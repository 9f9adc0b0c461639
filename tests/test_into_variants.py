"""C-style *_into calling convention: caller-allocated buffers sized via
X_length_from_Y, count returns, 0 on error."""

import numpy as np
import pytest

import simdutf_tpu as su


def test_into_roundtrip(transcode_impl):
    data = "héllo 日本 🙂".encode()
    out = np.zeros(su.utf16_length_from_utf8(data), dtype=np.uint16)
    n = su.convert_utf8_to_utf16le_into(data, out)
    assert n == out.shape[0]
    assert out.tobytes() == data.decode().encode("utf-16-le")

    out8 = np.zeros(su.utf8_length_from_utf16le(out), dtype=np.uint8)
    n8 = su.convert_utf16le_to_utf8_into(out, out8)
    assert out8[:n8].tobytes() == data


def test_into_error_returns_zero(transcode_impl):
    out = np.zeros(16, dtype=np.uint16)
    assert su.convert_utf8_to_utf16le_into(b"ab\xff", out) == 0


def test_into_too_small_raises(transcode_impl):
    out = np.zeros(1, dtype=np.uint16)
    with pytest.raises(ValueError, match="too small"):
        su.convert_utf8_to_utf16le_into(b"abcdef", out)
