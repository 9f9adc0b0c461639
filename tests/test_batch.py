"""Batch API: one device launch for many strings; per-item parity with the
single-call API (and hence the oracle)."""

import numpy as np
import pytest

import helpers
import oracle
from simdutf_tpu import batch


def _items(seed):
    out = [
        b"",
        b"plain ascii",
        "héllo 日本 🙂".encode(),
        b"bad\xff\xfebytes",
        b"\xed\xa0\x80",
        helpers.random_utf8(seed, 300, 2, 1, 1, 1),
        helpers.mutate(helpers.random_utf8(seed + 1, 200, 1, 1, 1, 1), seed, 2),
    ]
    return out


@pytest.mark.parametrize("seed", range(3))
def test_validate_batch(seed):
    items = _items(seed)
    got = batch.validate_utf8_batch(items)
    for item, r in zip(items, got):
        assert r == oracle.validate_utf8_with_errors(item), item.hex()


@pytest.mark.parametrize("seed", range(3))
def test_count_and_length_batch(seed):
    items = _items(seed)
    counts = batch.count_utf8_batch(items)
    u16 = batch.utf16_length_from_utf8_batch(items)
    for i, item in enumerate(items):
        assert counts[i] == oracle.count_utf8(item)
        assert u16[i] == oracle.utf16_length_from_utf8(item)


@pytest.mark.parametrize("seed", range(3))
def test_transcode_batch(seed):
    items = _items(seed)
    got = batch.convert_utf8_to_utf16le_batch(items)
    for item, (r, out) in zip(items, got):
        exp_r, exp_out = oracle.convert_utf8_to_utf16_with_errors(item, False)
        assert r == exp_r, item.hex()
        assert out == exp_out


def test_batch_no_stale_rows():
    # a long batch then a short one: pooled matrix must not leak old rows
    long_items = [b"x" * 500, b"y" * 400]
    batch.validate_utf8_batch(long_items)
    short = [b"a", b"\xc3\xa9"]
    got = batch.validate_utf8_batch(short)
    assert all(r.is_ok for r in got)
    counts = batch.count_utf8_batch(short)
    assert list(counts) == [1, 1]


def test_empty_batch():
    assert batch.validate_utf8_batch([]) == []
    assert batch.count_utf8_batch([]).shape == (0,)


@pytest.mark.parametrize("seed", range(2))
def test_utf16_batch(seed):
    items = [
        b"",
        "plain".encode("utf-16-le"),
        "héllo 𝄞".encode("utf-16-le"),
        np.array([0x41, 0xD800, 0x42], dtype=np.uint16).tobytes(),
        helpers.random_utf16(seed, 100, 2, 1),
    ]
    got = batch.validate_utf16le_batch(items)
    for item, r in zip(items, got):
        assert r == oracle.validate_utf16_with_errors(item, False), item.hex()
    pairs = batch.convert_utf16le_to_utf8_batch(items)
    for item, (r, out) in zip(items, pairs):
        exp_r, exp_out = oracle.convert_utf16_to_utf8_with_errors(item, False)
        assert (r, out) == (exp_r, exp_out)


@pytest.mark.parametrize("options", [0, 1, 4, 8])
@pytest.mark.parametrize("last", [0, 1, 2])
def test_base64_batch_matches_one_shot(options, last):
    import base64 as pyb64
    import random

    import simdutf_tpu as su

    rng = random.Random(options * 7 + last)
    items = [b"", b"aGVsbG8=", b"====", b"aGVsbG8", b"a"]
    for k in range(10):
        payload = helpers.random_bytes(rng.randrange(1 << 30),
                                       rng.randrange(0, 150))
        enc = pyb64.b64encode(payload)
        if k % 3 == 1:  # whitespace
            enc = b" ".join(enc[i:i + 7] for i in range(0, len(enc), 7))
        elif k % 3 == 2:  # mutate
            enc = helpers.mutate(enc, rng.randrange(1 << 30), 2)
        items.append(enc)
    got = batch.base64_to_binary_batch(items, options, last)
    for item, (full, out) in zip(items, got):
        wf, wo = su.base64_to_binary_details(item, options, last)
        assert (full, out) == (wf, wo), item


def test_base64_encode_batch_matches_one_shot():
    import random

    import simdutf_tpu as su

    rng = random.Random(3)
    items = [b"", b"f", b"fo", b"foo", b"foob"]
    items += [helpers.random_bytes(rng.randrange(1 << 30),
                                   rng.randrange(0, 300)) for _ in range(8)]
    for options in (0, 1, 2, 3):
        got = batch.binary_to_base64_batch(items, options)
        for item, enc in zip(items, got):
            assert enc == su.binary_to_base64(item, options), (item, options)


def test_batch_row_bucketing_bounds_compiles():
    """Batch sizes bucket to powers of two so the jit cache stays bounded
    across serving batch sizes (pad rows are zero-length and sliced off)."""
    assert batch._bucket_rows(1) == 8
    assert batch._bucket_rows(8) == 8
    assert batch._bucket_rows(9) == 16
    assert batch._bucket_rows(1000) == 1024
    for b in (1, 3, 7, 9, 12):
        items = [b"ab" for _ in range(b)]
        assert len(batch.validate_utf8_batch(items)) == b
        assert len(batch.count_utf8_batch(items)) == b
        assert len(batch.base64_to_binary_batch([b"aGk="] * b)) == b
        assert len(batch.binary_to_base64_batch(items)) == b
    buf, lens = batch._pack([b"x"] * 5)
    assert buf.shape[0] == 8 and list(lens) == [1] * 5 + [0] * 3


def test_detect_encodings_batch_matches_one_shot():
    import simdutf_tpu as su

    s = "héllo wörld 日本語 " * 50
    items = [
        s.encode(), s.encode("utf-16-le"), s.encode("utf-32-le"),
        b"\xff\xfe" + s.encode("utf-16-le"), bytes(range(256)),
        b"", b"plain ascii",
    ]
    got = batch.detect_encodings_batch(items)
    want = [su.detect_encodings(it) for it in items]
    assert got == want


def test_utf16_count_length_batch():
    import simdutf_tpu as su

    items = [b"", "héllo 𝄞".encode("utf-16-le"), b"a\x00b\x00",
             "日本語 🙂".encode("utf-16-le")]
    got_c = list(batch.count_utf16le_batch(items))
    got_l = list(batch.utf8_length_from_utf16le_batch(items))
    assert got_c == [su.count_utf16le(it) for it in items]
    assert got_l == [su.utf8_length_from_utf16le(it) for it in items]


def test_batch_ascii_fast_paths_match_general():
    """The whole-batch ASCII widen/narrow fast paths must be
    byte-identical to the general vmapped engine, including Result
    shapes; mixed batches must take the general path unchanged."""
    ascii_items = [b"hello world " * 40, b"", b"a", b"x" * 999,
                   bytes(range(0x20, 0x7F)) * 8]
    # force both paths and compare
    buf, lens = batch._pack(ascii_items)
    assert batch._ascii_batch(buf, lens, len(ascii_items),
                              np.uint16) is not None
    got = batch.convert_utf8_to_utf16le_batch(ascii_items)
    for (res, out), item in zip(got, ascii_items):
        assert res.is_ok and res.count == len(item)
        assert out == item.decode().encode("utf-16-le")

    u16_items = [s.decode().encode("utf-16-le") for s in ascii_items]
    got16 = batch.convert_utf16le_to_utf8_batch(u16_items)
    for (res, out), item in zip(got16, ascii_items):
        assert res.is_ok and res.count == len(item)
        assert out == item

    # a single non-ASCII byte anywhere must fall back (peek may miss it;
    # the device pass is the proof) and still produce exact results
    mixed = [b"hello", "héllo".encode(), b"world"]
    bufm, lensm = batch._pack(mixed)
    assert batch._ascii_batch(bufm, lensm, len(mixed), np.uint16) is None
    gotm = batch.convert_utf8_to_utf16le_batch(mixed)
    for (res, out), item in zip(gotm, mixed):
        assert res.is_ok
        assert out == item.decode().encode("utf-16-le")

    # invalid UTF-8 in a non-ASCII batch: exact per-item error positions
    bad = [b"ok", b"ab\xffcd", "héllo".encode()]
    gotb = batch.convert_utf8_to_utf16le_batch(bad)
    assert gotb[0][0].is_ok
    assert not gotb[1][0].is_ok and gotb[1][0].count == 2
    assert gotb[2][0].is_ok
