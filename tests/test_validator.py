"""The device tier's UTF-8 validator against the oracle: exact first-error
code and position on every input class, including sequences that straddle
word and 32 KiB block boundaries."""

import numpy as np
import pytest

import helpers
import oracle
from simdutf_tpu.ops.impl import XLAImplementation

_XLA = XLAImplementation()


CASES = []
CASES += [helpers.random_utf8(s, 300, 2, 1, 1, 1) for s in range(10)]
CASES += [helpers.mutate(helpers.random_utf8(s, 300, 1, 1, 1, 1), s, 2) for s in range(20)]
CASES += [helpers.random_bytes(s, 200) for s in range(10)]
CASES += [
    b"", b"a", b"\x80", b"\xc3", b"\xc3\xa9", b"\xc0\xaf", b"\xe0\x80\x80",
    b"\xed\x9f\xbf", b"\xed\xa0\x80", b"\xf0\x8f\xbf\xbf", b"\xf0\x90\x80\x80",
    b"\xf4\x8f\xbf\xbf", b"\xf4\x90\x80\x80", b"\xf5\x80\x80\x80", b"\xf8\x88",
    b"A" * 511 + b"\xe4\xb8\xad", b"A" * 32767 + b"\xc3\xa9",
    b"A" * 32765 + b"\xf0\x9f\x98\x80",   # 4-byte across the tile boundary
    b"A" * 32767 + b"\xf0\x9f\x98",       # truncated at tile boundary
]
# every 2-byte combination class
for b0 in range(0xC0, 0xE0, 3):
    for b1 in (0x7F, 0x80, 0xBF, 0xC0):
        CASES.append(bytes([b0, b1]))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_validator_matches_oracle(i):
    data = CASES[i]
    got = _XLA.validate_utf8_with_errors(np.frombuffer(data, np.uint8))
    assert got == oracle.validate_utf8_with_errors(data), data[:24].hex()
