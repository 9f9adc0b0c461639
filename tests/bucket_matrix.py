"""Shared inputs for the bucket and padding matrix (tests/test_buckets_*.py).

The device tier pads every input to a power-of-two bucket of at least
1 KiB with 8 bytes of slack (ops/impl._bucket) and passes the true length
as a dynamic scalar. These cases sit on both sides of each bucket boundary
(n + 8 == 2^k), on both sides of the old block alignments (8 Ki and
32 Ki units; 1536 and 2048 bytes for base64), and at tiny lengths. Each
input is valid, or valid with an error in its last code unit, and every
public entry point is compared with the fallback tier (the golden NumPy
machine), results, positions and outputs included.
"""

from __future__ import annotations

import random

import numpy as np

import simdutf_tpu as su

_BOUNDARIES = [n for k in range(10, 16) for n in ((1 << k) - 8, (1 << k) - 7)]
_ALIGNED = [8191, 8192, 8193, 32767, 32768, 32769]
LENGTHS = sorted(set([0, 1, 3] + _BOUNDARIES + _ALIGNED))  # up to 32769
LENGTHS_U8 = LENGTHS + [65528]  # byte sources: up to 64 KiB
LENGTHS_U32 = [n for n in LENGTHS if n <= 16384]  # 4-byte units: <= 64 KiB
LENGTHS_B64 = sorted(set([0, 1, 2, 3, 1535, 1536, 1537, 2047, 2048, 2049]
                         + _BOUNDARIES[:8] + [32760, 32761]))


def cases(lengths):
    """(n, bad) pairs; a zero-length input has no last unit to break."""
    return [(n, bad) for n in lengths for bad in (False, True)
            if n or not bad]


def case_ids(pairs):
    return [f"{n}-{'bad' if bad else 'ok'}" for n, bad in pairs]


_CLASSES = ("ascii", "two", "three", "four", "mixed")

_RANGES = {
    "ascii": [(0x20, 0x7F)],
    "two": [(0x80, 0x800)],
    "three": [(0x800, 0xD800), (0xE000, 0x10000)],
    "four": [(0x10000, 0x110000)],
    "latin1": [(0x20, 0x7F), (0xA0, 0x100)],
}


def _chars(rng, cls, count):
    if cls == "mixed":
        return [_chars(rng, rng.choice(_CLASSES[:4]), 1)[0]
                for _ in range(count)]
    out = []
    for _ in range(count):
        lo, hi = rng.choice(_RANGES[cls])
        out.append(chr(rng.randrange(lo, hi)))
    return out


def _class_for(n, latin1):
    if latin1:
        return "latin1"
    return _CLASSES[n % len(_CLASSES)]


def utf8_input(n: int, bad: bool, latin1: bool = False) -> np.ndarray:
    """Exactly ``n`` bytes of valid UTF-8 (latin1-range characters when
    ``latin1``), the last byte replaced by 0xFF when ``bad``."""
    rng = random.Random(n * 2 + bad)
    body = n - 1 if bad else n
    cls = _class_for(n, latin1)
    width = {"ascii": 1, "two": 2, "three": 3, "four": 4}.get(cls, 2)
    text = "".join(_chars(rng, cls, body // width)).encode()[:body]
    text = text[: su.trim_partial_utf8(text)]
    text += b"a" * (body - len(text))
    if bad:
        text += b"\xff"
    return np.frombuffer(text, np.uint8)


def utf16_input(n: int, bad: bool, big_endian: bool,
                latin1: bool = False) -> np.ndarray:
    """Exactly ``n`` UTF-16 units in storage order; when ``bad`` the last
    unit is a lone high surrogate (or 0x100 for a Latin1 target)."""
    rng = random.Random(n * 4 + bad * 2 + big_endian)
    body = n - 1 if bad else n
    cls = _class_for(n, latin1)
    units = np.frombuffer(
        "".join(_chars(rng, cls, body)).encode("utf-16-le"), np.uint16
    )[:body]
    if len(units) and (units[-1] & 0xFC00) == 0xD800:
        units = units[:-1]
    units = np.concatenate([units, np.full(body - len(units), 0x61, np.uint16)])
    if bad:
        units = np.append(units, np.uint16(0x100 if latin1 else 0xD800))
    units = units.astype(np.uint16)
    return units.byteswap() if big_endian else units


def utf32_input(n: int, bad: bool, latin1: bool = False) -> np.ndarray:
    """Exactly ``n`` code points; when ``bad`` the last is 0x110000 (or
    0x100 for a Latin1 target)."""
    rng = random.Random(n * 2 + bad)
    body = n - 1 if bad else n
    cps = [ord(c) for c in _chars(rng, _class_for(n, latin1), body)]
    if bad:
        cps.append(0x100 if latin1 else 0x110000)
    return np.array(cps, dtype=np.uint32)


def latin1_input(n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    lo = 0x80 if n % 3 == 1 else 0
    hi = 0x80 if n % 3 == 2 else 0x100
    return rng.integers(lo, hi, n, dtype=np.uint8)


def base64_input(n: int, bad: bool, url: bool) -> np.ndarray:
    """``n`` characters of base64 text with a line break every 76
    characters; the last character is '*' when ``bad``."""
    import base64 as pyb64

    raw = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    enc = (pyb64.urlsafe_b64encode if url else pyb64.b64encode)(raw)
    lines = b"\n".join(enc[i: i + 76] for i in range(0, len(enc), 76))
    text = lines[:n]
    if bad:
        text = text[:-1] + b"*"
    return np.frombuffer(text, np.uint8)


def tiers():
    impls = su.get_available_implementations()
    return impls["xla"], impls["fallback"]


def assert_same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert np.array_equal(np.asarray(got), want), (
            np.asarray(got)[:16], want[:16])
    else:
        assert got == want, (got, want)


def check(method: str, arr: np.ndarray, *args):
    xla, fallback = tiers()
    assert_same(getattr(xla, method)(arr, *args),
                getattr(fallback, method)(arr, *args))
