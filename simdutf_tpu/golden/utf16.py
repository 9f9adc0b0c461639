"""Vectorized NumPy UTF-16 machinery.

Mask algebra mirrors generic/validate_utf16.h:48-126 semantics; exact
first-error position uses the event-minimum argument (see golden/utf8.py):
before its first error the scalar machine (scalar/utf16.h:39-67) consumes
well-paired units, so the first error is the minimum of
  * a high surrogate not followed by a low surrogate -> SURROGATE at the high
  * a low surrogate not preceded by a high surrogate -> SURROGATE at the low
"""

from __future__ import annotations

import numpy as np

from ..errors import Result, error_code as ec

_NO_ERROR = np.iinfo(np.int32).max


def _native(words: np.ndarray, big_endian: bool) -> np.ndarray:
    """uint16 units -> native-order int32 values."""
    w = words.byteswap() if big_endian else words
    return w.astype(np.int32)


def first_error(w: np.ndarray) -> tuple[int, int]:
    """(err_pos, err_code) with err_pos == _NO_ERROR when valid. ``w`` is
    native-order int32."""
    n = int(w.shape[0])
    if n == 0:
        return _NO_ERROR, 0
    is_high = (w & 0xFC00) == 0xD800
    is_low = (w & 0xFC00) == 0xDC00
    next_low = np.zeros(n, dtype=bool)
    next_low[: n - 1] = is_low[1:]
    prev_high = np.zeros(n, dtype=bool)
    prev_high[1:] = is_high[: n - 1]
    bad = (is_high & ~next_low) | (is_low & ~prev_high)
    if not bad.any():
        return _NO_ERROR, 0
    return int(np.argmax(bad)), int(ec.SURROGATE)


def validate(words: np.ndarray, big_endian: bool) -> bool:
    return first_error(_native(words, big_endian))[0] == _NO_ERROR


def validate_with_errors(words: np.ndarray, big_endian: bool) -> Result:
    w = _native(words, big_endian)
    pos, code = first_error(w)
    if pos == _NO_ERROR:
        return Result(ec.SUCCESS, int(w.shape[0]))
    return Result(ec(code), pos)


def count_code_points(words: np.ndarray, big_endian: bool) -> int:
    w = _native(words, big_endian)
    return int(np.count_nonzero((w & 0xFC00) != 0xDC00))


def utf8_length(words: np.ndarray, big_endian: bool) -> int:
    # scalar/utf16.h:80-94
    w = _native(words, big_endian)
    n = int(w.shape[0])
    n += int(np.count_nonzero(w > 0x7F))
    n += int(np.count_nonzero(((w > 0x7FF) & (w <= 0xD7FF)) | (w >= 0xE000)))
    return n


def utf32_length(words: np.ndarray, big_endian: bool) -> int:
    return count_code_points(words, big_endian)


def change_endianness(words: np.ndarray) -> np.ndarray:
    return words.byteswap()


def trim_partial(words: np.ndarray, big_endian: bool) -> int:
    # scalar/utf16.h:114-124 (length in code units)
    length = int(words.shape[0])
    if length <= 1:
        return length
    last = int(_native(words[-1:], big_endian)[0])
    if (last & 0xFC00) == 0xD800:
        return length - 1
    return length


def to_well_formed(words: np.ndarray, big_endian: bool) -> np.ndarray:
    """U+FFFD substitution of ill-formed surrogates (scalar/utf16.h:141-166).
    Pure elementwise with a one-unit lookback."""
    w = _native(words, big_endian)
    n = int(w.shape[0])
    if n == 0:
        return words.copy()
    is_high = (w & 0xFC00) == 0xD800
    is_low = (w & 0xFC00) == 0xDC00
    prev_high = np.zeros(n, dtype=bool)
    prev_high[1:] = is_high[: n - 1]
    next_low = np.zeros(n, dtype=bool)
    next_low[: n - 1] = is_low[1:]
    bad = (is_high & ~next_low) | (is_low & ~prev_high)
    out = np.where(bad, 0xFFFD, w).astype(np.uint16)
    if big_endian:
        out = out.byteswap()
    return out


# ---------------------------------------------------------------------------
# conversions


def _utf16_cps(w: np.ndarray):
    """Per-unit codepoints for a valid-prefix: highs carry the full
    astral codepoint, lows carry width 0."""
    is_high = (w & 0xFC00) == 0xD800
    is_low = (w & 0xFC00) == 0xDC00
    nxt = np.zeros_like(w)
    nxt[:-1] = w[1:]
    cp = np.where(is_high, ((w - 0xD800) << 10) + (nxt - 0xDC00) + 0x10000, w)
    start = ~is_low  # units that begin a codepoint
    return cp, start


def convert_to_utf8_with_errors(words: np.ndarray, big_endian: bool):
    w = _native(words, big_endian)
    pos, code = first_error(w)
    upto = int(w.shape[0]) if pos == _NO_ERROR else pos
    wv = w[:upto]
    cp, start = _utf16_cps(wv)
    cps = cp[start]
    width = np.ones(cps.shape[0], dtype=np.int32)
    width += (cps > 0x7F).astype(np.int32)
    width += (cps > 0x7FF).astype(np.int32)
    width += (cps > 0xFFFF).astype(np.int32)
    out = _emit_utf8(cps, width)
    if pos == _NO_ERROR:
        return Result(ec.SUCCESS, int(out.shape[0])), out
    return Result(ec(code), pos), out


def _emit_utf8(cps: np.ndarray, width: np.ndarray) -> np.ndarray:
    total = int(width.sum())
    out = np.zeros(total, dtype=np.int32)
    off = np.cumsum(width) - width
    w1 = width == 1
    w2 = width == 2
    w3 = width == 3
    w4 = width == 4
    out[off[w1]] = cps[w1]
    out[off[w2]] = (cps[w2] >> 6) | 0xC0
    out[off[w2] + 1] = (cps[w2] & 0x3F) | 0x80
    out[off[w3]] = (cps[w3] >> 12) | 0xE0
    out[off[w3] + 1] = ((cps[w3] >> 6) & 0x3F) | 0x80
    out[off[w3] + 2] = (cps[w3] & 0x3F) | 0x80
    out[off[w4]] = (cps[w4] >> 18) | 0xF0
    out[off[w4] + 1] = ((cps[w4] >> 12) & 0x3F) | 0x80
    out[off[w4] + 2] = ((cps[w4] >> 6) & 0x3F) | 0x80
    out[off[w4] + 3] = (cps[w4] & 0x3F) | 0x80
    return out.astype(np.uint8)


def convert_to_utf32_with_errors(words: np.ndarray, big_endian: bool):
    w = _native(words, big_endian)
    pos, code = first_error(w)
    upto = int(w.shape[0]) if pos == _NO_ERROR else pos
    cp, start = _utf16_cps(w[:upto])
    out = cp[start].astype(np.uint32)
    if pos == _NO_ERROR:
        return Result(ec.SUCCESS, int(out.shape[0])), out
    return Result(ec(code), pos), out


def convert_to_latin1_with_errors(words: np.ndarray, big_endian: bool):
    # scalar/utf16_to_latin1/utf16_to_latin1.h:35-91: first unit > 0xFF is
    # TOO_LARGE at its position; no surrogate logic at all.
    w = _native(words, big_endian)
    big = w > 0xFF
    if big.any():
        pos = int(np.argmax(big))
        return Result(ec.TOO_LARGE, pos), w[:pos].astype(np.uint8)
    return Result(ec.SUCCESS, int(w.shape[0])), w.astype(np.uint8)
