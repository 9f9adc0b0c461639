"""UTF-32 ops, XLA tier (elementwise checks; scatter expansions).
Refs: src/scalar/utf32.h, utf32_to_utf8/utf16/latin1 scalar kernels."""

from __future__ import annotations

import jax.numpy as jnp

from ..errors import error_code as ec
from .common import (
    BIG,
    DEVICE_ROUTING,
    bswap16,
    excl_scan,
    positions,
    route,
    vlike,
    scatter_writes,
    zero_tail,
)

_SURROGATE = int(ec.SURROGATE)
_TOO_LARGE = int(ec.TOO_LARGE)


def _native(words: jnp.ndarray, length):
    # stay in uint32: unsigned compares are exact for values >= 2^31
    # (int64 would silently truncate to int32 without jax_enable_x64)
    return zero_tail(words.astype(jnp.uint32), length)


def first_error(w, length):
    idx = positions(w.shape[0])
    in_r = idx < length
    too_large = (w > 0x10FFFF) & in_r
    surrogate = (w >= 0xD800) & (w <= 0xDFFF) & in_r
    bad = too_large | surrogate
    # one reduction: the key equals idx wherever bad, so argmin alone
    # locates the first bad word; bad[k] distinguishes "none bad"
    k = jnp.argmin(jnp.where(bad, idx, BIG))
    pos = jnp.where(bad[k], k.astype(jnp.int32), BIG)
    code = jnp.where(too_large[k], _TOO_LARGE, _SURROGATE)
    return pos, code


def validate_with_errors(words: jnp.ndarray, length):
    w = _native(words, length)
    pos, code = first_error(w, length)
    ok = pos == BIG
    return jnp.where(ok, 0, code), jnp.where(ok, length, pos)


def utf8_length(words: jnp.ndarray, length):
    w = _native(words, length)
    idx = positions(w.shape[0])
    in_r = idx < length
    n = jnp.sum(in_r)
    n += jnp.sum((w > 0x7F) & in_r)
    n += jnp.sum((w > 0x7FF) & in_r)
    n += jnp.sum((w > 0xFFFF) & in_r)
    return n


def utf16_length(words: jnp.ndarray, length):
    w = _native(words, length)
    idx = positions(w.shape[0])
    in_r = idx < length
    return jnp.sum(in_r) + jnp.sum((w > 0xFFFF) & in_r)


def _emit_utf8(w64, length, n):
    """Shared UTF-8 emission from clamped codepoints: (out u8[4N], off,
    total)."""
    idx = positions(n)
    in_r = idx < length
    # clamp garbage (>0x10FFFF) so bit ops stay sane; truncated away anyway
    cp = jnp.where(w64 > 0x10FFFF, 0, w64).astype(jnp.int32)
    width = jnp.where(in_r, 1, 0)
    width += jnp.where(in_r & (cp > 0x7F), 1, 0)
    width += jnp.where(in_r & (cp > 0x7FF), 1, 0)
    width += jnp.where(in_r & (cp > 0xFFFF), 1, 0)
    off, off_inc = excl_scan(width, n)
    total = off_inc[n - 1]
    cap = 4 * n
    w1, w2, w3, w4 = width == 1, width == 2, width == 3, width == 4
    b0 = jnp.where(w1, cp, 0)
    b0 = jnp.where(w2, (cp >> 6) | 0xC0, b0)
    b0 = jnp.where(w3, (cp >> 12) | 0xE0, b0)
    b0 = jnp.where(w4, (cp >> 18) | 0xF0, b0)
    b1 = jnp.where(w2, (cp & 0x3F) | 0x80, 0)
    b1 = jnp.where(w3, ((cp >> 6) & 0x3F) | 0x80, b1)
    b1 = jnp.where(w4, ((cp >> 12) & 0x3F) | 0x80, b1)
    b2 = jnp.where(w3, (cp & 0x3F) | 0x80, 0)
    b2 = jnp.where(w4, ((cp >> 6) & 0x3F) | 0x80, b2)
    b3 = (cp & 0x3F) | 0x80
    out = scatter_writes(cap, jnp.uint8, [
        (in_r, off, b0),
        (in_r & (width >= 2), off + 1, b1),
        (in_r & (width >= 3), off + 2, b2),
        (in_r & (width >= 4), off + 3, b3),
    ])
    return out, off, total


def _emit_utf16(w64, length, n, big_endian):
    """Shared UTF-16 emission: (out u16[2N], off, total)."""
    idx = positions(n)
    in_r = idx < length
    cp = jnp.where(w64 > 0x10FFFF, 0, w64).astype(jnp.int32)
    is4 = (cp > 0xFFFF) & in_r
    width = jnp.where(in_r, 1, 0) + is4.astype(jnp.int32)
    off, off_inc = excl_scan(width, n)
    total = off_inc[n - 1]
    cap = 2 * n
    cpx = cp - 0x10000
    unit0 = jnp.where(is4, 0xD800 + (cpx >> 10), cp)
    unit1 = 0xDC00 + (cpx & 0x3FF)
    if big_endian:
        unit0 = bswap16(unit0)
        unit1 = bswap16(unit1)
    out = scatter_writes(cap, jnp.uint16, [
        (in_r, off, unit0),
        (is4, off + 1, unit1),
    ])
    return out, off, total


def census(w64, length):
    """One-pass census of a native (uint32, tail-zeroed) buffer (see
    ops/utf8.census): exact in-class validity proofs for the uniform
    UTF-8-width classes (ascii/2/3-byte BMP bands, astral) plus the
    non-surrogate BMP band (uniform for UTF-16)."""
    from jax import lax

    idx = positions(w64.shape[0])
    out_r = idx >= length
    nz = length > 0
    sur = (w64 >= 0xD800) & (w64 <= 0xDFFF)
    # pack the five facts as bits of one int32 and AND-reduce once: a
    # single reduction over one read of the buffer
    word = (
        ((w64 < 0x80) | out_r).astype(jnp.int32)
        | ((((w64 >= 0x80) & (w64 <= 0x7FF)) | out_r).astype(jnp.int32)
           << 1)
        | ((((w64 >= 0x800) & (w64 <= 0xFFFF) & ~sur) | out_r)
           .astype(jnp.int32) << 2)
        | ((((w64 >= 0x10000) & (w64 <= 0x10FFFF)) | out_r)
           .astype(jnp.int32) << 3)
        | ((((w64 <= 0xFFFF) & ~sur) | out_r).astype(jnp.int32) << 4)
    )
    red = lax.reduce(word, jnp.int32(0x1F), lax.bitwise_and, (0,))
    ascii_ = (red & 1) != 0
    u2 = ((red & 2) != 0) & nz
    u3 = ((red & 4) != 0) & nz
    astral = ((red & 8) != 0) & nz
    bmp = (red & 16) != 0
    return ascii_, u2, u3, astral, bmp


def _mask_tail(vals, count):
    idx = positions(vals.shape[0])
    return jnp.where(idx < count, vals, 0)


def to_utf8(words: jnp.ndarray, length, routing: bool = DEVICE_ROUTING):
    """Returns (err_code, err_pos, out u8[4N], out_len); census-routed;
    mixed input pays the general engine."""
    n = words.shape[0]
    w64 = _native(words, length)

    def general():
        err_pos, err_code = first_error(w64, length)
        ok = err_pos == BIG
        out, off, total = _emit_utf8(w64, length, n)
        clamped = jnp.minimum(err_pos, n - 1)
        # off[0] == 0: err_pos == 0 needs no special case
        out_len = jnp.where(ok, total, off[clamped])
        return (
            jnp.where(ok, 0, err_code),
            jnp.where(ok, length, err_pos),
            out,
            out_len,
        )

    if not routing:
        return general()
    ascii_, u2, u3, astral, _ = census(w64, length)
    branches = _u8_fast_branches(w64, length, n)

    def wrap(br):
        def f():
            out, cnt = br()
            z = vlike(jnp.int32(0), out)
            return z, z + length, out, z + cnt
        return f

    preds = (ascii_, u2, u3, astral)
    return route([(p, wrap(b)) for p, b in zip(preds, branches)], general)


def _u8_fast_branches(w64, length, n):
    cp = w64.astype(jnp.int32)

    def br_ascii():
        return jnp.pad(cp, (0, 3 * n)).astype(jnp.uint8), length

    def br_u2():
        b0 = (cp >> 6) | 0xC0
        b1 = (cp & 0x3F) | 0x80
        by = _mask_tail(jnp.stack([b0, b1], 1).reshape(-1), 2 * length)
        return jnp.pad(by, (0, 2 * n)).astype(jnp.uint8), 2 * length

    def br_u3():
        b0 = (cp >> 12) | 0xE0
        b1 = ((cp >> 6) & 0x3F) | 0x80
        b2 = (cp & 0x3F) | 0x80
        by = _mask_tail(jnp.stack([b0, b1, b2], 1).reshape(-1), 3 * length)
        return jnp.pad(by, (0, n)).astype(jnp.uint8), 3 * length

    def br_astral():
        b0 = (cp >> 18) | 0xF0
        b1 = ((cp >> 12) & 0x3F) | 0x80
        b2 = ((cp >> 6) & 0x3F) | 0x80
        b3 = (cp & 0x3F) | 0x80
        by = _mask_tail(jnp.stack([b0, b1, b2, b3], 1).reshape(-1), 4 * length)
        return by.astype(jnp.uint8), 4 * length

    return br_ascii, br_u2, br_u3, br_astral


def to_utf8_valid(words: jnp.ndarray, length,
                  routing: bool = DEVICE_ROUTING):
    """convert_valid_utf32_to_utf8: skips the range/surrogate checks
    (reference: per-arch convert_valid kernels). Returns (out, total);
    census-routed."""
    n = words.shape[0]
    w64 = _native(words, length)

    def general():
        out, _, total = _emit_utf8(w64, length, n)
        return out, jnp.int32(total)

    if not routing:
        return general()
    ascii_, u2, u3, astral, _ = census(w64, length)
    branches = _u8_fast_branches(w64, length, n)

    def wrap(br):
        def f():
            out, cnt = br()
            return out, vlike(jnp.int32(cnt), out)
        return f

    preds = (ascii_, u2, u3, astral)
    return route([(p, wrap(b)) for p, b in zip(preds, branches)], general)


def _u16_fast_branches(w64, length, n, big_endian):
    cp = w64.astype(jnp.int32)

    def swp(u):
        return bswap16(u) if big_endian else u

    def br_bmp():
        u = _mask_tail(swp(cp), length)
        return jnp.pad(u, (0, n)).astype(jnp.uint16), length

    def br_astral():
        cpx = cp - 0x10000
        hi = swp(0xD800 + (cpx >> 10))
        lo = swp(0xDC00 + (cpx & 0x3FF))
        u = _mask_tail(jnp.stack([hi, lo], 1).reshape(-1), 2 * length)
        return u.astype(jnp.uint16), 2 * length

    return br_bmp, br_astral


def to_utf16(words: jnp.ndarray, length, big_endian: bool,
             routing: bool = DEVICE_ROUTING):
    """Returns (err_code, err_pos, out u16[2N], out_len); census-routed;
    mixed input pays the general engine."""
    n = words.shape[0]
    w64 = _native(words, length)

    def general():
        err_pos, err_code = first_error(w64, length)
        ok = err_pos == BIG
        out, off, total = _emit_utf16(w64, length, n, big_endian)
        clamped = jnp.minimum(err_pos, n - 1)
        # off[0] == 0: err_pos == 0 needs no special case
        out_len = jnp.where(ok, total, off[clamped])
        return (
            jnp.where(ok, 0, err_code),
            jnp.where(ok, length, err_pos),
            out,
            out_len,
        )

    if not routing:
        return general()
    _, _, _, astral, bmp = census(w64, length)
    br_bmp, br_astral = _u16_fast_branches(w64, length, n, big_endian)

    def wrap(br):
        def f():
            out, cnt = br()
            z = vlike(jnp.int32(0), out)
            return z, z + length, out, z + cnt
        return f

    return route([(bmp, wrap(br_bmp)), (astral, wrap(br_astral))], general)


def to_utf16_valid(words: jnp.ndarray, length, big_endian: bool,
                   routing: bool = DEVICE_ROUTING):
    """convert_valid_utf32_to_utf16: no validation pass. (out, total);
    census-routed."""
    n = words.shape[0]
    w64 = _native(words, length)

    def general():
        out, _, total = _emit_utf16(w64, length, n, big_endian)
        return out, jnp.int32(total)

    if not routing:
        return general()
    _, _, _, astral, bmp = census(w64, length)
    br_bmp, br_astral = _u16_fast_branches(w64, length, n, big_endian)

    def wrap(br):
        def f():
            out, cnt = br()
            return out, vlike(jnp.int32(cnt), out)
        return f

    return route([(bmp, wrap(br_bmp)), (astral, wrap(br_astral))], general)


def to_latin1(words: jnp.ndarray, length):
    n = words.shape[0]
    w = _native(words, length)
    idx = positions(n)
    bad = (w > 0xFF) & (idx < length)
    err_pos = jnp.min(jnp.where(bad, idx, BIG))
    ok = err_pos == BIG
    out = (w & 0xFF).astype(jnp.uint8)
    out_len = jnp.where(ok, length, err_pos)
    return (
        jnp.where(ok, 0, _TOO_LARGE),
        jnp.where(ok, length, err_pos),
        out,
        out_len,
    )


def to_latin1_valid(words: jnp.ndarray, length):
    """convert_valid_utf32_to_latin1: a pure narrowing store. (out, total)."""
    w = _native(words, length)
    return (w & 0xFF).astype(jnp.uint8), length
