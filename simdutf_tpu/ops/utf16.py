"""UTF-16 ops, XLA tier.

Surrogate mask algebra per generic/validate_utf16.h:48-126; exact first
error by event minimum (see golden/utf16.py). ``words`` is a padded uint16
buffer (raw storage order) + dynamic ``length`` in code units.
"""

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
    shift_left,
    zero_tail,
)

_SURROGATE = int(ec.SURROGATE)
_TOO_LARGE = int(ec.TOO_LARGE)


def native(words: jnp.ndarray, length, big_endian: bool) -> jnp.ndarray:
    w = words.astype(jnp.int32)
    if big_endian:
        w = bswap16(w)
    return zero_tail(w, length)


def first_error(w: jnp.ndarray, length):
    """(err_pos, code); BIG when valid. w: native int32, tail zeroed."""
    n = w.shape[0]
    idx = positions(n)
    in_r = idx < length
    is_high = ((w & 0xFC00) == 0xD800) & in_r
    is_low = ((w & 0xFC00) == 0xDC00) & in_r
    next_low = shift_left(is_low.astype(jnp.int32), 1).astype(bool)
    prev_high = jnp.pad(is_high[:-1], (1, 0))
    bad = (is_high & ~next_low) | (is_low & ~prev_high)
    pos = jnp.min(jnp.where(bad, idx, BIG))
    return pos, _SURROGATE


def validate_with_errors(words: jnp.ndarray, length, big_endian: bool):
    w = native(words, length, big_endian)
    pos, code = first_error(w, length)
    ok = pos == BIG
    return jnp.where(ok, 0, code), jnp.where(ok, length, pos)


def count_code_points(words: jnp.ndarray, length, big_endian: bool):
    w = native(words, length, big_endian)
    idx = positions(w.shape[0])
    return jnp.sum(((w & 0xFC00) != 0xDC00) & (idx < length))


def utf8_length(words: jnp.ndarray, length, big_endian: bool):
    # scalar/utf16.h:80-94
    w = native(words, length, big_endian)
    idx = positions(w.shape[0])
    in_r = idx < length
    n = jnp.sum(in_r)
    n += jnp.sum((w > 0x7F) & in_r)
    n += jnp.sum((((w > 0x7FF) & (w <= 0xD7FF)) | (w >= 0xE000)) & in_r)
    return n


def change_endianness(words: jnp.ndarray):
    w = words.astype(jnp.int32)
    return bswap16(w).astype(jnp.uint16)


def to_well_formed(words: jnp.ndarray, length, big_endian: bool):
    """U+FFFD substitution (scalar/utf16.h:141-166), elementwise with a
    one-unit lookback — the reference's utf16fix (arXiv:2601.06349)."""
    w = native(words, length, big_endian)
    idx = positions(w.shape[0])
    in_r = idx < length
    is_high = ((w & 0xFC00) == 0xD800) & in_r
    is_low = ((w & 0xFC00) == 0xDC00) & in_r
    next_low = shift_left(is_low.astype(jnp.int32), 1).astype(bool)
    prev_high = jnp.pad(is_high[:-1], (1, 0))
    bad = (is_high & ~next_low) | (is_low & ~prev_high)
    out = jnp.where(bad & in_r, 0xFFFD, w)
    if big_endian:
        out = bswap16(out)
    # restore original (unswapped) payload outside range for cleanliness
    out = jnp.where(in_r, out, words.astype(jnp.int32))
    return out.astype(jnp.uint16)


def _native16(words: jnp.ndarray, big_endian: bool) -> jnp.ndarray:
    """uint16 native-order view WITHOUT widening or tail-zeroing — the
    census/fast-branch form (no 4N-byte int32 temporary)."""
    w = words.astype(jnp.uint16)
    if big_endian:
        w = (w << 8) | (w >> 8)
    return w


def census(w: jnp.ndarray, length):
    """One-pass structural census of a native-order uint16 buffer for
    device-tier routing (see ops/utf8.census). Returns scalar bools
    (ascii, u2r, u3r, astral): exact in-class validity proofs
      ascii  — every unit < 0x80          (1 UTF-8 byte each)
      u2r    — every unit in [0x80,0x7FF] (2 UTF-8 bytes each)
      u3r    — every unit in [0x800,0xFFFF] minus surrogates (3 bytes each)
      astral — alternating high/low surrogate pairs (4 bytes per pair)
    Bytes at/after ``length`` are excluded by masks (no tail-zero pass).
    """
    n = w.shape[0]
    idx = positions(n)
    out_r = idx >= length
    ascii_ = jnp.all((w < 0x80) | out_r)
    u2r = jnp.all(((w >= 0x80) & (w <= 0x7FF)) | out_r) & (length > 0)
    sur = (w & 0xF800) == 0xD800
    u3r = jnp.all(((w >= 0x800) & ~sur) | out_r) & (length > 0)
    pair_ok = jnp.where(
        (idx & 1) == 0, (w & 0xFC00) == 0xD800, (w & 0xFC00) == 0xDC00
    )
    astral = jnp.all(pair_ok | out_r) & (length % 2 == 0) & (length > 0)
    return ascii_, u2r, u3r, astral


def _mask_tail(vals, count, n_out):
    idx = positions(n_out)
    return jnp.where(idx < count, vals, 0)


def _u8_fast_branches(w, length, n):
    """Fixed-rate utf16->utf8 branches on native-order uint16 w; each
    returns (out u8[3n], out_len) matching the general engine
    bit-for-bit. The uniform-3 class has no branch: it routes to the
    general engine."""

    def br_ascii():
        u = jnp.where(positions(n) < length, w, 0).astype(jnp.uint8)
        return jnp.pad(u, (0, 2 * n)), length

    def br_u2r():
        cnt = 2 * length
        b0 = ((w >> 6) | 0xC0).astype(jnp.uint8)
        b1 = ((w & 0x3F) | 0x80).astype(jnp.uint8)
        by = jnp.stack([b0, b1], axis=1).reshape(-1)  # 2n
        by = _mask_tail(by, cnt, 2 * n)
        return jnp.pad(by, (0, n)), cnt

    def br_astral():
        cnt = 2 * length
        pr = w.reshape(-1, 2)
        hi, lo = pr[:, 0].astype(jnp.int32), pr[:, 1].astype(jnp.int32)
        # cp = 0x10000 + ((hi-D800)<<10) + (lo-DC00), so hi - D7C0 is
        # cp >> 10 (11 bits) and b0 = F0 | (cp>>18) needs only its top bits
        hb = hi - 0xD7C0
        b0 = (0xF0 | (hb >> 8)).astype(jnp.uint8)
        b1 = (0x80 | ((hb >> 2) & 0x3F)).astype(jnp.uint8)
        b2 = (0x80 | (((hb & 0x03) << 4)
                      | ((lo >> 6) & 0x0F))).astype(jnp.uint8)
        b3 = (0x80 | (lo & 0x3F)).astype(jnp.uint8)
        by = jnp.stack([b0, b1, b2, b3], axis=1).reshape(-1)
        by = _mask_tail(by, cnt, 2 * n)
        return jnp.pad(by, (0, n)), cnt

    return br_ascii, br_u2r, br_astral


def _codepoints(w: jnp.ndarray, length):
    """Per-unit codepoints: highs carry the astral codepoint, lows width 0.
    Only meaningful on the valid prefix."""
    idx = positions(w.shape[0])
    in_r = idx < length
    is_high = ((w & 0xFC00) == 0xD800) & in_r
    is_low = ((w & 0xFC00) == 0xDC00) & in_r
    nxt = shift_left(w, 1)
    cp = jnp.where(is_high, ((w - 0xD800) << 10) + (nxt - 0xDC00) + 0x10000, w)
    start = ~is_low & in_r
    return cp, start




def _emit_utf8(cp, start, width, n):
    """Scatter UTF-8 bytes for per-unit codepoints: shared by the
    validating and valid-only converters. Returns (out u8[3n], total)."""
    off, off_inc = excl_scan(width, n)
    total = off_inc[n - 1]
    cap = 3 * n
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
        (start, off, b0),
        (start & (width >= 2), off + 1, b1),
        (start & (width >= 3), off + 2, b2),
        (start & (width >= 4), off + 3, b3),
    ])
    return out, off, total


def _utf8_widths(cp, start):
    width = jnp.where(start, 1, 0)
    width += jnp.where(start & (cp > 0x7F), 1, 0)
    width += jnp.where(start & (cp > 0x7FF), 1, 0)
    width += jnp.where(start & (cp > 0xFFFF), 1, 0)
    return width

def _to_utf8_general(w, length, n):
    err_pos, err_code = first_error(w, length)
    ok = err_pos == BIG

    cp, start = _codepoints(w, length)
    width = _utf8_widths(cp, start)
    out, off, total = _emit_utf8(cp, start, width, n)
    clamped = jnp.minimum(err_pos, n - 1)
    # off[0] == 0 for an exclusive scan, so err_pos == 0 needs no special case
    out_len = jnp.where(ok, total, off[clamped])
    # zero bytes at/after out_len (engine-wide convention: on error the
    # raw scatter leaves mechanically-decoded bytes past the valid prefix)
    out = jnp.where(positions(out.shape[0]) < out_len, out, 0)
    return (
        jnp.where(ok, 0, err_code),
        jnp.where(ok, length, err_pos),
        out,
        out_len,
    )


def to_utf8(words: jnp.ndarray, length, big_endian: bool,
            routing: bool = DEVICE_ROUTING):
    """Returns (err_code, err_pos, out u8[3N], out_len); census-routed
    (see ops/utf8.to_utf16): whole-buffer uniform UTF-8-width classes
    take fixed-rate elementwise branches. Bytes at/after out_len are
    zero."""
    n = words.shape[0]
    if not routing:
        return _to_utf8_general(native(words, length, big_endian), length, n)
    w16 = _native16(words, big_endian)
    ascii_, u2r, u3r, astral = census(w16, length)
    br_ascii, br_u2r, br_astral = _u8_fast_branches(w16, length, n)

    def wrap(br):
        def f():
            out, cnt = br()
            z = vlike(jnp.int32(0), out)
            return z, z + length, out, z + cnt
        return f

    return route(
        [(ascii_, wrap(br_ascii)), (u2r, wrap(br_u2r)),
         (astral, wrap(br_astral))],
        lambda: _to_utf8_general(
            native(words, length, big_endian), length, n),
    )


def _emit_utf32(cp, start, n):
    """Shared UTF-32 emission: scan the start mask, scatter codepoints.
    Returns (out u32[n], off, total)."""
    width = start.astype(jnp.int32)
    off, off_inc = excl_scan(width, n)
    total = off_inc[n - 1]
    out = scatter_writes(n, jnp.uint32, [(start, off, cp)])
    return out, off, total


def _u32_fast_branches(w, length, n):
    """utf16->utf32 fixed-rate branches on native-order uint16 w: BMP
    non-surrogate is an elementwise widen; astral pairs are a 2:1 word
    map (uint32 only at the final pair combine)."""

    def br_bmp():
        u = jnp.where(positions(n) < length, w, 0)
        return u.astype(jnp.uint32), length

    def br_astral():
        pr = w.reshape(-1, 2)
        hb = pr[:, 0] - 0xD7C0  # (cp >> 10), 11 bits (see utf8 branch)
        cp = (hb.astype(jnp.uint32) << 10) | (pr[:, 1] & 0x3FF)
        cnt = length // 2
        out = jnp.pad(_mask_tail(cp, cnt, cp.shape[0]), (0, n - cp.shape[0]))
        return out, cnt

    return br_bmp, br_astral


def to_utf32(words: jnp.ndarray, length, big_endian: bool,
             routing: bool = DEVICE_ROUTING):
    """Returns (err_code, err_pos, out u32[N], out_len); census-routed;
    mixed input pays the general engine."""
    n = words.shape[0]

    def general():
        w = native(words, length, big_endian)
        err_pos, err_code = first_error(w, length)
        ok = err_pos == BIG
        cp, start = _codepoints(w, length)
        out, off, total = _emit_utf32(cp, start, n)
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
    w16 = _native16(words, big_endian)
    idx = positions(n)
    bmp = jnp.all(((w16 & 0xF800) != 0xD800) | (idx >= length))
    _, _, _, astral = census(w16, length)
    br_bmp, br_astral = _u32_fast_branches(w16, length, n)

    def wrap(br):
        def f():
            out, cnt = br()
            z = vlike(jnp.int32(0), out)
            return z, z + length, out, z + cnt
        return f

    return route([(bmp, wrap(br_bmp)), (astral, wrap(br_astral))], general)


def to_latin1(words: jnp.ndarray, length, big_endian: bool):
    """Returns (err_code, err_pos, out u8[N], out_len).
    scalar/utf16_to_latin1/utf16_to_latin1.h:35-91: first word > 0xFF is
    TOO_LARGE; surrogates are irrelevant."""
    n = words.shape[0]
    w = native(words, length, big_endian)
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


def to_latin1_valid(words: jnp.ndarray, length, big_endian: bool):
    """convert_valid_utf16_to_latin1: pure narrowing store. (out, total)."""
    w = native(words, length, big_endian)
    return (w & 0xFF).astype(jnp.uint8), length


def to_utf8_valid(words: jnp.ndarray, length, big_endian: bool,
                  routing: bool = DEVICE_ROUTING):
    """convert_valid_utf16_to_utf8: skips surrogate validation entirely
    (reference: per-arch convert_valid kernels). Returns (out u8[3N],
    total); census-routed like :func:`to_utf8`."""
    n = words.shape[0]

    def general():
        w = native(words, length, big_endian)
        cp, start = _codepoints(w, length)
        width = _utf8_widths(cp, start)
        out, _, total = _emit_utf8(cp, start, width, n)
        return out, jnp.int32(total)

    if not routing:
        return general()
    w16 = _native16(words, big_endian)
    ascii_, u2r, u3r, astral = census(w16, length)
    br_ascii, br_u2r, br_astral = _u8_fast_branches(w16, length, n)

    def wrap(br):
        def f():
            out, cnt = br()
            return out, vlike(jnp.int32(cnt), out)
        return f

    return route(
        [(ascii_, wrap(br_ascii)), (u2r, wrap(br_u2r)),
         (astral, wrap(br_astral))],
        general,
    )


def to_utf32_valid(words: jnp.ndarray, length, big_endian: bool,
                   routing: bool = DEVICE_ROUTING):
    n = words.shape[0]

    def general():
        w = native(words, length, big_endian)
        cp, start = _codepoints(w, length)
        out, _, total = _emit_utf32(cp, start, n)
        return out, jnp.int32(total)

    if not routing:
        return general()
    w16 = _native16(words, big_endian)
    idx = positions(n)
    bmp = jnp.all(((w16 & 0xF800) != 0xD800) | (idx >= length))
    _, _, _, astral = census(w16, length)
    br_bmp, br_astral = _u32_fast_branches(w16, length, n)

    def wrap(br):
        def f():
            out, cnt = br()
            return out, vlike(jnp.int32(cnt), out)
        return f

    return route([(bmp, wrap(br_bmp)), (astral, wrap(br_astral))], general)
