"""UTF-8 ops, XLA tier.

Validation uses the event-minimum formulation (see golden/utf8.py for the
derivation): fully vectorized, no sequential scan, exact first-error parity
with the reference scalar machine (src/scalar/utf8.h:102-199). Transcoding
is classify -> exclusive prefix scan -> scatter, replacing the reference's
209-entry shuffle tables (src/tables/utf8_to_utf16_tables.h).

All functions take a padded uint8 buffer plus a dynamic scalar ``length``;
bytes at/after ``length`` are ignored (they are zeroed on entry, which is
semantically safe: generic/utf8_validation/utf8_validator.h:18-22).
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
    shift_right,
    u8_words,
    zero_tail,
)

# plain ints (not jnp scalars): device constants at import time would pin
# the default backend and slow every lowering
_TOO_SHORT = int(ec.TOO_SHORT)
_TOO_LONG = int(ec.TOO_LONG)
_OVERLONG = int(ec.OVERLONG)
_TOO_LARGE = int(ec.TOO_LARGE)
_SURROGATE = int(ec.SURROGATE)
_HEADER_BITS = int(ec.HEADER_BITS)


def classify(b_u8: jnp.ndarray, length):
    """Structural classification of a UTF-8 buffer.

    Returns dict of per-byte arrays:
      lead     bool  — non-continuation byte (sequence start in a valid parse)
      seqlen   i32   — declared sequence length at leads (1..4)
      cp       i32   — decoded codepoint at leads
      err      i32   — per-lead error code (0 = valid sequence)
      is_cont  bool
      c1..c3   bool  — is_cont at i+1..i+3 (zero-fill: False past the end)
    """
    b = zero_tail(b_u8.astype(jnp.int32), length)
    b1, b2, b3 = shift_left(b, 1), shift_left(b, 2), shift_left(b, 3)

    is_cont = (b & 0xC0) == 0x80
    c1 = (b1 & 0xC0) == 0x80
    c2 = (b2 & 0xC0) == 0x80
    c3 = (b3 & 0xC0) == 0x80

    ascii_ = b < 0x80
    lead2 = (b & 0xE0) == 0xC0
    lead3 = (b & 0xF0) == 0xE0
    lead4 = (b & 0xF8) == 0xF0
    badlead = b >= 0xF8

    cp2 = ((b & 0x1F) << 6) | (b1 & 0x3F)
    cp3 = ((b & 0x0F) << 12) | ((b1 & 0x3F) << 6) | (b2 & 0x3F)
    cp4 = ((b & 0x07) << 18) | ((b1 & 0x3F) << 12) | ((b2 & 0x3F) << 6) | (b3 & 0x3F)

    zero = jnp.zeros_like(b)
    err = zero
    err = jnp.where(lead2 & ~c1, _TOO_SHORT, err)
    err = jnp.where(lead2 & c1 & (cp2 < 0x80), _OVERLONG, err)
    ok3 = c1 & c2
    err = jnp.where(lead3 & ~ok3, _TOO_SHORT, err)
    err = jnp.where(lead3 & ok3 & (cp3 < 0x800), _OVERLONG, err)
    err = jnp.where(lead3 & ok3 & (cp3 >= 0xD800) & (cp3 <= 0xDFFF), _SURROGATE, err)
    ok4 = c1 & c2 & c3
    err = jnp.where(lead4 & ~ok4, _TOO_SHORT, err)
    err = jnp.where(lead4 & ok4 & (cp4 <= 0xFFFF), _OVERLONG, err)
    err = jnp.where(lead4 & ok4 & (cp4 > 0x10FFFF), _TOO_LARGE, err)
    err = jnp.where(badlead, _HEADER_BITS, err)

    seqlen = jnp.where(ascii_, 1, 0)
    seqlen = jnp.where(lead2, 2, seqlen)
    seqlen = jnp.where(lead3, 3, seqlen)
    seqlen = jnp.where(lead4, 4, seqlen)

    cp = jnp.where(ascii_, b, 0)
    cp = jnp.where(lead2, cp2, cp)
    cp = jnp.where(lead3, cp3, cp)
    cp = jnp.where(lead4, cp4, cp)

    return dict(
        b=b,
        lead=~is_cont,
        is_cont=is_cont,
        c1=c1,
        c2=c2,
        c3=c3,
        seqlen=seqlen,
        cp=cp,
        err=err,
        badlead=badlead,
        lead4=lead4,
    )


def _first_error_from(cls, length):
    """(err_pos, err_code); err_pos == BIG when valid."""
    n = cls["b"].shape[0]
    idx = positions(n)
    in_range = idx < length
    lead = cls["lead"] & in_range
    err = cls["err"]

    # (1) invalid lead sequences
    bad_lead = lead & (err != 0)
    pos1 = jnp.min(jnp.where(bad_lead, idx, BIG))
    k1 = jnp.argmin(jnp.where(bad_lead, idx, BIG))
    code1 = err[k1]
    # (2) unconsumed continuation after a valid sequence: is_cont at i+seqlen.
    # c1/c2/c3 are is_cont at i+1..3; c4 needed for 4-byte leads.
    seqlen = cls["seqlen"]
    gap = (
        ((seqlen == 1) & cls["c1"])
        | ((seqlen == 2) & cls["c2"])
        | ((seqlen == 3) & cls["c3"])
        | ((seqlen == 4) & shift_left(cls["is_cont"].astype(jnp.int32), 4).astype(bool))
    )
    good_lead = lead & (err == 0)
    pos2 = jnp.min(jnp.where(good_lead & gap, idx + seqlen, BIG))
    # (zero-tail makes bytes past length non-continuations, so pos2 < length
    # automatically)
    # (3) buffer starts with a continuation byte
    pos3 = jnp.where(cls["is_cont"][0] & (length > 0), 0, BIG)

    err_pos = jnp.minimum(jnp.minimum(pos1, pos2), pos3)
    err_code = jnp.where(
        err_pos == pos1, code1, _TOO_LONG
    )  # pos2/pos3 are both TOO_LONG
    err_code = jnp.where(err_pos == BIG, 0, err_code)
    return err_pos, err_code


def validate_with_errors(b: jnp.ndarray, length):
    """-> (err_code i32, err_pos i32); (0, length) on success."""
    cls = classify(b, length)
    pos, code = _first_error_from(cls, length)
    ok = pos == BIG
    return jnp.where(ok, 0, code), jnp.where(ok, length, pos)


def validate(b: jnp.ndarray, length):
    code, _ = validate_with_errors(b, length)
    return code == 0


def validate_ascii_with_errors(b: jnp.ndarray, length):
    idx = positions(b.shape[0])
    bad = (b >= 0x80) & (idx < length)
    pos = jnp.min(jnp.where(bad, idx, BIG))
    ok = pos == BIG
    return (
        jnp.where(ok, 0, _TOO_LARGE),
        jnp.where(ok, length, pos),
    )


def count_code_points(b: jnp.ndarray, length):
    idx = positions(b.shape[0])
    return jnp.sum(((b & 0xC0) != 0x80) & (idx < length))


def utf16_length(b: jnp.ndarray, length):
    idx = positions(b.shape[0])
    in_r = idx < length
    return jnp.sum(((b & 0xC0) != 0x80) & in_r) + jnp.sum((b >= 0xF0) & in_r)




def census(b: jnp.ndarray, length):
    """One-pass structural census for device-tier routing (the reference's
    per-block is_ascii short-circuit, utf8_to_utf16.h:237-240, lifted to
    corpus scale). Returns scalar bools (ascii, u2, u3, u4): each is an
    EXACT validity proof for its class — a True means the whole in-range
    buffer is valid UTF-8 consisting solely of that sequence width — so a
    fast branch taken on it may skip the error lattice entirely.

    All predicates are elementwise masks + reductions over one read of the
    buffer, in uint8 arithmetic throughout — no widened (4N-byte)
    temporaries; range checks on the decoded value are re-expressed as
    byte-wise compares (E0 needs b1>=A0, ED needs b1<=9F, F0 needs b1>=90,
    F4 needs b1<=8F — the scalar machine's own boundary cases). XLA fuses
    everything into a single pass.
    """
    n = b.shape[0]
    b = b.astype(jnp.uint8)
    idx = positions(n)
    in_r = idx < length
    b1 = shift_left(b, 1)
    cont = (b & 0xC0) == 0x80
    c1 = (b1 & 0xC0) == 0x80

    ascii_ = ~jnp.any((b >= 0x80) & in_r)

    # uniform 2-byte: even positions are C2..DF leads, odd are
    # continuations — exactly the valid encodings of U+0080..U+07FF
    ok2 = jnp.where((idx & 1) == 0, (b >= 0xC2) & (b <= 0xDF), cont)
    u2 = jnp.all(ok2 | ~in_r) & (length % 2 == 0) & (length > 0)

    # uniform 3-byte: stride-3 E0..EF leads with cp in [0x800, 0xFFFF]
    # minus surrogates: overlong (E0 80-9F) and surrogate (ED A0-BF)
    # encodings are excluded by first-continuation bounds
    lead3ok = (
        ((b & 0xF0) == 0xE0)
        & c1
        & ~((b == 0xE0) & (b1 < 0xA0))
        & ~((b == 0xED) & (b1 >= 0xA0))
    )
    ok3 = jnp.where(idx % 3 == 0, lead3ok, cont)
    u3 = jnp.all(ok3 | ~in_r) & (length % 3 == 0) & (length > 0)

    # uniform 4-byte (astral-only: emoji streams): stride-4 F0..F4 leads
    # with cp in [0x10000, 0x10FFFF]: F0 90-BF.., F1-F3 80-BF.., F4 80-8F..
    lead4ok = (
        (b >= 0xF0) & (b <= 0xF4)
        & c1
        & ~((b == 0xF0) & (b1 < 0x90))
        & ~((b == 0xF4) & (b1 >= 0x90))
    )
    ok4 = jnp.where((idx & 3) == 0, lead4ok, cont)
    u4 = jnp.all(ok4 | ~in_r) & (length % 4 == 0) & (length > 0)
    return ascii_, u2, u3, u4


def _mask_units(units, count):
    """Zero units at/after ``count`` so fast-branch buffers match the
    general engine's zeros-past-out_len exactly."""
    idx = positions(units.shape[0])
    return jnp.where(idx < count, units, 0)


def _swp16(u, big_endian: bool):
    if not big_endian:
        return u
    u = u.astype(jnp.uint16)
    return (u << 8) | (u >> 8)


def _pair_u16_stream(lo, hi):
    """Interleave two u16-value int32 planes into a flat u16 stream
    (lo unit first) by packing each pair into one int32 word."""
    from jax import lax

    w = (lo & 0xFFFF) | (hi << 16)
    return lax.bitcast_convert_type(w, jnp.uint16).reshape(-1)


def _u16_fast_branches(b, length, n, big_endian: bool):
    """The four fixed-rate utf8->utf16 branches; each returns
    (out u16[n], out_len) bit-identical to the general engine on its
    class: no scan, no scatter. The 2- and 4-byte classes read whole
    int32 words."""

    def words():
        return u8_words(jnp.pad(b, (0, -n % 4)))

    def fit(u):
        return jnp.pad(u, (0, max(n - u.shape[0], 0)))[:n]

    def br_ascii():
        u = jnp.where(positions(n) < length, b, 0).astype(jnp.uint16)
        return _swp16(u, big_endian), length

    def br_u2():
        cnt = length // 2
        w = words()  # 2 units per word
        u_lo = ((w & 0x1F) << 6) | ((w >> 8) & 0x3F)
        u_hi = (((w >> 16) & 0x1F) << 6) | ((w >> 24) & 0x3F)
        u = _pair_u16_stream(
            _swp16(u_lo, big_endian).astype(jnp.int32),
            _swp16(u_hi, big_endian).astype(jnp.int32))
        return fit(_mask_units(u, cnt)), cnt

    def br_u3():
        cnt = length // 3
        n3 = n // 3 * 3
        tr = b[:n3].astype(jnp.uint16).reshape(-1, 3)
        u = (((tr[:, 0] & 0x0F) << 12) | ((tr[:, 1] & 0x3F) << 6)
             | (tr[:, 2] & 0x3F))
        u = _mask_units(_swp16(u, big_endian), cnt)
        return jnp.pad(u, (0, n - u.shape[0])), cnt

    def br_u4():
        cnt = length // 2
        w = words()  # one astral codepoint per word
        b0, b1 = w & 0xFF, (w >> 8) & 0xFF
        b2, b3 = (w >> 16) & 0xFF, (w >> 24) & 0xFF
        # surrogates from bytes without materializing the 21-bit cp:
        #   hi = D800 + (cp-0x10000)>>10, cp>>10 = ((b0&7)<<8)|((b1&3F)<<2)
        #        |((b2>>4)&3), so hi = D7C0 + that (the -0x10000 folds in)
        hi = 0xD7C0 + (((b0 & 0x07) << 8) | ((b1 & 0x3F) << 2)
                       | ((b2 >> 4) & 0x03))
        lo = 0xDC00 + (((b2 & 0x0F) << 6) | (b3 & 0x3F))
        u = _pair_u16_stream(
            _swp16(hi, big_endian).astype(jnp.int32),
            _swp16(lo, big_endian).astype(jnp.int32))
        return fit(_mask_units(u, cnt)), cnt

    return br_ascii, br_u2, br_u3, br_u4


def _emit_utf16_units(cp, lead, lead4, n, big_endian: bool):
    """Emit UTF-16 units with the unit-per-byte reformulation: unit0 is
    carried by the lead byte, unit1 (astral chars only) by the byte right
    after the lead, so per-byte widths are 0/1 and ONE scatter suffices
    (vs the reference's shuffle-table packing,
    src/haswell/avx2_convert_utf8_to_utf16.cpp:7-130). Returns
    (out u16[n], off, total) where off[i] = units written before byte i
    (the partial-output count at an error position)."""
    cpx = cp - 0x10000
    unit0 = jnp.where(cp > 0xFFFF, 0xD800 + (cpx >> 10), cp)
    unit1 = 0xDC00 + (cpx & 0x3FF)
    if big_endian:
        unit0 = bswap16(unit0)
        unit1 = bswap16(unit1)
    after_lead4 = shift_right((lead & lead4).astype(jnp.int32), 1).astype(bool)
    keep = lead | after_lead4
    val = jnp.where(after_lead4, shift_right(unit1, 1), unit0)
    k32 = keep.astype(jnp.int32)
    off, off_inc = excl_scan(k32, n)
    total = off_inc[n - 1]
    out = scatter_writes(n, jnp.uint16, [(keep, off, val)])
    return out, off, total


def _to_utf16_general(b: jnp.ndarray, length, big_endian: bool):
    """The general mixed-script engine: classify -> scan -> scatter.
    Units at/after out_len are zeroed (on error the raw scatter leaves
    mechanically-decoded units past the valid prefix; the zero convention
    makes every path's full buffer bit-identical, not just the prefix)."""
    n = b.shape[0]
    idx = positions(n)
    cls = classify(b, length)
    err_pos, err_code = _first_error_from(cls, length)
    ok = err_pos == BIG

    lead = cls["lead"] & (idx < length)
    out, off, total = _emit_utf16_units(
        cls["cp"], lead, cls["lead4"], n, big_endian
    )
    # on error, units written = offset at the error position
    clamped = jnp.minimum(err_pos, n - 1)
    # off[0] == 0 for an exclusive scan, so err_pos == 0 needs no special case
    out_len = jnp.where(ok, total, off[clamped])
    out = jnp.where(idx < out_len, out, 0)
    return jnp.where(ok, 0, err_code), jnp.where(ok, length, err_pos), out, out_len


def to_utf16(b: jnp.ndarray, length, big_endian: bool,
             routing: bool = DEVICE_ROUTING):
    """Validating transcode. With ``routing``, a one-pass device census
    sends whole-buffer structured classes (ASCII / uniform 2/3/4-byte) to
    fixed-rate elementwise branches (their census predicate IS the
    validity proof); mixed input pays the general engine as the switch's
    default branch.

    Returns (err_code, err_pos, out u16[N], out_len). On error out_len is
    the number of units for the valid prefix (scalar-machine partial
    output); units at/after out_len are zero. Output capacity N is exact
    worst case (1 unit/byte).
    """
    n = b.shape[0]
    if not routing:
        return _to_utf16_general(b, length, big_endian)
    ascii_, u2, u3, u4 = census(b, length)
    br_ascii, br_u2, br_u3, br_u4 = _u16_fast_branches(b, length, n, big_endian)

    def wrap(br):
        def f():
            out, cnt = br()
            z = vlike(jnp.int32(0), out)
            return z, z + length, out, z + cnt
        return f

    return route(
        [(ascii_, wrap(br_ascii)), (u2, wrap(br_u2)),
         (u3, wrap(br_u3)), (u4, wrap(br_u4))],
        lambda: _to_utf16_general(b, length, big_endian),
    )


def _u32_fast_branches(b, length, n):
    """Fixed-rate utf8->utf32 branches (see :func:`_u16_fast_branches`);
    per-branch narrow temporaries only (uint16 until the final widen where
    the codepoint fits, uint32 reshapes for the astral class)."""

    def br_ascii():
        u = jnp.where(positions(n) < length, b, 0)
        return u.astype(jnp.uint32), length

    def br_u2():
        pr = b.astype(jnp.uint16).reshape(-1, 2)
        u = ((pr[:, 0] & 0x1F) << 6) | (pr[:, 1] & 0x3F)
        cnt = length // 2
        out = jnp.pad(_mask_units(u, cnt), (0, n - u.shape[0]))
        return out.astype(jnp.uint32), cnt

    def br_u3():
        n3 = n // 3 * 3
        tr = b[:n3].astype(jnp.uint16).reshape(-1, 3)
        u = (
            ((tr[:, 0] & 0x0F) << 12) | ((tr[:, 1] & 0x3F) << 6)
            | (tr[:, 2] & 0x3F)
        )
        cnt = length // 3
        out = jnp.pad(_mask_units(u, cnt), (0, n - u.shape[0]))
        return out.astype(jnp.uint32), cnt

    def br_u4():
        q = b.astype(jnp.uint32).reshape(-1, 4)
        cp = (
            ((q[:, 0] & 0x07) << 18) | ((q[:, 1] & 0x3F) << 12)
            | ((q[:, 2] & 0x3F) << 6) | (q[:, 3] & 0x3F)
        )
        cnt = length // 4
        out = jnp.pad(_mask_units(cp, cnt), (0, n - cp.shape[0]))
        return out.astype(jnp.uint32), cnt

    return br_ascii, br_u2, br_u3, br_u4


def _to_utf32_general(b: jnp.ndarray, length):
    n = b.shape[0]
    idx = positions(n)
    cls = classify(b, length)
    err_pos, err_code = _first_error_from(cls, length)
    ok = err_pos == BIG

    lead = cls["lead"] & (idx < length)
    width = lead.astype(jnp.int32)
    off, off_inc = excl_scan(width, n)
    total = off_inc[n - 1]
    out = scatter_writes(n, jnp.uint32, [(lead, off, cls["cp"])])
    clamped = jnp.minimum(err_pos, n - 1)
    # off[0] == 0 for an exclusive scan, so err_pos == 0 needs no special case
    out_len = jnp.where(ok, total, off[clamped])
    return (
        jnp.where(ok, 0, err_code),
        jnp.where(ok, length, err_pos),
        out,
        out_len,
    )


def to_utf32(b: jnp.ndarray, length, routing: bool = DEVICE_ROUTING):
    """Returns (err_code, err_pos, out u32[N], out_len); census-routed
    like :func:`to_utf16`; mixed input pays the general engine."""
    if not routing:
        return _to_utf32_general(b, length)
    n = b.shape[0]
    ascii_, u2, u3, u4 = census(b, length)
    br_ascii, br_u2, br_u3, br_u4 = _u32_fast_branches(b, length, n)

    def wrap(br):
        def f():
            out, cnt = br()
            z = vlike(jnp.int32(0), out)
            return z, z + length, out, z + cnt
        return f

    return route(
        [(ascii_, wrap(br_ascii)), (u2, wrap(br_u2)),
         (u3, wrap(br_u3)), (u4, wrap(br_u4))],
        lambda: _to_utf32_general(b, length),
    )


def to_latin1(b: jnp.ndarray, length):
    """utf8 -> latin1 with its own error lattice
    (scalar/utf8_to_latin1/utf8_to_latin1.h:174-252)."""
    n = b.shape[0]
    idx = positions(n)
    bb = zero_tail(b.astype(jnp.int32), length)
    b1 = shift_left(bb, 1)
    is_cont = (bb & 0xC0) == 0x80
    ascii_ = bb < 0x80
    lead2 = (bb & 0xE0) == 0xC0
    lead34 = ((bb & 0xF0) == 0xE0) | ((bb & 0xF8) == 0xF0)
    badlead = bb >= 0xF8
    c1 = (b1 & 0xC0) == 0x80
    cp2 = ((bb & 0x1F) << 6) | (b1 & 0x3F)

    err = jnp.zeros(n, dtype=jnp.int32)
    err = jnp.where(lead2 & ~c1, _TOO_SHORT, err)
    err = jnp.where(lead2 & c1 & (cp2 < 0x80), _OVERLONG, err)
    err = jnp.where(lead2 & c1 & (cp2 > 0xFF), _TOO_LARGE, err)
    err = jnp.where(lead34, _TOO_LARGE, err)
    err = jnp.where(badlead, _HEADER_BITS, err)

    in_r = idx < length
    lead = ~is_cont & in_r
    bad_lead = lead & (err != 0)
    pos1 = jnp.min(jnp.where(bad_lead, idx, BIG))
    code1 = err[jnp.argmin(jnp.where(bad_lead, idx, BIG))]
    seqlen = jnp.where(ascii_, 1, 2)
    c2 = (shift_left(bb, 2) & 0xC0) == 0x80
    gap = ((seqlen == 1) & c1) | ((seqlen == 2) & c2)
    good_lead = lead & (err == 0)
    pos2 = jnp.min(jnp.where(good_lead & gap, idx + seqlen, BIG))
    pos3 = jnp.where(is_cont[0] & (length > 0), 0, BIG)
    err_pos = jnp.minimum(jnp.minimum(pos1, pos2), pos3)
    err_code = jnp.where(err_pos == pos1, code1, _TOO_LONG)
    ok = err_pos == BIG

    width = lead.astype(jnp.int32)
    off, off_inc = excl_scan(width, n)
    total = off_inc[n - 1]
    vals = jnp.where(ascii_, bb, cp2)
    out = scatter_writes(n, jnp.uint8, [(lead, off, vals)])
    clamped = jnp.minimum(err_pos, n - 1)
    # off[0] == 0 for an exclusive scan, so err_pos == 0 needs no special case
    out_len = jnp.where(ok, total, off[clamped])
    return (
        jnp.where(ok, 0, err_code),
        jnp.where(ok, length, err_pos),
        out,
        out_len,
    )


def to_latin1_valid(b: jnp.ndarray, length):
    """convert_valid_utf8_to_latin1: valid Latin1-range UTF-8 has only
    ASCII + 2-byte sequences, so this skips the whole error lattice
    (reference: valid_utf8_to_latin1.h). Returns (out u8[N], total)."""
    n = b.shape[0]
    idx = positions(n)
    bb = zero_tail(b.astype(jnp.int32), length)
    b1 = shift_left(bb, 1)
    lead = ((bb & 0xC0) != 0x80) & (idx < length)
    vals = jnp.where(bb < 0x80, bb, ((bb & 0x1F) << 6) | (b1 & 0x3F))
    k32 = lead.astype(jnp.int32)
    off, off_inc = excl_scan(k32, n)
    total = off_inc[n - 1]
    out = scatter_writes(n, jnp.uint8, [(lead, off, vals)])
    return out, total


def to_utf16_valid(b: jnp.ndarray, length, big_endian: bool,
                   routing: bool = DEVICE_ROUTING):
    """convert_valid_utf8_to_utf16*: assumes valid input, skips the error
    events entirely (reference: generic/utf8_to_utf16/valid_utf8_to_utf16.h).
    Returns (out u16[N], out_len); census-routed like :func:`to_utf16`."""
    n = b.shape[0]

    def general():
        idx = positions(n)
        cls = classify(b, length)
        lead = cls["lead"] & (idx < length)
        out, _, total = _emit_utf16_units(
            cls["cp"], lead, cls["lead4"], n, big_endian
        )
        return out, jnp.int32(total)

    if not routing:
        return general()
    ascii_, u2, u3, u4 = census(b, length)
    br_ascii, br_u2, br_u3, br_u4 = _u16_fast_branches(b, length, n, big_endian)

    def wrap(br):
        def f():
            out, cnt = br()
            return out, vlike(jnp.int32(cnt), out)
        return f

    return route(
        [(ascii_, wrap(br_ascii)), (u2, wrap(br_u2)),
         (u3, wrap(br_u3)), (u4, wrap(br_u4))],
        general,
    )


def to_utf32_valid(b: jnp.ndarray, length, routing: bool = DEVICE_ROUTING):
    n = b.shape[0]

    def general():
        idx = positions(n)
        cls = classify(b, length)
        lead = cls["lead"] & (idx < length)
        width = lead.astype(jnp.int32)
        off, off_inc = excl_scan(width, n)
        total = off_inc[n - 1]
        out = scatter_writes(n, jnp.uint32, [(lead, off, cls["cp"])])
        return out, jnp.int32(total)

    if not routing:
        return general()
    ascii_, u2, u3, u4 = census(b, length)
    br_ascii, br_u2, br_u3, br_u4 = _u32_fast_branches(b, length, n)

    def wrap(br):
        def f():
            out, cnt = br()
            return out, vlike(jnp.int32(cnt), out)
        return f

    return route(
        [(ascii_, wrap(br_ascii)), (u2, wrap(br_u2)),
         (u3, wrap(br_u3)), (u4, wrap(br_u4))],
        general,
    )
