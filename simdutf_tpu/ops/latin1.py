"""Latin1 ops, XLA tier — pure widen/expand, no error paths.
Refs: src/scalar/latin1_to_utf8/latin1_to_utf8.h, latin1_to_utf16/32."""

from __future__ import annotations

import jax.numpy as jnp

from .common import (
    DEVICE_ROUTING,
    excl_scan,
    positions,
    route,
    scatter_writes,
    zero_tail,
)


def utf8_length(b: jnp.ndarray, length):
    idx = positions(b.shape[0])
    in_r = idx < length
    return jnp.sum(in_r) + jnp.sum((b >= 0x80) & in_r)


def to_utf8(b: jnp.ndarray, length, routing: bool = DEVICE_ROUTING):
    """Returns (out u8[2N], out_len); census-routed: an all-ASCII buffer
    (the dominant real-world Latin1 case) is a copy, an all-high buffer is
    a fixed-rate 1:2 expand; only mixed input pays the scatter engine."""
    n = b.shape[0]
    w = zero_tail(b.astype(jnp.int32), length)
    idx = positions(n)
    in_r = idx < length

    def general():
        hi = (w >= 0x80) & in_r
        width = jnp.where(in_r, 1, 0) + hi.astype(jnp.int32)
        off, off_inc = excl_scan(width, n)
        total = off_inc[n - 1]
        cap = 2 * n
        b0 = jnp.where(hi, (w >> 6) | 0xC0, w)
        out = scatter_writes(cap, jnp.uint8, [
            (in_r, off, b0),
            (hi, off + 1, (w & 0x3F) | 0x80),
        ])
        return out, jnp.int32(total)

    if not routing:
        return general()
    ascii_ = jnp.all((w < 0x80) | ~in_r)
    allhi = jnp.all((w >= 0x80) | ~in_r) & (length > 0)

    def br_ascii():
        return jnp.pad(w, (0, n)).astype(jnp.uint8), jnp.int32(length)

    def br_hi():
        b0 = (w >> 6) | 0xC0
        b1 = (w & 0x3F) | 0x80
        by = jnp.stack([b0, b1], 1).reshape(-1)
        by = jnp.where(positions(2 * n) < 2 * length, by, 0)
        return by.astype(jnp.uint8), jnp.int32(2 * length)

    return route([(ascii_, br_ascii), (allhi, br_hi)], general)


def to_utf16(b: jnp.ndarray, length, big_endian: bool):
    w = b.astype(jnp.int32)
    if big_endian:
        w = (w << 8) & 0xFFFF
    return w.astype(jnp.uint16)


def to_utf32(b: jnp.ndarray, length):
    return b.astype(jnp.uint32)
