"""Shared helpers for the XLA tier."""

from __future__ import annotations

import jax.numpy as jnp

#: sentinel for "no error" positions; must exceed any buffer index.
#: Plain Python int: a jnp scalar created at import would live on the
#: default device and turn every jit lowering into a device fetch.
BIG = 2**31 - 1


def bswap16(w: jnp.ndarray) -> jnp.ndarray:
    """Byteswap the low 16 bits of each lane (the UTF-16 BE<->native
    step; one shared definition so every direction lowers identically)."""
    return ((w << 8) | (w >> 8)) & 0xFFFF


def shift_left(b: jnp.ndarray, k: int) -> jnp.ndarray:
    """out[i] = b[i+k], zero-filled past the end.

    Plays the role of the reference's ``prev<N>`` cross-block carries
    (src/simdutf/haswell/simd.h) but in the forward direction over the whole
    buffer: zero fill reproduces zero-padded-remainder semantics
    (generic/utf8_validation/utf8_validator.h:18-22).
    """
    if k == 0:
        return b
    return jnp.pad(b[k:], (0, k))


def shift_right(b: jnp.ndarray, k: int) -> jnp.ndarray:
    """out[i] = b[i-k], zero-filled before the start (lookback carry)."""
    if k == 0:
        return b
    return jnp.pad(b[:-k], (k, 0))


def positions(n: int) -> jnp.ndarray:
    return jnp.arange(n, dtype=jnp.int32)


def zero_tail(b: jnp.ndarray, length) -> jnp.ndarray:
    """Force bytes at/after ``length`` to zero so padded tails behave like
    the reference's zero-padded last block."""
    idx = positions(b.shape[0])
    return jnp.where(idx < length, b, 0)


# --- transcode-engine variants --------------------------------------------
# SIMDUTF_TPU_TRANSCODE_ENGINE is a '+'-separated combination of:
#   blkscan — blocked cumsum (row-wise scan + tiny row-offset scan)
#   uniq    — scatters pass unique_indices=True (drop targets made distinct)
#   nat     — scatter values in the OUTPUT dtype ("u16" accepted as alias),
#             eliminating the post-scatter astype pass (a full read+write
#             of the capacity buffer when the output is narrower than i32)
# Read once at import: the choice is baked into jit caches like the
# reference's one-time backend pick (src/implementation.cpp:1290).

import os as _os

ENGINE = frozenset(
    filter(None, _os.environ.get("SIMDUTF_TPU_TRANSCODE_ENGINE", "").split("+"))
)
_NAT = "nat" in ENGINE or "u16" in ENGINE
_BLK = 2048  # blkscan row width (divides every padded bucket size)

#: Device-tier structured-class routing: the
#: jitted transcode entry points census the input ON DEVICE (one fused
#: reduce pass) and lax.cond into a fixed-rate elementwise branch when the
#: whole buffer is one structural class (ASCII / uniform 2-, 3-, 4-byte /
#: BMP / astral pairs), paying the classify->scan->scatter engine only for
#: genuinely mixed input. This is the reference's per-block is_ascii
#: short-circuit (generic/utf8_to_utf16/utf8_to_utf16.h:237-240) lifted to
#: where the data lives, so the device API / batch / sharded paths all get
#: it — not just the host tier. The census predicates are EXACT in-class
#: validators, so a fast branch taken implies the input is valid and the
#: branch output is bit-identical to the general engine's.
#: This is only the default: every routed op takes ``routing`` as a
#: trace-time argument, so one process can compile both forms.
DEVICE_ROUTING = _os.environ.get("SIMDUTF_TPU_DEVICE_ROUTING", "1") != "0"


def u8_words(b_u8: jnp.ndarray) -> jnp.ndarray:
    """(N,) u8 -> (N/4,) int32 little-endian words (N % 4 == 0)."""
    from jax import lax

    return lax.bitcast_convert_type(b_u8.reshape(-1, 4), jnp.int32)


def vlike(x, ref: jnp.ndarray):
    """Tie scalar ``x``'s varying-manual-axes type to data array ``ref``'s
    by adding a zero derived from it. Under shard_map, lax.cond branches
    must agree on which mesh axes each output varies over; a fast branch's
    constant scalar (unvarying) must be promoted to match the general
    branch's data-dependent scalar (varying)."""
    return x + ref.reshape(-1)[0].astype(jnp.int32) * 0


def route(branches, default):
    """One-level lax.switch over class predicates: branches =
    [(pred_scalar, fn), ...]; every fn and default take no operands (close
    over traced values) and return identical pytrees. The first true
    predicate wins; ``default`` runs when none is true."""
    from jax import lax

    sel = None
    fns = [default]
    for i, (pred, fn) in enumerate(branches):
        p = jnp.asarray(pred)
        this = jnp.where(p, jnp.int32(i + 1), jnp.int32(0))
        sel = this if sel is None else jnp.where(sel > 0, sel, this)
        fns.append(fn)
    if sel is None:
        return default()
    return lax.switch(sel, fns)


def excl_scan(k32: jnp.ndarray, n: int):
    """Exclusive prefix sum of int32[n] -> (off, inclusive)."""
    if "blkscan" in ENGINE and n % _BLK == 0 and n > _BLK:
        x2 = k32.reshape(-1, _BLK)
        row_inc = jnp.cumsum(x2, axis=1)
        row_tot = row_inc[:, -1]
        row_off = jnp.cumsum(row_tot) - row_tot
        inc = (row_inc + row_off[:, None]).reshape(-1)
    else:
        inc = jnp.cumsum(k32)
    return inc - k32, inc


def scatter_writes(cap: int, out_dtype, writes):
    """Chained compaction scatters: out[off] = vals where mask, capacity
    ``cap``, others dropped. ``writes`` is a list of (mask, off, vals).
    Every transcode direction funnels through here so the engine variants
    above apply uniformly."""
    dt = out_dtype if _NAT else writes[0][2].dtype
    out = jnp.zeros(cap, dtype=dt)
    for mask, off, vals in writes:
        if _NAT:
            vals = vals.astype(dt)
        if "uniq" in ENGINE:
            idx = positions(mask.shape[0])
            tgt = jnp.where(mask, off, cap + idx)  # distinct OOB per drop
            out = out.at[tgt].set(vals, mode="drop", unique_indices=True)
        else:
            out = out.at[jnp.where(mask, off, cap)].set(vals, mode="drop")
    return out.astype(out_dtype)

