"""Base64 ops, XLA tier.

Decode bulk = 256-entry table gather (the to_base64 classification of
src/tables/base64_tables.h) + whitespace/garbage compaction by exclusive
prefix scan + 4->3 bit repack. The branchy tail (< 4 chars + padding
consistency, scalar/base64.h:133-216) stays on the host: it touches O(1)
data and the full options matrix.

Device outputs per call:
  first_bad   i32  — index of first invalid char (BIG when none)
  nvalid      i32  — number of alphabet chars
  nvalid_at_bad i32 — alphabet chars strictly before first_bad
  packed      u8[3*cap/4] — decoded bytes of whole 4-char groups
  tail_vals   u8[4]  — the last (nvalid % 4) sextets
  tail_start  i32  — source index of the first char of the partial chunk
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..golden import base64_impl as gb
from .common import BIG, excl_scan, positions, scatter_writes, u8_words


_ALPHA_CACHE = None


def alphabet_for(options: int) -> jnp.ndarray:
    """Device-resident encode alphabet, cached (decode tables likewise)."""
    global _ALPHA_CACHE
    import numpy as np

    if _ALPHA_CACHE is None:
        _ALPHA_CACHE = {
            0: jnp.asarray(np.frombuffer(gb._STD, dtype=np.uint8)),
            1: jnp.asarray(np.frombuffer(gb._URL, dtype=np.uint8)),
        }
    return _ALPHA_CACHE[options & gb.BASE64_URL]


def classify_chars(c: jnp.ndarray, url: bool, both: bool) -> jnp.ndarray:
    """Range-compare classification (no table gather). Matches the
    to_base64* value tables (src/tables/base64_tables.h): 0..63 alphabet
    value, 64 ASCII space, 255 invalid."""
    v = jnp.full_like(c, 255)
    v = jnp.where((c >= 65) & (c <= 90), c - 65, v)  # A-Z
    v = jnp.where((c >= 97) & (c <= 122), c - 71, v)  # a-z
    v = jnp.where((c >= 48) & (c <= 57), c + 4, v)  # 0-9
    if both or not url:
        v = jnp.where(c == 43, 62, v)  # '+'
        v = jnp.where(c == 47, 63, v)  # '/'
    if both or url:
        v = jnp.where(c == 45, 62, v)  # '-'
        v = jnp.where(c == 95, 63, v)  # '_'
    for sp in (32, 9, 10, 13, 12):
        v = jnp.where(c == sp, 64, v)
    return v


def sextets_to_bytes(vals_u8: jnp.ndarray, n: int) -> jnp.ndarray:
    """u8[n] compacted sextet values (n % 4 == 0; zeros beyond the valid
    prefix) -> u8[3n/4] decoded bytes: the 4 sextets of each group are
    one little-endian int32 word, repacked 4->3 (the 64-char-block bulk
    repack of src/generic/base64.h:43-246)."""
    w = u8_words(vals_u8)
    t = (((w & 0xFF) << 18) | (((w >> 8) & 0xFF) << 12)
         | (((w >> 16) & 0xFF) << 6) | ((w >> 24) & 0xFF))
    packed = jnp.stack([(t >> 16) & 0xFF, (t >> 8) & 0xFF, t & 0xFF], axis=1)
    return packed.reshape(-1).astype(jnp.uint8)


def decode_bulk(chars: jnp.ndarray, length, url: bool, both: bool):
    """chars: padded uint8[N] (N % 4 == 0) or uint16 for char16 input."""
    n = chars.shape[0]
    idx = positions(n)
    in_r = idx < length
    if chars.dtype == jnp.uint16:
        c = chars.astype(jnp.int32)
        codes = jnp.where(c > 0xFF, 255, classify_chars(c & 0xFF, url, both))
    else:
        codes = classify_chars(chars.astype(jnp.int32), url, both)

    valid = (codes <= 63) & in_r
    invalid = (codes > 64) & in_r
    bad_positions = jnp.where(invalid, idx, BIG)
    first_bad = jnp.min(bad_positions)

    vmask = valid.astype(jnp.int32)
    rank, rank_inc = excl_scan(vmask, n)
    nvalid = rank_inc[n - 1]
    clamped_bad = jnp.minimum(first_bad, n - 1)
    nvalid_at_bad = jnp.where(first_bad == 0, 0, rank[clamped_bad])

    vals = scatter_writes(n, jnp.uint8, [(valid, rank, codes)])
    packed = sextets_to_bytes(vals, n)

    nfull = (nvalid // 4) * 4
    tail_vals = jnp.stack(
        [vals[jnp.minimum(nfull + i, n - 1)] for i in range(4)]
    )
    # source index of the rank-nfull kept char by masked min-reduce
    hit = valid & (rank == nfull)
    tail_start = jnp.where(
        nvalid > nfull, jnp.min(jnp.where(hit, idx, BIG)), length
    )
    return first_bad, nvalid, nvalid_at_bad, packed, tail_vals, tail_start


def _unclassify(v, url: bool):
    """6-bit value -> char byte (inverse range mapping, no table; identical
    to the to_base64/url alphabets of src/tables/base64_tables.h)."""
    c = v + 65
    c = jnp.where(v >= 26, v + 71, c)
    c = jnp.where(v >= 52, v - 4, c)
    c = jnp.where(v == 62, 45 if url else 43, c)
    c = jnp.where(v == 63, 95 if url else 47, c)
    return c


def encode_bulk(data: jnp.ndarray, url: bool):
    """data: padded uint8[N] with N % 3 == 0. Encodes whole 3-byte groups
    (the caller slices the valid prefix on the host and appends the
    <=2-byte tail + padding). Returns u8[4N/3]."""
    n = data.shape[0]
    d = data.astype(jnp.int32).reshape(n // 3, 3)
    t = (d[:, 0] << 16) | (d[:, 1] << 8) | d[:, 2]
    quads = jnp.stack(
        [(t >> 18) & 63, (t >> 12) & 63, (t >> 6) & 63, t & 63], axis=1
    ).reshape(-1)
    return _unclassify(quads, url).astype(jnp.uint8)
