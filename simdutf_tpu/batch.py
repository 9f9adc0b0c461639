"""Batch API: process many byte strings in one device program.

The reference is a one-buffer-per-call library; serving workloads on an
accelerator want the opposite — a batch of documents validated, measured
or transcoded in a single vmapped program, so the device is fed one large
launch instead of thousands of small ones. This is the device-side extension of the
reference's "users shard across threads" scaling story
(benchmarks/threaded.cpp).

Inputs: a list of bytes-like objects. They are packed into one (B, L)
uint8 matrix (L = padded max length, power-of-two bucketed to keep the jit
cache small) with a per-row length vector; results come back per-row.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .errors import Result, error_code as ec
from .ops import utf8 as o8
from .runtime import staging_buffer, tune_host_allocator

_MIN_L = 256
_MIN_B = 8


def _bucket_rows(n: int) -> int:
    """Pad the batch dimension to a power of two (>= _MIN_B): like L, the
    row count is a compiled shape, so bucketing keeps the jit cache and
    compile latency bounded across serving batch sizes (pad rows are
    zero-length and sliced off the results)."""
    return 1 << (max(n, _MIN_B) - 1).bit_length()

try:  # C row packer (memcpy loop) — the Python per-row loop dominates
    from . import _cnative as _C  # host time for big batches of small items

    _HAVE_CPACK = hasattr(_C, "pack_batch")
except Exception:  # extension not built
    _C, _HAVE_CPACK = None, False


def _fill_rows(buf: np.ndarray, arrs) -> None:
    """Copy each item into its row of the (B, L) staging buffer, zeroing
    row tails. C memcpy path when the extension is built."""
    if _HAVE_CPACK:
        rowbytes = buf.shape[1] * buf.dtype.itemsize
        flat = buf.reshape(-1).view(np.uint8)
        try:
            # buffer protocol reads each item zero-copy (bytes or any
            # C-contiguous array); non-contiguous items fall through
            _C.pack_batch(arrs, flat, rowbytes)
            return
        except (BufferError, TypeError):
            pass
    for i, a in enumerate(arrs):
        k = a.shape[0]
        buf[i, :k] = a
        buf[i, k:] = 0


def _pack_matrix(arrs, item_lens, dtype, tag: str, row_align: int = 1):
    """Shared packing recipe: bucket L (and optionally align it) and B,
    zero-fill pad rows, memcpy items in. ``item_lens`` are the per-item
    logical lengths in ``dtype`` units (may be shorter than the items when
    a stripped prefix is being packed)."""
    item_lens = list(item_lens)
    maxlen = max(item_lens, default=1)
    L = 1 << (max(maxlen + 8, _MIN_L) - 1).bit_length()
    L += (row_align - L % row_align) % row_align
    B = _bucket_rows(len(arrs))
    lens = np.zeros(B, dtype=np.int32)
    lens[: len(arrs)] = item_lens
    buf = staging_buffer((B, L), dtype, fill_len=B * L, tag=tag)
    _fill_rows(buf, arrs)
    return buf, lens


def _pack(items: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    tune_host_allocator()
    arrs = [
        a if isinstance(a, np.ndarray) else np.frombuffer(memoryview(a), np.uint8)
        for a in items
    ]
    return _pack_matrix(arrs, (a.shape[0] for a in arrs), np.uint8, "batch")


_j_validate_batch = jax.jit(jax.vmap(o8.validate_with_errors))
_j_count_batch = jax.jit(jax.vmap(o8.count_code_points))
_j_u16len_batch = jax.jit(jax.vmap(o8.utf16_length))


def validate_utf8_batch(items: Sequence[bytes]) -> list[Result]:
    """Per-item validate_utf8_with_errors, one device launch."""
    if not items:
        return []
    buf, lens = _pack(items)
    codes, poss = (np.asarray(x) for x in _j_validate_batch(buf, lens))
    return [
        Result(ec(int(codes[i])), int(poss[i])) for i in range(len(items))
    ]


def count_utf8_batch(items: Sequence[bytes]) -> np.ndarray:
    """Per-item codepoint counts (int64 ndarray), one device launch."""
    if not items:
        return np.zeros(0, dtype=np.int64)
    buf, lens = _pack(items)
    out = np.asarray(_j_count_batch(buf, lens)).astype(np.int64)
    return out[: len(items)]


def utf16_length_from_utf8_batch(items: Sequence[bytes]) -> np.ndarray:
    if not items:
        return np.zeros(0, dtype=np.int64)
    buf, lens = _pack(items)
    out = np.asarray(_j_u16len_batch(buf, lens)).astype(np.int64)
    return out[: len(items)]


_j_transcode_batch = jax.jit(
    jax.vmap(lambda b, n: o8.to_utf16(b, n, False))
)


@functools.partial(jax.jit, static_argnames=("dtype",))
def _j_ascii_recode(buf, lens, dtype):
    """Whole-batch ASCII fast path: every in-range unit < 0x80 makes the
    transcode a per-unit width change at a fixed 1:1 rate, so item i's
    output lands in row i (the reference's per-block is_ascii
    short-circuit, generic/utf8_to_utf16/utf8_to_utf16.h:237-240, at
    batch scale). Returns (rows with zeros past each length, all_ascii)."""
    in_r = jnp.arange(buf.shape[1])[None, :] < lens[:, None]
    ok = ~jnp.any((buf >= 0x80) & in_r)
    return jnp.where(in_r, buf, 0).astype(dtype), ok


def _ascii_batch(buf: np.ndarray, lens: np.ndarray, n_items: int, dtype):
    """(n_items, L) matrix of ``dtype`` units when every item is ASCII,
    else None. A strided host peek at the item rows skips the launch for
    most non-ASCII batches; the device pass is the proof."""
    sample = buf[:n_items, :: max(1, buf.shape[1] // 64)]
    if sample.size == 0 or int(sample.max()) >= 0x80:
        return None
    out, ok = _j_ascii_recode(buf, lens, dtype=dtype)
    if not bool(ok):
        return None
    return np.asarray(out)[:n_items]


def convert_utf8_to_utf16le_batch(
    items: Sequence[bytes],
) -> list[tuple[Result, bytes]]:
    """Per-item validating transcode, one device launch.
    Returns [(Result, utf16le_bytes)] with the host API's semantics."""
    if not items:
        return []
    buf, lens = _pack(items)
    fast = _ascii_batch(buf, lens, len(items), jnp.uint16)
    if fast is not None:
        return [
            (Result(ec.SUCCESS, int(lens[i])),
             fast[i, : int(lens[i])].tobytes())
            for i in range(len(items))
        ]
    codes, poss, outs, out_lens = (
        np.asarray(x) for x in _j_transcode_batch(buf, lens)
    )
    results = []
    for i in range(len(items)):
        code, out_len = int(codes[i]), int(out_lens[i])
        payload = outs[i, :out_len].tobytes()
        if code == 0:
            results.append((Result(ec.SUCCESS, out_len), payload))
        else:
            results.append((Result(ec(code), int(poss[i])), payload))
    return results


from .ops import utf16 as o16  # noqa: E402

_j_validate16_batch = jax.jit(
    jax.vmap(lambda w, n: o16.validate_with_errors(w, n, False))
)
_j_u16_to_u8_batch = jax.jit(jax.vmap(lambda w, n: o16.to_utf8(w, n, False)))


def _pack16(items: Sequence[bytes]) -> tuple[np.ndarray, np.ndarray]:
    tune_host_allocator()
    arrs = []
    for a in items:
        if isinstance(a, np.ndarray) and a.dtype == np.uint16:
            arrs.append(a)
        else:
            raw = np.frombuffer(memoryview(a), np.uint8)
            if raw.shape[0] % 2:
                raise ValueError("UTF-16 items must have even byte length")
            arrs.append(raw.view(np.uint16))
    return _pack_matrix(arrs, (a.shape[0] for a in arrs), np.uint16,
                        "batch16")


def validate_utf16le_batch(items: Sequence[bytes]) -> list[Result]:
    if not items:
        return []
    buf, lens = _pack16(items)
    codes, poss = (np.asarray(x) for x in _j_validate16_batch(buf, lens))
    return [
        Result(ec(int(codes[i])), int(poss[i])) for i in range(len(items))
    ]


def convert_utf16le_to_utf8_batch(
    items: Sequence[bytes],
) -> list[tuple[Result, bytes]]:
    if not items:
        return []
    buf, lens = _pack16(items)
    fast = _ascii_batch(buf, lens, len(items), jnp.uint8)
    if fast is not None:
        return [
            (Result(ec.SUCCESS, int(lens[i])),
             fast[i, : int(lens[i])].tobytes())
            for i in range(len(items))
        ]
    codes, poss, outs, out_lens = (
        np.asarray(x) for x in _j_u16_to_u8_batch(buf, lens)
    )
    results = []
    for i in range(len(items)):
        code, out_len = int(codes[i]), int(out_lens[i])
        payload = outs[i, :out_len].tobytes()
        if code == 0:
            results.append((Result(ec.SUCCESS, out_len), payload))
        else:
            results.append((Result(ec(code), int(poss[i])), payload))
    return results


# --- base64 batch --------------------------------------------------------------

from .errors import FullResult  # noqa: E402
from .golden import base64_impl as gb  # noqa: E402
from .ops import base64_ops  # noqa: E402
from .ops.impl import b64_finish, b64_strip  # noqa: E402


@functools.partial(jax.jit, static_argnames=("url", "both"))
def _j_b64dec_batch(chars, lens, url, both):
    return jax.vmap(
        lambda c, n: base64_ops.decode_bulk(c, n, url, both)
    )(chars, lens)


@functools.partial(jax.jit, static_argnames=("url",))
def _j_b64enc_batch(data, url):
    return jax.vmap(lambda d: base64_ops.encode_bulk(d, url))(data)


def base64_to_binary_batch(
    items: Sequence[bytes], options: int = 0, last_chunk: int = gb.LOOSE
) -> list[tuple[FullResult, bytes]]:
    """Per-item forgiving-base64 decode, one device launch for the bulk
    classify/compact/repack of the whole batch; the per-item prologue
    (trailing strip) and tail epilogue stay on host exactly like the
    one-shot path, so results match base64_to_binary_details item by item.
    """
    if not items:
        return []
    garbage = gb.ignore_garbage(options)
    tab = gb.value_table(options)
    arrs = [
        a if isinstance(a, np.ndarray) and a.dtype == np.uint8
        else np.frombuffer(memoryview(a), np.uint8)
        for a in items
    ]
    strips = [b64_strip(a, tab, garbage) for a in arrs]
    buf, lens = _pack_matrix(
        [a[: s[0]] for a, s in zip(arrs, strips)],
        (s[0] for s in strips), np.uint8, "batch64")  # L % 4 == 0
    first_bad, nvalid, nvalid_at_bad, packed, tail_vals, tail_start = (
        np.asarray(x) for x in _j_b64dec_batch(
            buf, lens,
            bool(options & gb.BASE64_URL),
            bool(options & gb.BASE64_DEFAULT_OR_URL),
        )
    )
    out = []
    for i, (srclen, pad_count, pad_pos) in enumerate(strips):
        full, payload = b64_finish(
            srclen, pad_count, pad_pos, garbage, last_chunk,
            int(first_bad[i]), int(nvalid[i]), int(nvalid_at_bad[i]),
            packed[i], tail_vals[i], int(tail_start[i]),
        )
        out.append((full, payload.tobytes() if srclen else b""))
    return out


def binary_to_base64_batch(
    items: Sequence[bytes], options: int = 0
) -> list[bytes]:
    """Per-item base64 encode, one device launch for all whole 3-byte
    groups; <=2-byte tails + padding are appended on host per item."""
    if not items:
        return []
    arrs = [
        a if isinstance(a, np.ndarray) and a.dtype == np.uint8
        else np.frombuffer(memoryview(a), np.uint8)
        for a in items
    ]
    buf, lens = _pack_matrix(
        arrs, (a.shape[0] for a in arrs), np.uint8, "batch64e",
        row_align=3)  # encode_bulk reshapes rows into 3-byte groups
    quads = np.asarray(
        _j_b64enc_batch(buf, url=bool(options & gb.BASE64_URL)))
    out = []
    for i, a in enumerate(arrs):
        nfull = int(lens[i]) // 3 * 3
        body = quads[i, : nfull // 3 * 4]
        tail = gb.encode(a[nfull:], options)
        out.append(body.tobytes() + tail.tobytes())
    return out


# --- encoding detection batch ---------------------------------------------

from .encodings import check_bom, encoding_type  # noqa: E402
from .ops import detect as _od  # noqa: E402

_j_detect_batch = jax.jit(jax.vmap(_od.detect_encodings))


def detect_encodings_batch(items: Sequence[bytes]) -> list[int]:
    """Per-item detect_encodings (BOM host check + one fused vmapped
    detection pass), one device launch."""
    if not items:
        return []
    buf, lens = _pack(items)  # L is a power of two >= 256, so rows are %4
    ok8, ok16, ok32 = (np.asarray(x) for x in _j_detect_batch(buf, lens))
    out = []
    for i, item in enumerate(items):
        raw = bytes(item[:4]) if not isinstance(item, np.ndarray) \
            else item[:4].tobytes()
        bom = check_bom(raw)
        if bom != encoding_type.unspecified:
            out.append(int(bom))
            continue
        n = int(lens[i])
        mask = 0
        if ok8[i]:
            mask |= int(encoding_type.UTF8)
        if n % 2 == 0 and ok16[i]:
            mask |= int(encoding_type.UTF16_LE)
        if n % 4 == 0 and ok32[i]:
            mask |= int(encoding_type.UTF32_LE)
        out.append(mask)
    return out


_j_count16_batch = jax.jit(
    jax.vmap(lambda w, n: o16.count_code_points(w, n, False)))
_j_u8len16_batch = jax.jit(
    jax.vmap(lambda w, n: o16.utf8_length(w, n, False)))


def count_utf16le_batch(items: Sequence[bytes]) -> np.ndarray:
    """Per-item UTF-16LE codepoint counts, one device launch."""
    if not items:
        return np.zeros(0, dtype=np.int64)
    buf, lens = _pack16(items)
    out = np.asarray(_j_count16_batch(buf, lens)).astype(np.int64)
    return out[: len(items)]


def utf8_length_from_utf16le_batch(items: Sequence[bytes]) -> np.ndarray:
    """Per-item exact UTF-8 output sizes, one device launch."""
    if not items:
        return np.zeros(0, dtype=np.int64)
    buf, lens = _pack16(items)
    out = np.asarray(_j_u8len16_batch(buf, lens)).astype(np.int64)
    return out[: len(items)]
