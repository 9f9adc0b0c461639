"""XLAImplementation: host glue around the jnp ops.

Inputs are padded to power-of-two buckets (>= 1 KiB, +8 slack bytes) so
jax.jit's shape-keyed cache stays small while shapes remain static — the
fixed-shape discipline XLA wants. The actual length travels as a dynamic
scalar, so one compiled program serves every input in a bucket.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..errors import FullResult, Result, error_code as ec
from ..golden import base64_impl as gb
from ..implementation import Implementation
from ..runtime import staging_buffer, tune_host_allocator
from .common import DEVICE_ROUTING
from . import base64_ops, detect as odet, latin1 as ol1, utf8 as o8, utf16 as o16, utf32 as o32

_MIN_BUCKET = 1024
# Above this, buckets grow linearly (multiples of _BIG_STEP) instead of
# doubling, so a barely-over-a-bucket input does not double its device
# memory. 16 Mi steps keep the jit cache small (<= 4 extra entries per
# 64 Mi).
_POW2_CAP = 64 << 20
_BIG_STEP = 16 << 20


def _bucket(n: int, multiple: int = 4) -> int:
    need = max(n + 8, _MIN_BUCKET)
    if need > _POW2_CAP:
        cap = -(-need // _BIG_STEP) * _BIG_STEP
    else:
        cap = 1 << (need - 1).bit_length()
    if cap % multiple:
        cap += multiple - cap % multiple
    return cap


def _pad(arr: np.ndarray, multiple: int = 4):
    n = int(arr.shape[0])
    cap = _bucket(n, multiple)
    out = staging_buffer((cap,), arr.dtype, fill_len=n, tag="pad1d")
    out[:n] = arr
    return out, np.int32(n)


# --- jitted entry points (module level so the jit cache is shared) ----------

_j_validate_utf8 = jax.jit(o8.validate_with_errors)
_j_validate_ascii = jax.jit(o8.validate_ascii_with_errors)
_j_count_utf8 = jax.jit(o8.count_code_points)
_j_utf16_len_from_utf8 = jax.jit(o8.utf16_length)
_j_u8_to_l1 = jax.jit(o8.to_latin1)
_j_u8_to_l1_v = jax.jit(o8.to_latin1_valid)

_j_validate_u16le = jax.jit(lambda w, n: o16.validate_with_errors(w, n, False))
_j_validate_u16be = jax.jit(lambda w, n: o16.validate_with_errors(w, n, True))
_j_count_u16le = jax.jit(lambda w, n: o16.count_code_points(w, n, False))
_j_count_u16be = jax.jit(lambda w, n: o16.count_code_points(w, n, True))
_j_u8len_u16le = jax.jit(lambda w, n: o16.utf8_length(w, n, False))
_j_u8len_u16be = jax.jit(lambda w, n: o16.utf8_length(w, n, True))
_j_u16le_to_l1 = jax.jit(lambda w, n: o16.to_latin1(w, n, False))
_j_u16be_to_l1 = jax.jit(lambda w, n: o16.to_latin1(w, n, True))
_j_u16le_to_l1_v = jax.jit(lambda w, n: o16.to_latin1_valid(w, n, False))
_j_u16be_to_l1_v = jax.jit(lambda w, n: o16.to_latin1_valid(w, n, True))
_j_swap16 = jax.jit(o16.change_endianness)
_j_wf_u16le = jax.jit(lambda w, n: o16.to_well_formed(w, n, False))
_j_wf_u16be = jax.jit(lambda w, n: o16.to_well_formed(w, n, True))

_j_validate_u32 = jax.jit(o32.validate_with_errors)
_j_u8len_u32 = jax.jit(o32.utf8_length)
_j_u16len_u32 = jax.jit(o32.utf16_length)
_j_u32_to_l1 = jax.jit(o32.to_latin1)
_j_u32_to_l1_v = jax.jit(o32.to_latin1_valid)

_j_u8len_l1 = jax.jit(ol1.utf8_length)
_j_l1_to_u16le = jax.jit(lambda b, n: ol1.to_utf16(b, n, False))
_j_l1_to_u16be = jax.jit(lambda b, n: ol1.to_utf16(b, n, True))
_j_l1_to_u32 = jax.jit(ol1.to_utf32)

_j_detect = jax.jit(odet.detect_encodings)
_j_b64_decode = jax.jit(
    base64_ops.decode_bulk, static_argnames=("url", "both")
)
_j_b64_encode = jax.jit(base64_ops.encode_bulk, static_argnames=("url",))


def _routed_jit(fn):
    """jit of a census-routed op with ``routing`` as a static argument, so
    the routed and the general-engine programs share one jit cache."""
    return jax.jit(fn, static_argnames=("routing",))


# census-routed transcodes (ops.common.DEVICE_ROUTING)
_j_u8_to_u16le = _routed_jit(lambda b, n, routing: o8.to_utf16(b, n, False, routing))
_j_u8_to_u16be = _routed_jit(lambda b, n, routing: o8.to_utf16(b, n, True, routing))
_j_u8_to_u32 = _routed_jit(o8.to_utf32)
_j_u8_to_u16le_v = _routed_jit(
    lambda b, n, routing: o8.to_utf16_valid(b, n, False, routing))
_j_u8_to_u16be_v = _routed_jit(
    lambda b, n, routing: o8.to_utf16_valid(b, n, True, routing))
_j_u8_to_u32_v = _routed_jit(o8.to_utf32_valid)
_j_u16le_to_u8 = _routed_jit(lambda w, n, routing: o16.to_utf8(w, n, False, routing))
_j_u16be_to_u8 = _routed_jit(lambda w, n, routing: o16.to_utf8(w, n, True, routing))
_j_u16le_to_u8_v = _routed_jit(
    lambda w, n, routing: o16.to_utf8_valid(w, n, False, routing))
_j_u16be_to_u8_v = _routed_jit(
    lambda w, n, routing: o16.to_utf8_valid(w, n, True, routing))
_j_u16le_to_u32 = _routed_jit(lambda w, n, routing: o16.to_utf32(w, n, False, routing))
_j_u16be_to_u32 = _routed_jit(lambda w, n, routing: o16.to_utf32(w, n, True, routing))
_j_u16le_to_u32_v = _routed_jit(
    lambda w, n, routing: o16.to_utf32_valid(w, n, False, routing))
_j_u16be_to_u32_v = _routed_jit(
    lambda w, n, routing: o16.to_utf32_valid(w, n, True, routing))
_j_u32_to_u8 = _routed_jit(o32.to_utf8)
_j_u32_to_u8_v = _routed_jit(o32.to_utf8_valid)
_j_u32_to_u16le = _routed_jit(lambda w, n, routing: o32.to_utf16(w, n, False, routing))
_j_u32_to_u16be = _routed_jit(lambda w, n, routing: o32.to_utf16(w, n, True, routing))
_j_u32_to_u16le_v = _routed_jit(
    lambda w, n, routing: o32.to_utf16_valid(w, n, False, routing))
_j_u32_to_u16be_v = _routed_jit(
    lambda w, n, routing: o32.to_utf16_valid(w, n, True, routing))
_j_l1_to_u8 = _routed_jit(ol1.to_utf8)


def _res(code, pos) -> Result:
    return Result(ec(int(code)), int(pos))


def _cut(arr, out_len) -> np.ndarray:
    return np.asarray(arr)[: int(out_len)]


def b64_strip(src, tab_np, garbage: bool):
    """Prologue strip (generic/base64.h:50-73): trailing whitespace and up
    to two '=' signs. Returns (srclen, pad_count, pad_pos).
    Vectorized backward scan in growing chunks — O(trailing)."""
    eq = ord("=")

    def strip_ws(end: int) -> int:
        step = 64
        while end > 0:
            lo = max(0, end - step)
            chunk = np.asarray(src[lo:end])
            vals = np.where(
                chunk > 0xFF, 255, tab_np[np.minimum(chunk, 0xFF)]
            )
            nonws = np.flatnonzero(vals != 64)
            if len(nonws):
                return lo + int(nonws[-1]) + 1
            end = lo
            step *= 4
        return 0

    srclen = int(src.shape[0])
    pad_pos, pad_count = srclen, 0
    if not garbage:
        srclen = strip_ws(srclen)
        if srclen > 0 and int(src[srclen - 1]) == eq:
            pad_pos, srclen, pad_count = srclen - 1, srclen - 1, 1
            srclen = strip_ws(srclen)
            if srclen > 0 and int(src[srclen - 1]) == eq:
                pad_pos, srclen, pad_count = srclen - 1, srclen - 1, 2
    return srclen, pad_count, pad_pos


def b64_tail_epilogue(
    outlen: int,
    idx: int,
    tail: list,
    tail_start: int,
    srclen: int,
    pad_count: int,
    pad_pos: int,
    garbage: bool,
    last_chunk: int,
):
    """Last-chunk + padding-consistency semantics shared by the single-chip
    and sharded base64 decoders (scalar/base64.h:135-216 tail modes and the
    generic/base64.h:228-244 padding checks).

    ``outlen``: bytes decoded from full quads; ``idx``/``tail``: leftover
    (<4) char count and their 6-bit values; positions are global input
    indices. Returns (FullResult, extra uint8 bytes to append).
    """
    none = np.zeros(0, dtype=np.uint8)
    w = outlen
    extra = none
    if idx != 0 or (not garbage and pad_count > 0):
        if (
            not garbage
            and last_chunk == gb.STRICT
            and idx != 1
            and ((idx + pad_count) & 3) != 0
        ):
            return FullResult(ec.BASE64_INPUT_REMAINDER, srclen, w), none
        if (
            not garbage
            and last_chunk == gb.STOP_BEFORE_PARTIAL
            and ((idx + pad_count) & 3) != 0
        ):
            start = tail_start if idx > 0 else srclen
            return FullResult(ec.SUCCESS, start, w), none
        if idx == 2:
            t = tail[0] << 18 | tail[1] << 12
            if not garbage and last_chunk == gb.STRICT and (t & 0xFFFF):
                return FullResult(ec.BASE64_EXTRA_BITS, srclen, w), none
            extra = np.array([(t >> 16) & 0xFF], dtype=np.uint8)
            w += 1
        elif idx == 3:
            t = tail[0] << 18 | tail[1] << 12 | tail[2] << 6
            if not garbage and last_chunk == gb.STRICT and (t & 0xFF):
                return FullResult(ec.BASE64_EXTRA_BITS, srclen, w), none
            extra = np.array(
                [(t >> 16) & 0xFF, (t >> 8) & 0xFF], dtype=np.uint8
            )
            w += 2
        elif not garbage and idx == 1 and last_chunk != gb.STOP_BEFORE_PARTIAL:
            return FullResult(ec.BASE64_INPUT_REMAINDER, srclen, w), none

    if not garbage and last_chunk != gb.STOP_BEFORE_PARTIAL and pad_count > 0:
        if (w % 3 == 0) or ((w % 3) + 1 + pad_count != 4):
            return (
                FullResult(ec.INVALID_BASE64_CHARACTER, pad_pos, w),
                extra,
            )
    return FullResult(ec.SUCCESS, srclen, w), extra


def b64_finish(
    srclen: int,
    pad_count: int,
    pad_pos: int,
    garbage: bool,
    last_chunk: int,
    first_bad: int,
    nvalid: int,
    nvalid_at_bad: int,
    packed: np.ndarray,
    tail_vals: np.ndarray,
    tail_start: int,
):
    """Host epilogue shared by the one-shot and batch decoders: turns one
    device decode's raw outputs into the (FullResult, bytes) contract."""
    empty = np.zeros(0, dtype=np.uint8)
    if srclen == 0:
        if not garbage and pad_count > 0:
            if last_chunk == gb.STRICT:
                return FullResult(ec.BASE64_INPUT_REMAINDER, 0, 0), empty
            if last_chunk == gb.STOP_BEFORE_PARTIAL:
                return FullResult(ec.SUCCESS, 0, 0), empty
            return (
                FullResult(ec.INVALID_BASE64_CHARACTER, pad_pos, 0),
                empty,
            )
        return FullResult(ec.SUCCESS, 0, 0), empty

    if not garbage and first_bad < srclen:
        nb = int(nvalid_at_bad)
        outlen = nb // 4 * 3
        return (
            FullResult(ec.INVALID_BASE64_CHARACTER, first_bad, outlen),
            np.asarray(packed)[:outlen],
        )

    nfull = nvalid // 4 * 4
    out = np.asarray(packed)[: nfull // 4 * 3]
    idx = nvalid - nfull
    tail = [int(t) for t in np.asarray(tail_vals)[:idx]]
    full, extra = b64_tail_epilogue(
        len(out), idx, tail, int(tail_start), srclen,
        pad_count, pad_pos, garbage, last_chunk,
    )
    if len(extra):
        out = np.concatenate([out, extra])
    return full, out


class XLAImplementation(Implementation):
    """The device tier. ``routing`` selects the census-routed transcodes
    (the default, ``SIMDUTF_TPU_DEVICE_ROUTING``) or the general engine
    alone; both give identical results."""

    name = "xla"
    description = "jax.numpy ops lowered by XLA"

    def __init__(self, routing: bool = DEVICE_ROUTING):
        super().__init__()  # base __init__ already tunes the host allocator
        self.routing = bool(routing)

    def _routed(self, jfn, data):
        return jfn(*_pad(data), routing=self.routing)

    def supported_by_runtime_system(self) -> bool:
        try:
            return len(jax.devices()) > 0
        except Exception:
            return False

    # -- validation ----------------------------------------------------------
    def validate_ascii(self, b):
        return self.validate_ascii_with_errors(b).is_ok

    def validate_ascii_with_errors(self, b):
        return _res(*_j_validate_ascii(*_pad(b)))

    def validate_utf8(self, b):
        return self.validate_utf8_with_errors(b).is_ok

    def validate_utf8_with_errors(self, b):
        return _res(*_j_validate_utf8(*_pad(b)))

    def validate_utf16le(self, w):
        return self.validate_utf16le_with_errors(w).is_ok

    def validate_utf16be(self, w):
        return self.validate_utf16be_with_errors(w).is_ok

    def validate_utf16le_with_errors(self, w):
        return _res(*_j_validate_u16le(*_pad(w)))

    def validate_utf16be_with_errors(self, w):
        return _res(*_j_validate_u16be(*_pad(w)))

    def validate_utf32(self, w):
        return self.validate_utf32_with_errors(w).is_ok

    def validate_utf32_with_errors(self, w):
        return _res(*_j_validate_u32(*_pad(w)))

    # -- counts / lengths ----------------------------------------------------
    def count_utf8(self, b):
        return int(_j_count_utf8(*_pad(b)))

    def count_utf16le(self, w):
        return int(_j_count_u16le(*_pad(w)))

    def count_utf16be(self, w):
        return int(_j_count_u16be(*_pad(w)))

    def utf16_length_from_utf8(self, b):
        return int(_j_utf16_len_from_utf8(*_pad(b)))

    def utf32_length_from_utf8(self, b):
        return self.count_utf8(b)

    def latin1_length_from_utf8(self, b):
        return self.count_utf8(b)

    def utf8_length_from_utf16le(self, w):
        return int(_j_u8len_u16le(*_pad(w)))

    def utf8_length_from_utf16be(self, w):
        return int(_j_u8len_u16be(*_pad(w)))

    def utf32_length_from_utf16le(self, w):
        return self.count_utf16le(w)

    def utf32_length_from_utf16be(self, w):
        return self.count_utf16be(w)

    def utf8_length_from_utf32(self, w):
        return int(_j_u8len_u32(*_pad(w)))

    def utf16_length_from_utf32(self, w):
        return int(_j_u16len_u32(*_pad(w)))

    def utf8_length_from_latin1(self, b):
        return int(_j_u8len_l1(*_pad(b)))

    # -- conversions ---------------------------------------------------------
    def _convert(self, jfn, data, routed: bool = False):
        kw = {"routing": self.routing} if routed else {}
        code, pos, out, out_len = jfn(*_pad(data), **kw)
        code, out_len = int(code), int(out_len)
        if code == 0:
            # success count = code units written (error.h:36-38)
            return Result(ec.SUCCESS, out_len), _cut(out, out_len)
        return Result(ec(code), int(pos)), _cut(out, out_len)

    def convert_utf8_to_utf16le_with_errors(self, b):
        return self._convert(_j_u8_to_u16le, b, routed=True)

    def convert_valid_utf8_to_utf16le(self, b):
        out, total = self._routed(_j_u8_to_u16le_v, b)
        return _cut(out, total)

    def convert_valid_utf8_to_utf16be(self, b):
        out, total = self._routed(_j_u8_to_u16be_v, b)
        return _cut(out, total)

    def convert_valid_utf8_to_utf32(self, b):
        out, total = self._routed(_j_u8_to_u32_v, b)
        return _cut(out, total)

    def convert_utf8_to_utf16be_with_errors(self, b):
        return self._convert(_j_u8_to_u16be, b, routed=True)

    def convert_utf8_to_utf32_with_errors(self, b):
        return self._convert(_j_u8_to_u32, b, routed=True)

    def convert_utf8_to_latin1_with_errors(self, b):
        return self._convert(_j_u8_to_l1, b)

    def convert_valid_utf8_to_latin1(self, b):
        out, total = _j_u8_to_l1_v(*_pad(b))
        return _cut(out, total)

    def convert_valid_utf16le_to_latin1(self, w):
        out, total = _j_u16le_to_l1_v(*_pad(w))
        return _cut(out, total)

    def convert_valid_utf16be_to_latin1(self, w):
        out, total = _j_u16be_to_l1_v(*_pad(w))
        return _cut(out, total)

    def convert_valid_utf32_to_utf8(self, w):
        out, total = self._routed(_j_u32_to_u8_v, w)
        return _cut(out, total)

    def convert_valid_utf32_to_utf16le(self, w):
        out, total = self._routed(_j_u32_to_u16le_v, w)
        return _cut(out, total)

    def convert_valid_utf32_to_utf16be(self, w):
        out, total = self._routed(_j_u32_to_u16be_v, w)
        return _cut(out, total)

    def convert_valid_utf32_to_latin1(self, w):
        out, total = _j_u32_to_l1_v(*_pad(w))
        return _cut(out, total)

    def convert_utf16le_to_utf8_with_errors(self, w):
        return self._convert(_j_u16le_to_u8, w, routed=True)

    def convert_valid_utf16le_to_utf8(self, w):
        out, total = self._routed(_j_u16le_to_u8_v, w)
        return _cut(out, total)

    def convert_valid_utf16be_to_utf8(self, w):
        out, total = self._routed(_j_u16be_to_u8_v, w)
        return _cut(out, total)

    def convert_valid_utf16le_to_utf32(self, w):
        out, total = self._routed(_j_u16le_to_u32_v, w)
        return _cut(out, total)

    def convert_valid_utf16be_to_utf32(self, w):
        out, total = self._routed(_j_u16be_to_u32_v, w)
        return _cut(out, total)

    def convert_utf16be_to_utf8_with_errors(self, w):
        return self._convert(_j_u16be_to_u8, w, routed=True)

    def convert_utf16le_to_utf32_with_errors(self, w):
        return self._convert(_j_u16le_to_u32, w, routed=True)

    def convert_utf16be_to_utf32_with_errors(self, w):
        return self._convert(_j_u16be_to_u32, w, routed=True)

    def convert_utf16le_to_latin1_with_errors(self, w):
        return self._convert(_j_u16le_to_l1, w)

    def convert_utf16be_to_latin1_with_errors(self, w):
        return self._convert(_j_u16be_to_l1, w)

    def convert_utf32_to_utf8_with_errors(self, w):
        return self._convert(_j_u32_to_u8, w, routed=True)

    def convert_utf32_to_utf16le_with_errors(self, w):
        return self._convert(_j_u32_to_u16le, w, routed=True)

    def convert_utf32_to_utf16be_with_errors(self, w):
        return self._convert(_j_u32_to_u16be, w, routed=True)

    def convert_utf32_to_latin1_with_errors(self, w):
        return self._convert(_j_u32_to_l1, w)

    def convert_latin1_to_utf8(self, b):
        out, out_len = self._routed(_j_l1_to_u8, b)
        return _cut(out, out_len)

    def convert_latin1_to_utf16le(self, b):
        p, n = _pad(b)
        return _cut(_j_l1_to_u16le(p, n), n)

    def convert_latin1_to_utf16be(self, b):
        p, n = _pad(b)
        return _cut(_j_l1_to_u16be(p, n), n)

    def convert_latin1_to_utf32(self, b):
        p, n = _pad(b)
        return _cut(_j_l1_to_u32(p, n), n)

    # -- UTF-16 utilities ----------------------------------------------------
    def change_endianness_utf16(self, w):
        p, n = _pad(w)
        return _cut(_j_swap16(p), n)

    def to_well_formed_utf16le(self, w):
        p, n = _pad(w)
        return _cut(_j_wf_u16le(p, n), n)

    def to_well_formed_utf16be(self, w):
        p, n = _pad(w)
        return _cut(_j_wf_u16be(p, n), n)

    # -- encoding detection (fused one-pass) ---------------------------------
    def detect_encodings(self, b):
        from ..encodings import check_bom, encoding_type

        bom = check_bom(b[:4].tobytes())
        if bom != encoding_type.unspecified:
            return int(bom)
        n = int(b.shape[0])
        ok8, ok16, ok32 = (int(x) for x in _j_detect(*_pad(b)))
        out = 0
        if ok8:
            out |= int(encoding_type.UTF8)
        if n % 2 == 0 and ok16:
            out |= int(encoding_type.UTF16_LE)
        if n % 4 == 0 and ok32:
            out |= int(encoding_type.UTF32_LE)
        return out

    # -- base64 --------------------------------------------------------------
    def base64_to_binary_details(self, src, options=0, last_chunk=gb.LOOSE):
        garbage = gb.ignore_garbage(options)
        tab_np = gb.value_table(options)

        srclen, pad_count, pad_pos = b64_strip(src, tab_np, garbage)
        if srclen == 0:
            return b64_finish(0, pad_count, pad_pos, garbage,
                              last_chunk, 0, 0, 0, None, None, 0)

        p, _ = _pad(src[:srclen])
        first_bad, nvalid, nvalid_at_bad, packed, tail_vals, tail_start = (
            _j_b64_decode(
                p,
                np.int32(srclen),
                url=bool(options & gb.BASE64_URL),
                both=bool(options & gb.BASE64_DEFAULT_OR_URL),
            )
        )
        return b64_finish(
            srclen, pad_count, pad_pos, garbage, last_chunk,
            int(first_bad), int(nvalid), int(nvalid_at_bad),
            packed, tail_vals, int(tail_start),
        )

    def binary_to_base64(self, src, options=0):
        n = int(src.shape[0])
        nfull = n // 3 * 3
        p, _ = _pad(src[:nfull], multiple=3)
        body = np.asarray(_j_b64_encode(
            p, url=bool(options & gb.BASE64_URL)))[: nfull // 3 * 4]
        tail = gb.encode(src[nfull:], options)
        return np.concatenate([body, tail])
