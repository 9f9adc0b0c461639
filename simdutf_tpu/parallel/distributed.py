"""Data-parallel execution over a jax Mesh with collective reduction.

Shards run the same single-chip ops (ops/utf8.py) under shard_map; result
structs reduce on-device:
  * winning shard  = pmin over shard indices that contain an error, with
    the shard-local error (pos, code) carried by paired pmax-selects; the
    final global byte position is combined on the host in Python ints, so
    corpora beyond 2 GiB never overflow int32 device arithmetic
  * counts         = psum
This preserves the reference's ``result.count`` first-error contract
(error.h:34-52) lifted from 64-byte blocks to shards. Collectives ride ICI
within a slice (jax inserts them from the shardings).

The SPMD step functions are built once per (mesh, axis) and cached —
rebuilding a jit closure per call would retrace and recompile every time.

Multi-host: call ``jax.distributed.initialize()`` before building the mesh
(tools/dist_run.py does this); everything here is process-count agnostic
because shard_map only sees the mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..ops import utf8 as o8
from ..ops import utf16 as o16
from ..ops import utf32 as o32
from ..ops import latin1 as ol1
from ..ops import base64_ops
from ..ops.common import BIG
from .planner import ShardPlan, plan_shards


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


@functools.lru_cache(maxsize=32)
def _replicator(sharding):
    """Cached identity jit that reshards its argument to ``sharding``
    (used to replicate small result vectors across processes)."""
    return jax.jit(lambda a: a, out_shardings=sharding)


def _host_view(x) -> np.ndarray:
    """``np.asarray`` that also works on multi-process global arrays.

    Single-process (or replicated) arrays fetch directly. A P(axis)-sharded
    array whose shards live on other processes' devices cannot be fetched
    locally (jax raises); replicate it first via a resharding identity jit
    — XLA inserts the all-gather over ICI/DCN. Only use for SMALL per-shard
    result vectors (lengths, error codes); bulk outputs should stay
    sharded and be consumed via :func:`local_shards`."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    sh = NamedSharding(x.sharding.mesh, P())
    return np.asarray(_replicator(sh)(x))


def local_shards(outs, out_lens):
    """Per-process view of sharded transcode outputs: a list of
    (global_shard_index, np.ndarray) for the shards THIS process hosts,
    trimmed to their logical lengths and ordered by shard index.

    This is the multi-host materialization path: each process writes its
    own slice of the result (shard k's output belongs at output offset
    sum(out_lens[:k]))."""
    lens = _host_view(out_lens)
    got = []
    for s in outs.addressable_shards:
        k0 = int(s.index[0].start or 0) if s.index else 0
        rows = np.asarray(s.data)
        # one row per device under stage()'s plan==mesh invariant, but a
        # caller may place multiple shard rows per device — emit them all
        for r in range(rows.shape[0]):
            got.append((k0 + r, rows[r, : int(lens[k0 + r])]))
    got.sort(key=lambda t: t[0])
    return got


def stage(plan: ShardPlan, mesh: Mesh, axis: str = "data"):
    """Place shards + lengths on the mesh (one transfer; reuse across
    calls when timing or re-running)."""
    n_dev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if len(plan.lengths) != n_dev:
        # each shard_map local step processes exactly one shard; a
        # mismatched plan would silently skip rows
        raise ValueError(
            f"plan has {len(plan.lengths)} shards but the mesh has "
            f"{n_dev} devices — build the plan with n_shards={n_dev}")
    sh = NamedSharding(mesh, P(axis))
    shards = jax.device_put(plan.shards, sh)
    lengths = jax.device_put(plan.lengths.astype(np.int32), sh)
    return shards, lengths


def _local_reduce(code, pos, out_len, axis):
    """Reduce shard-local results to (winner shard idx, its pos/code,
    total units). All int32-safe: positions stay shard-local."""
    my_idx = jax.lax.axis_index(axis).astype(jnp.int32)
    bad = code != 0
    key = jnp.where(bad, my_idx, BIG)
    win = jax.lax.pmin(key, axis)
    mine = win == my_idx
    win_pos = jax.lax.pmax(jnp.where(mine, pos, -1), axis)
    win_code = jax.lax.pmax(jnp.where(mine, code, 0), axis)
    total = jax.lax.psum(out_len, axis)
    return win, win_pos, win_code, total


@functools.lru_cache(maxsize=16)
def _validate_step(mesh: Mesh, axis: str):
    def local(shards, lengths):
        code, pos = o8.validate_with_errors(shards[0], lengths[0])
        win, wpos, wcode, _ = _local_reduce(code, pos, jnp.int32(0), axis)
        return win[None], wpos[None], wcode[None]

    f = shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
    )

    @jax.jit
    def step(shards, lengths):
        win, wpos, wcode = f(shards, lengths)
        return win[0], wpos[0], wcode[0]

    return step


def _combine(plan: ShardPlan, win: int, wpos: int, wcode: int):
    """Host-side int64-exact global first-error position."""
    if win == BIG:
        return 0, None
    return wcode, int(plan.offsets[win]) + wpos


def validate_utf8_sharded(
    plan: ShardPlan, mesh: Mesh, axis: str = "data", staged=None
):
    """Global (err_code, err_pos) for the concatenated corpus; (0, total)
    when valid. Pass ``staged = stage(plan, mesh)`` to reuse device
    placement across calls."""
    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    win, wpos, wcode = (int(x) for x in _validate_step(mesh, axis)(shards, lengths))
    code, pos = _combine(plan, win, wpos, wcode)
    if code == 0:
        return 0, plan.total
    return code, pos


def transcode_utf8_to_utf16_sharded(
    plan: ShardPlan,
    mesh: Mesh,
    axis: str = "data",
    big_endian: bool = False,
    staged=None,
):
    """Validating transcode of a sharded corpus.

    Returns (err_code, err_pos_or_total_units, per-shard outputs, per-shard
    unit counts). Shard outputs stay sharded (device-resident); materialize
    with :func:`gather_utf16`.
    """
    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    op = "utf8_to_utf16be" if big_endian else "utf8_to_utf16le"
    win, wpos, wcode, _total, outs, out_lens = _matrix_step(
        mesh, axis, op
    )(shards, lengths)
    code, pos = _combine(plan, int(win), int(wpos), int(wcode))
    out_lens = _host_view(out_lens)
    # total is summed on the HOST in Python ints: a device psum would be
    # int32 and wrap past 2^31 output units (count_sharded does the same)
    total = int(out_lens.astype(np.int64).sum())
    if code == 0:
        return 0, total, outs, out_lens
    return code, pos, outs, out_lens


def gather_utf16(outs, out_lens) -> np.ndarray:
    """Materialize sharded transcode outputs into one host uint16 array."""
    outs = _host_view(outs)
    return np.concatenate(
        [outs[i, : int(out_lens[i])] for i in range(outs.shape[0])]
    )


gather_units = gather_utf16  # works for any per-shard (outs, out_lens) pair


# --- UTF-16 (plan with plan_shards(..., unit=2, big_endian=...)) ------------


@functools.lru_cache(maxsize=16)
def _validate16_step(mesh: Mesh, axis: str, big_endian: bool):
    def local(shards, lengths):
        code, pos = o16.validate_with_errors(shards[0], lengths[0], big_endian)
        win, wpos, wcode, _ = _local_reduce(code, pos, jnp.int32(0), axis)
        return win[None], wpos[None], wcode[None]

    f = shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
    )

    @jax.jit
    def step(shards, lengths):
        win, wpos, wcode = f(shards, lengths)
        return win[0], wpos[0], wcode[0]

    return step


def validate_utf16_sharded(
    plan: ShardPlan, mesh: Mesh, axis: str = "data",
    big_endian: bool = False, staged=None,
):
    """Global (err_code, err_pos) in code units; (0, total_units) when
    valid. ``plan`` must come from plan_shards(unit=2, big_endian=...)."""
    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    win, wpos, wcode = (
        int(x) for x in _validate16_step(mesh, axis, big_endian)(shards, lengths)
    )
    code, pos = _combine(plan, win, wpos, wcode)
    if code == 0:
        return 0, plan.total
    return code, pos


def transcode_utf16_to_utf8_sharded(
    plan: ShardPlan, mesh: Mesh, axis: str = "data",
    big_endian: bool = False, staged=None,
):
    """Validating UTF-16→UTF-8 over shards. Returns (err_code,
    err_pos_or_total_bytes, per-shard outputs, per-shard byte counts)."""
    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    op = "utf16be_to_utf8" if big_endian else "utf16le_to_utf8"
    win, wpos, wcode, _total, outs, out_lens = _matrix_step(
        mesh, axis, op
    )(shards, lengths)
    code, pos = _combine(plan, int(win), int(wpos), int(wcode))
    out_lens = _host_view(out_lens)
    total = int(out_lens.astype(np.int64).sum())  # host int64, never wraps
    if code == 0:
        return 0, total, outs, out_lens
    return code, pos, outs, out_lens


# --- the full 12-way conversion matrix, sharded -------------------------------
#
# One generic builder covers every direction (BASELINE config 5). Each op
# entry: (plan unit in bytes, local fn(shard, length) -> (code, pos, out,
# out_len)). Latin1 sources are always valid; their out_len is the known
# identity, wrapped to the common shape.


def _wrap_plain(fn, out_len_of):
    def local(s, l):
        out = fn(s, l)
        return jnp.int32(0), l, out, out_len_of(l)

    return local


_MATRIX_OPS = {
    "utf8_to_utf16le": (1, lambda s, l: o8.to_utf16(s, l, False)),
    "utf8_to_utf16be": (1, lambda s, l: o8.to_utf16(s, l, True)),
    "utf8_to_utf32": (1, o8.to_utf32),
    "utf8_to_latin1": (1, o8.to_latin1),
    "utf16le_to_utf8": (2, lambda s, l: o16.to_utf8(s, l, False)),
    "utf16be_to_utf8": (2, lambda s, l: o16.to_utf8(s, l, True)),
    "utf16le_to_utf32": (2, lambda s, l: o16.to_utf32(s, l, False)),
    "utf16be_to_utf32": (2, lambda s, l: o16.to_utf32(s, l, True)),
    "utf16le_to_latin1": (2, lambda s, l: o16.to_latin1(s, l, False)),
    "utf16be_to_latin1": (2, lambda s, l: o16.to_latin1(s, l, True)),
    "utf32_to_utf8": (4, o32.to_utf8),
    "utf32_to_utf16le": (4, lambda s, l: o32.to_utf16(s, l, False)),
    "utf32_to_utf16be": (4, lambda s, l: o32.to_utf16(s, l, True)),
    "utf32_to_latin1": (4, o32.to_latin1),
    "latin1_to_utf8": (1, lambda s, l: (
        jnp.int32(0), l, *ol1.to_utf8(s, l))),
    "latin1_to_utf16le": (1, _wrap_plain(
        lambda s, l: ol1.to_utf16(s, l, False), lambda l: l)),
    "latin1_to_utf16be": (1, _wrap_plain(
        lambda s, l: ol1.to_utf16(s, l, True), lambda l: l)),
    "latin1_to_utf32": (1, _wrap_plain(ol1.to_utf32, lambda l: l)),
    # elementwise utf16 ops: shard-local == global because the planner's
    # pair-aligned cuts mean no surrogate pair straddles a shard, so
    # to_well_formed's 1-word lookback never crosses a boundary
    "utf16le_to_well_formed": (2, _wrap_plain(
        lambda s, l: o16.to_well_formed(s, l, False), lambda l: l)),
    "utf16be_to_well_formed": (2, _wrap_plain(
        lambda s, l: o16.to_well_formed(s, l, True), lambda l: l)),
    "utf16_change_endianness": (2, _wrap_plain(
        lambda s, l: o16.change_endianness(s), lambda l: l)),
}


def plan_unit_for(op: str) -> int:
    """Shard-planner ``unit`` for a matrix op name."""
    return _MATRIX_OPS[op][0]


@functools.lru_cache(maxsize=64)
def _matrix_step(mesh: Mesh, axis: str, op: str):
    _, fn = _MATRIX_OPS[op]

    def local(shards, lengths):
        code, pos, out, out_len = fn(shards[0], lengths[0])
        win, wpos, wcode, total = _local_reduce(code, pos, out_len, axis)
        return (win[None], wpos[None], wcode[None], total[None],
                out[None], out_len[None])

    f = shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis),) * 4 + (P(axis), P(axis)),
    )

    @jax.jit
    def step(shards, lengths):
        win, wpos, wcode, total, outs, out_lens = f(shards, lengths)
        return win[0], wpos[0], wcode[0], total[0], outs, out_lens

    return step


def transcode_sharded(
    plan: ShardPlan, mesh: Mesh, op: str, axis: str = "data", staged=None
):
    """Any direction of the 12-way matrix over shards. ``plan`` must come
    from plan_shards(..., unit=plan_unit_for(op), big_endian=...). Returns
    (err_code, err_pos_or_total_units, per-shard outputs, per-shard unit
    counts); first-error positions are global input code-unit indices."""
    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    win, wpos, wcode, _total, outs, out_lens = _matrix_step(mesh, axis, op)(
        shards, lengths
    )
    code, pos = _combine(plan, int(win), int(wpos), int(wcode))
    out_lens = _host_view(out_lens)
    total = int(out_lens.astype(np.int64).sum())  # host int64, never wraps
    if code == 0:
        return 0, total, outs, out_lens
    return code, pos, outs, out_lens


# --- counts ------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _count_step(mesh: Mesh, axis: str, what: str):
    def local(shards, lengths):
        if what == "utf8":
            c = o8.count_code_points(shards[0], lengths[0])
        elif what == "utf8_utf16len":
            c = o8.utf16_length(shards[0], lengths[0])
        elif what in ("utf16le", "utf16be"):
            c = o16.count_code_points(shards[0], lengths[0], what.endswith("be"))
        else:  # pragma: no cover
            raise ValueError(what)
        return c.astype(jnp.int32)[None]

    f = shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(axis)
    )
    return jax.jit(f)


def count_sharded(
    plan: ShardPlan, mesh: Mesh, what: str = "utf8", axis: str = "data",
    staged=None,
) -> int:
    """Sharded counting (count_utf8 / utf16_length_from_utf8 /
    count_utf16le/be). Per-shard partials are summed on the host in Python
    ints so >2G-char corpora cannot overflow int32."""
    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    parts = _host_view(_count_step(mesh, axis, what)(shards, lengths))
    return int(sum(int(p) for p in parts))


# --- base64 (plan with plan_shards_base64) -----------------------------------


@functools.lru_cache(maxsize=16)
def _b64_step(mesh: Mesh, axis: str, url: bool, both: bool):
    def local(shards, lengths):
        first_bad, nvalid, nvalid_at_bad, packed, tail_vals, tail_start = (
            base64_ops.decode_bulk(shards[0], lengths[0], url, both)
        )
        return (first_bad[None], nvalid[None], nvalid_at_bad[None],
                packed[None], tail_vals[None], tail_start[None])

    f = shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis),) * 6,
    )
    return jax.jit(f)


def base64_to_binary_sharded(
    data, plan: ShardPlan, mesh: Mesh, options: int = 0,
    last_chunk=None, axis: str = "data", staged=None,
):
    """Forgiving-base64 decode of a sharded character stream.

    ``plan`` must come from :func:`planner.plan_shards_base64` on the SAME
    ``data`` (every non-final shard holds whole quads, padding in the final
    shard). Returns (FullResult with global counts, per-shard outputs,
    per-shard output byte counts). Semantics match the single-buffer
    decoder byte-for-byte, including the last-chunk matrix.
    """
    from ..golden import base64_impl as gb64
    from ..ops.impl import b64_tail_epilogue
    from ..errors import FullResult, error_code as ec

    if last_chunk is None:
        last_chunk = gb64.LOOSE
    if not isinstance(data, np.ndarray):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    garbage = gb64.ignore_garbage(options)
    tab = gb64.value_table(options)
    # prologue strip (generic/base64.h:50-73) — the shared vectorized
    # backward scan (ops/impl.b64_strip), same as the one-shot/batch paths
    from ..ops.impl import b64_strip

    srclen, pad_count, pad_pos = b64_strip(data, tab, garbage)

    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    url = bool(options & gb64.BASE64_URL)
    both = bool(options & gb64.BASE64_DEFAULT_OR_URL)
    fb, nv, nvb, packed, tails, tstarts = _b64_step(mesh, axis, url, both)(
        shards, lengths
    )
    fb, nv, nvb = _host_view(fb), _host_view(nv), _host_view(nvb)
    n_shards = len(plan.lengths)
    # clamp device first-bad to the shard's logical length: '='/whitespace
    # beyond srclen live in the final shard but were stripped above.
    # With accept_garbage, invalid chars are skipped, not errors — the same
    # gate as the one-shot epilogue (ops/impl.b64_finish).
    out_lens = (nv // 4) * 3
    if not garbage:
        for s in range(n_shards):
            local_strip = max(
                0, int(plan.offsets[s] + plan.lengths[s]) - srclen)
            bad = int(fb[s])
            if bad < int(plan.lengths[s]) - local_strip:
                gpos = int(plan.offsets[s]) + bad
                outlen = int(nvb[s]) // 4 * 3 + sum(
                    int(nv[t]) // 4 * 3 for t in range(s)
                )
                return (
                    FullResult(ec.INVALID_BASE64_CHARACTER, gpos, outlen),
                    packed, out_lens, np.zeros(0, dtype=np.uint8),
                )
    # tail: leftover (<4) chars all live in the final shard by construction
    last = n_shards - 1
    nvalid_last = int(nv[last])
    idx = nvalid_last % 4
    tail = [int(t) for t in _host_view(tails)[last][:idx]]
    tail_start = int(plan.offsets[last]) + int(_host_view(tstarts)[last])
    out_lens = (nv // 4) * 3
    total = int(out_lens.sum())
    full, extra = b64_tail_epilogue(
        total, idx, tail, tail_start, srclen,
        pad_count, pad_pos, garbage, last_chunk,
    )
    return full, packed, out_lens, extra


@functools.lru_cache(maxsize=8)
def _b64_encode_step(mesh: Mesh, axis: str, url: bool):
    def local(shards, lengths):
        chars = base64_ops.encode_bulk(shards[0], url)
        out_len = (lengths[0] // 3) * 4
        return chars[None], out_len[None]

    f = shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis)),
    )
    return jax.jit(f)


def binary_to_base64_sharded(
    data, plan: ShardPlan, mesh: Mesh, options: int = 0,
    axis: str = "data", staged=None,
):
    """Base64-encode a sharded binary payload (the reference's
    thread-scaling story covers encode first-class,
    benchmarks/threaded.cpp + benchmark_base64.cpp).

    ``plan`` must come from :func:`planner.plan_shards_binary3` on the
    SAME ``data`` (every non-final shard a multiple of 3 bytes). Returns
    (per-shard char outputs, per-shard char counts, tail bytes): shard
    s's first out_lens[s] chars, concatenated in shard order and followed
    by ``tail``, are byte-identical to the single-buffer
    api.binary_to_base64. The <=2-byte remainder plus its padding lives
    wholly in ``tail`` (host epilogue, golden.encode — the same split as
    the one-shot path's device-body/host-tail)."""
    from ..golden import base64_impl as gb64

    if not isinstance(data, np.ndarray):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    url = bool(options & gb64.BASE64_URL)
    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    chars, out_lens = _b64_encode_step(mesh, axis, url)(shards, lengths)
    out_lens = _host_view(out_lens)
    last = len(plan.lengths) - 1
    rem = int(plan.lengths[last]) % 3
    tail_src = data[int(plan.offsets[last]) + int(plan.lengths[last]) - rem:
                    int(plan.offsets[last]) + int(plan.lengths[last])]
    tail = gb64.encode(tail_src, options)
    return chars, out_lens, tail


def gather_base64(chars, out_lens, tail) -> bytes:
    """Assemble :func:`binary_to_base64_sharded` outputs into the full
    encoding (host-side; mirrors gather_utf16)."""
    chars = _host_view(chars)
    parts = [chars[s][: int(out_lens[s])].tobytes()
             for s in range(chars.shape[0])]
    return b"".join(parts) + bytes(tail)


# --- UTF-32 validation + encoding detection ----------------------------------


@functools.lru_cache(maxsize=16)
def _validate32_step(mesh: Mesh, axis: str):
    def local(shards, lengths):
        code, pos = o32.validate_with_errors(shards[0], lengths[0])
        win, wpos, wcode, _ = _local_reduce(code, pos, jnp.int32(0), axis)
        return win[None], wpos[None], wcode[None]

    f = shard_map(
        local, mesh=mesh, in_specs=(P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis)),
    )

    @jax.jit
    def step(shards, lengths):
        win, wpos, wcode = f(shards, lengths)
        return win[0], wpos[0], wcode[0]

    return step


def validate_utf32_sharded(
    plan: ShardPlan, mesh: Mesh, axis: str = "data", staged=None,
):
    """Global (err_code, err_pos) in code units; (0, total_words) when
    valid. ``plan`` must come from plan_shards(unit=4) (UTF-32 shards cut
    on word boundaries; no trimming logic is needed)."""
    shards, lengths = staged if staged is not None else stage(plan, mesh, axis)
    win, wpos, wcode = (
        int(x) for x in _validate32_step(mesh, axis)(shards, lengths)
    )
    code, pos = _combine(plan, win, wpos, wcode)
    if code == 0:
        return 0, plan.total
    return code, pos


def detect_encodings_sharded(data, mesh: Mesh, axis: str = "data") -> int:
    """Sharded detect_encodings: BOM first, then the three sharded
    validations (the reference's fallback strategy,
    fallback/implementation.cpp:6-30, at pod scale). Bit-exact vs the
    single-buffer detect_encodings."""
    from ..encodings import check_bom, encoding_type

    if not isinstance(data, np.ndarray):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    bom = check_bom(data[:4].tobytes())
    if bom != encoding_type.unspecified:
        return int(bom)
    n = int(data.shape[0])
    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    out = 0
    plan8 = plan_shards(data, n_shards, unit=1)
    if validate_utf8_sharded(plan8, mesh, axis)[0] == 0:
        out |= int(encoding_type.UTF8)
    if n % 2 == 0:
        plan16 = plan_shards(data, n_shards, unit=2)
        if validate_utf16_sharded(plan16, mesh, axis)[0] == 0:
            out |= int(encoding_type.UTF16_LE)
    if n % 4 == 0:
        plan32 = plan_shards(data, n_shards, unit=4)
        if validate_utf32_sharded(plan32, mesh, axis)[0] == 0:
            out |= int(encoding_type.UTF32_LE)
    return out


def autodetect_encoding_sharded(data, mesh: Mesh, axis: str = "data") -> int:
    """Sharded autodetect_encoding (implementation.cpp:44-76 priority:
    BOM, UTF-8, UTF-16LE, UTF-32LE, else unspecified)."""
    from ..encodings import check_bom, encoding_type

    if not isinstance(data, np.ndarray):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    bom = check_bom(data[:4].tobytes())
    if bom != encoding_type.unspecified:
        return int(bom)
    n = int(data.shape[0])
    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if validate_utf8_sharded(plan_shards(data, n_shards), mesh, axis)[0] == 0:
        return int(encoding_type.UTF8)
    if n % 2 == 0 and validate_utf16_sharded(
        plan_shards(data, n_shards, unit=2), mesh, axis
    )[0] == 0:
        return int(encoding_type.UTF16_LE)
    if n % 4 == 0 and validate_utf32_sharded(
        plan_shards(data, n_shards, unit=4), mesh, axis
    )[0] == 0:
        return int(encoding_type.UTF32_LE)
    return int(encoding_type.unspecified)
