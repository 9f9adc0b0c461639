"""Multi-device (8 virtual CPU devices) sharding tests: global results must
match the single-buffer oracle bit-for-bit, including first-error positions
across shard boundaries (the reference's trim_partial + threaded.cpp model
lifted to a device mesh)."""

import numpy as np
import pytest

import helpers
import oracle
from simdutf_tpu.parallel import (
    make_mesh,
    plan_shards,
    transcode_utf8_to_utf16_sharded,
    validate_utf8_sharded,
)
from simdutf_tpu.parallel.distributed import gather_utf16

import jax

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices"
)


def _mesh():
    return make_mesh(len(jax.devices()))


def test_plan_shards_boundaries():
    # a corpus of 3-byte chars: cuts must land on multiples of 3
    data = ("語" * 1000).encode()
    plan = plan_shards(data, 8)
    assert plan.total == len(data)
    for off in plan.offsets:
        assert int(off) % 3 == 0
    # every shard individually valid
    for i in range(8):
        assert oracle.validate_utf8(
            plan.shards[i, : plan.lengths[i]].tobytes()
        )
    # reassembly identity
    joined = b"".join(
        plan.shards[i, : plan.lengths[i]].tobytes() for i in range(8)
    )
    assert joined == data


@pytest.mark.parametrize("seed", range(6))
def test_sharded_validate_valid(seed):
    data = helpers.random_utf8(seed, 5000, 3, 2, 2, 1)
    plan = plan_shards(data, len(jax.devices()))
    code, pos = validate_utf8_sharded(plan, _mesh())
    assert code == 0 and pos == len(data)


@pytest.mark.parametrize("seed", range(10))
def test_sharded_validate_error_position(seed):
    data = bytearray(helpers.random_utf8(seed, 5000, 3, 2, 2, 1))
    # corrupt one byte somewhere (including near shard boundaries)
    n = len(data)
    spots = [n // 8 * k + (seed % 5) - 2 for k in range(1, 8)] + [
        seed * 997 % n
    ]
    for spot in spots:
        mutated = bytearray(data)
        mutated[spot % n] = 0xFF
        mb = bytes(mutated)
        expect = oracle.validate_utf8_with_errors(mb)
        plan = plan_shards(mb, len(jax.devices()))
        code, pos = validate_utf8_sharded(plan, _mesh())
        assert (code == 0) == expect.is_ok
        if not expect.is_ok:
            assert (code, pos) == (int(expect.error), expect.count), mb.hex()


@pytest.mark.parametrize("seed", range(5))
def test_sharded_transcode(seed):
    data = helpers.random_utf8(seed + 50, 4000, 2, 1, 2, 1)
    plan = plan_shards(data, len(jax.devices()))
    code, total, outs, out_lens = transcode_utf8_to_utf16_sharded(plan, _mesh())
    assert code == 0
    res, expect = oracle.convert_utf8_to_utf16_with_errors(data, False)
    assert total == res.count
    got = gather_utf16(outs, out_lens).tobytes()
    assert got == expect


def test_sharded_transcode_error():
    data = bytearray(helpers.random_utf8(7, 4000, 2, 1, 2, 1))
    data[len(data) // 2] = 0x80  # stray continuation mid-corpus
    mb = bytes(data)
    expect = oracle.validate_utf8_with_errors(mb)
    plan = plan_shards(mb, len(jax.devices()))
    code, pos, _, _ = transcode_utf8_to_utf16_sharded(plan, _mesh())
    assert (code, pos) == (int(expect.error), expect.count)


# --- round-2 surface: utf16 / counts / base64 sharded ------------------------

from simdutf_tpu.parallel.distributed import (
    base64_to_binary_sharded,
    count_sharded,
    gather_units,
    transcode_utf16_to_utf8_sharded,
    validate_utf16_sharded,
)
from simdutf_tpu.parallel.planner import plan_shards_base64


def _u16plan(data: bytes, be: bool):
    return plan_shards(
        np.frombuffer(data, np.uint8), len(jax.devices()), unit=2,
        big_endian=be,
    )


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_sharded_validate_utf16(seed, be):
    data = helpers.random_utf16(seed, 4001, 2, 1, big_endian=be)
    plan = _u16plan(data, be)
    code, pos = validate_utf16_sharded(plan, _mesh(), big_endian=be)
    assert code == 0 and pos == len(data) // 2
    # corrupt: lone high surrogate at unit k (incl. shard-boundary spots)
    n_units = len(data) // 2
    for k in [n_units // 8 * j for j in range(1, 8)] + [seed * 811 % n_units]:
        mutated = bytearray(data)
        hi, lo = (0xD8, 0x00) if be else (0x00, 0xD8)
        mutated[2 * k], mutated[2 * k + 1] = lo, hi
        mb = bytes(mutated)
        expect = oracle.validate_utf16_with_errors(mb, be)
        plan = _u16plan(mb, be)
        code, pos = validate_utf16_sharded(plan, _mesh(), big_endian=be)
        assert (code == 0) == expect.is_ok
        if not expect.is_ok:
            assert (code, pos) == (int(expect.error), expect.count)


def test_planner_utf16_be_pair_boundary():
    """A BE corpus whose surrogate pairs would straddle naive cuts: the
    planner must pull the cut back one unit (round-1 weakness: LE-only)."""
    # all astral chars: every pair is (high, low)
    data = helpers.random_utf16(3, 4000, 0, 1, big_endian=True)
    plan = _u16plan(data, True)
    for i in range(len(plan.lengths)):
        shard = plan.shards[i, : plan.lengths[i]].tobytes()
        assert oracle.validate_utf16(shard, True), i


@pytest.mark.parametrize("be", [False, True])
def test_sharded_transcode_utf16_to_utf8(be):
    data = helpers.random_utf16(11, 3000, 3, 1, big_endian=be)
    plan = _u16plan(data, be)
    code, total, outs, out_lens = transcode_utf16_to_utf8_sharded(
        plan, _mesh(), big_endian=be
    )
    assert code == 0
    res, expect = oracle.convert_utf16_to_utf8_with_errors(data, be)
    assert total == res.count
    got = gather_units(outs, out_lens).tobytes()
    assert got == expect


def test_sharded_counts():
    data = helpers.random_utf8(21, 6000, 3, 2, 2, 1)
    plan = plan_shards(data, len(jax.devices()))
    assert count_sharded(plan, _mesh(), "utf8") == oracle.count_utf8(data)
    assert count_sharded(plan, _mesh(), "utf8_utf16len") == (
        oracle.utf16_length_from_utf8(data)
    )
    u16 = helpers.random_utf16(22, 3000, 2, 1)
    plan16 = _u16plan(u16, False)
    assert count_sharded(plan16, _mesh(), "utf16le") == oracle.count_utf16(
        u16, False
    )


def _b64_case(seed: int, n: int, spaces: bool, pad: bool) -> bytes:
    import base64 as pyb64
    import random

    rng = random.Random(seed)
    raw = bytes(rng.randrange(256) for _ in range(n))
    s = pyb64.b64encode(raw)
    if not pad:
        s = s.rstrip(b"=")
    if spaces:
        chars = bytearray(s)
        for _ in range(len(s) // 17):
            chars.insert(rng.randrange(len(chars)), ord(" "))
        s = bytes(chars)
    return s


@pytest.mark.parametrize("spaces", [False, True])
@pytest.mark.parametrize("pad", [False, True])
def test_sharded_base64_decode(spaces, pad):
    import simdutf_tpu as su

    data = _b64_case(5, 5000 + (7 if pad else 0), spaces, pad)
    want_full, want_out = (
        su.base64_to_binary_details(data)
    )
    plan = plan_shards_base64(data, len(jax.devices()))
    full, outs, out_lens, extra = base64_to_binary_sharded(
        data, plan, _mesh()
    )
    assert full == want_full
    got = np.concatenate(
        [np.asarray(outs)[i, : int(out_lens[i])] for i in range(len(out_lens))]
        + [extra]
    ).tobytes()
    assert got == want_out


def test_sharded_base64_invalid_position():
    import simdutf_tpu as su

    data = bytearray(_b64_case(9, 4000, True, True))
    for spot in (17, len(data) // 2 + 1, len(data) - 9):
        mutated = bytearray(data)
        mutated[spot] = ord("!")
        mb = bytes(mutated)
        want_full, _ = su.base64_to_binary_details(mb)
        plan = plan_shards_base64(mb, len(jax.devices()))
        full, _, _, _ = base64_to_binary_sharded(mb, plan, _mesh())
        assert full.error == want_full.error
        assert full.input_count == want_full.input_count


def test_sharded_base64_last_chunk_modes():
    import simdutf_tpu as su
    from simdutf_tpu.golden import base64_impl as gb64

    for s in (b"ZXhhZg", b"ZXhhZg==", b"YWF=", b"ZXhhZg" + b" " * 70):
        data = b"QUJDRA==".rstrip(b"=")[:4] * 300 + s  # bulk + tail
        for lc in (gb64.LOOSE, gb64.STRICT, gb64.STOP_BEFORE_PARTIAL):
            want_full, want_out = su.base64_to_binary_details(
                data, last_chunk_handling=lc
            )
            plan = plan_shards_base64(data, len(jax.devices()))
            full, outs, out_lens, extra = base64_to_binary_sharded(
                data, plan, _mesh(), last_chunk=lc
            )
            assert full == want_full, (s, lc)
            if full.is_ok:
                got = np.concatenate(
                    [np.asarray(outs)[i, : int(out_lens[i])]
                     for i in range(len(out_lens))] + [extra]
                ).tobytes()
                assert got == want_out, (s, lc)


def test_sharded_full_matrix():
    """Every direction of the 12-way matrix sharded == single-buffer result
    (BASELINE config 5)."""
    from simdutf_tpu.parallel.distributed import (
        _MATRIX_OPS, plan_unit_for, transcode_sharded,
    )
    import simdutf_tpu as su

    rng = np.random.default_rng(3)
    u8 = helpers.random_utf8(31, 2500, 3, 2, 2, 1)
    latin1_u8 = "héllo wörld ÿñ æøå ".encode() * 150  # latin1-range utf8
    u16 = helpers.random_utf16(32, 2000, 3, 1)
    u16_l1 = ("héllo ÿ " * 300).encode("utf-16-le")
    u32 = helpers.random_utf32(33, 1500, 0.2)
    u32_l1 = ("héllo ÿ " * 300).encode("utf-32-le")
    l1 = bytes(rng.integers(0, 256, 2000, dtype=np.uint8))

    srcs = {
        "utf8_to_utf16le": u8, "utf8_to_utf16be": u8, "utf8_to_utf32": u8,
        "utf8_to_latin1": latin1_u8,
        "utf16le_to_utf8": u16, "utf16le_to_utf32": u16,
        "utf16le_to_latin1": u16_l1,
        "utf16be_to_utf8": su.change_endianness_utf16(u16),
        "utf16be_to_utf32": su.change_endianness_utf16(u16),
        "utf16be_to_latin1": su.change_endianness_utf16(u16_l1),
        "utf32_to_utf8": u32, "utf32_to_utf16le": u32,
        "utf32_to_utf16be": u32, "utf32_to_latin1": u32_l1,
        "latin1_to_utf8": l1, "latin1_to_utf16le": l1,
        "latin1_to_utf16be": l1, "latin1_to_utf32": l1,
        "utf16le_to_well_formed": u16,
        "utf16be_to_well_formed": su.change_endianness_utf16(u16),
        "utf16_change_endianness": u16,
    }
    single = {
        "utf8_to_utf16le": su.convert_utf8_to_utf16le,
        "utf8_to_utf16be": su.convert_utf8_to_utf16be,
        "utf8_to_utf32": su.convert_utf8_to_utf32,
        "utf8_to_latin1": su.convert_utf8_to_latin1,
        "utf16le_to_utf8": su.convert_utf16le_to_utf8,
        "utf16le_to_utf32": su.convert_utf16le_to_utf32,
        "utf16le_to_latin1": su.convert_utf16le_to_latin1,
        "utf16be_to_utf8": su.convert_utf16be_to_utf8,
        "utf16be_to_utf32": su.convert_utf16be_to_utf32,
        "utf16be_to_latin1": su.convert_utf16be_to_latin1,
        "utf32_to_utf8": su.convert_utf32_to_utf8,
        "utf32_to_utf16le": su.convert_utf32_to_utf16le,
        "utf32_to_utf16be": su.convert_utf32_to_utf16be,
        "utf32_to_latin1": su.convert_utf32_to_latin1,
        "latin1_to_utf8": su.convert_latin1_to_utf8,
        "latin1_to_utf16le": su.convert_latin1_to_utf16le,
        "latin1_to_utf16be": su.convert_latin1_to_utf16be,
        "latin1_to_utf32": su.convert_latin1_to_utf32,
        "utf16le_to_well_formed": su.to_well_formed_utf16le,
        "utf16be_to_well_formed": su.to_well_formed_utf16be,
        "utf16_change_endianness": su.change_endianness_utf16,
    }
    mesh = _mesh()
    n_dev = len(jax.devices())
    for op in _MATRIX_OPS:
        data = srcs[op]
        unit = plan_unit_for(op)
        be = "utf16be_to" in op
        arr = np.frombuffer(data, np.uint8)
        if unit == 2:
            plan = plan_shards(arr, n_dev, unit=2, big_endian=be)
        elif unit == 4:
            plan = plan_shards(arr, n_dev, unit=4)
        else:
            plan = plan_shards(arr, n_dev)
        code, total, outs, out_lens = transcode_sharded(plan, mesh, op)
        want = single[op](data)
        assert code == 0, op
        got = gather_units(outs, out_lens)
        assert got.tobytes() == want, op


def test_sharded_validate_utf32():
    mesh = _mesh()
    from simdutf_tpu.parallel import plan_shards, validate_utf32_sharded

    cps = [0x41, 0x3B1, 0x4E2D, 0x1F600] * 5000
    good = b"".join(c.to_bytes(4, "little") for c in cps)
    plan = plan_shards(good, len(jax.devices()), unit=4)
    assert validate_utf32_sharded(plan, mesh) == (0, len(cps))

    bad = bytearray(good)
    # inject a surrogate word deep in a later shard
    bad[4 * 7321: 4 * 7321 + 4] = (0xD800).to_bytes(4, "little")
    plan = plan_shards(bytes(bad), len(jax.devices()), unit=4)
    code, pos = validate_utf32_sharded(plan, mesh)
    assert (code, pos) == (int(oracle.ec.SURROGATE), 7321)


@pytest.mark.parametrize("kind", ["utf8", "utf16", "utf32", "bom", "soup"])
def test_sharded_detect_encodings(kind):
    mesh = _mesh()
    import simdutf_tpu as su
    from simdutf_tpu.parallel import (
        autodetect_encoding_sharded, detect_encodings_sharded)

    s = "héllo wörld 日本語 🙂 " * 3000
    data = {
        "utf8": s.encode(),
        "utf16": s.encode("utf-16-le"),
        "utf32": s.encode("utf-32-le"),
        "bom": b"\xff\xfe" + s.encode("utf-16-le"),
        "soup": bytes(range(256)) * 100,
    }[kind]
    want_mask = su.detect_encodings(data)
    want_auto = int(su.autodetect_encoding(data))
    assert detect_encodings_sharded(data, mesh) == want_mask
    assert autodetect_encoding_sharded(data, mesh) == want_auto


def test_sharded_base64_accept_garbage():
    """accept_garbage must skip invalid chars, not error on them — the
    same gate as the one-shot epilogue (review finding)."""
    import base64 as pyb64

    import simdutf_tpu as su
    from simdutf_tpu.parallel import base64_to_binary_sharded
    from simdutf_tpu.parallel.planner import plan_shards_base64

    mesh = _mesh()
    payload = bytes(range(256)) * 40
    enc = bytearray(pyb64.b64encode(payload))
    for k in range(13, len(enc), 211):
        enc.insert(k, ord("!"))  # garbage
    enc = bytes(enc)
    opts = 4  # BASE64_DEFAULT_ACCEPT_GARBAGE
    plan = plan_shards_base64(enc, len(jax.devices()), options=opts)
    full, outs, out_lens, extra = base64_to_binary_sharded(
        enc, plan, mesh, options=opts)
    got = b"".join(
        np.asarray(outs)[i, : int(out_lens[i])].tobytes()
        for i in range(len(out_lens))
    ) + extra.tobytes()
    want_full, want = su.base64_to_binary_details(enc, opts, 0)
    assert full == want_full and got == want


def test_stage_rejects_mismatched_plan():
    from simdutf_tpu.parallel import plan_shards, stage

    mesh = _mesh()
    plan = plan_shards(b"hello world" * 100, len(jax.devices()) * 2)
    with pytest.raises(ValueError, match="shards but the mesh"):
        stage(plan, mesh)


def test_plan_shards_rejects_partial_units():
    from simdutf_tpu.parallel import plan_shards

    with pytest.raises(ValueError, match="not a multiple"):
        plan_shards(b"A\x00B", 2, unit=2)
    with pytest.raises(ValueError, match="not a multiple"):
        plan_shards(b"12345", 2, unit=4)


@pytest.mark.parametrize("be", [False, True])
def test_sharded_to_well_formed_lone_surrogates(be):
    """Ill-formed input sharded: replacement decisions are adjacency-local,
    and pair-aligned cuts preserve adjacency, so sharded == single-buffer
    even with lone surrogates planted at shard-boundary-ish spots."""
    import simdutf_tpu as su
    from simdutf_tpu.parallel.distributed import transcode_sharded

    data = bytearray(helpers.random_utf16(77, 4001, 3, 1, big_endian=be))
    n_units = len(data) // 2
    hi, lo = (0xD9, 0x22) if be else (0x22, 0xD9)
    lo2, hi2 = (0xDD, 0x22) if be else (0x22, 0xDD)
    for j in range(1, 8):  # lone high + lone low near each boundary
        k = n_units // 8 * j
        data[2 * k], data[2 * k + 1] = hi, lo
        data[2 * (k + 3)], data[2 * (k + 3) + 1] = lo2, hi2
    data = bytes(data)
    op = "utf16be_to_well_formed" if be else "utf16le_to_well_formed"
    plan = _u16plan(data, be)
    code, total, outs, out_lens = transcode_sharded(plan, _mesh(), op)
    assert code == 0
    got = gather_units(outs, out_lens).tobytes()
    want = (su.to_well_formed_utf16be(data) if be
            else su.to_well_formed_utf16le(data))
    assert got == want
    assert total == n_units


# --- shard-capacity parity under shard_map ---------------------------------
# Outputs and exact cross-shard first-error positions must not depend on
# the planner's capacity alignment: a small alignment leaves ragged pad
# tails inside the buckets, a large one pads every shard to whole blocks.

ALIGNS = [512, 32768]


def _aligned_plan(data: bytes, align: int, unit: int = 1):
    return plan_shards(
        np.frombuffer(data, np.uint8) if unit == 1 else data,
        len(jax.devices()), unit=unit, align=align,
    )


@pytest.mark.parametrize("align", ALIGNS)
def test_sharded_transcode_parity(align):
    data = ("mixed é 東 \U0001f642 ascii tail " * 3000).encode()
    import simdutf_tpu as su

    data = data[: su.trim_partial_utf8(data)]
    plan = _aligned_plan(data, align)
    assert plan.shards.shape[1] % align == 0
    code, total, outs, out_lens = transcode_utf8_to_utf16_sharded(
        plan, _mesh())
    assert code == 0
    res, expect = oracle.convert_utf8_to_utf16_with_errors(data, False)
    assert total == res.count
    assert gather_utf16(outs, out_lens).tobytes() == expect


@pytest.mark.parametrize("align", ALIGNS)
def test_sharded_transcode_exact_cross_shard_error(align):
    base = bytearray(("mixed é 東 \U0001f642 " * 4000).encode())
    ndev = len(jax.devices())
    # injection sites near every shard boundary AND mid-shard
    for frac in (1, 3, ndev - 1):
        data = bytearray(base)
        spot = len(data) * frac // ndev + 1
        data[spot] = 0x80
        mb = bytes(data)
        expect = oracle.validate_utf8_with_errors(mb)
        if expect.is_ok:
            continue
        plan = _aligned_plan(mb, align)
        code, pos, _, _ = transcode_utf8_to_utf16_sharded(plan, _mesh())
        assert (code, pos) == (int(expect.error), expect.count), (
            align, spot)


@pytest.mark.parametrize("align", ALIGNS)
def test_sharded_utf16_to_utf8_parity(align):
    text = "pairs \U0001f680 東京 é ascii " * 2500
    u16 = text.encode("utf-16-le")
    plan = plan_shards(np.frombuffer(u16, np.uint8),
                       len(jax.devices()), unit=2, align=align)
    code, nbytes, outs, out_lens = transcode_utf16_to_utf8_sharded(
        plan, _mesh())
    assert code == 0
    want = text.encode("utf-8")
    assert nbytes == len(want)
    assert gather_utf16(outs, out_lens).tobytes() == want


@pytest.mark.parametrize("align", ALIGNS)
def test_sharded_base64_parity(align):
    import base64 as pyb64

    payload = bytes(range(256)) * 900
    raw = pyb64.b64encode(payload)
    wrapped = b"\r\n".join(raw[i:i + 76] for i in range(0, len(raw), 76))
    plan = plan_shards_base64(wrapped, len(jax.devices()), align=align)
    full, outs, out_lens, extra = base64_to_binary_sharded(
        wrapped, plan, _mesh())
    assert full.is_ok, (align, full)
    got = b"".join(
        np.asarray(outs)[i, : int(out_lens[i])].tobytes()
        for i in range(len(jax.devices()))
    ) + extra.tobytes()
    assert got == payload, align


@pytest.mark.parametrize("rem", [0, 1, 2])
@pytest.mark.parametrize("url", [False, True])
def test_sharded_base64_encode(rem, url):
    """binary_to_base64_sharded + gather == the single-buffer encoding
    byte-for-byte, for every tail remainder and both alphabets."""
    import simdutf_tpu as su
    from simdutf_tpu.golden import base64_impl as gb64
    from simdutf_tpu.parallel.distributed import (
        binary_to_base64_sharded, gather_base64)
    from simdutf_tpu.parallel.planner import plan_shards_binary3

    rng = np.random.default_rng(rem * 2 + url)
    payload = rng.integers(0, 256, 30011 * 3 + rem, dtype=np.uint8)
    options = gb64.BASE64_URL if url else 0
    want = su.binary_to_base64(payload, options)
    plan = plan_shards_binary3(payload, len(jax.devices()))
    chars, out_lens, tail = binary_to_base64_sharded(
        payload, plan, _mesh(), options)
    assert gather_base64(chars, out_lens, tail) == want
