#!/usr/bin/env python
"""On-card smoke test: drive the public API once at corpus scale on a GPU
and check every output byte for byte against the golden tier.

    python chip_smoke.py             # one card: phases 1-7
    python chip_smoke.py --chips 4   # the sharded path on four cards only

Each phase prints one JSON line with its wall times; ``first_s`` includes
compilation (shorter on a warm compile cache), ``steady_s`` repeats the
call. Any mismatch raises, the script exits non-zero and prints no result
line. Without a GPU backend phase 1 fails. The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Everything runs in this one process: a second process on the card would
find its memory reserved by the first.
"""

from __future__ import annotations

import argparse
import base64 as pyb64
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

import simdutf_tpu as su
from simdutf_tpu.errors import error_code as ec
from simdutf_tpu.runtime import configure_compile_cache
from tools.gen_corpus import mixed_corpus

ROOT = os.path.dirname(os.path.abspath(__file__))
MIB = 1 << 20
BLOCK = 32768  # an old kernel tile: errors are also injected on its edges


def emit(phase: str, **fields) -> dict:
    rec = {"phase": phase, **fields}
    print(json.dumps(rec), flush=True)
    return rec


def timed(fn, *args, repeat: int = 1):
    """(result, first_s, steady_s): the first call includes compilation;
    steady is the median of ``repeat`` further calls (None if 0)."""
    t0 = time.perf_counter()
    out = fn(*args)
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return out, first, (float(np.median(times)) if times else None)


def tiers():
    impls = su.get_available_implementations()
    return [impls["fallback"]] + ([impls["cnative"]] if "cnative" in impls
                                  else [])


def same(name, got, want):
    """Exact equality of API results: Result structs, ints, bytes."""
    if isinstance(want, np.ndarray):
        want = want.tobytes()
    if isinstance(want, tuple):
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            same(name, g, w)
        return
    if got != want:
        raise AssertionError(f"{name}: {str(got)[:120]} != {str(want)[:120]}")


def against_tiers(name, got, method, arr, *args):
    """Compare an API result with the fallback (golden NumPy) tier and
    with cnative where it is built."""
    for impl in tiers():
        same(f"{name} vs {impl.name}", got, getattr(impl, method)(arr, *args))


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


def corpus(mib: float) -> bytes:
    return mixed_corpus(int(mib * MIB))


# --- phase 1 ------------------------------------------------------------------


def phase_device() -> dict:
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(f"no GPU backend (JAX backend is {backend!r})")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"device platform is {devs[0].platform!r}")
    impl = su.get_active_implementation()
    if impl.name != "xla":
        raise RuntimeError(f"active implementation is {impl.name!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    return emit("device", backend=backend, kind=devs[0].device_kind,
                count=len(devs), implementation=impl.name,
                tiers=sorted(su.get_available_implementations()),
                nvidia_smi=smi, compile_cache=configure_compile_cache())


# --- phase 2 ------------------------------------------------------------------


def _snap(data: bytes, pos: int) -> int:
    while pos > 0 and data[pos] & 0xC0 == 0x80:
        pos -= 1
    return pos


def phase_flagship(mib: float = 64) -> tuple[dict, dict]:
    data = corpus(mib)
    arr = _u8(data)
    t = {}
    got, t["validate_first_s"], t["validate_s"] = timed(
        su.validate_utf8_with_errors, data, repeat=3)
    assert got.is_ok and got.count == len(data), got
    against_tiers("validate", got, "validate_utf8_with_errors", arr)

    n_cp, t["count_first_s"], t["count_s"] = timed(su.count_utf8, data,
                                                   repeat=3)
    against_tiers("count_utf8", n_cp, "count_utf8", arr)
    n16, t["utf16_len_first_s"], t["utf16_len_s"] = timed(
        su.utf16_length_from_utf8, data, repeat=3)
    against_tiers("utf16_length", n16, "utf16_length_from_utf8", arr)

    text = data.decode("utf-8")
    r16, t["to_utf16_first_s"], t["to_utf16_s"] = timed(
        su.convert_utf8_to_utf16le_with_errors, data, repeat=3)
    same("to_utf16 codec", r16[1], text.encode("utf-16-le"))
    against_tiers("to_utf16", r16, "convert_utf8_to_utf16le_with_errors", arr)
    assert r16[0].count == n16

    r32, t["to_utf32_first_s"], t["to_utf32_s"] = timed(
        su.convert_utf8_to_utf32_with_errors, data, repeat=3)
    same("to_utf32 codec", r32[1], text.encode("utf-32-le"))
    against_tiers("to_utf32", r32, "convert_utf8_to_utf32_with_errors", arr)

    l1 = (bytes(range(0x20, 0x7F)) + bytes(range(0xA0, 0x100))).decode(
        "latin-1").encode() * max(1, int(mib * MIB) // 4 // 287)
    rl1, t["to_latin1_first_s"], t["to_latin1_s"] = timed(
        su.convert_utf8_to_latin1_with_errors, l1, repeat=3)
    same("to_latin1 codec", rl1[1], l1.decode().encode("latin-1"))
    against_tiers("to_latin1", rl1, "convert_utf8_to_latin1_with_errors",
                  _u8(l1))

    errors = []
    for where in (len(data) // 2 + 7, (len(data) // 3) // BLOCK * BLOCK):
        bad = bytearray(data)
        bad[where] = 0xFF
        bad = bytes(bad)
        want = su.get_available_implementations()[
            "fallback"].validate_utf8_with_errors(_u8(bad))
        got = su.validate_utf8_with_errors(bad)
        same("corrupt validate", got, want)
        against_tiers("corrupt to_utf16",
                      su.convert_utf8_to_utf16le_with_errors(bad),
                      "convert_utf8_to_utf16le_with_errors", _u8(bad))
        start = _snap(data, where)
        expect = ((ec.HEADER_BITS, where) if start == where
                  else (ec.TOO_SHORT, start))
        assert (got.error, got.count) == expect, (got, expect)
        errors.append([int(got.error), got.count])
    rec = emit("flagship_utf8", bytes=len(data), latin1_bytes=len(l1),
               errors=errors, **t)
    return rec, {"data": data, "utf16": r16[1], "utf32": r32[1]}


# --- phase 3 ------------------------------------------------------------------


def phase_back_to_utf8(outs: dict) -> dict:
    data, u16, u32 = outs["data"], outs["utf16"], outs["utf32"]
    t = {}
    r8, t["utf16_to_utf8_first_s"], t["utf16_to_utf8_s"] = timed(
        su.convert_utf16le_to_utf8_with_errors, u16, repeat=3)
    same("utf16->utf8", r8[1], data)
    against_tiers("utf16->utf8", r8, "convert_utf16le_to_utf8_with_errors",
                  np.frombuffer(u16, np.uint16))
    r8b, t["utf32_to_utf8_first_s"], t["utf32_to_utf8_s"] = timed(
        su.convert_utf32_to_utf8_with_errors, u32, repeat=3)
    same("utf32->utf8", r8b[1], data)
    against_tiers("utf32->utf8", r8b, "convert_utf32_to_utf8_with_errors",
                  np.frombuffer(u32, np.uint32))

    units = np.frombuffer(u16, np.uint16).copy()
    k = len(units) // 2
    while (units[k] & 0xF800) == 0xD800 or (units[k - 1] & 0xFC00) == 0xD800:
        k += 1
    units[k] = 0xDC00  # a lone low surrogate at unit k
    bad = units.tobytes()
    got = su.convert_utf16le_to_utf8_with_errors(bad)
    assert (got[0].error, got[0].count) == (ec.SURROGATE, k), got[0]
    against_tiers("lone surrogate", got,
                  "convert_utf16le_to_utf8_with_errors", units)
    same("lone surrogate validate", su.validate_utf16le_with_errors(bad),
         su.get_available_implementations()[
             "fallback"].validate_utf16le_with_errors(units))
    return emit("back_to_utf8", units=len(units), surrogate_at=k, **t)


# --- phase 4 ------------------------------------------------------------------


def phase_base64(mib: float = 48) -> dict:
    raw = np.random.default_rng(4).integers(0, 256, int(mib * MIB),
                                            np.uint8).tobytes()
    t = {}
    enc, t["encode_first_s"], t["encode_s"] = timed(su.binary_to_base64,
                                                    raw, repeat=3)
    same("encode codec", enc, pyb64.b64encode(raw))
    against_tiers("encode", enc, "binary_to_base64", _u8(raw))

    std = pyb64.b64encode(raw)
    mime = b"\r\n".join(std[i: i + 76] for i in range(0, len(std), 76))
    url = pyb64.urlsafe_b64encode(raw)
    junk = bytearray(std)
    for i in range(97, len(junk), 4099):
        junk[i:i] = b"!*"
    cases = [("mime_crlf", mime, su.base64_default),
             ("url", url, su.base64_url),
             ("garbage", bytes(junk), su.base64_default_accept_garbage)]
    for name, text, opts in cases:
        got, t[f"{name}_first_s"], t[f"{name}_s"] = timed(
            su.base64_to_binary_details, text, opts, repeat=2)
        assert got[0].is_ok, (name, got[0])
        same(f"decode {name} payload", got[1], raw)
        against_tiers(f"decode {name}", got, "base64_to_binary_details",
                      _u8(text), opts)
    return emit("base64", bytes=len(raw), **t)


# --- phase 5 ------------------------------------------------------------------


def _documents(n_docs: int, max_len: int, seed: int = 5) -> list[bytes]:
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(np.log(600), 1.3, n_docs), 1, max_len)
    src = corpus(max(2 * max_len, 4 * MIB) / MIB)
    docs = []
    for i, n in enumerate(lens.astype(int)):
        off = int(rng.integers(0, len(src) - n))
        d = src[off: off + n]
        d = d.decode("utf-8", "ignore").encode()
        if i % 97 == 13 and d:
            d = d[: len(d) // 2] + b"\xc0" + d[len(d) // 2:]
        docs.append(d)
    return docs


def phase_batch_stream(n_docs: int = 4096, max_len: int = 64 * 1024,
                       stream_mib: float = 64, chunk: int = MIB) -> dict:
    from simdutf_tpu import batch

    docs = _documents(n_docs, max_len)
    fb = su.get_available_implementations()["fallback"]
    t = {}
    vals, t["batch_validate_first_s"], t["batch_validate_s"] = timed(
        batch.validate_utf8_batch, docs, repeat=2)
    outs, t["batch_utf16_first_s"], t["batch_utf16_s"] = timed(
        batch.convert_utf8_to_utf16le_batch, docs, repeat=2)
    n_bad = 0
    for d, v, o in zip(docs, vals, outs):
        a = _u8(d)
        same("batch validate", v, fb.validate_utf8_with_errors(a))
        same("batch utf16", o, fb.convert_utf8_to_utf16le_with_errors(a))
        n_bad += not v.is_ok

    data = corpus(stream_mib)
    st = su.StreamTranscoder("utf-8", "utf-16le")
    t0 = time.perf_counter()
    parts = [st.push(data[i: i + chunk]) for i in range(0, len(data), chunk)]
    parts.append(st.finish())
    t["stream_s"] = time.perf_counter() - t0
    same("stream == one-shot", b"".join(parts),
         su.convert_utf8_to_utf16le(data))
    return emit("batch_stream", docs=len(docs), doc_bytes=sum(map(len, docs)),
                invalid_docs=n_bad, stream_bytes=len(data), chunk=chunk, **t)


# --- phase 6 ------------------------------------------------------------------


def phase_big(mib: float = 100) -> dict:
    data = corpus(mib)
    arr = _u8(data)
    t = {}
    got, t["validate_first_s"], t["validate_s"] = timed(
        su.validate_utf8_with_errors, data, repeat=1)
    assert got.is_ok, got
    against_tiers("big validate", got, "validate_utf8_with_errors", arr)
    r16, t["to_utf16_first_s"], t["to_utf16_s"] = timed(
        su.convert_utf8_to_utf16le_with_errors, data, repeat=1)
    against_tiers("big to_utf16", r16, "convert_utf8_to_utf16le_with_errors",
                  arr)
    from simdutf_tpu.ops.impl import _bucket

    return emit("above_bucket_cap", bytes=len(data),
                bucket=_bucket(len(data)), **t)


# --- phase 7 ------------------------------------------------------------------


def _device_median(fn, args, runs: int, reps: int = 10) -> float:
    """Median over ``runs`` samples of the per-call time of ``reps``
    back-to-back calls on device-resident inputs (dispatch overlaps the
    previous call, so this approaches device time)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / reps)
    return float(np.median(times))


def _padded(data: bytes):
    from simdutf_tpu.ops.impl import _bucket

    buf = np.zeros(_bucket(len(data)), np.uint8)
    buf[: len(data)] = _u8(data)
    return jax.device_put(buf), jnp.int32(len(data))


def _strided_words(b_u8):
    """The comparator form of ops.common.u8_words: four strided lane
    slices of a (N/512, 512) view, OR-ed into (N/4,) int32 words."""
    x2 = b_u8.reshape(-1, 512)
    w = (x2[:, 0::4].astype(jnp.int32) | (x2[:, 1::4].astype(jnp.int32) << 8)
         | (x2[:, 2::4].astype(jnp.int32) << 16)
         | (x2[:, 3::4].astype(jnp.int32) << 24))
    return w.reshape(-1)


def phase_ab(mib: float = 64, runs: int = 7,
             sizes=tuple(1 << k for k in range(12, 25))) -> dict:
    """Device and served time of the UTF-8 validator, the ``u8_words``
    A/B (plain bitcast vs strided lane slices, inside the uniform 2-byte
    fast branch) and the served-time crossover between the device tier
    and the scalar tier that sets registry._SMALL_DEFAULT."""
    from unittest import mock

    from simdutf_tpu.ops import utf8 as o8

    validate = jax.jit(o8.validate_with_errors)
    res = {"runs": runs}
    mixed = corpus(mib)
    copy = jax.jit(lambda b: b + jnp.uint8(1))
    res["copy_read_write_s"] = _device_median(copy, _padded(mixed)[:1], runs)
    inputs = {"mixed": mixed, "ascii": b"plain ascii text. " * (len(mixed) // 18)}
    for name, data in inputs.items():
        res[f"validate_{name}_device_s"] = _device_median(
            validate, _padded(data), runs)
        _, _, res[f"validate_{name}_served_s"] = timed(
            su.validate_utf8_with_errors, data, repeat=runs)

    u2 = ("жзийклмн" * (len(mixed) // 16)).encode()
    b2, n2 = _padded(u2)
    plain = jax.jit(lambda b, n: o8.to_utf16(b, n, False, True))
    with mock.patch.object(o8, "u8_words", _strided_words):
        strided = jax.jit(lambda b, n: o8.to_utf16(b, n, False, True))
        got_s = [np.asarray(x) for x in strided(b2, n2)]
    got_p = [np.asarray(x) for x in plain(b2, n2)]
    for a, c in zip(got_p, got_s):
        assert np.array_equal(a, c), "u8_words variants differ"
    res["u8_words_plain_s"] = _device_median(plain, (b2, n2), runs)
    res["u8_words_strided_s"] = _device_median(strided, (b2, n2), runs)

    impls = su.get_available_implementations()
    scalar = impls.get("cnative", impls["fallback"])
    res["scalar_tier"] = scalar.name
    xla = impls["xla"]
    cross = {}
    for op in ("validate_utf8", "convert_utf8_to_utf16le_with_errors"):
        rows = []
        for size in sizes:
            arr = _u8(mixed[:size].decode("utf-8", "ignore").encode())
            row = {"bytes": len(arr)}
            for impl in (xla, scalar):
                _, _, row[impl.name] = timed(getattr(impl, op), arr,
                                             repeat=runs)
            rows.append(row)
        # the smallest size from which the device tier wins at every
        # larger measured size
        wins_from = None
        for r in reversed(rows):
            if r["xla"] >= r[scalar.name]:
                break
            wins_from = r["bytes"]
        cross[op] = {"rows": rows, "xla_wins_from": wins_from}
    res["crossover"] = cross
    return emit("ab", **res)


# --- --chips 4 ----------------------------------------------------------------


def phase_sharded(n_dev: int = 4, mib: float = 256) -> dict:
    from simdutf_tpu.parallel import (
        detect_encodings_sharded, make_mesh, plan_shards, stage,
        transcode_utf8_to_utf16_sharded, transcode_utf16_to_utf8_sharded,
        validate_utf8_sharded)
    from simdutf_tpu.parallel.distributed import (
        base64_to_binary_sharded, binary_to_base64_sharded, count_sharded,
        gather_base64, gather_utf16)
    from simdutf_tpu.parallel.planner import (plan_shards_base64,
                                              plan_shards_binary3)

    devs = jax.devices()
    if len(devs) < n_dev:
        raise RuntimeError(f"need {n_dev} devices, have {len(devs)}")
    mesh = make_mesh(n_dev)
    data = corpus(mib)
    t = {}
    plan = plan_shards(data, n_dev)
    staged = stage(plan, mesh)
    placed = {s.device.id for s in staged[0].addressable_shards}
    assert len(placed) == n_dev, f"shards on devices {sorted(placed)}"

    got, t["validate_first_s"], t["validate_s"] = timed(
        lambda: validate_utf8_sharded(plan, mesh, staged=staged), repeat=2)
    one = su.validate_utf8_with_errors(data)
    assert got == (0, one.count) and one.is_ok, (got, one)

    (code, units, outs, lens), t["to_utf16_first_s"], t["to_utf16_s"] = \
        timed(lambda: transcode_utf8_to_utf16_sharded(plan, mesh,
                                                      staged=staged), repeat=2)
    u16 = su.convert_utf8_to_utf16le(data)
    assert code == 0 and units * 2 == len(u16)
    same("sharded utf16", gather_utf16(outs, lens).tobytes(), u16)

    plan16 = plan_shards(np.frombuffer(u16, np.uint8), n_dev, unit=2)
    (code, nbytes, outs8, lens8), t["to_utf8_first_s"], t["to_utf8_s"] = \
        timed(lambda: transcode_utf16_to_utf8_sharded(plan16, mesh), repeat=1)
    assert code == 0 and nbytes == len(data)
    same("sharded utf8", gather_utf16(outs8, lens8).tobytes(), data)

    n_cp, t["count_first_s"], t["count_s"] = timed(
        lambda: count_sharded(plan, mesh, "utf8", staged=staged), repeat=2)
    same("sharded count", n_cp, su.count_utf8(data))

    errors = []
    for frac in (0.5, 0.25):
        where = int(plan.offsets[int(n_dev * frac)]) + 1
        bad = bytearray(data)
        bad[where] = 0xFF
        bad = bytes(bad)
        one = su.validate_utf8_with_errors(bad)
        got = validate_utf8_sharded(plan_shards(bad, n_dev), mesh)
        assert got == (int(one.error), one.count), (got, one)
        code, pos, _, _ = transcode_utf8_to_utf16_sharded(
            plan_shards(bad, n_dev), mesh)
        assert (code, pos) == (int(one.error), one.count)
        errors.append([int(one.error), one.count])

    raw = data[: len(data) // 2]
    enc = pyb64.b64encode(raw)
    mime = b"\r\n".join(enc[i: i + 76] for i in range(0, len(enc), 76))
    planb = plan_shards_base64(mime, n_dev)
    (full, outsb, lensb, extra), t["b64_decode_first_s"], t["b64_decode_s"] = \
        timed(lambda: base64_to_binary_sharded(mime, planb, mesh), repeat=1)
    assert full.is_ok, full
    got = b"".join(np.asarray(outsb)[i, : int(lensb[i])].tobytes()
                   for i in range(n_dev)) + extra.tobytes()
    same("sharded base64 decode", got, su.base64_to_binary(mime)[1])
    same("sharded base64 decode payload", got, raw)
    plane = plan_shards_binary3(raw, n_dev)
    (chars, clens, tail), t["b64_encode_first_s"], t["b64_encode_s"] = \
        timed(lambda: binary_to_base64_sharded(raw, plane, mesh), repeat=1)
    same("sharded base64 encode", gather_base64(chars, clens, tail),
         su.binary_to_base64(raw))

    mask, t["detect_s"], _ = timed(
        lambda: detect_encodings_sharded(data, mesh))
    same("sharded detect", mask, su.detect_encodings(data))
    return emit("sharded", devices=n_dev, placed_on=sorted(placed),
                bytes=len(data), errors=errors, **t)


def build_cnative() -> bool:
    """Build the C scalar tier in place when it is missing (it is one of
    the references every phase compares with). False when the host has no
    compiler for it; the phases then compare with the golden tier only."""
    try:
        import simdutf_tpu._cnative  # noqa: F401

        return True
    except ImportError:
        pass
    proc = subprocess.run([sys.executable, "setup.py", "build_ext",
                           "--inplace"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        print(proc.stderr[-2000:], file=sys.stderr)
    importlib.invalidate_caches()  # let this process find the new module
    return proc.returncode == 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    configure_compile_cache()
    # before phase 1: the auto-selected tier binds its scalar tier (the
    # small-input router's target) when it is first detected
    cnative_built = build_cnative()
    phase_device()
    emit("setup", cnative_built=cnative_built)
    if args.chips == 4:
        phase_sharded(4)
    else:
        _, outs = phase_flagship()
        phase_back_to_utf8(outs)
        del outs
        phase_base64()
        phase_batch_stream()
        phase_big()
        phase_ab()
    devs = jax.devices()
    emit("done", wall_s=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
