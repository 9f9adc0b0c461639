#!/usr/bin/env python
"""Device-resident throughput of the main ops on one GPU. Prints ONE JSON
line on stdout (details on stderr).

Rows: the validating UTF-8 -> UTF-16LE transcode (headline, mixed corpus,
plus per-script corpora), UTF-16LE -> UTF-8, forgiving base64 decode of
76-column MIME text, base64 encode, UTF-8 validation, and a large
read-modify-write copy measured in the same call as a bandwidth anchor.

Methodology: ITERS calls chained inside one jitted ``fori_loop`` whose
length argument changes with the loop index (nothing is loop-invariant),
TRIALS trials with rotated lengths, median of trials. GB/s counts input
bytes like the reference harness (benchmarks/src/benchmark_base.cpp:
118-136). The roofline share compares the op's minimum HBM traffic with
the card's published peak, taken from PEAK_HBM_GBPS by ``device_kind``;
a device missing from the table is an error, so a CPU run fails.

    python bench.py            # BENCH_CORPUS_MB (default 64) of input
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REFERENCE_GBPS = 4.0  # simdutf headline transcode GB/s per core
#: published HBM bandwidth by jax ``device_kind`` (NVIDIA data sheets)
PEAK_HBM_GBPS = {"NVIDIA H200": 4800.0, "NVIDIA H100 80GB HBM3": 3350.0}
ITERS = 20
TRIALS = 5
CORPUS_BYTES = int(os.environ.get("BENCH_CORPUS_MB", "64")) * 1024 * 1024 - 4096


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def device_record() -> dict:
    """Platform, kind, count, card name and power limit of this run."""
    import jax

    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in smi.split(","))
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": name, "power_limit": limit}


def peak_hbm_gbps(kind: str) -> float:
    if kind not in PEAK_HBM_GBPS:
        raise KeyError(f"no published HBM peak for device kind {kind!r}; "
                       f"known: {sorted(PEAK_HBM_GBPS)}")
    return PEAK_HBM_GBPS[kind]


def valid_utf8_lengths(data: bytes, n_base: int, count: int,
                       step: int = 12) -> np.ndarray:
    """``count`` distinct lengths near ``n_base``, each snapped back to a
    codepoint boundary, so every chained call measures the valid-input
    path (the reference's headline)."""
    import simdutf_tpu as su

    out = []
    for i in range(count):
        L = n_base - step * i
        tail = data[max(0, L - 4): L]
        out.append(L - len(tail) + su.trim_partial_utf8(tail))
    return np.array(out, np.int32)


def run_chained(f, x, lengths) -> float:
    """Median per-call seconds over TRIALS of the jitted loop f(x, lens);
    each trial rotates the length vector. ``x`` is an argument, never a
    closure (a closure would bake the corpus into the program)."""
    import jax
    import jax.numpy as jnp

    lengths = np.asarray(lengths, np.int32)
    jax.block_until_ready(f(x, jnp.asarray(lengths)))
    ts = []
    for t in range(TRIALS):
        lens_t = jnp.asarray(np.roll(lengths, t + 1))
        t0 = time.perf_counter()
        jax.block_until_ready(f(x, lens_t))
        ts.append((time.perf_counter() - t0) / ITERS)
    return statistics.median(ts)


def chain(body):
    """Jitted ITERS-step loop over ``body(x, n) -> (array or None,
    int32 scalar)``; an optimization barrier keeps the whole array as
    produced, and its first element feeds the carry."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def f(x, lens):
        def it(i, acc):
            out, scalar = body(x, lens[i & 7])
            if out is not None:
                out = lax.optimization_barrier(out)
                scalar = scalar + out[0].astype(jnp.int32)
            return acc + scalar
        return lax.fori_loop(0, ITERS, it, jnp.int32(0))

    return f


def main():
    import jax
    import jax.numpy as jnp

    from simdutf_tpu.runtime import configure_compile_cache, tune_host_allocator

    configure_compile_cache()
    dev = device_record()
    peak = peak_hbm_gbps(dev["kind"])
    log(f"device {dev}, published HBM peak {peak} GB/s")

    import simdutf_tpu as su
    import simdutf_tpu.ops.base64_ops as ob
    import simdutf_tpu.ops.impl as oi
    import simdutf_tpu.ops.utf8 as o8
    import simdutf_tpu.ops.utf16 as o16
    from tools import gen_corpus

    tune_host_allocator()
    data = gen_corpus.mixed_corpus(CORPUS_BYTES)
    nbytes = len(data)
    p, n = oi._pad(np.frombuffer(data, np.uint8))
    xj = jax.device_put(p)
    Ls = valid_utf8_lengths(data, int(n), 8)
    rows = {}

    def row(name, n_in, dt, traffic):
        rows[name] = {"gbps": round(n_in / dt / 1e9, 3),
                      "ms": round(dt * 1e3, 4),
                      "roofline_pct": round(100 * traffic / (peak * 1e9) / dt, 2)}
        log(f"{name:28s} {rows[name]}")

    copy = chain(lambda x, L: (x + (L & 1).astype(jnp.uint8), L))
    row("copy_read_write", nbytes, run_chained(copy, xj, Ls), 2 * nbytes)

    to16 = chain(lambda x, L: (lambda r: (r[2], r[0] + r[1] + r[3]))(
        o8.to_utf16(x, L, False)))
    dt = run_chained(to16, xj, Ls)
    n16 = su.utf16_length_from_utf8(data)
    row("utf8_to_utf16le", nbytes, dt, nbytes + 2 * n16)
    headline = nbytes / dt / 1e9

    for script in ("ascii", "zh", "zh_pure"):
        block = gen_corpus.generate(gen_corpus.PROFILES[script], 1 << 20, 1)
        sdata = (block * (CORPUS_BYTES // len(block) + 1))[:CORPUS_BYTES]
        sdata = sdata[: su.trim_partial_utf8(sdata)]
        sp, sn = oi._pad(np.frombuffer(sdata, np.uint8))
        sdt = run_chained(to16, jax.device_put(sp),
                          valid_utf8_lengths(sdata, int(sn), 8))
        row(f"utf8_to_utf16le[{script}]", len(sdata), sdt,
            len(sdata) + 2 * su.utf16_length_from_utf8(sdata))

    validate = chain(lambda x, L: (None, sum(o8.validate_with_errors(x, L))))
    row("utf8_validate", nbytes, run_chained(validate, xj, Ls), nbytes)

    u16 = np.frombuffer(data.decode().encode("utf-16-le"), np.uint16)
    p16, n16u = oi._pad(u16)
    L16 = np.array([int(n16u) - 8 * i - (
        0xD800 <= int(u16[int(n16u) - 8 * i - 1]) <= 0xDBFF)
        for i in range(8)], np.int32)
    to8 = chain(lambda x, L: (lambda r: (r[2], r[0] + r[1] + r[3]))(
        o16.to_utf8(x, L, False)))
    row("utf16le_to_utf8", 2 * len(u16),
        run_chained(to8, jax.device_put(p16), L16), 2 * len(u16) + nbytes)

    import base64 as pyb64

    raw = pyb64.b64encode(data[: CORPUS_BYTES * 3 // 4])
    mime = b"\r\n".join(raw[i:i + 76] for i in range(0, len(raw), 76))
    p64, n64 = oi._pad(np.frombuffer(mime, np.uint8))
    dec = chain(lambda x, L: (lambda r: (r[3], r[0] % 7 + r[1]))(
        ob.decode_bulk(x, L, False, False)))
    row("base64_decode_mime", len(mime),
        run_chained(dec, jax.device_put(p64),
                    int(n64) - 4 * np.arange(8, dtype=np.int32)),
        len(mime) + len(raw) * 3 // 4)

    enc_n = (CORPUS_BYTES // 2) // 3 * 3
    enc = chain(lambda x, L: (ob.encode_bulk(
        x + (L & 1).astype(jnp.uint8), False), L))
    row("base64_encode", enc_n,
        run_chained(enc, jax.device_put(np.frombuffer(data[:enc_n], np.uint8)),
                    np.arange(8, dtype=np.int32)),
        enc_n + enc_n * 4 // 3)

    print(json.dumps({
        "metric": "utf8_to_utf16_validating_transcode",
        "value": round(headline, 3),
        "unit": "GB/s (input bytes, device-resident)",
        "vs_baseline": round(headline / REFERENCE_GBPS, 3),
        "device": dev,
        "peak_hbm_gbps": peak,
        "rows": rows,
    }))


if __name__ == "__main__":
    main()
