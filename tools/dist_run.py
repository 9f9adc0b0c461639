#!/usr/bin/env python
"""Multi-host runner: validate/transcode a corpus across several hosts.

Launch one copy per host (the reference scales via user threads,
benchmarks/threaded.cpp; here the unit of scaling is chips/hosts):

    python tools/dist_run.py --coordinator=HOST0:1234 \
        --num-processes=2 --process-id=$ID corpus.txt

Single-host multi-chip needs no flags:

    python tools/dist_run.py corpus.txt

Prints the global Result and per-second throughput; also reports scaling
efficiency when --baseline-gbps (single-chip measurement) is given.
"""

from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--baseline-gbps", type=float)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("file")
    args = ap.parse_args()

    import jax

    if args.coordinator:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    from simdutf_tpu.parallel import (
        count_sharded,
        make_mesh,
        plan_shards,
        stage,
        transcode_utf8_to_utf16_sharded,
        validate_utf8_sharded,
    )

    with open(args.file, "rb") as f:
        data = f.read()

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    plan = plan_shards(data, n_dev)
    staged = stage(plan, mesh)  # one transfer; reused across iterations
    code, pos = validate_utf8_sharded(plan, mesh, staged=staged)  # compile
    t0 = time.perf_counter()
    for _ in range(args.iters):
        code, pos = validate_utf8_sharded(plan, mesh, staged=staged)
    dt = (time.perf_counter() - t0) / args.iters
    gbps = len(data) / dt / 1e9

    # transcode + count over the same staged shards (round-2 surface)
    tc = transcode_utf8_to_utf16_sharded(plan, mesh, staged=staged)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        tc = transcode_utf8_to_utf16_sharded(plan, mesh, staged=staged)
    tdt = (time.perf_counter() - t0) / args.iters
    n_cp = count_sharded(plan, mesh, "utf8", staged=staged)

    from simdutf_tpu.parallel import detect_encodings_sharded

    mask = detect_encodings_sharded(data, mesh)

    # multi-host materialization: each process handles only the output
    # shards it hosts (shard k belongs at offset sum(out_lens[:k]))
    from simdutf_tpu.parallel.distributed import local_shards

    mine = local_shards(tc[2], tc[3])
    local_units = sum(a.shape[0] for _, a in mine)

    print(f"[p{jax.process_index()}] hosts output shards "
          f"{[k for k, _ in mine]} ({local_units} units)", flush=True)
    if jax.process_index() == 0:
        print(f"devices={n_dev} processes={jax.process_count()}"
              f" result=({code},{pos}) validate {gbps:.1f} GB/s"
              f" | transcode {len(data)/tdt/1e9:.1f} GB/s"
              f" (code={tc[0]}, units={tc[1]}) | {n_cp} codepoints"
              f" | detect mask {mask}")
        if args.baseline_gbps:
            eff = gbps / (args.baseline_gbps * n_dev) * 100
            print(f"scaling efficiency vs {n_dev}x single-chip: {eff:.0f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
