#!/usr/bin/env python
"""Render benchmark JSON records as human tables — the analog of the
reference's scripts/benchmark_print.py / scripts/base64bench_print.py /
scripts/create_latex_table.py post-processors.

Inputs (any mix):
  * a `bench_all.jsonl` file (one JSON record per procedure)
  * a `bench.py` single-line headline record
  * a directory holding bench.json and/or bench_all.jsonl

Output: a GitHub-markdown table sorted by GB/s (device procedures), then
end-to-end rows, then competitors; `--latex` emits a LaTeX tabular like
create_latex_table.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def load_records(paths):
    recs = []
    for p in paths:
        if os.path.isdir(p):
            for name in ("bench.json", "bench_all.jsonl"):
                q = os.path.join(p, name)
                if os.path.exists(q):
                    recs += load_records([q])
            continue
        with open(p) as f:
            text = f.read()
        try:
            whole = json.loads(text)
            # driver envelope: the record is under "parsed"
            if isinstance(whole, dict) and "parsed" in whole:
                whole = whole["parsed"]  # may be null for a failed run
            items = whole if isinstance(whole, list) else [whole]
            recs += [r for r in items if isinstance(r, dict)]
            continue
        except json.JSONDecodeError:
            pass
        for line in text.splitlines():
            line = line.strip()
            if not line or not line.startswith("{"):
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return recs


def norm(rec):
    name = rec.get("procedure") or rec.get("metric") or "?"
    gbps = rec.get("gbps", rec.get("value"))
    kind = ("competitor" if rec.get("competitor")
            else "e2e" if name.endswith("_e2e")
            else "device")
    return {"name": name, "gbps": gbps, "sol": rec.get("sol_pct"),
            "kind": kind, "extra": rec}


def fmt_md(rows):
    out = ["| procedure | GB/s | SOL % | kind |", "|---|---:|---:|---|"]
    for r in rows:
        sol = f"{r['sol']:.1f}" if isinstance(r["sol"], (int, float)) else ""
        gb = f"{r['gbps']:.2f}" if isinstance(r["gbps"], (int, float)) else "?"
        out.append(f"| {r['name']} | {gb} | {sol} | {r['kind']} |")
    return "\n".join(out)


def fmt_latex(rows):
    out = [r"\begin{tabular}{lrr}", r"\toprule",
           r"procedure & GB/s & SOL\,\% \\", r"\midrule"]
    for r in rows:
        sol = f"{r['sol']:.1f}" if isinstance(r["sol"], (int, float)) else "--"
        gb = f"{r['gbps']:.2f}" if isinstance(r["gbps"], (int, float)) else "?"
        name = r["name"].replace("_", r"\_")
        out.append(f"{name} & {gb} & {sol} \\\\")
    out += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="jsonl/json files or record dirs")
    ap.add_argument("--latex", action="store_true")
    ap.add_argument("--top", type=int, default=0, help="keep top N by GB/s")
    args = ap.parse_args(argv)

    rows = [norm(r) for r in load_records(args.paths)]
    rows = [r for r in rows if r["gbps"] is not None]
    order = {"device": 0, "e2e": 1, "competitor": 2}
    rows.sort(key=lambda r: (order[r["kind"]], -float(r["gbps"])))
    if args.top:
        rows = rows[: args.top]
    print(fmt_latex(rows) if args.latex else fmt_md(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
