#!/usr/bin/env python
"""Benchmark corpus generator (analog of benchmarks/dataset/wikipedia_mars
+ tests/helpers/random_utf8.h): per-language synthetic corpora with
controlled byte-class mixes, plus a census report.

    python tools/gen_corpus.py --out /tmp/corpora --mb 4
    python tools/gen_corpus.py --census /tmp/corpora/ja.txt
"""

from __future__ import annotations

import argparse
import os
import random
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

# (name, codepoint ranges with weights) — byte-class profiles per script
PROFILES = {
    "ascii": [((0x20, 0x7E), 1.0)],
    "latin": [((0x20, 0x7E), 0.7), ((0xC0, 0x17F), 0.3)],
    "cyrillic": [((0x20, 0x7E), 0.25), ((0x400, 0x4FF), 0.75)],
    "arabic": [((0x20, 0x7E), 0.2), ((0x600, 0x6FF), 0.8)],
    "ja": [((0x20, 0x7E), 0.1), ((0x3040, 0x30FF), 0.45), ((0x4E00, 0x9FFF), 0.45)],
    "zh": [((0x20, 0x7E), 0.05), ((0x4E00, 0x9FFF), 0.95)],
    # pure single-width profiles: the reference's checked-in wikipedia_mars
    # files are artificially all-3-byte (benchmarks/dataset/README.md,
    # convert_to_utf6.py); these are the analogous uniform-width corpora
    "zh_pure": [((0x4E00, 0x9FFF), 1.0)],
    "cyrillic_pure": [((0x400, 0x4FF), 1.0)],
    "ko": [((0x20, 0x7E), 0.15), ((0xAC00, 0xD7A3), 0.85)],
    "emoji": [((0x20, 0x7E), 0.5), ((0x1F300, 0x1F64F), 0.5)],
    "mixed": [
        ((0x20, 0x7E), 0.4), ((0xC0, 0x17F), 0.1), ((0x400, 0x4FF), 0.1),
        ((0x600, 0x6FF), 0.1), ((0x3040, 0x30FF), 0.1),
        ((0x4E00, 0x9FFF), 0.15), ((0x1F300, 0x1F64F), 0.05),
    ],
}


def generate(profile, n_bytes: int, seed: int = 0, spaces=None) -> bytes:
    """``spaces=None`` inserts ASCII spaces at p=0.12 for single-range
    mixed profiles only; single-range profiles stay class-pure (the
    wikipedia_mars analog: the reference's checked-in dataset is converted
    to an artificial all-3-byte encoding, benchmarks/dataset/README.md),
    so census-routed uniform-class fast paths actually engage on them."""
    rng = random.Random(seed)
    ranges = [r for r, _ in profile]
    weights = [w for _, w in profile]
    if spaces is None:
        spaces = len(profile) > 1
    out = []
    size = 0
    while size < n_bytes:
        lo, hi = rng.choices(ranges, weights)[0]
        cp = rng.randint(lo, hi)
        if 0xD800 <= cp <= 0xDFFF:
            continue
        ch = chr(cp)
        out.append(ch)
        size += len(ch.encode("utf-8"))
        if spaces and rng.random() < 0.12:
            out.append(" ")
            size += 1
    data = "".join(out).encode("utf-8")
    return data[: n_bytes] if False else data  # keep whole codepoints


def mixed_corpus(nbytes: int) -> bytes:
    """Mixed-language corpus of about ``nbytes`` bytes, ending on a
    codepoint boundary: ASCII / Latin / CJK / emoji / Arabic / Cyrillic
    (byte-class mix in the spirit of benchmarks/dataset)."""
    block = (
        "The quick brown fox jumps over the lazy dog. "
        "Höfn í Hornafirði er bær á Suðausturlandi. "
        "東京は日本の首都であり、世界最大の都市圏です。"
        "مرحبا بالعالم، هذا نص تجريبي باللغة العربية. "
        "Привет, мир! Это тестовый текст. "
        "🙂🚀🌍💡🎉 emoji and 𝄞 astral chars. "
    )
    data = (block * (nbytes // len(block.encode()) + 1)).encode()[:nbytes]
    return data.decode("utf-8", "ignore").encode("utf-8")


def census(data: bytes) -> dict:
    """Byte-class census (benchmarks/dataset/README.md format)."""
    import numpy as np

    b = np.frombuffer(data, np.uint8)
    total = len(data)
    cont = int(np.count_nonzero((b & 0xC0) == 0x80))
    c = {
        "bytes": total,
        "ascii": int(np.count_nonzero(b < 0x80)),
        "2_byte_leads": int(np.count_nonzero((b & 0xE0) == 0xC0)),
        "3_byte_leads": int(np.count_nonzero((b & 0xF0) == 0xE0)),
        "4_byte_leads": int(np.count_nonzero((b & 0xF8) == 0xF0)),
        "continuations": cont,
    }
    c["codepoints"] = total - cont
    return c


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="directory to write per-language corpora")
    ap.add_argument("--mb", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--census", help="print census of an existing file")
    args = ap.parse_args()

    if args.census:
        import json

        with open(args.census, "rb") as f:
            print(json.dumps(census(f.read()), indent=2))
        return 0

    if not args.out:
        print("need --out or --census", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    for name, profile in PROFILES.items():
        data = generate(profile, args.mb * 1024 * 1024, args.seed)
        path = os.path.join(args.out, f"{name}.txt")
        with open(path, "wb") as f:
            f.write(data)
        c = census(data)
        pct = 100 * c["ascii"] / c["bytes"]
        print(f"{name:10s} {c['bytes']:>9} B  ascii {pct:4.1f}%  "
              f"cp {c['codepoints']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
