#!/usr/bin/env python
"""Broad benchmark harness: one JSON record per procedure.

Mirrors the reference's benchmark registry + scripts/benchmark-all.py
reporting (benchmarks/src/benchmark.cpp registers 101 procedures; we cover
every op family on device plus host competitors). Each line:

  {"procedure": ..., "gbps": ..., "sol_pct": ..., "ms": ..., "bytes": ...}

GB/s is input-bytes based like benchmark_base.cpp:118-136; sol_pct is
the per-op minimum HBM read+write traffic over the card's published peak
(bench.PEAK_HBM_GBPS; an unknown device is an error). Every record carries
the device, card name and power limit.

Usage: python tools/bench_all.py [--size MB] [--filter substr] [--list]
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

ITERS = 10
TRIALS = 5
MB = 1024 * 1024


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# --- corpora -----------------------------------------------------------------


def _trim8(data: bytes) -> bytes:
    import simdutf_tpu as su

    return data[: su.trim_partial_utf8(data)]


def _corpora(nbytes: int):
    import base64 as pyb64

    from tools.gen_corpus import mixed_corpus

    mixed = mixed_corpus(nbytes)
    u16 = mixed.decode("utf-8").encode("utf-16-le")[:nbytes]
    u16 = u16[: len(u16) // 2 * 2]
    # trim a split surrogate pair at the cut
    import simdutf_tpu as su

    u16 = u16[: 2 * su.trim_partial_utf16le(u16)]
    raw = np.random.default_rng(7).integers(0, 256, nbytes * 3 // 4,
                                            dtype=np.uint8).tobytes()
    b64_clean = pyb64.b64encode(raw)[:nbytes]
    b64_clean = b64_clean[: len(b64_clean) // 4 * 4]
    chars = np.frombuffer(b64_clean, np.uint8).copy()
    sp = np.random.default_rng(8).random(len(chars)) < (1 / 77.0)
    spaced = chars.copy()
    spaced[sp] = ord(" ")  # overwrite (keeps length; quads break -> forgiving path)
    ascii_c = (b"The quick brown fox jumps over the lazy dog. " * (
        nbytes // 46 + 1))[:nbytes]
    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    import gen_corpus

    zh = gen_corpus.generate(gen_corpus.PROFILES["zh_pure"], 1 << 20, seed=2)
    zh = (zh * (nbytes // len(zh) + 1))[:nbytes]
    cyr = gen_corpus.generate(
        gen_corpus.PROFILES["cyrillic_pure"], 1 << 20, seed=2)
    cyr = (cyr * (nbytes // len(cyr) + 1))[:nbytes]
    u32 = mixed.decode("utf-8").encode("utf-32-le")[:nbytes]
    u32 = u32[: len(u32) // 4 * 4]
    lat_text = ("Grüße aus München - ¡señor! àéîõû ÆØÅ ÷ × ¤ "
                "plain ASCII interleaved for a realistic byte mix. ")
    latin1 = (lat_text.encode("latin-1") * (
        nbytes // len(lat_text.encode("latin-1")) + 1))[:nbytes]
    emoji = ("🙂🚀🌍💡🎉😀🥳🤖".encode() * (nbytes // 32 + 1))[:nbytes]
    # twitter.json-class corpus (BASELINE config 1): ASCII-heavy JSON with
    # embedded unicode text fields
    tweet = ('{"id": 1234567890, "user": "somebody", "lang": "ja", '
             '"text": "RT @friend: 今日はいい天気ですね🙂 #weather", '
             '"entities": {"hashtags": ["weather"], "urls": []}},\n')
    jsonish = (tweet.encode() * (nbytes // len(tweet.encode()) + 1))[:nbytes]
    u16be = np.frombuffer(u16, np.uint16).byteswap().tobytes()
    lat16 = latin1.decode("latin-1").encode("utf-16-le")[:nbytes]
    lat32 = latin1.decode("latin-1").encode("utf-32-le")[:nbytes]
    # worst-case UTF-8: equal random mix of 1/2/3/4-byte classes — defeats
    # every uniform-class fast path, stresses the general transcode machinery
    # (the reference's adversarial "worst" corpus idea,
    # benchmarks/src/benchmark.cpp 4-byte worst-expansion notes)
    worst = gen_corpus.generate(
        [((0x20, 0x7E), 0.25), ((0x400, 0x4FF), 0.25),
         ((0x4E00, 0x9FFF), 0.25), ((0x1F300, 0x1F64F), 0.25)],
        1 << 20, seed=3)
    worst = _trim8((worst * (nbytes // len(worst) + 1))[:nbytes])
    emoji16 = ("🙂🚀🌍💡🎉😀🥳🤖".encode("utf-16-le") * (
        nbytes // 32 + 1))[:nbytes]
    return {
        "mixed": mixed,
        "ascii": ascii_c,
        "zh_pure": zh[: len(zh) // 3 * 3],
        "cyr_pure": cyr[: len(cyr) // 2 * 2],
        "emoji_pure": emoji[: len(emoji) // 4 * 4],
        "jsonish": _trim8(jsonish),
        "ascii16": ascii_c.decode().encode("utf-16-le")[:nbytes],
        "utf16": u16,
        "utf16be": u16be,
        "latin1_utf16": lat16[: len(lat16) // 2 * 2],
        "latin1_utf32": lat32[: len(lat32) // 4 * 4],
        "worst": worst,
        "emoji16": emoji16[: len(emoji16) // 4 * 4],
        "utf32": u32,
        "latin1": latin1,
        "latin1_utf8": _trim8(latin1.decode("latin-1").encode("utf-8")[:nbytes]),
        "b64": b64_clean,
        "b64_spaced": spaced.tobytes(),
        "binary": raw[:nbytes],
    }


# --- timing ------------------------------------------------------------------


def _run_chained(f, x, n):
    import jax
    import jax.numpy as jnp

    jax.block_until_ready(f(x, jnp.int32(n)))
    ts = []
    for t in range(TRIALS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(x, jnp.int32(n - 8 * (t + 1))))
        ts.append((time.perf_counter() - t0) / ITERS)
    return statistics.median(ts)


def _chain_scalarish(body):
    """body(x, n) -> int32-reducible scalar(s)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def f(x, n0):
        def it(i, acc):
            return acc + body(x, n0 - (i & 7))
        return lax.fori_loop(0, ITERS, it, jnp.int32(0))

    return f


def _chain_out(body):
    """body(x, n) -> (out array, out_len)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def f(x, n0):
        def it(i, acc):
            out, out_len = body(x, n0 - (i & 7))
            # static content probe behind an optimization barrier: a
            # bare out[0] would let XLA push the slice through
            # elementwise producers and compute ONE element; the barrier
            # keeps the whole output as produced
            out = lax.optimization_barrier(out)
            probe = out[0].astype(jnp.int32)
            return acc + out_len + probe
        return lax.fori_loop(0, ITERS, it, jnp.int32(0))

    return f


# --- procedure registry --------------------------------------------------


def build_procedures():
    """Returns [(name, corpus_key, prepare(arr)->(x, n), chained_fn,
    traffic(nbytes)->min_rw_bytes)]. Built lazily so jax imports once."""
    import jax.numpy as jnp

    import simdutf_tpu.ops.impl as oi
    import simdutf_tpu.ops.utf8 as o8
    import simdutf_tpu.ops.utf16 as o16
    import simdutf_tpu.ops.base64_ops as ob

    def pad8(arr):
        return oi._pad(arr)

    def pad16(arr):
        return oi._pad(arr.view(np.uint16))

    P = []

    def add(name, corpus, prep, fn, traffic):
        P.append((name, corpus, prep, fn, traffic))

    # validation family
    add("utf8_validate", "mixed", pad8,
        _chain_scalarish(lambda x, n: o8.validate_with_errors(x, n)[0] +
                         o8.validate_with_errors(x, n)[1]),
        lambda nb: nb)
    add("ascii_validate", "ascii", pad8,
        _chain_scalarish(lambda x, n: o8.validate_ascii_with_errors(x, n)[1]),
        lambda nb: nb)
    add("utf16_validate", "utf16", pad16,
        _chain_scalarish(lambda x, n: o16.validate_with_errors(x, n, False)[1]),
        lambda nb: nb)

    # BASELINE config 1: validate + count on twitter.json-class data
    add("utf8_validate_jsonish", "jsonish", pad8,
        _chain_scalarish(lambda x, n: o8.validate_with_errors(x, n)[0] +
                         o8.validate_with_errors(x, n)[1]),
        lambda nb: nb)
    add("utf8_count_jsonish", "jsonish", pad8,
        _chain_scalarish(o8.count_code_points), lambda nb: nb)

    # counting family
    add("utf8_count", "mixed", pad8,
        _chain_scalarish(o8.count_code_points), lambda nb: nb)
    add("utf16_length_from_utf8", "mixed", pad8,
        _chain_scalarish(o8.utf16_length), lambda nb: nb)
    add("utf8_length_from_utf16", "utf16", pad16,
        _chain_scalarish(lambda x, n: o16.utf8_length(x, n, False)),
        lambda nb: nb)
    add("utf16_count", "utf16", pad16,
        _chain_scalarish(lambda x, n: o16.count_code_points(x, n, False)),
        lambda nb: nb)

    # transcode family (traffic: in + typical out)
    add("utf8_to_utf16le", "mixed", pad8,
        _chain_out(lambda x, n: o8.to_utf16(x, n, False)[2:]),
        lambda nb: nb + int(nb * 1.4))
    add("utf8_to_utf16le_valid", "mixed", pad8,
        _chain_out(lambda x, n: o8.to_utf16_valid(x, n, False)),
        lambda nb: nb + int(nb * 1.4))
    add("utf8_to_utf16le_ascii", "ascii", pad8,
        _chain_out(lambda x, n: o8.to_utf16(x, n, False)[2:]),
        lambda nb: 3 * nb)
    add("utf8_to_utf32", "mixed", pad8,
        _chain_out(lambda x, n: o8.to_utf32(x, n)[2:]),
        lambda nb: nb + int(nb * 2.8))
    add("utf16_to_utf8", "utf16", pad16,
        _chain_out(lambda x, n: o16.to_utf8(x, n, False)[2:]),
        lambda nb: nb + int(nb * 0.8))
    add("utf16_change_endianness", "utf16", pad16,
        _chain_out(lambda x, n: (o16.change_endianness(x), n)),
        lambda nb: 2 * nb)
    add("utf16_to_well_formed", "utf16", pad16,
        _chain_out(lambda x, n: (o16.to_well_formed(x, n, False), n)),
        lambda nb: 2 * nb)

    # base64 family
    def b64_dec(x, n):
        fb, nv, _, packed, _, _ = ob.decode_bulk(x, n, False, False)
        return packed, (nv // 4) * 3 + fb * 0

    add("base64_decode", "b64", pad8, _chain_out(b64_dec),
        lambda nb: nb + nb * 3 // 4)
    add("base64_decode_spaced", "b64_spaced", pad8, _chain_out(b64_dec),
        lambda nb: nb + nb * 3 // 4)

    def b64_enc(x, n):
        out = oi._j_b64_encode(x, url=False)
        return out, (n // 3) * 4

    add("base64_encode", "binary", lambda a: oi._pad(a, multiple=3),
        _chain_out(b64_enc), lambda nb: nb + nb * 4 // 3)

    add("utf8_to_utf16le_cjk_xla", "zh_pure", pad8,
        _chain_out(lambda x, n: o8.to_utf16(x, n, False)[2:]),
        lambda nb: nb + nb * 2 // 3)
    add("utf8_to_utf16le_emoji", "emoji_pure", pad8,
        _chain_out(lambda x, n: o8.to_utf16(x, n, False)[2:]),
        lambda nb: 2 * nb)
    add("utf8_to_utf32_emoji", "emoji_pure", pad8,
        _chain_out(lambda x, n: o8.to_utf32(x, n)[2:]),
        lambda nb: 2 * nb)

    # utf32 / latin1 families (completes the 12-way matrix coverage)
    import simdutf_tpu.ops.utf32 as o32
    import simdutf_tpu.ops.latin1 as ol1

    def pad32(arr):
        return oi._pad(arr.view(np.uint32))

    add("utf16_to_utf32", "utf16", pad16,
        _chain_out(lambda x, n: o16.to_utf32(x, n, False)[2:]),
        lambda nb: 3 * nb)
    add("utf16_to_utf8_valid", "utf16", pad16,
        _chain_out(lambda x, n: o16.to_utf8_valid(x, n, False)),
        lambda nb: nb + int(nb * 0.8))
    add("utf16be_to_utf8", "utf16be", pad16,
        _chain_out(lambda x, n: o16.to_utf8(x, n, True)[2:]),
        lambda nb: nb + int(nb * 0.8))
    add("utf32_to_utf8_valid", "utf32", pad32,
        _chain_out(lambda x, n: o32.to_utf8_valid(x, n)),
        lambda nb: nb + int(nb * 0.45))
    add("latin1_to_utf16le", "latin1", pad8,
        _chain_out(lambda x, n: (ol1.to_utf16(x, n, False), n)),
        lambda nb: 3 * nb)
    add("utf16_to_latin1", "latin1_utf16", pad16,
        _chain_out(lambda x, n: o16.to_latin1(x, n, False)[2:]),
        lambda nb: nb + nb // 2)
    add("utf32_validate", "utf32", pad32,
        _chain_scalarish(lambda x, n: o32.validate_with_errors(x, n)[1]),
        lambda nb: nb)
    add("utf32_to_utf8", "utf32", pad32,
        _chain_out(lambda x, n: o32.to_utf8(x, n)[2:]),
        lambda nb: nb + int(nb * 0.45))
    add("utf32_to_utf16le", "utf32", pad32,
        _chain_out(lambda x, n: o32.to_utf16(x, n, False)[2:]),
        lambda nb: nb + nb // 2)
    add("latin1_to_utf8", "latin1", pad8,
        _chain_out(lambda x, n: ol1.to_utf8(x, n)),
        lambda nb: nb + int(nb * 1.1))
    add("utf8_to_latin1", "latin1_utf8", pad8,
        _chain_out(lambda x, n: o8.to_latin1(x, n)[2:]),
        lambda nb: nb + int(nb * 0.9))

    # remaining reference-procedure analogs (benchmarks/src/benchmark.cpp
    # registry): latin1<->utf32, utf32->utf16be, the length predictors, and
    # the rest of the convert_valid_* family
    add("latin1_to_utf32", "latin1", pad8,
        _chain_out(lambda x, n: (ol1.to_utf32(x, n), n)),
        lambda nb: 5 * nb)
    add("utf32_to_latin1", "latin1_utf32", pad32,
        _chain_out(lambda x, n: o32.to_latin1(x, n)[2:]),
        lambda nb: nb + nb // 4)
    add("utf32_to_latin1_valid", "latin1_utf32", pad32,
        _chain_out(lambda x, n: o32.to_latin1_valid(x, n)),
        lambda nb: nb + nb // 4)
    add("utf32_to_utf16be", "utf32", pad32,
        _chain_out(lambda x, n: o32.to_utf16(x, n, True)[2:]),
        lambda nb: nb + nb // 2)
    add("utf32_to_utf16le_valid", "utf32", pad32,
        _chain_out(lambda x, n: o32.to_utf16_valid(x, n, False)),
        lambda nb: nb + nb // 2)
    add("utf8_length_from_latin1", "latin1", pad8,
        _chain_scalarish(ol1.utf8_length), lambda nb: nb)
    add("utf8_length_from_utf32", "utf32", pad32,
        _chain_scalarish(o32.utf8_length), lambda nb: nb)
    add("utf16_length_from_utf32", "utf32", pad32,
        _chain_scalarish(o32.utf16_length), lambda nb: nb)
    add("utf8_to_utf32_valid", "mixed", pad8,
        _chain_out(lambda x, n: o8.to_utf32_valid(x, n)),
        lambda nb: nb + int(nb * 2.8))
    add("utf8_to_latin1_valid", "latin1_utf8", pad8,
        _chain_out(lambda x, n: o8.to_latin1_valid(x, n)),
        lambda nb: nb + int(nb * 0.9))
    add("utf16_to_utf32_valid", "utf16", pad16,
        _chain_out(lambda x, n: o16.to_utf32_valid(x, n, False)),
        lambda nb: 3 * nb)
    add("utf16_to_latin1_valid", "latin1_utf16", pad16,
        _chain_out(lambda x, n: o16.to_latin1_valid(x, n, False)),
        lambda nb: nb + nb // 2)

    # adversarial worst-case byte-class mix (no uniform-class fast path
    # applies — measures the general classify->scan->scatter machinery)
    add("utf8_validate_worst", "worst", pad8,
        _chain_scalarish(lambda x, n: o8.validate_with_errors(x, n)[0] +
                         o8.validate_with_errors(x, n)[1]),
        lambda nb: nb)
    add("utf8_to_utf16le_worst", "worst", pad8,
        _chain_out(lambda x, n: o8.to_utf16(x, n, False)[2:]),
        lambda nb: nb + int(nb * 1.3))
    add("utf8_count_worst", "worst", pad8,
        _chain_scalarish(o8.count_code_points), lambda nb: nb)

    # detection
    import simdutf_tpu.ops.detect as od

    add("detect_encodings", "mixed", pad8,
        _chain_scalarish(lambda x, n: sum(
            jnp.asarray(c).astype(jnp.int32)
            for c in od.detect_encodings(x, n))),
        lambda nb: nb)

    # --- _with_errors rows (reference benchmark.cpp registers one per
    # direction; here the *_with_errors surface IS the default device
    # path — exact (code, pos) are computed in-engine for free — so
    # these rows time the same programs while consuming the error scalars
    # too, documenting that the error contract costs nothing extra)
    def _chain_out_err(body):
        import jax
        from jax import lax

        @jax.jit
        def f(x, n0):
            def it(i, acc):
                code, pos, out, out_len = body(x, n0 - (i & 7))
                out = lax.optimization_barrier(out)  # see _chain_out
                return (acc + out_len + code + pos
                        + out[0].astype(jnp.int32))
            return lax.fori_loop(0, ITERS, it, jnp.int32(0))

        return f

    add("utf8_to_utf16le_with_errors", "mixed", pad8,
        _chain_out_err(lambda x, n: o8.to_utf16(x, n, False)),
        lambda nb: nb + int(nb * 1.4))
    add("utf8_to_utf32_with_errors", "mixed", pad8,
        _chain_out_err(lambda x, n: o8.to_utf32(x, n)),
        lambda nb: nb + int(nb * 2.8))
    add("utf8_to_latin1_with_errors", "latin1_utf8", pad8,
        _chain_out_err(lambda x, n: o8.to_latin1(x, n)),
        lambda nb: nb + int(nb * 0.9))
    add("utf16_to_utf8_with_errors", "utf16", pad16,
        _chain_out_err(lambda x, n: o16.to_utf8(x, n, False)),
        lambda nb: nb + int(nb * 0.8))
    add("utf16_to_utf32_with_errors", "utf16", pad16,
        _chain_out_err(lambda x, n: o16.to_utf32(x, n, False)),
        lambda nb: 3 * nb)
    add("utf16_to_latin1_with_errors", "latin1_utf16", pad16,
        _chain_out_err(lambda x, n: o16.to_latin1(x, n, False)),
        lambda nb: nb + nb // 2)
    add("utf32_to_utf8_with_errors", "utf32", pad32,
        _chain_out_err(lambda x, n: o32.to_utf8(x, n)),
        lambda nb: nb + nb // 2)
    add("utf32_to_utf16le_with_errors", "utf32", pad32,
        _chain_out_err(lambda x, n: o32.to_utf16(x, n, False)),
        lambda nb: nb + nb // 2)
    add("utf32_to_latin1_with_errors", "latin1_utf32", pad32,
        _chain_out_err(lambda x, n: o32.to_latin1(x, n)),
        lambda nb: nb + nb // 4)
    add("validate_utf16_with_errors", "utf16", pad16,
        _chain_scalarish(
            lambda x, n: sum(o16.validate_with_errors(x, n, False))),
        lambda nb: nb)
    add("validate_utf32_with_errors", "utf32", pad32,
        _chain_scalarish(
            lambda x, n: sum(o32.validate_with_errors(x, n))),
        lambda nb: nb)

    # --- BE-side rows (reference expands per byte order)
    add("utf16be_validate", "utf16be", pad16,
        _chain_scalarish(
            lambda x, n: sum(o16.validate_with_errors(x, n, True))),
        lambda nb: nb)
    add("utf8_length_from_utf16be", "utf16be", pad16,
        _chain_scalarish(lambda x, n: o16.utf8_length(x, n, True)),
        lambda nb: nb)
    add("utf16be_to_utf32", "utf16be", pad16,
        _chain_out(lambda x, n: o16.to_utf32(x, n, True)[2:]),
        lambda nb: 3 * nb)
    add("utf32_to_utf16be_valid", "utf32", pad32,
        _chain_out(lambda x, n: o32.to_utf16_valid(x, n, True)),
        lambda nb: nb + nb // 2)
    add("latin1_to_utf16be", "latin1", pad8,
        _chain_out(lambda x, n: (ol1.to_utf16(x, n, True), n)),
        lambda nb: 3 * nb)

    return P


def host_competitors(corp):
    """CPython codecs / base64 module — the ecosystem's ICU/iconv analog
    (reference competitor table: benchmarks/src/benchmark.h:9-46)."""
    import base64 as pyb64

    out = []
    mixed, u16, b64 = corp["mixed"][: 8 * MB], corp["utf16"][: 8 * MB], corp["b64"][: 8 * MB]
    mixed = _trim8(mixed)

    def t(name, fn, nbytes):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        out.append({"procedure": name, "gbps": round(nbytes / dt / 1e9, 3),
                    "competitor": True})

    t("cpython_utf8_to_utf16le",
      lambda: mixed.decode("utf-8").encode("utf-16-le"), len(mixed))
    t("cpython_utf8_validate",
      lambda: mixed.decode("utf-8", errors="strict"), len(mixed))
    t("cpython_utf16le_to_utf8",
      lambda: u16.decode("utf-16-le", errors="surrogatepass").encode("utf-8"),
      len(u16))
    t("cpython_base64_decode", lambda: pyb64.b64decode(b64), len(b64))
    t("cpython_base64_encode",
      lambda: pyb64.b64encode(corp["binary"][: 8 * MB]),
      len(corp["binary"][: 8 * MB]))
    # per-direction codecs + binascii (every device
    # procedure gets at least one host competitor row; the reference
    # benches ICU/iconv per direction, benchmarks/src/benchmark.h:9-46)
    t("cpython_utf8_to_utf32",
      lambda: mixed.decode("utf-8").encode("utf-32-le"), len(mixed))
    u32 = mixed.decode("utf-8").encode("utf-32-le")
    t("cpython_utf32_to_utf8",
      lambda: u32.decode("utf-32-le").encode("utf-8"), len(u32))
    t("cpython_utf16le_to_utf32",
      lambda: u16.decode("utf-16-le", errors="surrogatepass")
      .encode("utf-32-le", errors="surrogatepass"), len(u16))
    t("cpython_utf32_to_utf16le",
      lambda: u32.decode("utf-32-le").encode("utf-16-le"), len(u32))
    lat = bytes(range(256)) * (2 * MB // 256)
    t("cpython_latin1_to_utf8",
      lambda: lat.decode("latin-1").encode("utf-8"), len(lat))
    lat8 = lat.decode("latin-1").encode("utf-8")
    t("cpython_utf8_to_latin1",
      lambda: lat8.decode("utf-8").encode("latin-1"), len(lat8))
    t("cpython_utf16_swap",
      lambda: u16.decode("utf-16-le", errors="surrogatepass")
      .encode("utf-16-be", errors="surrogatepass"), len(u16))
    import binascii

    t("binascii_a2b_base64", lambda: binascii.a2b_base64(b64), len(b64))
    t("binascii_b2a_base64",
      lambda: binascii.b2a_base64(corp["binary"][: 8 * MB]),
      len(corp["binary"][: 8 * MB]))
    try:  # PyICU, if the environment ships it (the reference's #1 rival)
        import icu  # noqa: F401

        t("pyicu_utf8_to_utf16",
          lambda: icu.UnicodeString(mixed.decode("utf-8")), len(mixed))
    except ImportError:
        pass

    # our own host tiers as competitors (the reference benches its
    # fallback backend the same way)
    try:
        from simdutf_tpu.registry import get_available_implementations

        impls = get_available_implementations()
        m2 = mixed[: 2 * MB]
        import simdutf_tpu as su

        m2 = m2[: su.trim_partial_utf8(m2)]
        arr2 = np.frombuffer(m2, np.uint8)
        for tier in ("cnative", "fallback"):
            if tier not in impls:
                continue
            impl = impls[tier]
            t(f"{tier}_utf8_validate",
              lambda impl=impl: impl.validate_utf8(arr2), len(m2))
            t(f"{tier}_utf8_to_utf16le",
              lambda impl=impl: impl.convert_utf8_to_utf16le_with_errors(
                  arr2), len(m2))
    except Exception:
        pass
    return out


def main():
    size = 64
    filt = ""
    argv = sys.argv[1:]
    for i, a in enumerate(argv):
        # accept both --opt=value and --opt value
        def val():
            if "=" in a:
                return a.split("=", 1)[1]
            if i + 1 >= len(argv) or argv[i + 1].startswith("--"):
                sys.exit(f"bench_all: {a} needs a value")
            return argv[i + 1]

        if a.startswith("--size"):
            size = int(val())
        if a.startswith("--filter"):
            filt = val()
    import jax

    from bench import device_record, peak_hbm_gbps
    from simdutf_tpu.runtime import configure_compile_cache

    configure_compile_cache()
    dev = device_record()
    hbm = peak_hbm_gbps(dev["kind"])
    log(f"device {dev}, published HBM peak {hbm} GB/s")

    if "--list" in sys.argv:
        for name, ck, *_ in build_procedures():
            print(name, f"[{ck}]")
        return

    nbytes = size * MB - 4096
    corp = _corpora(nbytes)

    from simdutf_tpu.runtime import tune_host_allocator

    tune_host_allocator()
    records = []
    for name, ck, prep, fn, traffic in build_procedures():
        if filt and filt not in name:
            continue
        arr = np.frombuffer(corp[ck], np.uint8)
        try:
            x, n = prep(arr)
            xj = jax.device_put(x)
            xj.block_until_ready()
            dt = _run_chained(fn, xj, int(n))
            nb = len(corp[ck])
            sol = traffic(nb) / hbm / 1e9
            rec = {
                "procedure": name,
                "gbps": round(nb / dt / 1e9, 2),
                "sol_pct": round(100 * sol / dt, 1),
                "ms": round(dt * 1e3, 3),
                "bytes": nb,
                "device": dev,
            }
            records.append(rec)
            log(f"{name:28s} {rec['gbps']:7.1f} GB/s  {rec['sol_pct']:5.1f}% SOL")
            print(json.dumps(rec), flush=True)
            del xj
        except Exception as e:
            log(f"{name:28s} ERROR {type(e).__name__}: {e}")
    # batch API (host pack + device): end-to-end wall clock
    try:
        import simdutf_tpu.batch as sb

        items = [corp["mixed"][i * 8192 : (i + 1) * 8192] for i in range(512)]
        items = [it[: len(it)] for it in items if it]
        tot = sum(len(it) for it in items)
        sb.validate_utf8_batch(items)  # compile at the timed batch shape
        t0 = time.perf_counter()
        sb.validate_utf8_batch(items)
        dt = time.perf_counter() - t0
        rec = {"procedure": "utf8_validate_batch_e2e",
               "gbps": round(tot / dt / 1e9, 2), "ms": round(dt * 1e3, 2),
               "bytes": tot}
        log(f"{rec['procedure']:28s} {rec['gbps']:7.2f} GB/s (end-to-end)")
        print(json.dumps({**rec, "device": dev}), flush=True)
    except Exception as e:
        log(f"batch bench skipped: {e}")

    # streaming chunked transcode (the reference's benchmarks/stream.cpp
    # microstudy): bounded-memory chunks with trim_partial joints through
    # the public API — measures the chunking/staging overhead end-to-end
    try:
        import simdutf_tpu as su

        data = corp["mixed"][: 16 * MB]
        chunk_sz = 1 * MB
        su.convert_utf8_to_utf16le(data[:chunk_sz])  # compile
        t0 = time.perf_counter()
        pos = total_units = 0
        while pos < len(data):
            chunk = data[pos : pos + chunk_sz]
            keep = su.trim_partial_utf8(chunk) if pos + chunk_sz < len(data) \
                else len(chunk)
            out = su.convert_utf8_to_utf16le(chunk[:keep])
            total_units += len(out) // 2
            pos += keep
        dt = time.perf_counter() - t0
        rec = {"procedure": "utf8_to_utf16le_stream_e2e",
               "gbps": round(len(data) / dt / 1e9, 2),
               "ms": round(dt * 1e3, 2), "bytes": len(data),
               "chunk_bytes": chunk_sz, "units": total_units}
        log(f"{rec['procedure']:28s} {rec['gbps']:7.2f} GB/s (end-to-end)")
        print(json.dumps({**rec, "device": dev}), flush=True)
    except Exception as e:
        log(f"stream bench skipped: {e}")

    # thread-scaling microstudy (the reference's benchmarks/threaded.cpp:
    # users shard a corpus across threads and expect near-linear scaling).
    # Threads share one process-wide jit cache; each validates its own
    # shard through the public API. Device work serializes on one card, so
    # the interesting number is aggregate throughput vs 1-thread — it shows
    # the dispatch path doesn't lose the reference's "stateless API, safe
    # concurrent callers" property under load.
    try:
        import threading

        import simdutf_tpu as su

        data = corp["mixed"][: 16 * MB]
        su.validate_utf8_with_errors(data[: 1 * MB])  # compile
        for nthreads in (1, 4):
            shard = len(data) // nthreads
            shards = [data[i * shard : (i + 1) * shard] for i in range(nthreads)]
            shards = [s[: su.trim_partial_utf8(s)] for s in shards]
            [su.validate_utf8_with_errors(s) for s in shards]  # warm shapes
            errors = []

            def work(s):
                try:
                    su.validate_utf8_with_errors(s)
                except Exception as exc:  # noqa: BLE001 — must not emit a
                    errors.append(exc)    # record if any worker died

            t0 = time.perf_counter()
            th = [threading.Thread(target=work, args=(s,)) for s in shards]
            [t.start() for t in th]
            [t.join() for t in th]
            dt = time.perf_counter() - t0
            if errors:
                raise errors[0]
            tot = sum(len(s) for s in shards)
            rec = {"procedure": f"utf8_validate_threads{nthreads}_e2e",
                   "gbps": round(tot / dt / 1e9, 2),
                   "ms": round(dt * 1e3, 2), "bytes": tot,
                   "threads": nthreads}
            log(f"{rec['procedure']:28s} {rec['gbps']:7.2f} GB/s (end-to-end)")
            print(json.dumps({**rec, "device": dev}), flush=True)
    except Exception as e:
        log(f"threaded bench skipped: {e}")

    for rec in host_competitors(corp):
        log(f"{rec['procedure']:28s} {rec['gbps']:7.2f} GB/s (host)")
        print(json.dumps({**rec, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
