"""Fixed-rate fast branches of the device tier against Python's codecs.

The census-routed transcodes send whole-buffer uniform classes (ASCII,
uniform 2-, 3- or 4-byte UTF-8, BMP or astral UTF-16, Latin1) to
elementwise branches with no scan and no scatter. These cases hit each
branch at lengths around word and block boundaries, then break the class
with one divergent unit so the same call takes the general engine. Every
case runs routed and with routing off; both must equal the codec result
byte for byte.
"""

import base64 as pyb64
import random

import numpy as np
import pytest

import helpers
import simdutf_tpu as su


@pytest.fixture(autouse=True)
def _active(xla_impl):
    su.set_active_implementation(xla_impl)
    yield
    su.set_active_implementation("fallback")


def _enc16(be):
    return "utf-16-be" if be else "utf-16-le"


# --- ASCII widen / narrow -------------------------------------------------------


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("n", [0, 1, 7, 511, 512, 4097, 70000])
def test_widen_ascii_exact(be, n):
    data = bytes((i * 7 + 13) % 128 for i in range(n))
    conv = su.convert_utf8_to_utf16be if be else su.convert_utf8_to_utf16le
    assert conv(data) == data.decode().encode(_enc16(be))


@pytest.mark.parametrize("spot", [0, 1, 510, 511, 512, 513, 9000])
def test_widen_nonascii_spot(spot):
    data = bytearray(b"a" * 9001)
    data[spot] = 0xC3  # truncated 2-byte sequence: an error at ``spot``
    res, _ = su.convert_utf8_to_utf16le_with_errors(bytes(data))
    assert not res.is_ok and res.count == spot
    data[spot:spot + 1] = "é".encode()
    assert su.convert_utf8_to_utf16le(bytes(data)) == \
        bytes(data).decode().encode("utf-16-le")


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 2049, 40000])
def test_narrow_ascii_exact(be, n):
    s = "".join(chr((i * 11 + 5) % 128) for i in range(n))
    conv = su.convert_utf16be_to_utf8 if be else su.convert_utf16le_to_utf8
    assert conv(s.encode(_enc16(be))) == s.encode()


@pytest.mark.parametrize("be", [False, True])
def test_narrow_nonascii_tail(be):
    s = "abc" * 1000 + "é"
    conv = su.convert_utf16be_to_utf8 if be else su.convert_utf16le_to_utf8
    assert conv(s.encode(_enc16(be))) == s.encode()


def test_ascii_and_mixed_entry_points():
    for s in ("hello device world " * 400, "héllo wörld 日本語 🙂 " * 100):
        data = s.encode()
        assert su.convert_utf8_to_utf16le(data) == s.encode("utf-16-le")
        assert su.convert_valid_utf8_to_utf16le(data) == s.encode("utf-16-le")
        assert su.convert_utf8_to_utf16be(data) == s.encode("utf-16-be")
    for s in ("ok " * 900, "日本 ok " * 300):
        assert su.convert_utf16le_to_utf8(s.encode("utf-16-le")) == s.encode()


def test_with_errors_result_counts():
    data = b"abc" * 1000
    r = su.convert_utf8_to_utf16le_with_errors(data)
    assert r[0].is_ok and r[0].count == len(data)
    u16 = "xyz".encode("utf-16-le") * 500
    r = su.convert_utf16le_to_utf8_with_errors(u16)
    assert r[0].is_ok and r[0].count == len(u16) // 2


# --- base64 -------------------------------------------------------------------


@pytest.mark.parametrize("url", [False, True])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 4, 100, 3000, 70000])
def test_b64_roundtrip(url, n):
    rng = np.random.default_rng(n + url)
    raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    opts = su.base64_url if url else su.base64_default
    enc = su.binary_to_base64(raw, opts)
    want = pyb64.urlsafe_b64encode(raw) if url else pyb64.b64encode(raw)
    if url:
        want = want.rstrip(b"=")  # base64_url omits padding by default
    assert enc == want
    res, back = su.base64_to_binary(enc, opts)
    assert res.is_ok and back == raw


def test_b64_curated_last_chunk_modes():
    cases = [
        b"aGVsbG8=", b"aGVsbG8", b"", b"QQ==", b"QUJDRA==", b"A" * 8192,
        b"QUJD" * 5000, b"TWFu", b"bGlnaHQgdw==", b"bGlnaHQgd28=",
    ]
    fb = su.get_available_implementations()["fallback"]
    for data in cases:
        arr = np.frombuffer(data, np.uint8)
        for lc in (su.loose, su.strict, su.stop_before_partial):
            got = su.base64_to_binary_details(data, last_chunk_handling=lc)
            res, out = fb.base64_to_binary_details(arr, 0, lc)
            assert got == (res, out.tobytes()), (data[:20], lc)


def test_b64_whitespace_and_garbage():
    cases = [
        b"aGVs bG8=", b" " * 100 + b"aGVsbG8=", b"aGVsbG8=   ",
        b"aGVs!bG8=", b"QUJD" * 100 + b"\n" + b"QUJD" * 100,
    ]
    fb = su.get_available_implementations()["fallback"]
    for data in cases:
        arr = np.frombuffer(data, np.uint8)
        for opts in (su.base64_default, su.base64_default_accept_garbage):
            got = su.base64_to_binary_details(data, options=opts)
            res, out = fb.base64_to_binary_details(arr, opts)
            assert got == (res, out.tobytes()), (data, opts)


# --- uniform-width UTF-8 <-> UTF-16 / UTF-32 ----------------------------------------


def _script(kind, n, seed):
    rng = random.Random(seed)
    if kind == "cyr":
        return "".join(chr(rng.randrange(0x80, 0x800)) for _ in range(n))
    if kind == "cjk":
        return "".join(
            chr(rng.choice([rng.randrange(0x800, 0xD800),
                            rng.randrange(0xE000, 0x10000)]))
            for _ in range(n))
    if kind == "astral":
        return "".join(chr(rng.randrange(0x10000, 0x110000)) for _ in range(n))
    return "".join(chr(rng.randrange(0x20, 0x7F)) for _ in range(n))


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("script", ["cyr", "cjk", "astral"])
def test_uniform_utf8_to_utf16(be, script):
    s = _script(script, 5000, 7)
    conv = su.convert_utf8_to_utf16be if be else su.convert_utf8_to_utf16le
    validc = (su.convert_valid_utf8_to_utf16be if be
              else su.convert_valid_utf8_to_utf16le)
    assert conv(s.encode()) == s.encode(_enc16(be))
    assert validc(s.encode()) == s.encode(_enc16(be))


def test_uniform_divergence_and_errors():
    """Near-uniform corpora with one divergent char or one error must
    match the golden tier exactly."""
    cyr = ("ж" * 4000 + "a" + "ж" * 100).encode()
    cjk = ("語" * 4000 + "é" + "語" * 100).encode()
    bad2 = bytearray(("ж" * 3000).encode())
    bad2[501] = 0xFF
    bad3 = bytearray(("語" * 3000).encode())
    bad3[300] = 0x80
    sur = bytearray(("語" * 2000).encode())
    sur[99:102] = b"\xed\xa0\x80"  # encoded surrogate: invalid
    fb = su.get_available_implementations()["fallback"]
    for data in (cyr, cjk, bytes(bad2), bytes(bad3), bytes(sur)):
        got = su.convert_utf8_to_utf16le_with_errors(data)
        res, out = fb.convert_utf8_to_utf16le_with_errors(
            np.frombuffer(data, np.uint8))
        assert got == (res, out.tobytes())


@pytest.mark.parametrize("be", [False, True])
@pytest.mark.parametrize("script", ["cyr", "cjk"])
def test_uniform_utf16_to_utf8(be, script):
    s = _script(script, 4001, 9)
    conv = su.convert_utf16be_to_utf8 if be else su.convert_utf16le_to_utf8
    assert conv(s.encode(_enc16(be))) == s.encode()
    mixed = s[:2000] + "a" + s[2000:]
    assert conv(mixed.encode(_enc16(be))) == mixed.encode()


def test_latin1_widen():
    data = bytes(range(256)) * 40
    s = data.decode("latin-1")
    assert su.convert_latin1_to_utf16le(data) == s.encode("utf-16-le")
    assert su.convert_latin1_to_utf16be(data) == s.encode("utf-16-be")
    assert su.convert_latin1_to_utf32(data) == s.encode("utf-32-le")
    assert su.convert_latin1_to_utf8(data) == s.encode()
    hi = bytes(range(0x80, 0x100)) * 30
    assert su.convert_latin1_to_utf8(hi) == hi.decode("latin-1").encode()


@pytest.mark.parametrize("be", [False, True])
def test_bmp_widen_narrow(be):
    rng = random.Random(5)
    s = "".join(chr(rng.choice([rng.randrange(1, 0xD800),
                                rng.randrange(0xE000, 0x10000)]))
                for _ in range(3001))
    conv32 = su.convert_utf16be_to_utf32 if be else su.convert_utf16le_to_utf32
    conv16 = su.convert_utf32_to_utf16be if be else su.convert_utf32_to_utf16le
    assert conv32(s.encode(_enc16(be))) == s.encode("utf-32-le")
    assert conv16(s.encode("utf-32-le")) == s.encode(_enc16(be))
    s2 = s[:100] + "🙂" + s[100:]  # astral char: general engine
    assert conv32(s2.encode(_enc16(be))) == s2.encode("utf-32-le")
    assert conv16(s2.encode("utf-32-le")) == s2.encode(_enc16(be))


@pytest.mark.parametrize("script", ["cyr", "cjk", "ascii", "astral"])
def test_uniform_utf8_utf32_roundtrip(script):
    s = _script(script, 3001, 11)
    data, u32 = s.encode(), s.encode("utf-32-le")
    assert su.convert_utf8_to_utf32(data) == u32
    assert su.convert_valid_utf8_to_utf32(data) == u32
    assert su.convert_utf32_to_utf8(u32) == data
    assert su.convert_valid_utf32_to_utf8(u32) == data
    s2 = s[:50] + ("x" if script != "ascii" else "é") + s[50:]
    assert su.convert_utf8_to_utf32(s2.encode()) == s2.encode("utf-32-le")
    assert su.convert_utf32_to_utf8(s2.encode("utf-32-le")) == s2.encode()


# --- detection ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_detect_differential(seed):
    """Fused one-pass detection agrees with the fallback tier on every
    input class. Ref: haswell/implementation.cpp:152-260."""
    rng = random.Random(seed)
    cases = []
    for i in range(40):
        k = i % 5
        if k == 0:
            cases.append(helpers.random_utf8(seed * 99 + i, rng.randrange(0, 700), 2, 1, 1, 1))
        elif k == 1:
            cases.append(helpers.random_utf16(seed * 99 + i, rng.randrange(0, 350), 2, 1))
        elif k == 2:
            cps = [c for c in (rng.randrange(0, 0x110000) for _ in range(rng.randrange(0, 170)))
                   if not (0xD800 <= c <= 0xDFFF)]
            cases.append(np.array(cps, np.uint32).tobytes())
        elif k == 3:
            cases.append(helpers.random_bytes(seed * 99 + i, rng.randrange(0, 700)))
        else:
            cases.append(helpers.mutate(
                helpers.random_utf8(seed * 99 + i, 150, 1, 1, 1, 1), i, 3))
    cases += [b"\xff\xfeab", b"\xef\xbb\xbfxy", b"\x00\xd8\x00\xdc",
              b"\x00\xdc\x00\xd8", b"\x00\xd8", b"\x00\xdc", b"",
              b"\x00\xd8\x00\xd8\x00\xdc\x00\xdc", b"\x00\xdcrest"]
    fb = su.get_available_implementations()["fallback"]
    for data in cases:
        want = fb.detect_encodings(np.frombuffer(data, np.uint8))
        assert su.detect_encodings(data) == want, data.hex()


# --- astral (uniform 4-byte / surrogate pairs) ------------------------------------


@pytest.mark.parametrize("be", [False, True])
def test_astral_utf16_utf32_pair_maps(be):
    s = _script("astral", 2501, 17)
    conv32 = su.convert_utf16be_to_utf32 if be else su.convert_utf16le_to_utf32
    conv16 = su.convert_utf32_to_utf16be if be else su.convert_utf32_to_utf16le
    assert conv32(s.encode(_enc16(be))) == s.encode("utf-32-le")
    assert conv16(s.encode("utf-32-le")) == s.encode(_enc16(be))
    conv8 = su.convert_utf16be_to_utf8 if be else su.convert_utf16le_to_utf8
    assert conv8(s.encode(_enc16(be))) == s.encode()


def test_astral_divergence_exact():
    s = _script("astral", 2001, 23)
    fb = su.get_available_implementations()["fallback"]
    u8 = [(s[:700] + "x" + s[700:]).encode()]
    bad8 = bytearray(s.encode())
    bad8[1001] = 0x2A  # breaks a 4-byte sequence
    u8.append(bytes(bad8))
    for data in u8:
        arr = np.frombuffer(data, np.uint8)
        for name in ("convert_utf8_to_utf16le_with_errors",
                     "convert_utf8_to_utf32_with_errors"):
            res, out = getattr(fb, name)(arr)
            assert getattr(su, name)(data) == (res, out.tobytes()), name
    lone = np.frombuffer(s.encode("utf-16-le"), np.uint16).copy()
    lone[501] = 0xD800  # low half replaced by a high surrogate
    res, out = fb.convert_utf16le_to_utf32_with_errors(lone)
    assert su.convert_utf16le_to_utf32_with_errors(lone.tobytes()) == \
        (res, out.tobytes())
    bad32 = np.frombuffer(s.encode("utf-32-le"), np.uint32).copy()
    bad32[301] = 0x110000
    for name in ("convert_utf32_to_utf16le_with_errors",
                 "convert_utf32_to_utf8_with_errors"):
        res, out = getattr(fb, name)(bad32)
        assert getattr(su, name)(bad32.tobytes()) == (res, out.tobytes())
