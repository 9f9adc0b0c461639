"""Multi-block corpora through the device tier's transcode engines.

Each corpus spans several 32 KiB blocks, with sequences straddling block
boundaries, every input class interleaved, and errors injected near the
boundaries. Every case runs twice: through the census-routed ops (fixed-rate
branches for uniform classes) and through the general classify -> scan ->
scatter engine alone, and both must match the golden scalar machine
bit-for-bit, including error codes, positions and partial output.

Reference behavior mirrored: the validating transcode contract of
generic/utf8_to_utf16/utf8_to_utf16.h:217-322.
"""

import base64 as pyb64

import numpy as np
import pytest

import simdutf_tpu as su
from simdutf_tpu.golden import base64_impl as gb
from simdutf_tpu.golden import latin1 as gl1
from simdutf_tpu.golden import utf8 as g8
from simdutf_tpu.golden import utf16 as g16
from simdutf_tpu.golden import utf32 as g32

BLOCK = 32768


def _trim(data: bytes) -> bytes:
    return data[: su.trim_partial_utf8(data)]


def _same(got, want):
    (gres, gout), (wres, wout) = got, want
    assert gres == wres, (gres, wres)
    assert np.array_equal(np.asarray(gout), np.asarray(wout))


# --- UTF-8 -> UTF-16 ----------------------------------------------------------

VALID8 = {
    "mixed": ("ab é 東 \U0001f642 ".encode() * 2400),
    "zh_spaces": (("東京は日本 " * 7).encode() * 380),
    "ascii": b"packed ascii! " * 2500,
    "emoji": "\U0001f642\U0001f680\U0001f30d".encode() * 3000,
    "one_block_partial": ("aé東\U0001f642".encode() * 2000)[: BLOCK // 2],
    # ascii block / CJK block / ascii block, a 3-byte sequence straddling
    # the ascii->CJK boundary
    "block_granular_mix": (
        b"a" * (BLOCK - 2) + "東".encode()
        + "京は日本".encode() * 2340
    )[: 2 * BLOCK - 200] + "é".encode() + b"z" * BLOCK,
}


@pytest.mark.parametrize("name", sorted(VALID8))
@pytest.mark.parametrize("be", [False, True])
def test_utf8_to_utf16_valid(xla_impl, name, be):
    data = _trim(bytes(VALID8[name]))
    arr = np.frombuffer(data, np.uint8)
    fn = (xla_impl.convert_utf8_to_utf16be_with_errors if be
          else xla_impl.convert_utf8_to_utf16le_with_errors)
    got = fn(arr)
    assert got[0].is_ok
    _same(got, g8.convert_to_utf16_with_errors(arr, be))


@pytest.mark.parametrize(
    "name,data",
    [
        ("orphan_cont", b"ok " + b"\x80" + b"x" * 40000),
        ("overlong", b"a" * 33000 + b"\xc0\xaf" + b"b" * 100),
        ("surrogate_enc", b"a" * 40000 + b"\xed\xa0\x80"),
        ("truncated_tail", b"a" * 40000 + "東".encode()[:2]),
        ("start_cont", b"\xbf" + b"a" * 40000),
        ("bad_header", b"a" * 100 + b"\xff" + b"a" * 40000),
    ],
)
def test_utf8_to_utf16_errors(xla_impl, name, data):
    arr = np.frombuffer(data, np.uint8)
    got = xla_impl.convert_utf8_to_utf16le_with_errors(arr)
    assert not got[0].is_ok, name
    _same(got, g8.convert_to_utf16_with_errors(arr, False))


def test_utf8_cross_block_straddle(xla_impl):
    """A multi-byte sequence whose lead is the last byte of block 0."""
    head = b"a" * (BLOCK - 1)
    for ch in ("\U0001f642", "東", "é"):
        arr = np.frombuffer(head + ch.encode() + b"tail", np.uint8)
        _same(xla_impl.convert_utf8_to_utf16le_with_errors(arr),
              g8.convert_to_utf16_with_errors(arr, False))


def test_utf8_error_positions_at_block_boundaries(xla_impl):
    """Every error kind injected around block boundaries: exact (code,
    pos, prefix units) parity with the golden machine."""
    base = bytearray(_trim(("ab é 東 \U0001f642 ".encode() * 8000)[: 3 * BLOCK]))
    sites = []
    for target in (0, 5, BLOCK - 3, BLOCK - 1, BLOCK, BLOCK + 2,
                   2 * BLOCK - 2, len(base) - 5):
        j = min(target, len(base) - 5)
        while base[j] & 0xC0 == 0x80:
            j -= 1
        sites.append(j)
    injections = [b"\x80", b"\xff", b"\xc0\xaf", b"\xed\xa0\x80",
                  b"\xf4\x90\x80\x80", b"\xc3"]
    for j in sorted(set(sites)):
        for inj in injections:
            arr = np.frombuffer(bytes(base[:j]) + inj + bytes(base[j:]),
                                np.uint8)
            _same(xla_impl.convert_utf8_to_utf16le_with_errors(arr),
                  g8.convert_to_utf16_with_errors(arr, False))


# --- UTF-16 -> UTF-8 ----------------------------------------------------------

UNITS = BLOCK // 2


def _u16(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-16-le"), np.uint16)


VALID16 = {
    "mixed": _u16("ab é 東 \U0001f642 " * 2000),
    "zh_spaces": _u16("東京は日本 " * 3000),
    "ascii": _u16("packed ascii! " * 1500),
    "emoji": _u16("\U0001f642\U0001f680\U0001f30d" * 3000),
    "cyrillic": _u16("Привет мир " * 2500),
    "one_block_partial": _u16("aé東\U0001f642" * 1000)[: UNITS // 2],
    # unit UNITS-1 is a high surrogate: the pair straddles a block
    "straddle": _u16("x" * (UNITS - 1) + "\U0001f642" + "tail é 東"),
}


@pytest.mark.parametrize("name", sorted(VALID16))
def test_utf16_to_utf8_valid(xla_impl, name):
    units = VALID16[name]
    got = xla_impl.convert_utf16le_to_utf8_with_errors(units)
    assert got[0].is_ok
    _same(got, g16.convert_to_utf8_with_errors(units, False))


BAD16 = [
    [0xD800],  # lone high at end
    [0xDC00],  # lone low
    [0x41, 0xD800, 0x42],  # high not followed by low
    [0x41, 0xDC00, 0x42],  # low not preceded by high
    [0xD800, 0xD800, 0xDC00],  # high high low
]


@pytest.mark.parametrize("bad", BAD16, ids=[f"bad{i}" for i in range(5)])
def test_utf16_to_utf8_errors(xla_impl, bad):
    for prefix in (0, UNITS - 1):
        units = np.concatenate(
            [np.full(prefix, 0x41, np.uint16), np.array(bad, np.uint16),
             np.full(7, 0x42, np.uint16)])
        got = xla_impl.convert_utf16le_to_utf8_with_errors(units)
        assert not got[0].is_ok, (prefix, bad)
        _same(got, g16.convert_to_utf8_with_errors(units, False))


def test_utf16_extreme_pairs(xla_impl):
    units = _u16("\U00010000\U0010FFFF" * 64)
    _same(xla_impl.convert_utf16le_to_utf8_with_errors(units),
          g16.convert_to_utf8_with_errors(units, False))


def test_utf16_truncated_pair_is_error(xla_impl):
    """A length cut between high and low leaves a lone high surrogate."""
    units = _u16("\U0001f642" * 8)[:-1]
    res, _ = xla_impl.convert_utf16le_to_utf8_with_errors(units)
    assert not res.is_ok and res.count == len(units) - 1
    _same(xla_impl.convert_utf16le_to_utf8_with_errors(units),
          g16.convert_to_utf8_with_errors(units, False))


def test_utf16_empty(xla_impl):
    res, out = xla_impl.convert_utf16le_to_utf8_with_errors(np.zeros(0, np.uint16))
    assert res.is_ok and res.count == 0 and len(out) == 0


def test_utf16_every_width_boundary(xla_impl):
    cps = [0x1, 0x7F, 0x80, 0x7FF, 0x800, 0xD7FF, 0xE000, 0xFFFF,
           0x10000, 0x10FFFF]
    rng = np.random.default_rng(7)
    units = _u16("".join(chr(cps[i]) for i in rng.integers(0, len(cps), 4000)))
    got = xla_impl.convert_utf16le_to_utf8_with_errors(units)
    assert got[0].is_ok
    _same(got, g16.convert_to_utf8_with_errors(units, False))


# --- UTF-8 -> UTF-32 ----------------------------------------------------------

VALID32 = {
    "mixed": ("ab é 東 \U0001f642 ".encode() * 900),
    "zh_spaces": (("東京は日本 " * 7).encode() * 120),
    "ascii": b"packed ascii! " * 800,
    "emoji": "\U0001f642\U0001f680\U0001f30d".encode() * 900,
    "one_block_partial": ("aé東\U0001f642".encode() * 500)[: 4096],
    "straddle": b"x" * (8192 - 2) + "\U0001f642é".encode(),
}


@pytest.mark.parametrize("name", sorted(VALID32))
def test_utf8_to_utf32_valid(xla_impl, name):
    arr = np.frombuffer(_trim(bytes(VALID32[name])), np.uint8)
    got = xla_impl.convert_utf8_to_utf32_with_errors(arr)
    assert got[0].is_ok
    _same(got, g8.convert_to_utf32_with_errors(arr))


BAD8 = [b"\xff", b"\xc0\xaf", b"\xe0\x80\x80", b"\xed\xa0\x80",
        b"\xf4\x90\x80\x80", b"\xc3", b"\x80abc", b"a\x80bc", b"\xe2\x98x"]


@pytest.mark.parametrize("bad", BAD8, ids=[f"bad{i}" for i in range(9)])
def test_utf8_to_utf32_errors(xla_impl, bad):
    for prefix in (0, 8192 - 2):
        arr = np.frombuffer(b"A" * prefix + bad + b"tail", np.uint8)
        got = xla_impl.convert_utf8_to_utf32_with_errors(arr)
        assert not got[0].is_ok, (prefix, bad)
        _same(got, g8.convert_to_utf32_with_errors(arr))


def test_utf8_to_utf32_empty(xla_impl):
    res, out = xla_impl.convert_utf8_to_utf32_with_errors(np.zeros(0, np.uint8))
    assert res.is_ok and res.count == 0 and len(out) == 0


# --- UTF-32 / UTF-16 / Latin1 expansions ----------------------------------------

N = 2 * 8192
MIXED = "a é 東 \U0001f642 Привет ё " * 900


def _u32(text):
    return np.frombuffer(text.encode("utf-32-le"), np.uint32)


def test_u32_to_utf8_matches_golden(xla_impl):
    words = _u32(MIXED)[: N - 5]
    got = xla_impl.convert_utf32_to_utf8_with_errors(words)
    assert got[0].is_ok
    _same(got, g32.convert_to_utf8_with_errors(words))


@pytest.mark.parametrize("bad", [0xD800, 0xDFFF, 0x110000, 0xFFFFFFFF])
def test_u32_to_utf8_errors(xla_impl, bad):
    words = _u32(MIXED)[:3000]
    w = np.concatenate([words, [bad], words]).astype(np.uint32)
    got = xla_impl.convert_utf32_to_utf8_with_errors(w)
    assert not got[0].is_ok and got[0].count == 3000
    _same(got, g32.convert_to_utf8_with_errors(w))


@pytest.mark.parametrize("be", [False, True])
def test_u32_to_utf16_matches_golden(xla_impl, be):
    words = _u32(MIXED)[: N - 3]
    fn = (xla_impl.convert_utf32_to_utf16be_with_errors if be
          else xla_impl.convert_utf32_to_utf16le_with_errors)
    got = fn(words)
    assert got[0].is_ok
    _same(got, g32.convert_to_utf16_with_errors(words, be))


def test_u16_to_utf32_matches_golden(xla_impl):
    units = _u16(MIXED)[: N - 7]
    if (units[-1] & 0xFC00) == 0xD800:
        units = units[:-1]
    got = xla_impl.convert_utf16le_to_utf32_with_errors(units)
    assert got[0].is_ok
    _same(got, g16.convert_to_utf32_with_errors(units, False))


def test_u16_to_utf32_pair_straddles_block(xla_impl):
    units = np.concatenate([np.full(8192 - 1, 0x41, np.uint16),
                            _u16("\U0001f642é東")])
    assert (units[8192 - 1] & 0xFC00) == 0xD800
    _same(xla_impl.convert_utf16le_to_utf32_with_errors(units),
          g16.convert_to_utf32_with_errors(units, False))


@pytest.mark.parametrize("bad", [[0xD800, 0x41], [0xDC00], [0xD800]],
                         ids=["high_then_ascii", "lone_low", "lone_high"])
def test_u16_to_utf32_errors(xla_impl, bad):
    units = np.concatenate([np.full(17, 0x42, np.uint16),
                            np.array(bad, np.uint16)])
    got = xla_impl.convert_utf16le_to_utf32_with_errors(units)
    assert not got[0].is_ok
    _same(got, g16.convert_to_utf32_with_errors(units, False))


def test_latin1_to_utf8_matches_golden(xla_impl):
    arr = np.frombuffer((bytes(range(256)) * 70)[: N - 11], np.uint8)
    got = xla_impl.convert_latin1_to_utf8(arr)
    assert np.array_equal(got, gl1.convert_to_utf8(arr))


# --- base64 whitespace compaction ---------------------------------------------


def _mime(nbytes: int, every: int = 76, ws: bytes = b"\r\n") -> bytes:
    line = pyb64.b64encode(bytes(range(256)) * 64)[:every]
    return (line + ws) * (nbytes // (every + len(ws)) + 1)


B64_CORPORA = {
    "clean": pyb64.b64encode(b"hello world" * 4000),
    "mime_crlf": _mime(70000),
    "mime_lf": _mime(70000, ws=b"\n"),
    "space_every_4": b" ".join(b"TWFu" for _ in range(12000)),
    "tabs_formfeed": b"TWFu\t\x0c" * 9000,
    "partial_tail": _mime(70000)[: 70000 - (70000 % 4) + 2],
    "all_whitespace": b" \r\n\t" * 20000,
}

B64_OPTIONS = {"default": gb.BASE64_DEFAULT, "url": gb.BASE64_URL,
               "default_or_url": gb.BASE64_DEFAULT_OR_URL}


@pytest.mark.parametrize("name", sorted(B64_CORPORA))
@pytest.mark.parametrize("opt", sorted(B64_OPTIONS))
def test_base64_decode_corpora(name, opt):
    arr = np.frombuffer(bytes(B64_CORPORA[name]), np.uint8)
    xla = su.get_available_implementations()["xla"]
    got = xla.base64_to_binary_details(arr, B64_OPTIONS[opt])
    want = su.get_available_implementations()["fallback"] \
        .base64_to_binary_details(arr, B64_OPTIONS[opt])
    assert got[0] == want[0]
    assert np.array_equal(got[1], want[1])


def test_base64_first_bad_at_block_boundaries():
    base = _mime(5 * BLOCK)
    xla = su.get_available_implementations()["xla"]
    fb = su.get_available_implementations()["fallback"]
    for pos in (0, 1, BLOCK - 1, BLOCK, BLOCK + 7, 2 * BLOCK - 1,
                len(base) - 1):
        data = bytearray(base)
        data[pos] = ord("*")
        arr = np.frombuffer(bytes(data), np.uint8)
        got = xla.base64_to_binary_details(arr)
        want = fb.base64_to_binary_details(arr)
        assert got[0] == want[0], pos
        assert np.array_equal(got[1], want[1]), pos


def test_base64_wrapped_roundtrip():
    payload = b"The quick brown fox! " * 3000
    raw = pyb64.b64encode(payload)
    wrapped = b"\r\n".join(raw[i: i + 76] for i in range(0, len(raw), 76))
    res, out = su.get_available_implementations()["xla"].base64_to_binary_details(
        np.frombuffer(wrapped, np.uint8))
    assert res.is_ok
    assert out.tobytes() == payload
