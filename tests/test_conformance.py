"""Differential conformance: every registered implementation vs the oracle.

This is the core of the test strategy (reference model: tests run once per
implementation; deviations across implementations are not tolerated —
fuzz/README.md:8-16). Inputs cover valid corpora across byte-class mixes,
brute-force mutations, and curated adversarial cases.
"""

import numpy as np
import pytest

import helpers
import oracle
import simdutf_tpu as su
from simdutf_tpu.errors import error_code as ec

# --- input corpora ----------------------------------------------------------

UTF8_CASES = [
    b"",
    b"a",
    b"hello world",
    "héllo wörld".encode(),
    "日本語のテキスト".encode(),
    "🙂🚀🌍 emoji mix".encode(),
    "مرحبا بالعالم".encode(),
    ("a" * 1000).encode(),
    ("δ" * 700).encode(),
    ("髓" * 500).encode(),
    ("𐍈" * 300).encode(),
    bytes([0xF4, 0x8F, 0xBF, 0xBF]),  # U+10FFFF
    bytes([0xED, 0x9F, 0xBF]),  # U+D7FF
    bytes([0xEE, 0x80, 0x80]),  # U+E000
]

UTF8_BAD_CASES = [
    b"\x80",  # stray continuation at 0
    b"a\x80b",
    b"\xc3",  # truncated 2-byte
    b"\xc3\x28",  # bad continuation
    b"\xc0\xaf",  # overlong '/'
    b"\xe0\x80\x80",  # overlong
    b"\xed\xa0\x80",  # surrogate D800
    b"\xed\xbf\xbf",  # surrogate DFFF
    b"\xf0\x80\x80\x80",  # overlong 4-byte
    b"\xf4\x90\x80\x80",  # > U+10FFFF
    b"\xf8\x88\x80\x80\x80",  # 5-byte header
    b"\xff",
    b"\xfe",
    b"ab\xe2\x82",  # truncated at end
    b"ab\xe2\x82\xacc\xf0\x9f",  # truncated 4-byte at end
    b"\xc3\xa9\x80",  # valid 2-byte then stray continuation
    b"\xf0\x9f\x98\x80\x80",  # valid 4-byte then stray continuation
    b"\xe2\x82\xac\xc3\xc3\xa9",  # lead interrupting lead
    b"A" * 63 + b"\x80",
    b"A" * 64 + b"\xc3\x28" + b"B" * 64,
]

for s in range(30):
    UTF8_CASES.append(helpers.random_utf8(s, 257, 4, 3, 2, 1))
    UTF8_BAD_CASES.append(
        helpers.mutate(helpers.random_utf8(s + 1000, 300, 1, 1, 1, 1), s, 3)
    )


def _ids(cases):
    return [f"case{i}" for i in range(len(cases))]


# --- UTF-8 ------------------------------------------------------------------


@pytest.mark.parametrize("data", UTF8_CASES + UTF8_BAD_CASES, ids=_ids(UTF8_CASES + UTF8_BAD_CASES))
def test_utf8_validate(impl_name, data):
    expect = oracle.validate_utf8_with_errors(data)
    assert su.validate_utf8(data) == expect.is_ok
    got = su.validate_utf8_with_errors(data)
    assert got == expect, f"{got} != {expect} on {data.hex()}"


@pytest.mark.parametrize("data", UTF8_CASES + UTF8_BAD_CASES, ids=_ids(UTF8_CASES + UTF8_BAD_CASES))
def test_utf8_counts(impl_name, data):
    assert su.count_utf8(data) == oracle.count_utf8(data)
    assert su.utf16_length_from_utf8(data) == oracle.utf16_length_from_utf8(data)
    assert su.utf32_length_from_utf8(data) == oracle.utf32_length_from_utf8(data)


@pytest.mark.parametrize("data", UTF8_CASES + UTF8_BAD_CASES, ids=_ids(UTF8_CASES + UTF8_BAD_CASES))
def test_utf8_to_utf16(transcode_impl, data):
    for be in (False, True):
        expect_res, expect_out = oracle.convert_utf8_to_utf16_with_errors(data, be)
        fn = (
            su.convert_utf8_to_utf16be_with_errors
            if be
            else su.convert_utf8_to_utf16le_with_errors
        )
        got_res, got_out = fn(data)
        assert got_res == expect_res, (got_res, expect_res, data.hex())
        assert got_out == expect_out
        plain = su.convert_utf8_to_utf16be(data) if be else su.convert_utf8_to_utf16le(data)
        assert plain == (expect_out if expect_res.is_ok else b"")
        if expect_res.is_ok:
            valid = (
                su.convert_valid_utf8_to_utf16be(data)
                if be
                else su.convert_valid_utf8_to_utf16le(data)
            )
            assert valid == expect_out


@pytest.mark.parametrize("data", UTF8_CASES + UTF8_BAD_CASES, ids=_ids(UTF8_CASES + UTF8_BAD_CASES))
def test_utf8_to_utf32(transcode_impl, data):
    expect_res, expect_out = oracle.convert_utf8_to_utf32_with_errors(data)
    got_res, got_out = su.convert_utf8_to_utf32_with_errors(data)
    assert got_res == expect_res
    assert got_out == expect_out


@pytest.mark.parametrize("data", UTF8_CASES + UTF8_BAD_CASES, ids=_ids(UTF8_CASES + UTF8_BAD_CASES))
def test_utf8_to_latin1(impl_name, data):
    expect_res, expect_out = oracle.convert_utf8_to_latin1_with_errors(data)
    got_res, got_out = su.convert_utf8_to_latin1_with_errors(data)
    assert got_res == expect_res, (got_res, expect_res, data.hex())
    assert got_out == expect_out


@pytest.mark.parametrize("data", UTF8_CASES, ids=_ids(UTF8_CASES))
def test_utf8_trim_partial(impl_name, data):
    for cut in range(max(0, len(data) - 5), len(data) + 1):
        prefix = data[:cut]
        assert su.trim_partial_utf8(prefix) == oracle.trim_partial_utf8(prefix)
        # trimmed prefix of valid utf8 must validate
        if oracle.validate_utf8(data):
            t = su.trim_partial_utf8(prefix)
            assert oracle.validate_utf8(prefix[:t])


# --- ASCII ------------------------------------------------------------------


@pytest.mark.parametrize(
    "data", [b"", b"ascii only", b"a" * 1000, b"a\x80b", b"\xffzz", bytes(range(128))]
)
def test_ascii(impl_name, data):
    assert su.validate_ascii(data) == oracle.validate_ascii(data)
    assert su.validate_ascii_with_errors(data) == oracle.validate_ascii_with_errors(data)


# --- UTF-16 -----------------------------------------------------------------

UTF16_CASES = [
    b"",
    "hello".encode("utf-16-le"),
    "héllo wörld𝄞".encode("utf-16-le"),
    "🙂🚀🌍".encode("utf-16-le"),
    np.array([0xD7FF, 0xE000, 0xFFFF], dtype=np.uint16).tobytes(),
]
UTF16_BAD_CASES = [
    np.array([0xD800], dtype=np.uint16).tobytes(),
    np.array([0xDC00], dtype=np.uint16).tobytes(),
    np.array([0x41, 0xD800, 0x42], dtype=np.uint16).tobytes(),
    np.array([0xD800, 0xD800, 0xDC00], dtype=np.uint16).tobytes(),
    np.array([0xD800, 0xDC00, 0xDC00], dtype=np.uint16).tobytes(),
    np.array([0xDC00, 0xD800], dtype=np.uint16).tobytes(),
    ("x" * 100).encode("utf-16-le") + np.array([0xD800], dtype=np.uint16).tobytes(),
]
for s in range(20):
    UTF16_CASES.append(helpers.random_utf16(s, 157, 3, 1))
    raw = bytearray(helpers.random_utf16(s + 500, 157, 2, 2))
    raw[(s * 7) % (len(raw) // 2) * 2 + 1] = 0xDC if s % 2 else 0xD8
    UTF16_BAD_CASES.append(bytes(raw))

ALL_UTF16 = UTF16_CASES + UTF16_BAD_CASES


def _be(data: bytes) -> bytes:
    return np.frombuffer(data, dtype=np.uint16).byteswap().tobytes()


@pytest.mark.parametrize("data", ALL_UTF16, ids=_ids(ALL_UTF16))
def test_utf16_validate(impl_name, data):
    expect = oracle.validate_utf16_with_errors(data, False)
    assert su.validate_utf16le(data) == expect.is_ok
    assert su.validate_utf16le_with_errors(data) == expect
    be = _be(data)
    expect_be = oracle.validate_utf16_with_errors(be, True)
    assert expect_be == expect  # same logical content
    assert su.validate_utf16be(be) == expect_be.is_ok
    assert su.validate_utf16be_with_errors(be) == expect_be


@pytest.mark.parametrize("data", ALL_UTF16, ids=_ids(ALL_UTF16))
def test_utf16_counts_lengths(impl_name, data):
    assert su.count_utf16le(data) == oracle.count_utf16(data, False)
    assert su.utf8_length_from_utf16le(data) == oracle.utf8_length_from_utf16(data, False)
    assert su.utf32_length_from_utf16le(data) == oracle.utf32_length_from_utf16(data, False)
    be = _be(data)
    assert su.count_utf16be(be) == oracle.count_utf16(be, True)
    assert su.utf8_length_from_utf16be(be) == oracle.utf8_length_from_utf16(be, True)


@pytest.mark.parametrize("data", ALL_UTF16, ids=_ids(ALL_UTF16))
def test_utf16_to_utf8(transcode_impl, data):
    expect_res, expect_out = oracle.convert_utf16_to_utf8_with_errors(data, False)
    got_res, got_out = su.convert_utf16le_to_utf8_with_errors(data)
    assert got_res == expect_res
    assert got_out == expect_out
    be = _be(data)
    got_res, got_out = su.convert_utf16be_to_utf8_with_errors(be)
    assert got_res == expect_res
    assert got_out == expect_out


@pytest.mark.parametrize("data", ALL_UTF16, ids=_ids(ALL_UTF16))
def test_utf16_to_utf32(transcode_impl, data):
    expect_res, expect_out = oracle.convert_utf16_to_utf32_with_errors(data, False)
    got_res, got_out = su.convert_utf16le_to_utf32_with_errors(data)
    assert got_res == expect_res
    assert got_out == expect_out


@pytest.mark.parametrize("data", ALL_UTF16, ids=_ids(ALL_UTF16))
def test_utf16_to_latin1(impl_name, data):
    expect_res, expect_out = oracle.convert_utf16_to_latin1_with_errors(data, False)
    got_res, got_out = su.convert_utf16le_to_latin1_with_errors(data)
    assert got_res == expect_res
    assert got_out == expect_out


@pytest.mark.parametrize("data", ALL_UTF16, ids=_ids(ALL_UTF16))
def test_utf16_utilities(impl_name, data):
    assert su.change_endianness_utf16(data) == oracle.change_endianness_utf16(data)
    assert su.to_well_formed_utf16le(data) == oracle.to_well_formed_utf16(data, False)
    be = _be(data)
    assert su.to_well_formed_utf16be(be) == oracle.to_well_formed_utf16(be, True)
    assert su.trim_partial_utf16le(data) == oracle.trim_partial_utf16(data, False)
    # well-formed output must validate
    assert oracle.validate_utf16(su.to_well_formed_utf16le(data), False)


# --- UTF-32 -----------------------------------------------------------------

UTF32_CASES = [
    b"",
    "hello 🙂 world".encode("utf-32-le"),
    np.array([0x10FFFF, 0xD7FF, 0xE000], dtype=np.uint32).tobytes(),
]
UTF32_BAD_CASES = [
    np.array([0x110000], dtype=np.uint32).tobytes(),
    np.array([0xD800], dtype=np.uint32).tobytes(),
    np.array([0x41, 0xDFFF, 0x42], dtype=np.uint32).tobytes(),
    np.array([0x41, 0xFFFFFFFF], dtype=np.uint32).tobytes(),
]
for s in range(10):
    UTF32_CASES.append(helpers.random_utf32(s, 211))

ALL_UTF32 = UTF32_CASES + UTF32_BAD_CASES


@pytest.mark.parametrize("data", ALL_UTF32, ids=_ids(ALL_UTF32))
def test_utf32(transcode_impl, data):
    expect = oracle.validate_utf32_with_errors(data)
    assert su.validate_utf32(data) == expect.is_ok
    assert su.validate_utf32_with_errors(data) == expect
    assert su.utf8_length_from_utf32(data) == oracle.utf8_length_from_utf32(data)
    assert su.utf16_length_from_utf32(data) == oracle.utf16_length_from_utf32(data)
    r, o = oracle.convert_utf32_to_utf8_with_errors(data)
    assert su.convert_utf32_to_utf8_with_errors(data) == (r, o)
    r, o = oracle.convert_utf32_to_utf16_with_errors(data, False)
    assert su.convert_utf32_to_utf16le_with_errors(data) == (r, o)
    r, o = oracle.convert_utf32_to_utf16_with_errors(data, True)
    assert su.convert_utf32_to_utf16be_with_errors(data) == (r, o)
    r, o = oracle.convert_utf32_to_latin1_with_errors(data)
    assert su.convert_utf32_to_latin1_with_errors(data) == (r, o)


# --- Latin1 -----------------------------------------------------------------


@pytest.mark.parametrize(
    "data", [b"", b"ascii", bytes(range(256)), helpers.random_bytes(7, 501)]
)
def test_latin1(transcode_impl, data):
    assert su.convert_latin1_to_utf8(data) == oracle.convert_latin1_to_utf8(data)
    assert su.convert_latin1_to_utf16le(data) == oracle.convert_latin1_to_utf16(data, False)
    assert su.convert_latin1_to_utf16be(data) == oracle.convert_latin1_to_utf16(data, True)
    assert su.convert_latin1_to_utf32(data) == oracle.convert_latin1_to_utf32(data)
    assert su.utf8_length_from_latin1(data) == oracle.utf8_length_from_latin1(data)
    # roundtrip
    assert su.convert_utf8_to_latin1(su.convert_latin1_to_utf8(data)) == data


# --- encoding detection -----------------------------------------------------


def test_bom_detection(impl_name):
    assert su.autodetect_encoding(b"\xff\xfeab") == su.encoding_type.UTF16_LE
    assert su.autodetect_encoding(b"\xff\xfe\x00\x00") == su.encoding_type.UTF32_LE
    assert su.autodetect_encoding(b"\xfe\xffab") == su.encoding_type.UTF16_BE
    assert su.autodetect_encoding(b"\x00\x00\xfe\xff") == su.encoding_type.UTF32_BE
    assert su.autodetect_encoding(b"\xef\xbb\xbfa") == su.encoding_type.UTF8
    assert su.autodetect_encoding(b"plain ascii") == su.encoding_type.UTF8
    # invalid in every encoding: utf8 surrogate bytes, odd length
    assert su.autodetect_encoding(b"\xed\xa0\x80") == su.encoding_type.unspecified


def test_detect_encodings(impl_name):
    # pure ASCII of length %4==0 can be utf8 + utf16le + utf32le? ASCII bytes
    # as utf16/utf32 words are valid too (no surrogates, small values).
    mask = su.detect_encodings(b"aaaa")
    assert mask & int(su.encoding_type.UTF8)
    assert mask & int(su.encoding_type.UTF16_LE)
    data = "héllo".encode()
    assert su.detect_encodings(data) & int(su.encoding_type.UTF8)


# --- registry ---------------------------------------------------------------


def test_registry_api():
    impls = su.get_available_implementations()
    assert "fallback" in impls
    cur = su.get_active_implementation()
    assert cur.name in impls
    su.set_active_implementation("fallback")
    assert su.get_active_implementation().name == "fallback"
    with pytest.raises(KeyError):
        su.set_active_implementation("no-such-impl")


def test_encoding_to_string():
    assert su.to_string(su.encoding_type.UTF8) == "UTF8"
    assert su.to_string(su.encoding_type.UTF16_LE) == "UTF16 little-endian"
    assert su.to_string(su.encoding_type.unspecified) == "unknown"
    assert su.bom_byte_size(su.encoding_type.UTF32_BE) == 4
    assert su.bom_byte_size(su.encoding_type.UTF8) == 3


def test_bom_prefixed_autodetect(impl_name):
    # BOM wins over content (implementation.cpp:44-49)
    data = b"\xfe\xff" + "ascii tail".encode()
    assert su.autodetect_encoding(data) == su.encoding_type.UTF16_BE
    # utf8 BOM needs length >= 4 (reference quirk, encoding_types.cpp:42)
    assert su.check_bom(b"\xef\xbb\xbf") == su.encoding_type.unspecified
    assert su.check_bom(b"\xef\xbb\xbfa") == su.encoding_type.UTF8


@pytest.mark.parametrize("data", UTF16_CASES, ids=_ids(UTF16_CASES))
def test_utf16_valid_variants(transcode_impl, data):
    if not oracle.validate_utf16(data, False):
        pytest.skip("needs valid input")
    _, exp8 = oracle.convert_utf16_to_utf8_with_errors(data, False)
    _, exp32 = oracle.convert_utf16_to_utf32_with_errors(data, False)
    assert su.convert_valid_utf16le_to_utf8(data) == exp8
    assert su.convert_valid_utf16le_to_utf32(data) == exp32
    be = _be(data)
    assert su.convert_valid_utf16be_to_utf8(be) == exp8
    assert su.convert_valid_utf16be_to_utf32(be) == exp32


def test_convert_valid_matches_validating_on_valid_input(transcode_impl):
    """Every convert_valid_* must agree with its validating sibling on
    valid input (the reference's valid_ kernels are pure fast paths,
    e.g. generic/utf8_to_utf16/valid_utf8_to_utf16.h)."""
    import helpers

    u8_latin = "héllo wörld ÿñ æøå".encode()  # Latin1-representable
    u8_full = helpers.random_utf8(3, 600, 3, 2, 2, 1)
    u16 = helpers.random_utf16(4, 500, 3, 1)
    u16_latin = "héllo ÿ".encode("utf-16-le")
    u32 = helpers.random_utf32(5, 400, 0.25)
    u32_latin = "héllo ÿ".encode("utf-32-le")

    assert su.convert_valid_utf8_to_latin1(u8_latin) == (
        su.convert_utf8_to_latin1(u8_latin))
    assert su.convert_valid_utf8_to_utf16le(u8_full) == (
        su.convert_utf8_to_utf16le(u8_full))
    assert su.convert_valid_utf16le_to_latin1(u16_latin) == (
        su.convert_utf16le_to_latin1(u16_latin))
    assert su.convert_valid_utf16be_to_latin1(
        su.change_endianness_utf16(u16_latin)) == (
        su.convert_utf16le_to_latin1(u16_latin))
    assert su.convert_valid_utf32_to_utf8(u32) == su.convert_utf32_to_utf8(u32)
    assert su.convert_valid_utf32_to_utf16le(u32) == (
        su.convert_utf32_to_utf16le(u32))
    assert su.convert_valid_utf32_to_utf16be(u32) == (
        su.convert_utf32_to_utf16be(u32))
    assert su.convert_valid_utf32_to_latin1(u32_latin) == (
        su.convert_utf32_to_latin1(u32_latin))
    assert su.convert_valid_utf16le_to_utf8(u16) == (
        su.convert_utf16le_to_utf8(u16))


def test_length_taking_signatures(impl_name):
    """latin1_length_from_utf16/utf32 and utf16/utf32_length_from_latin1
    deliberately take a LENGTH, not data — matching the reference
    signatures (implementation.h: these counts are the identity function
    of the unit count). Guard the deliberate difference from their
    data-taking siblings."""
    assert su.latin1_length_from_utf16(123) == 123
    assert su.latin1_length_from_utf32(77) == 77
    assert su.utf16_length_from_latin1(9) == 9
    assert su.utf32_length_from_latin1(5) == 5
    # data-taking siblings accept buffers, not ints
    data = "abcé".encode()
    assert su.utf8_length_from_latin1(
        "abcé".encode("latin-1")) == len(data)
