"""Exhaustive boundary enumeration — the reference's heavier test genres:
every 2-byte UTF-8 sequence, 3-byte boundary planes, all interesting UTF-16
unit-class pairings (transcode_test_base.h:10-11 all_utf16_combinations),
and curated puzzlers (validate_utf8_puzzler_tests.cpp model)."""

import numpy as np
import pytest

import oracle
import simdutf_tpu as su


def test_all_two_byte_sequences(impl_name):
    """Every (b0, b1) with b0 in 0xC0..0xDF: exact code+position parity."""
    seqs = bytearray()
    for b0 in range(0xC0, 0xE0):
        for b1 in (0x00, 0x7F, 0x80, 0xBF, 0xC0, 0xFF):
            data = bytes([b0, b1])
            assert su.validate_utf8_with_errors(
                data
            ) == oracle.validate_utf8_with_errors(data), data.hex()


def test_three_byte_boundary_planes(impl_name):
    """E0/ED lead bytes across the overlong/surrogate boundaries."""
    for b0 in (0xE0, 0xE1, 0xEC, 0xED, 0xEE, 0xEF):
        for b1 in (0x80, 0x9F, 0xA0, 0xBF, 0x41, 0xC0):
            for b2 in (0x80, 0xBF, 0x41):
                data = bytes([b0, b1, b2])
                assert su.validate_utf8_with_errors(
                    data
                ) == oracle.validate_utf8_with_errors(data), data.hex()


def test_four_byte_boundary_planes(impl_name):
    for b0 in (0xF0, 0xF1, 0xF4, 0xF5, 0xF7):
        for b1 in (0x80, 0x8F, 0x90, 0xBF, 0x41):
            data = bytes([b0, b1, 0x80, 0x80])
            assert su.validate_utf8_with_errors(
                data
            ) == oracle.validate_utf8_with_errors(data), data.hex()


_U16_CLASSES = [0x0000, 0x007F, 0x0080, 0x07FF, 0x0800, 0xD7FF,
                0xD800, 0xDBFF, 0xDC00, 0xDFFF, 0xE000, 0xFFFF]


def test_all_utf16_class_pairs(transcode_impl):
    """Every pairing of unit classes (incl. surrogate halves) in a 3-unit
    window — validation, count, and transcode parity."""
    for a in _U16_CLASSES:
        for b in _U16_CLASSES:
            data = np.array([0x41, a, b, 0x42], dtype=np.uint16).tobytes()
            assert su.validate_utf16le_with_errors(
                data
            ) == oracle.validate_utf16_with_errors(data, False), (hex(a), hex(b))
            r, o = oracle.convert_utf16_to_utf8_with_errors(data, False)
            assert su.convert_utf16le_to_utf8_with_errors(data) == (r, o)
            assert su.count_utf16le(data) == oracle.count_utf16(data, False)


def test_utf32_boundaries(impl_name):
    for w in (0x0, 0x7F, 0x80, 0x7FF, 0x800, 0xD7FF, 0xD800, 0xDFFF, 0xE000,
              0xFFFF, 0x10000, 0x10FFFF, 0x110000, 0xFFFFFFFF):
        data = np.array([0x41, w], dtype=np.uint32).tobytes()
        assert su.validate_utf32_with_errors(
            data
        ) == oracle.validate_utf32_with_errors(data), hex(w)


PUZZLERS = [
    # sequences designed to confuse blockwise validators
    b"\xc2" * 64,                       # wall of leads
    b"\x80" * 64,                       # wall of continuations
    (b"\xe2\x82" * 40) + b"\xac",       # repeated truncations
    b"\xf0\x90\x80\x80" * 16,           # clean astral run
    b"\xf0\x90\x80" + b"\x80" * 5,      # astral + excess continuations
    b"A" * 63 + b"\xf0\x90\x80\x80",    # astral straddling a 64B block
    b"A" * 511 + b"\xe4\xb8\xad",       # 3-byte straddling a 512B row
    b"A" * 4095 + b"\xf0\x9f\x98\x80",  # 4-byte straddling a 4K tile
    b"A" * 32767 + b"\xc3\xa9",         # 2-byte straddling a 32K tile
    b"\xed\x9f\xbf\xed\xa0\x80",        # D7FF then D800
    b"\xef\xbf\xbd" * 100,              # replacement chars
    bytes(range(0x80, 0x100)),          # all high bytes ascending
    bytes(reversed(range(0x80, 0x100))),
]


@pytest.mark.parametrize("i", range(len(PUZZLERS)))
def test_puzzlers(transcode_impl, i):
    data = PUZZLERS[i]
    assert su.validate_utf8_with_errors(
        data
    ) == oracle.validate_utf8_with_errors(data), data[:16].hex()
    r, o = oracle.convert_utf8_to_utf16_with_errors(data, False)
    assert su.convert_utf8_to_utf16le_with_errors(data) == (r, o)


def test_null_safety(impl_name):
    """nullptr-with-size-0 analog (tests/null_safety_tests.cpp:7-29)."""
    for fn in (su.validate_utf8, su.validate_ascii, su.count_utf8,
               su.convert_utf8_to_utf16le, su.convert_utf8_to_utf32,
               su.convert_latin1_to_utf8, su.trim_partial_utf8):
        fn(b"")
    assert su.base64_to_binary(b"")[0].is_ok
    assert su.binary_to_base64(b"") == b""
    assert su.to_well_formed_utf16le(b"") == b""


def test_whole_repertoire_transcode_matrix(transcode_impl):
    """Every Unicode scalar value (all 1,112,064 codepoints) in one buffer:
    the full transcode matrix must agree with CPython's codecs
    byte-for-byte, and counts/lengths must be exact. The reference
    approximates this with all_utf16_combinations windows
    (transcode_test_base.h:10-11); one corpus-sized buffer covers the
    whole repertoire in a handful of device launches."""
    import simdutf_tpu as su

    cps = list(range(0, 0xD800)) + list(range(0xE000, 0x110000))
    s = "".join(map(chr, cps))
    u8 = s.encode()
    u16le = s.encode("utf-16-le")
    u16be = s.encode("utf-16-be")
    u32 = s.encode("utf-32-le")

    assert su.validate_utf8(u8)
    assert su.validate_utf16le(u16le)
    assert su.validate_utf16be(u16be)
    assert su.validate_utf32(u32)

    assert su.count_utf8(u8) == len(cps)
    assert su.count_utf16le(u16le) == len(cps)
    assert su.utf16_length_from_utf8(u8) == len(u16le) // 2
    assert su.utf8_length_from_utf16le(u16le) == len(u8)
    assert su.utf32_length_from_utf8(u8) == len(cps)
    assert su.utf8_length_from_utf32(u32) == len(u8)

    assert su.convert_utf8_to_utf16le(u8) == u16le
    assert su.convert_utf8_to_utf16be(u8) == u16be
    assert su.convert_utf8_to_utf32(u8) == u32
    assert su.convert_utf16le_to_utf8(u16le) == u8
    assert su.convert_utf16be_to_utf8(u16be) == u8
    assert su.convert_utf16le_to_utf32(u16le) == u32
    assert su.convert_utf32_to_utf8(u32) == u8
    assert su.convert_utf32_to_utf16le(u32) == u16le
    assert su.change_endianness_utf16(u16le) == u16be
