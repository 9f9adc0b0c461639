"""BE/LE symmetry — the reference's bele_tests.cpp idea: every UTF-16LE
function and its UTF-16BE sibling must agree through a byteswap, for valid
AND invalid inputs (same results, same error positions), on every tier.
"""

import numpy as np
import pytest

import simdutf_tpu as su

import helpers


def swap16(data: bytes) -> bytes:
    return np.frombuffer(data, np.uint16).byteswap().tobytes()


CASES = [
    helpers.random_utf16(1, 300, p_bmp=0.8, p_astral=0.2),
    helpers.random_utf16(2, 1, p_bmp=1),
    b"",
    "plain ascii text".encode("utf-16-le"),
    # ill-formed: lone high surrogate, lone low surrogate, truncated pair
    b"a\x00\x00\xd8b\x00",
    b"\x00\xdcx\x00",
    "ok🙂".encode("utf-16-le")[:-2],
    helpers.random_bytes(3, 400),  # arbitrary junk (even length)
]


@pytest.mark.parametrize("le", CASES, ids=range(len(CASES)))
def test_validate_symmetry(impl_name, le):
    be = swap16(le)
    assert su.validate_utf16be(be) == su.validate_utf16le(le)
    assert su.validate_utf16be_with_errors(be) == \
        su.validate_utf16le_with_errors(le)


@pytest.mark.parametrize("le", CASES, ids=range(len(CASES)))
def test_counts_symmetry(impl_name, le):
    be = swap16(le)
    if su.validate_utf16le(le):
        assert su.count_utf16be(be) == su.count_utf16le(le)
        assert su.utf8_length_from_utf16be(be) == \
            su.utf8_length_from_utf16le(le)
        assert su.utf32_length_from_utf16be(be) == \
            su.utf32_length_from_utf16le(le)


@pytest.mark.parametrize("le", CASES, ids=range(len(CASES)))
def test_convert_from_utf16_symmetry(transcode_impl, le):
    be = swap16(le)
    for fn_le, fn_be in [
        (su.convert_utf16le_to_utf8_with_errors,
         su.convert_utf16be_to_utf8_with_errors),
        (su.convert_utf16le_to_utf32_with_errors,
         su.convert_utf16be_to_utf32_with_errors),
        (su.convert_utf16le_to_latin1_with_errors,
         su.convert_utf16be_to_latin1_with_errors),
    ]:
        res_le, out_le = fn_le(le)
        res_be, out_be = fn_be(be)
        assert res_le == res_be, (fn_le.__name__, res_le, res_be)
        assert out_le == out_be


@pytest.mark.parametrize("seed", [11, 12])
def test_convert_into_utf16_symmetry(transcode_impl, seed):
    data = helpers.random_utf8(seed, 200, p1=0.4, p2=0.2, p3=0.2, p4=0.2)
    assert swap16(su.convert_utf8_to_utf16le(data)) == \
        su.convert_utf8_to_utf16be(data)
    u32 = helpers.random_utf32(seed, 150)
    assert swap16(su.convert_utf32_to_utf16le(u32)) == \
        su.convert_utf32_to_utf16be(u32)
    lat = bytes(range(256))
    assert swap16(su.convert_latin1_to_utf16le(lat)) == \
        su.convert_latin1_to_utf16be(lat)


@pytest.mark.parametrize("le", CASES, ids=range(len(CASES)))
def test_change_endianness_involution(impl_name, le):
    assert su.change_endianness_utf16(le) == swap16(le)
    assert su.change_endianness_utf16(su.change_endianness_utf16(le)) == le


@pytest.mark.parametrize("le", CASES, ids=range(len(CASES)))
def test_to_well_formed_symmetry(impl_name, le):
    be = swap16(le)
    assert swap16(su.to_well_formed_utf16le(le)) == su.to_well_formed_utf16be(be)
