"""Replay the reference's curated adversarial vectors on every tier.

Vectors are extracted as *data* by tools/extract_ref_vectors.py from
/root/reference/tests/{validate_utf8_puzzler_tests,special_tests}.cpp —
they encode years of found bugs (fuzzer reproducers, block-boundary
puzzlers). The base64 cases below transcribe the curated tables of
/root/reference/tests/base64_tests.cpp:467-651 (expected results included
in the table — also data).
"""

import base64
import json
import os

import pytest

import simdutf_tpu as su
from simdutf_tpu.errors import error_code as ec

_HERE = os.path.dirname(__file__)
with open(os.path.join(_HERE, "data", "ref_vectors.json")) as f:
    V = json.load(f)

_INVALID = [base64.b64decode(x) for x in V["utf8_invalid"]]
_VALID_RT = [base64.b64decode(x) for x in V["utf8_valid_roundtrip"]]
_UTF16 = [bytes_ for bytes_ in V["utf16_valid_units"]]


@pytest.mark.parametrize("i", range(len(_INVALID)))
def test_ref_invalid_utf8(transcode_impl, i):
    data = _INVALID[i]
    assert not su.validate_utf8(data)
    # reference asserts the non-error converters write 0 units on bad input
    # (special_tests.cpp:296-407)
    assert su.convert_utf8_to_utf16le(data) == b""
    assert su.convert_utf8_to_utf32(data) == b""
    assert su.convert_utf8_to_latin1(data) == b""


def test_ref_puzzler2_exact_error(impl_name):
    case = V["utf8_invalid_with_error"][0]
    data = base64.b64decode(case["data"])
    assert not su.validate_utf8(data)
    r = su.validate_utf8_with_errors(data)
    assert r.error == ec[case["error"]]
    assert r.count == case["pos"]


@pytest.mark.parametrize("i", range(len(_VALID_RT)))
def test_ref_valid_roundtrips(transcode_impl, i):
    src = _VALID_RT[i]
    assert su.validate_utf8(src)
    # utf32 roundtrip (special_cases_utf8_utf32_roundtrip)
    u32 = su.convert_utf8_to_utf32(src)
    assert len(u32) // 4 == su.utf32_length_from_utf8(src)
    assert su.validate_utf32(u32)
    assert su.convert_valid_utf8_to_utf32(src) == u32
    assert su.utf8_length_from_utf32(u32) == len(src)
    assert su.convert_utf32_to_utf8(u32) == src
    assert su.convert_valid_utf32_to_utf8(u32) == src
    # utf16 LE/BE roundtrips
    for conv, valid_conv, val, back, valid_back in (
        (su.convert_utf8_to_utf16le, su.convert_valid_utf8_to_utf16le,
         su.validate_utf16le, su.convert_utf16le_to_utf8,
         su.convert_valid_utf16le_to_utf8),
        (su.convert_utf8_to_utf16be, su.convert_valid_utf8_to_utf16be,
         su.validate_utf16be, su.convert_utf16be_to_utf8,
         su.convert_valid_utf16be_to_utf8),
    ):
        u16 = conv(src)
        assert len(u16) // 2 == su.utf16_length_from_utf8(src)
        assert val(u16)
        assert valid_conv(src) == u16
        assert back(u16) == src
        assert valid_back(u16) == src


@pytest.mark.parametrize("i", range(len(_UTF16)))
def test_ref_utf16_vectors(transcode_impl, i):
    import struct

    units = _UTF16[i]
    data = struct.pack("<%dH" % len(units), *units)
    assert su.validate_utf16le(data)
    u8 = su.convert_utf16le_to_utf8(data)
    # the VS2019/icelake regression: predicted length == written length
    assert len(u8) == su.utf8_length_from_utf16le(data)
    back = su.convert_utf8_to_utf16le(u8)
    assert back == data


# --- curated base64 tables (base64_tests.cpp:467-651, data incl. results) --

_B64_ONE_PADDING = "uuuu             ="  # 4 units, 13 spaces, lone '='


@pytest.mark.parametrize("opts", [su.base64_default, su.base64_url])
def test_ref_b64_one_padding_partial_safe(impl_name, opts):
    # stop_before_partial + capacity>=3: SUCCESS, consumed 4, wrote 3
    for cap in (3, 16, 127):
        r, out = su.base64_to_binary_safe(
            _B64_ONE_PADDING, capacity=cap, options=opts,
            last_chunk_handling=su.stop_before_partial)
        assert r.error == ec.SUCCESS and r.count == 4
        assert len(out) == 3


@pytest.mark.parametrize("opts", [su.base64_default, su.base64_url])
def test_ref_b64_one_padding_matrix(impl_name, opts):
    s = _B64_ONE_PADDING
    # stop_before_partial: SUCCESS, 3 bytes written
    r, out = su.base64_to_binary_details(
        s, options=opts, last_chunk_handling=su.stop_before_partial)
    assert r.error == ec.SUCCESS and len(out) == 3
    # loose: INVALID_BASE64_CHARACTER at 17 (the lone '=')
    r, out = su.base64_to_binary_details(
        s, options=opts, last_chunk_handling=su.loose)
    assert r.error == ec.INVALID_BASE64_CHARACTER and r.input_count == 17
    # strict: BASE64_INPUT_REMAINDER, 3 bytes decoded
    r, out = su.base64_to_binary_details(
        s, options=opts, last_chunk_handling=su.strict)
    assert r.error == ec.BASE64_INPUT_REMAINDER and len(out) == 3


def test_ref_b64_partial_cases(impl_name):
    cases = [
        ("ZXhhZg", ec.SUCCESS, 4),
        ("ZXhhZg" + " " * 66, ec.SUCCESS, 4),
        (" " * 64 + "ZXhhZg", ec.SUCCESS, 68),
    ]
    for s, err, count in cases:
        r, out = su.base64_to_binary_safe(
            s, capacity=3, last_chunk_handling=su.stop_before_partial)
        assert r.error == err and r.count == count


def test_ref_b64_strict_cases(impl_name):
    cases = [
        ("ZXhhZg==", ec.SUCCESS),
        ("YWE=", ec.SUCCESS),
        ("YWF=", ec.BASE64_EXTRA_BITS),
        ("ZXhhZh==", ec.BASE64_EXTRA_BITS),
        ("ZXhhZg", ec.BASE64_INPUT_REMAINDER),
        ("ZXhhZh", ec.BASE64_INPUT_REMAINDER),
        ("Z   X  h  h   Z h =   =", ec.BASE64_EXTRA_BITS),
        ("ZX  h  hZg", ec.BASE64_INPUT_REMAINDER),
        ("ZXh  hZ  h", ec.BASE64_INPUT_REMAINDER),
    ]
    for s, err in cases:
        r, _ = su.base64_to_binary_details(s, last_chunk_handling=su.strict)
        assert r.error == err, s
        rs, _ = su.base64_to_binary_safe(
            s, capacity=1024, last_chunk_handling=su.strict)
        assert rs.error == err, s


def test_ref_b64_strict_cases_length(impl_name):
    s = "d" * 128 + "zzz="
    r, _ = su.base64_to_binary_details(s, last_chunk_handling=su.strict)
    assert r.error == ec.BASE64_EXTRA_BITS and r.input_count == 131
    rs, _ = su.base64_to_binary_safe(
        s, capacity=1024, last_chunk_handling=su.strict)
    assert rs.error == ec.BASE64_EXTRA_BITS and rs.count == 131


def test_ref_b64_webkit_290829(impl_name):
    # https://bugs.webkit.org/show_bug.cgi?id=290829 (base64_tests.cpp:653)
    s = "MjYyZg==="
    for chunk in (su.strict, su.loose, su.stop_before_partial):
        r, _ = su.base64_to_binary_details(s, last_chunk_handling=chunk)
        assert r.error == ec.INVALID_BASE64_CHARACTER


def test_ref_b64_stop_before_partial_one_char(impl_name):
    # 5462 spaces then one valid base64 char (base64_tests.cpp:15-45)
    s = " " * 5462 + "8"
    r, out0 = su.base64_to_binary_details(
        s, last_chunk_handling=su.stop_before_partial)
    assert r.error == ec.SUCCESS and len(out0) == 0
    r2, out = su.base64_to_binary_safe(
        s, capacity=0, last_chunk_handling=su.stop_before_partial)
    assert r2.error == ec.SUCCESS and len(out) == 0 and r2.count == 5462
