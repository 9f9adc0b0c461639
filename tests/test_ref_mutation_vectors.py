"""Replay the brute-force mutation corpora on every tier and on the
device tier's general engine.

The vectors freeze the reference's corrupt/brute-force methodology
(/root/reference/tests/validate_utf8_brute_force_tests.cpp: random valid
strings per byte-length class with one corrupted position) as data, each
carrying a dual-oracle expectation computed at extraction time (golden
scalar machine == CPython decoder, asserted by
tools/extract_ref_vectors.py). Here they replay:

 - per implementation tier (impl_name fixture, the reference's
   per-implementation loop — tests/helpers/test.cpp:106), and
 - through the general classify -> scan -> scatter engine with census
   routing off, behind a valid prefix.
"""

import base64
import json
import os

import numpy as np
import pytest

import simdutf_tpu as su
from simdutf_tpu.errors import error_code as ec

_HERE = os.path.dirname(__file__)
with open(os.path.join(_HERE, "data", "ref_vectors.json")) as f:
    _V = json.load(f)

_U8 = [dict(v, raw=base64.b64decode(v["data"])) for v in _V["utf8_mutation"]]
_U16 = [dict(v, raw=base64.b64decode(v["data"]))
        for v in _V["utf16_mutation"]]

_CHUNK = 32


def _chunks(vs):
    return [vs[i : i + _CHUNK] for i in range(0, len(vs), _CHUNK)]


@pytest.mark.parametrize("ci", range(len(_chunks(_U8))))
def test_utf8_mutation_per_tier(transcode_impl, ci):
    for v in _chunks(_U8)[ci]:
        data = v["raw"]
        assert su.validate_utf8(data) == v["valid"], v["data"]
        r = su.validate_utf8_with_errors(data)
        if v["valid"]:
            assert r.error == ec.SUCCESS and r.count == len(data)
            # valid mutants must roundtrip through utf16
            u16 = su.convert_utf8_to_utf16le(data)
            assert su.convert_utf16le_to_utf8(u16) == data
        else:
            assert r.error == ec[v["code"]], v["data"]
            assert r.count == v["pos"], v["data"]
            # non-error converters write nothing on invalid input
            assert su.convert_utf8_to_utf16le(data) == b""
            # with-errors converter reports the same first error
            rr = su.convert_utf8_to_utf16le_with_errors(data)
            assert rr[0].error == ec[v["code"]] and rr[0].count == v["pos"]


@pytest.mark.parametrize("ci", range(len(_chunks(_U16))))
def test_utf16_mutation_per_tier(transcode_impl, ci):
    for v in _chunks(_U16)[ci]:
        data = v["raw"]
        assert su.validate_utf16le(data) == v["valid"], v["data"]
        r = su.validate_utf16le_with_errors(data)
        if v["valid"]:
            assert r.error == ec.SUCCESS and r.count == len(data) // 2
            u8 = su.convert_utf16le_to_utf8(data)
            assert su.convert_utf8_to_utf16le(u8) == data
        else:
            assert r.error == ec[v["code"]], v["data"]
            assert r.count == v["pos"], v["data"]
            assert su.convert_utf16le_to_utf8(data) == b""


# --- the general engine alone, behind a valid mixed prefix -----------------

_GENERAL = {}


def _general():
    from simdutf_tpu.ops.impl import XLAImplementation

    if not _GENERAL:
        _GENERAL["xla"] = XLAImplementation(routing=False)
    return _GENERAL["xla"]


@pytest.mark.parametrize("stride_off", range(6))
def test_utf8_mutation_general_engine(stride_off):
    """Every 6th vector through the classify -> scan -> scatter
    utf8->utf16 engine: exact (code, pos, prefix-units, bytes) parity with
    the golden machine, at offset 0 and embedded behind a valid mixed
    prefix so carries across words are exercised."""
    from simdutf_tpu.golden import utf8 as g8

    prefix = ("mixed é 東 \U0001f642 ".encode() * 40)
    prefix = prefix[: su.trim_partial_utf8(prefix)]
    for v in _U8[stride_off::6]:
        for lead in (b"", prefix):
            arr = np.frombuffer(lead + v["raw"], np.uint8)
            res, out = _general().convert_utf8_to_utf16le_with_errors(arr)
            want_res, want = g8.convert_to_utf16_with_errors(arr, False)
            if v["valid"] and not lead:
                assert res.is_ok
            assert res == want_res, (v["data"], len(lead))
            assert np.array_equal(out, want), (v["data"], len(lead))


@pytest.mark.parametrize("stride_off", range(3))
def test_utf16_mutation_general_engine(stride_off):
    """UTF-16 mutants through the general utf16->utf8 engine: exact
    (code, pos) parity with the stored expectation on invalid input, and
    byte-for-byte output parity on valid mutants."""
    for v in _U16[stride_off::3]:
        units = np.frombuffer(v["raw"], np.uint16)
        res, out = _general().convert_utf16le_to_utf8_with_errors(units)
        if not v["valid"]:
            assert not res.is_ok, v["data"]
            assert res.count == v["pos"], v["data"]
            assert int(res.error) == int(ec[v["code"]]), v["data"]
            continue
        assert res.is_ok, v["data"]
        assert out.tobytes() == v["raw"].decode("utf-16-le").encode("utf-8")
