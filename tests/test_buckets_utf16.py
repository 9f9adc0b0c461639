"""Bucket and padding matrix, UTF-16 sources (see tests/bucket_matrix.py)."""

import pytest

from bucket_matrix import LENGTHS, case_ids, cases, check, utf16_input

VALIDATING = [
    "validate_utf16{e}_with_errors",
    "count_utf16{e}",
    "utf8_length_from_utf16{e}",
    "convert_utf16{e}_to_utf8_with_errors",
    "convert_utf16{e}_to_utf32_with_errors",
    "convert_utf16{e}_to_latin1_with_errors",
]
VALID_ONLY = [
    "convert_valid_utf16{e}_to_utf8",
    "convert_valid_utf16{e}_to_utf32",
    "convert_valid_utf16{e}_to_latin1",
]
CASES = cases(LENGTHS)


def _input(method, n, bad, endian):
    return utf16_input(n, bad, endian == "be", latin1="latin1" in method)


@pytest.mark.parametrize("n,bad", CASES, ids=case_ids(CASES))
@pytest.mark.parametrize("endian", ["le", "be"])
@pytest.mark.parametrize("method", VALIDATING)
def test_utf16_source(method, endian, n, bad):
    name = method.format(e=endian)
    check(name, _input(name, n, bad, endian))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("endian", ["le", "be"])
@pytest.mark.parametrize("method", VALID_ONLY)
def test_utf16_source_valid(method, endian, n):
    name = method.format(e=endian)
    check(name, _input(name, n, False, endian))
