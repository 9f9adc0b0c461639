"""Bucket and padding matrix, UTF-8 and Latin1 sources (see
tests/bucket_matrix.py)."""

import pytest

from bucket_matrix import (LENGTHS_U8, case_ids, cases, check, latin1_input,
                           utf8_input)

VALIDATING = [
    "validate_utf8_with_errors",
    "validate_ascii_with_errors",
    "count_utf8",
    "utf16_length_from_utf8",
    "convert_utf8_to_utf16le_with_errors",
    "convert_utf8_to_utf16be_with_errors",
    "convert_utf8_to_utf32_with_errors",
    "convert_utf8_to_latin1_with_errors",
]
VALID_ONLY = [
    "convert_valid_utf8_to_utf16le",
    "convert_valid_utf8_to_utf16be",
    "convert_valid_utf8_to_utf32",
    "convert_valid_utf8_to_latin1",
]
FROM_LATIN1 = [
    "utf8_length_from_latin1",
    "convert_latin1_to_utf8",
    "convert_latin1_to_utf16le",
    "convert_latin1_to_utf16be",
    "convert_latin1_to_utf32",
]
CASES = cases(LENGTHS_U8)


@pytest.mark.parametrize("n,bad", CASES, ids=case_ids(CASES))
@pytest.mark.parametrize("method", VALIDATING)
def test_utf8_source(method, n, bad):
    check(method, utf8_input(n, bad, latin1="latin1" in method))


@pytest.mark.parametrize("n", LENGTHS_U8)
@pytest.mark.parametrize("method", VALID_ONLY)
def test_utf8_source_valid(method, n):
    check(method, utf8_input(n, False, latin1="latin1" in method))


@pytest.mark.parametrize("n", LENGTHS_U8)
@pytest.mark.parametrize("method", FROM_LATIN1)
def test_latin1_source(method, n):
    check(method, latin1_input(n))
