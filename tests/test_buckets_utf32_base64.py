"""Bucket and padding matrix, UTF-32 sources and base64 (see
tests/bucket_matrix.py)."""

import pytest

import simdutf_tpu as su
from bucket_matrix import (LENGTHS_B64, LENGTHS_U32, base64_input, case_ids,
                           cases, check, latin1_input, utf32_input)

VALIDATING = [
    "validate_utf32_with_errors",
    "utf8_length_from_utf32",
    "utf16_length_from_utf32",
    "convert_utf32_to_utf8_with_errors",
    "convert_utf32_to_utf16le_with_errors",
    "convert_utf32_to_utf16be_with_errors",
    "convert_utf32_to_latin1_with_errors",
]
VALID_ONLY = [
    "convert_valid_utf32_to_utf8",
    "convert_valid_utf32_to_utf16le",
    "convert_valid_utf32_to_utf16be",
    "convert_valid_utf32_to_latin1",
]
CASES = cases(LENGTHS_U32)
B64_CASES = cases(LENGTHS_B64)


@pytest.mark.parametrize("n,bad", CASES, ids=case_ids(CASES))
@pytest.mark.parametrize("method", VALIDATING)
def test_utf32_source(method, n, bad):
    check(method, utf32_input(n, bad, latin1="latin1" in method))


@pytest.mark.parametrize("n", LENGTHS_U32)
@pytest.mark.parametrize("method", VALID_ONLY)
def test_utf32_source_valid(method, n):
    check(method, utf32_input(n, False, latin1="latin1" in method))


@pytest.mark.parametrize("n", LENGTHS_B64)
@pytest.mark.parametrize("url", [False, True], ids=["default", "url"])
def test_base64_encode(url, n):
    check("binary_to_base64", latin1_input(n),
          su.base64_url if url else su.base64_default)


@pytest.mark.parametrize("n,bad", B64_CASES, ids=case_ids(B64_CASES))
@pytest.mark.parametrize("url", [False, True], ids=["default", "url"])
def test_base64_decode(url, n, bad):
    check("base64_to_binary_details", base64_input(n, bad, url),
          su.base64_url if url else su.base64_default)
