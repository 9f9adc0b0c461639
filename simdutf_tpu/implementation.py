"""Implementation interface + the NumPy fallback tier.

Mirrors the reference's ``simdutf::implementation`` abstract class
(include/simdutf/implementation.h:3302-5066): one object exposing the whole
method surface, so a single conformance suite can run against every
registered tier (fallback / cnative / xla), exactly like the reference's
per-implementation test loop (tests/helpers/test.cpp).

Array conventions at this layer:
  * UTF-8 / Latin1 / base64-chars: ``np.uint8[n]``
  * UTF-16: ``np.uint16[n]`` holding raw (unswapped) storage; the ``le``/
    ``be`` entry points interpret them
  * UTF-32: ``np.uint32[n]`` (little-endian storage, as in the reference)
Outputs are NumPy arrays of the destination unit type.
"""

from __future__ import annotations

import numpy as np

from .errors import Result, FullResult, error_code as ec
from .encodings import encoding_type, check_bom
from .golden import utf8 as g8, utf16 as g16, utf32 as g32, latin1 as gl1
from .golden import base64_impl as gb64


class Implementation:
    """Base class: every method delegates to the NumPy golden tier.

    Subclasses (XLA, cnative) override the hot entry points and inherit the
    rest, mirroring how reference backends inherit scalar fallbacks.
    """

    name = "fallback"
    description = "Vectorized NumPy implementation (host CPU)"

    def __init__(self):
        # virtualized hosts fault fresh pages extremely slowly; see runtime.py
        from .runtime import tune_host_allocator

        tune_host_allocator()

    def supported_by_runtime_system(self) -> bool:
        return True

    def preferred_by_runtime(self) -> bool:
        """Whether best-pick auto-selection may choose this tier."""
        return True

    def internal_tests(self) -> list:
        """Developer tests of private helpers, exposed through the public
        registry like the reference's ``implementation::internal_tests()``
        (implementation.h:5019-5037; only its ppc64 backend registers any).
        Returns [(name, zero-arg callable that raises on failure), ...]."""
        return []

    # -- ASCII ---------------------------------------------------------------
    def validate_ascii(self, b: np.ndarray) -> bool:
        return not bool((b & 0x80).any())

    def validate_ascii_with_errors(self, b: np.ndarray) -> Result:
        bad = b >= 0x80
        if bad.any():
            return Result(ec.TOO_LARGE, int(np.argmax(bad)))
        return Result(ec.SUCCESS, int(b.shape[0]))

    # -- UTF-8 validation ----------------------------------------------------
    def validate_utf8(self, b: np.ndarray) -> bool:
        return g8.validate(b)

    def validate_utf8_with_errors(self, b: np.ndarray) -> Result:
        return g8.validate_with_errors(b)

    # -- UTF-16 validation ---------------------------------------------------
    def validate_utf16le(self, w: np.ndarray) -> bool:
        return g16.validate(w, big_endian=False)

    def validate_utf16be(self, w: np.ndarray) -> bool:
        return g16.validate(w, big_endian=True)

    def validate_utf16le_with_errors(self, w: np.ndarray) -> Result:
        return g16.validate_with_errors(w, big_endian=False)

    def validate_utf16be_with_errors(self, w: np.ndarray) -> Result:
        return g16.validate_with_errors(w, big_endian=True)

    # -- UTF-32 validation ---------------------------------------------------
    def validate_utf32(self, w: np.ndarray) -> bool:
        return g32.validate(w)

    def validate_utf32_with_errors(self, w: np.ndarray) -> Result:
        return g32.validate_with_errors(w)

    # -- counting ------------------------------------------------------------
    def count_utf8(self, b: np.ndarray) -> int:
        return g8.count_code_points(b)

    def count_utf16le(self, w: np.ndarray) -> int:
        return g16.count_code_points(w, big_endian=False)

    def count_utf16be(self, w: np.ndarray) -> int:
        return g16.count_code_points(w, big_endian=True)

    # -- lengths -------------------------------------------------------------
    def utf16_length_from_utf8(self, b: np.ndarray) -> int:
        return g8.utf16_length(b)

    def utf32_length_from_utf8(self, b: np.ndarray) -> int:
        return g8.utf32_length(b)

    def latin1_length_from_utf8(self, b: np.ndarray) -> int:
        return g8.latin1_length(b)

    def utf8_length_from_utf16le(self, w: np.ndarray) -> int:
        return g16.utf8_length(w, big_endian=False)

    def utf8_length_from_utf16be(self, w: np.ndarray) -> int:
        return g16.utf8_length(w, big_endian=True)

    def utf32_length_from_utf16le(self, w: np.ndarray) -> int:
        return g16.utf32_length(w, big_endian=False)

    def utf32_length_from_utf16be(self, w: np.ndarray) -> int:
        return g16.utf32_length(w, big_endian=True)

    def latin1_length_from_utf16(self, length: int) -> int:
        return length

    def utf8_length_from_utf32(self, w: np.ndarray) -> int:
        return g32.utf8_length(w)

    def utf16_length_from_utf32(self, w: np.ndarray) -> int:
        return g32.utf16_length(w)

    def latin1_length_from_utf32(self, length: int) -> int:
        return length

    def utf8_length_from_latin1(self, b: np.ndarray) -> int:
        return gl1.utf8_length(b)

    def utf16_length_from_latin1(self, length: int) -> int:
        return length

    def utf32_length_from_latin1(self, length: int) -> int:
        return length

    # -- UTF-8 -> x ----------------------------------------------------------
    def convert_utf8_to_utf16le_with_errors(self, b):
        return g8.convert_to_utf16_with_errors(b, big_endian=False)

    def convert_utf8_to_utf16be_with_errors(self, b):
        return g8.convert_to_utf16_with_errors(b, big_endian=True)

    def convert_utf8_to_utf32_with_errors(self, b):
        return g8.convert_to_utf32_with_errors(b)

    def convert_utf8_to_latin1_with_errors(self, b):
        return g8.convert_to_latin1_with_errors(b)

    def convert_valid_utf8_to_utf16le(self, b):
        return self.convert_utf8_to_utf16le_with_errors(b)[1]

    def convert_valid_utf8_to_utf16be(self, b):
        return self.convert_utf8_to_utf16be_with_errors(b)[1]

    def convert_valid_utf8_to_utf32(self, b):
        return self.convert_utf8_to_utf32_with_errors(b)[1]

    def convert_valid_utf8_to_latin1(self, b):
        return self.convert_utf8_to_latin1_with_errors(b)[1]

    # -- UTF-16 -> x ---------------------------------------------------------
    def convert_utf16le_to_utf8_with_errors(self, w):
        return g16.convert_to_utf8_with_errors(w, big_endian=False)

    def convert_utf16be_to_utf8_with_errors(self, w):
        return g16.convert_to_utf8_with_errors(w, big_endian=True)

    def convert_utf16le_to_utf32_with_errors(self, w):
        return g16.convert_to_utf32_with_errors(w, big_endian=False)

    def convert_utf16be_to_utf32_with_errors(self, w):
        return g16.convert_to_utf32_with_errors(w, big_endian=True)

    def convert_utf16le_to_latin1_with_errors(self, w):
        return g16.convert_to_latin1_with_errors(w, big_endian=False)

    def convert_utf16be_to_latin1_with_errors(self, w):
        return g16.convert_to_latin1_with_errors(w, big_endian=True)

    def convert_valid_utf16le_to_utf8(self, w):
        return self.convert_utf16le_to_utf8_with_errors(w)[1]

    def convert_valid_utf16be_to_utf8(self, w):
        return self.convert_utf16be_to_utf8_with_errors(w)[1]

    def convert_valid_utf16le_to_utf32(self, w):
        return self.convert_utf16le_to_utf32_with_errors(w)[1]

    def convert_valid_utf16be_to_utf32(self, w):
        return self.convert_utf16be_to_utf32_with_errors(w)[1]

    def convert_valid_utf16le_to_latin1(self, w):
        return self.convert_utf16le_to_latin1_with_errors(w)[1]

    def convert_valid_utf16be_to_latin1(self, w):
        return self.convert_utf16be_to_latin1_with_errors(w)[1]

    # -- UTF-32 -> x ---------------------------------------------------------
    def convert_utf32_to_utf8_with_errors(self, w):
        return g32.convert_to_utf8_with_errors(w)

    def convert_utf32_to_utf16le_with_errors(self, w):
        return g32.convert_to_utf16_with_errors(w, big_endian=False)

    def convert_utf32_to_utf16be_with_errors(self, w):
        return g32.convert_to_utf16_with_errors(w, big_endian=True)

    def convert_utf32_to_latin1_with_errors(self, w):
        return g32.convert_to_latin1_with_errors(w)

    def convert_valid_utf32_to_utf8(self, w):
        return self.convert_utf32_to_utf8_with_errors(w)[1]

    def convert_valid_utf32_to_utf16le(self, w):
        return self.convert_utf32_to_utf16le_with_errors(w)[1]

    def convert_valid_utf32_to_utf16be(self, w):
        return self.convert_utf32_to_utf16be_with_errors(w)[1]

    def convert_valid_utf32_to_latin1(self, w):
        return self.convert_utf32_to_latin1_with_errors(w)[1]

    # -- Latin1 -> x (always valid) ------------------------------------------
    def convert_latin1_to_utf8(self, b):
        return gl1.convert_to_utf8(b)

    def convert_latin1_to_utf16le(self, b):
        return gl1.convert_to_utf16(b, big_endian=False)

    def convert_latin1_to_utf16be(self, b):
        return gl1.convert_to_utf16(b, big_endian=True)

    def convert_latin1_to_utf32(self, b):
        return gl1.convert_to_utf32(b)

    # -- UTF-16 utilities ----------------------------------------------------
    def change_endianness_utf16(self, w):
        return g16.change_endianness(w)

    def to_well_formed_utf16le(self, w):
        return g16.to_well_formed(w, big_endian=False)

    def to_well_formed_utf16be(self, w):
        return g16.to_well_formed(w, big_endian=True)

    def trim_partial_utf8(self, b) -> int:
        return g8.trim_partial(b)

    def trim_partial_utf16le(self, w) -> int:
        return g16.trim_partial(w, big_endian=False)

    def trim_partial_utf16be(self, w) -> int:
        return g16.trim_partial(w, big_endian=True)

    # -- encoding detection --------------------------------------------------
    def autodetect_encoding(self, b: np.ndarray) -> encoding_type:
        # src/implementation.cpp:44-76
        bom = check_bom(b[:4].tobytes())
        if bom != encoding_type.unspecified:
            return bom
        n = int(b.shape[0])
        if self.validate_utf8(b):
            return encoding_type.UTF8
        if n % 2 == 0 and self.validate_utf16le(b.view(np.uint16)):
            return encoding_type.UTF16_LE
        if n % 4 == 0 and self.validate_utf32(b.view(np.uint32)):
            return encoding_type.UTF32_LE
        return encoding_type.unspecified

    def detect_encodings(self, b: np.ndarray) -> int:
        # src/fallback/implementation.cpp:6-30
        bom = check_bom(b[:4].tobytes())
        if bom != encoding_type.unspecified:
            return int(bom)
        out = 0
        n = int(b.shape[0])
        if self.validate_utf8(b):
            out |= int(encoding_type.UTF8)
        if n % 2 == 0 and self.validate_utf16le(b.view(np.uint16)):
            out |= int(encoding_type.UTF16_LE)
        if n % 4 == 0 and self.validate_utf32(b.view(np.uint32)):
            out |= int(encoding_type.UTF32_LE)
        return out

    # -- base64 --------------------------------------------------------------
    def maximal_binary_length_from_base64(self, src) -> int:
        return gb64.maximal_binary_length(src)

    def base64_length_from_binary(self, length: int, options: int = 0) -> int:
        return gb64.base64_length_from_binary(length, options)

    def base64_to_binary_details(
        self, src, options: int = 0, last_chunk: int = gb64.LOOSE
    ) -> tuple[FullResult, np.ndarray]:
        return gb64.decode(src, options, last_chunk)

    def binary_to_base64(self, src, options: int = 0) -> np.ndarray:
        return gb64.encode(src, options)

    def base64_to_binary_safe(
        self,
        src,
        capacity: int,
        options: int = 0,
        last_chunk: int = gb64.LOOSE,
        decode_up_to_bad_char: bool = False,
    ):
        """Capacity-limited decode (implementation.h:3090-3208 contract).
        Returns (Result, out) with len(out) <= capacity."""
        return gb64.decode_safe(
            src,
            capacity,
            options,
            last_chunk,
            decode_up_to_bad_char,
            details_fn=self.base64_to_binary_details,
        )


class FallbackImplementation(Implementation):
    """Explicit name for the base tier."""
