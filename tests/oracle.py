"""Pure-Python scalar oracle for conformance testing.

This is the ground-truth model: deliberately simple per-code-point loops that
mirror the reference scalar machines byte for byte, including error codes and
first-error positions (reference: src/scalar/utf8.h:102-199,
src/scalar/utf16.h:39-67, src/scalar/utf8_to_utf16/utf8_to_utf16.h:128-255,
src/scalar/base64.h:33-216, src/generic/base64.h:43-246).

It plays the role of simdutf's ``tests/reference`` naive re-implementation:
production tiers (golden/cnative/xla) are never checked against themselves.
Only used by tests — never imported by the library.
"""

from __future__ import annotations

from simdutf_tpu.errors import (
    Result,
    FullResult,
    error_code as ec,
)

# ---------------------------------------------------------------------------
# helpers


def _u16s(data: bytes, big_endian: bool) -> list[int]:
    """View a byte string as a list of uint16 code units."""
    assert len(data) % 2 == 0
    out = []
    for i in range(0, len(data), 2):
        if big_endian:
            out.append((data[i] << 8) | data[i + 1])
        else:
            out.append(data[i] | (data[i + 1] << 8))
    return out


def _u32s(data: bytes) -> list[int]:
    assert len(data) % 4 == 0
    return [int.from_bytes(data[i : i + 4], "little") for i in range(0, len(data), 4)]


def _pack16(words: list[int], big_endian: bool) -> bytes:
    return b"".join(w.to_bytes(2, "big" if big_endian else "little") for w in words)


def _pack32(words: list[int]) -> bytes:
    return b"".join(w.to_bytes(4, "little") for w in words)


def _is_cont(b: int) -> bool:
    return (b & 0xC0) == 0x80


# ---------------------------------------------------------------------------
# ASCII


def validate_ascii_with_errors(buf: bytes) -> Result:
    for i, b in enumerate(buf):
        if b >= 0x80:
            return Result(ec.TOO_LARGE, i)
    return Result(ec.SUCCESS, len(buf))


def validate_ascii(buf: bytes) -> bool:
    return validate_ascii_with_errors(buf).is_ok


# ---------------------------------------------------------------------------
# UTF-8


def validate_utf8_with_errors(buf: bytes) -> Result:
    n = len(buf)
    pos = 0
    while pos < n:
        byte = buf[pos]
        if byte < 0x80:
            pos += 1
        elif (byte & 0xE0) == 0xC0:
            if pos + 1 >= n or _is_cont(buf[pos + 1]) is False:
                return Result(ec.TOO_SHORT, pos)
            cp = (byte & 0x1F) << 6 | (buf[pos + 1] & 0x3F)
            if cp < 0x80:
                return Result(ec.OVERLONG, pos)
            pos += 2
        elif (byte & 0xF0) == 0xE0:
            if pos + 2 >= n:
                return Result(ec.TOO_SHORT, pos)
            if not _is_cont(buf[pos + 1]) or not _is_cont(buf[pos + 2]):
                return Result(ec.TOO_SHORT, pos)
            cp = (byte & 0x0F) << 12 | (buf[pos + 1] & 0x3F) << 6 | (buf[pos + 2] & 0x3F)
            if cp < 0x800:
                return Result(ec.OVERLONG, pos)
            if 0xD800 <= cp <= 0xDFFF:
                return Result(ec.SURROGATE, pos)
            pos += 3
        elif (byte & 0xF8) == 0xF0:
            if pos + 3 >= n:
                return Result(ec.TOO_SHORT, pos)
            if (
                not _is_cont(buf[pos + 1])
                or not _is_cont(buf[pos + 2])
                or not _is_cont(buf[pos + 3])
            ):
                return Result(ec.TOO_SHORT, pos)
            cp = (
                (byte & 0x07) << 18
                | (buf[pos + 1] & 0x3F) << 12
                | (buf[pos + 2] & 0x3F) << 6
                | (buf[pos + 3] & 0x3F)
            )
            if cp <= 0xFFFF:
                return Result(ec.OVERLONG, pos)
            if cp > 0x10FFFF:
                return Result(ec.TOO_LARGE, pos)
            pos += 4
        elif _is_cont(byte):
            return Result(ec.TOO_LONG, pos)
        else:
            return Result(ec.HEADER_BITS, pos)
    return Result(ec.SUCCESS, n)


def validate_utf8(buf: bytes) -> bool:
    # NOTE: matches validate_with_errors; the bool variant in the reference has
    # identical accept/reject behavior (scalar/utf8.h:11-99).
    return validate_utf8_with_errors(buf).is_ok


def count_utf8(buf: bytes) -> int:
    return sum(1 for b in buf if not _is_cont(b))


def utf16_length_from_utf8(buf: bytes) -> int:
    n = 0
    for b in buf:
        if not _is_cont(b):
            n += 1
        if b >= 0xF0:
            n += 1
    return n


def utf32_length_from_utf8(buf: bytes) -> int:
    return count_utf8(buf)


def latin1_length_from_utf8(buf: bytes) -> int:
    # Valid UTF-8 representing latin1: every codepoint is 1 unit.
    return count_utf8(buf)


def trim_partial_utf8(buf: bytes) -> int:
    length = len(buf)
    if length < 3:
        if length == 2:
            if buf[length - 1] >= 0xC0:
                return length - 1
            if buf[length - 2] >= 0xE0:
                return length - 2
            return length
        if length == 1:
            if buf[length - 1] >= 0xC0:
                return length - 1
            return length
        return 0
    if buf[length - 1] >= 0xC0:
        return length - 1
    if buf[length - 2] >= 0xE0:
        return length - 2
    if buf[length - 3] >= 0xF0:
        return length - 3
    return length


# ---------------------------------------------------------------------------
# UTF-8 -> UTF-16 / UTF-32 / Latin1


def _decode_utf8_seq(buf: bytes, pos: int):
    """Decode one sequence at pos.

    Returns (cp, seqlen) or Result on error (error codes/positions per
    scalar/utf8_to_utf16/utf8_to_utf16.h:128-255).
    """
    n = len(buf)
    byte = buf[pos]
    if byte < 0x80:
        return byte, 1
    if (byte & 0xE0) == 0xC0:
        if pos + 1 >= n or not _is_cont(buf[pos + 1]):
            return Result(ec.TOO_SHORT, pos)
        cp = (byte & 0x1F) << 6 | (buf[pos + 1] & 0x3F)
        if cp < 0x80:
            return Result(ec.OVERLONG, pos)
        return cp, 2
    if (byte & 0xF0) == 0xE0:
        if pos + 2 >= n:
            return Result(ec.TOO_SHORT, pos)
        if not _is_cont(buf[pos + 1]) or not _is_cont(buf[pos + 2]):
            return Result(ec.TOO_SHORT, pos)
        cp = (byte & 0x0F) << 12 | (buf[pos + 1] & 0x3F) << 6 | (buf[pos + 2] & 0x3F)
        if cp < 0x800:
            return Result(ec.OVERLONG, pos)
        if 0xD800 <= cp <= 0xDFFF:
            return Result(ec.SURROGATE, pos)
        return cp, 3
    if (byte & 0xF8) == 0xF0:
        if pos + 3 >= n:
            return Result(ec.TOO_SHORT, pos)
        if (
            not _is_cont(buf[pos + 1])
            or not _is_cont(buf[pos + 2])
            or not _is_cont(buf[pos + 3])
        ):
            return Result(ec.TOO_SHORT, pos)
        cp = (
            (byte & 0x07) << 18
            | (buf[pos + 1] & 0x3F) << 12
            | (buf[pos + 2] & 0x3F) << 6
            | (buf[pos + 3] & 0x3F)
        )
        if cp <= 0xFFFF:
            return Result(ec.OVERLONG, pos)
        if cp > 0x10FFFF:
            return Result(ec.TOO_LARGE, pos)
        return cp, 4
    if _is_cont(byte):
        return Result(ec.TOO_LONG, pos)
    return Result(ec.HEADER_BITS, pos)


def convert_utf8_to_utf16_with_errors(buf: bytes, big_endian: bool):
    """Returns (Result, utf16_bytes). On success, Result.count = u16 units."""
    out: list[int] = []
    pos = 0
    n = len(buf)
    while pos < n:
        r = _decode_utf8_seq(buf, pos)
        if isinstance(r, Result):
            return r, _pack16(out, big_endian)
        cp, ln = r
        if cp < 0x10000:
            out.append(cp)
        else:
            cp -= 0x10000
            out.append(0xD800 + (cp >> 10))
            out.append(0xDC00 + (cp & 0x3FF))
        pos += ln
    return Result(ec.SUCCESS, len(out)), _pack16(out, big_endian)


def convert_utf8_to_utf32_with_errors(buf: bytes):
    out: list[int] = []
    pos = 0
    n = len(buf)
    while pos < n:
        r = _decode_utf8_seq(buf, pos)
        if isinstance(r, Result):
            return r, _pack32(out)
        cp, ln = r
        out.append(cp)
        pos += ln
    return Result(ec.SUCCESS, len(out)), _pack32(out)


def convert_utf8_to_latin1_with_errors(buf: bytes):
    # scalar/utf8_to_latin1/utf8_to_latin1.h:174-252
    out = bytearray()
    pos = 0
    n = len(buf)
    while pos < n:
        byte = buf[pos]
        if byte < 0x80:
            out.append(byte)
            pos += 1
        elif (byte & 0xE0) == 0xC0:
            if pos + 1 >= n or not _is_cont(buf[pos + 1]):
                return Result(ec.TOO_SHORT, pos), bytes(out)
            cp = (byte & 0x1F) << 6 | (buf[pos + 1] & 0x3F)
            if cp < 0x80:
                return Result(ec.OVERLONG, pos), bytes(out)
            if cp > 0xFF:
                return Result(ec.TOO_LARGE, pos), bytes(out)
            out.append(cp)
            pos += 2
        elif (byte & 0xF0) == 0xE0 or (byte & 0xF8) == 0xF0:
            return Result(ec.TOO_LARGE, pos), bytes(out)
        elif _is_cont(byte):
            return Result(ec.TOO_LONG, pos), bytes(out)
        else:
            return Result(ec.HEADER_BITS, pos), bytes(out)
    return Result(ec.SUCCESS, len(out)), bytes(out)


# ---------------------------------------------------------------------------
# UTF-16


def validate_utf16_with_errors(data: bytes, big_endian: bool) -> Result:
    words = _u16s(data, big_endian)
    n = len(words)
    pos = 0
    while pos < n:
        w = words[pos]
        if (w & 0xF800) == 0xD800:
            if pos + 1 >= n:
                return Result(ec.SURROGATE, pos)
            if (w - 0xD800) > 0x3FF:
                return Result(ec.SURROGATE, pos)
            if ((words[pos + 1] - 0xDC00) & 0xFFFF) > 0x3FF:
                return Result(ec.SURROGATE, pos)
            pos += 2
        else:
            pos += 1
    return Result(ec.SUCCESS, pos)


def validate_utf16(data: bytes, big_endian: bool) -> bool:
    return validate_utf16_with_errors(data, big_endian).is_ok


def count_utf16(data: bytes, big_endian: bool) -> int:
    return sum(1 for w in _u16s(data, big_endian) if (w & 0xFC00) != 0xDC00)


def utf8_length_from_utf16(data: bytes, big_endian: bool) -> int:
    n = 0
    for w in _u16s(data, big_endian):
        n += 1
        if w > 0x7F:
            n += 1
        if (0x7FF < w <= 0xD7FF) or w >= 0xE000:
            n += 1
    return n


def utf32_length_from_utf16(data: bytes, big_endian: bool) -> int:
    return count_utf16(data, big_endian)


def latin1_length_from_utf16(units: int) -> int:
    return units


def change_endianness_utf16(data: bytes) -> bytes:
    out = bytearray(len(data))
    out[0::2] = data[1::2]
    out[1::2] = data[0::2]
    return bytes(out)


def trim_partial_utf16(data: bytes, big_endian: bool) -> int:
    """Returns length in code units (scalar/utf16.h:114-124)."""
    length = len(data) // 2
    if length <= 1:
        return length
    words = _u16s(data, big_endian)
    last = words[length - 1]
    if (last & 0xFC00) == 0xD800:
        return length - 1
    return length


def to_well_formed_utf16(data: bytes, big_endian: bool) -> bytes:
    # scalar/utf16.h:141-166
    words = _u16s(data, big_endian)
    out = list(words)
    rep = 0xFFFD
    high_prev = False
    i = 0
    for i, w in enumerate(words):
        high = 0xD800 <= w <= 0xDBFF
        low = 0xDC00 <= w <= 0xDFFF
        if high_prev and not low:
            out[i - 1] = rep
        if not high_prev and low:
            out[i] = rep
        else:
            out[i] = w
        high_prev = high
    if high_prev:
        out[i] = rep
    return _pack16(out, big_endian)


def convert_utf16_to_utf8_with_errors(data: bytes, big_endian: bool):
    words = _u16s(data, big_endian)
    out = bytearray()
    n = len(words)
    pos = 0
    while pos < n:
        w = words[pos]
        if (w & 0xFF80) == 0:
            out.append(w)
            pos += 1
        elif (w & 0xF800) == 0:
            out.append((w >> 6) | 0xC0)
            out.append((w & 0x3F) | 0x80)
            pos += 1
        elif (w & 0xF800) != 0xD800:
            out.append((w >> 12) | 0xE0)
            out.append(((w >> 6) & 0x3F) | 0x80)
            out.append((w & 0x3F) | 0x80)
            pos += 1
        else:
            if pos + 1 >= n:
                return Result(ec.SURROGATE, pos), bytes(out)
            if (w - 0xD800) > 0x3FF:
                return Result(ec.SURROGATE, pos), bytes(out)
            nw = words[pos + 1]
            if ((nw - 0xDC00) & 0xFFFF) > 0x3FF:
                return Result(ec.SURROGATE, pos), bytes(out)
            value = ((w - 0xD800) << 10) + (nw - 0xDC00) + 0x10000
            out.append((value >> 18) | 0xF0)
            out.append(((value >> 12) & 0x3F) | 0x80)
            out.append(((value >> 6) & 0x3F) | 0x80)
            out.append((value & 0x3F) | 0x80)
            pos += 2
    return Result(ec.SUCCESS, len(out)), bytes(out)


def convert_utf16_to_utf32_with_errors(data: bytes, big_endian: bool):
    words = _u16s(data, big_endian)
    out: list[int] = []
    n = len(words)
    pos = 0
    while pos < n:
        w = words[pos]
        if (w & 0xF800) != 0xD800:
            out.append(w)
            pos += 1
        else:
            if (w - 0xD800) > 0x3FF:
                return Result(ec.SURROGATE, pos), _pack32(out)
            if pos + 1 >= n:
                return Result(ec.SURROGATE, pos), _pack32(out)
            nw = words[pos + 1]
            if ((nw - 0xDC00) & 0xFFFF) > 0x3FF:
                return Result(ec.SURROGATE, pos), _pack32(out)
            out.append(((w - 0xD800) << 10) + (nw - 0xDC00) + 0x10000)
            pos += 2
    return Result(ec.SUCCESS, len(out)), _pack32(out)


def convert_utf16_to_latin1_with_errors(data: bytes, big_endian: bool):
    words = _u16s(data, big_endian)
    out = bytearray()
    for pos, w in enumerate(words):
        if (w & 0xFF00) == 0:
            out.append(w)
        else:
            return Result(ec.TOO_LARGE, pos), bytes(out)
    return Result(ec.SUCCESS, len(out)), bytes(out)


# ---------------------------------------------------------------------------
# UTF-32


def validate_utf32_with_errors(data: bytes) -> Result:
    words = _u32s(data)
    for pos, w in enumerate(words):
        if w > 0x10FFFF:
            return Result(ec.TOO_LARGE, pos)
        if 0xD800 <= w <= 0xDFFF:
            return Result(ec.SURROGATE, pos)
    return Result(ec.SUCCESS, len(words))


def validate_utf32(data: bytes) -> bool:
    return validate_utf32_with_errors(data).is_ok


def utf8_length_from_utf32(data: bytes) -> int:
    n = 0
    for w in _u32s(data):
        n += 1
        if w > 0x7F:
            n += 1
        if w > 0x7FF:
            n += 1
        if w > 0xFFFF:
            n += 1
    return n


def utf16_length_from_utf32(data: bytes) -> int:
    n = 0
    for w in _u32s(data):
        n += 1
        if w > 0xFFFF:
            n += 1
    return n


def latin1_length_from_utf32(units: int) -> int:
    return units


def convert_utf32_to_utf8_with_errors(data: bytes):
    out = bytearray()
    for pos, w in enumerate(_u32s(data)):
        if (w & 0xFFFFFF80) == 0:
            out.append(w)
        elif (w & 0xFFFFF800) == 0:
            out.append((w >> 6) | 0xC0)
            out.append((w & 0x3F) | 0x80)
        elif (w & 0xFFFF0000) == 0:
            if 0xD800 <= w <= 0xDFFF:
                return Result(ec.SURROGATE, pos), bytes(out)
            out.append((w >> 12) | 0xE0)
            out.append(((w >> 6) & 0x3F) | 0x80)
            out.append((w & 0x3F) | 0x80)
        else:
            if w > 0x10FFFF:
                return Result(ec.TOO_LARGE, pos), bytes(out)
            out.append((w >> 18) | 0xF0)
            out.append(((w >> 12) & 0x3F) | 0x80)
            out.append(((w >> 6) & 0x3F) | 0x80)
            out.append((w & 0x3F) | 0x80)
    return Result(ec.SUCCESS, len(out)), bytes(out)


def convert_utf32_to_utf16_with_errors(data: bytes, big_endian: bool):
    out: list[int] = []
    for pos, w in enumerate(_u32s(data)):
        if (w & 0xFFFF0000) == 0:
            if 0xD800 <= w <= 0xDFFF:
                return Result(ec.SURROGATE, pos), _pack16(out, big_endian)
            out.append(w)
        else:
            if w > 0x10FFFF:
                return Result(ec.TOO_LARGE, pos), _pack16(out, big_endian)
            w -= 0x10000
            out.append(0xD800 + (w >> 10))
            out.append(0xDC00 + (w & 0x3FF))
    return Result(ec.SUCCESS, len(out)), _pack16(out, big_endian)


def convert_utf32_to_latin1_with_errors(data: bytes):
    out = bytearray()
    for pos, w in enumerate(_u32s(data)):
        if (w & 0xFFFFFF00) == 0:
            out.append(w)
        else:
            return Result(ec.TOO_LARGE, pos), bytes(out)
    return Result(ec.SUCCESS, len(out)), bytes(out)


# ---------------------------------------------------------------------------
# Latin1 (always valid input; no error paths)


def convert_latin1_to_utf8(data: bytes) -> bytes:
    out = bytearray()
    for b in data:
        if b < 0x80:
            out.append(b)
        else:
            out.append((b >> 6) | 0xC0)
            out.append((b & 0x3F) | 0x80)
    return bytes(out)


def convert_latin1_to_utf16(data: bytes, big_endian: bool) -> bytes:
    return _pack16(list(data), big_endian)


def convert_latin1_to_utf32(data: bytes) -> bytes:
    return _pack32(list(data))


def utf8_length_from_latin1(data: bytes) -> int:
    return len(data) + sum(1 for b in data if b >= 0x80)


# ---------------------------------------------------------------------------
# Base64 (WHATWG forgiving base64; reference: src/scalar/base64.h,
# src/generic/base64.h:43-246, tables src/tables/base64_tables.h)

_B64_STD = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
_B64_URL = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_"
_SPACES = b" \t\n\r\x0c"

# base64_options values (implementation.h:2782-2800)
BASE64_DEFAULT = 0
BASE64_URL = 1
BASE64_REVERSE_PADDING = 2
BASE64_DEFAULT_NO_PADDING = 2
BASE64_URL_WITH_PADDING = 3
BASE64_DEFAULT_ACCEPT_GARBAGE = 4
BASE64_URL_ACCEPT_GARBAGE = 5
BASE64_DEFAULT_OR_URL = 8
BASE64_DEFAULT_OR_URL_ACCEPT_GARBAGE = 12

LOOSE = 0
STRICT = 1
STOP_BEFORE_PARTIAL = 2


def _b64_value_table(options: int) -> list[int]:
    """Char -> 6-bit value; 64 for ASCII spaces; 255 invalid."""
    tab = [255] * 256
    if options & BASE64_DEFAULT_OR_URL:
        alphabets = [_B64_STD, _B64_URL]
    elif options & BASE64_URL:
        alphabets = [_B64_URL]
    else:
        alphabets = [_B64_STD]
    for alpha in alphabets:
        for v, ch in enumerate(alpha):
            tab[ord(ch)] = v
    for s in _SPACES:
        tab[s] = 64
    return tab


def _b64_ignore_garbage(options: int) -> bool:
    return options in (
        BASE64_DEFAULT_ACCEPT_GARBAGE,
        BASE64_URL_ACCEPT_GARBAGE,
        BASE64_DEFAULT_OR_URL_ACCEPT_GARBAGE,
    )


def maximal_binary_length_from_base64(src) -> int:
    length = len(src)
    padding = 0
    if length > 0:
        eq = ord("=")
        if src[length - 1] == eq:
            padding += 1
            if length > 1 and src[length - 2] == eq:
                padding += 1
    actual = length - padding
    if actual % 4 <= 1:
        return actual // 4 * 3
    return actual // 4 * 3 + (actual % 4) - 1


def base64_length_from_binary(length: int, options: int = BASE64_DEFAULT) -> int:
    use_padding = ((options & BASE64_URL) == 0) ^ (
        (options & BASE64_REVERSE_PADDING) == BASE64_REVERSE_PADDING
    )
    if not use_padding:
        return length // 3 * 4 + ((length % 3) + 1 if length % 3 else 0)
    return (length + 2) // 3 * 4


def binary_to_base64(src: bytes, options: int = BASE64_DEFAULT) -> bytes:
    use_padding = ((options & BASE64_URL) == 0) ^ (
        (options & BASE64_REVERSE_PADDING) == BASE64_REVERSE_PADDING
    )
    alpha = _B64_URL if (options & BASE64_URL) else _B64_STD
    out = bytearray()
    i = 0
    n = len(src)
    while i + 2 < n:
        t = src[i] << 16 | src[i + 1] << 8 | src[i + 2]
        out += bytes(
            ord(alpha[x]) for x in ((t >> 18) & 63, (t >> 12) & 63, (t >> 6) & 63, t & 63)
        )
        i += 3
    rem = n - i
    if rem == 1:
        t = src[i]
        out.append(ord(alpha[t >> 2]))
        out.append(ord(alpha[(t & 0x03) << 4]))
        if use_padding:
            out += b"=="
    elif rem == 2:
        t1, t2 = src[i], src[i + 1]
        out.append(ord(alpha[t1 >> 2]))
        out.append(ord(alpha[((t1 & 0x03) << 4) | (t2 >> 4)]))
        out.append(ord(alpha[(t2 & 0x0F) << 2]))
        if use_padding:
            out.append(ord("="))
    return bytes(out)


def _b64_char_ok16(c: int) -> bool:
    """is_eight_byte for char16 inputs (scalar/base64.h:24-29)."""
    return c == (c & 0xFF)


def base64_to_binary(
    src,
    options: int = BASE64_DEFAULT,
    last_chunk: int = LOOSE,
) -> tuple[FullResult, bytes]:
    """Forgiving-base64 decode.

    ``src`` is ``bytes`` (8-bit chars) or a sequence of ints (char16 input).
    Returns (FullResult, decoded bytes). Mirrors
    generic/base64.h:43-246 + scalar/base64.h:33-216 observable behavior.
    """
    tab = _b64_value_table(options)
    ignore_garbage = _b64_ignore_garbage(options)
    eq = ord("=")

    def code(c: int) -> int:
        if not _b64_char_ok16(c):
            return 255
        return tab[c & 0xFF]

    srclen = len(src)
    pad_pos = srclen
    pad_count = 0
    if not ignore_garbage:
        while srclen > 0 and code(src[srclen - 1]) == 64:
            srclen -= 1
        if srclen > 0 and src[srclen - 1] == eq:
            pad_pos = srclen - 1
            srclen -= 1
            pad_count = 1
            while srclen > 0 and code(src[srclen - 1]) == 64:
                srclen -= 1
            if srclen > 0 and src[srclen - 1] == eq:
                pad_pos = srclen - 1
                srclen -= 1
                pad_count = 2
    if srclen == 0:
        if not ignore_garbage and pad_count > 0:
            if last_chunk == STRICT:
                return FullResult(ec.BASE64_INPUT_REMAINDER, 0, 0), b""
            if last_chunk == STOP_BEFORE_PARTIAL:
                return FullResult(ec.SUCCESS, 0, 0), b""
            return FullResult(ec.INVALID_BASE64_CHARACTER, pad_pos, 0), b""
        return FullResult(ec.SUCCESS, 0, 0), b""

    # Emulate base64_tail_decode over the stripped input (scalar/base64.h:33).
    out = bytearray()
    buffer: list[int] = []
    pos = 0
    chunk_valid_positions: list[int] = []  # source pos of each valid char in chunk
    while pos < srclen:
        c = src[pos]
        v = code(c)
        if v <= 63:
            buffer.append(v)
            chunk_valid_positions.append(pos)
            if len(buffer) == 4:
                t = buffer[0] << 18 | buffer[1] << 12 | buffer[2] << 6 | buffer[3]
                out += bytes([(t >> 16) & 0xFF, (t >> 8) & 0xFF, t & 0xFF])
                buffer.clear()
                chunk_valid_positions.clear()
        elif v == 64 or ignore_garbage:
            pass  # space (or garbage when accepted): skip
        else:
            return (
                FullResult(ec.INVALID_BASE64_CHARACTER, pos, len(out)),
                bytes(out),
            )
        pos += 1

    idx = len(buffer)
    # Tail handling (scalar/base64.h:133-200)
    if idx != 0 or (not ignore_garbage and pad_count > 0):
        if (
            not ignore_garbage
            and last_chunk == STRICT
            and idx != 1
            and ((idx + pad_count) & 3) != 0
        ):
            return FullResult(ec.BASE64_INPUT_REMAINDER, srclen, len(out)), bytes(out)
        if (
            not ignore_garbage
            and last_chunk == STOP_BEFORE_PARTIAL
            and ((idx + pad_count) & 3) != 0
        ):
            # input_count = start of the partial chunk (first valid char of it)
            start = chunk_valid_positions[0] if chunk_valid_positions else srclen
            return FullResult(ec.SUCCESS, start, len(out)), bytes(out)
        if idx == 2:
            t = buffer[0] << 18 | buffer[1] << 12
            if not ignore_garbage and last_chunk == STRICT and (t & 0xFFFF):
                return FullResult(ec.BASE64_EXTRA_BITS, srclen, len(out)), bytes(out)
            out.append((t >> 16) & 0xFF)
        elif idx == 3:
            t = buffer[0] << 18 | buffer[1] << 12 | buffer[2] << 6
            if not ignore_garbage and last_chunk == STRICT and (t & 0xFF):
                return FullResult(ec.BASE64_EXTRA_BITS, srclen, len(out)), bytes(out)
            out.append((t >> 16) & 0xFF)
            out.append((t >> 8) & 0xFF)
        elif not ignore_garbage and idx == 1 and last_chunk != STOP_BEFORE_PARTIAL:
            return FullResult(ec.BASE64_INPUT_REMAINDER, srclen, len(out)), bytes(out)

    # Padding-consistency epilogue (generic/base64.h:228-244)
    if (
        not ignore_garbage
        and last_chunk != STOP_BEFORE_PARTIAL
        and pad_count > 0
    ):
        if (len(out) % 3 == 0) or ((len(out) % 3) + 1 + pad_count != 4):
            return (
                FullResult(ec.INVALID_BASE64_CHARACTER, pad_pos, len(out)),
                bytes(out),
            )
    return FullResult(ec.SUCCESS, srclen, len(out)), bytes(out)
