"""Stateful streaming (chunked) processing.

The reference has no stream objects; its streaming story is a *contract*:
callers chunk at codepoint boundaries using ``trim_partial_utf8/16``
(implementation.h:2690-2716, exercised by the benchmarks/stream.cpp
microstudy) and resume base64 decodes via ``base64_to_binary_safe``'s
consumed-count semantics (implementation.h:3090-3208). These classes
package exactly that discipline as a first-class API: push arbitrary byte
chunks, get transcoded/validated/decoded output incrementally, with error
positions reported as *global* input offsets (in input code units) — the
same carry discipline the shard planner applies across chips
(parallel/planner.py), here applied across time.

Device-shaped by construction: every ``push`` hands the device one
boundary-aligned buffer (no per-character host loop); the only host work
is the <=3-byte carry splice between chunks.
"""

from __future__ import annotations

import numpy as np

from . import api
from .errors import FullResult, Result, error_code

__all__ = [
    "StreamingError",
    "StreamTranscoder",
    "StreamValidator",
    "Base64StreamDecoder",
    "Base64StreamEncoder",
    "canonical_encoding",
]

#: iconv-style spellings -> canonical names (tools/sutf.cpp accepts the
#: same set; bare UTF-16/32 mean LE as on the reference's LE hosts).
ENCODING_SPELLINGS = {
    "utf8": "utf8",
    "utf-8": "utf8",
    "utf16": "utf16le",
    "utf-16": "utf16le",
    "utf16le": "utf16le",
    "utf-16le": "utf16le",
    "utf16be": "utf16be",
    "utf-16be": "utf16be",
    "utf32": "utf32",
    "utf-32": "utf32",
    "utf32le": "utf32",
    "utf-32le": "utf32",
    "latin1": "latin1",
    "iso-8859-1": "latin1",
    "iso8859-1": "latin1",
    "ascii": "ascii",
    "us-ascii": "ascii",
}


def canonical_encoding(name: str) -> str | None:
    return ENCODING_SPELLINGS.get(name.lower().strip())


#: bytes per input code unit (error offsets are reported in units,
#: matching the reference's result.count contract, error.h:34-52)
_UNIT_BYTES = {
    "utf8": 1,
    "utf16le": 2,
    "utf16be": 2,
    "utf32": 4,
    "latin1": 1,
    "ascii": 1,
}


def _trim_bytes(enc: str, buf: bytes) -> int:
    """Largest prefix (in bytes) ending on a code-point boundary — the
    trim_partial contract lifted to raw bytes."""
    if enc == "utf8":
        return api.trim_partial_utf8(buf)
    if enc in ("utf16le", "utf16be"):
        even = len(buf) // 2 * 2
        if even == 2:
            # trim_partial_utf16 deliberately keeps a lone lead surrogate
            # when length <= 1 (scalar/utf16.h:116-119); a *stream* knows
            # the pair's tail may still arrive, so hold it instead.
            u = int.from_bytes(
                buf[:2], "little" if enc == "utf16le" else "big")
            return 0 if (u & 0xFC00) == 0xD800 else 2
        trim = (api.trim_partial_utf16le if enc == "utf16le"
                else api.trim_partial_utf16be)
        return 2 * trim(buf[:even])
    if enc == "utf32":
        return len(buf) // 4 * 4
    return len(buf)  # latin1 / ascii: every byte is a whole character


_VALIDATORS = {
    "utf8": api.validate_utf8_with_errors,
    "utf16le": api.validate_utf16le_with_errors,
    "utf16be": api.validate_utf16be_with_errors,
    "utf32": api.validate_utf32_with_errors,
    "ascii": api.validate_ascii_with_errors,
    "latin1": lambda d: Result(error_code.SUCCESS, len(d)),
}


def _converters():
    """(src, dst) -> fn(bytes) -> (Result | None, bytes)."""
    none_ok = lambda fn: (lambda d: (None, fn(d)))  # noqa: E731
    return {
        ("utf8", "utf16le"): api.convert_utf8_to_utf16le_with_errors,
        ("utf8", "utf16be"): api.convert_utf8_to_utf16be_with_errors,
        ("utf8", "utf32"): api.convert_utf8_to_utf32_with_errors,
        ("utf8", "latin1"): api.convert_utf8_to_latin1_with_errors,
        ("utf16le", "utf8"): api.convert_utf16le_to_utf8_with_errors,
        ("utf16be", "utf8"): api.convert_utf16be_to_utf8_with_errors,
        ("utf16le", "utf32"): api.convert_utf16le_to_utf32_with_errors,
        ("utf16be", "utf32"): api.convert_utf16be_to_utf32_with_errors,
        ("utf16le", "latin1"): api.convert_utf16le_to_latin1_with_errors,
        ("utf16be", "latin1"): api.convert_utf16be_to_latin1_with_errors,
        ("utf32", "utf8"): api.convert_utf32_to_utf8_with_errors,
        ("utf32", "utf16le"): api.convert_utf32_to_utf16le_with_errors,
        ("utf32", "utf16be"): api.convert_utf32_to_utf16be_with_errors,
        ("utf32", "latin1"): api.convert_utf32_to_latin1_with_errors,
        ("utf16le", "utf16be"): none_ok(api.change_endianness_utf16),
        ("utf16be", "utf16le"): none_ok(api.change_endianness_utf16),
        ("latin1", "utf8"): none_ok(api.convert_latin1_to_utf8),
        ("latin1", "utf16le"): none_ok(api.convert_latin1_to_utf16le),
        ("latin1", "utf16be"): none_ok(api.convert_latin1_to_utf16be),
        ("latin1", "utf32"): none_ok(api.convert_latin1_to_utf32),
    }


class StreamingError(ValueError):
    """Invalid input in a stream.

    ``error``: the :class:`error_code`; ``count``: global offset of the
    first invalid input unit (same units as the one-shot result.count);
    ``partial``: output produced from this segment before the error (the
    with_errors partial-output contract)."""

    def __init__(self, error, count: int, partial: bytes = b""):
        super().__init__(f"{error_code(error).name} at input unit {count}")
        self.error = error_code(error)
        self.count = int(count)
        self.partial = partial


class _Carried:
    """Shared push/finish plumbing: buffer, trim-aligned cuts, global
    unit accounting."""

    def __init__(self, src: str):
        enc = canonical_encoding(src)
        if enc is None:
            raise ValueError(f"unknown encoding {src!r}")
        from .features import ENCODING_FEATURE, require_enabled

        require_enabled({ENCODING_FEATURE[enc]}, type(self).__name__)
        self._src = enc
        self._unit = _UNIT_BYTES[enc]
        self._buf = bytearray()
        self._units = 0  # complete input units consumed so far
        self._done = False

    @property
    def units_consumed(self) -> int:
        return self._units

    def _segments(self, chunk: bytes, final: bool):
        """Yield boundary-aligned byte segments to process."""
        if self._done:
            raise RuntimeError("stream already finished")
        self._buf += chunk
        if final:
            self._done = True
            seg = bytes(self._buf)
            self._buf.clear()
            if seg or self._units == 0:
                yield seg, True
            return
        cut = _trim_bytes(self._src, bytes(self._buf))
        if cut:
            seg = bytes(self._buf[:cut])
            del self._buf[:cut]
            yield seg, False

    def _split_aligned(self, seg: bytes) -> tuple[bytes, int]:
        """(unit-aligned prefix, trailing fragment bytes). A fragment that
        cannot even form a code unit (odd utf16 byte / short utf32 word) is
        invisible to the unit-typed one-shot API; the stream reports
        TOO_SHORT at its start — but only AFTER the aligned prefix has been
        checked, so an earlier real error keeps its own code/offset."""
        rem = len(seg) % self._unit
        return (seg[: len(seg) - rem] if rem else seg), rem


class StreamTranscoder(_Carried):
    """Incremental transcoder between any two supported encodings.

    >>> t = StreamTranscoder("utf-8", "utf-16le")
    >>> out = t.push(b"\\xe4\\xbd")   # partial codepoint is carried
    >>> out += t.push(b"\\xa0!")
    >>> out += t.finish()

    Output bytes are identical to the one-shot converter on the
    concatenated input; invalid input raises :class:`StreamingError` with
    the global unit offset the one-shot would report.
    """

    def __init__(self, src: str, dst: str):
        super().__init__(src)
        to = canonical_encoding(dst)
        if to is None:
            raise ValueError(f"unknown encoding {dst!r}")
        from .features import ENCODING_FEATURE, require_enabled

        require_enabled({ENCODING_FEATURE[to]}, type(self).__name__)
        if to == "ascii":
            raise ValueError(
                "ascii is a validation target, not a conversion target "
                "(use dst='utf8' + StreamValidator('ascii'))")
        src_eff = "utf8" if self._src == "ascii" else self._src
        self._check_ascii = self._src == "ascii"
        if src_eff == to:
            self._fn = None  # validate + passthrough
        else:
            self._fn = _converters()[(src_eff, to)]

    def _convert(self, seg: bytes) -> bytes:
        aligned, rem = self._split_aligned(seg)
        out = b""
        if aligned:
            if self._fn is None:
                # passthrough: one validation (the ascii validator already
                # is _VALIDATORS['ascii'] when src == 'ascii')
                r = _VALIDATORS[self._src](aligned)
                if r.is_err:
                    raise StreamingError(r.error, self._units + r.count)
                out = aligned
            else:
                if self._check_ascii:
                    r = api.validate_ascii_with_errors(aligned)
                    if r.is_err:
                        raise StreamingError(r.error, self._units + r.count)
                res, out = self._fn(aligned)
                if res is not None and res.is_err:
                    raise StreamingError(
                        res.error, self._units + res.count, out)
            self._units += len(aligned) // self._unit
        if rem:
            raise StreamingError(error_code.TOO_SHORT, self._units, out)
        return out

    def push(self, chunk: bytes) -> bytes:
        out = b""
        try:
            for seg, _ in self._segments(bytes(chunk), final=False):
                out += self._convert(seg)
        except StreamingError:
            self._done = True  # invalid input is terminal for a transcoder
            raise
        return out

    def finish(self) -> bytes:
        out = b""
        try:
            for seg, _ in self._segments(b"", final=True):
                out += self._convert(seg)
        except StreamingError:
            self._done = True
            raise
        return out


class StreamValidator(_Carried):
    """Incremental validator; ``finish()`` returns the one-shot Result:
    SUCCESS with the total unit count, or the first error with its global
    unit offset."""

    def __init__(self, enc: str):
        super().__init__(enc)
        self._err: Result | None = None

    def push(self, chunk: bytes) -> "StreamValidator":
        if self._done:
            raise RuntimeError("stream already finished")
        if self._err is not None:
            # first error wins; later bytes cannot change it, so they are
            # dropped (the stream stays consumable, but finish() is still
            # terminal like every other stream class)
            return self
        for seg, _ in self._segments(bytes(chunk), final=False):
            self._check(seg)
        return self

    def _check(self, seg: bytes) -> None:
        if self._err is not None:
            return
        aligned, rem = self._split_aligned(seg)
        if aligned:
            r = _VALIDATORS[self._src](aligned)
            if r.is_err:
                self._err = Result(r.error, self._units + r.count)
                return
            self._units += len(aligned) // self._unit
        if rem:
            self._err = Result(error_code.TOO_SHORT, self._units)

    def finish(self) -> Result:
        for seg, _ in self._segments(b"", final=True):
            self._check(seg)
        return self._err if self._err is not None else Result(
            error_code.SUCCESS, self._units)


class Base64StreamDecoder:
    """Incremental forgiving-base64 decoder.

    Complete quads of *significant* characters (per the active alphabet;
    whitespace and — under accept_garbage — garbage are insignificant) are
    decoded as they arrive; once an ``=`` is seen, the rest is held for
    ``finish()`` so the one-shot padding/epilogue rules (generic/
    base64.h:52-85, 228-244) apply verbatim with global offsets. After
    ``finish()``, :attr:`result` carries the one-shot FullResult with
    global input/output counts (including stop_before_partial's
    unconsumed-tail accounting).
    """

    def __init__(self, options: int = 0, last_chunk_handling: int = 0):
        from .features import require_enabled

        require_enabled({"base64"}, type(self).__name__)
        from .golden import base64_impl as gb

        self._options = options
        self._last = last_chunk_handling
        self._tab = gb.value_table(options)
        self._garbage = bool(gb.ignore_garbage(options))
        self._buf = bytearray()
        self._chars = 0  # global chars consumed into decodes
        self._out = 0  # global bytes produced
        self._done = False
        #: positions (relative to _buf) of pending significant chars seen
        #: before any '=' — each push classifies ONLY its own chunk, so a
        #: whitespace/garbage-heavy stream stays O(chunk) per push
        self._sig_pos: list[int] = []
        self._eq_off: int | None = None  # first '=' position within _buf
        self.result: FullResult | None = None

    def push(self, chunk: bytes) -> bytes:
        if self._done:
            raise RuntimeError("stream already finished")
        chunk = bytes(chunk)
        base = len(self._buf)
        self._buf += chunk
        if self._eq_off is not None:
            # everything from the '='-quad on is tail context held for
            # finish(); memory here is bounded by the post-padding
            # remainder of the stream (padding is terminal in practice)
            return b""
        arr = np.frombuffer(chunk, dtype=np.uint8)
        if self._garbage:
            # with accept_garbage, '=' is an insignificant character like
            # any other garbage (golden/base64_impl semantics), so eager
            # quad decoding continues through it — without this, one stray
            # '=' would buffer the entire remaining stream until finish()
            region = arr.shape[0]
            eqpos = np.zeros(0, dtype=np.int64)
        else:
            eqpos = np.nonzero(arr == 0x3D)[0]
            region = int(eqpos[0]) if eqpos.size else arr.shape[0]
        new_sig = np.nonzero(self._tab[arr[:region]] < 64)[0]
        self._sig_pos.extend((new_sig + base).tolist())
        if eqpos.size:
            self._eq_off = base + int(eqpos[0])
        quads = len(self._sig_pos) // 4
        if quads == 0:
            return b""
        cut = self._sig_pos[quads * 4 - 1] + 1
        seg = bytes(self._buf[:cut])
        del self._buf[:cut]
        self._sig_pos = [p - cut for p in self._sig_pos[quads * 4:]]
        if self._eq_off is not None:
            self._eq_off -= cut
        return self._decode(seg, 0)  # complete quads: mode irrelevant

    def _decode(self, seg: bytes, last_chunk: int) -> bytes:
        full, out = api.base64_to_binary_details(
            seg, self._options, last_chunk)
        if full.is_ok or full.error == error_code.BASE64_INPUT_REMAINDER:
            self._chars += len(seg) if not self._done else full.input_count
            self._out += len(out)
            self.result = FullResult(full.error, self._chars, self._out)
            if full.error != error_code.SUCCESS:
                self._done = True  # invalid input is terminal
                raise StreamingError(
                    full.error, self._chars, out)
            return out
        self._out += len(out)
        self.result = FullResult(
            full.error, self._chars + full.input_count, self._out)
        self._done = True  # invalid input is terminal
        raise StreamingError(
            full.error, self._chars + full.input_count, out)

    def finish(self) -> bytes:
        if self._done:
            raise RuntimeError("stream already finished")
        self._done = True
        seg = bytes(self._buf)
        self._buf.clear()
        out = self._decode(seg, self._last)
        # stop_before_partial leaves a partial quad unconsumed; the chars
        # counter already reflects exactly what the tail decode consumed
        return out


class Base64StreamEncoder:
    """Incremental base64 encoder: 3-byte groups stream out eagerly
    (base64 of a 3-aligned prefix is a prefix of the whole encoding);
    padding per ``options`` is appended by ``finish()``."""

    def __init__(self, options: int = 0):
        from .features import require_enabled

        require_enabled({"base64"}, type(self).__name__)
        self._options = options
        self._buf = bytearray()
        self._done = False

    def push(self, chunk: bytes) -> bytes:
        if self._done:
            raise RuntimeError("stream already finished")
        self._buf += bytes(chunk)
        k = len(self._buf) // 3 * 3
        if not k:
            return b""
        seg = bytes(self._buf[:k])
        del self._buf[:k]
        return api.binary_to_base64(seg, self._options)

    def finish(self) -> bytes:
        if self._done:
            raise RuntimeError("stream already finished")
        self._done = True
        seg = bytes(self._buf)
        self._buf.clear()
        return api.binary_to_base64(seg, self._options) if seg else b""
