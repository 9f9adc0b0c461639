"""simdutf_tpu — an accelerator Unicode validation/transcoding + base64 library.

A from-scratch JAX re-imagining of the capabilities of simdutf
(reference: WojciechMula/simdutf v7.0.0): validating transcode across
ASCII / Latin1 / UTF-8 / UTF-16LE/BE / UTF-32, validation with exact
first-error location, character/length counting, encoding detection, and
WHATWG forgiving-base64 — compiled by XLA for the GPU, with data-parallel
sharding across devices and collective error reduction.

Tiers (selected at runtime, like the reference's CPU backends):
  * ``xla``      — jax.numpy/lax compiled by XLA (the device tier)
  * ``cnative``  — compiled C scalar code on the host, when built
  * ``fallback`` — vectorized NumPy on host

Quick start::

    import simdutf_tpu as su
    su.validate_utf8(b"\\xf0\\x9f\\x98\\x80")      # True
    su.convert_utf8_to_utf16le("héllo".encode())   # b'h\\x00\\xe9\\x00...'
    res, out = su.base64_to_binary(b"aGVsbG8=")
"""

from .api import *  # noqa: F401,F403
from .api import (  # explicit re-exports for the registry / enums
    get_active_implementation,
    get_available_implementations,
    set_active_implementation,
)
from .errors import Result, FullResult, error_code
from .stream import (
    StreamingError,
    StreamTranscoder,
    StreamValidator,
    Base64StreamDecoder,
    Base64StreamEncoder,
)
from .features import features, FEATURES
from .encodings import (
    encoding_type,
    endianness,
    match_system,
    check_bom,
    bom_byte_size,
    to_string,
)

__version__ = "0.1.0"

SIMDUTF_VERSION = "7.0.0"  # reference parity target

# runtime feature subsetting (SIMDUTF_TPU_FEATURES env) — the analog of
# building the reference with a SIMDUTF_FEATURE_* subset via amalgamation
from . import api as _api_mod  # noqa: E402
from .features import apply_gates as _apply_gates, FeatureUnavailableError  # noqa: E402,F401
import sys as _sys  # noqa: E402

_GATED_FUNCTIONS = _apply_gates((_api_mod, _sys.modules[__name__]))
