"""Implementation registry + runtime dispatch.

Parity with the reference's dispatch layer (src/implementation.cpp):
  * ``get_available_implementations()``  (implementation.cpp:1316-1323)
  * ``get_active_implementation()`` with lazy best-pick on first use
    (implementation.cpp:1326-1340, detect_best at :1274-1309)
  * env-var override ``SIMDUTF_TPU_FORCE_IMPLEMENTATION`` mirroring
    ``SIMDUTF_FORCE_IMPLEMENTATION`` (implementation.cpp:1294-1305)
  * programmatic ``set_active_implementation(name)`` like
    ``get_active_implementation() = impl`` (tests/select_implementation.cpp)

Where the reference probes CPUID (isadetection.h), we probe
``jax.devices()``: any JAX backend selects the XLA tier, and the NumPy
fallback is always available.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from .implementation import Implementation, FallbackImplementation

_lock = threading.Lock()
_implementations: Dict[str, Implementation] = {}
_active: Optional[Implementation] = None
_priority = ["xla", "cnative", "fallback"]  # best-first, like the reference's
# icelake->haswell->...->fallback listing order (implementation.cpp:758-786)

ENV_FORCE = "SIMDUTF_TPU_FORCE_IMPLEMENTATION"
ENV_SMALL = "SIMDUTF_TPU_SMALL_INPUT_BYTES"
# Up to this many input bytes, the auto-selected device tier answers from
# the scalar tier instead. On an NVIDIA H200 (700 W) the C tier beat the
# device tier's served time (host padding and transfers included) at 4 MiB
# and lost from 8 MiB, for both validate_utf8 and convert_utf8_to_utf16le
# (chip_smoke.py phase 7; PERF.md).
_SMALL_DEFAULT = 4 << 20


class SmallInputRouter:
    """Proxy around a device-tier implementation that answers small calls
    from the scalar tier (cnative when built, NumPy fallback otherwise).

    The reference ends every SIMD kernel with a scalar tail because below
    a block the vector machinery costs more than it saves; on an
    accelerator the same cliff sits at the *call* level (device launch +
    host<->HBM staging), so the dispatch layer applies the identical cure
    at call granularity. Applied only to the AUTO-selected tier: a forced
    tier (env or set_active_implementation) always runs what was asked,
    keeping per-tier conformance runs and pinned benchmarks exact.
    Disable with SIMDUTF_TPU_SMALL_INPUT_BYTES=0 (or tune the threshold).
    """

    def __init__(self, device: Implementation, scalar: Implementation,
                 threshold: int):
        self._device = device
        self._scalar = scalar
        self._threshold = threshold
        self.name = device.name
        self.description = (
            f"{device.description} (+{scalar.name} for inputs "
            f"<= {threshold} B)"
        )

    def __getattr__(self, attr):
        dev = getattr(self._device, attr)
        if attr.startswith("_") or not callable(dev):
            return dev
        sca = getattr(self._scalar, attr, None)
        if sca is None:
            return dev
        threshold = self._threshold

        import functools

        import numpy as np

        @functools.wraps(dev)
        def routed(*args, **kw):
            if (
                args
                and isinstance(args[0], np.ndarray)
                and args[0].nbytes <= threshold
            ):
                return sca(*args, **kw)
            return dev(*args, **kw)

        setattr(self, attr, routed)  # cache: resolve each method once
        return routed


def _with_small_routing(impl: Implementation) -> Implementation:
    try:
        threshold = int(os.environ.get(ENV_SMALL, _SMALL_DEFAULT))
    except ValueError:
        threshold = _SMALL_DEFAULT
    if threshold <= 0 or impl.name != "xla":
        return impl
    scalar = _implementations.get("cnative") or _implementations["fallback"]
    return SmallInputRouter(impl, scalar, threshold)


def register(impl: Implementation) -> None:
    with _lock:
        _implementations[impl.name] = impl


def _ensure_builtin_registered() -> None:
    if "fallback" not in _implementations:
        register(FallbackImplementation())
    if "xla" not in _implementations:
        try:
            from .ops.impl import XLAImplementation

            register(XLAImplementation())
        except Exception:  # pragma: no cover - jax not importable
            pass
    if "cnative" not in _implementations:
        try:
            from ._native.impl import CNativeImplementation

            register(CNativeImplementation())
        except ImportError:  # extension not built
            pass


def get_available_implementations() -> Dict[str, Implementation]:
    _ensure_builtin_registered()
    return dict(_implementations)


def _detect_best() -> Implementation:
    _ensure_builtin_registered()
    forced = os.environ.get(ENV_FORCE)
    if forced:
        impl = _implementations.get(forced)
        if impl is not None and impl.supported_by_runtime_system():
            return impl
        # Fail loudly: the reference installs an unsupported singleton whose
        # every call fails (implementation.cpp:1302-1305); silently running a
        # different tier would invalidate pinned benchmarks/fuzz runs.
        raise RuntimeError(
            f"{ENV_FORCE}={forced!r} names no usable implementation; "
            f"available: {sorted(_implementations)}"
        )
    for name in _priority:
        impl = _implementations.get(name)
        if (
            impl is not None
            and impl.supported_by_runtime_system()
            and impl.preferred_by_runtime()
        ):
            return _with_small_routing(impl)
    raise RuntimeError("no usable simdutf_tpu implementation registered")


def get_active_implementation() -> Implementation:
    global _active
    if _active is None:
        # detection may import jax and take seconds; run it outside the
        # lock, then install only if nobody else won the race
        impl = _detect_best()
        with _lock:
            if _active is None:
                _active = impl
    return _active


def set_active_implementation(impl: Implementation | str) -> Implementation:
    global _active
    if isinstance(impl, str):
        _ensure_builtin_registered()
        if impl not in _implementations:
            raise KeyError(
                f"unknown implementation {impl!r}; available: "
                f"{sorted(_implementations)}"
            )
        impl = _implementations[impl]
    with _lock:
        _active = impl
    return impl
