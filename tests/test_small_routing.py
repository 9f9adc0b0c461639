"""Small-call scalar routing on the auto-selected device tier.

Device launch overhead dwarfs the work below ~0.5 MB, so the dispatch
layer answers small calls from the scalar tier — the reference's scalar
tail philosophy applied at call granularity. Forced tiers are never
wrapped (per-tier conformance and pinned benchmarks stay exact).
"""

from __future__ import annotations

import numpy as np
import pytest

import simdutf_tpu as su
from simdutf_tpu import registry


@pytest.fixture
def restore_active():
    prev = registry.get_active_implementation()
    yield
    registry._active = prev


def test_autopick_wraps_device_tier(restore_active):
    impl = registry._detect_best()
    if impl.name != "xla":
        pytest.skip("no device tier on this backend")
    assert isinstance(impl, registry.SmallInputRouter)
    # registry lookups and forced selection still hand out the raw tiers
    raw = registry.get_available_implementations()[impl.name]
    assert not isinstance(raw, registry.SmallInputRouter)
    forced = su.set_active_implementation(impl.name)
    assert forced is raw


def test_routing_by_size(restore_active, monkeypatch):
    impls = registry.get_available_implementations()
    device = impls.get("xla")
    if device is None:
        pytest.skip("no device tier")
    scalar = impls.get("cnative") or impls["fallback"]
    router = registry.SmallInputRouter(device, scalar, threshold=1024)

    calls = []
    monkeypatch.setattr(
        type(scalar), "count_utf8",
        lambda self, b: calls.append(("scalar", b.nbytes)) or 7,
    )
    monkeypatch.setattr(
        type(device), "count_utf8",
        lambda self, b: calls.append(("device", b.nbytes)) or 9,
    )
    small = np.zeros(100, np.uint8)
    big = np.zeros(4096, np.uint8)
    assert router.count_utf8(small) == 7
    assert router.count_utf8(big) == 9
    assert [c[0] for c in calls] == ["scalar", "device"]
    # results parity on real methods (no monkeypatch)
    monkeypatch.undo()
    data = np.frombuffer("héllo wörld 日本語 🙂".encode(), np.uint8)
    router2 = registry.SmallInputRouter(device, scalar, threshold=10**6)
    assert router2.count_utf8(data) == device.count_utf8(data)
    assert router2.validate_utf8(data) == device.validate_utf8(data)
    res_r = router2.validate_utf8_with_errors(data)
    assert res_r == device.validate_utf8_with_errors(data)


def test_threshold_env(restore_active, monkeypatch):
    monkeypatch.setenv(registry.ENV_SMALL, "0")
    impl = registry._detect_best()
    assert not isinstance(impl, registry.SmallInputRouter)
    monkeypatch.setenv(registry.ENV_SMALL, "123456")
    impl = registry._detect_best()
    if impl.name == "xla":
        assert isinstance(impl, registry.SmallInputRouter)
        assert impl._threshold == 123456


def test_non_buffer_args_use_device(restore_active):
    impls = registry.get_available_implementations()
    device = impls.get("xla") or impls["fallback"]
    scalar = impls["fallback"]
    router = registry.SmallInputRouter(device, scalar, threshold=1 << 20)
    # int-first signatures (latin1_length_from_utf16 takes a length)
    assert router.latin1_length_from_utf16(55) == 55
    assert router.supported_by_runtime_system() in (True, False)
    assert isinstance(router.internal_tests(), list)
