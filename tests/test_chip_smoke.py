"""chip_smoke.py's phases at small sizes on the CPU: the control flow and
the byte-for-byte comparisons, forced onto the device tier. Timings from
these runs mean nothing. Phase 1 must refuse a non-GPU backend."""

import os
import sys

import pytest

import simdutf_tpu as su

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


@pytest.fixture(autouse=True)
def _xla():
    su.set_active_implementation("xla")
    yield
    su.set_active_implementation("fallback")


def test_phase_device_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU backend"):
        cs.phase_device()


def test_phases_flagship_and_back():
    rec, outs = cs.phase_flagship(0.25)
    assert rec["bytes"] == len(outs["data"]) and len(rec["errors"]) == 2
    rec = cs.phase_back_to_utf8(outs)
    assert rec["surrogate_at"] > 0


def test_phase_base64():
    assert cs.phase_base64(0.05)["bytes"] == int(0.05 * cs.MIB)


def test_phase_batch_stream():
    rec = cs.phase_batch_stream(n_docs=64, max_len=2048, stream_mib=0.5,
                                chunk=65536)
    assert rec["docs"] == 64 and rec["invalid_docs"] >= 1


def test_phase_big():
    rec = cs.phase_big(0.3)
    assert rec["bucket"] >= rec["bytes"] + 8


def test_phase_ab():
    rec = cs.phase_ab(0.05, runs=1, sizes=(4096, 16384))
    assert set(rec["crossover"]) == {"validate_utf8",
                                     "convert_utf8_to_utf16le_with_errors"}


def test_phase_sharded():
    rec = cs.phase_sharded(4, 0.25)
    assert len(rec["placed_on"]) == 4


@pytest.mark.gpu
def test_phase_device_on_gpu(gpu_backend):
    """On the card, phase 1 accepts the backend and the xla tier."""
    from simdutf_tpu import registry

    registry._active = None  # let auto-selection pick the device tier
    rec = cs.phase_device()
    assert rec["backend"] == "gpu" and rec["implementation"] == "xla"
