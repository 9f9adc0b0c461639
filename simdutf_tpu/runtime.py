"""Host runtime tuning: allocator behavior and pooled staging buffers.

Production concern, not a micro-optimization: on virtualized hosts
(Firecracker/balloon memory) first-touch page faults can run at ~10 MB/s,
so NumPy's default malloc->mmap->munmap cycle for large temporaries makes
every call re-fault its buffers. Two measures:

  * ``tune_host_allocator()``: glibc ``mallopt(M_MMAP_MAX, 0)`` +
    ``mallopt(M_TRIM_THRESHOLD, -1)`` so large blocks live on the sbrk heap
    and are never returned to the kernel — pages fault once per process.
  * ``staging_buffer()``: a per-thread pool of zeroed padding buffers
    reused across calls (the reference library is allocation-free
    — README.md:2343; this is the closest Python equivalent, and keeps the
    public API thread-safe like the reference).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_M_MMAP_MAX = -4
_M_TRIM_THRESHOLD = -1

_tuned = False
_attempted = False
_lock = threading.Lock()


def tune_host_allocator() -> bool:
    """Idempotent; returns True if tuning was applied (glibc only)."""
    global _tuned, _attempted
    with _lock:
        if _attempted:
            return _tuned
        try:
            libc = ctypes.CDLL("libc.so.6", use_errno=True)
            ok1 = libc.mallopt(_M_MMAP_MAX, 0)
            ok2 = libc.mallopt(_M_TRIM_THRESHOLD, -1)
            _tuned = bool(ok1 and ok2)
        except Exception:  # non-glibc platforms: harmless no-op
            _tuned = False
        finally:
            # cache the ATTEMPT either way: without this, every batch call
            # on non-glibc hosts repeats a failing dlopen under the lock
            _attempted = True
        return _tuned


_tls = threading.local()
_MAX_POOLED_BYTES = 1 << 31  # don't pool buffers above 2 GiB


def staging_buffer(
    shape: tuple, dtype, fill_len: int = 0, tag: str = ""
) -> np.ndarray:
    """A pooled zeroed buffer of (shape, dtype), reused per thread.

    The region [fill_len:] is guaranteed zero on return; the caller then
    writes [:fill_len]. ``tag`` isolates pool entries between callers with
    different layout invariants (e.g. leading-halo layouts) — two callers
    with the same shape but different dirty-region conventions MUST use
    different tags, or stale bytes leak between them. Callers must treat
    the buffer as borrowed until the next ``staging_buffer`` call with the
    same key on this thread (device_put / np copies happen immediately in
    all users).
    """
    pool = getattr(_tls, "pool", None)
    if pool is None:
        pool = _tls.pool = {}
    shape = tuple(int(s) for s in shape)
    dt = np.dtype(dtype)
    key = (tag, shape, dt.str)
    entry = pool.get(key)
    if entry is None:
        buf = np.zeros(shape, dtype=dt)
        if buf.nbytes <= _MAX_POOLED_BYTES:
            pool[key] = [buf, fill_len]
        return buf
    buf, watermark = entry
    # re-zero only the previously dirty region (pages already resident)
    if watermark > fill_len:
        buf.reshape(-1)[fill_len:watermark] = 0
    entry[1] = fill_len
    return buf


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory and
    return it. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
    itself and nothing is set here; otherwise the cache lives in
    ``.jax_cache`` at the root of the checkout. Call before compiling."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
