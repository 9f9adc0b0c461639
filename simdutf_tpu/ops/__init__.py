"""XLA tier: jit-safe jax.numpy implementations of every algorithm.

These are the device-native building blocks (static shapes, scalar lengths,
mask algebra, classify -> exclusive-prefix-scan -> scatter) that XLA lowers
for the GPU (or the CPU in tests). JAX users can call them directly inside jit on device
arrays; the host API reaches them through ops.impl.XLAImplementation.
"""

from . import common, utf8, utf16, utf32, latin1, base64_ops  # noqa: F401
