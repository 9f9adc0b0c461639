"""The ops tier composes inside user jit programs on device arrays —
the device-resident usage mode (data never leaves the device)."""

import jax
import jax.numpy as jnp
import numpy as np

import oracle
from simdutf_tpu.ops import utf8 as o8, utf16 as o16


def test_ops_compose_inside_user_jit():
    data = "héllo 日本 🙂 pipeline".encode()
    buf = np.zeros(1024, np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)

    @jax.jit
    def pipeline(b, n):
        # validate, transcode, then immediately consume the utf16 on device
        code, pos, u16, u16_len = o8.to_utf16(b, n, False)
        # downstream device work: count BMP units (no host round trip)
        idx = jnp.arange(u16.shape[0])
        bmp = jnp.sum(((u16 < 0xD800) | (u16 > 0xDFFF)) & (idx < u16_len))
        c2, p2 = o16.validate_with_errors(u16, u16_len, False)
        return code, u16_len, bmp, c2

    code, u16_len, bmp, c2 = pipeline(buf, jnp.int32(len(data)))
    expect = data.decode().encode("utf-16-le")
    assert int(code) == 0 and int(c2) == 0
    assert int(u16_len) * 2 == len(expect)
    # one astral char -> 2 surrogate units, rest BMP
    assert int(bmp) == len(expect) // 2 - 2


def test_ops_grad_safe_closure():
    # ops are pure functions: safe under vmap over a batch of buffers
    datas = [b"abc", b"d\xc3\xa9f", b"\xf0\x9f\x98\x80xy"]
    bufs = np.zeros((3, 64), np.uint8)
    lens = np.zeros(3, np.int32)
    for i, d in enumerate(datas):
        bufs[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)

    @jax.jit
    def batch_count(bufs, lens):
        return jax.vmap(o8.count_code_points)(bufs, lens)

    got = np.asarray(batch_count(bufs, lens))
    assert list(got) == [oracle.count_utf8(d) for d in datas]
