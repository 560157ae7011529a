"""The int8 and paged decode kernels' plain versions (K9, K10, K11) against
the JAX package's Pallas kernels in interpret mode, and the port's
``paged_decode_attention`` against JAX's, on the CPU.

Shapes are ``[b=3, nq 8, kv 2, max_len 512, d 128]``; pools are shuffled
(block ids 1..b*T in random order), table entries past a row's fill point
at the trash block 0, and the trash block holds large finite garbage that
must never reach an output.  ``test_torch_cuda.py`` holds the CUDA kernels
against these plain versions, and K10/K11 against K8/K9 bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.kernels import flash_decode as jfd
from megatron_llm_tpu.ops import attention as jattn
from megatron_llm_tpu_torch.kernels import flash_decode as tfd
from megatron_llm_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

B, NQ, KV, MAX_LEN, D = 3, 8, 2, 512, 128
# fp32 on both sides: the same function, the TPU kernel's softmax tiled
# online and the plain version's whole; sums in another order
TOL = dict(rtol=1e-5, atol=1e-5)


def _q(rng):
    return rng.normal(size=(B, NQ, D)).astype(np.float32)


def _int8_cache(rng, shape):
    """int8 codes and row scales whose dequantized values are O(1), as
    the fp32 caches' are (|q * scale| <= 1.5)."""
    q = rng.integers(-127, 128, shape).astype(np.int8)
    scale = rng.uniform(0.002, 0.012, shape[:-1]).astype(np.float32)
    return q, scale


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _check(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("lens", [[1, 128, 512], [97, 1, 300]])
def test_flash_decode_int8_plain_matches_pallas(lens):
    rng = np.random.default_rng(0)
    q = _q(rng)
    kq, ks = _int8_cache(rng, (B, KV, MAX_LEN, D))
    vq, vs = _int8_cache(rng, (B, KV, MAX_LEN, D))
    cl = np.asarray(lens, np.int32)
    want = jfd.flash_decode_int8(*(jnp.asarray(a) for a in
                                   (q, kq, ks, vq, vs, cl)), interpret=True)
    got = tfd.flash_decode_int8(*(_t(a) for a in (q, kq, ks, vq, vs, cl)))
    _check(got, want)


def _tables(rng, lens, n_tbl):
    """Shuffled live blocks; entries past each row's fill at trash 0."""
    block = MAX_LEN // n_tbl
    tables = (rng.permutation(B * n_tbl) + 1).reshape(B, n_tbl)
    for i, n in enumerate(lens):
        tables[i, -(-n // block):] = 0
    return tables.astype(np.int32)


def _pool(dense, tables, garbage):
    """Dense ``[b, kv, max_len(, d)]`` leaves scattered into pool blocks
    at the tables' ids; the trash block (and unused ids) hold garbage."""
    n_tbl = tables.shape[1]
    block = dense.shape[2] // n_tbl
    pool = np.full((1 + B * n_tbl, KV, block) + dense.shape[3:], garbage,
                   dense.dtype)
    for bi in range(B):
        for j in range(n_tbl):
            if tables[bi, j]:
                pool[tables[bi, j]] = dense[bi, :, j * block:(j + 1) * block]
    return pool


LENS = [1, 128, 512]   # one row, a block boundary (block 128), full


@pytest.mark.parametrize("block", [64, 128])
def test_flash_decode_paged_plain_matches_pallas(block):
    rng = np.random.default_rng(1)
    q = _q(rng)
    k = rng.normal(size=(B, KV, MAX_LEN, D)).astype(np.float32)
    v = rng.normal(size=(B, KV, MAX_LEN, D)).astype(np.float32)
    tables = _tables(rng, LENS, MAX_LEN // block)
    kp, vp = _pool(k, tables, 1e4), _pool(v, tables, 1e4)
    cl = np.asarray(LENS, np.int32)
    want = jfd.flash_decode_paged(*(jnp.asarray(a) for a in
                                    (q, kp, vp, tables, cl)), interpret=True)
    got = tfd.flash_decode_paged(*(_t(a) for a in (q, kp, vp, tables, cl)))
    _check(got, want)
    # the plain version is K8's over the dense cache
    _check(got, tfd.flash_decode(*(_t(a) for a in (q, k, v, cl))))


@pytest.mark.parametrize("block", [64, 128])
def test_flash_decode_paged_int8_plain_matches_pallas(block):
    rng = np.random.default_rng(2)
    q = _q(rng)
    kq, ks = _int8_cache(rng, (B, KV, MAX_LEN, D))
    vq, vs = _int8_cache(rng, (B, KV, MAX_LEN, D))
    tables = _tables(rng, LENS, MAX_LEN // block)
    pools = [_pool(kq, tables, 127), _pool(ks, tables, 1e4),
             _pool(vq, tables, 127), _pool(vs, tables, 1e4)]
    cl = np.asarray(LENS, np.int32)
    want = jfd.flash_decode_paged_int8(
        *(jnp.asarray(a) for a in (q, *pools, tables, cl)), interpret=True)
    got = tfd.flash_decode_paged_int8(*(_t(a) for a in
                                        (q, *pools, tables, cl)))
    _check(got, want)
    _check(got, tfd.flash_decode_int8(*(_t(a) for a in
                                        (q, kq, ks, vq, vs, cl))))


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_attention_matches_jax(int8):
    """The op over one layer's pool, both pool forms, against JAX's gather
    route (the route both packages take off their kernels' devices)."""
    rng = np.random.default_rng(3)
    block = 64
    qd = rng.normal(size=(B, 1, NQ, D)).astype(np.float32)
    fills = np.asarray([0, 127, 300], np.int32)   # q's position; +1 rows
    tables = _tables(rng, list(fills + 1), MAX_LEN // block)
    if int8:
        kq, ks = _int8_cache(rng, (B, KV, MAX_LEN, D))
        vq, vs = _int8_cache(rng, (B, KV, MAX_LEN, D))
        jk = {"q": _pool(kq, tables, 127), "scale": _pool(ks, tables, 1e4)}
        jv = {"q": _pool(vq, tables, 127), "scale": _pool(vs, tables, 1e4)}
    else:
        jk = _pool(rng.normal(size=(B, KV, MAX_LEN, D)).astype(np.float32),
                   tables, 1e4)
        jv = _pool(rng.normal(size=(B, KV, MAX_LEN, D)).astype(np.float32),
                   tables, 1e4)

    def conv(tree, fn):
        return {k: fn(v) for k, v in tree.items()} if int8 else fn(tree)

    want = jattn.paged_decode_attention(
        jnp.asarray(qd), conv(jk, jnp.asarray), conv(jv, jnp.asarray),
        jnp.asarray(tables), jnp.asarray(fills))
    tk, tv = conv(jk, _t), conv(jv, _t)
    assert not tattn.paged_decode_kernel_eligible(_t(qd), tk)  # CPU tensors
    got = tattn.paged_decode_attention(_t(qd), tk, tv, _t(tables),
                                       _t(fills))
    assert got.shape == (B, 1, NQ, D)
    _check(got, want)


def test_int8_decode_attention_matches_jax():
    """The scale-folded einsum route of ``decode_attention`` (an int8 cache
    off the kernel), ragged fills and two new tokens a row."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(B, 2, NQ, D)).astype(np.float32)
    kq, ks = _int8_cache(rng, (B, KV, MAX_LEN, D))
    vq, vs = _int8_cache(rng, (B, KV, MAX_LEN, D))
    fills = np.asarray([3, 200, 509], np.int32)
    want = jattn.decode_attention(
        jnp.asarray(q), {"q": jnp.asarray(kq), "scale": jnp.asarray(ks)},
        {"q": jnp.asarray(vq), "scale": jnp.asarray(vs)}, jnp.asarray(fills))
    tk = {"q": _t(kq), "scale": _t(ks)}
    assert not tattn.decode_kernel_eligible(_t(q[:, :1]), tk)
    got = tattn.decode_attention(_t(q), tk, {"q": _t(vq), "scale": _t(vs)},
                                 _t(fills))
    _check(got, want)
