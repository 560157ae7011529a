"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode (K1, K4, K6 and K8 here; the
backward kernels in ``test_torch_train_kernels.py``).  Inputs are made with numpy from
a seed and handed to both.  ``test_torch_cuda.py`` holds the hand-written
kernels against these plain versions on the card.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from megatron_llm_tpu.kernels import flash_attention as jfa
from megatron_llm_tpu.kernels import flash_decode as jfd
from megatron_llm_tpu.kernels import rmsnorm as jrn
from megatron_llm_tpu_torch.kernels import flash_attention as tfa
from megatron_llm_tpu_torch.kernels import flash_decode as tfd
from megatron_llm_tpu_torch.kernels import rmsnorm as trn

torch.set_num_threads(1)

# fp32 on both sides, same math, different summation order (and the TPU
# kernel's tiled online softmax): a few fp32 ulps of O(1) values
FP32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 inputs against the fp32 reference: bf16 operands and P rounded to
# bf16 before P@V put the result ~2^-8 relative from the fp32 function
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# bf16 inputs on both sides: both round P to bf16 before P@V (and dS / P
# before the backward's products) and the result once; they differ by one
# bf16 step of the result (2^-7 relative) and, where a P or dS value rounds
# the other way (its exp or sum differs in the last fp32 bit), by one bf16
# step of that term (under 2^-8 absolute for these O(1) inputs).  The JAX
# kernel's per-tile running max, which decides which value of P is
# rounded, is the global max here: these shapes fit one JAX key tile.
BF16_PALLAS_TOL = dict(rtol=2 ** -7, atol=2 ** -8)


def _np(rng, shape, dtype=np.float32):
    return rng.normal(size=shape).astype(dtype)


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# K1 flash-attention forward
# ---------------------------------------------------------------------------


def _jax_flash_fwd(q, k, v, *, causal, segment_ids=None):
    """(O [b, sq, hq, d], lse [b, hq, sq]) from the Pallas forward kernel in
    interpret mode, through the same padding/transposition as
    ``flash_attention`` (whose public wrapper returns O only)."""
    b, sq, hq, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    bq = min(1024, max(128, 1 << (sq - 1).bit_length()))
    bk = min(1024, max(128, 1 << (sk - 1).bit_length()))
    sq_p, sk_p = -(-sq // bq) * bq, -(-sk // bk) * bk
    cfg = jfa._Config(causal=causal, scale=float(1 / np.sqrt(d)), block_q=bq,
                      block_k=bk, group=hq // hk, kv_len=sk, q_len=sq,
                      use_segs=segment_ids is not None, interpret=True)
    qt = jfa._pad_to(jnp.transpose(jnp.asarray(q), (0, 2, 1, 3)), sq_p, 2)
    kt = jfa._pad_to(jnp.transpose(jnp.asarray(k), (0, 2, 1, 3)), sk_p, 2)
    vt = jfa._pad_to(jnp.transpose(jnp.asarray(v), (0, 2, 1, 3)), sk_p, 2)
    if segment_ids is not None:
        seg = jnp.asarray(segment_ids, jnp.int32)
        q_seg = jfa._pad_to(seg, sq_p, 1)[:, None, :]
        k_seg = jfa._pad_to(seg, sk_p, 1)[:, None, :]
    else:
        q_seg = k_seg = jnp.zeros((1, 1, 1), jnp.int32)
    o, lse = jfa._fwd(cfg, qt, kt, vt, q_seg, k_seg)
    o = jnp.transpose(o[:, :, :sq], (0, 2, 1, 3))
    return np.asarray(o), np.asarray(lse[:, :, :sq, 0])


@pytest.mark.parametrize("b,sq,sk,hq,hk,d,causal,segs", [
    (2, 64, 64, 4, 4, 64, True, False),      # square causal
    (1, 40, 100, 4, 2, 64, True, False),     # causal with sq < sk, GQA
    (2, 96, 96, 8, 2, 128, True, True),      # segment ids, GQA, d=128
    (1, 33, 77, 2, 1, 64, False, False),     # ragged, not causal, MQA
    (3, 96, 96, 4, 4, 64, False, "pad"),     # an encoder: pad segments
])
def test_flash_attention_plain_matches_pallas(b, sq, sk, hq, hk, d, causal,
                                              segs):
    rng = np.random.default_rng(0)
    q, k, v = (_np(rng, (b, sq, hq, d)), _np(rng, (b, sk, hk, d)),
               _np(rng, (b, sk, hk, d)))
    seg = None
    if segs == "pad":  # content in segment 1, a tail of pads in 0
        lens = rng.integers(sq // 2, sq + 1, b)
        seg = (np.arange(sq)[None, :] < lens[:, None]).astype(np.int32)
    elif segs:
        cuts = np.sort(rng.integers(1, sq, (b, 2)), axis=1)
        seg = (np.arange(sq)[None, :, None] >= cuts[:, None, :]).sum(-1)
        seg = seg.astype(np.int32)
    o_want, lse_want = _jax_flash_fwd(q, k, v, causal=causal,
                                      segment_ids=seg)
    o, lse = tfa.flash_attention_fwd(
        _torch(q), _torch(k), _torch(v), causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(o.numpy(), o_want, **FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_want, **FP32_TOL)
    # the public wrapper agrees with the forward's O
    o_pub = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                segment_ids=seg, interpret=True)
    np.testing.assert_allclose(
        tfa.flash_attention(_torch(q), _torch(k), _torch(v), causal=causal,
                            segment_ids=None if seg is None
                            else torch.from_numpy(seg)).numpy(),
        np.asarray(o_pub), **FP32_TOL)


def test_flash_attention_bf16_against_fp32_reference():
    rng = np.random.default_rng(1)
    b, sq, sk, hq, hk, d = 1, 64, 128, 4, 2, 128
    q, k, v = (_np(rng, (b, sq, hq, d)), _np(rng, (b, sk, hk, d)),
               _np(rng, (b, sk, hk, d)))
    o_want, _ = _jax_flash_fwd(q, k, v, causal=True)       # fp32 reference
    qb, kb, vb = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    o_jax, _ = _jax_flash_fwd(qb, kb, vb, causal=True)
    o, lse = tfa.flash_attention_fwd(_torch(qb), _torch(kb), _torch(vb),
                                     causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(_f32(o), o_want, **BF16_TOL)
    np.testing.assert_allclose(_f32(o), _f32(o_jax), **BF16_PALLAS_TOL)


@pytest.mark.parametrize("b,sq,sk,hq,hk,d,causal,segs", [
    (1, 64, 128, 4, 2, 128, True, False),    # causal, sq < sk, GQA
    (2, 96, 96, 8, 2, 128, True, True),      # segment ids
    (1, 33, 77, 2, 1, 64, False, False),     # ragged, not causal, MQA
    (1, 20, 8, 2, 2, 64, True, False),       # rows that see no key
])
def test_flash_attention_plain_bf16_matches_pallas(b, sq, sk, hq, hk, d,
                                                   causal, segs):
    """bf16 inputs on both sides: the plain version rounds P where the
    Pallas kernel does, so O agrees to a bf16 step, lse to fp32 ulps."""
    rng = np.random.default_rng(2)
    q, k, v = (_np(rng, s).astype(ml_dtypes.bfloat16) for s in
               ((b, sq, hq, d), (b, sk, hk, d), (b, sk, hk, d)))
    seg = None
    if segs == "pad":  # content in segment 1, a tail of pads in 0
        lens = rng.integers(sq // 2, sq + 1, b)
        seg = (np.arange(sq)[None, :] < lens[:, None]).astype(np.int32)
    elif segs:
        cuts = np.sort(rng.integers(1, sq, (b, 2)), axis=1)
        seg = (np.arange(sq)[None, :, None] >= cuts[:, None, :]).sum(-1)
        seg = seg.astype(np.int32)
    o_jax, lse_jax = _jax_flash_fwd(q, k, v, causal=causal, segment_ids=seg)
    o, lse = tfa.flash_attention_fwd(
        _torch(q), _torch(k), _torch(v), causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert o.dtype == torch.bfloat16
    # a row that sees no key: the port's O is 0 and its lse -1e30; the JAX
    # kernel, whose mask is a finite -1e30, averages V there instead
    blind = max(0, sq - sk) if causal else 0
    assert not _f32(o)[:, :blind].any()
    assert (lse[:, :, :blind] == tfa.NO_KEY_LSE).all()
    np.testing.assert_allclose(_f32(o)[:, blind:], _f32(o_jax)[:, blind:],
                               **BF16_PALLAS_TOL)
    np.testing.assert_allclose(lse.numpy()[..., blind:],
                               lse_jax[..., blind:], **FP32_TOL)


# ---------------------------------------------------------------------------
# K8 flash decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("heads,kv_heads,d,lens", [
    (4, 4, 64, [17, 1]),          # plain
    (8, 2, 128, [100, 256]),      # GQA, full cache
    (4, 1, 64, [0, 31]),          # MQA, fill 0 (averages the whole cache)
    (4, 2, 128, [5, 200]),        # ragged per-row fills
])
def test_flash_decode_plain_matches_pallas(heads, kv_heads, d, lens):
    rng = np.random.default_rng(2)
    b, max_len = len(lens), 256
    q = _np(rng, (b, heads, d))
    k = _np(rng, (b, kv_heads, max_len, d))
    v = _np(rng, (b, kv_heads, max_len, d))
    lens = np.asarray(lens, np.int32)
    want = jfd.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), interpret=True)
    got = tfd.flash_decode(_torch(q), _torch(k), _torch(v),
                           torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_flash_decode_scalar_fill_and_bf16():
    rng = np.random.default_rng(3)
    b, heads, kv_heads, max_len, d = 2, 8, 4, 512, 128
    q = _np(rng, (b, heads, d))
    k = _np(rng, (b, kv_heads, max_len, d))
    v = _np(rng, (b, kv_heads, max_len, d))
    want = np.asarray(jfd.flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.int32(301),
                                       interpret=True))
    got = tfd.flash_decode(_torch(q), _torch(k), _torch(v), 301)
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)
    qb, kb, vb = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    got_b = tfd.flash_decode(_torch(qb), _torch(kb), _torch(vb), 301)
    jax_b = jfd.flash_decode(jnp.asarray(qb), jnp.asarray(kb),
                             jnp.asarray(vb), jnp.int32(301), interpret=True)
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got_b), want, **BF16_TOL)
    np.testing.assert_allclose(_f32(got_b), _f32(jax_b), **BF16_TOL)


# ---------------------------------------------------------------------------
# K4 RMSNorm forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [
    ((3, 5, 64), np.float32),
    ((7, 128), np.float32),
    ((4, 9, 256), ml_dtypes.bfloat16),
])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(4)
    x = _np(rng, shape).astype(dtype)
    w = (1.0 + 0.1 * _np(rng, shape[-1:])).astype(dtype)
    y_jax, res = jrn._rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-5, True)
    rows = int(np.prod(shape[:-1]))
    rstd_jax = np.asarray(res[2])[:rows]
    y, rstd = trn.rmsnorm_fwd(_torch(x), _torch(w), 1e-5)
    assert y.dtype == _torch(x).dtype and rstd.dtype == torch.float32
    assert tuple(rstd.shape) == shape[:-1] + (1,)
    # fp32: identical formula; bf16: both round the fp32 result once
    tol = FP32_TOL if dtype == np.float32 else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_f32(y), _f32(y_jax), **tol)
    np.testing.assert_allclose(rstd.numpy().reshape(rows, 1), rstd_jax,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        _f32(trn.rmsnorm(_torch(x), _torch(w), 1e-5)),
        _f32(jrn.rmsnorm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                True)), **tol)


# ---------------------------------------------------------------------------
# K6 LayerNorm forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,bias", [
    ((5, 72), True),          # hidden 72: not a power of two
    ((5, 72), False),
    ((3, 7, 72), True),       # ragged rows (21) over leading dims
    ((2, 9, 256), False),
])
def test_layernorm_plain_matches_pallas(shape, bias):
    rng = np.random.default_rng(5)
    x = 2.0 * _np(rng, shape) + 0.5          # rows with a nonzero mean
    w = 1.0 + 0.1 * _np(rng, shape[-1:])
    b = 0.1 * _np(rng, shape[-1:]) if bias else None
    jb = None if b is None else jnp.asarray(b)
    y_jax, res = jrn._ln_fwd(jnp.asarray(x), jnp.asarray(w), jb, 1e-5, True)
    rows = int(np.prod(shape[:-1]))
    tb = None if b is None else _torch(b)
    y, mean, rstd = trn.layernorm_fwd(_torch(x), _torch(w), tb, 1e-5)
    assert mean.dtype == rstd.dtype == torch.float32
    assert tuple(mean.shape) == tuple(rstd.shape) == shape[:-1] + (1,)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **FP32_TOL)
    for got, want in ((mean, res[2]), (rstd, res[3])):
        np.testing.assert_allclose(got.numpy().reshape(rows, 1),
                                   np.asarray(want)[:rows], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        trn.layernorm(_torch(x), _torch(w), tb, 1e-5).numpy(),
        np.asarray(jrn.layernorm_pallas(jnp.asarray(x), jnp.asarray(w), jb,
                                        1e-5, True)), **FP32_TOL)


def test_norm_wrappers_refuse_devices_they_do_not_run():
    """A CPU tensor takes the plain version; a tensor on any other device
    than CUDA is refused, not run through it."""
    x = torch.zeros(4, 64, device="meta")
    w = torch.ones(64, device="meta")
    stat = torch.zeros(4, 1, device="meta")
    with pytest.raises(ValueError):
        trn.layernorm_fwd(x, w, w)
    with pytest.raises(ValueError):
        trn.layernorm_bwd(x, w, stat, stat, x)
    with pytest.raises(ValueError):
        trn.rmsnorm_fwd(x, w)
