"""The port's backward kernels' plain versions and autograd Functions
against the JAX package's Pallas backward kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
differentiates ``flash_attention`` / ``rmsnorm_pallas`` /
``layernorm_pallas`` with ``jax.vjp``, which runs the Pallas backward
kernels (``_dq_kernel``, ``_dkv_kernel``, ``_rms_bwd_kernel``,
``_ln_bwd_kernel``) in interpret mode.  Inputs are made with numpy from a
seed and handed to both.  ``test_torch_cuda.py`` holds the hand-written
CUDA / Triton kernels against these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from megatron_llm_tpu.kernels import flash_attention as jfa
from megatron_llm_tpu.kernels import rmsnorm as jrn
from megatron_llm_tpu_torch.kernels import flash_attention as tfa
from megatron_llm_tpu_torch.kernels import rmsnorm as trn

torch.set_num_threads(1)

# fp32 on both sides, the same function, sums in another order (the TPU
# kernels tile k/q blocks): a few fp32 ulps of O(1) values
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 inputs on both sides: both round dS to bf16 before dS·K and dSᵀ·Q
# and P before Pᵀ·dO, and each gradient once; one bf16 step of the result
# (2^-7 relative) plus, where a P or dS value rounds the other way (its
# fp32 value differs in the last bit), one bf16 step of that term (under
# 2^-8 absolute for these O(1) inputs)
BF16_PALLAS_TOL = dict(rtol=2 ** -7, atol=2 ** -8)


def _np(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _segments(rng, b, s, segs=True):
    """Packed sequences at random boundaries, or with ``segs="pad"`` the
    encoders' pad segments: content in segment 1, a tail of pads (none
    to half the row) in segment 0."""
    if segs == "pad":
        lens = rng.integers(s - s // 2, s + 1, b)
        return (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)
    cuts = np.sort(rng.integers(1, s, (b, 2)), axis=1)
    return (np.arange(s)[None, :, None] >= cuts[:, None, :]).sum(-1).astype(
        np.int32)


# ---------------------------------------------------------------------------
# K2 / K3 flash-attention backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,sq,sk,hq,hk,d,causal,segs", [
    (2, 64, 64, 4, 4, 64, True, False),      # square causal
    (2, 64, 64, 4, 4, 64, False, False),     # not causal
    (1, 40, 100, 4, 2, 64, True, False),     # causal, sq < sk, GQA, ragged
    (2, 96, 96, 8, 2, 128, True, True),      # segment ids, GQA, d 128
    (1, 33, 77, 2, 1, 64, False, False),     # ragged, not causal, MQA
    (1, 130, 130, 4, 1, 64, True, True),     # past one 128 tile, segments
    (3, 96, 96, 4, 4, 64, False, "pad"),     # an encoder: pad segments
])
def test_flash_attention_bwd_plain_matches_pallas(b, sq, sk, hq, hk, d,
                                                  causal, segs):
    rng = np.random.default_rng(10)
    q, k, v = (_np(rng, (b, sq, hq, d)), _np(rng, (b, sk, hk, d)),
               _np(rng, (b, sk, hk, d)))
    do = _np(rng, (b, sq, hq, d))
    seg = _segments(rng, b, sq, segs) if segs else None

    def jax_attn(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal,
                                   segment_ids=seg, interpret=True)

    o_jax, vjp = jax.vjp(jax_attn, jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
    want = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal,
                                     segment_ids=tseg)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), **FP32_TOL)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                                  segment_ids=tseg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("b,sq,sk,hq,hk,d,causal,segs", [
    (2, 64, 64, 4, 4, 64, True, False),      # square causal
    (1, 40, 100, 4, 2, 64, True, False),     # causal, sq < sk, GQA, ragged
    (2, 96, 96, 8, 2, 128, True, True),      # segment ids, GQA, d 128
    (1, 33, 77, 2, 1, 64, False, False),     # ragged, not causal, MQA
    (3, 96, 96, 4, 4, 64, False, "pad"),     # an encoder: pad segments
])
def test_flash_attention_bwd_plain_bf16_matches_pallas(b, sq, sk, hq, hk, d,
                                                       causal, segs):
    """bf16 inputs on both sides: the plain backward rounds P and dS where
    the Pallas kernels do."""
    rng = np.random.default_rng(14)
    q, k, v, do = (_np(rng, s).astype(ml_dtypes.bfloat16) for s in
                   ((b, sq, hq, d), (b, sk, hk, d), (b, sk, hk, d),
                    (b, sq, hq, d)))
    seg = _segments(rng, b, sq, segs) if segs else None

    def jax_attn(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=causal,
                                   segment_ids=seg, interpret=True)

    _, vjp = jax.vjp(jax_attn, jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a.view(np.int16).copy()).view(
        torch.bfloat16) for a in (q, k, v, do))
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = tfa.flash_attention_fwd(tq, tk, tv, causal=causal,
                                     segment_ids=tseg)
    got = tfa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                                  segment_ids=tseg)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   **BF16_PALLAS_TOL, err_msg=name)


def test_flash_attention_bwd_rows_without_keys_get_zero_dq():
    """A causal query row with no key at or before it (sq > sk) has lse =
    -1e30 and gets dQ = 0, not inf or NaN."""
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(_np(rng, s)) for s in
                   ((1, 20, 2, 64), (1, 8, 2, 64), (1, 8, 2, 64),
                    (1, 20, 2, 64)))
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert (lse[:, :, :12] == tfa.NO_KEY_LSE).all()
    dq, dk, dv = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
    assert not dq[:, :12].any()


@pytest.mark.parametrize("causal,kind", [(True, "seq"), (False, "pad")])
def test_accuracy_probe_float64_backward_and_segments(causal, kind):
    """The float64 witness of ``attention_accuracy_probe`` (and of the
    card smoke's backward checks), a batch row at a time, equals the
    plain backward of the whole batch in float64 (atol 1e-12: the same
    sums); its packed rows rise 0..3, its pad rows are content (1) then a
    tail of pads (0), row 0 unpadded."""
    from megatron_llm_tpu_torch.kernels import attention_accuracy_probe as ap

    b, s, h, d = 3, 40, 2, 16
    gen = torch.Generator().manual_seed(0)
    if kind == "seq":
        seg = ap.packed_segments(b, s, gen, "cpu")
        assert (seg[:, 0] == 0).all() and (seg.diff(dim=1) >= 0).all()
        assert (seg.max(dim=1).values <= 3).all()
    else:
        seg = ap.pad_segments(b, s, gen, "cpu", s // 2)
        assert (seg[0] == 1).all() and (seg.diff(dim=1) <= 0).all()
        assert (seg.sum(dim=1) >= s - s // 2).all()
    assert seg.dtype == torch.int32 and seg.is_contiguous()
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen)
                   for _ in range(4))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal,
                                       segment_ids=seg)
    got = ap.f64_bwd(q, k, v, o, lse, do, causal, seg)
    want = tfa.flash_attention_bwd_plain(
        *(t.double() for t in (q, k, v, o, lse, do)), causal=causal,
        segment_ids=seg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("b,hk,sk,group,sms,want", [
    (1, 32, 4096, 1, 132, 1),     # Llama-2-7B training: 2048 blocks
    (1, 8, 4096, 4, 132, 1),      # GQA: 512 blocks
    (1, 1, 2048, 71, 132, 16),    # Falcon-7B: 32 blocks, capped at 16
    (1, 1, 256, 8, 132, 8),       # 4 blocks, capped at the group
    (1, 4, 256, 1, 132, 1),       # MHA: a split needs a second head
    (2, 66, 128, 2, 132, 1),      # 264 blocks: two a SM already
    (1, 131, 128, 4, 132, 3),     # 262 blocks: ceil(528 / 262)
    (1, 1, 2048, 71, 20, 3),      # a smaller card: ceil(80 / 32)
])
def test_dkv_splits(b, hk, sk, group, sms, want):
    """How many blocks share each K3 block's walk: none where the grid
    already fills two blocks a SM, else towards four a SM, at most one a
    head of the group and at most 16."""
    assert tfa._dkv_splits(b, hk, sk, group, sms) == want


@pytest.mark.parametrize("causal,segs,hk", [(True, False, 2),
                                            (False, False, 1),
                                            (True, True, 2)])
def test_flash_attention_function_gradcheck(causal, segs, hk):
    """The autograd Function (plain forward and plain backward on CPU
    tensors) against finite differences, in fp64."""
    gen = torch.Generator().manual_seed(12)
    q = torch.randn(1, 7, 2, 64, generator=gen, dtype=torch.float64)
    k = torch.randn(1, 7, hk, 64, generator=gen, dtype=torch.float64)
    v = torch.randn(1, 7, hk, 64, generator=gen, dtype=torch.float64)
    seg = torch.tensor([[0, 0, 0, 1, 1, 2, 2]]) if segs else None
    inputs = tuple(t.requires_grad_(True) for t in (q, k, v))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: tfa.flash_attention(q_, k_, v_, causal=causal,
                                               segment_ids=seg),
        inputs, eps=1e-6, atol=1e-6, rtol=1e-5)


def test_flash_attention_function_matches_autograd_of_plain_forward():
    """Backward of the Function equals torch autograd through the plain
    forward, in fp32."""
    rng = np.random.default_rng(13)
    leaves = [torch.from_numpy(_np(rng, s)).requires_grad_(True)
              for s in ((2, 24, 4, 64), (2, 30, 2, 64), (2, 30, 2, 64))]
    do = torch.from_numpy(_np(rng, (2, 24, 4, 64)))
    got = torch.autograd.grad(tfa.flash_attention(*leaves, causal=True),
                              leaves, do)
    want = torch.autograd.grad(
        tfa.flash_attention_plain(*leaves, causal=True)[0], leaves, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **FP32_TOL)


def test_backward_kernel_wrappers_refuse_cpu_tensors():
    """The counted kernel wrappers launch or raise: a CPU tensor is
    refused, not run through the plain version."""
    q = torch.zeros(1, 64, 2, 64)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dq(q, q, q, q, lse, lse)
    with pytest.raises(ValueError):
        tfa.flash_attention_bwd_dkv(q, q, q, q, lse, lse)


# ---------------------------------------------------------------------------
# K5 RMSNorm backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 5, 64), (7, 128), (2, 300, 256)])
def test_rmsnorm_bwd_plain_matches_pallas(shape):
    rng = np.random.default_rng(14)
    x = _np(rng, shape)
    w = (1.0 + 0.1 * _np(rng, shape[-1:])).astype(np.float32)
    dy = _np(rng, shape)
    y_jax, vjp = jax.vjp(
        lambda x_, w_: jrn.rmsnorm_pallas(x_, w_, 1e-5, True),
        jnp.asarray(x), jnp.asarray(w))
    dx_want, dw_want = vjp(jnp.asarray(dy))
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    y, rstd = trn.rmsnorm_fwd(tx, tw, 1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **FP32_TOL)
    dx, dw = trn.rmsnorm_bwd(tx, tw, rstd, tdy)
    assert dx.shape == x.shape and dw.shape == w.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_want), **FP32_TOL)
    # dw sums dy * x̂ over all rows: a longer fp32 sum
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_want), rtol=1e-5,
                               atol=1e-4)


def test_rmsnorm_bwd_bf16_dweight_in_weight_dtype():
    rng = np.random.default_rng(15)
    x = torch.from_numpy(_np(rng, (6, 64))).to(torch.bfloat16)
    w = torch.from_numpy(1.0 + 0.1 * _np(rng, (64,))).to(torch.bfloat16)
    dy = torch.from_numpy(_np(rng, (6, 64))).to(torch.bfloat16)
    _, rstd = trn.rmsnorm_fwd(x, w)
    dx, dw = trn.rmsnorm_bwd(x, w, rstd, dy)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16
    dx32, dw32 = trn.rmsnorm_bwd(x.float(), w.float(), rstd, dy.float())
    torch.testing.assert_close(dx.float(), dx32, rtol=2 ** -7, atol=1e-2)
    torch.testing.assert_close(dw.float(), dw32, rtol=2 ** -7, atol=1e-2)


def test_rmsnorm_function_gradcheck():
    gen = torch.Generator().manual_seed(16)
    x = torch.randn(3, 4, 16, generator=gen, dtype=torch.float64)
    w = 1.0 + 0.1 * torch.randn(16, generator=gen, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda x_, w_: trn.rmsnorm(x_, w_, 1e-5),
        (x.requires_grad_(True), w.requires_grad_(True)), eps=1e-6,
        atol=1e-6, rtol=1e-5)


def test_rmsnorm_function_matches_autograd_of_plain_forward():
    rng = np.random.default_rng(17)
    x = torch.from_numpy(_np(rng, (5, 9, 128))).requires_grad_(True)
    w = torch.from_numpy(1.0 + 0.1 * _np(rng, (128,))).requires_grad_(True)
    dy = torch.from_numpy(_np(rng, (5, 9, 128)))
    got = torch.autograd.grad(trn.rmsnorm(x, w), (x, w), dy)
    want = torch.autograd.grad(trn.rmsnorm_plain(x, w)[0], (x, w), dy)
    torch.testing.assert_close(got[0], want[0], **FP32_TOL)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rows,sms", [
    (1, 132),        # under one program
    (7, 132),
    (528, 132),      # one row a program, exactly
    (529, 132),      # two rows a program, the last one short
    (1001, 132),
    (4096, 132),     # Llama-2-7B's training rows (micro batch 1, seq 4096)
    (2048, 132),     # Falcon-7B's (seq 2048)
    (4097, 132),
    (4096, 114),     # an H100 PCIe
    (8192, 1),
    (10000, 8),
])
def test_bwd_rows_per_program_covers_every_row_once(rows, sms):
    per = trn._bwd_rows_per_program(rows, sms)
    programs = -(-rows // per)
    assert per >= 1 and programs <= max(1, trn._BWD_PROGRAMS_PER_SM * sms)
    seen = np.zeros(rows, np.int64)
    for p in range(programs):   # the kernel's program p
        start, end = p * per, min(p * per + per, rows)
        assert start < end      # no program is empty
        seen[start:end] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,per,x_dtype", [
    ((300, 256), 7, np.float32),      # the last program's 6 rows run short
    ((3, 5, 64), 4, np.float32),
    ((2, 300, 256), 1, np.float32),
    ((1, 64), 8, np.float32),         # rows under one program
    ((300, 256), 7, ml_dtypes.bfloat16),
    ((37, 128), 16, ml_dtypes.bfloat16),
])
def test_rmsnorm_dweight_two_stage_matches_pallas(shape, per, x_dtype):
    """K5's dweight order (per row block, then over the blocks) in plain
    torch against JAX's dweight from ``jax.vjp`` of ``rmsnorm_pallas`` in
    interpret mode.  bf16 x and dy with an fp32 weight keep dweight in
    fp32, so both sides hold the tolerance of the fp32 test above."""
    rng = np.random.default_rng(21)
    x = _np(rng, shape).astype(x_dtype)
    w = (1.0 + 0.1 * _np(rng, shape[-1:])).astype(np.float32)
    dy = _np(rng, shape).astype(x_dtype)
    _, vjp = jax.vjp(lambda x_, w_: jrn.rmsnorm_pallas(x_, w_, 1e-5, True),
                     jnp.asarray(x), jnp.asarray(w))
    _, dw_want = vjp(jnp.asarray(dy))
    tx, tdy = (torch.from_numpy(a.astype(np.float32)) for a in (x, dy))
    _, rstd = trn.rmsnorm_fwd(tx, torch.from_numpy(w), 1e-5)
    h = shape[-1]
    got = trn._two_stage_sum_plain((tdy * tx * rstd).reshape(-1, h), per)
    assert got.dtype == torch.float32 and got.shape == (h,)
    np.testing.assert_allclose(got.numpy(), np.asarray(dw_want), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# K7 LayerNorm backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,bias", [((5, 72), True), ((5, 72), False),
                                        ((3, 7, 72), True),
                                        ((2, 30, 256), False)])
def test_layernorm_bwd_plain_matches_pallas(shape, bias):
    rng = np.random.default_rng(18)
    x = 2.0 * _np(rng, shape) + 0.5
    w = (1.0 + 0.1 * _np(rng, shape[-1:])).astype(np.float32)
    b = (0.1 * _np(rng, shape[-1:])).astype(np.float32) if bias else None
    dy = _np(rng, shape)
    args = [jnp.asarray(x), jnp.asarray(w)] + ([jnp.asarray(b)] if bias
                                               else [])
    y_jax, vjp = jax.vjp(
        lambda x_, w_, *b_: jrn.layernorm_pallas(
            x_, w_, b_[0] if b_ else None, 1e-5, True), *args)
    want = vjp(jnp.asarray(dy))
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    tb = None if b is None else torch.from_numpy(b)
    y, mean, rstd = trn.layernorm_fwd(tx, tw, tb, 1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), **FP32_TOL)
    dx, dw, db = trn.layernorm_bwd(tx, tw, mean, rstd, tdy, has_bias=bias)
    assert dx.shape == x.shape and dw.shape == w.shape
    assert (db is None) == (not bias)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), **FP32_TOL)
    for got, w_ in zip((dw, db) if bias else (dw,), want[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), **FP32_TOL)


@pytest.mark.parametrize("shape,per,bias", [
    ((64, 144), 5, True),     # Falcon-like: a width off a power of two,
    ((64, 144), 5, False),    #   the last program's 4 rows run short
    ((2, 48, 128), 16, True),   # GPT-like rows, whole programs
    ((2, 48, 128), 16, False),
    ((3, 80), 8, True),       # rows fewer than one program
    ((3, 80), 8, False),
    ((7, 80), 1, True),       # rows fewer than the programs a card runs:
    ((7, 80), 1, False),      #   one row each
])
def test_layernorm_bwd_two_stage_matches_pallas(shape, per, bias):
    """K7's plain backward in the kernel's partition (dweight and dbias
    summed per block of ``per`` rows, then over the blocks in order)
    against JAX's gradients from ``jax.vjp`` of ``layernorm_pallas`` in
    interpret mode, fp32, at 1e-5."""
    rng = np.random.default_rng(22)
    x = 2.0 * _np(rng, shape) + 0.5
    w = (1.0 + 0.1 * _np(rng, shape[-1:])).astype(np.float32)
    b = (0.1 * _np(rng, shape[-1:])).astype(np.float32) if bias else None
    dy = _np(rng, shape)
    args = [jnp.asarray(x), jnp.asarray(w)] + ([jnp.asarray(b)] if bias
                                               else [])
    _, vjp = jax.vjp(
        lambda x_, w_, *b_: jrn.layernorm_pallas(
            x_, w_, b_[0] if b_ else None, 1e-5, True), *args)
    want = vjp(jnp.asarray(dy))
    tx, tw, tdy = (torch.from_numpy(a) for a in (x, w, dy))
    _, mean, rstd = trn.layernorm_fwd(
        tx, tw, None if b is None else torch.from_numpy(b), 1e-5)
    dx, dw, db = trn.layernorm_bwd_plain(tx, tw, mean, rstd, tdy,
                                         has_bias=bias, rows_per_program=per)
    assert (db is None) == (not bias)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), **FP32_TOL)
    for got, w_ in zip((dw, db) if bias else (dw,), want[1:]):
        assert got.dtype == torch.float32 and got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(w_), **FP32_TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_layernorm_function_gradcheck(bias):
    gen = torch.Generator().manual_seed(19)
    x = torch.randn(3, 4, 12, generator=gen, dtype=torch.float64)
    w = 1.0 + 0.1 * torch.randn(12, generator=gen, dtype=torch.float64)
    b = 0.1 * torch.randn(12, generator=gen, dtype=torch.float64)
    inputs = (x, w, b) if bias else (x, w)
    assert torch.autograd.gradcheck(
        lambda x_, w_, *b_: trn.layernorm(x_, w_, b_[0] if b_ else None,
                                          1e-5),
        tuple(t.requires_grad_(True) for t in inputs), eps=1e-6, atol=1e-6,
        rtol=1e-5)


def test_layernorm_function_matches_autograd_of_plain_forward():
    rng = np.random.default_rng(20)
    x = torch.from_numpy(_np(rng, (5, 9, 72))).requires_grad_(True)
    w = torch.from_numpy(1.0 + 0.1 * _np(rng, (72,))).requires_grad_(True)
    b = torch.from_numpy(0.1 * _np(rng, (72,))).requires_grad_(True)
    dy = torch.from_numpy(_np(rng, (5, 9, 72)))
    got = torch.autograd.grad(trn.layernorm(x, w, b), (x, w, b), dy)
    want = torch.autograd.grad(trn.layernorm_plain(x, w, b)[0], (x, w, b),
                               dy)
    torch.testing.assert_close(got[0], want[0], **FP32_TOL)
    for g, w_ in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-4)
