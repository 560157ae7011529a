"""W8A8 int8 training matmuls (``ops/quant.int8_training_matmul``,
``quantize_matmuls="int8"``) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
codes, scales and the int32 product are JAX's bit for bit (the same fp32
divisions, round half to even, an exact integer sum); the forward's
epilogue and the backward's dense products are fp32 and agree to 1e-6
relative (the JAX test's limit).  Through a model, each package quantizes
its own activations, which differ by fp32 rounding, so a value next to a
rounding boundary may take the neighbouring code: the logits then agree
to 1e-4 (a code step is 1/127 of a row's largest value, and such a flip
moves one product of hundreds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.ops import quant as jquant
from megatron_llm_tpu.training import step as jstep
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.ops import quant as tquant
from megatron_llm_tpu_torch.training import step as tstep
from megatron_llm_tpu_torch.utils.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)


def _t(a):
    return params_from_jax(np.asarray(a), "cpu")


def _tiny(**kw):
    base = dict(params_dtype="float32", attention_impl="dot",
                recompute="none", seq_length=32, max_position_embeddings=32)
    base.update(kw)
    return base


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shape", [(4, 16, 64), (1, 3, 40), (8, 32)])
def test_operands_and_int32_product_bitwise_equal_jax(shape, dtype):
    """qx, sx, qw["q"], qw["scale"] and the int32 product equal JAX's bit
    for bit, a zero row (scale 1) included; the plain product too."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x[(0,) * (len(shape) - 1)] = 0.0
    w = rng.standard_normal((shape[-1], 24)).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    j_qx, j_sx, j_qw = jquant._int8_operands(jx, jw)
    t_qx, t_sx, t_qw = tquant._int8_operands(_t(jx), _t(jw))
    for got, want in ((t_qx, j_qx), (t_sx, j_sx), (t_qw["q"], j_qw["q"]),
                      (t_qw["scale"], j_qw["scale"])):
        assert torch.equal(got, _t(want))
    j_y = jax.lax.dot_general(j_qx, j_qw["q"],
                              (((j_qx.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    k = shape[-1]
    t_y = tquant.int32_product(t_qx.reshape(-1, k), t_qw["q"])
    assert torch.equal(t_y, _t(j_y).reshape(-1, 24))
    assert torch.equal(tquant.int32_product_plain(t_qx.reshape(-1, k),
                                                  t_qw["q"]), t_y)


def test_int32_product_exact_at_the_widest_contraction():
    """Every code at +-127 along k = 11008 (Llama-2-7B's MLP width): the
    int32 sums reach 1.8e8, exact in both products."""
    k = 11008
    a = torch.full((3, k), 127, dtype=torch.int8)
    a[1] = -127
    b = torch.full((k, 8), -127, dtype=torch.int8)
    want = torch.tensor([-127 * 127 * k, 127 * 127 * k, -127 * 127 * k],
                        dtype=torch.int32)[:, None].expand(3, 8)
    assert torch.equal(tquant.int32_product(a, b), want)
    assert torch.equal(tquant.int32_product_plain(a, b), want)


def test_forward_and_grads_match_jax():
    """The JAX test's shapes: the forward at 1e-6 relative to JAX's; dx and
    dw equal JAX's and the dense formulas on the dequantized operands at
    1e-6, and track the dense grads within quantization error (2%)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    w = rng.standard_normal((32, 24)).astype(np.float32)
    g = rng.standard_normal((8, 24)).astype(np.float32)

    def f_q(a, b):
        return jnp.sum(jquant.int8_training_matmul(a, b) * g)

    j_y = jquant.int8_training_matmul(jnp.asarray(x), jnp.asarray(w))
    j_dx, j_dw = jax.grad(f_q, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    t_y = tquant.int8_training_matmul(tx, tw)
    t_dx, t_dw = torch.autograd.grad(t_y, (tx, tw), torch.from_numpy(g))
    np.testing.assert_allclose(t_y.detach().numpy(), np.asarray(j_y),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t_dx.numpy(), np.asarray(j_dx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(t_dw.numpy(), np.asarray(j_dw), rtol=1e-6,
                               atol=1e-6)
    qx, sx = tquant._int8_rowwise(torch.from_numpy(x))
    wd = tquant.dequantize_weight(tquant.quantize_weight(
        torch.from_numpy(w)))
    xd = qx.float() * sx
    tg = torch.from_numpy(g)
    torch.testing.assert_close(t_dx, tg @ wd.T, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(t_dw, xd.T @ tg, rtol=1e-6, atol=1e-6)
    dense_dx, dense_dw = tg @ torch.from_numpy(w).T, \
        torch.from_numpy(x).T @ tg
    assert float((t_dx - dense_dx).abs().max()) \
        / float(dense_dx.abs().max()) < 0.02
    assert float((t_dw - dense_dw).abs().max()) \
        / float(dense_dw.abs().max()) < 0.02


def test_frozen_weight_takes_no_weight_gradient():
    """A weight that does not require grad (a frozen LoRA base) skips the
    dw product; dx is the same."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    xa = x.clone().requires_grad_(True)
    (dx_frozen,) = torch.autograd.grad(
        tquant.int8_training_matmul(xa, w).sum(), xa)
    xb = x.clone().requires_grad_(True)
    wb = w.clone().requires_grad_(True)
    dx, _ = torch.autograd.grad(
        tquant.int8_training_matmul(xb, wb).sum(), (xb, wb))
    assert torch.equal(dx_frozen, dx)


def _models(**kw):
    jc = jtiny(**_tiny(**kw))
    jp = jm.init_params(jax.random.key(0), jc)
    tc = ttiny(**_tiny(**kw))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jc, jp, tc, tp


def test_int8_logits_match_jax_and_drift_under_a_tenth():
    """A model with ``quantize_matmuls="int8"``: logits against JAX's int8
    model at 1e-4 (module docstring), and against the port's fp32 model
    an average |Δlogit| under 0.1 (the JAX test's limit, the reference's
    fp16 verify tolerance)."""
    jc, jp, tc, tp = _models()
    jq, tq = (dataclasses.replace(c, quantize_matmuls="int8")
              for c in (jc, tc))
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, (2, 32))
    j_q = np.asarray(jm.forward(jq, jp, jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        t_q = tm.forward(tq, tp, torch.from_numpy(toks)).numpy()
        t_ref = tm.forward(tc, tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(t_q, j_q, rtol=1e-4, atol=1e-4)
    assert float(np.abs(t_q - t_ref).mean()) < 0.1


def _cfgs(lr=1e-2, **model_kw):
    opt = dict(lr=lr, clip_grad=1.0)
    train = dict(train_iters=10, micro_batch_size=2, global_batch_size=2,
                 seq_length=32)
    jc = JRun(model=jtiny(**_tiny(quantize_matmuls="int8", **model_kw)),
              parallel=JPar(), optimizer=JOpt(**opt),
              train=JTrain(**train)).validate()
    tc = TRun(model=ttiny(**_tiny(quantize_matmuls="int8", **model_kw)),
              optimizer=TOpt(**opt), train=TTrain(**train)).validate()
    return jc, tc


def _batch(vocab, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (1, 2, 32))
    return {"tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, -1).astype(np.int32),
            "loss_mask": np.ones((1, 2, 32), np.float32)}


def test_int8_train_steps_match_jax():
    """Four fp32 steps with int8 matmuls from JAX's weights: the losses
    against JAX's ``make_train_step`` at 1e-4 (module docstring).  At lr
    1e-3: at the 1e-2 of the training test below the loss swings by 0.6 a
    step, and the code flips of one step grow the next steps' gap to
    3e-4."""
    jc, tc = _cfgs(lr=1e-3)
    jp = jm.init_params(jax.random.key(0), jc.model)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jstate, tstate = jstep.init_train_state(jc, jp), \
        tstep.init_train_state(tc, tp)
    jfn, tfn = jstep.make_train_step(jc), tstep.make_train_step(tc, "cpu")
    batch = _batch(tc.model.vocab_size)
    for _ in range(4):
        jstate, jm_ = jfn(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()}, None)
        tstate, tm_ = tfn(tstate, tstep.to_device_batch(batch, "cpu"))
        assert float(tm_["loss"]) == pytest.approx(float(jm_["loss"]),
                                                   rel=1e-4, abs=1e-4)


def test_int8_train_step_trains():
    """The JAX test's run: bf16 params with int8 matmuls, 8 steps on one
    batch: finite losses that fall, and fp32 masters under the params."""
    _, tc = _cfgs(params_dtype="bfloat16")
    params = tm.init_params(tc.model, seed=0, device="cpu")
    state = tstep.init_train_state(tc, params)
    assert state.opt.master is not None
    step = tstep.make_train_step(tc, "cpu")
    batch = tstep.to_device_batch(_batch(tc.model.vocab_size), "cpu")
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


class _CountIntMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._int_mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("recompute", ["none", "selective", "full"])
def test_recompute_policies_save_the_int8_products(recompute):
    """Every policy gives the same grads, bit for bit; the selective
    policy keeps the int32 products and the int8 operands as JAX keeps
    them (the dot, a ``custom_vjp``'s residuals), so its backward
    recomputes no int8 product, and full recompute redoes each."""
    tc = ttiny(**_tiny(quantize_matmuls="int8", recompute=recompute))
    params = tm.init_params(tc, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab_size, (2, 16)))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    out = tm.forward(tc, tree_unflatten(params, leaves), toks)
    count = _CountIntMM()
    with count:
        grads = torch.autograd.grad(out.square().mean(), leaves)
    n_proj = 7 * tc.num_layers          # q, k, v, o, gate, up, down
    assert count.n == {"none": 0, "selective": 0, "full": n_proj}[recompute]
    base = ttiny(**_tiny(quantize_matmuls="int8", recompute="none"))
    leaves0 = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    out0 = tm.forward(base, tree_unflatten(params, leaves0), toks)
    for a, b in zip(grads, torch.autograd.grad(out0.square().mean(),
                                               leaves0)):
        assert torch.equal(a, b)
