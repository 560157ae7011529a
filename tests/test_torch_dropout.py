"""Dropout, LIMA dropout and drop-path in the port against the JAX
package, fp32 on the CPU.

The port draws its masks from ``torch.Generator``s keyed by the same chain
of ``fold_in`` / ``split`` steps that builds JAX's keys, but not with
``jax.random``'s bits.  So the comparisons with JAX replace the port's one
mask-drawing function, ``ops.dropout.keep_mask``, with one that returns
the mask ``jax.random.bernoulli`` draws for the same key; everything
downstream of the masks is then compared.  The port's own masks are held
to what the design promises: rate 0 is the identity, and a recomputed
layer redraws exactly the forward's masks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.models import transformer as jtransformer
from megatron_llm_tpu.training import step as jstep
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.ops import dropout as tdrop
from megatron_llm_tpu_torch.training import step as tstep
from megatron_llm_tpu_torch.utils.tree import tree_leaves, tree_unflatten

torch.set_num_threads(1)

FALCON = dict(norm_type="layernorm", activation="gelu_exact",
              parallel_attn=True, num_kv_heads=1, tie_embed_logits=True)
GPT = dict(norm_type="layernorm", activation="gelu",
           position_embedding_type="absolute", use_bias=True,
           tie_embed_logits=True, num_kv_heads=None, vocab_size=250)
CASES = {
    # the parallel block's one branch mask (salt 2) and embedding dropout
    "falcon-hidden": dict(FALCON, hidden_dropout=0.1, norm_impl="pallas",
                          attention_impl="flash"),
    # the sequential block's two masks (salts 2, 3) and attention dropout,
    # which routes "flash" to the einsum path
    "gpt-hidden-attention": dict(GPT, hidden_dropout=0.1,
                                 attention_dropout=0.1, norm_impl="pallas",
                                 attention_impl="flash"),
    # LIMA's per-layer ramp and drop-path (salts 4, 5)
    "gpt-lima-drop-path": dict(GPT, hidden_dropout=0.2, lima_dropout=True,
                               drop_path_rate=0.3, num_layers=3),
    "llama-drop-path": dict(drop_path_rate=0.5, attention_dropout=0.2),
}
# fp32 on both sides; only the order of sums differs
TOL = dict(rtol=1e-5, atol=1e-5)


def grad_tol(want: np.ndarray) -> dict:
    """A gradient leaf's limit: fp32 noise scaled to the leaf.  Run in
    float64 (``test_forward_and_grads_match_jax_in_float64``) the two
    sides' gradients agree to ~1e-13 absolute on leaves of size up to ~70,
    so what parts them in fp32 is the order of sums: up to ~2.5e-5 on
    such a leaf, about fp32's epsilon times its size.  ``atol = 1e-5 *
    max|w|`` per leaf, never below ``TOL``'s 1e-5."""
    return dict(rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _jax_key(k: tdrop.DropoutKey):
    """JAX's key for the port's key: the same fold_in / split chain."""
    jk = jax.random.key(k.seed)
    for op, data in k.path:
        jk = (jax.random.fold_in(jk, data) if op == "fold"
              else jax.random.split(jk)[data])
    return jk


@pytest.fixture
def jax_masks(monkeypatch):
    """Route every port mask through ``jax.random.bernoulli``; returns the
    list of keys drawn."""
    drawn = []

    def keep_mask(k, keep_p, shape, device):
        drawn.append(k)
        m = jax.random.bernoulli(_jax_key(k), np.float32(keep_p),
                                 tuple(shape))
        return torch.from_numpy(np.array(m)).to(device)

    monkeypatch.setattr(tdrop, "keep_mask", keep_mask)
    return drawn


def _pair(model_kw):
    jc, tc = jtiny(**model_kw), ttiny(**model_kw)
    jp = jm.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _tokens(vocab, b=2, s=12, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax_with_its_masks(case, jax_masks):
    jc, jp, tc, tp = _pair(CASES[case])
    toks = _tokens(jc.vocab_size)
    proj = np.random.default_rng(1).normal(
        size=(2, 12, jc.padded_vocab_size())).astype(np.float32)

    def jloss(p):
        lg = jm.forward(jc, p, jnp.asarray(toks), rng=jax.random.key(7),
                        deterministic=False)
        return jnp.sum(lg * proj), lg

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    live = tree_unflatten(tp, leaves)
    got = tm.forward(tc, live, torch.from_numpy(toks).long(),
                     rng=tdrop.key(7))
    grads = torch.autograd.grad((got * torch.from_numpy(proj)).sum(), leaves)
    assert jax_masks, "no mask was drawn"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **grad_tol(np.asarray(w)))
    # and dropout did act: the deterministic forward differs
    plain = tm.forward(tc, tp, torch.from_numpy(toks).long())
    assert not torch.allclose(plain, got.detach(), atol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax_in_float64(case, monkeypatch):
    """The evidence for ``grad_tol``: the same comparison with both sides
    in float64 (``torch_float64.float64_everywhere``; JAX's masks drawn
    from float64 uniforms, as its own dropout does under x64) agrees to
    ~1e-13, so the port computes what JAX computes and the fp32 gaps are
    the order of sums."""
    from torch_float64 import as_float64, float64_everywhere

    def keep_mask(k, keep_p, shape, device):
        m = jax.random.bernoulli(_jax_key(k), float(keep_p), tuple(shape))
        return torch.from_numpy(np.array(m)).to(device)

    monkeypatch.setattr(tdrop, "keep_mask", keep_mask)
    jc, jp, tc, _ = _pair(CASES[case])
    jp = as_float64(jp)
    toks = _tokens(jc.vocab_size)
    proj = np.random.default_rng(1).normal(size=(2, 12,
                                                 jc.padded_vocab_size()))
    with float64_everywhere():
        jp = jax.tree.map(jnp.asarray, jp)
        tp = params_from_jax(as_float64(jp), device="cpu")

        def jloss(p):
            lg = jm.forward(jc, p, jnp.asarray(toks), rng=jax.random.key(7),
                            deterministic=False)
            return jnp.sum(lg * proj), lg

        (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
        leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
        got = tm.forward(tc, tree_unflatten(tp, leaves),
                         torch.from_numpy(toks).long(), rng=tdrop.key(7))
        grads = torch.autograd.grad((got * torch.from_numpy(proj)).sum(),
                                    leaves)
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-12)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def _train_cfgs(model_kw):
    opt = dict(lr=1e-3, lr_warmup_iters=1)
    train = dict(train_iters=10, micro_batch_size=2, global_batch_size=4,
                 seq_length=16, seed=11)
    jc = JRun(model=jtiny(**model_kw), parallel=JPar(),
              optimizer=JOpt(**opt), train=JTrain(**train)).validate()
    tc = TRun(model=ttiny(**model_kw), optimizer=TOpt(**opt),
              train=TTrain(**train)).validate()
    return jc, tc


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (2, 2, 16)).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1),
            "loss_mask": np.ones((2, 2, 16), np.float32)}


@pytest.mark.parametrize("case", ["falcon-hidden", "gpt-hidden-attention"])
def test_train_steps_thread_the_keys_as_jax(case, jax_masks):
    """Two steps, grad_accum 2, with ``pretrain``'s base key: the step folds
    in the iteration, then the microbatch, as JAX's step does."""
    model_kw = dict(CASES[case], recompute="selective")
    jc, tc = _train_cfgs(model_kw)
    jparams = jm.init_params(jax.random.key(0), jc.model)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jstate = jstep.init_train_state(jc, jparams)
    tstate = tstep.init_train_state(tc, tparams)
    jfn, tfn = jstep.make_train_step(jc), tstep.make_train_step(tc, "cpu")
    for i in range(2):
        batch = _batch(300 + i, jc.model.vocab_size)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.key(jc.train.seed))
        tstate, tmet = tfn(tstate, tstep.to_device_batch(batch, "cpu"),
                           tdrop.key(tc.train.seed))
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5, abs=1e-5)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-5)
    iters_mbs = {k.path[:2] for k in jax_masks}
    assert iters_mbs == {(("fold", it), ("fold", mb)) for it in range(2)
                         for mb in range(2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rate_zero_is_bitwise_no_key(case):
    kw = {k: v for k, v in CASES[case].items()
          if k not in ("hidden_dropout", "attention_dropout", "lima_dropout",
                       "drop_path_rate")}
    _, _, tc, tp = _pair(kw)
    toks = torch.from_numpy(_tokens(tc.vocab_size)).long()
    assert torch.equal(tm.forward(tc, tp, toks, rng=tdrop.key(3)),
                       tm.forward(tc, tp, toks))
    x = torch.randn(4, 8)
    assert tdrop.dropout(x, 0.0, tdrop.key(1)) is x
    assert tdrop.drop_path(x, 0.0, tdrop.key(1)) is x
    assert tdrop.dropout(x, 0.5, None) is x


@pytest.mark.parametrize("case", ["falcon-hidden", "gpt-hidden-attention",
                                  "gpt-lima-drop-path"])
def test_recompute_redraws_the_forwards_masks(case):
    """The port's own masks (no JAX): grads bitwise equal under the three
    recompute policies with dropout on, since a recomputed layer draws
    each mask again from the same key."""
    _, _, tc, tp = _pair(CASES[case])
    toks = torch.from_numpy(_tokens(tc.vocab_size, seed=2)).long()
    grads = {}
    for policy in ("none", "selective", "full"):
        c = dataclasses.replace(tc, recompute=policy)
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
        out = tm.forward(c, tree_unflatten(tp, leaves), toks,
                         rng=tdrop.key(5))
        grads[policy] = torch.autograd.grad(out.square().mean(), leaves)
    for policy in ("selective", "full"):
        for a, b in zip(grads["none"], grads[policy]):
            assert torch.equal(a, b), policy


@pytest.mark.parametrize("lima,hidden,path,layers", [
    (True, 0.3, 0.2, 5), (False, 0.1, 0.4, 4), (True, 0.1, 0.0, 1),
    (False, 0.2, 0.0, 3)])
def test_layer_rates_match_jax(lima, hidden, path, layers):
    kw = dict(lima_dropout=lima, hidden_dropout=hidden, drop_path_rate=path,
              num_layers=layers)
    jc, tc = jtiny(**kw), ttiny(**kw)
    for i in range(layers):
        want = jtransformer._layer_rates(jc, jnp.int32(i))
        got = tdrop.layer_rates(tc, i)
        for g, w in zip(got, want):
            assert g == pytest.approx(float(w), rel=1e-6, abs=1e-7)


def test_keep_mask_depends_on_its_key_alone():
    k = tdrop.fold_in(tdrop.fold_in(tdrop.key(3), 1), 2)
    a = tdrop.keep_mask(k, 0.7, (64, 64), "cpu")
    torch.manual_seed(0)  # the default generator plays no part
    assert torch.equal(a, tdrop.keep_mask(k, 0.7, (64, 64), "cpu"))
    e, s = tdrop.split(k)
    assert e != s and not torch.equal(a, tdrop.keep_mask(e, 0.7, (64, 64),
                                                         "cpu"))
    assert abs(float(a.float().mean()) - 0.7) < 0.03   # 4096 draws
    x = torch.ones(64, 64)
    y = tdrop.dropout(x, 0.3, k)
    assert torch.equal(y, torch.where(a, x / 0.7, 0.0))


def test_runtime_config_takes_dropout():
    cfg = TRun(model=ttiny(hidden_dropout=0.1, attention_dropout=0.1,
                           lima_dropout=True, drop_path_rate=0.1)).validate()
    assert cfg.model.attention_dropout == 0.1
