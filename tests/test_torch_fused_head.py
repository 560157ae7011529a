"""The fused LM head (``parallel/cross_entropy.fused_linear_cross_entropy``)
and the fused-head train step against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
train steps start from the JAX package's weights (``params_from_jax``).
fp32 comparisons hold at 1e-5 (the JAX test's own limit for fused against
plain).  The card's limits for fused against the unfused bf16 route
(``chip_smoke.py``'s fused-head phase, ``tests/test_torch_cuda.py``) come
from ``test_card_tolerance_from_float64`` below.
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
from megatron_llm_tpu.parallel import cross_entropy as jce
from megatron_llm_tpu.training import step as jstep
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.parallel import cross_entropy as tce
from megatron_llm_tpu_torch.training import step as tstep
from megatron_llm_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

# the card's limits for the fused head against the unfused bf16 route at
# Llama-2-7B's head (rows of unit RMS, w std 0.02, vocab 32000): the
# float64 study below measures the unfused route's bf16-rounded logits
# against float64 at a quarter of these
CARD_MEAN_LOSS = 2e-3       # |mean loss difference|
CARD_MAX_LOSS = 0.05        # max per-token loss difference
CARD_GRAD_REL = 0.02        # relative Frobenius error of dx and dw
# the card's limit for the fused head's per-token loss against the float64
# CE of the same bf16 operands: the float64 study below finds fp32 block
# logits within 1e-6 of it and bf16-rounded ones 6e-3 away, so a fused
# head that rounded its block logits to bf16 fails it
CARD_EXACT_MAX_LOSS = 5e-4


def _inputs(n, h, v_padded, vocab, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h)).astype(dtype)
    w = (rng.normal(size=(h, v_padded)) * 0.5).astype(dtype)
    labels = rng.integers(0, vocab, n).astype(np.int32)
    return x, w, labels


def _torch_fused(x, w, labels, vocab, block, g=None):
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    loss = tce.fused_linear_cross_entropy(tx, tw, torch.from_numpy(labels),
                                          vocab, block)
    g = torch.ones_like(loss) if g is None else torch.from_numpy(g)
    dx, dw = torch.autograd.grad(loss, (tx, tw), g)
    return loss.detach().numpy(), dx.numpy(), dw.numpy()


# (n, h, vocab, v_padded, block): the JAX test's padded vocab with a block
# that does not divide v_padded, a block larger than the vocabulary, one
# that divides it, and every column real
CASES = [(48, 24, 90, 112, 48), (48, 24, 90, 112, 8192),
         (32, 16, 100, 128, 32), (40, 32, 64, 64, 24)]


@pytest.mark.parametrize("n,h,vocab,v_padded,block", CASES)
def test_fused_linear_cross_entropy_matches_jax(n, h, vocab, v_padded,
                                                block):
    """Loss, dx and dw against JAX's ``custom_vjp`` on the same inputs and
    a random cotangent, fp32, atol / rtol 1e-5."""
    x, w, labels = _inputs(n, h, v_padded, vocab)
    g = np.random.default_rng(1).random(n).astype(np.float32)

    def jfn(a, b):
        return jce.fused_linear_cross_entropy(a, b, jnp.asarray(labels),
                                              vocab, block)

    j_loss, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    j_dx, j_dw = vjp(jnp.asarray(g))
    t_loss, t_dx, t_dw = _torch_fused(x, w, labels, vocab, block, g)
    for got, want in ((t_loss, j_loss), (t_dx, j_dx), (t_dw, j_dw)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("n,h,vocab,v_padded,block", CASES[:2])
def test_fused_linear_cross_entropy_matches_the_plain_route(n, h, vocab,
                                                            v_padded, block):
    """Against the port's own ``cross_entropy(x @ w)`` and its autograd:
    the padded columns get no probability and a zero dw."""
    x, w, labels = _inputs(n, h, v_padded, vocab, seed=2)
    t_loss, t_dx, t_dw = _torch_fused(x, w, labels, vocab, block)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    plain = tce.cross_entropy(tx @ tw, torch.from_numpy(labels).long(),
                              vocab_size=vocab)
    p_dx, p_dw = torch.autograd.grad(plain.sum(), (tx, tw))
    np.testing.assert_allclose(t_loss, plain.detach().numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(t_dx, p_dx.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_dw, p_dw.numpy(), atol=1e-5, rtol=1e-5)
    assert not np.any(t_dw[:, vocab:])


def test_fused_linear_cross_entropy_bf16_keeps_fp32_logits():
    """bf16 operands take fp32 block logits (JAX's
    ``preferred_element_type``): the loss equals the fp32 run on the same
    bf16 values widened, within fp32 summation order (1e-5); dx and dw
    come back in bf16, one rounding of the fp32 run's after a bf16
    cotangent product (2e-2 relative, Frobenius).  (JAX's own bf16 run
    on the CPU gives inf losses on some rows of this input, so the
    reference here is the port's fp32 run, itself held to JAX above.)"""
    x, w, labels = _inputs(64, 32, 90, 112)
    xb = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wb = torch.from_numpy(w).bfloat16().requires_grad_(True)
    t_loss = tce.fused_linear_cross_entropy(
        xb, wb, torch.from_numpy(labels), 90, 48)
    t_dx, t_dw = torch.autograd.grad(t_loss.sum(), (xb, wb))
    assert t_loss.dtype == torch.float32 and t_dx.dtype == torch.bfloat16
    r_loss, r_dx, r_dw = _torch_fused(xb.detach().float().numpy(),
                                      wb.detach().float().numpy(), labels,
                                      90, 48)
    np.testing.assert_allclose(t_loss.detach().numpy(), r_loss, atol=1e-5,
                               rtol=1e-5)
    for got, want in ((t_dx, r_dx), (t_dw, r_dw)):
        got = got.float().numpy()
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


def test_fused_head_saves_no_full_logits():
    """The fused route's autograd graph keeps no ``[n, vocab]`` tensor;
    the unfused route keeps the fp32 logits."""
    n, h, v = 64, 16, 512
    x, w, labels = _inputs(n, h, v, v)
    big = []

    def pack(t):
        if t.numel() >= n * v:
            big.append(tuple(t.shape))
        return t

    for fused in (True, False):
        tx = torch.from_numpy(x).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        tl = torch.from_numpy(labels)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if fused:
                tce.fused_linear_cross_entropy(tx, tw, tl, v, 128)
                assert big == []
            else:
                tce.cross_entropy(tx @ tw, tl.long(), vocab_size=v)
                assert (n, v) in big


def test_tied_head_gradient_reaches_the_embedding():
    """With tied embeddings the unembedding weight is ``word.T``: the
    fused head's dw reaches the table through the transpose, as the plain
    head's does."""
    cfg = ttiny(tie_embed_logits=True, params_dtype="float32")
    params = tm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    batch = {"tokens": toks, "labels": toks.roll(-1, -1),
             "loss_mask": torch.ones(2, 16)}
    grads = {}
    for fused in (True, False):
        c = TRun(model=dataclasses.replace(cfg, fused_lm_head=fused),
                 train=TTrain(seq_length=16, micro_batch_size=2,
                              global_batch_size=2)).validate()
        word = params["embedding"]["word"].detach().requires_grad_(True)
        live = {**params, "embedding": {**params["embedding"],
                                        "word": word}}
        loss = tstep.compute_loss(c, live, batch)
        grads[fused] = (float(loss.detach()),
                        torch.autograd.grad(loss, word)[0])
    assert grads[True][0] == pytest.approx(grads[False][0], rel=1e-6)
    torch.testing.assert_close(grads[True][1], grads[False][1], atol=1e-6,
                               rtol=1e-5)


def _cfgs(fused, **model_kw):
    opt = dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1, weight_decay=0.1,
               clip_grad=1.0)
    train = dict(train_iters=10, micro_batch_size=2, global_batch_size=4,
                 seq_length=16)
    model_kw = dict(model_kw, fused_lm_head=fused)
    jc = JRun(model=jtiny(**model_kw), parallel=JPar(),
              optimizer=JOpt(**opt), train=JTrain(**train)).validate()
    tc = TRun(model=ttiny(**model_kw), optimizer=TOpt(**opt),
              train=TTrain(**train)).validate()
    return jc, tc


def _batch(cfg, seed, accum=2):
    rng = np.random.default_rng(seed)
    shape = (accum, cfg.train.micro_batch_size, cfg.train.seq_length)
    tokens = rng.integers(0, cfg.model.vocab_size, shape).astype(np.int32)
    mask = (rng.random(shape) > 0.1).astype(np.float32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1),
            "loss_mask": mask}


def _train(jc, tc, steps=3):
    jparams = jm.init_params(jax.random.key(0), jc.model)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    jstate = jstep.init_train_state(jc, jparams)
    tstate = tstep.init_train_state(tc, tparams)
    jfn = jstep.make_train_step(jc)
    tfn = tstep.make_train_step(tc, "cpu")
    losses = []
    for i in range(steps):
        batch = _batch(jc, 100 + i)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, None)
        tstate, tmet = tfn(tstate, tstep.to_device_batch(batch, "cpu"))
        losses.append((float(tmet["loss"]), float(jmet["loss"]),
                       float(tmet["grad_norm"]), float(jmet["grad_norm"])))
    return jstate, tstate, losses


@pytest.mark.parametrize("model_kw", [
    dict(attention_impl="flash", norm_impl="pallas", recompute="selective"),
    dict(tie_embed_logits=True, make_vocab_size_divisible_by=128,
         vocab_size=200)])
def test_fused_head_train_steps_match_jax(model_kw):
    """Three fused-head steps (grad accumulation 2) against JAX's fused
    ``make_train_step``: losses 1e-5, params 1e-4 relative (the limits of
    ``tests/test_torch_train.py``); the second case has a tied head and
    56 padded vocabulary columns."""
    jc, tc = _cfgs(True, **model_kw)
    jstate, tstate, out = _train(jc, tc)
    for t_loss, j_loss, t_norm, j_norm in out:
        assert t_loss == pytest.approx(j_loss, rel=1e-5, abs=1e-5)
        assert t_norm == pytest.approx(j_norm, rel=1e-4)
    for t, j in zip(tree_leaves(tstate.params),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jstate.params))):
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=2e-5)


def test_fused_head_train_steps_match_the_unfused_port():
    """The port's fused and unfused steps from the same weights: the same
    losses and params within fp32 reassociation (1e-5 / 1e-5)."""
    _, tf = _cfgs(True)
    _, tp = _cfgs(False)
    params = tm.init_params(tf.model, seed=0, device="cpu")
    states = {}
    for label, c in (("fused", tf), ("plain", tp)):
        state = tstep.init_train_state(
            c, {k: v for k, v in _clone(params).items()})
        fn = tstep.make_train_step(c, "cpu")
        losses = []
        for i in range(3):
            state, met = fn(state, tstep.to_device_batch(_batch(c, 7 + i),
                                                         "cpu"))
            losses.append(float(met["loss"]))
        states[label] = (state, losses)
    np.testing.assert_allclose(states["fused"][1], states["plain"][1],
                               rtol=1e-5)
    for a, b in zip(tree_leaves(states["fused"][0].params),
                    tree_leaves(states["plain"][0].params)):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def test_card_tolerance_from_float64():
    """Where the card's limits come from.  At Llama-2-7B's head width
    (h 4096, vocab 32000, w std 0.02, rows of unit RMS as the final norm
    gives), 64 rows in bf16: the unfused route rounds its logits to bf16
    before the fp32 CE, the fused route keeps them fp32.  Against a
    float64 CE of the same bf16 operands, the unfused route errs by a
    quarter of the card's limits or less, the fused one by far less; so
    fused against unfused on the card stays within them.  The limit
    against the float64 CE itself lies between the fused route's gap and
    the unfused route's: the card's check tells fp32 block logits from
    bf16 ones."""
    rng = np.random.default_rng(11)
    n, h, v = 64, 4096, 32000
    x = torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)) \
        .bfloat16()
    w = torch.from_numpy((rng.normal(size=(h, v)) * 0.02)
                         .astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.integers(0, v, n))

    def grads(fn, dtype):
        tx = x.to(dtype).requires_grad_(True)
        tw = w.to(dtype).requires_grad_(True)
        loss = fn(tx, tw)
        dx, dw = torch.autograd.grad(loss.sum(), (tx, tw))
        return loss.detach().double(), dx.double(), dw.double()

    ref = grads(lambda a, b: tce.cross_entropy(a @ b, labels),
                torch.float64)
    unfused = grads(lambda a, b: tce.cross_entropy((a @ b).float(), labels),
                    torch.bfloat16)
    fused = grads(lambda a, b: tce.fused_linear_cross_entropy(a, b, labels,
                                                              v),
                  torch.bfloat16)

    def errs(got):
        d = got[0] - ref[0]
        return (abs(float(d.mean())), float(d.abs().max()),
                *(float((g - r).norm() / r.norm())
                  for g, r in zip(got[1:], ref[1:])))

    e_unf, e_fus = errs(unfused), errs(fused)
    limits = (CARD_MEAN_LOSS, CARD_MAX_LOSS, CARD_GRAD_REL, CARD_GRAD_REL)
    for e, lim in zip(e_unf, limits):
        assert e <= lim / 4, (e_unf, limits)
    for e, lim in zip(e_fus, limits):
        assert e <= lim / 4, (e_fus, limits)
    assert e_fus[1] <= CARD_EXACT_MAX_LOSS / 100 < CARD_EXACT_MAX_LOSS * 4 \
        <= e_unf[1], (e_fus, e_unf)


def test_runtime_config_takes_the_fused_head():
    cfg = TRun(model=ttiny(fused_lm_head=True)).validate()
    assert cfg.model.fused_lm_head
