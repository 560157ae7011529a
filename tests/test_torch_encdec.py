"""BERT and T5 (``models/encdec.py``) through the port against the JAX
package, fp32 on the CPU.

Tiny configs (2 layers, hidden 64, 4 heads, vocabulary 250 padded to 256);
weights are the JAX package's, carried across with ``params_from_jax``;
batches are made with numpy from a seed and carry padding: BERT's rows and
T5's encoder and decoder rows end in pads.  Under ``attention_impl=
"flash"`` / ``norm_impl="pallas"`` the JAX side runs its Pallas kernels in
interpret mode and the port its kernels' plain versions (CPU tensors), the
encoders in the kernels' non-causal mode over pad segments.  The JAX
contracts of ``tests/models/test_encdec.py`` are restated port against
port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ModelConfig as JModelConfig
from megatron_llm_tpu.models import encdec as jencdec
from megatron_llm_tpu_torch.config import ModelConfig as TModelConfig
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import encdec as tencdec
from megatron_llm_tpu_torch.ops import dropout as drop
from megatron_llm_tpu_torch.utils.tree import (
    tree_leaves,
    tree_leaves_with_path,
    tree_unflatten,
)

torch.set_num_threads(1)

VOCAB = 250
SEQ = 32
BASE = dict(
    vocab_size=VOCAB, hidden_size=64, num_layers=2, num_attention_heads=4,
    ffn_hidden_size=128, max_position_embeddings=SEQ, norm_type="layernorm",
    activation="gelu", position_embedding_type="absolute", use_bias=True,
    tie_embed_logits=True, params_dtype="float32", recompute="none",
    seq_length=SEQ)
IMPLS = [("dot", "xla"), ("flash", "pallas")]
# fp32 on both sides; the sums run in another order (logits of size ~1,
# losses ~5.5, grads up to ~1).  In float64 the two sides agree to ~1e-13
# (test_bert_t5_match_jax_in_float64), so the fp32 gaps are rounding; on
# this suite's host the largest gap used 0.8% of LOSS_TOL and 3.5% of
# GRAD_TOL (BERT, the einsum route), room for another host's sum order
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)


def _cfgs(family, attn="dot", norm="xla", **kw):
    extra = (dict(tokentype_size=2) if family == "bert"
             else dict(num_decoder_layers=2))
    kw = dict(BASE, attention_impl=attn, norm_impl=norm, **extra, **kw)
    return JModelConfig(**kw).validate(), TModelConfig(**kw).validate()


def _params(family, jc):
    init = (jencdec.init_bert_params if family == "bert"
            else jencdec.init_t5_params)
    jp = init(jax.random.key(0), jc)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _pad_mask(lens, s):
    return (np.arange(s)[None, :] < np.asarray(lens)[:, None]).astype(
        np.float32)


def bert_batch(seed=0, lens=(32, 20, 9)):
    rng = np.random.default_rng(seed)
    b = len(lens)
    pad = _pad_mask(lens, SEQ)
    return {
        "tokens": rng.integers(0, VOCAB, (b, SEQ)).astype(np.int32),
        "labels": rng.integers(0, VOCAB, (b, SEQ)).astype(np.int32),
        "loss_mask": (rng.random((b, SEQ)) < 0.3).astype(np.float32) * pad,
        "pad_mask": pad,
        "tokentype_ids": np.repeat((np.arange(SEQ) >= 7)[None], b,
                                   0).astype(np.int32),
        "is_random": np.asarray([0, 1, 1][:b], np.int32),
    }


def t5_batch(seed=0, enc_lens=(32, 24, 11), dec_lens=(16, 9, 4)):
    rng = np.random.default_rng(seed)
    b, sd = len(enc_lens), 16
    dpad = _pad_mask(dec_lens, sd)
    return {
        "enc_tokens": rng.integers(0, VOCAB, (b, SEQ)).astype(np.int32),
        "dec_tokens": rng.integers(0, VOCAB, (b, sd)).astype(np.int32),
        "labels": rng.integers(0, VOCAB, (b, sd)).astype(np.int32),
        "loss_mask": dpad,
        "enc_pad_mask": _pad_mask(enc_lens, SEQ),
        "dec_pad_mask": dpad,
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _grads_match(tp, t_grads, j_grads):
    paths = [p for p, _ in tree_leaves_with_path(tp)]
    assert len(paths) == len(jax.tree.leaves(j_grads))
    for path, g in zip(paths, t_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(_leaf(j_grads, path)),
                                   err_msg=".".join(path), **GRAD_TOL)


@pytest.mark.parametrize("attn,norm", IMPLS)
def test_bert_logits_loss_and_grads_match_jax(attn, norm):
    jc, tc = _cfgs("bert", attn, norm)
    jp, tp = _params("bert", jc)
    batch = bert_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)
    j_mlm, j_bin = jax.jit(lambda p, b: jencdec.bert_forward(
        jc, p, b["tokens"], b["pad_mask"], b["tokentype_ids"]))(jp, jb)
    with torch.no_grad():
        t_mlm, t_bin = tencdec.bert_forward(tc, tp, tb["tokens"],
                                            tb["pad_mask"],
                                            tb["tokentype_ids"])
    np.testing.assert_allclose(t_mlm.numpy(), np.asarray(j_mlm), **LOGIT_TOL)
    np.testing.assert_allclose(t_bin.numpy(), np.asarray(j_bin), **LOGIT_TOL)

    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jencdec.bert_loss(jc, p, jb)))(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    t_loss = tencdec.bert_loss(tc, tp, tb)
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               **LOSS_TOL)
    _grads_match(tp, t_grads, j_grads)


@pytest.mark.parametrize("attn,norm", IMPLS)
def test_t5_logits_loss_and_grads_match_jax(attn, norm):
    jc, tc = _cfgs("t5", attn, norm)
    jp, tp = _params("t5", jc)
    assert tp["cross"]["wq"].shape[0] == 2   # stacked per decoder layer
    batch = t5_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _torch_batch(batch)
    j_logits = jax.jit(lambda p, b: jencdec.t5_forward(
        jc, p, b["enc_tokens"], b["dec_tokens"], b["enc_pad_mask"],
        b["dec_pad_mask"]))(jp, jb)
    with torch.no_grad():
        t_logits = tencdec.t5_forward(tc, tp, tb["enc_tokens"],
                                      tb["dec_tokens"], tb["enc_pad_mask"],
                                      tb["dec_pad_mask"])
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               **LOGIT_TOL)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jencdec.t5_loss(jc, p, jb)))(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    t_loss = tencdec.t5_loss(tc, tp, tb)
    t_grads = torch.autograd.grad(t_loss, leaves)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               **LOSS_TOL)
    _grads_match(tp, t_grads, j_grads)


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_bert_t5_match_jax_in_float64(family):
    """The evidence for the fp32 limits above: the loss and every gradient
    with both sides in float64 (``torch_float64.float64_everywhere``)
    agree to ~1e-13, so the port computes what JAX computes."""
    from torch_float64 import as_float64, float64_everywhere

    jc, _ = _cfgs(family)
    jp, _ = _params(family, jc)
    batch = bert_batch() if family == "bert" else t5_batch()
    jloss = jencdec.bert_loss if family == "bert" else jencdec.t5_loss
    tloss = tencdec.bert_loss if family == "bert" else tencdec.t5_loss
    with float64_everywhere():
        jc, tc = _cfgs(family)
        jp64 = jax.tree.map(jnp.asarray, as_float64(jp))
        tp = params_from_jax(as_float64(jp), device="cpu")
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        j_loss, j_grads = jax.jit(jax.value_and_grad(
            lambda p: jloss(jc, p, jb)))(jp64)
        leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
        t_loss = tloss(tc, tp, _torch_batch(batch))
        t_grads = torch.autograd.grad(t_loss, leaves)
    assert t_loss.dtype == torch.float64
    assert float(t_loss.detach()) == pytest.approx(float(j_loss), rel=1e-12)
    for (path, _), g in zip(tree_leaves_with_path(tp), t_grads):
        want = np.asarray(_leaf(j_grads, path))
        assert g.dtype == torch.float64 and want.dtype == np.float64
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-10, atol=1e-12,
                                   err_msg=".".join(path))


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_init_trees_match_jax(family):
    """The port's init gives the JAX tree: the same paths, shapes, dtypes,
    zero biases and unit norm scales."""
    jc, tc = _cfgs(family)
    jp, _ = _params(family, jc)
    init = (tencdec.init_bert_params if family == "bert"
            else tencdec.init_t5_params)
    tp = init(tc, seed=3, device="cpu")
    want = {tuple(str(k.key) for k in path): leaf
            for path, leaf in jax.tree.leaves_with_path(jp)}
    got = dict(tree_leaves_with_path(tp))
    assert set(got) == set(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).split(".")[-1] == str(want[path].dtype), path
        w = np.asarray(want[path])
        if not w.any():                 # biases
            assert not bool(t.any()), path
        if (w == 1).all():              # norm scales
            assert bool((t == 1).all()), path
    meta = init(tc, device="meta")
    assert [tuple(t.shape) for t in tree_leaves(meta)] == \
        [tuple(t.shape) for t in tree_leaves(tp)]


# ---------------------------------------------------------------------------
# The JAX contracts (tests/models/test_encdec.py), port against port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bert():
    _, tc = _cfgs("bert")
    return tc, tencdec.init_bert_params(tc, seed=0, device="cpu")


@pytest.fixture(scope="module")
def t5():
    _, tc = _cfgs("t5")
    return tc, tencdec.init_t5_params(tc, seed=0, device="cpu")


def _tok(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.long)


@torch.no_grad()
def test_bert_is_bidirectional(bert):
    cfg, params = bert
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, VOCAB, (1, SEQ))
    pad = torch.ones(1, SEQ)
    a, _ = tencdec.bert_forward(cfg, params, _tok(tokens), pad)
    tokens[0, -1] = (tokens[0, -1] + 1) % VOCAB
    b, _ = tencdec.bert_forward(cfg, params, _tok(tokens), pad)
    assert float((a[0, 0] - b[0, 0]).abs().max()) > 1e-6


@pytest.mark.parametrize("attn,norm", IMPLS)
@torch.no_grad()
def test_bert_padding_is_ignored(attn, norm):
    """Content positions do not depend on the pads' token values, through
    the einsum path and the flash kernel's plain version alike."""
    _, cfg = _cfgs("bert", attn, norm)
    params = tencdec.init_bert_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    content = rng.integers(0, VOCAB, 20)
    pad = torch.as_tensor(_pad_mask([20], SEQ))
    t1 = np.concatenate([content, np.zeros(12, np.int64)])[None]
    t2 = np.concatenate([content, rng.integers(0, VOCAB, 12)])[None]
    a, _ = tencdec.bert_forward(cfg, params, _tok(t1), pad)
    b, _ = tencdec.bert_forward(cfg, params, _tok(t2), pad)
    np.testing.assert_allclose(a[0, :20].numpy(), b[0, :20].numpy(),
                               atol=1e-5)


@torch.no_grad()
def test_t5_cross_attention_reaches_only_its_row(t5):
    cfg, params = t5
    rng = np.random.default_rng(4)
    enc = rng.integers(0, VOCAB, (2, 24))
    dec = _tok(rng.integers(0, VOCAB, (2, 16)))
    a = tencdec.t5_forward(cfg, params, _tok(enc), dec)
    enc[0, 3] = (enc[0, 3] + 1) % VOCAB
    b = tencdec.t5_forward(cfg, params, _tok(enc), dec)
    assert float((a[0] - b[0]).abs().max()) > 1e-6
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), atol=1e-6)


@torch.no_grad()
def test_t5_decoder_is_causal(t5):
    cfg, params = t5
    rng = np.random.default_rng(5)
    enc = _tok(rng.integers(0, VOCAB, (1, 24)))
    dec = rng.integers(0, VOCAB, (1, 16))
    a = tencdec.t5_forward(cfg, params, enc, _tok(dec))
    dec[0, -1] = (dec[0, -1] + 1) % VOCAB
    b = tencdec.t5_forward(cfg, params, enc, _tok(dec))
    np.testing.assert_allclose(a[0, :-1].numpy(), b[0, :-1].numpy(),
                               atol=1e-6)


@torch.no_grad()
def test_t5_encoder_pads_masked_in_cross_attention(t5):
    cfg, params = t5
    rng = np.random.default_rng(6)
    content = rng.integers(0, VOCAB, 16)
    mask = torch.as_tensor(_pad_mask([16], 24))
    dec = _tok(rng.integers(0, VOCAB, (1, 8)))
    e1 = np.concatenate([content, np.zeros(8, np.int64)])[None]
    e2 = np.concatenate([content, rng.integers(0, VOCAB, 8)])[None]
    a = tencdec.t5_forward(cfg, params, _tok(e1), dec, enc_pad_mask=mask)
    b = tencdec.t5_forward(cfg, params, _tok(e2), dec, enc_pad_mask=mask)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_loss_decreases(family):
    """12 plain SGD steps cut the loss by 10% (JAX's test_*_loss_decreases),
    the port's own init."""
    _, cfg = _cfgs(family)
    if family == "bert":
        params = tencdec.init_bert_params(cfg, seed=7, device="cpu")
        batch = _torch_batch(bert_batch(3, lens=(32, 32)))
        loss_fn = tencdec.bert_loss
    else:
        params = tencdec.init_t5_params(cfg, seed=9, device="cpu")
        batch = _torch_batch(t5_batch(7, enc_lens=(32, 32),
                                      dec_lens=(16, 16)))
        loss_fn = tencdec.t5_loss
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    l0 = float(loss_fn(cfg, params, batch).detach())
    for _ in range(12):
        grads = torch.autograd.grad(loss_fn(cfg, params, batch), leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(0.05 * g)
    assert float(loss_fn(cfg, params, batch).detach()) < 0.9 * l0


@pytest.mark.parametrize("family", ["bert", "t5"])
def test_dropout_is_keyed_and_off_when_deterministic(family):
    """With dropout the loss is a function of the key (the same key, the
    same loss; another key, another), and ``deterministic=True`` or no key
    gives the dropout-free loss; every recompute policy gives the same
    bits."""
    _, cfg = _cfgs(family, hidden_dropout=0.1, attention_dropout=0.1)
    if family == "bert":
        params = tencdec.init_bert_params(cfg, seed=0, device="cpu")
        batch, loss_fn = _torch_batch(bert_batch()), tencdec.bert_loss
    else:
        params = tencdec.init_t5_params(cfg, seed=0, device="cpu")
        batch, loss_fn = _torch_batch(t5_batch()), tencdec.t5_loss
    with torch.no_grad():
        plain = loss_fn(cfg, params, batch)
        k = drop.key(5)
        a = loss_fn(cfg, params, batch, k, False)
        assert torch.equal(a, loss_fn(cfg, params, batch, k, False))
        assert not torch.equal(a, loss_fn(cfg, params, batch, drop.key(6),
                                          False))
        assert not torch.equal(a, plain)
        assert torch.equal(loss_fn(cfg, params, batch, k, True), plain)
    grads = []
    for policy in ("none", "selective", "full"):
        c = dataclasses.replace(cfg, recompute=policy)
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        grads.append(torch.autograd.grad(loss_fn(c, live, batch, k, False),
                                         leaves))
    for g in grads[1:]:
        assert all(torch.equal(x, y) for x, y in zip(g, grads[0]))


def test_pad_segments_are_int32_and_contiguous():
    seg = tencdec._pad_segments(torch.tensor([[1.0, 1.0, 0.0]]))
    assert seg.dtype == torch.int32 and seg.is_contiguous()
    assert seg.tolist() == [[1, 1, 0]]
