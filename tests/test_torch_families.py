"""The LayerNorm decoder families (Falcon, Falcon-40B, GPT) through the
port against the JAX package, fp32 on the CPU.

Each family is a tiny config with the family's switches: Falcon's
parallel attention, MQA, exact GELU, LayerNorm with bias and tied
embeddings; Falcon-40B's second (MLP) LayerNorm and two KV heads; GPT's
learned positions, biases on every projection, tanh GELU and a vocabulary
that is not a multiple of ``make_vocab_size_divisible_by``.  Weights are
the JAX package's, carried across with ``params_from_jax``; tokens and
batches are made with numpy from a seed.  Under ``norm_impl="pallas"`` the
JAX side runs ``layernorm_pallas`` (and the flash kernels) in interpret
mode and the port its kernels' plain versions (CPU tensors).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu import config as jconfig
from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu.training import step as jstep
from megatron_llm_tpu_torch import config as tconfig
from megatron_llm_tpu_torch import finetune as tfinetune
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.serving.engine import _sample_slots
from megatron_llm_tpu_torch.training import step as tstep
from megatron_llm_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

FAMILIES = {
    "falcon": dict(norm_type="layernorm", activation="gelu_exact",
                   parallel_attn=True, num_kv_heads=1, tie_embed_logits=True),
    "falcon40b": dict(norm_type="layernorm", activation="gelu_exact",
                      parallel_attn=True, parallel_layernorm=True,
                      num_kv_heads=2, tie_embed_logits=True),
    "gpt": dict(norm_type="layernorm", activation="gelu",
                position_embedding_type="absolute", use_bias=True,
                tie_embed_logits=True, num_kv_heads=None, vocab_size=250),
}
# (attention_impl, norm_impl): the plain route and the kernel route
IMPLS = [("dot", "xla"), ("flash", "pallas")]
CASES = [(f, a, n) for f in FAMILIES for a, n in IMPLS]
# fp32 end to end on both sides; sums in another order
TOL = dict(rtol=1e-4, atol=1e-4)
# JAX's forwards as one program a config (called eagerly, each op of the
# model compiles on its own)
_jforward = jax.jit(jm.forward, static_argnums=0)
_jforward_cached = jax.jit(jm.forward_cached, static_argnums=0,
                           static_argnames="empty_cache")


def _pair(family, attn="dot", norm="xla", **kw):
    kw = dict(FAMILIES[family], attention_impl=attn, norm_impl=norm,
              fused_decode=False, **kw)
    jc, tc = jtiny(**kw), ttiny(**kw)
    jp = jm.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("family,size", [
    ("falcon", "7b"), ("falcon", "40b"), ("gpt", "125m"), ("gpt", "345m"),
    ("gpt", "1.3b")])
def test_family_presets_match_jax(family, size):
    """``falcon_config`` / ``gpt_config`` field for field, every size
    (Falcon-40B's ``parallel_layernorm`` included), with the dropout rates
    the reference's GPT runs use."""
    t = getattr(tconfig, f"{family}_config")(size, hidden_dropout=0.1,
                                             attention_dropout=0.1)
    j = getattr(jconfig, f"{family}_config")(size, hidden_dropout=0.1,
                                             attention_dropout=0.1)
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.kv_heads, t.head_dim, t.ffn_size, t.padded_vocab_size()) == \
        (j.kv_heads, j.head_dim, j.ffn_size, j.padded_vocab_size())


def test_family_configs_have_their_switches():
    _, _, falcon, _ = _pair("falcon")
    _, _, gpt, _ = _pair("gpt")
    assert falcon.kv_heads == 1 and falcon.parallel_attn
    assert gpt.vocab_size % gpt.make_vocab_size_divisible_by
    assert gpt.padded_vocab_size() == 256 > gpt.vocab_size


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_from_jax_carries_the_family_tree(family):
    """Leaf for leaf: the same paths, shapes and values as JAX's tree, and
    the same paths and shapes as the port's own ``init_params``."""
    _, jp, tc, tp = _pair(family)
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]

    def paths(tree, prefix=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(paths(v, prefix + (k,)))
            else:
                out[prefix + (k,)] = v
        return out

    got = paths(tp)
    want = {tuple(p.key for p in path): np.asarray(v) for path, v in jleaves}
    assert got.keys() == want.keys()
    for path, v in want.items():
        np.testing.assert_array_equal(got[path].numpy(), v, str(path))
    own = paths(tm.init_params(tc, seed=0, device="cpu"))
    assert {p: tuple(v.shape) for p, v in own.items()} == \
        {p: tuple(v.shape) for p, v in got.items()}
    assert "lm_head" not in tp
    assert ("layers", "input_norm", "bias") in got
    assert (("layers", "mlp_norm", "scale") in got) == (family == "falcon40b")
    assert (("embedding", "position") in got) == (family == "gpt")
    assert (("layers", "attn", "bq") in got) == (family == "gpt")
    assert (("layers", "mlp", "b_down") in got) == (family == "gpt")


@pytest.mark.parametrize("family,attn,norm", CASES)
def test_family_logits_match_jax(family, attn, norm):
    jc, jp, tc, tp = _pair(family, attn, norm)
    toks = _tokens(2, 11, jc.vocab_size)
    want = _jforward(jc, jp, jnp.asarray(toks))
    got = tm.forward(tc, tp, torch.from_numpy(toks).long())
    assert got.shape == want.shape == (2, 11, jc.padded_vocab_size())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("family,attn,norm", CASES)
def test_family_prefill_then_decode_match_jax(family, attn, norm):
    jc, jp, tc, tp = _pair(family, attn, norm)
    b, plen, max_len = 2, 9, 32
    toks = _tokens(b, plen + 3, jc.vocab_size, seed=1)
    jk, jv = jm.init_kv_cache(jc, b, max_len)
    tk, tv = tm.init_kv_cache(tc, b, max_len, device="cpu")
    assert tuple(tk.shape) == (tc.num_layers, b, tc.kv_heads, max_len,
                               tc.head_dim)
    want, jk, jv = _jforward_cached(jc, jp, jnp.asarray(toks[:, :plen]), jk,
                                     jv, jnp.int32(0), empty_cache=True)
    got, tk, tv = tm.forward_cached(tc, tp, torch.from_numpy(toks[:, :plen]),
                                    tk, tv, 0, empty_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(3):
        fills = np.full((b,), plen + i, np.int32)
        step = toks[:, plen + i:plen + i + 1]
        want, jk, jv = _jforward_cached(jc, jp, jnp.asarray(step), jk, jv,
                                         jnp.asarray(fills))
        got, tk, tv = tm.forward_cached(tc, tp, torch.from_numpy(step), tk,
                                        tv, torch.from_numpy(fills))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)


# ---------------------------------------------------------------------------
# Training: three make_train_step steps, grad_accum 2
# ---------------------------------------------------------------------------


def _train_cfgs(model_kw):
    opt = dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1, weight_decay=0.1,
               clip_grad=1.0)
    train = dict(train_iters=10, micro_batch_size=2, global_batch_size=4,
                 seq_length=16)
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


@pytest.mark.parametrize("family,attn,norm", CASES)
def test_family_train_steps_match_jax(family, attn, norm):
    """Losses and grad norms within 1e-5 and the params within 1e-4
    relative (Frobenius, over the whole tree) after three steps, selective
    recompute on both sides; the tied embedding takes its grads from the
    lookup and the unembedding in one leaf.

    The grads agree to ~3e-7 relative, but Adam moves an element by about
    lr whatever its grad's size, so an element whose grad is near its
    rounding noise can move differently on the two sides: GPT's key bias
    has a grad that is zero but for rounding (softmax ignores a shift
    shared by all keys), and Falcon's wo a few such elements.  Which
    elements those are is read from the port's float64 run of the same
    three steps (``_float64_grads``; the two sides agree there to ~3e-14,
    ``test_family_train_steps_match_jax_in_float64``): an element whose
    float64 grad falls below ``NOISE_FLOOR`` of its leaf's largest at any
    step may part by ``NOISY_STEP_LIMIT``; every other element by no more
    than a fifth of one step's lr (2e-4)."""
    model_kw = dict(FAMILIES[family], attention_impl=attn, norm_impl=norm,
                    recompute="selective")
    jc, tc = _train_cfgs(model_kw)
    jparams = jm.init_params(jax.random.key(0), jc.model)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    noisy = [np.min([np.abs(g) / max(float(np.abs(g).max()), 1e-30)
                     for g in leaf], axis=0) < NOISE_FLOOR
             for leaf in zip(*_float64_grads(model_kw, jparams)[0])]
    jstate = jstep.init_train_state(jc, jparams)
    tstate = tstep.init_train_state(tc, tparams)
    jfn, tfn = jstep.make_train_step(jc), tstep.make_train_step(tc, "cpu")
    for i in range(3):
        batch = _batch(jc, 200 + i)
        jstate, jmet = jfn(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, None)
        tstate, tmet = tfn(tstate, tstep.to_device_batch(batch, "cpu"))
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5, abs=1e-5)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-5)
    pairs = list(zip(tree_leaves(tstate.params),
                     jax.tree.leaves(jax.tree.map(np.asarray,
                                                  jstate.params))))
    diff = sum(float(np.sum((t.numpy() - j) ** 2)) for t, j in pairs)
    size = sum(float(np.sum(j.astype(np.float64) ** 2)) for _, j in pairs)
    assert (diff / size) ** 0.5 <= 1e-4
    for (t, j), noise in zip(pairs, noisy):
        gap = np.abs(t.numpy() - j)
        assert float(gap[~noise].max(initial=0.0)) <= 2e-4
        assert float(gap[noise].max(initial=0.0)) <= NOISY_STEP_LIMIT


# In fp32 the port's grads part from their float64 values by ~3.5e-7 of
# the leaf's largest (Falcon's wo at the first step: 1.5e-8 on 0.043); an
# element whose float64 grad is below 1e-5 of it (30x that) has a sign
# that rounding decides.  Adam's step is at most about lr when
# 1 - beta1 <= sqrt(1 - beta2) (Kingma & Ba, section 2.1; 0.1 <= 0.22
# here), so over three steps such an element can part by two steps of lr
# at each: 6e-3.  Measured: Falcon's wo, one element, 2.4e-4 (its float64
# grad at the first step 2e-9, 4.5e-8 of the leaf's largest); every
# element above the floor within 1.5e-5 in all six cases.
NOISE_FLOOR = 1e-5
NOISY_STEP_LIMIT = 3 * 2 * 1e-3


def _float64_grads(model_kw, jparams, steps=3):
    """The port's float64 grads at each of the test's ``steps`` steps,
    from JAX's initial params (a list per step of numpy leaves), and the
    final params."""
    from megatron_llm_tpu_torch.models.transformer import rope_tables
    from torch_float64 import as_float64, float64_everywhere

    init = as_float64(jparams)
    with float64_everywhere():
        jc, tc = _train_cfgs(model_kw)
        state = tstep.init_train_state(
            tc, params_from_jax(init, device="cpu"))
        fn = tstep.make_train_step(tc, "cpu")
        rope = rope_tables(tc.model, device="cpu")
        grads = []
        for i in range(steps):
            batch = tstep.to_device_batch(_batch(jc, 200 + i), "cpu")
            g, _ = tstep._accumulate_grads(tc, state.params, batch, rope,
                                           1.0)
            grads.append([x.numpy() for x in tree_leaves(g)])
            state, metrics = fn(state, batch)
        final = [p.numpy() for p in tree_leaves(state.params)]
    return grads, final, float(metrics["loss"])


@pytest.mark.parametrize("family,attn,norm", CASES)
def test_family_train_steps_match_jax_in_float64(family, attn, norm):
    """The evidence for the limits above: the same three steps with both
    sides in float64 (``torch_float64.float64_everywhere``) agree to
    ~3e-14 per element, so the port computes JAX's step and the fp32 gaps
    are rounding."""
    from torch_float64 import as_float64, float64_everywhere

    model_kw = dict(FAMILIES[family], attention_impl=attn, norm_impl=norm,
                    recompute="selective")
    jparams = jm.init_params(jax.random.key(0),
                             _train_cfgs(model_kw)[0].model)
    _, got, got_loss = _float64_grads(model_kw, jparams)
    with float64_everywhere():
        jc, _ = _train_cfgs(model_kw)
        jstate = jstep.init_train_state(
            jc, jax.tree.map(jnp.asarray, as_float64(jparams)))
        jfn = jstep.make_train_step(jc)
        for i in range(3):
            jstate, jmet = jfn(jstate, {k: jnp.asarray(v) for k, v in
                                        _batch(jc, 200 + i).items()}, None)
        want = [np.asarray(p) for p in jax.tree.leaves(jstate.params)]
    assert got_loss == pytest.approx(float(jmet["loss"]), rel=1e-12)
    for t, j in zip(got, want):
        assert t.dtype == j.dtype == np.float64
        assert float(np.abs(t - j).max()) <= 1e-12


def test_learned_positions_bound_the_training_sequence():
    """GPT's learned table has ``max_position_embeddings`` rows: a longer
    training sequence is refused up front (torch indexing would raise
    mid-step, on the card as a device-side assert); rotary configs take
    any length."""
    gpt = ttiny(**FAMILIES["gpt"])
    TRun(model=gpt, train=TTrain(seq_length=gpt.max_position_embeddings,
                                 micro_batch_size=1,
                                 global_batch_size=1)).validate()
    with pytest.raises(ValueError, match="learned position table"):
        TRun(model=gpt, train=TTrain(seq_length=gpt.max_position_embeddings
                                     + 1, micro_batch_size=1,
                                     global_batch_size=1)).validate()
    falcon = ttiny(**FAMILIES["falcon"])
    TRun(model=falcon,
         train=TTrain(seq_length=4 * falcon.max_position_embeddings,
                      micro_batch_size=1, global_batch_size=1)).validate()


def test_padded_vocab_is_never_a_target_or_a_sample():
    """Cross entropy and sampling both mask the padded columns: a padded
    column holding the largest logit changes neither."""
    rng = np.random.default_rng(5)
    vocab, width = 250, 256
    logits = torch.from_numpy(rng.normal(size=(3, width)).astype(np.float32))
    logits[:, vocab:] = 100.0
    for greedy in (True, False):
        tok, _ = _sample_slots(logits, [1, 2, 3], [0, 0, 0], [greedy] * 3,
                               [1.0] * 3, [0] * 3, [0.0] * 3, vocab)
        assert int(tok.max()) < vocab
    from megatron_llm_tpu_torch.parallel.cross_entropy import cross_entropy

    targets = torch.tensor([0, 7, 249])
    got = cross_entropy(logits, targets, vocab_size=vocab)
    want = cross_entropy(logits[:, :vocab], targets)
    torch.testing.assert_close(got, want)


# ---------------------------------------------------------------------------
# Serving: greedy tokens from the two engines
# ---------------------------------------------------------------------------

SLICE = dict(max_batch_size=2, max_seq_len=64, kv_block_size=8,
             prefill_bucket=8, prefix_cache_blocks=0, trace=False)
LENS = (3, 9, 5, 14)
NEW = (6, 4, 9, 5)


def _serve(engine, prompts):
    engine.start()
    try:
        handles = [engine.submit(p, n, use_eos_stop=False)
                   for p, n in zip(prompts, NEW)]
        return [h.result(timeout=300).tokens for h in handles]
    finally:
        engine.shutdown()


@pytest.mark.parametrize("family,attn,norm", CASES)
def test_family_greedy_tokens_match_jax(family, attn, norm):
    """For GPT the padded vocab rows of the tied embedding are scaled up,
    so that a padded id holds the largest unmasked logit: both engines
    must still pick only real ids, and the same ones."""
    jc, jp, tc, _ = _pair(family, attn, norm)
    jp = jax.tree.map(np.array, jp)          # writable copies
    if family == "gpt":
        jp["embedding"]["word"][jc.vocab_size:] *= 50.0
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jc.vocab_size, n).tolist() for n in LENS]
    if family == "gpt":
        logits = tm.forward(tc, tp, torch.tensor(prompts[3])[None])
        assert int((logits.argmax(-1) >= tc.vocab_size).sum()) > 0
    want = _serve(JServingEngine(jc, jax.tree.map(jnp.asarray, jp),
                                 JEngineConfig(**SLICE)), prompts)
    got = _serve(ServingEngine(tc, tp, EngineConfig(**SLICE), device="cpu"),
                 prompts)
    assert got == want
    assert all(0 <= t < tc.vocab_size for toks in got for t in toks)


# ---------------------------------------------------------------------------
# The training entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["--model", "gpt", "--model_size", "125m", "--seq_length", "128"],
    ["--model", "falcon", "--model_size", "7b", "--seq_length", "64",
     "--hidden_dropout", "0.1"],
])
def test_finetune_builds_family_configs(argv):
    """``--model falcon|gpt`` resolves to the preset (its norm_impl and
    widths) with the dropout flags in effect."""
    args = tfinetune.parse_args(argv + ["--mock_data", "--device", "cpu"])
    cfg = tfinetune.build_config(args)
    assert cfg.model.norm_type == "layernorm"
    assert cfg.model.norm_impl == "xla"
    if args.model == "gpt":
        assert (cfg.model.hidden_size, cfg.model.num_layers) == (768, 12)
        assert cfg.model.padded_vocab_size() == 50304
    else:
        assert (cfg.model.num_attention_heads, cfg.model.kv_heads) == (71, 1)
        assert cfg.model.hidden_dropout == 0.1


def test_finetune_trains_gpt_125m_on_cpu(capsys):
    argv = ["--model", "gpt", "--model_size", "125m", "--seq_length", "128",
            "--mock_data", "--train_iters", "2", "--device", "cpu",
            "--log_interval", "1", "--eval_iters", "0"]
    assert tfinetune.main(argv) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("lm loss:")[1].split("|")[0])
              for line in out.splitlines() if "lm loss:" in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
