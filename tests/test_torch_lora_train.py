"""LoRA finetuning (``training/lora.py``) against the JAX package's, on
the CPU: factor-only training against a frozen base, the serving
epilogue's math, the adapter-only checkpoint, and the entry's
``--lora_rank`` / ``--lora_load``.

Both packages start from the JAX package's base weights and adapter
(``params_from_jax``, ``adapter_from_jax``: A drawn from a JAX key, B
zero) and take the same numpy batches.  fp32 throughout: losses agree to
1e-5 and trained factors to 1e-4 relative, the limits of the full train
step's comparison (``tests/test_torch_train.py``).
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.ops import lora as jlora
from megatron_llm_tpu.training import lora as jtlora
from megatron_llm_tpu.training import optimizer as jopt
from megatron_llm_tpu_torch import finetune as tfinetune
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import adapter_from_jax, params_from_jax
from megatron_llm_tpu_torch.models import model as tm
from megatron_llm_tpu_torch.ops import lora as tlora
from megatron_llm_tpu_torch.serving.adapters import AdapterRegistry
from megatron_llm_tpu_torch.training import driver as tdriver
from megatron_llm_tpu_torch.training import lora as ttlora
from megatron_llm_tpu_torch.training import optimizer as topt
from megatron_llm_tpu_torch.training import step as tstep
from megatron_llm_tpu_torch.utils.tree import tree_leaves, tree_map

torch.set_num_threads(1)

ALL = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _cfgs(model_kw=None, **train_kw):
    model_kw = dict(dict(num_layers=2, vocab_size=64,
                         make_vocab_size_divisible_by=8), **(model_kw or {}))
    train = dict(dict(train_iters=6, micro_batch_size=2, global_batch_size=4,
                      seq_length=16, log_interval=0), **train_kw)
    opt = dict(lr=5e-2, clip_grad=1.0, lr_warmup_iters=1)
    jc = JRun(model=jtiny(**model_kw), optimizer=JOpt(**opt),
              train=JTrain(**train)).validate()
    tc = TRun(model=ttiny(**model_kw), optimizer=TOpt(**opt),
              train=TTrain(**train)).validate()
    return jc, tc


def _batch(cfg, seed, accum=2):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.model.vocab_size,
                        (accum, cfg.train.micro_batch_size,
                         cfg.train.seq_length)).astype(np.int32)
    mask = (rng.random(toks.shape) > 0.1).astype(np.float32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
            "loss_mask": mask}


def _both(jc, tc, targets=None, alpha=None):
    jbase = jm.init_params(jax.random.key(0), jc.model)
    jad = jlora.init_lora_adapter(jc.model, jax.random.key(1), 4,
                                  targets=targets, alpha=alpha)
    tbase = params_from_jax(jax.tree.map(np.asarray, jbase), "cpu")
    tad = adapter_from_jax(jad, "cpu")
    return jbase, jad, tbase, tad


@pytest.mark.parametrize("model_kw,targets,alpha", [
    ({}, None, None),
    (dict(attention_impl="flash", norm_impl="pallas",
          recompute="selective"), ALL, 8.0),
    (dict(recompute="full", fused_lm_head=True), ("wq", "wo", "w_down"),
     16.0),
])
def test_lora_steps_match_jax(model_kw, targets, alpha):
    """Five steps of ``make_lora_step`` (grad accumulation 2, a new batch
    each step) from factors carried by ``convert``: per-step loss and grad
    norm, and the trained factors, against JAX's.  The third case takes
    the fused head, which JAX's LoRA loss does not (it unembeds): the
    same loss to fp32 rounding."""
    jc, tc = _cfgs(model_kw)
    jbase, jad, tbase, tad = _both(jc, tc, targets, alpha)
    jstep_ = jtlora.make_lora_step(jc, jbase, jad)
    tstep_ = ttlora.make_lora_step(tc, tbase, tad)
    jf, jo = jad.factors, jopt.init_opt_state(jad.factors, jc.optimizer)
    tf = tree_map(lambda f: f.clone(), tad.factors)
    to = topt.init_opt_state(tf, tc.optimizer)
    for it in range(5):
        batch = _batch(jc, 20 + it)
        jf, jo, jmet = jstep_(jf, jo, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                              jnp.int32(it))
        tf, to, tmet = tstep_(tf, to, tstep.to_device_batch(batch, "cpu"),
                              it)
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-5, abs=1e-5)
        # at lr 5e-2 (JAX's test) each step's fp32 rounding moves the
        # next step's factors (3e-5 relative after five), which the grad
        # norm of so small a tree feels more than the loss: 2.2e-4 at the
        # fifth step of the recompute cases
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=5e-4)
        assert tmet["lr"] == pytest.approx(float(jmet["lr"]), rel=1e-6)
    for t in tad.targets:
        for k in ("a", "b"):
            want = np.asarray(jf[t][k])
            got = tf[t][k].numpy()
            assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
            # elementwise: an Adam step at lr 5e-2 moves an element ~0.05,
            # and the fp32 drift above leaves up to 3.4e-5 on a few
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert to.step == 5


@pytest.mark.parametrize("fused", [False, True])
def test_base_frozen_and_step0_is_the_base_bitwise(fused):
    """B = 0: step 0's loss is the base model's loss bit for bit (the same
    microbatch sums); no base tensor moves or takes a grad; B departs from
    zero and the loss on a repeated batch falls."""
    jc, tc = _cfgs(dict(fused_lm_head=fused))
    _, _, tbase, tad = _both(jc, tc)
    before = [t.clone() for t in tree_leaves(tbase)]
    batch = tstep.to_device_batch(_batch(jc, 3), "cpu")
    with torch.no_grad():
        base_loss = torch.zeros((), dtype=torch.float32)
        for i in range(2):
            base_loss = base_loss + tstep.compute_loss(
                tc, tbase, {k: v[i] for k, v in batch.items()})
        base_loss = base_loss / 2
    step = ttlora.make_lora_step(tc, tbase, tad)
    factors = tree_map(lambda f: f.clone(), tad.factors)
    opt = topt.init_opt_state(factors, tc.optimizer)
    losses = []
    for it in range(8):
        factors, opt, met = step(factors, opt, batch, it)
        losses.append(met["loss"])
    assert torch.equal(losses[0], base_loss)
    assert float(losses[-1]) < float(losses[0])
    for a, b in zip(before, tree_leaves(tbase)):
        assert torch.equal(a, b) and b.grad is None and not b.requires_grad
    assert bool(torch.any(factors["wq"]["b"] != 0))


@pytest.mark.parametrize("recompute", ["none", "selective", "full"])
def test_factor_grads_flow_under_every_recompute_policy(recompute):
    """Gradients reach A and B through ``_lora_add`` on the uncached path
    under each policy, and the three policies agree bit for bit."""
    grads = {}
    for policy in ("none", recompute):
        _, tc = _cfgs(dict(recompute=policy))
        base = tm.init_params(tc.model, seed=0, device="cpu")
        gen = torch.Generator().manual_seed(1)
        ad = tlora.init_lora_adapter(tc.model, gen, 4, targets=ALL)
        leaves = []
        for f in tree_leaves(ad.factors):
            if not f.any():     # a live B, so that A's grad is not zero
                f = 0.1 * torch.randn(f.shape, generator=gen)
            leaves.append(f.requires_grad_(True))
        factors = dict(zip(ad.factors, [
            {"a": a, "b": b} for a, b in zip(leaves[::2], leaves[1::2])]))
        mb = {k: v[0] for k, v in tstep.to_device_batch(
            _batch(_cfgs()[0], 5), "cpu").items()}
        mask = torch.ones(mb["tokens"].shape[0], 4)
        loss = tstep.compute_loss(tc, base, mb, lora=(factors, mask))
        grads[policy] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["none"], grads[recompute]):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)


def test_training_epilogue_is_the_serving_epilogue():
    """The training forward (α/r folded into B, an all-ones mask, Sr = r)
    equals the serving arena's (the adapter installed in slot 1 of 2, a
    slot mask), and JAX's training forward, within 1e-5."""
    jc, tc = _cfgs()
    jbase, jad, tbase, tad = _both(jc, tc, alpha=8.0)
    gen = torch.Generator().manual_seed(9)
    factors = {t: {"a": f["a"], "b": 0.1 * torch.randn(f["b"].shape,
                                                        generator=gen)}
               for t, f in tad.factors.items()}
    scale = tad.scale
    toks = torch.tensor([[3, 5, 7, 11]])
    arenas_t = {t: {"a": f["a"], "b": f["b"] * scale}
                for t, f in factors.items()}
    out_train = tm.forward(tc.model, tbase, toks,
                           lora=(arenas_t, torch.ones(1, tad.rank)))
    arenas_s = tlora.make_arenas(tc.model, 2, tad.rank, tad.targets,
                                 device="cpu")
    tlora.install_adapter(arenas_s, factors, 1, scale, tad.rank)
    mask_s = tlora.slot_mask(torch.tensor([1]), 2, tad.rank)
    out_serve = tm.forward(tc.model, tbase, toks, lora=(arenas_s, mask_s))
    torch.testing.assert_close(out_train, out_serve, atol=1e-5, rtol=1e-5)
    j_arenas = {t: {"a": jnp.asarray(f["a"].numpy()),
                    "b": jnp.asarray((f["b"] * scale).numpy())}
                for t, f in factors.items()}
    j_out = jm.forward(jc.model, jbase, jnp.asarray(toks.numpy()),
                       lora=(j_arenas, jnp.ones((1, tad.rank))))
    np.testing.assert_allclose(out_train.detach().numpy(), np.asarray(j_out),
                               atol=1e-5, rtol=1e-5)


def test_lora_finetune_end_to_end_saves_and_serves(tmp_path, capsys):
    """``lora_finetune`` on mock data: the JAX log lines, an adapter-only
    checkpoint at ``<save>/adapter`` that loads back bitwise, registers
    with ``register_path`` and serves: the engine's greedy tokens with the
    adapter equal greedy decoding of the training forward with the same
    factors."""
    from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine

    _, tc = _cfgs(log_interval=3)
    base = tm.init_params(tc.model, seed=0, device="cpu")
    ds = tfinetune._MockDataset(tc.model.vocab_size, tc.train.seq_length,
                                n=64)
    trained = ttlora.lora_finetune(tc, base, ds, rank=4, alpha=16.0,
                                   save=str(tmp_path))
    out = capsys.readouterr().out
    assert "lora finetune: rank=4 alpha=16.0 targets=('wq', 'wv')" in out
    assert len(re.findall(r"lora iteration +\d+/ +6 \| lm loss:", out)) == 2
    assert "saved adapter-only checkpoint" in out
    back = tlora.load_adapter(str(tmp_path / "adapter"))
    for t in trained.targets:
        for k in ("a", "b"):
            assert torch.equal(back.factors[t][k], trained.factors[t][k])
    assert bool(torch.any(back.factors["wq"]["b"] != 0))

    reg = AdapterRegistry(tc.model, 2, 4, ("wq", "wv"), device="cpu")
    reg.register_path("trained", str(tmp_path / "adapter"))
    prompt, new = [5, 9, 2, 33, 17, 4], 6
    engine = ServingEngine(tc.model, base, EngineConfig(
        max_batch_size=2, max_seq_len=32, adapter_cache_slots=2,
        prefix_cache_blocks=0), adapters=reg, device="cpu").start()
    try:
        got = engine.submit(prompt, new, use_eos_stop=False,
                            adapter_id="trained").result(600).tokens
    finally:
        engine.shutdown()
    arenas = {t: {"a": f["a"], "b": f["b"] * back.scale}
              for t, f in back.factors.items()}
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(new):
            logits = tm.forward(tc.model, base, torch.tensor([toks]),
                                lora=(arenas, torch.ones(1, 4)))
            toks.append(int(logits[0, -1, :tc.model.vocab_size].argmax()))
    assert got == toks


def test_moe_mlp_targets_rejected():
    _, tc = _cfgs()
    moe = dataclasses.replace(tc, model=dataclasses.replace(
        tc.model, num_experts=4))
    with pytest.raises(ValueError, match="MoE"):
        ttlora._check_targets(moe, ("wq", "w_up"))
    ttlora._check_targets(moe, ("wq", "wv"))


def _losses(out):
    return [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+)", out)]


def _argv(*extra):
    return ["--model", "tiny", "--mock_data", "--device", "cpu",
            "--seq_length", "16", "--params_dtype", "float32",
            "--log_interval", "1", "--train_iters", "3", "--lora_rank", "4",
            *extra]


def test_finetune_main_lora_saves_and_resumes(tmp_path, capsys):
    """``finetune.main --lora_rank`` on the CPU: a fresh base from the
    seed, an adapter-only ``--save``, then ``--lora_load`` of it: the
    resumed run starts from the trained factors (its first loss is the
    trained adapter's on that batch, not the base's), and equals
    ``lora_finetune`` called with the loaded adapter."""
    assert tfinetune.main(_argv("--save", str(tmp_path / "a"))) == 0
    first = _losses(capsys.readouterr().out)
    path = tmp_path / "a" / "adapter"
    assert (path / "adapter.npz").exists() and len(first) == 3
    assert tfinetune.main(_argv("--lora_load", str(path))) == 0
    out = capsys.readouterr().out
    resumed = _losses(out)
    assert f"continuing adapter {path}" in out
    assert resumed[0] != first[0] and all(np.isfinite(resumed))
    args = tfinetune.parse_args(_argv())
    cfg = tfinetune.build_config(args)
    base = tm.init_params(cfg.model, seed=cfg.train.seed, device="cpu")
    train_ds, _, _ = tfinetune.build_datasets(args, cfg)
    ttlora.lora_finetune(cfg, base, train_ds, rank=4,
                         adapter=tlora.load_adapter(str(path)))
    assert _losses(capsys.readouterr().out) == resumed


def test_finetune_main_resumes_a_peft_adapter(tmp_path, capsys):
    """``--lora_load`` of a PEFT directory (``adapter_model.safetensors``,
    all seven projections): the first logged loss is the base model's
    with the PEFT delta merged into its weights, on the first batch."""
    from safetensors.numpy import save_file

    args = tfinetune.parse_args(_argv())
    cfg = tfinetune.build_config(args)
    m = cfg.model
    dims = {"q_proj": ("self_attn", m.hidden_size, m.num_attention_heads
                       * m.head_dim),
            "v_proj": ("self_attn", m.hidden_size, m.kv_heads * m.head_dim),
            "down_proj": ("mlp", m.ffn_size, m.hidden_size)}
    rng = np.random.default_rng(7)
    sd = {}
    for i in range(m.num_layers):
        for proj, (grp, fin, fout) in dims.items():
            pre = f"base_model.model.model.layers.{i}.{grp}.{proj}"
            sd[f"{pre}.lora_A.weight"] = 0.1 * rng.standard_normal(
                (4, fin)).astype(np.float32)
            sd[f"{pre}.lora_B.weight"] = 0.1 * rng.standard_normal(
                (fout, 4)).astype(np.float32)
    save_file(sd, str(tmp_path / "adapter_model.safetensors"))
    (tmp_path / "adapter_config.json").write_text(json.dumps(
        {"r": 4, "lora_alpha": 8}))
    assert tfinetune.main(_argv("--lora_load", str(tmp_path))) == 0
    got = _losses(capsys.readouterr().out)[0]

    from megatron_llm_tpu_torch.tools.hf_interop import load_peft_adapter

    base = tm.init_params(m, seed=cfg.train.seed, device="cpu")
    merged = tlora.merge_adapter(base, load_peft_adapter(str(tmp_path), m,
                                                         device="cpu"))
    train_ds, _, _ = tfinetune.build_datasets(args, cfg)
    batch = next(tdriver._build_train_iterator(
        cfg, train_ds, 0, cfg.train.global_batch_size, True))
    mb = {k: v[0] for k, v in tstep.to_device_batch(batch, "cpu").items()}
    with torch.no_grad():
        want = float(tstep.compute_loss(cfg, merged, mb))
    assert got == pytest.approx(want, rel=1e-5)
