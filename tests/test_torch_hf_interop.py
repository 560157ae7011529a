"""HF / Meta / PEFT weight conversion of the port against the JAX
package's converters and against ``transformers`` itself.

Tiny ``transformers`` models are built here from a seed: Llama with GQA,
Llama with linear, llama3 and yarn RoPE scaling, Falcon in its old (MQA)
and new (GQA, two norms) architectures, and GPT-2.  For each: the port's
converter equals the JAX converter leaf for leaf, bit for bit, in fp32;
the port's fp32 forward of the imported params matches the HF logits
within 2e-4 (the JAX test's limit, tests/models/test_hf_parity.py); and
``*_to_hf`` gives back the HF state dict bit for bit.  ``config_from_hf``
equals JAX's field for field, from the config object and from its dict.
"""

import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import jax  # noqa: E402

from megatron_llm_tpu.tools import hf_interop as jhf  # noqa: E402
from megatron_llm_tpu_torch.models import model as tmodel  # noqa: E402
from megatron_llm_tpu_torch.tools import hf_interop as thf  # noqa: E402
from megatron_llm_tpu_torch.utils.tree import (  # noqa: E402
    tree_leaves_with_path,
)

torch.set_num_threads(2)

HF_LOGIT_TOL = 2e-4
KW = dict(params_dtype="float32", attention_impl="dot", recompute="none",
          make_vocab_size_divisible_by=8)


def _llama(seed, **kw):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=128,
                rms_norm_eps=1e-5, rope_theta=10000.0,
                tie_word_embeddings=False, attn_implementation="eager")
    base.update(kw)
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(
        transformers.LlamaConfig(**base)).eval()


def _falcon(seed, new_arch):
    kw = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, hidden_dropout=0.0,
              attention_dropout=0.0, parallel_attn=True, bias=False,
              alibi=False, max_position_embeddings=64,
              attn_implementation="eager")
    if new_arch:
        kw.update(new_decoder_architecture=True, num_kv_heads=2)
    else:
        kw.update(multi_query=True, new_decoder_architecture=False)
    torch.manual_seed(seed)
    return transformers.FalconForCausalLM(
        transformers.FalconConfig(**kw)).eval()


def _gpt2(seed):
    torch.manual_seed(seed)
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        attn_implementation="eager")).eval()


# name -> (HF model, family, config overrides, tokens [b, s])
CASES = {
    "llama-gqa": (lambda: _llama(0, num_hidden_layers=3), "llama", {},
                  (2, 48)),
    "llama-linear": (lambda: _llama(1, num_key_value_heads=4,
                                    rope_scaling={"type": "linear",
                                                  "factor": 2.0}),
                     "llama", {}, (1, 64)),
    "llama-llama3": (lambda: _llama(11, num_attention_heads=8,
                                    intermediate_size=112,
                                    max_position_embeddings=64,
                                    rope_theta=500000.0,
                                    rope_scaling={
                                        "rope_type": "llama3",
                                        "factor": 8.0,
                                        "low_freq_factor": 1.0,
                                        "high_freq_factor": 4.0,
                                        "original_max_position_embeddings":
                                            32}),
                     "llama", {}, (2, 60)),
    "llama-yarn": (lambda: _llama(21, intermediate_size=112,
                                  rope_scaling={
                                      "rope_type": "yarn", "factor": 4.0,
                                      "original_max_position_embeddings":
                                          32}),
                   "llama", {}, (2, 100)),
    "falcon-7b-mqa": (lambda: _falcon(2, False), "falcon",
                      {"activation": "gelu_exact"}, (2, 32)),
    "falcon-40b-gqa": (lambda: _falcon(2, True), "falcon",
                       {"activation": "gelu_exact"}, (2, 32)),
    "gpt2": (lambda: _gpt2(3), "gpt2", {}, (2, 32)),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, family, over, shape = CASES[request.param]
    hf = make()
    kw = dict(KW, seq_length=shape[1], **over)
    jcfg = jhf.config_from_hf(hf.config, family, **kw)
    tcfg = thf.config_from_hf(hf.config, family, **kw)
    sd = hf.state_dict()
    jparams = jhf.CONVERTERS_FROM_HF[family](sd, jcfg)
    tparams = thf.CONVERTERS_FROM_HF[family](sd, tcfg, device="cpu")
    return dict(name=request.param, hf=hf, family=family, kw=kw,
                jcfg=jcfg, tcfg=tcfg, sd=sd, jparams=jparams,
                tparams=tparams, shape=shape)


def _jax_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_converter_equals_jax_bitwise(case):
    jleaves = {jax.tree_util.keystr(p) for p, _ in
               jax.tree_util.tree_leaves_with_path(case["jparams"])}
    tleaves = tree_leaves_with_path(case["tparams"])
    assert len(tleaves) == len(jleaves)
    for path, leaf in tleaves:
        want = _jax_leaf(case["jparams"], path)
        assert leaf.is_contiguous(), path
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), want, err_msg=str(path))


def test_port_forward_matches_transformers(case):
    tokens = np.random.default_rng(7).integers(0, 128, case["shape"])
    with torch.no_grad():
        ref = case["hf"](torch.tensor(tokens)).logits.float()
        ours = tmodel.forward(case["tcfg"], case["tparams"],
                              torch.tensor(tokens))[..., :128]
    diff = float((ours - ref).abs().max())
    assert diff < HF_LOGIT_TOL, f"{case['name']} logit diff {diff}"


def test_to_hf_round_trip_is_bitwise(case):
    back = thf.CONVERTERS_TO_HF[case["family"]](case["tparams"],
                                                case["tcfg"])
    sd = case["sd"]
    # HF keeps tied / non-persistent entries the export need not write
    skip = ("rotary_emb.inv_freq", ".attn.bias", ".attn.masked_bias")
    for k, v in sd.items():
        if k.endswith(skip):
            continue
        assert k in back, k
        assert back[k].is_contiguous()
        assert torch.equal(back[k], v), k
    assert set(back) <= set(sd) | {"lm_head.weight"}


def test_export_is_computed_a_leaf_at_a_time(case, tmp_path):
    """``*_to_hf`` give each leaf's shape and dtype on the meta device
    before computing it, and the writer streams the export to files that
    read back as the leaves."""
    from megatron_llm_tpu_torch import safetensors_io

    back = thf.CONVERTERS_TO_HF[case["family"]](case["tparams"],
                                                case["tcfg"])
    for k in back:
        spec, leaf = back.spec(k), back[k]
        assert spec.device.type == "meta"
        assert (spec.shape, spec.dtype) == (leaf.shape, leaf.dtype), k
    safetensors_io.save_sharded(back, tmp_path)
    got = safetensors_io.open_sharded(tmp_path)
    assert set(got) == set(back)
    for k in back:
        assert torch.equal(got[k], back[k]), k


def test_config_from_hf_equals_jax(case):
    j = dataclasses.asdict(case["jcfg"])
    t = dataclasses.asdict(case["tcfg"])
    assert t == j
    as_dict = thf.config_from_hf(case["hf"].config.to_dict(),
                                 case["family"], **case["kw"])
    assert as_dict == case["tcfg"]


def test_bf16_import_keeps_the_bits():
    """A bf16 checkpoint imported in bf16 is bitwise the HF tensors
    (the permutation moves data, and bf16 -> fp32 -> bf16 is exact),
    equal to the JAX converter's fp32 output rounded to bf16."""
    hf = _llama(5).to(torch.bfloat16)
    cfg = thf.config_from_hf(hf.config, "llama", **dict(
        KW, params_dtype="bfloat16"))
    sd = hf.state_dict()
    params = thf.llama_from_hf(sd, cfg, dtype=torch.bfloat16, device="cpu")
    jparams = jhf.llama_from_hf(sd, jhf.config_from_hf(hf.config, "llama",
                                                       **KW))
    for path, leaf in tree_leaves_with_path(params):
        assert leaf.dtype == torch.bfloat16 and leaf.is_contiguous()
        want = torch.from_numpy(_jax_leaf(jparams, path)).to(torch.bfloat16)
        assert torch.equal(leaf, want), path
    back = thf.llama_to_hf(params, cfg)
    for k, v in sd.items():
        if not k.endswith("rotary_emb.inv_freq"):
            assert back[k].dtype == torch.bfloat16
            assert torch.equal(back[k], v), k


def test_interleave_permutation_equals_jax():
    w = np.random.default_rng(0).standard_normal((4 * 8, 6)).astype(
        np.float32)
    np.testing.assert_array_equal(thf.hf_to_interleaved(w, 4, 8).numpy(),
                                  jhf.hf_to_interleaved(w, 4, 8))
    np.testing.assert_array_equal(thf.interleaved_to_hf(w, 4, 8).numpy(),
                                  jhf.interleaved_to_hf(w, 4, 8))
    assert torch.equal(thf.interleaved_to_hf(thf.hf_to_interleaved(
        w, 4, 8), 4, 8), torch.from_numpy(w))


@pytest.mark.parametrize("family,cfg,match", [
    ("llama", transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4,
        rope_scaling={"rope_type": "dynamic", "factor": 2.0}),
     "rope_scaling"),
    ("llama", transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=112,
        num_hidden_layers=2, num_attention_heads=4,
        rope_scaling={"rope_type": "yarn", "factor": 2.0, "mscale": 0.7,
                      "original_max_position_embeddings": 32}),
     "yarn"),
    ("falcon", transformers.FalconConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=4, alibi=True), "ALiBi"),
    ("falcon", transformers.FalconConfig(
        vocab_size=64, hidden_size=32, num_hidden_layers=1,
        num_attention_heads=4, bias=True), "bias"),
    ("bert", transformers.BertConfig(), "unsupported HF model family"),
], ids=["dynamic", "yarn-mscale", "falcon-alibi", "falcon-bias", "bert"])
def test_unsupported_configs_raise_as_in_jax(family, cfg, match):
    with pytest.raises(ValueError, match=match):
        jhf.config_from_hf(cfg, family)
    for src in (cfg, cfg.to_dict()):
        with pytest.raises(ValueError, match=match):
            thf.config_from_hf(src, family)


# ---------------------------------------------------------------------------
# Meta release shards
# ---------------------------------------------------------------------------


def _meta_cfgs():
    from megatron_llm_tpu.config import tiny_config as jtiny
    from megatron_llm_tpu_torch.config import tiny_config as ttiny

    kw = dict(num_layers=2, hidden_size=64, num_attention_heads=8,
              num_kv_heads=4, ffn_hidden_size=96, vocab_size=128,
              make_vocab_size_divisible_by=1, params_dtype="float32")
    return jtiny(**kw), ttiny(**kw)


def _meta_state_dict(jcfg, seed):
    """A Meta-format state dict of the JAX package's random params (Meta
    keeps ``[out, in]`` weights in the interleaved RoPE layout)."""
    from megatron_llm_tpu.models import model as jmodel

    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.key(seed),
                                                    jcfg))
    L = p["layers"]
    sd = {"tok_embeddings.weight": p["embedding"]["word"],
          "norm.weight": p["final_norm"]["scale"],
          "output.weight": p["lm_head"].T.copy(),
          "rope.freqs": np.zeros((jcfg.head_dim // 2,), np.float32)}
    names = {"attention_norm": ("input_norm", "scale"),
             "ffn_norm": ("post_attn_norm", "scale"),
             "attention.wq": ("attn", "wq"), "attention.wk": ("attn", "wk"),
             "attention.wv": ("attn", "wv"), "attention.wo": ("attn", "wo"),
             "feed_forward.w1": ("mlp", "w_gate"),
             "feed_forward.w3": ("mlp", "w_up"),
             "feed_forward.w2": ("mlp", "w_down")}
    for i in range(jcfg.num_layers):
        for meta, (g, k) in names.items():
            w = L[g][k][i]
            sd[f"layers.{i}.{meta}.weight"] = w.T.copy() if w.ndim == 2 \
                else w
    return sd


def _shard(sd, n):
    shards = [dict() for _ in range(n)]
    for key, w in sd.items():
        axis = jhf._meta_shard_axis(key)
        parts = ([w] * n if axis is None else np.split(w, n, axis=axis))
        for s, piece in zip(shards, parts):
            s[key] = torch.from_numpy(np.array(piece))
    return shards


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_meta_shards_merge_and_convert_as_jax(n_shards):
    jcfg, tcfg = _meta_cfgs()
    sd = _meta_state_dict(jcfg, seed=n_shards)
    shards = _shard(sd, n_shards)
    merged = thf.merge_meta_shards(shards)
    jmerged = jhf.merge_meta_shards(shards)
    assert set(merged) == set(jmerged) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(merged[k].numpy(), jmerged[k])
    params = thf.llama_from_meta(merged, tcfg, device="cpu")
    want = jhf.llama_from_meta(jmerged, jcfg)
    for path, leaf in tree_leaves_with_path(params):
        assert leaf.is_contiguous()
        np.testing.assert_array_equal(leaf.numpy(), _jax_leaf(want, path))


def test_meta_and_hf_paths_agree():
    """The same model through the Meta path (no permutation) and the HF
    path (rotate-half undone) lands on the same params."""
    jcfg, tcfg = _meta_cfgs()
    sd = _meta_state_dict(jcfg, seed=9)
    from_meta = thf.llama_from_meta(sd, tcfg, device="cpu")
    hf_sd = thf.llama_to_hf(from_meta, tcfg)
    from_hf = thf.llama_from_hf(hf_sd, tcfg, device="cpu")
    for (path, a), (_, b) in zip(tree_leaves_with_path(from_meta),
                                 tree_leaves_with_path(from_hf)):
        assert torch.equal(a, b), path


def test_load_meta_shards_orders_numerically(tmp_path):
    jcfg, _ = _meta_cfgs()
    sd = _meta_state_dict(jcfg, seed=4)
    for i, s in enumerate(_shard(sd, 2)):
        torch.save(s, tmp_path / f"consolidated.{i:02d}.pth")
    merged = thf.load_meta_shards(str(tmp_path))
    for k, v in sd.items():
        np.testing.assert_array_equal(merged[k].numpy(), v)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="consolidated"):
        thf.load_meta_shards(str(tmp_path / "empty"))


def test_unknown_meta_key_rejected():
    with pytest.raises(KeyError):
        thf._meta_shard_axis("layers.0.attention.bogus.weight")
    bogus = {"layers.0.attention.bogus.weight": torch.zeros(2)}
    with pytest.raises(KeyError):
        thf.merge_meta_shards([bogus, bogus])


# ---------------------------------------------------------------------------
# PEFT adapters
# ---------------------------------------------------------------------------

_PEFT_DIMS = {"q_proj": "self_attn", "k_proj": "self_attn",
              "v_proj": "self_attn", "o_proj": "self_attn",
              "gate_proj": "mlp", "up_proj": "mlp", "down_proj": "mlp"}


def _peft_cfgs():
    from megatron_llm_tpu.config import tiny_config as jtiny
    from megatron_llm_tpu_torch.config import tiny_config as ttiny

    kw = dict(num_layers=2, vocab_size=64, make_vocab_size_divisible_by=8)
    return jtiny(**kw), ttiny(**kw)


def _peft_state_dict(cfg, rank, seed=0, projs=None, infix=""):
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv, ffn = cfg.num_attention_heads, cfg.kv_heads, cfg.ffn_size
    dims = {"q_proj": (h, nq * d), "k_proj": (h, nkv * d),
            "v_proj": (h, nkv * d), "o_proj": (nq * d, h),
            "gate_proj": (h, ffn), "up_proj": (h, ffn),
            "down_proj": (ffn, h)}
    rng = np.random.default_rng(seed)
    sd = {}
    for i in range(cfg.num_layers):
        for proj in projs or dims:
            fin, fout = dims[proj]
            pre = f"base_model.model.model.layers.{i}.{_PEFT_DIMS[proj]}." \
                  f"{proj}"
            sd[f"{pre}.lora_A{infix}.weight"] = 0.1 * rng.standard_normal(
                (rank, fin)).astype(np.float32)
            sd[f"{pre}.lora_B{infix}.weight"] = 0.1 * rng.standard_normal(
                (fout, rank)).astype(np.float32)
    return sd


@pytest.mark.parametrize("infix", ["", ".default"], ids=["plain", "default"])
def test_peft_factors_equal_jax(infix):
    jcfg, tcfg = _peft_cfgs()
    sd = _peft_state_dict(tcfg, 4, infix=infix)
    conf = {"r": 4, "lora_alpha": 16}
    jad = jhf.lora_from_peft(sd, conf, jcfg)
    tad = thf.lora_from_peft(sd, conf, tcfg, device="cpu")
    assert (tad.rank, tad.alpha) == (jad.rank, jad.alpha)
    assert set(tad.targets) == set(jad.targets)
    for t in tad.targets:
        for k in ("a", "b"):
            assert tad.factors[t][k].is_contiguous()
            np.testing.assert_array_equal(tad.factors[t][k].numpy(),
                                          np.asarray(jad.factors[t][k]))


def test_peft_guards_as_jax():
    _, tcfg = _peft_cfgs()
    sd = _peft_state_dict(tcfg, 4)
    for conf, match in (({"use_rslora": True}, "rsLoRA"),
                        ({"use_dora": True}, "DoRA"),
                        ({"rank_pattern": {"q_proj": 8}}, "rank_pattern"),
                        ({"r": 8}, "rank")):
        with pytest.raises(ValueError, match=match):
            thf.lora_from_peft(sd, {"r": 4, "lora_alpha": 8, **conf}, tcfg,
                               device="cpu")
    with pytest.raises(ValueError, match="no recognized"):
        thf.lora_from_peft({"not.a.lora.key": np.zeros((2, 2))},
                           {"r": 4}, tcfg, device="cpu")
    partial = {k: v for k, v in sd.items() if ".layers.0." in k}
    with pytest.raises(ValueError, match="missing"):
        thf.lora_from_peft(partial, {"r": 4}, tcfg, device="cpu")


def test_peft_adapter_serves_through_the_registry(tmp_path):
    """A PEFT directory (safetensors) loads, registers in the port's
    registry and changes what the engine generates; the JAX import of the
    same directory, carried across, gives the same tokens."""
    from safetensors.numpy import save_file

    from megatron_llm_tpu_torch.convert import adapter_from_jax
    from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
    from megatron_llm_tpu_torch.serving.adapters import AdapterRegistry

    jcfg, tcfg = _peft_cfgs()
    sd = _peft_state_dict(tcfg, 4, projs=("q_proj", "v_proj"), seed=3)
    save_file(sd, str(tmp_path / "adapter_model.safetensors"))
    (tmp_path / "adapter_config.json").write_text(
        '{"r": 4, "lora_alpha": 8, "target_modules": ["q_proj", "v_proj"]}')
    port = thf.load_peft_adapter(str(tmp_path), tcfg, device="cpu")
    carried = adapter_from_jax(jhf.load_peft_adapter(str(tmp_path), jcfg),
                               device="cpu")
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    prompt = [5, 9, 2, 33, 17, 4]
    out = {}
    for name, ad in (("port", port), ("jax", carried)):
        reg = AdapterRegistry(tcfg, 2, 4, ("wq", "wv"), device="cpu")
        reg.register("peft", ad)
        engine = ServingEngine(tcfg, params, EngineConfig(
            max_batch_size=2, max_seq_len=32, idle_wait_s=0.005,
            adapter_cache_slots=2, prefix_cache_blocks=0), adapters=reg,
            device="cpu").start()
        try:
            out[name] = engine.submit(prompt, 8, use_eos_stop=False,
                                      adapter_id="peft").result(600).tokens
            out["base"] = engine.submit(prompt, 8, use_eos_stop=False
                                        ).result(600).tokens
        finally:
            engine.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"] != out["base"]
