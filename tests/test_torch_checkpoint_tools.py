"""The port's weight tools on tiny local HF models: the trust harness
(``tools/verify_correctness.py``), the four ``checkpoint_util``
subcommands, ``verify_checkpoint`` (the cases of
tests/tools/test_verify_checkpoint.py), and finetuning that saves, resumes
and starts from an imported release checkpoint."""

import dataclasses
import json
import math
import shutil

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from megatron_llm_tpu.tools import hf_interop as jhf  # noqa: E402
from megatron_llm_tpu_torch import checkpointing as ckpt  # noqa: E402
from megatron_llm_tpu_torch import finetune  # noqa: E402
from megatron_llm_tpu_torch.config import (  # noqa: E402
    OptimizerConfig,
    RuntimeConfig,
    TrainConfig,
    tiny_config,
)
from megatron_llm_tpu_torch.models import model as model_lib  # noqa: E402
from megatron_llm_tpu_torch.tools import checkpoint_util  # noqa: E402
from megatron_llm_tpu_torch.tools import hf_interop  # noqa: E402
from megatron_llm_tpu_torch.tools import verify_checkpoint  # noqa: E402
from megatron_llm_tpu_torch.tools import verify_correctness  # noqa: E402
from megatron_llm_tpu_torch.utils.tree import (  # noqa: E402
    tree_leaves,
    tree_leaves_with_path,
)

torch.set_num_threads(2)
HF_LOGIT_TOL = 2e-4


def tiny_hf_llama(seed=0):
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False, attn_implementation="eager")).eval()


def _cfg_of(hf, **kw):
    return hf_interop.config_from_hf(
        hf.config, "llama", **dict(dict(
            params_dtype="float32", attention_impl="dot", recompute="none",
            make_vocab_size_divisible_by=8, seq_length=48), **kw))


# ---------------------------------------------------------------------------
# verify_correctness
# ---------------------------------------------------------------------------


def test_verify_passes_on_a_converted_model():
    hf = tiny_hf_llama()
    cfg = _cfg_of(hf)
    params = hf_interop.llama_from_hf(hf.state_dict(), cfg, device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 128, (2, 48)) for _ in range(3)]
    report = verify_correctness.verify(cfg, params, hf, batches)
    assert report["passed"] and report["iters"] == 3
    assert report["avg_max_abs_err"] < HF_LOGIT_TOL
    assert report["avg_loss_delta"] < 1e-4
    # the caller's matmul settings come back
    assert torch.get_float32_matmul_precision() == "highest"


def test_verify_restores_the_callers_precision():
    hf = tiny_hf_llama()
    cfg = _cfg_of(hf)
    params = hf_interop.llama_from_hf(hf.state_dict(), cfg, device="cpu")
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        verify_correctness.verify(cfg, params, hf,
                                  [np.zeros((1, 8), np.int64)])
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("corrupt", ["norm-scale", "qk-permutation"])
def test_verify_detects_corruption(corrupt):
    hf = tiny_hf_llama()
    cfg = _cfg_of(hf)
    sd = hf.state_dict()
    params = hf_interop.llama_from_hf(sd, cfg, device="cpu")
    if corrupt == "norm-scale":
        params["final_norm"]["scale"] = params["final_norm"]["scale"] * 1.05
    else:  # layer 1's Q imported without undoing rotate-half
        params["layers"]["attn"]["wq"][1].copy_(
            sd["model.layers.1.self_attn.q_proj.weight"].T)
    batches = [np.random.default_rng(0).integers(0, 128, (2, 48))]
    assert not verify_correctness.verify(cfg, params, hf, batches)["passed"]


def test_verify_takes_a_plain_callable():
    """A reference that returns a logits tensor (the port's own plain
    forward, as on a machine without transformers) works."""
    hf = tiny_hf_llama()
    cfg = _cfg_of(hf)
    params = hf_interop.llama_from_hf(hf.state_dict(), cfg, device="cpu")
    report = verify_correctness.verify(
        cfg, params, lambda t: model_lib.forward(cfg, params, t),
        [np.random.default_rng(1).integers(0, 128, (1, 32))])
    assert report["passed"] and report["avg_max_abs_err"] == 0.0


def test_verify_cli(tmp_path, capsys):
    hf = tiny_hf_llama()
    hf.save_pretrained(str(tmp_path / "hf"))
    rc = verify_correctness.main([
        "--hf_path", str(tmp_path / "hf"), "--iters", "2",
        "--batch_size", "2", "--seq_length", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert '"passed": true' in out
    with pytest.raises(NotImplementedError, match="item 7"):
        verify_correctness.main(["--hf_path", str(tmp_path / "hf"),
                                 "--data_path", "corpus", "--device", "cpu"])


# ---------------------------------------------------------------------------
# checkpoint_util
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A tiny HF Llama saved as safetensors, converted by hf-to-native."""
    root = tmp_path_factory.mktemp("conv")
    hf = tiny_hf_llama()
    hf.save_pretrained(str(root / "hf_in"))
    assert checkpoint_util.main([
        "hf-to-native", "--hf_path", str(root / "hf_in"),
        "--output", str(root / "native"), "--device", "cpu"]) == 0
    return root, hf


def test_hf_to_native_equals_the_jax_converter(converted):
    root, hf = converted
    assert ckpt.read_tracker(str(root / "native")) == "release"
    cfg = ckpt.load_config_from_checkpoint(str(root / "native")).model
    params = ckpt.load_params_for_inference(str(root / "native"), cfg,
                                            device="cpu")
    jcfg = jhf.config_from_hf(hf.config, "llama")
    want = jhf.llama_from_hf(hf.state_dict(), jcfg)
    for path, leaf in tree_leaves_with_path(params):
        w = want
        for k in path:
            w = w[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(w))
    report = verify_correctness.verify(
        cfg, params, hf, [np.random.default_rng(0).integers(0, 128, (2, 32))])
    assert report["passed"], report


def test_hf_to_native_reads_pytorch_model_bin(converted, tmp_path):
    root, hf = converted
    hf.save_pretrained(str(tmp_path / "bin"), safe_serialization=False)
    assert (tmp_path / "bin" / "pytorch_model.bin").exists()
    checkpoint_util.hf_to_native(str(tmp_path / "bin"),
                                 str(tmp_path / "native"), device="cpu")
    cfg = ckpt.load_config_from_checkpoint(str(tmp_path / "native")).model
    a = ckpt.load_params_for_inference(str(tmp_path / "native"), cfg,
                                       device="cpu")
    b = ckpt.load_params_for_inference(str(root / "native"), cfg,
                                       device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_resave_casts_and_round_trips(converted, tmp_path):
    root, hf = converted
    checkpoint_util.main(["resave", "--load", str(root / "native"),
                          "--output", str(tmp_path / "bf16"),
                          "--dtype", "bfloat16", "--device", "cpu"])
    cfg = ckpt.load_config_from_checkpoint(str(tmp_path / "bf16"))
    assert cfg.model.params_dtype == "bfloat16"
    bf16 = ckpt.load_params_for_inference(str(tmp_path / "bf16"), cfg.model,
                                          device="cpu")
    fp32_cfg = ckpt.load_config_from_checkpoint(str(root / "native")).model
    fp32 = ckpt.load_params_for_inference(str(root / "native"), fp32_cfg,
                                          device="cpu")
    for a, b in zip(tree_leaves(bf16), tree_leaves(fp32)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b.bfloat16())
    checkpoint_util.main(["resave", "--load", str(root / "native"),
                          "--output", str(tmp_path / "same"),
                          "--device", "cpu"])
    same = ckpt.load_params_for_inference(str(tmp_path / "same"), fp32_cfg,
                                          device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(same),
                                                 tree_leaves(fp32)))


@pytest.mark.parametrize("hf_base", [True, False],
                         ids=["hf-base-config", "derived-config"])
def test_native_to_hf_loads_in_transformers(converted, tmp_path, hf_base):
    """native-to-hf writes a directory transformers loads, with the
    original weights bit for bit and the port's logits within 2e-4."""
    root, hf = converted
    argv = ["native-to-hf", "--load", str(root / "native"),
            "--output", str(tmp_path / "hf_out"), "--device", "cpu"]
    if hf_base:
        argv += ["--hf_base", str(root / "hf_in")]
    checkpoint_util.main(argv)
    back = transformers.AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "hf_out")).eval()
    new = back.state_dict()
    for k, v in hf.state_dict().items():
        if not k.endswith("rotary_emb.inv_freq"):
            assert torch.equal(new[k], v), k
    cfg = ckpt.load_config_from_checkpoint(str(root / "native")).model
    params = ckpt.load_params_for_inference(str(root / "native"), cfg,
                                            device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 128,
                                                               (2, 40)))
    with torch.no_grad():
        ref = back(tokens).logits.float()
        ours = model_lib.forward(cfg, params, tokens)[..., :128]
    assert float((ours - ref).abs().max()) < HF_LOGIT_TOL


@pytest.mark.parametrize("family", ["falcon", "gpt2"])
def test_native_to_hf_other_families(tmp_path, family):
    """Falcon and GPT-2 exports (derived configs) load in transformers
    and give the port's logits."""
    torch.manual_seed(5)
    if family == "falcon":
        hf = transformers.FalconForCausalLM(transformers.FalconConfig(
            vocab_size=96, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, multi_query=True, parallel_attn=True,
            bias=False, new_decoder_architecture=False,
            attn_implementation="eager")).eval()
        over = {"activation": "gelu_exact"}
    else:
        hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
            vocab_size=96, n_embd=48, n_layer=2, n_head=4, n_positions=64,
            attn_implementation="eager")).eval()
        over = {}
    hf.save_pretrained(str(tmp_path / "in"))
    checkpoint_util.hf_to_native(str(tmp_path / "in"), str(tmp_path / "n"),
                                 device="cpu")
    checkpoint_util.native_to_hf(str(tmp_path / "n"), str(tmp_path / "out"),
                                 device="cpu")
    back = transformers.AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "out"), attn_implementation="eager").eval()
    cfg = ckpt.load_config_from_checkpoint(str(tmp_path / "n")).model
    cfg = dataclasses.replace(cfg, **over)
    params = ckpt.load_params_for_inference(str(tmp_path / "n"), cfg,
                                            device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 96,
                                                               (2, 24)))
    with torch.no_grad():
        ref = back(tokens).logits.float()
        ours = model_lib.forward(cfg, params, tokens)[..., :96]
    assert float((ours - ref).abs().max()) < HF_LOGIT_TOL


def test_meta_to_native_end_to_end(tmp_path):
    """consolidated.*.pth shards + params.json on disk → a release
    checkpoint equal to JAX's llama_from_meta of the same shards."""
    from megatron_llm_tpu.tools import checkpoint_util as jcu

    hf = tiny_hf_llama(seed=4)
    cfg = _cfg_of(hf)
    params = hf_interop.llama_from_hf(hf.state_dict(), cfg, device="cpu")
    L = params["layers"]
    sd = {"tok_embeddings.weight": params["embedding"]["word"][:128],
          "norm.weight": params["final_norm"]["scale"],
          "output.weight": params["lm_head"].T[:128].contiguous()}
    names = {"attention_norm": ("input_norm", "scale"),
             "ffn_norm": ("post_attn_norm", "scale"),
             "attention.wq": ("attn", "wq"), "attention.wk": ("attn", "wk"),
             "attention.wv": ("attn", "wv"), "attention.wo": ("attn", "wo"),
             "feed_forward.w1": ("mlp", "w_gate"),
             "feed_forward.w3": ("mlp", "w_up"),
             "feed_forward.w2": ("mlp", "w_down")}
    for i in range(cfg.num_layers):
        for meta, (g, k) in names.items():
            w = L[g][k][i]
            sd[f"layers.{i}.{meta}.weight"] = (w.T if w.ndim == 2
                                               else w).contiguous()
    shards = [{}, {}]
    for key, w in sd.items():
        axis = jhf._meta_shard_axis(key)
        parts = [w, w] if axis is None else torch.chunk(w, 2, dim=axis)
        for s, piece in zip(shards, parts):
            s[key] = piece.clone()
    for i, s in enumerate(shards):
        torch.save(s, tmp_path / f"consolidated.{i:02d}.pth")
    (tmp_path / "params.json").write_text(json.dumps({
        "dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
        "norm_eps": 1e-5, "vocab_size": 128, "multiple_of": 32}))
    assert checkpoint_util.main(["meta-to-native", "--meta_dir",
                                 str(tmp_path), "--output",
                                 str(tmp_path / "rel"), "--device",
                                 "cpu"]) == 0
    loaded_cfg = ckpt.load_config_from_checkpoint(str(tmp_path / "rel"))
    assert loaded_cfg.model.ffn_size == 176  # from the tensors
    jcfg = jcu.config_from_meta_params(json.loads(
        (tmp_path / "params.json").read_text()), 128)
    assert checkpoint_util.config_from_meta_params(json.loads(
        (tmp_path / "params.json").read_text()), 128).ffn_size == \
        jcfg.ffn_size
    got = ckpt.load_params_for_inference(str(tmp_path / "rel"),
                                         loaded_cfg.model, device="cpu")
    want = jhf.llama_from_meta(jhf.merge_meta_shards(shards),
                               dataclasses.replace(jcfg,
                                                   ffn_hidden_size=176))
    for path, leaf in tree_leaves_with_path(got):
        w = want
        for k in path:
            w = w[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# verify_checkpoint (tests/tools/test_verify_checkpoint.py)
# ---------------------------------------------------------------------------


def _good_root(tmp_path, iteration=3):
    cfg = RuntimeConfig(model=tiny_config(), optimizer=OptimizerConfig(),
                        train=TrainConfig(seq_length=32)).validate()
    ckpt.save_checkpoint(str(tmp_path), {"w": torch.ones(8)}, cfg,
                         iteration=iteration, meta={"consumed_samples": 12})
    return str(tmp_path)


def test_verify_checkpoint_ok_on_healthy_root(tmp_path, capsys):
    assert verify_checkpoint.main([_good_root(tmp_path)]) == 0
    assert "OK" in capsys.readouterr().out


@pytest.mark.parametrize("damage", [
    "missing-root", "empty-root", "torn-payload", "corrupt-tracker",
    "corrupt-meta", "corrupt-config", "corrupt-state-json",
    "truncated-tensors"])
def test_verify_checkpoint_fails(tmp_path, damage):
    if damage == "missing-root":
        assert verify_checkpoint.main([str(tmp_path / "nope")]) != 0
        return
    if damage == "empty-root":
        assert verify_checkpoint.main([str(tmp_path)]) != 0
        return
    root = _good_root(tmp_path)
    it = tmp_path / "iter_0000003"
    if damage == "torn-payload":
        (it / "state" / ckpt.COMMIT_MARKER).unlink()
    elif damage == "corrupt-tracker":
        (tmp_path / ckpt.TRACKER_FILENAME).write_text("???")
    elif damage == "corrupt-meta":
        (it / "meta.json").write_text("{truncated")
    elif damage == "corrupt-config":
        (it / "config.json").write_text("not json")
    elif damage == "corrupt-state-json":
        (it / "state" / ckpt.STATE_JSON).write_text("{")
    else:
        (it / "state" / "model.safetensors").write_bytes(b"\x10\x00")
    assert verify_checkpoint.main([root]) != 0


def test_verify_checkpoint_pinned_iteration(tmp_path):
    root = _good_root(tmp_path, iteration=3)
    assert verify_checkpoint.main([root, "--iteration", "3"]) == 0
    assert verify_checkpoint.main([root, "--iteration", "7"]) != 0


@pytest.mark.parametrize("hygiene", ["stray-staging", "incomplete-older"])
def test_verify_checkpoint_hygiene_warns_then_strict_fails(tmp_path,
                                                           hygiene):
    root = _good_root(tmp_path)
    if hygiene == "stray-staging":
        (tmp_path / ("iter_0000009" + ckpt.STAGING_SUFFIX)).mkdir()
    else:
        (tmp_path / "iter_0000001" / "state").mkdir(parents=True)
    assert verify_checkpoint.main([root]) == 0
    assert verify_checkpoint.main([root, "--strict"]) != 0


def test_verify_checkpoint_release(converted):
    root, _ = converted
    assert verify_checkpoint.main([str(root / "native")]) == 0


# ---------------------------------------------------------------------------
# finetune: --save / --load / --use_checkpoint_args, and from a release
# ---------------------------------------------------------------------------


def _finetune(argv, capsys):
    base = ["--model", "tiny", "--mock_data", "--device", "cpu",
            "--log_interval", "1", "--seq_length", "16",
            "--global_batch_size", "2", "--micro_batch_size", "1",
            "--params_dtype", "float32", "--eval_iters", "0"]
    assert finetune.main(base + argv) == 0
    out = capsys.readouterr().out
    return [float(line.split("lm loss:")[1].split("|")[0])
            for line in out.splitlines() if "lm loss:" in line], out


def test_finetune_save_then_resume_equals_straight(tmp_path, capsys):
    straight, _ = _finetune(["--train_iters", "4"], capsys)
    first, _ = _finetune(["--train_iters", "4", "--exit_interval", "2",
                          "--save", str(tmp_path / "ck")], capsys)
    assert ckpt.read_tracker(str(tmp_path / "ck")) == 2
    second, out = _finetune(["--train_iters", "4", "--load",
                             str(tmp_path / "ck"), "--save",
                             str(tmp_path / "ck"), "--save_interval", "3"],
                            capsys)
    assert "loaded checkpoint" in out
    assert first + second == straight
    assert ckpt.list_iterations(str(tmp_path / "ck")) == [2, 3, 4]


def test_finetune_use_checkpoint_args(tmp_path, capsys):
    """--use_checkpoint_args takes the model from the checkpoint, whatever
    the command line's preset says."""
    _finetune(["--train_iters", "1", "--save", str(tmp_path / "ck")],
              capsys)
    args = finetune.parse_args(["--model", "llama2", "--load",
                                str(tmp_path / "ck"),
                                "--use_checkpoint_args", "--device", "cpu",
                                "--seq_length", "16", "--mock_data"])
    cfg = finetune.build_config(args)
    assert cfg.model == ckpt.load_config_from_checkpoint(
        str(tmp_path / "ck")).model
    assert cfg.model.hidden_size == tiny_config().hidden_size


def test_finetune_from_an_imported_release(converted, tmp_path, capsys):
    """hf-to-native's release checkpoint finetunes under the checkpoint's
    own config, with a fresh optimizer, and saves its progress."""
    root, hf = converted
    rel = tmp_path / "rel"
    shutil.copytree(root / "native", rel)
    losses, out = _finetune(["--train_iters", "3", "--load", str(rel),
                             "--use_checkpoint_args", "--save",
                             str(tmp_path / "ft"), "--lr", "1e-2"], capsys)
    assert "loaded checkpoint" in out and "iteration release" in out
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert losses[-1] != losses[0]
    assert ckpt.read_tracker(str(tmp_path / "ft")) == 3
    # log(128) for a random tiny model's near-uniform predictions
    assert abs(losses[0] - math.log(128)) < 0.5
