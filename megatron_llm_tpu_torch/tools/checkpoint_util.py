"""Weight import, export and re-save between HF / Meta directories and the
port's checkpoints (mirror of ``megatron_llm_tpu/tools/checkpoint_util.py``):

  hf-to-native    HF model directory → release checkpoint (+ config.json)
  meta-to-native  Meta release directory (consolidated.NN.pth shards and
                  params.json) → release checkpoint
  native-to-hf    port checkpoint → HF model directory (config.json and
                  safetensors shards with their index)
  resave          any port checkpoint → a release checkpoint, optionally
                  cast to another dtype

HF directories are read and written through ``safetensors_io`` and
``hf_interop`` alone: no ``transformers``.  Tensors move leaf by leaf
between the disk and ``--device`` (default ``cuda``): a read maps one
leaf's file pages at a time and drops them after its copy, and a write
computes one leaf (an export's, lazily) and moves it to the host in 64
MiB pieces.  With ``--device cpu`` the converted tree itself lives in
host memory.

    python -m megatron_llm_tpu_torch.tools.checkpoint_util hf-to-native \\
        --hf_path /weights/Llama-2-7b-hf --output /ckpts/llama2-7b \\
        --dtype bfloat16
    python -m megatron_llm_tpu_torch.tools.checkpoint_util meta-to-native \\
        --meta_dir /weights/llama-2-7b --output /ckpts/llama2-7b
    python -m megatron_llm_tpu_torch.tools.checkpoint_util native-to-hf \\
        --load /ckpts/run1 --output /out/hf
    python -m megatron_llm_tpu_torch.tools.checkpoint_util resave \\
        --load /ckpts/run1 --output /ckpts/run1-release --dtype bfloat16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import time
from pathlib import Path
from typing import Optional

import torch

from .. import checkpointing
from ..config import ModelConfig, RuntimeConfig, llama2_config
from ..models import model as model_lib
from ..utils.tree import tree_leaves
from .. import safetensors_io
from . import hf_interop


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def hf_to_native(hf_path: str, output: str, family: Optional[str] = None,
                 dtype: str = "float32", device=None) -> dict:
    """Convert an HF directory into a release checkpoint under ``output``;
    returns the parameter count, bytes and each stage's seconds."""
    device = model_lib.default_device(device)
    hf_cfg = json.loads((Path(hf_path) / "config.json").read_text())
    family = family or hf_cfg["model_type"]
    cfg = hf_interop.config_from_hf(hf_cfg, family, params_dtype=dtype)
    t0 = time.perf_counter()
    params = hf_interop.CONVERTERS_FROM_HF[family](
        safetensors_io.hf_state_dict(hf_path, device=device), cfg,
        dtype=cfg.dtype, device=device)
    _sync(device)
    t1 = time.perf_counter()
    checkpointing.save_release_params(output, params, RuntimeConfig(model=cfg))
    t2 = time.perf_counter()
    stats = {"params": model_lib.num_params(params), "bytes": _nbytes(params),
             "import_s": t1 - t0, "save_s": t2 - t1}
    print(f"wrote release checkpoint: {output} ({stats['params']:,} params)")
    return stats


def config_from_meta_params(params_json: dict, vocab_size: int,
                            dtype: str = "float32") -> ModelConfig:
    """Meta release ``params.json`` → native ``ModelConfig``.  Meta stores
    ``dim / n_layers / n_heads [/ n_kv_heads]`` and the SwiGLU sizing
    inputs; the ffn width is ``2/3 · 4·dim``, scaled by
    ``ffn_dim_multiplier``, rounded up to ``multiple_of``."""
    dim = params_json["dim"]
    hidden = int(2 * 4 * dim / 3)
    mult = params_json.get("ffn_dim_multiplier")
    if mult is not None:
        hidden = int(mult * hidden)
    multiple_of = params_json.get("multiple_of", 256)
    ffn = multiple_of * (-(-hidden // multiple_of))
    kwargs = dict(
        hidden_size=dim,
        num_layers=params_json["n_layers"],
        num_attention_heads=params_json["n_heads"],
        ffn_hidden_size=ffn,
        vocab_size=vocab_size,
        norm_eps=params_json.get("norm_eps", 1e-5),
        params_dtype=dtype,
    )
    if "n_kv_heads" in params_json:
        kwargs["num_kv_heads"] = params_json["n_kv_heads"]
    if "rope_theta" in params_json:
        kwargs["rope_theta"] = params_json["rope_theta"]
    return llama2_config("7b", **kwargs)


def meta_to_native(meta_dir: str, output: str, dtype: str = "float32",
                   device=None) -> None:
    """Meta release directory → release checkpoint."""
    device = model_lib.default_device(device)
    params_json = json.loads((Path(meta_dir) / "params.json").read_text())
    sd = hf_interop.load_meta_shards(meta_dir)
    vocab = params_json.get("vocab_size", -1)
    if vocab is None or vocab <= 0:
        vocab = sd["tok_embeddings.weight"].shape[0]
    cfg = config_from_meta_params(params_json, vocab, dtype)
    # params.json under-determines the ffn width (multiple_of rounding
    # varies across releases): the tensor decides
    ffn_actual = sd["layers.0.feed_forward.w1.weight"].shape[0]
    if ffn_actual != cfg.ffn_size:
        cfg = dataclasses.replace(cfg, ffn_hidden_size=ffn_actual).validate()
    params = hf_interop.llama_from_meta(sd, cfg, dtype=cfg.dtype,
                                        device=device)
    checkpointing.save_release_params(output, params, RuntimeConfig(model=cfg))
    print(f"wrote release checkpoint: {output} "
          f"({model_lib.num_params(params):,} params)")


def _iteration(iteration: Optional[str]):
    if iteration is None or iteration == checkpointing.RELEASE:
        return iteration
    return int(iteration)


def native_to_hf(load: str, output: str, hf_base: Optional[str] = None,
                 family: Optional[str] = None,
                 iteration: Optional[str] = None, device=None) -> dict:
    """A port checkpoint → an HF directory: ``config.json`` (``hf_base``'s,
    or one derived from the native config) and safetensors shards with
    their index (shards of at most 5 GB).  Returns the bytes written and
    the seconds taken."""
    device = model_lib.default_device(device)
    it = _iteration(iteration)
    model_cfg = checkpointing.load_config_from_checkpoint(load, it).model
    family = family or _infer_family(model_cfg)
    t0 = time.perf_counter()
    params = checkpointing.load_params_for_inference(load, model_cfg, it,
                                                     device=device)
    _sync(device)
    t1 = time.perf_counter()
    sd = hf_interop.CONVERTERS_TO_HF[family](params, model_cfg)
    out = Path(output)
    out.mkdir(parents=True, exist_ok=True)
    if hf_base is not None:
        shutil.copyfile(Path(hf_base) / "config.json", out / "config.json")
    else:
        (out / "config.json").write_text(json.dumps(
            _hf_config_from_native(model_cfg, family), indent=2))
    safetensors_io.save_sharded(sd, out)
    t2 = time.perf_counter()
    print(f"wrote HF model: {output}")
    return {"bytes": safetensors_io.nbytes(sd), "load_s": t1 - t0,
            "export_s": t2 - t1}


def resave(load: str, output: str, dtype: Optional[str] = None,
           iteration: Optional[str] = None, device=None) -> None:
    """Any port checkpoint → a release checkpoint, optionally cast."""
    it = _iteration(iteration)
    cfg = checkpointing.load_config_from_checkpoint(load, it)
    model_cfg = cfg.model
    if dtype is not None:
        model_cfg = dataclasses.replace(model_cfg, params_dtype=dtype)
        cfg = dataclasses.replace(cfg, model=model_cfg)
    # the loader casts to model_cfg's dtype
    params = checkpointing.load_params_for_inference(load, model_cfg, it,
                                                     device=device)
    checkpointing.save_release_params(output, params, cfg)
    print(f"resaved {load} -> {output} (release)")


def _infer_family(cfg: ModelConfig) -> str:
    if cfg.parallel_attn:
        return "falcon"
    if cfg.norm_type == "rmsnorm":
        return "llama"
    return "gpt2"


def _rope_scaling(cfg: ModelConfig) -> Optional[dict]:
    if cfg.rope_scaling_factor == 1.0:
        return None
    if cfg.rope_scaling_type == "llama3":
        return {"rope_type": "llama3", "factor": cfg.rope_scaling_factor,
                "low_freq_factor": cfg.rope_low_freq_factor,
                "high_freq_factor": cfg.rope_high_freq_factor,
                "original_max_position_embeddings":
                    cfg.rope_original_max_positions}
    if cfg.rope_scaling_type == "yarn":
        out = {"rope_type": "yarn", "factor": cfg.rope_scaling_factor,
               "beta_fast": cfg.rope_beta_fast,
               "beta_slow": cfg.rope_beta_slow,
               "original_max_position_embeddings":
                   cfg.rope_original_max_positions}
        if cfg.rope_attention_factor is not None:
            out["attention_factor"] = cfg.rope_attention_factor
        return out
    return {"rope_type": "linear", "factor": cfg.rope_scaling_factor}


def _hf_config_from_native(cfg: ModelConfig, family: str) -> dict:
    """The ``config.json`` of an HF model with ``cfg``'s architecture, as
    a plain dict."""
    dtype = str(cfg.dtype).removeprefix("torch.")
    if family == "llama":
        return {
            "architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.ffn_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.kv_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "rope_scaling": _rope_scaling(cfg), "hidden_act": "silu",
            "tie_word_embeddings": cfg.tie_embed_logits,
            "torch_dtype": dtype,
        }
    if family == "falcon":
        return {
            "architectures": ["FalconForCausalLM"], "model_type": "falcon",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_kv_heads": cfg.kv_heads,
            "layer_norm_epsilon": cfg.norm_eps,
            "parallel_attn": cfg.parallel_attn,
            "new_decoder_architecture": cfg.parallel_layernorm,
            "multi_query": cfg.kv_heads == 1, "bias": False, "alibi": False,
            "torch_dtype": dtype,
        }
    if family == "gpt2":
        return {
            "architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
            "vocab_size": cfg.vocab_size, "n_embd": cfg.hidden_size,
            "n_layer": cfg.num_layers, "n_head": cfg.num_attention_heads,
            "n_positions": cfg.max_position_embeddings,
            "layer_norm_epsilon": cfg.norm_eps, "torch_dtype": dtype,
        }
    raise ValueError(f"unknown family {family!r}")


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("hf-to-native")
    a.add_argument("--hf_path", required=True)
    a.add_argument("--output", required=True)
    a.add_argument("--model_family", default=None)
    a.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])

    m = sub.add_parser("meta-to-native")
    m.add_argument("--meta_dir", required=True,
                   help="dir with consolidated.NN.pth shards + params.json")
    m.add_argument("--output", required=True)
    m.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])

    b = sub.add_parser("native-to-hf")
    b.add_argument("--load", required=True)
    b.add_argument("--output", required=True)
    b.add_argument("--hf_base", default=None,
                   help="an HF directory whose config.json to copy")
    b.add_argument("--model_family", default=None)
    b.add_argument("--iteration", default=None)

    c = sub.add_parser("resave")
    c.add_argument("--load", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--dtype", default=None,
                   choices=[None, "float32", "bfloat16"])
    c.add_argument("--iteration", default=None)

    for sp in (a, m, b, c):
        sp.add_argument("--device", default="cuda",
                        help="torch device the tensors pass through (the "
                             "tests pass 'cpu')")

    args = p.parse_args(argv)
    if args.cmd == "hf-to-native":
        hf_to_native(args.hf_path, args.output, args.model_family,
                     args.dtype, args.device)
    elif args.cmd == "meta-to-native":
        meta_to_native(args.meta_dir, args.output, args.dtype, args.device)
    elif args.cmd == "native-to-hf":
        native_to_hf(args.load, args.output, args.hf_base,
                     args.model_family, args.iteration, args.device)
    else:
        resave(args.load, args.output, args.dtype, args.iteration,
               args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
