"""HuggingFace and Meta ↔ native weight conversion in torch (mirror of
``megatron_llm_tpu/tools/hf_interop.py``).

HF Llama and Falcon checkpoints store the Q/K projections in the
"rotate-half" RoPE layout, while this framework (like Meta and Megatron)
rotates interleaved even/odd pairs, so Q/K weights are (un)permuted on the
way in and out.  Outputs are the native parameter dict of
``models/model.py``: layers stacked on a leading axis, weights ``[in,
out]`` for ``x @ w``.

Where the JAX converters turn the whole state dict into fp32 numpy (27 GB
of host memory at 7B), these convert leaf by leaf: each output leaf is
allocated once on ``device`` in ``dtype``, and each layer's HF tensor is
read (a lazy state dict reads it from disk only then), permuted in its
own dtype, cast and copied into its row, then dropped.  The permutations
move data without arithmetic and a bf16 → fp32 → bf16 round trip is
exact, so a converted leaf equals the JAX converter's bit for bit in fp32,
and a bf16 checkpoint imported in bf16 keeps its bits.  Every output leaf
is contiguous (the fused decode kernels build TMA descriptors over the
stacked weights).  The way out is lazy too: ``*_to_hf`` return a mapping
that computes each HF tensor (contiguous, in the params' dtype, on their
device) when it is asked for, and ``safetensors_io.save_sharded`` asks
for one at a time, so an export holds no second copy of the model.  Meta
shards are merged one key at a time in the same way.

``config_from_hf`` takes a ``transformers`` config object or the plain
dict of a ``config.json``; nothing here imports ``transformers``.
"""

from __future__ import annotations

import json
import re
from functools import partial
from pathlib import Path
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .. import safetensors_io
from ..config import ModelConfig
from ..models.model import default_device
from ..utils.tree import tree_map


def _t(x) -> torch.Tensor:
    """A state-dict value (tensor or numpy array) as a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


# ---------------------------------------------------------------------------
# Rotary layout permutation (reference:
# weights_conversion/utils/permute_qkv.py)
# ---------------------------------------------------------------------------


def hf_to_interleaved(w, n_heads: int, head_dim: int) -> torch.Tensor:
    """Invert HF's rotate-half permutation on a ``[n*d, in]`` projection
    weight (HF stores ``w.view(n, d//2, 2, in).transpose(1, 2)`` of the
    interleaved original)."""
    w = _t(w)
    out_dim, in_dim = w.shape
    assert out_dim == n_heads * head_dim
    return w.reshape(n_heads, 2, head_dim // 2, in_dim).transpose(
        1, 2).reshape(out_dim, in_dim)


def interleaved_to_hf(w, n_heads: int, head_dim: int) -> torch.Tensor:
    w = _t(w)
    out_dim, in_dim = w.shape
    assert out_dim == n_heads * head_dim
    return w.reshape(n_heads, head_dim // 2, 2, in_dim).transpose(
        1, 2).reshape(out_dim, in_dim)


class _Builder:
    """Allocates each output leaf once and fills it layer by layer."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        self.L = cfg.num_layers
        self.dtype = dtype
        self.device = default_device(device)

    def leaf(self, x) -> torch.Tensor:
        x = _t(x)
        out = torch.empty(x.shape, dtype=self.dtype, device=self.device)
        out.copy_(x)
        return out

    def stack(self, fn: Callable[[int], torch.Tensor]) -> torch.Tensor:
        first = _t(fn(0))
        out = torch.empty((self.L,) + tuple(first.shape), dtype=self.dtype,
                          device=self.device)
        out[0].copy_(first)
        del first
        for i in range(1, self.L):
            out[i].copy_(_t(fn(i)))
        return out

    def padded_rows(self, w, rows: int) -> torch.Tensor:
        w = _t(w)
        out = torch.zeros((rows,) + tuple(w.shape[1:]), dtype=self.dtype,
                          device=self.device)
        out[:w.shape[0]].copy_(w)
        return out

    def padded_cols_t(self, w, rows: int) -> torch.Tensor:
        """``pad_rows(w, rows).T`` (the untied lm head ``[h, V_pad]``)."""
        w = _t(w)
        out = torch.zeros((w.shape[1], rows), dtype=self.dtype,
                          device=self.device)
        out[:, :w.shape[0]].copy_(w.T)
        return out


class _Export(Mapping):
    """An HF state dict computed leaf by leaf: ``[name]`` builds one
    contiguous tensor on the params' device (nothing is cached), and
    ``spec(name)`` gives its shape and dtype on the ``meta`` device, so a
    writer plans its files before it computes a leaf.  ``build(params)``
    maps each name to a call that computes the leaf from views of
    ``params``."""

    def __init__(self, build: Callable[[dict], dict], params: dict):
        self._leaves = build(params)
        self._specs = build(tree_map(
            lambda t: torch.empty_like(t, device="meta"), params))

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._leaves[name]()

    def spec(self, name: str) -> torch.Tensor:
        return self._specs[name]()

    def __iter__(self):
        return iter(self._leaves)

    def __len__(self) -> int:
        return len(self._leaves)


def _out(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous()


def _qk_to_hf(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """A native ``[in, n*d]`` Q or K stack row → HF's rotate-half
    ``[n*d, in]``."""
    return interleaved_to_hf(w.T, n_heads, head_dim).contiguous()


# ---------------------------------------------------------------------------
# Llama / Code Llama  (reference: hf_to_megatron.py llama_to_megatron)
# ---------------------------------------------------------------------------


def llama_from_hf(state_dict: Mapping, cfg: ModelConfig, tp: int = 1,
                  dtype=torch.float32, device=None) -> dict:
    """HF LlamaForCausalLM state dict → native params on ``device``
    (default ``cuda``) in ``dtype``."""
    sd = state_dict
    d, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    v_padded = cfg.padded_vocab_size(tp)
    b = _Builder(cfg, dtype, device)

    def pfx(i: int) -> str:
        return f"model.layers.{i}."

    return {
        "embedding": {
            "word": b.padded_rows(sd["model.embed_tokens.weight"], v_padded),
        },
        "layers": {
            "input_norm": {
                "scale": b.stack(lambda i: sd[pfx(i) + "input_layernorm.weight"]),
            },
            "post_attn_norm": {
                "scale": b.stack(
                    lambda i: sd[pfx(i) + "post_attention_layernorm.weight"]),
            },
            "attn": {
                "wq": b.stack(lambda i: hf_to_interleaved(
                    sd[pfx(i) + "self_attn.q_proj.weight"], nq, d).T),
                "wk": b.stack(lambda i: hf_to_interleaved(
                    sd[pfx(i) + "self_attn.k_proj.weight"], nkv, d).T),
                "wv": b.stack(
                    lambda i: _t(sd[pfx(i) + "self_attn.v_proj.weight"]).T),
                "wo": b.stack(
                    lambda i: _t(sd[pfx(i) + "self_attn.o_proj.weight"]).T),
            },
            "mlp": {
                "w_gate": b.stack(
                    lambda i: _t(sd[pfx(i) + "mlp.gate_proj.weight"]).T),
                "w_up": b.stack(
                    lambda i: _t(sd[pfx(i) + "mlp.up_proj.weight"]).T),
                "w_down": b.stack(
                    lambda i: _t(sd[pfx(i) + "mlp.down_proj.weight"]).T),
            },
        },
        "final_norm": {"scale": b.leaf(sd["model.norm.weight"])},
        "lm_head": b.padded_cols_t(sd["lm_head.weight"], v_padded),
    }


def llama_to_hf(params: dict, cfg: ModelConfig) -> Mapping:
    """Native params → HF LlamaForCausalLM state dict (inverse of
    ``llama_from_hf``; reference megatron_to_hf.py:80-197), computed a
    leaf at a time on access."""
    return _Export(partial(_llama_to_hf, cfg=cfg), params)


def _llama_to_hf(params: dict, cfg: ModelConfig) -> dict:
    d, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    v = cfg.vocab_size
    sd = {
        "model.embed_tokens.weight": partial(
            _out, params["embedding"]["word"][:v]),
        "model.norm.weight": partial(_out, params["final_norm"]["scale"]),
        "lm_head.weight": partial(_out, params["lm_head"].T[:v]),
    }
    L = params["layers"]
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = partial(
            _out, L["input_norm"]["scale"][i])
        sd[p + "post_attention_layernorm.weight"] = partial(
            _out, L["post_attn_norm"]["scale"][i])
        sd[p + "self_attn.q_proj.weight"] = partial(
            _qk_to_hf, L["attn"]["wq"][i], nq, d)
        sd[p + "self_attn.k_proj.weight"] = partial(
            _qk_to_hf, L["attn"]["wk"][i], nkv, d)
        sd[p + "self_attn.v_proj.weight"] = partial(_out, L["attn"]["wv"][i].T)
        sd[p + "self_attn.o_proj.weight"] = partial(_out, L["attn"]["wo"][i].T)
        sd[p + "mlp.gate_proj.weight"] = partial(_out,
                                                 L["mlp"]["w_gate"][i].T)
        sd[p + "mlp.up_proj.weight"] = partial(_out, L["mlp"]["w_up"][i].T)
        sd[p + "mlp.down_proj.weight"] = partial(_out,
                                                 L["mlp"]["w_down"][i].T)
    return sd


# ---------------------------------------------------------------------------
# Meta release checkpoints (consolidated.NN.pth); reference behaviour:
# weights_conversion/utils/merge_llama.py:1-80
# ---------------------------------------------------------------------------

# Which axis the consolidated.*.pth model-parallel shards concatenate
# along; None = replicated (every shard holds the full tensor).
_META_SHARD_AXIS = {
    "attention.wq.weight": 0,       # column-parallel: out-dim split
    "attention.wk.weight": 0,
    "attention.wv.weight": 0,
    "feed_forward.w1.weight": 0,    # gate proj
    "feed_forward.w3.weight": 0,    # up proj
    "output.weight": 0,             # lm head [vocab, h]: vocab split
    "attention.wo.weight": 1,       # row-parallel: in-dim split
    "feed_forward.w2.weight": 1,    # down proj
    "tok_embeddings.weight": 1,     # embedding split along hidden dim
    "attention_norm.weight": None,
    "ffn_norm.weight": None,
    "norm.weight": None,
    "rope.freqs": None,
}


def _meta_shard_axis(key: str):
    for suffix, axis in _META_SHARD_AXIS.items():
        if key.endswith(suffix):
            return axis
    raise KeyError(f"unrecognized Meta checkpoint key: {key!r}")


class _MetaMerged(Mapping):
    """Meta shards seen as one state dict: ``[key]`` concatenates that
    key's pieces when it is asked for (nothing is cached), so a converter
    holds one merged tensor at a time."""

    def __init__(self, shards: list):
        self._shards = shards
        # every key's axis up front: an unknown key fails the merge, as in
        # the JAX package (one shard needs no axes)
        self._axis = {k: (_meta_shard_axis(k) if len(shards) > 1 else None)
                      for k in shards[0]}

    def __getitem__(self, key: str) -> torch.Tensor:
        axis = self._axis[key]
        if axis is None:
            return _t(self._shards[0][key])
        return torch.cat([_t(s[key]) for s in self._shards], dim=axis)

    def __iter__(self):
        return iter(self._axis)

    def __len__(self) -> int:
        return len(self._axis)


def merge_meta_shards(shards: list) -> Mapping:
    """Merge Meta ``consolidated.*.pth`` shards (loaded state dicts, in
    rank order) into one state dict of tensors, a key at a time on
    access: column-parallel params concatenate along dim 0, row-parallel
    along dim 1, replicated ones come from shard 0."""
    return _MetaMerged(shards)


def load_meta_shards(root_dir: str) -> Mapping:
    """Load (memory-mapped) and merge every ``consolidated.NN.pth`` under
    ``root_dir``, in numeric shard order."""
    paths = sorted(
        (p for p in Path(root_dir).iterdir()
         if re.match(r"^consolidated\.\d+\.pth$", p.name)),
        key=lambda p: int(p.name.split(".")[1]))
    if not paths:
        raise FileNotFoundError(
            f"no consolidated.NN.pth shards under {root_dir}")
    shards = [torch.load(p, map_location="cpu", weights_only=True,
                         mmap=True) for p in paths]
    return merge_meta_shards(shards)


def llama_from_meta(state_dict: Mapping, cfg: ModelConfig, tp: int = 1,
                    dtype=torch.float32, device=None) -> dict:
    """Merged Meta state dict → native params.  Meta weights are already
    in the interleaved RoPE layout, so no permutation is applied."""
    sd = state_dict
    v_padded = cfg.padded_vocab_size(tp)
    b = _Builder(cfg, dtype, device)

    def w(i: int, name: str) -> torch.Tensor:
        return _t(sd[f"layers.{i}.{name}.weight"])

    return {
        "embedding": {
            "word": b.padded_rows(sd["tok_embeddings.weight"], v_padded),
        },
        "layers": {
            "input_norm": {"scale": b.stack(lambda i: w(i, "attention_norm"))},
            "post_attn_norm": {"scale": b.stack(lambda i: w(i, "ffn_norm"))},
            "attn": {
                "wq": b.stack(lambda i: w(i, "attention.wq").T),
                "wk": b.stack(lambda i: w(i, "attention.wk").T),
                "wv": b.stack(lambda i: w(i, "attention.wv").T),
                "wo": b.stack(lambda i: w(i, "attention.wo").T),
            },
            "mlp": {
                "w_gate": b.stack(lambda i: w(i, "feed_forward.w1").T),
                "w_up": b.stack(lambda i: w(i, "feed_forward.w3").T),
                "w_down": b.stack(lambda i: w(i, "feed_forward.w2").T),
            },
        },
        "final_norm": {"scale": b.leaf(sd["norm.weight"])},
        "lm_head": b.padded_cols_t(sd["output.weight"], v_padded),
    }


# ---------------------------------------------------------------------------
# Falcon  (reference: hf_to_megatron.py falcon_to_megatron)
# ---------------------------------------------------------------------------


def _split_falcon_qkv(fused, cfg: ModelConfig):
    """Falcon HF fuses QKV as ``[kv_heads, group_q + 1 k + 1 v, d, in]``."""
    d, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    group = nq // nkv
    w = _t(fused).reshape(nkv, group + 2, d, -1)
    q = w[:, :group].reshape(nq * d, -1)
    k = w[:, group].reshape(nkv * d, -1)
    v = w[:, group + 1].reshape(nkv * d, -1)
    return q, k, v


class _Unprefixed(Mapping):
    """``state_dict`` seen without the ``transformer.`` prefix (lazily:
    a lazy state dict stays lazy)."""

    def __init__(self, sd: Mapping):
        self._sd = sd
        self._keys = {k.replace("transformer.", ""): k for k in sd}

    def __getitem__(self, k):
        return self._sd[self._keys[k]]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)


def falcon_from_hf(state_dict: Mapping, cfg: ModelConfig, tp: int = 1,
                   dtype=torch.float32, device=None) -> dict:
    """HF FalconForCausalLM state dict → native params; falcon-7b (one
    input_layernorm) and falcon-40b (ln_attn + ln_mlp)."""
    sd = _Unprefixed(state_dict)
    d, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    v_padded = cfg.padded_vocab_size(tp)
    b = _Builder(cfg, dtype, device)

    def pfx(i):
        return f"h.{i}."

    def ln_name(i, which):
        if pfx(i) + "ln_attn.weight" in sd:  # 40b: ln_attn / ln_mlp
            return pfx(i) + ("ln_attn" if which == "attn" else "ln_mlp")
        return pfx(i) + "input_layernorm"

    # split and unpermute each layer's fused QKV once, into all three leaves
    attn = {}
    for i in range(cfg.num_layers):
        q, k, v = _split_falcon_qkv(
            sd[pfx(i) + "self_attention.query_key_value.weight"], cfg)
        rows = (hf_to_interleaved(q, nq, d).T, hf_to_interleaved(k, nkv, d).T,
                v.T)
        for name, x in zip(("wq", "wk", "wv"), rows):
            if name not in attn:
                attn[name] = torch.empty((cfg.num_layers,) + tuple(x.shape),
                                         dtype=b.dtype, device=b.device)
            attn[name][i].copy_(x)
        del q, k, v, rows
    attn["wo"] = b.stack(
        lambda i: _t(sd[pfx(i) + "self_attention.dense.weight"]).T)

    layers = {
        "input_norm": {
            "scale": b.stack(lambda i: sd[ln_name(i, "attn") + ".weight"]),
            "bias": b.stack(lambda i: sd[ln_name(i, "attn") + ".bias"]),
        },
        "attn": attn,
        "mlp": {
            "w_up": b.stack(
                lambda i: _t(sd[pfx(i) + "mlp.dense_h_to_4h.weight"]).T),
            "w_down": b.stack(
                lambda i: _t(sd[pfx(i) + "mlp.dense_4h_to_h.weight"]).T),
        },
    }
    if cfg.parallel_layernorm:
        layers["mlp_norm"] = {
            "scale": b.stack(lambda i: sd[ln_name(i, "mlp") + ".weight"]),
            "bias": b.stack(lambda i: sd[ln_name(i, "mlp") + ".bias"]),
        }
    return {
        "embedding": {
            "word": b.padded_rows(sd["word_embeddings.weight"], v_padded),
        },
        "layers": layers,
        "final_norm": {
            "scale": b.leaf(sd["ln_f.weight"]),
            "bias": b.leaf(sd["ln_f.bias"]),
        },
    }


# ---------------------------------------------------------------------------
# GPT-2  (HF GPT2LMHeadModel's Conv1D weights are already [in, out])
# ---------------------------------------------------------------------------


def gpt2_from_hf(state_dict: Mapping, cfg: ModelConfig, tp: int = 1,
                 dtype=torch.float32, device=None) -> dict:
    sd = _Unprefixed(state_dict)
    v_padded = cfg.padded_vocab_size(tp)
    b = _Builder(cfg, dtype, device)

    def pfx(i):
        return f"h.{i}."

    def qkv_w(i, idx):  # Conv1D weight [in, 3h]
        return torch.chunk(_t(sd[pfx(i) + "attn.c_attn.weight"]), 3, 1)[idx]

    def qkv_b(i, idx):
        return torch.chunk(_t(sd[pfx(i) + "attn.c_attn.bias"]), 3, 0)[idx]

    return {
        "embedding": {
            "word": b.padded_rows(sd["wte.weight"], v_padded),
            "position": b.leaf(sd["wpe.weight"]),
        },
        "layers": {
            "input_norm": {
                "scale": b.stack(lambda i: sd[pfx(i) + "ln_1.weight"]),
                "bias": b.stack(lambda i: sd[pfx(i) + "ln_1.bias"]),
            },
            "post_attn_norm": {
                "scale": b.stack(lambda i: sd[pfx(i) + "ln_2.weight"]),
                "bias": b.stack(lambda i: sd[pfx(i) + "ln_2.bias"]),
            },
            "attn": {
                "wq": b.stack(lambda i: qkv_w(i, 0)),
                "wk": b.stack(lambda i: qkv_w(i, 1)),
                "wv": b.stack(lambda i: qkv_w(i, 2)),
                "wo": b.stack(lambda i: sd[pfx(i) + "attn.c_proj.weight"]),
                "bq": b.stack(lambda i: qkv_b(i, 0)),
                "bk": b.stack(lambda i: qkv_b(i, 1)),
                "bv": b.stack(lambda i: qkv_b(i, 2)),
                "bo": b.stack(lambda i: sd[pfx(i) + "attn.c_proj.bias"]),
            },
            "mlp": {
                "w_up": b.stack(lambda i: sd[pfx(i) + "mlp.c_fc.weight"]),
                "b_up": b.stack(lambda i: sd[pfx(i) + "mlp.c_fc.bias"]),
                "w_down": b.stack(lambda i: sd[pfx(i) + "mlp.c_proj.weight"]),
                "b_down": b.stack(lambda i: sd[pfx(i) + "mlp.c_proj.bias"]),
            },
        },
        "final_norm": {
            "scale": b.leaf(sd["ln_f.weight"]),
            "bias": b.leaf(sd["ln_f.bias"]),
        },
    }


def _fuse_falcon_qkv(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Inverse of ``_split_falcon_qkv``: ``[*, in]`` rows → HF's fused
    layout."""
    d, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    group = nq // nkv
    h_in = q.shape[-1]
    return torch.cat([q.reshape(nkv, group, d, h_in),
                      k.reshape(nkv, 1, d, h_in),
                      v.reshape(nkv, 1, d, h_in)], dim=1).reshape(-1, h_in)


def _falcon_qkv_to_hf(wq, wk, wv, cfg: ModelConfig) -> torch.Tensor:
    d, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    return _fuse_falcon_qkv(interleaved_to_hf(wq.T, nq, d),
                            interleaved_to_hf(wk.T, nkv, d), wv.T, cfg)


def falcon_to_hf(params: dict, cfg: ModelConfig) -> Mapping:
    """Native params → HF FalconForCausalLM state dict (inverse of
    ``falcon_from_hf``: re-permuted to rotate-half and re-fused QKV),
    computed a leaf at a time on access."""
    return _Export(partial(_falcon_to_hf, cfg=cfg), params)


def _falcon_to_hf(params: dict, cfg: ModelConfig) -> dict:
    v = cfg.vocab_size
    word = params["embedding"]["word"][:v]
    sd = {
        "transformer.word_embeddings.weight": partial(_out, word),
        "transformer.ln_f.weight": partial(_out,
                                           params["final_norm"]["scale"]),
        "transformer.ln_f.bias": partial(_out, params["final_norm"]["bias"]),
        "lm_head.weight": partial(_out, word),
    }
    L = params["layers"]
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        norms = ((("ln_attn", "input_norm"), ("ln_mlp", "mlp_norm"))
                 if cfg.parallel_layernorm
                 else (("input_layernorm", "input_norm"),))
        for hf_name, native in norms:
            sd[p + hf_name + ".weight"] = partial(_out,
                                                  L[native]["scale"][i])
            sd[p + hf_name + ".bias"] = partial(_out, L[native]["bias"][i])
        a = L["attn"]
        sd[p + "self_attention.query_key_value.weight"] = partial(
            _falcon_qkv_to_hf, a["wq"][i], a["wk"][i], a["wv"][i], cfg)
        sd[p + "self_attention.dense.weight"] = partial(_out, a["wo"][i].T)
        sd[p + "mlp.dense_h_to_4h.weight"] = partial(
            _out, L["mlp"]["w_up"][i].T)
        sd[p + "mlp.dense_4h_to_h.weight"] = partial(
            _out, L["mlp"]["w_down"][i].T)
    return sd


def gpt2_to_hf(params: dict, cfg: ModelConfig) -> Mapping:
    """Native params → HF GPT2LMHeadModel state dict (Conv1D: weights stay
    ``[in, out]``); inverse of ``gpt2_from_hf``, computed a leaf at a time
    on access."""
    return _Export(partial(_gpt2_to_hf, cfg=cfg), params)


def _gpt2_to_hf(params: dict, cfg: ModelConfig) -> dict:
    v = cfg.vocab_size
    word = params["embedding"]["word"][:v]
    sd = {
        "transformer.wte.weight": partial(_out, word),
        "transformer.wpe.weight": partial(_out,
                                          params["embedding"]["position"]),
        "transformer.ln_f.weight": partial(_out,
                                           params["final_norm"]["scale"]),
        "transformer.ln_f.bias": partial(_out, params["final_norm"]["bias"]),
        "lm_head.weight": partial(_out, word),
    }
    L = params["layers"]
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        a, m = L["attn"], L["mlp"]
        sd[p + "ln_1.weight"] = partial(_out, L["input_norm"]["scale"][i])
        sd[p + "ln_1.bias"] = partial(_out, L["input_norm"]["bias"][i])
        sd[p + "ln_2.weight"] = partial(_out, L["post_attn_norm"]["scale"][i])
        sd[p + "ln_2.bias"] = partial(_out, L["post_attn_norm"]["bias"][i])
        sd[p + "attn.c_attn.weight"] = partial(
            torch.cat, [a["wq"][i], a["wk"][i], a["wv"][i]], dim=1)
        sd[p + "attn.c_attn.bias"] = partial(
            torch.cat, [a["bq"][i], a["bk"][i], a["bv"][i]])
        sd[p + "attn.c_proj.weight"] = partial(_out, a["wo"][i])
        sd[p + "attn.c_proj.bias"] = partial(_out, a["bo"][i])
        sd[p + "mlp.c_fc.weight"] = partial(_out, m["w_up"][i])
        sd[p + "mlp.c_fc.bias"] = partial(_out, m["b_up"][i])
        sd[p + "mlp.c_proj.weight"] = partial(_out, m["w_down"][i])
        sd[p + "mlp.c_proj.bias"] = partial(_out, m["b_down"][i])
    return sd


CONVERTERS_FROM_HF = {
    "llama": llama_from_hf,
    "falcon": falcon_from_hf,
    "gpt2": gpt2_from_hf,
}

CONVERTERS_TO_HF = {
    "llama": llama_to_hf,
    "falcon": falcon_to_hf,
    "gpt2": gpt2_to_hf,
}


# ---------------------------------------------------------------------------
# PEFT LoRA adapters (Llama family)
# ---------------------------------------------------------------------------

# PEFT module name → native projection target (ops/lora.py naming).
_PEFT_TO_NATIVE = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "w_gate",
    "up_proj": "w_up",
    "down_proj": "w_down",
}


def lora_from_peft(state_dict: Mapping, peft_config: Mapping,
                   cfg: ModelConfig, device=None):
    """HF PEFT LoRA state dict → the port's ``ops.lora.LoRAAdapter`` (fp32
    factors on ``device``, default ``cuda``).

    PEFT stores ``lora_A.weight [r, in]`` / ``lora_B.weight [out, r]``
    against the HF base weights; the native epilogue computes ``x @ A @
    B``, so both transpose.  The HF Q/K bases are in rotate-half layout and
    the delta follows its base: the inverse permutation touches the output
    dim only, so it lands on ``lora_B``.  ``α/r`` stays on the adapter and
    is folded at arena install."""
    from ..ops.lora import LoRAAdapter, lora_target_shapes, validate_adapter

    for key, why in (
            ("use_rslora", "rsLoRA scales by α/sqrt(r), not α/r"),
            ("use_dora", "DoRA adds a magnitude vector the arena "
                         "epilogue does not model")):
        if peft_config.get(key):
            raise ValueError(f"unsupported PEFT option {key}=True ({why})")
    for key in ("rank_pattern", "alpha_pattern"):
        if peft_config.get(key):
            raise ValueError(
                f"unsupported PEFT option {key!r}: per-module ranks/alphas "
                "don't fit the single-rank arena layout")

    rank = int(peft_config["r"])
    alpha = float(peft_config.get("lora_alpha", rank))
    d, nq, nkv = cfg.head_dim, cfg.num_attention_heads, cfg.kv_heads
    device = default_device(device)

    # normalize "base_model.model.model.layers.N...lora_A[.default].weight"
    sd = {}
    for k, v in state_dict.items():
        k = k.removeprefix("base_model.model.")
        k = k.replace(".lora_A.default.", ".lora_A.").replace(
            ".lora_B.default.", ".lora_B.")
        sd[k] = v

    present = sorted({proj for k in sd for proj in _PEFT_TO_NATIVE
                      if f".{proj}.lora_" in k})
    if not present:
        raise ValueError(
            "no recognized LoRA tensors in the PEFT state dict "
            f"(looked for {sorted(_PEFT_TO_NATIVE)} modules)")
    shapes = lora_target_shapes(cfg)
    unknown = [p for p in present if _PEFT_TO_NATIVE[p] not in shapes]
    if unknown:
        raise ValueError(
            f"PEFT adapter targets {unknown}, which this model config "
            "does not have (non-GLU model with gate_proj?)")

    factors = {}
    for proj in present:
        native = _PEFT_TO_NATIVE[proj]
        fin, fout = shapes[native]
        a_out = torch.empty((cfg.num_layers, fin, rank), dtype=torch.float32,
                            device=device)
        b_out = torch.empty((cfg.num_layers, rank, fout),
                            dtype=torch.float32, device=device)
        for i in range(cfg.num_layers):
            base = f"model.layers.{i}." + (
                "self_attn." if native in ("wq", "wk", "wv", "wo")
                else "mlp.") + proj
            try:
                a_hf = _t(sd[base + ".lora_A.weight"])
                b_hf = _t(sd[base + ".lora_B.weight"])
            except KeyError as e:
                raise ValueError(
                    f"PEFT adapter is missing {e.args[0]!r}: partial-layer "
                    "adapters (layers_to_transform) are not supported; "
                    "the arena stacks every layer") from None
            if (tuple(a_hf.shape) != (rank, fin)
                    or tuple(b_hf.shape) != (fout, rank)):
                raise ValueError(
                    f"layer {i} {proj}: lora_A {tuple(a_hf.shape)} / lora_B "
                    f"{tuple(b_hf.shape)} don't match rank={rank}, "
                    f"in={fin}, out={fout}")
            if native == "wq":
                b_hf = hf_to_interleaved(b_hf, nq, d)
            elif native == "wk":
                b_hf = hf_to_interleaved(b_hf, nkv, d)
            a_out[i].copy_(a_hf.T)
            b_out[i].copy_(b_hf.T)
        factors[native] = {"a": a_out, "b": b_out}

    adapter = LoRAAdapter(rank=rank, alpha=alpha, targets=tuple(factors),
                          factors=factors)
    validate_adapter(cfg, adapter)
    return adapter


def load_peft_adapter(path: str, cfg: ModelConfig, device=None):
    """A PEFT LoRA directory (``adapter_config.json`` and
    ``adapter_model.safetensors`` or ``adapter_model.bin``) as a port
    adapter, ready for ``AdapterRegistry.register``."""
    root = Path(path)
    peft_config = json.loads((root / "adapter_config.json").read_text())
    st = root / "adapter_model.safetensors"
    if st.exists():
        state_dict = safetensors_io.load_file(st)
    else:
        state_dict = torch.load(root / "adapter_model.bin",
                                map_location="cpu", weights_only=True)
    return lora_from_peft(state_dict, peft_config, cfg, device=device)


# ---------------------------------------------------------------------------
# Config derivation
# ---------------------------------------------------------------------------

_MISSING = object()


def config_from_hf(hf_config, family: Optional[str] = None,
                   **overrides) -> ModelConfig:
    """A native ``ModelConfig`` from a ``transformers`` config object or
    the plain dict of its ``config.json``; unsupported RoPE scalings and
    Falcon variants are refused, as in the JAX package."""
    if isinstance(hf_config, Mapping):
        def get(key, default=_MISSING):
            if default is _MISSING:
                if key not in hf_config:
                    raise KeyError(f"HF config has no {key!r}")
                return hf_config[key]
            return hf_config.get(key, default)
    else:
        def get(key, default=_MISSING):
            if default is _MISSING:
                return getattr(hf_config, key)
            return getattr(hf_config, key, default)

    mt = family or get("model_type", None)
    if mt in ("llama", "code_llama"):
        scaling = get("rope_scaling", None) or {}
        stype = scaling.get("rope_type") or scaling.get("type") or "linear"
        rope_fields = {}
        if stype in ("linear", "default") or not scaling:
            # "default" is transformers' spelling of no scaling
            rope_fields["rope_scaling_factor"] = float(
                scaling.get("factor", 1.0)) if stype == "linear" else 1.0
        elif stype == "llama3":
            rope_fields.update(
                rope_scaling_type="llama3",
                rope_scaling_factor=float(scaling["factor"]),
                rope_low_freq_factor=float(
                    scaling.get("low_freq_factor", 1.0)),
                rope_high_freq_factor=float(
                    scaling.get("high_freq_factor", 4.0)),
                rope_original_max_positions=int(
                    scaling["original_max_position_embeddings"]),
            )
        elif stype == "yarn":
            # mscale / mscale_all_dim change the attention temperature and
            # truncate=False the correction bounds: importing while
            # ignoring them would silently diverge from HF
            unsupported = [k for k in ("mscale", "mscale_all_dim",
                                       "truncate")
                           if scaling.get(k) not in (None, True)]
            if unsupported:
                raise ValueError(
                    f"unsupported yarn rope_scaling keys {unsupported} "
                    "(mscale/mscale_all_dim/truncate=False are not "
                    "implemented)")
            rope_fields.update(
                rope_scaling_type="yarn",
                rope_scaling_factor=float(scaling["factor"]),
                rope_beta_fast=float(scaling.get("beta_fast") or 32.0),
                rope_beta_slow=float(scaling.get("beta_slow") or 1.0),
                rope_attention_factor=scaling.get("attention_factor"),
                rope_original_max_positions=int(
                    scaling.get("original_max_position_embeddings")
                    or get("max_position_embeddings")),
            )
        else:
            raise ValueError(
                f"unsupported rope_scaling type {stype!r} "
                "(supported: linear, llama3, yarn)")
        fields = dict(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            num_kv_heads=get("num_key_value_heads", None),
            ffn_hidden_size=get("intermediate_size"),
            max_position_embeddings=get("max_position_embeddings"),
            norm_type="rmsnorm",
            norm_eps=get("rms_norm_eps"),
            activation="swiglu",
            rope_theta=get("rope_theta", 10000.0),
            tie_embed_logits=bool(get("tie_word_embeddings", False)),
            **rope_fields,
        )
    elif mt == "falcon":
        # only the rotary, bias-free Falcon variants (7b / 40b lineage):
        # the converters move no bias tensors and the model has no ALiBi
        if get("alibi", False):
            raise ValueError("ALiBi Falcon variants (falcon-rw-*) are not "
                             "supported; only rotary Falcon is")
        if get("bias", False):
            raise ValueError("Falcon variants with attention bias are not "
                             "supported by the weight converters")
        new_arch = get("new_decoder_architecture", False)
        fields = dict(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            num_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            num_kv_heads=(get("num_kv_heads") if new_arch
                          else (1 if get("multi_query", True)
                                else get("num_attention_heads"))),
            ffn_hidden_size=4 * get("hidden_size"),
            max_position_embeddings=2048,
            norm_type="layernorm",
            norm_eps=get("layer_norm_epsilon"),
            activation="gelu",
            parallel_attn=bool(get("parallel_attn", True)),
            parallel_layernorm=bool(new_arch),
            tie_embed_logits=True,
        )
    elif mt == "gpt2":
        fields = dict(
            vocab_size=get("vocab_size"),
            hidden_size=get("n_embd"),
            num_layers=get("n_layer"),
            num_attention_heads=get("n_head"),
            ffn_hidden_size=4 * get("n_embd"),
            max_position_embeddings=get("n_positions"),
            norm_type="layernorm",
            norm_eps=get("layer_norm_epsilon"),
            activation="gelu",
            position_embedding_type="absolute",
            use_bias=True,
            tie_embed_logits=True,
        )
    else:
        raise ValueError(f"unsupported HF model family: {mt!r}")
    fields.update(overrides)
    return ModelConfig(**fields).validate()
