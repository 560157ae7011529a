"""Model configuration for the PyTorch/CUDA port.

A copy of ``megatron_llm_tpu/config.py``'s ``ModelConfig`` and presets
with torch dtypes: every field, default and preset is the same, so a
config built here describes the same network as its JAX twin.  The
parallel, optimizer and runtime configs belong to the training slices
of the port and are not here yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


class PositionEmbeddingType:
    ROTARY = "rotary"
    ABSOLUTE = "absolute"
    NONE = "none"


class AttnMaskType:
    CAUSAL = "causal"
    PADDING = "padding"
    PREFIX = "prefix"


_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (GPT / Llama-1/2/3 / Code Llama / Falcon).

    Field for field the JAX ``ModelConfig``; see its comments for what
    each knob means.  Fields that select TPU-only machinery keep their
    names and defaults so configs round-trip between the packages:
    ``fused_decode=True`` is refused by the port's serving engine, and
    the flash tile sizes are ignored (the CUDA kernel picks its own)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_attention_heads: int = 32
    num_kv_heads: Optional[int] = None
    ffn_hidden_size: Optional[int] = None
    max_position_embeddings: int = 4096
    norm_type: str = "rmsnorm"
    norm_eps: float = 1e-5
    activation: str = "swiglu"
    position_embedding_type: str = PositionEmbeddingType.ROTARY
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 1.0
    rope_scaling_type: str = "linear"
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_positions: Optional[int] = None
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_attention_factor: Optional[float] = None
    kv_cache_quant: str = "none"
    use_bias: bool = False
    qkv_bias: bool = False
    tie_embed_logits: bool = False
    parallel_attn: bool = False
    parallel_layernorm: bool = False
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    params_dtype: str = "bfloat16"
    apply_query_key_layer_scaling: bool = False
    attention_softmax_in_fp32: bool = True
    make_vocab_size_divisible_by: int = 128
    init_method_std: float = 0.02
    use_scaled_init: bool = True
    # "flash" selects the port's CUDA flash-attention kernel for CUDA
    # tensors (kernels/flash_attention.py); "dot" the plain torch path
    attention_impl: str = "dot"
    flash_block_q: int = 1024
    flash_block_k: int = 1024
    lima_dropout: bool = False
    drop_path_rate: float = 0.0
    # "pallas" selects the port's Triton RMSNorm kernel (the name is the
    # JAX package's); "xla" the plain torch math
    norm_impl: str = "xla"
    fused_decode: bool = True
    quantize_matmuls: str = "none"
    recompute: str = "selective"
    context_parallel_axis: Optional[str] = None
    context_parallel_zigzag: bool = False
    sequence_parallel_axis: Optional[str] = None
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coeff: float = 0.01
    moe_group_size: int = 512
    seq_length: int = 4096
    tokentype_size: int = 0
    num_decoder_layers: Optional[int] = None
    fused_lm_head: bool = False

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_attention_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def ffn_size(self) -> int:
        if self.ffn_hidden_size is not None:
            return self.ffn_hidden_size
        if self.is_glu:
            size = int(2 * 4 * self.hidden_size / 3)
            return 256 * ((size + 255) // 256)
        return 4 * self.hidden_size

    @property
    def is_glu(self) -> bool:
        return self.activation in ("swiglu", "geglu", "reglu", "liglu")

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.params_dtype)

    def padded_vocab_size(self, tp: int = 1) -> int:
        multiple = self.make_vocab_size_divisible_by * tp
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def validate(self) -> "ModelConfig":
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")
        if self.num_attention_heads % self.kv_heads:
            raise ValueError("num_attention_heads must divide by kv heads")
        if self.parallel_layernorm and not self.parallel_attn:
            raise ValueError("parallel_layernorm requires parallel_attn")
        if self.num_experts > 0:
            if not 1 <= self.moe_top_k <= self.num_experts:
                raise ValueError(
                    f"moe_top_k {self.moe_top_k} must be in "
                    f"[1, num_experts={self.num_experts}]")
            if self.use_bias:
                raise ValueError("MoE MLPs are bias-free")
        if self.kv_cache_quant not in ("none", "int8"):
            raise ValueError(f"unknown kv_cache_quant {self.kv_cache_quant!r}")
        if self.quantize_matmuls not in ("none", "int8"):
            raise ValueError(
                f"unknown quantize_matmuls {self.quantize_matmuls!r}")
        return self


# ---------------------------------------------------------------------------
# Presets (the JAX package's, value for value)
# ---------------------------------------------------------------------------


def llama2_config(size: str = "7b", **overrides) -> ModelConfig:
    base = dict(
        norm_type="rmsnorm",
        norm_eps=1e-5,
        activation="swiglu",
        position_embedding_type=PositionEmbeddingType.ROTARY,
        use_bias=False,
        tie_embed_logits=False,
        vocab_size=32000,
        max_position_embeddings=4096,
        seq_length=4096,
    )
    sizes = {
        "7b": dict(hidden_size=4096, num_layers=32, num_attention_heads=32,
                   ffn_hidden_size=11008),
        "13b": dict(hidden_size=5120, num_layers=40, num_attention_heads=40,
                    ffn_hidden_size=13824),
        "70b": dict(hidden_size=8192, num_layers=80, num_attention_heads=64,
                    num_kv_heads=8, ffn_hidden_size=28672),
    }
    base.update(sizes[size])
    base.update(overrides)
    return ModelConfig(**base).validate()


def llama1_config(size: str = "7b", **overrides) -> ModelConfig:
    cfg = dict(max_position_embeddings=2048, seq_length=2048, norm_eps=1e-6)
    llama1_sizes = {
        "30b": dict(hidden_size=6656, num_layers=60, num_attention_heads=52,
                    ffn_hidden_size=17920),
        "65b": dict(hidden_size=8192, num_layers=80, num_attention_heads=64,
                    ffn_hidden_size=22016),
    }
    if size in llama1_sizes:
        cfg.update(llama1_sizes[size])
        cfg.update(overrides)
        return llama2_config("7b", **cfg)
    if size not in ("7b", "13b"):
        raise KeyError(f"unknown llama-1 size {size!r}")
    cfg.update(overrides)
    return llama2_config(size, **cfg)


def codellama_config(size: str = "34b", **overrides) -> ModelConfig:
    base = dict(
        vocab_size=32016,
        rope_theta=1000000.0,
        max_position_embeddings=16384,
        seq_length=16384,
    )
    sizes = {
        "7b": dict(hidden_size=4096, num_layers=32, num_attention_heads=32,
                   ffn_hidden_size=11008),
        "13b": dict(hidden_size=5120, num_layers=40, num_attention_heads=40,
                    ffn_hidden_size=13824),
        "34b": dict(hidden_size=8192, num_layers=48, num_attention_heads=64,
                    num_kv_heads=8, ffn_hidden_size=22016),
    }
    base.update(sizes[size])
    base.update(overrides)
    return llama2_config("7b", **base)


def llama3_config(size: str = "8b", **overrides) -> ModelConfig:
    base = dict(
        vocab_size=128256,
        rope_theta=500000.0,
        max_position_embeddings=8192,
        seq_length=8192,
        make_vocab_size_divisible_by=128,
    )
    sizes = {
        "8b": dict(hidden_size=4096, num_layers=32, num_attention_heads=32,
                   num_kv_heads=8, ffn_hidden_size=14336),
        "70b": dict(hidden_size=8192, num_layers=80,
                    num_attention_heads=64, num_kv_heads=8,
                    ffn_hidden_size=28672),
    }
    if size not in sizes:
        raise KeyError(f"unknown llama-3 size {size!r} "
                       f"(have {sorted(sizes)}; pass --model_size 8b)")
    base.update(sizes[size])
    base.update(overrides)
    return llama2_config("7b", **base)


def llama31_config(size: str = "8b", **overrides) -> ModelConfig:
    base = dict(
        max_position_embeddings=131072,
        seq_length=8192,
        rope_scaling_type="llama3",
        rope_scaling_factor=8.0,
        rope_low_freq_factor=1.0,
        rope_high_freq_factor=4.0,
        rope_original_max_positions=8192,
    )
    base.update(overrides)
    return llama3_config(size, **base)


def falcon_config(size: str = "7b", **overrides) -> ModelConfig:
    base = dict(
        norm_type="layernorm",
        norm_eps=1e-5,
        activation="gelu_exact",
        position_embedding_type=PositionEmbeddingType.ROTARY,
        use_bias=False,
        tie_embed_logits=True,
        parallel_attn=True,
        vocab_size=65024,
        max_position_embeddings=2048,
        seq_length=2048,
    )
    sizes = {
        "7b": dict(hidden_size=4544, num_layers=32, num_attention_heads=71,
                   num_kv_heads=1, ffn_hidden_size=4 * 4544),
        "40b": dict(hidden_size=8192, num_layers=60, num_attention_heads=128,
                    num_kv_heads=8, ffn_hidden_size=4 * 8192,
                    parallel_layernorm=True),
    }
    base.update(sizes[size])
    base.update(overrides)
    return ModelConfig(**base).validate()


def gpt_config(size: str = "345m", **overrides) -> ModelConfig:
    base = dict(
        norm_type="layernorm",
        norm_eps=1e-5,
        activation="gelu",
        position_embedding_type=PositionEmbeddingType.ABSOLUTE,
        use_bias=True,
        tie_embed_logits=True,
        vocab_size=50257,
        max_position_embeddings=1024,
        seq_length=1024,
    )
    sizes = {
        "125m": dict(hidden_size=768, num_layers=12, num_attention_heads=12),
        "345m": dict(hidden_size=1024, num_layers=24, num_attention_heads=16),
        "1.3b": dict(hidden_size=2048, num_layers=24, num_attention_heads=32),
    }
    base.update(sizes[size])
    base.update(overrides)
    return ModelConfig(**base).validate()


def tiny_config(**overrides) -> ModelConfig:
    """Small llama-style config for tests."""
    base = dict(
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_attention_heads=4,
        num_kv_heads=2,
        ffn_hidden_size=128,
        max_position_embeddings=128,
        seq_length=32,
        params_dtype="float32",
        attention_impl="dot",
        recompute="none",
        make_vocab_size_divisible_by=8,
    )
    base.update(overrides)
    return ModelConfig(**base).validate()


PRESETS = {
    "llama2-7b": lambda: llama2_config("7b"),
    "llama2-13b": lambda: llama2_config("13b"),
    "llama2-70b": lambda: llama2_config("70b"),
    "llama1-7b": lambda: llama1_config("7b"),
    "llama3-8b": lambda: llama3_config("8b"),
    "llama3-70b": lambda: llama3_config("70b"),
    "llama3.1-8b": lambda: llama31_config("8b"),
    "llama3.1-70b": lambda: llama31_config("70b"),
    "codellama-7b": lambda: codellama_config("7b"),
    "codellama-34b": lambda: codellama_config("34b"),
    "falcon-7b": lambda: falcon_config("7b"),
    "falcon-40b": lambda: falcon_config("40b"),
    "gpt-345m": lambda: gpt_config("345m"),
    "tiny": tiny_config,
}


def get_preset(name: str) -> ModelConfig:
    return PRESETS[name]()
