"""Configuration for the PyTorch/CUDA port.

A copy of ``megatron_llm_tpu/config.py``: ``ModelConfig`` and its presets
with torch dtypes, and the ``ParallelConfig``, ``OptimizerConfig``,
``TrainConfig`` and ``RuntimeConfig`` of the training path.  Every field,
default and preset is the same, so a config built here describes the same
run as its JAX twin.  ``RuntimeConfig.validate`` refuses, with
``NotImplementedError`` naming the ROADMAP item, what the single-device
training path does not run: parallel degrees above 1 and the fused LM
head.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

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
    ``fused_decode=True`` takes the whole-stack decode kernels
    (``kernels/decode_step.py``) where their predicates accept the stack,
    and the flash tile sizes are ignored (the CUDA kernel picks its own).
    ``kv_cache_quant="int8"`` serves from the int8 KV cache;
    ``quantize_matmuls="int8"`` (W8A8 training) is refused by
    ``RuntimeConfig.validate`` and the serving engine."""

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
    # "pallas" selects the port's Triton RMSNorm / LayerNorm kernels (the
    # name is the JAX package's); "xla" the plain torch math
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
# Parallel, optimizer and training configuration (the JAX package's, field
# for field)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    """Parallel degrees; see the JAX ``ParallelConfig`` for each knob.  The
    port trains on one device: every degree above 1 is refused by
    ``RuntimeConfig.validate``."""

    data_parallel: int = 1
    pipeline_parallel: int = 1
    tensor_parallel: int = 1
    fsdp: int = 1
    sequence_parallel: bool = False
    virtual_pipeline_stages: int = 1
    expert_parallel: int = 1
    context_parallel: int = 1
    context_parallel_layout: str = "contiguous"
    num_microbatches: int = 1
    pipeline_remat_window: int = 0
    use_distributed_optimizer: bool = False
    pipeline_split_rank: Optional[int] = None

    @property
    def world_size(self) -> int:
        return (self.data_parallel * self.fsdp * self.pipeline_parallel
                * self.tensor_parallel * self.context_parallel
                * self.expert_parallel)

    def validate(self) -> "ParallelConfig":
        if self.fsdp < 1:
            raise ValueError(f"fsdp must be >= 1, got {self.fsdp}")
        if self.context_parallel_layout not in ("contiguous", "zigzag"):
            raise ValueError(f"unknown context_parallel_layout "
                             f"{self.context_parallel_layout!r}")
        dp_tp = {"data_parallel": self.data_parallel,
                 "tensor_parallel": self.tensor_parallel,
                 "fsdp": self.fsdp}
        pp_cp_ep = {"pipeline_parallel": self.pipeline_parallel,
                    "virtual_pipeline_stages": self.virtual_pipeline_stages,
                    "context_parallel": self.context_parallel,
                    "expert_parallel": self.expert_parallel}
        for degrees, item in (
                (dp_tp, "data, tensor and sequence parallel training"),
                (pp_cp_ep, "pipeline, context and expert parallelism")):
            above = {k: v for k, v in degrees.items() if v > 1}
            if above:
                raise NotImplementedError(
                    f"parallel training ({above}) is not ported yet: the port "
                    f"trains on one device (ROADMAP.md, Queue 1: {item})")
        if self.sequence_parallel or self.use_distributed_optimizer:
            raise NotImplementedError(
                "sequence parallelism and ZeRO-1 are not ported yet "
                "(ROADMAP.md, Queue 1: data, tensor and sequence parallel "
                "training)")
        return self


@dataclass(frozen=True)
class OptimizerConfig:
    optimizer: str = "adamw"  # "adamw" | "sgd"
    lr: float = 3e-4
    min_lr: float = 3e-5
    weight_decay: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_eps: float = 1e-8
    sgd_momentum: float = 0.9
    clip_grad: float = 1.0
    # constant | linear | cosine | inverse-square-root
    lr_decay_style: str = "cosine"
    lr_warmup_iters: int = 0
    lr_warmup_fraction: Optional[float] = None
    lr_decay_iters: Optional[int] = None
    start_weight_decay: Optional[float] = None
    end_weight_decay: Optional[float] = None
    weight_decay_incr_style: str = "constant"
    # loss scaling for fp16 (bf16 needs none)
    loss_scale: Optional[float] = None
    initial_loss_scale: float = 2.0**32
    min_loss_scale: float = 1.0
    loss_scale_window: int = 1000
    hysteresis: int = 2
    main_params_dtype: str = "float32"
    use_fp32_grad_accum: bool = True


@dataclass(frozen=True)
class TrainConfig:
    train_iters: int = 1000
    micro_batch_size: int = 1
    global_batch_size: int = 1
    rampup_batch_size: Optional[Sequence[int]] = None
    seq_length: int = 4096
    seed: int = 1234
    eval_interval: int = 1000
    eval_iters: int = 10
    save: Optional[str] = None
    load: Optional[str] = None
    save_interval: int = 1000
    keep_latest_checkpoints: int = 0
    checkpoint_retries: int = 3
    anomaly_z_threshold: float = 0.0
    anomaly_ewma_alpha: float = 0.02
    anomaly_warmup_steps: int = 20
    anomaly_rollback_after: int = 0
    anomaly_max_rollbacks: int = 10
    log_interval: int = 10
    tensorboard_dir: Optional[str] = None
    wandb_project: Optional[str] = None
    wandb_name: Optional[str] = None
    exit_interval: Optional[int] = None
    exit_duration_mins: Optional[float] = None
    data_path: Optional[Sequence[Any]] = None
    split: str = "969,30,1"
    metrics: Sequence[str] = ()
    skip_iters: Sequence[int] = ()
    profile_dir: Optional[str] = None
    profile_step_start: int = 11
    profile_step_end: int = 13


@dataclass(frozen=True)
class RuntimeConfig:
    """Top-level bundle threaded through the training path."""

    model: ModelConfig = field(default_factory=ModelConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def validate(self) -> "RuntimeConfig":
        m = self.model
        if m.fused_lm_head:
            raise NotImplementedError(
                "fused_lm_head (fused_linear_cross_entropy) is not ported "
                "yet (ROADMAP.md, Queue 1: decoder forward and backward)")
        if m.quantize_matmuls != "none":
            raise NotImplementedError(
                "quantize_matmuls='int8' (W8A8 training matmuls) is not "
                "ported yet (ROADMAP.md, Queue 1 item 12: the rest, int8 "
                "training matmul)")
        m.validate()
        self.parallel.validate()
        mb = self.train.micro_batch_size
        gb = self.train.global_batch_size
        dp = self.parallel.data_parallel
        if gb % (mb * dp):
            raise ValueError(f"global_batch_size {gb} must divide by "
                             f"micro_batch {mb} * dp {dp}")
        if (m.position_embedding_type == PositionEmbeddingType.ABSOLUTE
                and self.train.seq_length > m.max_position_embeddings):
            # an index past the learned table: torch raises (on the card, a
            # device-side assert) where XLA's gather would clamp
            raise ValueError(
                f"seq_length {self.train.seq_length} exceeds the learned "
                f"position table ({m.max_position_embeddings} rows)")
        return self

    @property
    def grad_accum_steps(self) -> int:
        return self.train.global_batch_size // (
            self.train.micro_batch_size * self.parallel.data_parallel)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: dict) -> "RuntimeConfig":
        """The inverse of ``to_dict``; JSON lists become tuples.  A
        ``config.json`` written by either package loads into the same
        fields."""
        def tuples(section):
            return {k: tuple(v) if isinstance(v, list) else v
                    for k, v in d.get(section, {}).items()}

        return cls(model=ModelConfig(**d.get("model", {})),
                   parallel=ParallelConfig(**tuples("parallel")),
                   optimizer=OptimizerConfig(**d.get("optimizer", {})),
                   train=TrainConfig(**tuples("train")))

    @classmethod
    def from_json(cls, s: str) -> "RuntimeConfig":
        return cls.from_dict(json.loads(s))


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
