"""Model-family helpers (the part of ``megatron_llm_tpu/models/families.py``
that serving needs): ``draft_model`` resolves a resident draft model's
config for tree speculation against a target."""

from __future__ import annotations

import dataclasses

from ..config import ModelConfig, get_preset


def draft_model(name: str, target: ModelConfig, **overrides) -> ModelConfig:
    """A resident draft model's config from a preset name
    (``config.PRESETS``, e.g. ``"tiny"``) for ``target``: the vocabulary
    is forced to the target's (every drafted token must be verifiable by
    the target's argmax) and the position range widened to the target's
    (draft positions cover every slot the engine decodes); depth, width
    and heads stay the preset's.  The JAX function wraps the same config
    in a ``CausalLM``; the port returns the config."""
    cfg = get_preset(name)
    cfg = dataclasses.replace(
        cfg,
        vocab_size=target.vocab_size,
        make_vocab_size_divisible_by=target.make_vocab_size_divisible_by,
        seq_length=max(cfg.seq_length, target.seq_length),
        max_position_embeddings=max(cfg.max_position_embeddings,
                                    target.max_position_embeddings),
        **overrides)
    return cfg.validate()
