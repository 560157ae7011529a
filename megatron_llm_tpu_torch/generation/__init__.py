"""Inference and text generation (mirror of ``megatron_llm_tpu/generation``):
KV-cached decoding over ``models/model.py:forward_cached`` (the fused
decode kernel for single-token steps), top-k / top-p / temperature
sampling, scoring, beam search, prompt-lookup speculation, and the REST
front-end over the continuous-batching engine.
"""

from .api import (
    GenerationResult,
    beam_search_and_post_process,
    detokenize_generations,
    generate_and_post_process,
    score_and_post_process,
    tokenize_prompts,
)
from .generation import (
    BeamOutput,
    GenerateOutput,
    beam_search,
    generate_tokens,
    score_tokens,
)
from .sampling import (
    modify_logits_for_top_k_filtering,
    modify_logits_for_top_p_filtering,
    sample,
)
from .server import GenerationService, MegatronServer

__all__ = [
    "BeamOutput",
    "GenerateOutput",
    "GenerationResult",
    "GenerationService",
    "MegatronServer",
    "beam_search",
    "beam_search_and_post_process",
    "detokenize_generations",
    "generate_and_post_process",
    "generate_tokens",
    "modify_logits_for_top_k_filtering",
    "modify_logits_for_top_p_filtering",
    "sample",
    "score_and_post_process",
    "score_tokens",
    "tokenize_prompts",
]
