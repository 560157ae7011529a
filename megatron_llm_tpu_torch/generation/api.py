"""Text in, text out (mirror of ``megatron_llm_tpu/generation/api.py``):
tokenize and right-pad prompts, run generation, beam search or scoring
where the params live, and detokenize.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional, Sequence

import numpy as np

from ..config import ModelConfig
from ..tokenizer.tokenizer import Tokenizer
from .generation import beam_search, generate_tokens, score_tokens
from .speculative import DEFAULT_NGRAM, generate_tokens_pld


def tokenize_prompts(tokenizer: Tokenizer, prompts: Sequence[str],
                     tokens_to_generate: int, add_bos: bool = False,
                     max_position_embeddings: Optional[int] = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize and right-pad prompts with room to generate: ``(tokens [b,
    max_prompt_len + tokens_to_generate], lengths [b])`` int32."""
    ids = []
    for p in prompts:
        t = tokenizer.tokenize(p)
        if add_bos and tokenizer.bos is not None:
            t = [tokenizer.bos] + t
        ids.append(t)
    lengths = np.array([len(t) for t in ids], np.int32)
    if tokens_to_generate > 0 and np.any(lengths == 0):
        # e.g. an empty prompt and a tokenizer with no BOS token: there is
        # no position to condition generation on
        raise ValueError("a prompt tokenized to zero tokens (empty prompt "
                         "with a BOS-less tokenizer?)")
    max_len = int(lengths.max()) + tokens_to_generate
    if max_position_embeddings is not None \
            and max_len > max_position_embeddings:
        raise ValueError(
            f"prompt + tokens_to_generate = {max_len} exceeds "
            f"max_position_embeddings = {max_position_embeddings}")
    tokens = np.full((len(ids), max_len), tokenizer.pad, np.int32)
    for i, t in enumerate(ids):
        tokens[i, :len(t)] = t
    return tokens, lengths


def detokenize_generations(tokenizer: Tokenizer, tokens, lengths,
                           return_segments: bool = False):
    """Trim each row to its length and detokenize; with
    ``return_segments`` also each token's piece."""
    texts, segments, all_ids = [], [], []
    for row, n in zip(np.asarray(tokens), np.asarray(lengths)):
        ids = [int(t) for t in row[:int(n)]]
        all_ids.append(ids)
        texts.append(tokenizer.detokenize(ids))
        if return_segments:
            segments.append([tokenizer.detokenize([t]) for t in ids])
    if return_segments:
        return texts, segments, all_ids
    return texts, all_ids


@dataclasses.dataclass(frozen=True)
class GenerationResult:
    texts: list[str]
    tokens: list[list[int]]
    segments: Optional[list[list[str]]] = None
    logprobs: Optional[list[list[float]]] = None
    scores: Optional[list[float]] = None  # beam search only
    # "pld" when speculative decoding served the request; "fallback:<why>"
    # when it was requested but ineligible; None when not requested
    speculative: Optional[str] = None


def pld_eligible(speculative, top_k, top_p, return_logprobs,
                 lengths) -> tuple[bool, str]:
    """(ok, reason-if-not) for the prompt-lookup path: greedy only, no
    log-probs, every prompt at least the lookup n-gram long (ragged
    lengths are fine)."""
    if speculative != "pld":
        return False, "not requested"
    if top_k != 0 or top_p != 0.0:
        return False, "sampling requested (PLD is greedy-exact only)"
    if return_logprobs:
        return False, "log-probs requested"
    if min(int(n) for n in lengths) < DEFAULT_NGRAM:
        return False, (f"a prompt is shorter than the lookup n-gram "
                       f"({DEFAULT_NGRAM})")
    return True, ""


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _detokenize(tokenizer, toks, lens, return_segments):
    if return_segments:
        return detokenize_generations(tokenizer, toks, lens, True)
    texts, ids = detokenize_generations(tokenizer, toks, lens)
    return texts, None, ids


def generate_and_post_process(
        cfg: ModelConfig, params, tokenizer: Tokenizer,
        prompts: Sequence[str], *, tokens_to_generate: int = 64,
        return_output_log_probs: bool = False, return_segments: bool = False,
        top_k_sampling: int = 0, top_p_sampling: float = 0.0,
        temperature: float = 1.0, add_BOS: bool = False,
        use_eod_token_for_early_termination: bool = True,
        random_seed: int = -1,
        speculative: Optional[str] = None) -> GenerationResult:
    """Generate from text prompts and detokenize.

    ``speculative="pld"`` sends eligible requests (greedy, no log-probs)
    through prompt-lookup speculation; the others take the standard loop
    with the same output contract, and the fallback is logged and tagged
    ``"fallback:<why>"``."""
    tokens, lengths = tokenize_prompts(
        tokenizer, prompts, tokens_to_generate, add_BOS,
        cfg.max_position_embeddings)
    if random_seed < 0:
        # unseeded requests must vary between calls
        random_seed = int.from_bytes(os.urandom(4), "little")
    pld_ok, pld_reason = pld_eligible(
        speculative, top_k_sampling, top_p_sampling,
        return_output_log_probs, lengths)
    if speculative == "pld" and not pld_ok:
        logging.getLogger(__name__).warning(
            "speculative='pld' requested but the request is ineligible "
            "(%s); using the standard decode loop", pld_reason)
    if pld_ok:
        out = generate_tokens_pld(
            cfg, params, tokens, lengths, eos_id=tokenizer.eod,
            use_eos_stop=use_eod_token_for_early_termination)
    else:
        out = generate_tokens(
            cfg, params, tokens, lengths, eos_id=tokenizer.eod,
            top_k=top_k_sampling, top_p=top_p_sampling,
            temperature=temperature, seed=random_seed,
            return_logprobs=return_output_log_probs,
            use_eos_stop=use_eod_token_for_early_termination)
    toks, lens = _host(out.tokens), _host(out.lengths)
    texts, segments, ids = _detokenize(tokenizer, toks, lens,
                                       return_segments)
    logprobs = None
    if return_output_log_probs:
        lp = _host(out.logprobs)
        logprobs = [lp[i, :max(int(n) - 1, 0)].tolist()
                    for i, n in enumerate(lens)]
    spec_tag = None
    if speculative == "pld":
        spec_tag = "pld" if pld_ok else f"fallback:{pld_reason}"
    return GenerationResult(texts=texts, tokens=ids, segments=segments,
                            logprobs=logprobs, speculative=spec_tag)


def beam_search_and_post_process(
        cfg: ModelConfig, params, tokenizer: Tokenizer, prompt: str, *,
        tokens_to_generate: int = 64, beam_size: int = 4,
        stop_token: Optional[int] = None, num_return_gen: int = 1,
        length_penalty: float = 1.0, add_BOS: bool = False,
        return_segments: bool = False) -> GenerationResult:
    """Beam-search a single prompt and detokenize the hypotheses."""
    tokens, lengths = tokenize_prompts(
        tokenizer, [prompt], tokens_to_generate, add_BOS,
        cfg.max_position_embeddings)
    out = beam_search(
        cfg, params, tokens[0], int(lengths[0]), beam_size=beam_size,
        stop_token=stop_token if stop_token is not None else tokenizer.eod,
        num_return_gen=num_return_gen, length_penalty=length_penalty)
    texts, segments, ids = _detokenize(tokenizer, _host(out.tokens),
                                       _host(out.lengths), return_segments)
    return GenerationResult(texts=texts, tokens=ids, segments=segments,
                            scores=_host(out.scores).tolist())


def score_and_post_process(cfg: ModelConfig, params, tokenizer: Tokenizer,
                           prompts: Sequence[str]) -> GenerationResult:
    """Log-probs of whole prompts, no generation (the
    ``tokens_to_generate=0`` path)."""
    tokens, lengths = tokenize_prompts(tokenizer, prompts, 0)
    lp = _host(score_tokens(cfg, params, tokens))
    texts, ids = detokenize_generations(tokenizer, tokens, lengths)
    logprobs = [lp[i, :max(int(n) - 1, 0)].tolist()
                for i, n in enumerate(lengths)]
    return GenerationResult(texts=texts, tokens=ids, logprobs=logprobs)
