"""Autoregressive generation: the sampling loop, scoring, beam search
(mirror of ``megatron_llm_tpu/generation/generation.py``).

- ``generate_tokens``: ragged right-padded prompts, each row starting at
  its own prompt length, EOS early exit, optional per-token log-probs;
- ``score_tokens``: the log-probs of given sequences;
- ``beam_search``: one prompt, HF-style hypotheses scored by sum-logprob
  / len**length_penalty.

JAX runs each loop as one ``lax.while_loop`` under ``jit``; here each is
a host loop over ``models/model.py:forward_cached`` with the position
``cur`` a Python int, so a single-token step of an eligible stack takes
the fused decode kernel (K12) with its fill on the host, and the prefill
(``empty_cache=True``) takes the flash-attention kernel (K1).  A step
reads the device once, for the stop test (none when nothing can stop).
Every entry point runs where the params live; prompts given as numpy or
host tensors move there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import ModelConfig
from ..models import model as model_lib
from .sampling import NEG_INF, sample_with_mode


def params_device(params) -> torch.device:
    """The device the params live on (every entry point runs there)."""
    return params["final_norm"]["scale"].device


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.long)


@dataclasses.dataclass(frozen=True)
class GenerateOutput:
    tokens: torch.Tensor  # [b, max_seq] int64: prompts + generations
    lengths: torch.Tensor  # [b] int64: total length incl. the prompt
    logprobs: Optional[torch.Tensor]  # [b, max_seq - 1] fp32 or None


def _sample_mode(top_k: int, top_p: float) -> str:
    assert not (top_k > 0 and top_p > 0.0), \
        "cannot have both greedy-limiting top-k and top-p"
    if top_k == 0 and top_p == 0.0:
        return "greedy"
    return "top_k" if top_k > 0 else "top_p"


@torch.no_grad()
def generate_tokens(cfg: ModelConfig, params, tokens, lengths, *,
                    eos_id: int = 2, top_k: int = 0, top_p: float = 0.0,
                    temperature: float = 1.0, seed: int = 0,
                    return_logprobs: bool = False,
                    use_eos_stop: bool = True) -> GenerateOutput:
    """Generate into ``tokens`` ``[b, max_seq]`` (right-padded prompts plus
    room) from prompt ``lengths`` ``[b]`` until EOS or the buffer fills.

    The common prefix ``[0, min(lengths))`` is prefilled at once; after
    that, a row still inside its prompt is teacher-forced with its prompt
    token.  The token at position ``cur`` is drawn from the stream
    ``(seed, cur)`` (JAX folds ``cur`` into its key)."""
    device = params_device(params)
    tokens = _long(tokens, device).clone()
    lengths = _long(lengths, device)
    b, max_seq = tokens.shape
    min_prompt_len = int(lengths.min())
    if min_prompt_len >= max_seq:
        raise ValueError("context length + tokens_to_generate too large "
                         "(reference: generation.py:118-121)")
    mode = _sample_mode(top_k, top_p)
    rope = model_lib.rope_tables(cfg, device=device)
    k_cache, v_cache = model_lib.init_kv_cache(cfg, b, max_seq, device=device)

    # prefill the common prompt prefix [0, min_prompt_len)
    logits, k_cache, v_cache = model_lib.forward_cached(
        cfg, params, tokens[:, :min_prompt_len], k_cache, v_cache, 0,
        rope=rope, empty_cache=True, last_logit_only=not return_logprobs)
    last_logits = logits[:, -1]

    logprob_buf = torch.zeros((b, max_seq - 1), dtype=torch.float32,
                              device=device)
    if return_logprobs:
        # the prompt tokens' own log-probs (positions 1 .. min_len - 1)
        lp = torch.log_softmax(logits, dim=-1)
        logprob_buf[:, :min_prompt_len - 1] = torch.gather(
            lp[:, :-1], 2, tokens[:, 1:min_prompt_len, None])[..., 0]

    done = torch.zeros((b,), dtype=torch.bool, device=device)
    out_lengths = torch.full((b,), min_prompt_len, dtype=torch.long,
                             device=device)
    cur = min_prompt_len
    while cur < max_seq:
        sampled = sample_with_mode(
            last_logits, (seed, cur), mode=mode, top_k=top_k, top_p=top_p,
            temperature=temperature, vocab_size=cfg.vocab_size)
        write = (lengths <= cur) & ~done  # prompt exhausted, not stopped
        tok_cur = torch.where(write, sampled, tokens[:, cur])
        tokens[:, cur] = tok_cur
        if return_logprobs:
            lp = torch.log_softmax(last_logits, dim=-1)
            logprob_buf[:, cur - 1] = torch.gather(lp, 1,
                                                   tok_cur[:, None])[:, 0]
        out_lengths = torch.where(done, out_lengths, cur + 1)
        if use_eos_stop:
            done = done | (write & (tok_cur == eos_id))
        cur += 1
        # JAX runs one more forward before its loop test; its logits are
        # never read
        if cur == max_seq or (use_eos_stop and bool(done.all())):
            break
        logits, k_cache, v_cache = model_lib.forward_cached(
            cfg, params, tok_cur[:, None], k_cache, v_cache, cur - 1,
            rope=rope)
        last_logits = logits[:, 0]
    return GenerateOutput(tokens=tokens, lengths=out_lengths,
                          logprobs=logprob_buf if return_logprobs else None)


@torch.no_grad()
def score_tokens(cfg: ModelConfig, params, tokens) -> torch.Tensor:
    """Per-token log-probs of given sequences ``[b, s]`` → ``[b, s - 1]``:
    one full forward (K1 and the norm kernels on the card)."""
    tokens = _long(tokens, params_device(params))
    logits = model_lib.forward(cfg, params, tokens)
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return torch.gather(lp, 2, tokens[:, 1:, None])[..., 0]


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BeamOutput:
    tokens: torch.Tensor  # [num_return, max_seq]
    scores: torch.Tensor  # [num_return]: sum-logprob / len**length_penalty
    lengths: torch.Tensor  # [num_return]


def top_k_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` over a vector: the k largest values and their
    indices, the lower index first among equal values (``torch.topk``
    promises no order on ties, and beam search meets them: its finished
    pool starts as k copies of ``NEG_INF``)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _len_norm(n: int, length_penalty: float) -> float:
    """``max(n, 1) ** length_penalty`` rounded to fp32, as JAX computes it
    (a host number: dividing by it leaves the device alone)."""
    return float(torch.pow(torch.tensor(float(max(n, 1)),
                                        dtype=torch.float32),
                           length_penalty))


@torch.no_grad()
def beam_search(cfg: ModelConfig, params, tokens, prompt_len: int, *,
                beam_size: int, stop_token: int = 2, num_return_gen: int = 1,
                length_penalty: float = 1.0) -> BeamOutput:
    """Beam-search one prompt: ``tokens`` ``[max_seq]`` or ``[1, max_seq]``
    holds it and the generation room."""
    device = params_device(params)
    tokens = _long(tokens, device)
    if tokens.ndim == 2:
        assert tokens.shape[0] == 1, "beam search is single-prompt (ref :293)"
        tokens = tokens[0]
    prompt_len = int(prompt_len)
    max_seq = tokens.shape[0]
    if prompt_len >= max_seq:
        raise ValueError("context length + tokens_to_generate too large")
    k = int(beam_size)
    rope = model_lib.rope_tables(cfg, device=device)
    tokens = tokens[None, :].expand(k, max_seq).clone()
    k_cache, v_cache = model_lib.init_kv_cache(cfg, k, max_seq, device=device)
    logits, k_cache, v_cache = model_lib.forward_cached(
        cfg, params, tokens[:, :prompt_len], k_cache, v_cache, 0, rope=rope,
        empty_cache=True, last_logit_only=True)
    last_logits = logits[:, -1]

    alive_scores = torch.zeros((k,), dtype=torch.float32, device=device)
    fin_tokens = torch.zeros((k, max_seq), dtype=torch.long, device=device)
    fin_scores = torch.full((k,), NEG_INF, dtype=torch.float32,
                            device=device)
    fin_lengths = torch.zeros((k,), dtype=torch.long, device=device)
    pad_mask = (torch.arange(last_logits.shape[-1], device=device)
                >= cfg.vocab_size)[None, :]
    first_rank = torch.arange(2 * k, device=device) < k

    cur = prompt_len
    while True:
        lp = torch.log_softmax(last_logits.masked_fill(pad_mask, NEG_INF),
                               dim=-1)
        cand = lp + alive_scores[:, None]  # [k, vocab]
        if cur == prompt_len:
            # every beam is a copy of the prompt: only beam 0 expands
            cand[1:] = NEG_INF
        top_scores, top_idx = top_k_stable(cand.reshape(-1), 2 * k)
        beam_ids = top_idx // cand.shape[1]
        words = top_idx % cand.shape[1]
        is_stop = words == stop_token

        # finished: stop-token hits ranked within the top k, recorded
        # without the stop token, at length cur
        hyp_scores = top_scores / _len_norm(cur + 1 - prompt_len,
                                            length_penalty)
        cand_fin_scores = torch.where(is_stop & first_rank, hyp_scores,
                                      torch.full_like(hyp_scores, NEG_INF))
        merged_scores = torch.cat([fin_scores, cand_fin_scores])
        merged_tokens = torch.cat([fin_tokens, tokens[beam_ids]])
        merged_lengths = torch.cat([fin_lengths, torch.full(
            (2 * k,), cur, dtype=torch.long, device=device)])
        keep = top_k_stable(merged_scores, k)[1]
        fin_scores = merged_scores[keep]
        fin_tokens = merged_tokens[keep]
        fin_lengths = merged_lengths[keep]

        # alive: the best k candidates that are not stop hits
        alive_rank = torch.where(is_stop, torch.full_like(top_scores,
                                                          NEG_INF),
                                 top_scores)
        alive_pick = top_k_stable(alive_rank, k)[1]
        alive_scores = alive_rank[alive_pick]
        alive_beam_ids = beam_ids[alive_pick]
        alive_words = words[alive_pick]
        tokens = tokens[alive_beam_ids]
        tokens[:, cur] = alive_words
        cur += 1
        # BeamHypotheses.is_done: k finished, and the best alive score can
        # no longer beat the worst of them (JAX tests this after the
        # step's forward, whose logits it then never reads)
        best_possible = alive_scores.max() / _len_norm(
            cur + 1 - prompt_len, length_penalty)
        have_k = (fin_scores > NEG_INF / 2).sum() >= k
        if cur >= max_seq or bool(have_k & (fin_scores.min()
                                            >= best_possible)):
            break
        # the KV cache follows the surviving beams
        k_cache = model_lib.cache_take_rows(k_cache, alive_beam_ids)
        v_cache = model_lib.cache_take_rows(v_cache, alive_beam_ids)
        logits, k_cache, v_cache = model_lib.forward_cached(
            cfg, params, alive_words[:, None], k_cache, v_cache, cur - 1,
            rope=rope)
        last_logits = logits[:, 0]

    # open beams join the pool when the buffer filled without k stop hits
    open_scores = alive_scores / _len_norm(cur - prompt_len,
                                           length_penalty)
    merged_scores = torch.cat([fin_scores, open_scores])
    merged_tokens = torch.cat([fin_tokens, tokens])
    merged_lengths = torch.cat([fin_lengths, torch.full(
        (k,), cur, dtype=torch.long, device=device)])
    keep = top_k_stable(merged_scores, k)[1]
    n = min(num_return_gen, beam_size)
    return BeamOutput(tokens=merged_tokens[keep][:n],
                      scores=merged_scores[keep][:n],
                      lengths=merged_lengths[keep][:n])
