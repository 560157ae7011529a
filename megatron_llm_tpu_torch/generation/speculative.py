"""Prompt-lookup speculative decoding (greedy): multi-token decode steps
(mirror of ``megatron_llm_tpu/generation/speculative.py``).

PLD drafts the next ``draft_len`` tokens of each row by matching its
trailing n-gram against its own history, then verifies them in one
cached forward of a ``[b, draft_len + 1]`` window.  Every committed token
is the argmax of the model's logits over its committed prefix, so the
output is a greedy trajectory of the model (equal to ``generate_tokens``'
greedy tokens on the CPU in fp32).

Per row: the KV cache takes a ``[b]`` vector of fills (the window's rows
land at each row's own fill, ``ops/kv_quant.cache_update``, and the
composed route's decode mask is per row, ``ops/attention.
_decode_keep_mask``), so prompts may be ragged and each row advances by
its own acceptance.  Rows that hit EOS or run out of room freeze (their
buffer and fill stop changing) while the rest go on.  When no row has
room for a whole window, a tail of single-token greedy steps (the fused
decode kernel, K12, on an eligible stack) finishes the rows.

The JAX function is one jitted pair of ``lax.while_loop``s; here both are
host loops that read the device once a step, for the loop test.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import ModelConfig
from ..models import model as model_lib
from .generation import params_device

# shared with api.py's eligibility check so the two can't drift
DEFAULT_DRAFT_LEN = 5
DEFAULT_NGRAM = 3


def _greedy_ids(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """argmax over the REAL vocabulary (the logits cover the padded one,
    whose untrained columns must never win)."""
    return torch.argmax(logits[..., :vocab], dim=-1)


@dataclasses.dataclass(frozen=True)
class SpeculativeOutput:
    tokens: torch.Tensor   # [b, max_seq] int64: prompts + generations
    lengths: torch.Tensor  # [b] int64: total length incl. the prompt
    steps: int             # forwards after the prefill (verify and tail)
    # the port's addition: draft tokens the verify steps proposed to
    # active rows, and those accepted
    proposed: int = 0
    accepted: int = 0


def _cols(buf: torch.Tensor, start: torch.Tensor, w: int) -> torch.Tensor:
    """Per-row column indices ``[b, w]`` from ``start`` ``[b]``, the start
    clamped so the slice fits, as ``dynamic_slice`` clamps it."""
    start = start.clamp(0, buf.shape[1] - w)
    return start[:, None] + torch.arange(w, device=buf.device)[None, :]


def _row_update(buf, rows, start):
    """Per-row ``dynamic_update_slice`` of ``rows`` ``[b, w]`` into ``buf``
    ``[b, T]`` at each row's ``start`` (a new tensor)."""
    return buf.scatter(1, _cols(buf, start, rows.shape[1]), rows)


def _row_slice(buf, start, w: int):
    """Per-row ``dynamic_slice`` ``[b, w]`` of ``buf`` at ``start``."""
    return torch.gather(buf, 1, _cols(buf, start, w))


def _ngram_draft(tokens, cur, t0, *, ngram: int, draft_len: int):
    """Per-row draft by the most recent n-gram match.

    ``tokens`` ``[b, T]`` holds valid content on ``[0, cur_i)``; ``t0``
    ``[b]`` is the just-chosen token at each row's ``cur_i``.  The key is
    the last ``ngram`` tokens ending at ``cur_i``; the draft is the
    ``draft_len`` tokens that followed its most recent earlier
    occurrence.  No match repeats ``t0`` (the verify then rejects it)."""
    b, T = tokens.shape
    buf = _row_update(tokens, t0[:, None], cur)
    key = _row_slice(buf, cur + 1 - ngram, ngram)        # [b, ngram]
    n_win = T - ngram + 1
    match = torch.ones((b, n_win), dtype=torch.bool, device=tokens.device)
    for o in range(ngram):
        match &= buf[:, o:o + n_win] == key[:, o:o + 1]
    j_idx = torch.arange(n_win, device=tokens.device)
    # only occurrences ending before each row's key
    valid = (j_idx[None, :] + ngram - 1) < cur[:, None]
    score = torch.where(match & valid, j_idx[None, :] + 1,
                        torch.zeros_like(j_idx)[None, :])
    j_best = torch.argmax(score, dim=1)       # the most recent match
    found = score.max(dim=1).values > 0
    idx = (j_best[:, None] + ngram
           + torch.arange(draft_len, device=tokens.device)[None, :])
    draft = torch.gather(buf, 1, idx.clamp(0, T - 1))
    return torch.where(found[:, None], draft, t0[:, None].expand(b, draft_len))


@torch.no_grad()
def generate_tokens_pld(cfg: ModelConfig, params, tokens, lengths, *,
                        eos_id: int = 2, draft_len: int = DEFAULT_DRAFT_LEN,
                        ngram: int = DEFAULT_NGRAM,
                        use_eos_stop: bool = True) -> SpeculativeOutput:
    """Greedy generation with prompt-lookup speculative decoding into
    ``tokens`` ``[b, max_seq]`` from prompt ``lengths`` ``[b]`` (ragged
    allowed)."""
    device = params_device(params)
    tokens = torch.as_tensor(tokens, device=device).to(torch.long)
    lengths = torch.as_tensor(lengths, device=device).to(torch.long)
    lo, hi = int(lengths.min()), int(lengths.max())
    if lo < ngram:
        raise ValueError(f"prompt length {lo} shorter than ngram {ngram}")
    if lo >= tokens.shape[1]:
        raise ValueError("no room to generate")
    b, max_seq = tokens.shape
    k = draft_len
    vocab = cfg.vocab_size
    rope = model_lib.rope_tables(cfg, device=device)
    # The cache is padded past max_seq: frozen rows (EOS'd or out of room)
    # still ride through the lockstep verify forward, and their discarded
    # window rows must land somewhere harmless (past-fill rows are masked
    # until overwritten).  The pad rounds up to a multiple of 128 so the
    # cache widths are JAX's.  Those rows' positions, cur .. cur + k, can
    # also pass the end of the position tables (the rope table, GPT's
    # learned positions): XLA clamps its gather there silently, torch
    # would index out of bounds, so the positions fed to every forward
    # below are clamped to the last table row, as kernels/decode_step.py:
    # rope_rows clamps (the fills are not: the rows must still land past
    # each row's fill, not on a frozen row's committed rows).  A row that
    # commits never reaches the clamp when max_seq <= the tables, so
    # active rows' bits and the JAX result stay the same.
    pad_len = -(-(max_seq + k + 1) // 128) * 128
    last_pos = cfg.max_position_embeddings - 1
    k_cache, v_cache = model_lib.init_kv_cache(cfg, b, pad_len, device=device)

    # one prefill over the longest prompt: the rows past each prompt hold
    # garbage K/V that the per-row fill masks until committed tokens
    # overwrite them
    logits, k_cache, v_cache = model_lib.forward_cached(
        cfg, params, tokens[:, :hi], k_cache, v_cache, 0, rope=rope,
        empty_cache=True, logit_rows=lengths - 1)
    last_logits = logits[:, 0]

    cur = lengths.clone()
    done = torch.zeros((b,), dtype=torch.bool, device=device)
    out_lengths = lengths.clone()
    steps = 0
    offs = torch.arange(k + 1, device=device)
    proposed = torch.zeros((), dtype=torch.long, device=device)
    accepted = torch.zeros((), dtype=torch.long, device=device)

    def positions(w: int):
        return (cur[:, None] + offs[None, :w]).clamp(max=last_pos)

    while True:
        active = ~done & (cur + k + 1 <= max_seq)
        if not bool(active.any()):
            break
        t0 = _greedy_ids(last_logits, vocab)
        draft = _ngram_draft(tokens, cur, t0, ngram=ngram, draft_len=k)
        window = torch.cat([t0[:, None], draft], dim=1)  # [b, k + 1]
        logits, k_cache, v_cache = model_lib.forward_cached(
            cfg, params, window, k_cache, v_cache, cur, rope=rope,
            position_ids=positions(k + 1))
        greedy = _greedy_ids(logits, vocab)  # [b, k + 1]

        # draft[:, i] is accepted iff it equals the model's greedy token
        # after the prefix ending at draft[:, i - 1]: cumulative agreement,
        # advanced per row (frozen rows commit nothing)
        agree = torch.cumprod((draft == greedy[:, :k]).to(torch.long), dim=1)
        m = agree.sum(dim=1)                               # [b]
        n_commit = torch.where(active, m + 1, torch.zeros_like(m))
        proposed += active.sum() * k
        accepted += (n_commit - active.to(torch.long)).sum()

        # commit [t0, d1 .. dm] at each row's own position (positions past
        # cur + m are scratch the next step overwrites); frozen rows'
        # buffers stay bit for bit
        start = torch.clamp(cur, max=max_seq - (k + 1))
        old = _row_slice(tokens, start, k + 1)
        tokens = _row_update(tokens, torch.where(active[:, None], window, old),
                             start)
        if use_eos_stop:
            committed = offs[None, :] < n_commit[:, None]
            is_eos = (window == eos_id) & committed
            hit = is_eos.any(dim=1)
            first = torch.argmax(is_eos.to(torch.long), dim=1)
            just_done = active & hit
            out_lengths = torch.where(
                just_done, cur + first + 1,
                torch.where(active, cur + n_commit, out_lengths))
            done = done | just_done
        else:
            out_lengths = torch.where(active, cur + n_commit, out_lengths)

        # the next step's logits: the row after each row's last committed
        # token (its argmax is the next t0)
        nl = torch.gather(logits, 1, m[:, None, None].expand(
            b, 1, logits.shape[2]))[:, 0]
        last_logits = torch.where(active[:, None], nl, last_logits)
        cur = cur + n_commit
        steps += 1

    # tail: fewer than draft_len + 1 slots left for a row: plain greedy,
    # one token a forward, still per row
    while True:
        active = ~done & (cur < max_seq)
        if not bool(active.any()):
            break
        t0 = _greedy_ids(last_logits, vocab)
        safe = torch.clamp(cur, max=max_seq - 1)
        old = _row_slice(tokens, safe, 1)
        tokens = _row_update(
            tokens, torch.where(active[:, None], t0[:, None], old), safe)
        out_lengths = torch.where(active, cur + 1, out_lengths)
        if use_eos_stop:
            done = done | (active & (t0 == eos_id))
        logits, k_cache, v_cache = model_lib.forward_cached(
            cfg, params, t0[:, None], k_cache, v_cache, cur, rope=rope,
            position_ids=positions(1))
        last_logits = torch.where(active[:, None], logits[:, 0], last_logits)
        cur = torch.where(active, cur + 1, cur)
        steps += 1
    return SpeculativeOutput(tokens=tokens, lengths=out_lengths, steps=steps,
                             proposed=int(proposed), accepted=int(accepted))
