"""The serving engine's device work, one method an operation.

``ServingEngine`` keeps the host state (queue, scheduler, block ledger,
prefix trie, the first token's sampling) and hands every operation that
touches the KV state to a ``DeviceOps``: the pool's allocation, a
prefill piece into a batch-1 working cache, the publication of that
cache into pool blocks, a decode step, a speculative verify step and a
copy-on-write block copy.  Each method takes host values (numpy arrays,
ints, flags) and names the device state it works on: the pool, the
working caches (keyed by the request's id) and the last decode step's
tokens, which the next step feeds back on the device.

That is the seam of sharded serving (``serving/cluster/sharded.py``):
rank 0's engine drives a ``DeviceOps`` whose calls are also sent to the
other ranks of the mesh, and each of them replays the call on its own
``DeviceOps`` over its own shards, inside ``use_mesh``.  Every rank
samples the same tokens from the same gathered logits and keeps them for
the next step.  In a world of one the engine calls it directly.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..config import ModelConfig
from ..generation.sampling import NEG_INF, generator, gumbel_argmax
from ..models import model as model_lib
from ..parallel import mesh as mesh_lib
from .block_pool import BlockPool


def _sample_slots(logits: torch.Tensor, seeds, counters, greedy, temps,
                  top_ks, top_ps, vocab: int):
    """Per-slot mixed-mode sampling over ``[S, V]`` fp32 logits → ``(tok
    [S] int64, tok_logprob [S] fp32)`` on the logits' device.

    The knob vectors are host numpy arrays.  Greedy slots take the
    padded-vocab-masked argmax; the rest apply temperature, a dynamic
    per-slot top-k rank mask and a per-slot nucleus (top-p) threshold,
    then draw by Gumbel-max from the stream ``(seed, counter)``
    (``generation/sampling.py``): the draw depends only on the request and
    its token index."""
    S, V = logits.shape
    dev = logits.device
    pad = torch.arange(V, device=dev) >= vocab
    logits = logits.masked_fill(pad[None, :], NEG_INF)
    tok = torch.argmax(logits, dim=-1)
    sampled_rows = [i for i in range(S) if not greedy[i]]
    if sampled_rows:
        temps_t = torch.as_tensor(np.asarray(temps, np.float32), device=dev)
        top_ks_t = torch.as_tensor(np.asarray(top_ks, np.int64), device=dev)
        top_ps_t = torch.as_tensor(np.asarray(top_ps, np.float32), device=dev)
        scaled = logits / torch.clamp(temps_t, min=1e-6)[:, None]
        ranks = torch.argsort(torch.argsort(-scaled, dim=-1, stable=True),
                              dim=-1, stable=True)
        kmask = (top_ks_t[:, None] > 0) & (ranks >= top_ks_t[:, None])
        scaled = scaled.masked_fill(kmask, NEG_INF)
        p_eff = torch.where(top_ps_t > 0.0, top_ps_t,
                            torch.ones_like(top_ps_t))[:, None]
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        sorted_probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(sorted_probs, dim=-1)
        kept = sorted_logits.masked_fill((cum - sorted_probs) > p_eff,
                                         float("inf"))
        threshold = kept.min(dim=-1, keepdim=True).values
        scaled = scaled.masked_fill(scaled < threshold, NEG_INF)
        for i in sampled_rows:
            gen = generator((seeds[i], counters[i]), dev)
            tok[i] = gumbel_argmax(scaled[i:i + 1], gen)[0]
    lp = torch.log_softmax(logits, dim=-1)
    tok_lp = torch.gather(lp, 1, tok[:, None])[:, 0]
    return tok, tok_lp


def _verify_step(cfg: ModelConfig, params, pool, tables, window, fills,
                 bids, offs, seeds, counters, greedy, temps, top_ks, top_ps,
                 *, rope, use_fused: bool, tree=None, lora=None):
    """One speculative verify step over every slot: score each slot's
    ``[pending, draft...]`` window (or, with ``tree = (depths, anc)``, the
    nodes of its candidate tree) in one forward
    (``forward_cached_paged_verify``).  Position 0 samples exactly as a
    plain decode step does (same ``_sample_slots``, same stream), so a
    slot riding with no draft takes an unchanged plain step; positions
    >= 1 only ever commit under greedy acceptance, so their pad-masked
    argmax is all they need; ``lora`` is the per-slot LoRA bundle.
    Returns ``([S, W] tokens, [S, W] logprobs)`` on the device."""
    logits, _, _ = model_lib.forward_cached_paged_verify(
        cfg, params, window, pool.k_pool, pool.v_pool, tables, fills, bids,
        offs, rope=rope, use_fused=use_fused, tree=tree, lora=lora)
    tok0, tok0_lp = _sample_slots(logits[:, 0], seeds, counters, greedy,
                                  temps, top_ks, top_ps, cfg.vocab_size)
    pad = torch.arange(logits.shape[-1], device=logits.device) \
        >= cfg.vocab_size
    masked = logits.masked_fill(pad, NEG_INF)
    g_tok = torch.argmax(masked, dim=-1)
    g_lp = torch.gather(torch.log_softmax(masked, dim=-1), 2,
                        g_tok[..., None])[..., 0]
    g_tok[:, 0] = tok0
    g_lp[:, 0] = tok0_lp
    return g_tok, g_lp


class DeviceOps:
    """One rank's device state and work for the serving engine (see the
    module docstring).  ``mesh`` (a serving mesh, or None) is made
    current around every operation, so the model's collectives and the
    pool's shapes follow it."""

    def __init__(self, cfg, params, device, mesh=None):
        self.cfg = cfg
        self.params = params
        self.device = device
        self.mesh = mesh
        self.pool = None
        self.rope = None
        self.width = 0
        self._work: dict = {}   # key -> (k, v) batch-1 working caches
        self._tok = None        # the last decode step's tokens [S]

    def _scope(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_lib.use_mesh(self.mesh)

    def tensor(self, a) -> torch.Tensor:
        """Host array → device tensor without stalling the stream (pinned
        staging + non-blocking copy on the card)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- the operations ------------------------------------------------------

    def start(self, n_blocks: int, block_size: int, width: int) -> BlockPool:
        """Allocate the pool (this rank's slice under a mesh) and the RoPE
        tables; ``width`` is a working cache's length."""
        with self._scope():
            self.pool = BlockPool(self.cfg, n_blocks, block_size,
                                  device=self.device, mesh=self.mesh)
            self.rope = model_lib.rope_tables(self.cfg, device=self.device)
        self.pool.copier = self.copy_block
        self.width = int(width)
        return self.pool

    def prefill(self, key, tokens: np.ndarray, off: int, *, fresh: bool,
                table=None, rows=None, lora=None) -> torch.Tensor:
        """One prefill piece: ``forward_cached`` of ``tokens [1, w]`` at
        positions ``off ..`` over working cache ``key`` (made now with
        ``fresh``: empty, or the pool blocks of ``table [1, T]``
        gathered), attending the rows before ``off`` (``empty_cache`` at
        offset 0).  ``rows``: None for every position's logits, ``"last"``
        for the last, an int for that row's → the logits."""
        with self._scope():
            if fresh:
                if table is None:
                    work = model_lib.init_kv_cache(self.cfg, 1, self.width,
                                                   device=self.device)
                else:
                    t = self.tensor(np.asarray(table, np.int64))
                    work = (model_lib.cache_gather_blocks(self.pool.k_pool, t),
                            model_lib.cache_gather_blocks(self.pool.v_pool, t))
                self._work[key] = work
            k, v = self._work[key]
            kw = {}
            if rows == "last":
                kw["last_logit_only"] = True
            elif rows is not None:
                kw["logit_rows"] = torch.tensor([int(rows)])
            logits, k, v = model_lib.forward_cached(
                self.cfg, self.params,
                self.tensor(np.asarray(tokens, np.int64)), k, v, int(off),
                rope=self.rope, empty_cache=off == 0, lora=lora, **kw)
            self._work[key] = (k, v)
        return logits

    def work(self, key) -> tuple:
        """Working cache ``key``'s ``(k, v)`` on this rank."""
        return self._work[key]

    def publish(self, key, scatter: np.ndarray) -> None:
        """Write working cache ``key`` into the pool: its block i into block
        ``scatter[i]`` (the trash block: nowhere); the cache is dropped."""
        k, v = self._work.pop(key)
        with self._scope():
            bids = self.tensor(np.asarray(scatter, np.int64))
            model_lib.cache_scatter_blocks(self.pool.k_pool, k, bids)
            model_lib.cache_scatter_blocks(self.pool.v_pool, v, bids)

    def drop(self, key) -> None:
        """Forget working cache ``key`` (an aborted prefill)."""
        self._work.pop(key, None)

    def decode(self, tables, fills, overrides, override_mask, use_prev,
               seeds, counters, greedy, temps, top_ks, top_ps, *,
               groups: int = 1, use_fused: bool = False, lora=None):
        """One decode step over every slot → ``(tok [S], logprob [S])`` on
        the device, kept for the next step.  Each slot feeds its override
        where ``override_mask`` says so (or everywhere without
        ``use_prev``), else the token the previous step sampled, on the
        device.  ``groups`` splits the slots into that many contiguous
        groups decoded one after the other (the serving mesh's pipeline
        groups); per-row math makes the tokens those of one group."""
        S = len(fills)
        gs = S // groups
        toks, lps = [], []
        with self._scope():
            for g in range(groups):
                sl = slice(g * gs, (g + 1) * gs)
                if not use_prev:
                    pending = self.tensor(overrides[sl])
                elif override_mask[sl].any():
                    pending = torch.where(self.tensor(override_mask[sl]),
                                          self.tensor(overrides[sl]),
                                          self._tok[sl])
                else:
                    pending = self._tok[sl]  # device-to-device handoff
                glora = lora if lora is None or groups == 1 else \
                    (lora[0], lora[1][sl])
                logits, _, _ = model_lib.forward_cached_paged(
                    self.cfg, self.params, pending[:, None],
                    self.pool.k_pool, self.pool.v_pool,
                    self.tensor(tables[sl]), self.tensor(fills[sl]),
                    rope=self.rope, use_fused=use_fused, lora=glora)
                tok, lp = _sample_slots(
                    logits[:, 0], seeds[sl], counters[sl], greedy[sl],
                    temps[sl], top_ks[sl], top_ps[sl], self.cfg.vocab_size)
                toks.append(tok)
                lps.append(lp)
        tok, lp = ((toks[0], lps[0]) if groups == 1
                   else (torch.cat(toks), torch.cat(lps)))
        self._tok = tok
        return tok, lp

    def verify(self, tables, window, fills, bids, offs, seeds, counters,
               greedy, temps, top_ks, top_ps, *, use_fused: bool = False,
               lora=None):
        """One speculative verify step (``_verify_step``) → ``([S, W]
        tokens, [S, W] logprobs)`` on the device."""
        t = self.tensor
        with self._scope():
            return _verify_step(
                self.cfg, self.params, self.pool, t(tables), t(window),
                t(fills), t(bids), t(offs), seeds, counters, greedy, temps,
                top_ks, top_ps, rope=self.rope, use_fused=use_fused,
                lora=lora)

    def copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write: block ``src``'s rows onto block ``dst``."""
        self.pool.copy(src, dst)

    def close(self) -> None:
        """The engine's shutdown (nothing to release in a world of one)."""

    def abort(self) -> None:
        """The scheduler died (nothing to release in a world of one)."""
