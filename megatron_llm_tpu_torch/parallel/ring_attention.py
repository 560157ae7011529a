"""Ring attention: context parallelism over the ``cp`` axis (mirror of
``megatron_llm_tpu/parallel/ring_attention.py``).

The sequence of Q, K and V is split over the cp group; exact softmax
attention comes from rotating the K/V blocks around the ring
(``mappings.ppermute``) while each rank folds every block into online
softmax statistics.  The semantics are JAX's:

- contiguous ownership: rank ``r`` holds positions ``[r * s, (r + 1) *
  s)``; or the zigzag layout, where rank ``r`` holds the half-size chunks
  ``(r, 2n - 1 - r)`` of a sequence the step permuted with
  ``zigzag_indices`` (causal only);
- after ``i`` rotations a rank holds the block of rank ``(my - i) mod
  n``; the causal and segment masks are applied per block;
- a row masked so far keeps its exponent base at 0 (``safe_m``), so no
  ``exp`` is NaN;
- ``n - 1`` rotations, the last block folded outside the loop.

JAX differentiates the scan.  Here the ring is one
``torch.autograd.Function``: the forward saves q, k, v, the output and
the fp32 log-sum-exp, and the backward rotates K/V again, recomputing
each block's probabilities from the log-sum-exp, while each block's dK
and dV accumulators travel with it and take one more rotation home.
Left to autograd, the loop would keep every block's fp32 ``[b, kv, g,
sq, sk]`` probabilities for each layer.  A block is folded a few kv
heads at a time (``BLOCK_BYTES``), which changes no number: the heads are
independent.

A (query chunk, key chunk) pair is skipped where the whole key chunk is
in the future of the query chunk (JAX's zigzag skips it with
``lax.cond``; its contiguous ring computes it fully masked, which adds
exact zeros).  The blocks are plain PyTorch, as JAX's are: the ring
runs none of the attention kernels.

Under ``whole_sequence`` (a custom loss under cp: the BERT, T5 and ICT
losses, whose batches the step does not cut) every cp rank holds the
whole sequence and computes the rest of the model whole alike, as JAX's
step runs them: their batch is sharded over dp alone, and only the
ring's ``shard_map`` splits the sequence over cp.  The ring then takes
this rank's block of q, k and v (``mappings.split_region``) and
all-gathers the output (``mappings.gather_whole``), so the attention's
quadratic work is split over cp and every rank's grads are whole.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from . import mappings
from . import mesh as mesh_lib

CP = mesh_lib.CONTEXT_AXIS


def zigzag_indices(seq_len: int, cp: int) -> np.ndarray:
    """The permutation ``pi`` with ``zigzag[i] = x[pi[i]]``: chunk order
    ``[0, 2n-1, 1, 2n-2, ...]``, so cp rank ``r`` holds chunks ``(r,
    2n-1-r)``."""
    if seq_len % (2 * cp):
        raise ValueError(f"seq_len {seq_len} must divide by 2*cp={2 * cp}")
    c = seq_len // (2 * cp)
    order = []
    for r in range(cp):
        order += [r, 2 * cp - 1 - r]
    return np.concatenate([np.arange(ch * c, (ch + 1) * c) for ch in order])


def inverse_zigzag_indices(seq_len: int, cp: int) -> np.ndarray:
    return np.argsort(zigzag_indices(seq_len, cp))


def _chunks(rank: int, n: int, s: int, zigzag: bool) -> list:
    """``[(chunk id, start, length), ...]`` of the rank's ``s`` local
    positions: one chunk ``rank`` (contiguous; chunk ``j`` covers global
    positions ``[j * s, (j + 1) * s)``), or the zigzag pair ``(rank, 2n -
    1 - rank)`` of half-size chunks."""
    if not zigzag:
        return [(rank, 0, s)]
    c = s // 2
    return [(rank, 0, c), (2 * n - 1 - rank, c, c)]


BLOCK_BYTES = 256 << 20  # one fp32 [b, heads, g, sq, sk] block at most


def _head_block(b: int, nkv: int, g: int, s: int, zigzag: bool) -> int:
    """KV heads a block takes at a time, so its fp32 scores (and each of
    the probabilities and their grads) stay within ``BLOCK_BYTES``: at
    Llama-2-7B widths and 4096 positions a rank, a whole block's scores
    would be 2 GiB."""
    c = s // 2 if zigzag else s
    per_head = b * g * c * c * 4
    return max(1, min(nkv, BLOCK_BYTES // max(per_head, 1)))


def _relation(causal: bool, qid: int, kid: int) -> Optional[str]:
    """How a key chunk meets a query chunk of the same length: ``"full"``,
    ``"diag"`` (the causal triangle), or None (wholly in the future)."""
    if not causal or kid < qid:
        return "full"
    return "diag" if kid == qid else None


def _scores(qc, kc, qs, ks, rel, scale):
    """Masked fp32 scores ``[b, kv, g, sq, sk]`` of a query chunk ``[b, sq,
    kv, g, d]`` against a key chunk ``[b, sk, kv, d]``."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), kc.float()) * scale
    if rel == "diag":
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    if qs is not None:
        same = qs[:, :, None] == ks[:, None, :]
        s = s.masked_fill(~same[:, None, None], float("-inf"))
    return s


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, group, causal, zigzag, scale):
        n = mappings.group_size(group)
        my = mappings.group_rank(group)
        b, s, nq, d = q.shape
        nkv = k.shape[2]
        g = nq // nkv
        qg = q.reshape(b, s, nkv, g, d)
        qch = _chunks(my, n, s, zigzag)
        states = [(torch.full((b, nkv, g, ln), float("-inf"),
                              device=q.device),
                   torch.zeros((b, nkv, g, ln), device=q.device),
                   torch.zeros((b, ln, nkv, g, d), device=q.device))
                  for _, _, ln in qch]
        ring = [(j, (j + 1) % n) for j in range(n)]
        kb, vb, sb = k, v, k_seg
        hb = _head_block(b, nkv, g, s, zigzag)
        for i in range(n):
            src = (my - i) % n
            for qi, (qid, qo, ql) in enumerate(qch):
                m, l, acc = states[qi]
                qs = None if q_seg is None else q_seg[:, qo:qo + ql]
                for kid, ko, kl in _chunks(src, n, s, zigzag):
                    rel = _relation(causal, qid, kid)
                    if rel is None:
                        continue
                    ks = None if sb is None else sb[:, ko:ko + kl]
                    for h in range(0, nkv, hb):  # a few heads at a time
                        hs = slice(h, h + hb)
                        mh = m[:, hs]
                        sc = _scores(qg[:, qo:qo + ql, hs],
                                     kb[:, ko:ko + kl, hs], qs, ks, rel,
                                     scale)
                        new_m = torch.maximum(mh, sc.amax(dim=-1))
                        safe_m = torch.where(torch.isneginf(new_m),
                                             torch.zeros_like(new_m), new_m)
                        corr = torch.where(torch.isneginf(mh),
                                           torch.zeros_like(mh),
                                           torch.exp(mh - safe_m))
                        p = torch.exp(sc - safe_m[..., None])
                        del sc
                        l[:, hs] = l[:, hs] * corr + p.sum(dim=-1)
                        pv = torch.einsum("bhgqk,bkhd->bqhgd",
                                          p.to(v.dtype).float(),
                                          vb[:, ko:ko + kl, hs].float())
                        acc[:, :, hs] = acc[:, :, hs] * corr.permute(
                            0, 3, 1, 2)[..., None] + pv
                        m[:, hs] = new_m
            if i < n - 1:  # the last block is folded without a rotation
                kb = mappings.ppermute(kb, group, ring)
                vb = mappings.ppermute(vb, group, ring)
                if sb is not None:
                    sb = mappings.ppermute(sb, group, ring)
        outs, lses = [], []
        for m, l, acc in states:
            la = l.permute(0, 3, 1, 2)[..., None]
            outs.append(torch.where(la > 0, acc / torch.where(
                la > 0, la, torch.ones_like(la)), torch.zeros_like(acc)))
            lses.append(torch.where(l > 0, m + torch.log(
                torch.where(l > 0, l, torch.ones_like(l))),
                torch.full_like(l, float("-inf"))))
        out = torch.cat(outs, dim=1).reshape(b, s, nq, d).to(q.dtype)
        ctx.save_for_backward(q, k, v, q_seg, k_seg, out, *lses)
        ctx.cfg = (group, causal, zigzag, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_seg, k_seg, out, *lses = ctx.saved_tensors
        group, causal, zigzag, scale = ctx.cfg
        n = mappings.group_size(group)
        my = mappings.group_rank(group)
        b, s, nq, d = q.shape
        nkv = k.shape[2]
        g = nq // nkv
        qg = q.reshape(b, s, nkv, g, d)
        do = dout.reshape(b, s, nkv, g, d).float()
        # D = rowsum(dO * O), [b, kv, g, s]
        big_d = (do * out.reshape(b, s, nkv, g, d).float()).sum(-1) \
            .permute(0, 2, 3, 1)
        dq = torch.zeros((b, s, nkv, g, d), device=q.device)
        qch = _chunks(my, n, s, zigzag)
        ring = [(j, (j + 1) % n) for j in range(n)]
        kb, vb, sb = k, v, k_seg
        dkb = torch.zeros(k.shape, device=k.device)
        dvb = torch.zeros(v.shape, device=v.device)
        hb = _head_block(b, nkv, g, s, zigzag)
        for i in range(n):
            src = (my - i) % n
            for qi, (qid, qo, ql) in enumerate(qch):
                lse = lses[qi]
                safe = torch.where(torch.isneginf(lse),
                                   torch.zeros_like(lse), lse)
                qs = None if q_seg is None else q_seg[:, qo:qo + ql]
                for kid, ko, kl in _chunks(src, n, s, zigzag):
                    rel = _relation(causal, qid, kid)
                    if rel is None:
                        continue
                    ks = None if sb is None else sb[:, ko:ko + kl]
                    for h in range(0, nkv, hb):  # a few heads at a time
                        hs = slice(h, h + hb)
                        qc = qg[:, qo:qo + ql, hs]
                        kc = kb[:, ko:ko + kl, hs]
                        vc = vb[:, ko:ko + kl, hs]
                        doc = do[:, qo:qo + ql, hs]
                        p = torch.exp(_scores(qc, kc, qs, ks, rel, scale)
                                      - safe[:, hs, ..., None])
                        dvb[:, ko:ko + kl, hs] += torch.einsum(
                            "bhgqk,bqhgd->bkhd", p.to(v.dtype).float(), doc)
                        ds = torch.einsum("bqhgd,bkhd->bhgqk", doc,
                                          vc.float())
                        ds = p * (ds - big_d[:, hs, :, qo:qo + ql, None])
                        del p
                        dq[:, qo:qo + ql, hs] += torch.einsum(
                            "bhgqk,bkhd->bqhgd", ds, kc.float()) * scale
                        dkb[:, ko:ko + kl, hs] += torch.einsum(
                            "bhgqk,bqhgd->bkhd", ds, qc.float()) * scale
            # each block's dK/dV travel with it; after the last block one
            # more rotation takes them home
            dkb = mappings.ppermute(dkb, group, ring)
            dvb = mappings.ppermute(dvb, group, ring)
            if i < n - 1:
                kb = mappings.ppermute(kb, group, ring)
                vb = mappings.ppermute(vb, group, ring)
                if sb is not None:
                    sb = mappings.ppermute(sb, group, ring)
        return (dq.reshape(q.shape).to(q.dtype), dkb.to(k.dtype),
                dvb.to(v.dtype), None, None, None, None, None, None)


def _ring(q, k, v, q_seg, k_seg, group, causal, zigzag, softmax_scale):
    if softmax_scale is None:
        softmax_scale = 1.0 / float(np.sqrt(q.shape[-1]))
    if k_seg is None:
        k_seg = q_seg
    if k.shape[1] != q.shape[1]:
        raise ValueError("ring attention takes equal q and k shards")
    if zigzag and q.shape[1] % 2:
        raise ValueError("the zigzag layout takes an even shard length")
    return _Ring.apply(q, k, v, q_seg, k_seg, group, causal, zigzag,
                       float(softmax_scale))


def ring_attention_local(q, k, v, q_seg=None, k_seg=None, *, group,
                         causal: bool = True,
                         softmax_scale: Optional[float] = None):
    """Exact ring attention on this rank's contiguous shards ``[b,
    s_local, heads, d]`` over ``group`` (JAX's, inside ``shard_map``)."""
    return _ring(q, k, v, q_seg, k_seg, group, causal, False, softmax_scale)


def ring_attention_zigzag_local(q, k, v, q_seg=None, k_seg=None, *, group,
                                softmax_scale: Optional[float] = None):
    """Causal ring attention on zigzag-ordered shards (chunks ``(r, 2n -
    1 - r)``)."""
    return _ring(q, k, v, q_seg, k_seg, group, True, True, softmax_scale)


def _group(mesh, axis_name):
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh is None:
        raise ValueError("ring attention needs a mesh (pass mesh= or enter "
                         "parallel.mesh.use_mesh)")
    return mesh.group(axis_name)


def ring_attention(q, k, v, *, mesh=None, axis_name: str = CP,
                   causal: bool = True, segment_ids=None,
                   softmax_scale: Optional[float] = None):
    """The ring over ``axis_name`` of ``mesh`` (default the current
    mesh); q, k, v and ``segment_ids`` are this rank's shards."""
    return ring_attention_local(q, k, v, segment_ids, segment_ids,
                                group=_group(mesh, axis_name), causal=causal,
                                softmax_scale=softmax_scale)


def ring_attention_zigzag(q, k, v, *, mesh=None, axis_name: str = CP,
                          segment_ids=None,
                          softmax_scale: Optional[float] = None):
    """The zigzag ring over ``axis_name`` of ``mesh`` (default the current
    mesh) on zigzag-ordered shards."""
    return ring_attention_zigzag_local(
        q, k, v, segment_ids, segment_ids, group=_group(mesh, axis_name),
        softmax_scale=softmax_scale)


_WHOLE = [False]


@contextlib.contextmanager
def whole_sequence(on: bool = True):
    """Inside the block (with ``on``), ``ops.attention``'s ring takes q, k
    and v that every cp rank holds whole (``ring_attention_whole``)."""
    old = _WHOLE[0]
    _WHOLE[0] = old or on
    try:
        yield
    finally:
        _WHOLE[0] = old


def whole_sequence_on() -> bool:
    return _WHOLE[0]


def ring_attention_whole(q, k, v, *, mesh=None, axis_name: str = CP,
                         causal: bool = True, segment_ids=None,
                         softmax_scale: Optional[float] = None):
    """The contiguous ring on q, k, v ``[b, s, heads, d]`` that every rank
    of the cp group holds whole: this rank's ``s / cp`` block of each
    through the ring, the output gathered whole (its grad's block
    backward; the blocks' grads gathered into whole ones)."""
    group = _group(mesh, axis_name)
    n = mappings.group_size(group)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"ring attention: sequence lengths {q.shape[1]}, "
                         f"{k.shape[1]} must divide by cp = {n}")
    q, k, v = (mappings.split_region(t, group, 1) for t in (q, k, v))
    seg = None if segment_ids is None else \
        mappings.split(segment_ids, group, 1).contiguous()
    out = ring_attention_local(q, k, v, seg, seg, group=group, causal=causal,
                               softmax_scale=softmax_scale)
    return mappings.gather_whole(out, group, 1)
