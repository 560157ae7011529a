"""Cross entropy (mirror of ``megatron_llm_tpu/parallel/cross_entropy.py``).

- ``cross_entropy``: stable log-softmax CE over fp32 logits, with label
  smoothing (reference cross_entropy.py:71-86) and the padded vocabulary
  columns masked out;
- ``vocab_parallel_cross_entropy``: the same over vocab-sharded logits,
  as an autograd Function with the reference's three all-reduces (max,
  target logit, sum of exp; cross_entropy.py:14-130), JAX's ``_ce_shard``;
  ``vocab_parallel_max_indices`` the greedy argmax over the shards;
- ``masked_mean_loss``: the loss-mask weighted mean (a local helper: under
  data parallelism the step hands it the denominator, ``loss_denom``);
- ``fused_linear_cross_entropy``: the LM head and the CE in one pass over
  vocabulary blocks, so the ``[n, vocab]`` fp32 logits never exist at
  once (tp = 1 only, as JAX ``training/step.py:111-116`` gates it).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import mappings

_MASKED = -1e30  # padded vocab columns (finite, as in JAX)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  label_smoothing: float = 0.0,
                  vocab_size: int | None = None) -> torch.Tensor:
    """Per-token CE of ``logits [..., width]`` against ``targets [...]``;
    ``vocab_size`` masks the padded columns past it."""
    logits = logits.float()
    width = logits.shape[-1]
    valid = None
    if vocab_size is not None and vocab_size < width:
        valid = torch.arange(width, device=logits.device) < vocab_size
        logits = logits.masked_fill(~valid, _MASKED)
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    target_logit = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    loss = lse - target_logit
    if label_smoothing > 0.0:
        # s = ls * K / (K - 1); loss = (1 - s) nll - s mean(log_probs), over
        # the K real vocab columns only
        n = vocab_size if vocab_size is not None else width
        smoothing = label_smoothing * n / (n - 1)
        kept = logits if valid is None else logits.masked_fill(~valid, 0.0)
        sum_log_probs = kept.sum(dim=-1) - n * lse
        loss = (1.0 - smoothing) * loss - smoothing * (sum_log_probs / n)
    return loss


def masked_mean_loss(per_token_loss: torch.Tensor, loss_mask: torch.Tensor,
                     denom: torch.Tensor | None = None) -> torch.Tensor:
    """Loss-mask weighted mean (reference: finetune.py:196-213).

    ``denom`` replaces the mask's own sum: under data parallelism the step
    passes the batch's ``loss_denom`` (``training/step.loss_denominators``),
    so the mean over dp of the ranks' losses is the global masked mean."""
    loss_mask = loss_mask.to(per_token_loss.dtype)
    total = torch.sum(per_token_loss * loss_mask)
    if denom is None:
        denom = torch.clamp(torch.sum(loss_mask), min=1.0)
    return total / denom


# ---------------------------------------------------------------------------
# Vocab-parallel CE (JAX ``_ce_shard`` and
# ``vocab_parallel_cross_entropy_shardmap``)
# ---------------------------------------------------------------------------


def _vocab_shard(logits, group, vocab_size):
    """``(rank's first column, its width, the valid-column mask or None,
    logits with the padded columns masked)``."""
    width = logits.shape[-1]
    start = mappings.group_rank(group) * width
    valid = None
    if vocab_size is not None and start + width > vocab_size:
        valid = (start + torch.arange(width, device=logits.device)) \
            < vocab_size
        logits = logits.masked_fill(~valid, _MASKED)
    return start, width, valid, logits


class _VocabParallelCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, group, label_smoothing, vocab_size):
        logits = logits.float()
        start, width, valid, logits = _vocab_shard(logits, group,
                                                   vocab_size)
        n_total = width * mappings.group_size(group)
        m = mappings.all_reduce(logits.amax(dim=-1), group,
                                dist.ReduceOp.MAX)
        shifted = logits - m[..., None]
        local_t = targets.long() - start
        in_shard = (local_t >= 0) & (local_t < width)
        idx = local_t.clamp(0, width - 1)
        tl = torch.gather(shifted, -1, idx[..., None])[..., 0]
        target_logit = mappings.all_reduce(
            torch.where(in_shard, tl, 0.0), group)
        exp = torch.exp(shifted)
        sum_exp = mappings.all_reduce(exp.sum(dim=-1), group)
        lse = torch.log(sum_exp)
        loss = lse - target_logit
        n = vocab_size if vocab_size is not None else n_total
        smoothing = 0.0
        if label_smoothing > 0.0:
            smoothing = label_smoothing * n / (n - 1)
            kept = shifted if valid is None else shifted.masked_fill(~valid,
                                                                     0.0)
            sum_log_probs = mappings.all_reduce(kept.sum(dim=-1),
                                                group) - n * lse
            loss = (1.0 - smoothing) * loss - smoothing * (sum_log_probs / n)
        softmax = exp.div_(sum_exp[..., None])
        ctx.save_for_backward(softmax, idx, in_shard,
                              valid if valid is not None
                              else torch.empty(0, dtype=torch.bool))
        ctx.smoothing, ctx.n, ctx.has_valid = smoothing, n, valid is not None
        return loss

    @staticmethod
    def backward(ctx, g):
        softmax, idx, in_shard, valid = ctx.saved_tensors
        # d loss / d logit_j = p_j - (1 - s) [j = t] - (s / n) [j valid]
        grad = softmax.clone()
        grad.scatter_add_(-1, idx[..., None],
                          -(1.0 - ctx.smoothing) * in_shard.float()[..., None])
        if ctx.smoothing:
            sub = ctx.smoothing / ctx.n
            grad -= valid.float() * sub if ctx.has_valid else sub
        return grad * g[..., None], None, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 group, label_smoothing: float = 0.0,
                                 vocab_size: int | None = None
                                 ) -> torch.Tensor:
    """Per-token CE (fp32 ``[...]``, the same on every rank of ``group``)
    of logits whose last dim is this rank's vocabulary block; columns at
    or past ``vocab_size`` are masked.  With ``group`` None it is the
    one-device CE over the whole vocabulary."""
    return _VocabParallelCrossEntropy.apply(
        logits, targets, group, float(label_smoothing), vocab_size)


def vocab_parallel_max_indices(logits: torch.Tensor, group) -> torch.Tensor:
    """Greedy argmax over vocab-sharded logits (reference
    cross_entropy.py:146-175): the largest value over the ranks, ties to
    the lowest global index, as ``argmax`` over the whole row."""
    width = logits.shape[-1]
    local_max, local_idx = logits.max(dim=-1)
    best = mappings.all_reduce(local_max.clone(), group, dist.ReduceOp.MAX)
    big = torch.iinfo(torch.long).max
    cand = torch.where(local_max == best,
                       local_idx.long() + mappings.group_rank(group) * width,
                       torch.full_like(local_idx, big, dtype=torch.long))
    return mappings.all_reduce(cand, group, dist.ReduceOp.MIN)


# ---------------------------------------------------------------------------
# Fused LM head (JAX parallel/cross_entropy.py:154-257): the unembedding
# product streamed over vocabulary blocks, an online logsumexp in the
# forward, each block's logits recomputed from the saved lse in the
# backward.  The per-block products are plain large matrix products, which
# JAX leaves to XLA and the port to torch.mm.
# ---------------------------------------------------------------------------


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with fp32 output from operands in their own dtype (JAX's
    ``preferred_element_type=float32``): bf16 operands on the card go
    through cuBLAS with fp32 output (``aten::mm.dtype``), never a bf16
    rounding of the product; on the CPU, which lacks that overload, the
    operands widen exactly to fp32 first (one block at a time)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _blocks(v_padded: int, block: int):
    """``(first column, width)`` of each vocabulary block.  The last block
    is narrower where ``block`` does not divide ``v_padded``: JAX pads w
    with zero columns up to whole blocks and masks them (col >=
    vocab_size), which leaves the same sums as not visiting them."""
    return [(c0, min(block, v_padded - c0))
            for c0 in range(0, v_padded, block)]


def _flce_forward(x, w, labels, vocab_size: int, block: int):
    """``(per-token loss, lse)``: fp32 ``[n]`` each."""
    n = x.shape[0]
    dev = x.device
    m = torch.full((n,), float("-inf"), dtype=torch.float32, device=dev)
    l = torch.zeros((n,), dtype=torch.float32, device=dev)
    tgt = torch.zeros((n,), dtype=torch.float32, device=dev)
    for c0, bw in _blocks(w.shape[1], block):
        logits = _mm_f32(x, w[:, c0:c0 + bw])           # [n, bw] fp32
        if c0 + bw > vocab_size:
            logits[:, max(vocab_size - c0, 0):] = float("-inf")
        in_blk = (labels >= c0) & (labels < c0 + bw)
        idx = torch.clamp(labels - c0, 0, bw - 1)
        tl = torch.gather(logits, 1, idx[:, None])[:, 0]
        tgt = torch.where(in_blk, tl, tgt)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        l = l * torch.exp(m - new_m) + \
            logits.sub_(new_m[:, None]).exp_().sum(dim=-1)
        m = new_m
        del logits
    lse = m + torch.log(l)
    return lse - tgt, lse


class _FusedLinearCrossEntropy(torch.autograd.Function):
    """JAX's ``custom_vjp``: the residuals are x, the ORIGINAL w (never a
    padded copy), the labels and the lse."""

    @staticmethod
    def forward(ctx, x, w, labels, vocab_size, block):
        loss, lse = _flce_forward(x, w, labels, vocab_size, block)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.vocab_size, ctx.block = vocab_size, block
        ctx.mark_non_differentiable(lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        vocab_size = ctx.vocab_size
        g = g.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        # a frozen head (LoRA finetuning) takes no dw products
        dw = torch.empty(w.shape, dtype=w.dtype, device=w.device) \
            if ctx.needs_input_grad[1] else None
        for c0, bw in _blocks(w.shape[1], ctx.block):
            w_blk = w[:, c0:c0 + bw]
            # p = softmax from the saved lse, 0 on the padded columns
            p = _mm_f32(x, w_blk).sub_(lse[:, None]).exp_()
            if c0 + bw > vocab_size:
                p[:, max(vocab_size - c0, 0):] = 0.0
            in_blk = (labels >= c0) & (labels < c0 + bw)
            idx = torch.clamp(labels - c0, 0, bw - 1)
            p.scatter_add_(1, idx[:, None], -in_blk.float()[:, None])
            d_cast = p.mul_(g[:, None]).to(w.dtype)       # (p - onehot) g
            del p
            dx += _mm_f32(d_cast, w_blk.T)
            if dw is not None:
                dw[:, c0:c0 + bw] = _mm_f32(x.T, d_cast).to(w.dtype)
        return dx.to(x.dtype), dw, None, None, None


def fused_linear_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor, vocab_size: int,
                               block: int = 8192) -> torch.Tensor:
    """Per-token CE of ``softmax(x @ w)`` (fp32 ``[n]``) without the full
    fp32 logits: ``x [n, h]`` hidden states, ``w [h, v_padded]`` the
    unembedding weight, ``labels [n]`` (not differentiable), columns at
    or past ``vocab_size`` masked out.  Differentiable in x and w; dx
    sums over the blocks in fp32, dw is each block's fp32 product cast to
    w's dtype, as in JAX."""
    return _FusedLinearCrossEntropy.apply(x, w, labels.long(),
                                          int(vocab_size), int(block))
