"""Cross entropy on one device (mirror of
``megatron_llm_tpu/parallel/cross_entropy.py``'s ``cross_entropy`` and
``masked_mean_loss``).

Stable log-softmax CE over fp32 logits, with label smoothing (reference
cross_entropy.py:71-86) and the padded vocabulary columns masked out.  The
vocab-parallel forms and ``fused_linear_cross_entropy`` come with the
parallel slices (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import torch

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


def masked_mean_loss(per_token_loss: torch.Tensor,
                     loss_mask: torch.Tensor) -> torch.Tensor:
    """Loss-mask weighted mean (reference: finetune.py:196-213)."""
    loss_mask = loss_mask.to(per_token_loss.dtype)
    total = torch.sum(per_token_loss * loss_mask)
    return total / torch.clamp(torch.sum(loss_mask), min=1.0)
