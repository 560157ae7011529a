"""NaN/inf and EWMA-z-score loss-spike gating of the train step (mirror of
``megatron_llm_tpu/resilience/anomaly.py``).

The guard is four 0-d tensors on the loss's device: the EWMA of the loss
and of its squared deviation over accepted steps, the count of accepted
steps, and the run of consecutive data anomalies.  A step is anomalous
when its grads are non-finite, its loss is non-finite, or (past warmup,
with ``z_threshold > 0``) its loss exceeds the EWMA baseline by ``z *
max(std, 0.02 |ewma| + 1e-3)``.  The math is the JAX package's, in fp32.
The train step skips an anomalous update bitwise: it reads ``anomalous``
on the host and leaves params and moments untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GuardState(NamedTuple):
    ewma: torch.Tensor   # f32: EWMA of the loss over accepted steps
    emvar: torch.Tensor  # f32: EWMA of squared deviation from the mean
    steps: torch.Tensor  # i32: accepted (non-anomalous) steps observed
    run: torch.Tensor    # i32: consecutive data-anomalous steps


def init_guard_state(device=None) -> GuardState:
    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return GuardState(ewma=zero(torch.float32), emvar=zero(torch.float32),
                      steps=zero(torch.int32), run=zero(torch.int32))


def guard_update(guard: GuardState, loss: torch.Tensor,
                 found_inf: torch.Tensor, *, z_threshold: float,
                 alpha: float, warmup_steps: int):
    """One guard step → ``(new_guard, anomalous, data_anomaly)`` (0-d bool
    tensors): ``anomalous`` gates the whole update, ``data_anomaly`` is
    what the run counter tracks."""
    loss = loss.float()
    bad_loss = ~torch.isfinite(loss)
    if z_threshold > 0:
        warm = guard.steps >= warmup_steps
        std = torch.sqrt(torch.clamp(guard.emvar, min=0.0))
        floor = 0.02 * torch.abs(guard.ewma) + 1e-3
        spike = (warm & ~bad_loss
                 & ((loss - guard.ewma)
                    > z_threshold * torch.maximum(std, floor)))
    else:
        spike = torch.zeros((), dtype=torch.bool, device=loss.device)
    data_anomaly = bad_loss | spike
    anomalous = data_anomaly | found_inf
    accepted = ~anomalous

    first = guard.steps == 0
    safe_loss = torch.where(bad_loss, torch.zeros_like(loss), loss)
    delta = safe_loss - guard.ewma
    new_ewma = torch.where(
        accepted, torch.where(first, safe_loss, guard.ewma + alpha * delta),
        guard.ewma)
    new_emvar = torch.where(
        accepted & ~first,
        (1.0 - alpha) * (guard.emvar + alpha * delta * delta), guard.emvar)
    new_guard = GuardState(
        ewma=new_ewma,
        emvar=new_emvar,
        steps=guard.steps + accepted.to(torch.int32),
        # a scaler-overflow skip holds the run; an accepted step resets it
        run=torch.where(data_anomaly, guard.run + 1,
                        torch.where(accepted, torch.zeros_like(guard.run),
                                    guard.run)),
    )
    return new_guard, anomalous, data_anomaly
