"""LoRA finetuning: train low-rank adapter factors against a frozen base
(mirror of ``megatron_llm_tpu/training/lora.py``).

Training runs through the SAME epilogue the serving stack applies:
``ops/lora.py:lora_delta`` after each targeted projection in
``models/transformer.py``, with a single-slot arena (Sr = r) and an
all-ones mask, so a trained adapter's math at serve time is the same by
construction.

Only the A/B factor tree is trainable: the base tensors never require
grad, so autograd builds no weight gradient of the base, and there is no
master copy and no moment of it; the optimizer state is O(rank · hidden ·
layers · targets).  Gradients reach the factors through the input
gradients of the frozen stack (K2, K3 and K5 on the card).  B is zero at
init, so step 0 reproduces the base model bitwise.

With ``fused_lm_head`` the loss takes the fused head, as the full
training step does; the JAX step always unembeds (its loss ignores the
flag), which differs from the fused loss by float rounding alone.

Checkpoints are adapter-only (``ops/lora.py:save_adapter``): a directory
that ``AdapterRegistry.register_path`` loads and that either package
reads.  The base checkpoint is never rewritten.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Optional, Sequence

import torch

from ..config import RuntimeConfig
from ..models.transformer import rope_tables
from ..ops import lora as lora_lib
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import optimizer as opt_lib
from .schedule import learning_rate, weight_decay
from .step import compute_loss, to_device_batch

PyTree = Any


def _check_targets(cfg: RuntimeConfig, targets: Sequence[str]) -> None:
    if cfg.parallel.world_size > 1:
        raise NotImplementedError(
            "LoRA training under data or tensor parallelism is not ported "
            "yet (ROADMAP.md, Queue 1 item 9's remainder: the JAX package "
            "has no specs for the adapter)")
    # the serving registry's MoE guard (JAX lora.py:49-54): the expert
    # dispatch routes tokens through per-expert weights the single stacked
    # delta does not model, so MLP targets would train against the wrong
    # math
    if cfg.model.num_experts > 0:
        moe = [t for t in targets if t in ("w_gate", "w_up", "w_down")]
        if moe:
            raise ValueError(
                f"LoRA MLP targets {moe} unsupported with MoE "
                f"(num_experts={cfg.model.num_experts}); use attention "
                "targets only")


def _device_of(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def make_lora_step(cfg: RuntimeConfig, base_params,
                   adapter: lora_lib.LoRAAdapter):
    """``step(factors, opt_state, batch, it) -> (factors, opt_state,
    metrics)``: the masked CE loss grad-accumulated over a ``[accum, micro,
    seq]`` batch (fp32 sums), then the global-norm clip, the schedule's lr
    and wd at ``it``, and AdamW/SGD on the factor tree alone, in place.

    ``scale = α/r`` is folded into B inside the loss (the fold the arena
    install makes), so the factors stay raw and the delta's magnitude is
    serving's."""
    rank = adapter.rank
    scale = torch.tensor(adapter.scale, dtype=torch.float32)
    device = _device_of(base_params)
    rope = rope_tables(cfg.model, device=device)
    ocfg = cfg.optimizer
    train_iters = cfg.train.train_iters

    def loss_fn(factors, mb):
        arenas = {t: {"a": f["a"], "b": f["b"] * scale.to(f["b"].device)}
                  for t, f in factors.items()}
        mask = torch.ones((mb["tokens"].shape[0], rank), dtype=torch.float32,
                          device=mb["tokens"].device)
        return compute_loss(cfg, base_params, mb, rope=rope,
                            lora=(arenas, mask))

    def step(factors, opt_state, batch, it: int):
        accum = batch["tokens"].shape[0]
        leaves = [f.detach().requires_grad_(True)
                  for f in tree_leaves(factors)]
        live = tree_unflatten(factors, leaves)
        gsum = [torch.zeros(f.shape, dtype=torch.float32, device=f.device)
                for f in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(accum):
            loss = loss_fn(live, {k: v[i] for k, v in batch.items()})
            for acc, g in zip(gsum, torch.autograd.grad(loss, leaves)):
                acc.add_(g)
            lsum = lsum + loss.detach()
        grads = tree_unflatten(factors, [g.div_(accum) for g in gsum])
        grads, norm = opt_lib.clip_by_global_norm(grads, ocfg.clip_grad)
        lr = learning_rate(ocfg, it, train_iters)
        wd = weight_decay(ocfg, it, train_iters)
        factors, opt_state = opt_lib.optimizer_step(ocfg, factors, grads,
                                                    opt_state, lr, wd)
        return factors, opt_state, {"loss": lsum / accum,
                                    "grad_norm": norm, "lr": lr}

    return step


def lora_finetune(
    cfg: RuntimeConfig,
    base_params,
    train_dataset,
    *,
    rank: int,
    targets: Optional[Sequence[str]] = None,
    alpha: Optional[float] = None,
    adapter: Optional[lora_lib.LoRAAdapter] = None,
    eod_token: Optional[int] = None,
    save: Optional[str] = None,
) -> lora_lib.LoRAAdapter:
    """Train a LoRA adapter for ``cfg.train.train_iters`` iterations against
    frozen ``base_params`` (on their device); returns (and with ``save``
    writes, at ``<save>/adapter``) the trained adapter.

    ``adapter`` continues an existing adapter (one saved here, or a PEFT
    import through ``tools/hf_interop.lora_from_peft``), copied onto the
    base's device; otherwise a fresh one comes from ``rank`` / ``targets``
    / ``alpha`` with B = 0, its A drawn by a ``torch.Generator`` seeded
    with ``cfg.train.seed``."""
    from .driver import _build_train_iterator, print_rank_0

    cfg.validate()
    device = _device_of(base_params)
    if adapter is None:
        gen = torch.Generator(device=device).manual_seed(cfg.train.seed)
        adapter = lora_lib.init_lora_adapter(cfg.model, gen, rank,
                                             targets=targets, alpha=alpha)
    else:
        lora_lib.validate_adapter(cfg.model, adapter)
    _check_targets(cfg, adapter.targets)

    factors = tree_map(lambda f: f.detach().to(device, torch.float32,
                                               copy=True), adapter.factors)
    opt_state = opt_lib.init_opt_state(factors, cfg.optimizer)
    step = make_lora_step(cfg, base_params, adapter)

    gbs = cfg.train.global_batch_size
    train_iter = _build_train_iterator(cfg, train_dataset, 0, gbs, True,
                                       eod_token)
    n_params = sum(f.numel() for f in tree_leaves(factors))
    print_rank_0(f" lora finetune: rank={adapter.rank} "
                 f"alpha={adapter.alpha} targets={adapter.targets} | "
                 f"{n_params:,} trainable factor params (base frozen)")
    t0 = time.perf_counter()
    window_loss, window_n = 0.0, 0
    for it in range(cfg.train.train_iters):
        try:
            batch = next(train_iter)
        except StopIteration:
            train_iter = _build_train_iterator(
                cfg, train_dataset, (it * gbs) % max(len(train_dataset), 1),
                gbs, True, eod_token)
            batch = next(train_iter)
        factors, opt_state, metrics = step(
            factors, opt_state, to_device_batch(batch, device), it)
        window_loss += float(metrics["loss"])
        window_n += 1
        li = cfg.train.log_interval
        if li and (it + 1) % li == 0:
            dt = time.perf_counter() - t0
            print_rank_0(
                f" lora iteration {it + 1:8d}/{cfg.train.train_iters:8d} |"
                f" lm loss: {window_loss / max(window_n, 1):.6E} |"
                f" learning rate: {float(metrics['lr']):.3E} |"
                f" grad norm: {float(metrics['grad_norm']):.3f} |"
                f" elapsed time per iteration (ms): "
                f"{dt * 1000.0 / max(window_n, 1):.1f} |")
            window_loss, window_n = 0.0, 0
            t0 = time.perf_counter()

    trained = dataclasses.replace(adapter, factors=factors)
    if save:
        path = os.path.join(save, "adapter")
        lora_lib.save_adapter(path, trained)
        print_rank_0(f" saved adapter-only checkpoint to {path}")
    return trained
