"""LoRA factors and the stacked multi-adapter arena (mirror of
``megatron_llm_tpu/ops/lora.py``).

A target projection ``W [in, out]`` gains a rank-``r`` update ``ΔW = A·B ·
α/r`` with ``A [in, r]`` and ``B [r, out]`` (B zero at init, so a fresh
adapter changes nothing).  Factors are stacked on the leading layer axis,
as the model's parameters are, and kept fp32 whatever the base precision.

Serving multiplexes adapters the punica / S-LoRA way: ``n_slots``
resident adapters are concatenated along the rank axis into one arena per
target, ``A [L, in, n_slots·r]`` / ``B [L, n_slots·r, out]``, and a per-row
one-hot ``slot_mask`` keeps only the row's own adapter's columns between
the two products::

    y += ((x · A) ⊙ mask_row) · B

A masked-out column contributes an exact ±0, so a request's numbers do not
depend on which adapters share its batch; slot ``-1`` selects no column
(the base model).  ``α/r`` is folded into B's rows at install, so the hot
path carries no scale.

Residency (LRU with ref pinning) is ``serving/adapters/registry.py``; this
module is the math and the adapter checkpoint format (``adapter.npz`` with
``{target}.{a|b}`` arrays plus ``adapter_config.json``), the JAX package's
format, so an adapter saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# Adapter-targetable projections, in the order the fused decode kernel
# applies them: wq/wk/wv/wo under ["attn"], w_gate/w_up/w_down under ["mlp"].
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# PEFT-style default: attention q/v only.
DEFAULT_TARGETS = ("wq", "wv")

_ADAPTER_CONFIG = "adapter_config.json"
_ADAPTER_WEIGHTS = "adapter.npz"


def lora_target_shapes(cfg) -> Dict[str, Tuple[int, int]]:
    """target -> (in_dim, out_dim) of the base projection it adapts."""
    h, d = cfg.hidden_size, cfg.head_dim
    nq, nkv, ffn = cfg.num_attention_heads, cfg.kv_heads, cfg.ffn_size
    shapes = {"wq": (h, nq * d), "wk": (h, nkv * d), "wv": (h, nkv * d),
              "wo": (nq * d, h), "w_up": (h, ffn), "w_down": (ffn, h)}
    if cfg.is_glu:
        shapes["w_gate"] = (h, ffn)
    return shapes


@dataclasses.dataclass
class LoRAAdapter:
    """One adapter: ``factors[target] = {"a": [L, in, r], "b": [L, r,
    out]}`` fp32 tensors and its hyperparameters."""

    rank: int
    alpha: float
    targets: Tuple[str, ...]
    factors: Dict[str, Dict[str, torch.Tensor]]

    @property
    def scale(self) -> float:
        return float(self.alpha) / float(self.rank)

    @property
    def nbytes(self) -> int:
        return sum(int(t.numel() * t.element_size())
                   for f in self.factors.values() for t in f.values())


def init_lora_adapter(cfg, generator: torch.Generator, rank: int,
                      targets: Optional[Sequence[str]] = None,
                      alpha: Optional[float] = None,
                      device=None) -> LoRAAdapter:
    """A fresh adapter: A ~ N(0, 1/in), B = 0, so ΔW is exactly zero.  The
    draws come from ``generator`` (on ``device``), target by target in
    ``targets`` order."""
    targets = tuple(targets) if targets is not None else DEFAULT_TARGETS
    shapes = lora_target_shapes(cfg)
    unknown = [t for t in targets if t not in shapes]
    if unknown:
        raise ValueError(f"unknown LoRA targets {unknown}; "
                         f"choose from {sorted(shapes)}")
    L = cfg.num_layers
    device = generator.device if device is None else torch.device(device)
    factors = {}
    for t in targets:
        fin, fout = shapes[t]
        a = torch.randn((L, fin, rank), generator=generator, device=device,
                        dtype=torch.float32) / float(np.sqrt(np.float32(fin)))
        factors[t] = {"a": a, "b": torch.zeros((L, rank, fout),
                                               dtype=torch.float32,
                                               device=device)}
    return LoRAAdapter(rank=int(rank),
                       alpha=float(alpha if alpha is not None else rank),
                       targets=targets, factors=factors)


def validate_adapter(cfg, adapter: LoRAAdapter) -> None:
    """Shape-check an adapter against a model config."""
    shapes = lora_target_shapes(cfg)
    L, r = cfg.num_layers, adapter.rank
    for t in adapter.targets:
        if t not in shapes:
            raise ValueError(f"adapter targets unknown projection {t!r}")
        fin, fout = shapes[t]
        a, b = adapter.factors[t]["a"], adapter.factors[t]["b"]
        if tuple(a.shape) != (L, fin, r):
            raise ValueError(
                f"adapter {t}.a shape {tuple(a.shape)} != {(L, fin, r)}")
        if tuple(b.shape) != (L, r, fout):
            raise ValueError(
                f"adapter {t}.b shape {tuple(b.shape)} != {(L, r, fout)}")


# ---------------------------------------------------------------------------
# The multi-adapter arena and the grouped epilogue
# ---------------------------------------------------------------------------


def make_arenas(cfg, n_slots: int, rank: int, targets: Sequence[str],
                device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zeroed fp32 arenas on ``device``: target -> {"a": [L, in,
    n_slots·r], "b": [L, n_slots·r, out]}.  Zero columns make an
    uninstalled slot an exact no-op."""
    shapes = lora_target_shapes(cfg)
    L, sr = cfg.num_layers, n_slots * rank
    kw = dict(dtype=torch.float32, device=device)
    return {t: {"a": torch.zeros((L, shapes[t][0], sr), **kw),
                "b": torch.zeros((L, sr, shapes[t][1]), **kw)}
            for t in targets}


def arena_sr(arenas) -> int:
    """Total stacked rank (n_slots·r) of an arena dict; 0 when empty."""
    if not arenas:
        return 0
    return int(next(iter(arenas.values()))["a"].shape[-1])


def slot_mask(slots: torch.Tensor, n_slots: int, rank: int) -> torch.Tensor:
    """fp32 ``[b, n_slots·rank]``: ones on the ``rank`` columns of each
    row's slot, zeros elsewhere; slot ``-1`` selects nothing.  Built on
    the slot vector's device."""
    slots = torch.as_tensor(slots)
    col_slot = torch.arange(n_slots * rank, device=slots.device) // rank
    return (slots.to(torch.long)[:, None] == col_slot[None, :]).float()


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """``((x·A) ⊙ mask)·B`` in fp32 for one projection (α/r already in B):
    ``x [rows, ..., in]`` cast to fp32 first, ``a [in, Sr]``, ``b [Sr,
    out]``, ``mask [rows, Sr]`` broadcast over x's middle axes."""
    xa = x.float() @ a
    while mask.dim() < xa.dim():
        mask = mask[:, None]
    return (xa * mask) @ b


def install_adapter(arenas, factors, slot: int, scale: float,
                    rank: int) -> None:
    """Write one adapter's columns into the arena at ``slot``, in place
    (slice assignment into the resident tensors, no reallocation), with
    ``scale = α/r`` folded into B's rows; a target the adapter lacks gets
    its slot columns zeroed, so nothing of the slot's last tenant leaks."""
    c0, c1 = slot * rank, (slot + 1) * rank
    for t, arena in arenas.items():
        if t in factors:
            a_cols = factors[t]["a"].to(device=arena["a"].device,
                                        dtype=torch.float32)
            b_rows = factors[t]["b"].to(device=arena["b"].device,
                                        dtype=torch.float32) \
                * torch.tensor(scale, dtype=torch.float32)
            arena["a"][:, :, c0:c1] = a_cols
            arena["b"][:, c0:c1, :] = b_rows
        else:
            arena["a"][:, :, c0:c1] = 0.0
            arena["b"][:, c0:c1, :] = 0.0


def merge_adapter(params, adapter: LoRAAdapter):
    """Fold ``ΔW = A·B·α/r`` into the base weights (the single-tenant
    deployment): a new params dict, base dtypes kept.  A quantized base
    leaf is refused: merge before ``quantize_params``."""
    layers = dict(params["layers"])
    groups = {"attn": dict(layers["attn"]), "mlp": dict(layers["mlp"])}
    for t, f in adapter.factors.items():
        gname = "attn" if t in ("wq", "wk", "wv", "wo") else "mlp"
        w = groups[gname][t]
        if not isinstance(w, torch.Tensor):
            raise ValueError(
                f"cannot merge adapter into quantized base leaf {t!r}; "
                "merge before quantize_params")
        delta = torch.einsum("lir,lro->lio", f["a"].float(),
                             f["b"].float()) * adapter.scale
        groups[gname][t] = (w.float() + delta.to(w.device)).to(w.dtype)
    layers.update(groups)
    return {**params, "layers": layers}


# ---------------------------------------------------------------------------
# The adapter checkpoint format
# ---------------------------------------------------------------------------


def save_adapter(path: str, adapter: LoRAAdapter) -> None:
    """Write ``adapter.npz`` (flat ``{target}.{a|b}`` fp32 arrays) and
    ``adapter_config.json`` under ``path``."""
    os.makedirs(path, exist_ok=True)
    flat = {}
    for t, f in adapter.factors.items():
        flat[f"{t}.a"] = f["a"].detach().float().cpu().numpy()
        flat[f"{t}.b"] = f["b"].detach().float().cpu().numpy()
    np.savez(os.path.join(path, _ADAPTER_WEIGHTS), **flat)
    with open(os.path.join(path, _ADAPTER_CONFIG), "w") as fh:
        json.dump({"rank": adapter.rank, "alpha": adapter.alpha,
                   "targets": list(adapter.targets)}, fh, indent=2)


def load_adapter(path: str, device="cpu") -> LoRAAdapter:
    """Load an adapter written by ``save_adapter`` (either package's)."""
    with open(os.path.join(path, _ADAPTER_CONFIG)) as fh:
        meta = json.load(fh)
    data = np.load(os.path.join(path, _ADAPTER_WEIGHTS))
    factors = {t: {k: torch.from_numpy(np.array(data[f"{t}.{k}"],
                                                np.float32)).to(device)
                   for k in ("a", "b")}
               for t in meta["targets"]}
    return LoRAAdapter(rank=int(meta["rank"]), alpha=float(meta["alpha"]),
                       targets=tuple(meta["targets"]), factors=factors)
