"""The parameter layout: Megatron's column, row and vocab parallel layout as
one spec a parameter (mirror of ``megatron_llm_tpu/models/sharding.py``).

A spec is a tuple with one entry a dimension: None (not split), an axis
name (``"tp"``, ``"dp"``, ``"pp"``) or a tuple of names; the trees equal
the JAX package's ``PartitionSpec`` trees leaf for leaf
(``tuple(P(None, "tp")) == (None, "tp")``):

- a column-parallel weight ``[in, out]``      → ``(None, "tp")``
- a row-parallel weight ``[in, out]``         → ``("tp", None)``
- the vocab-parallel embedding ``[v, h]``     → ``("tp", None)``
- an untied lm head ``[h, v]``                → ``(None, "tp")``
- norms and the biases of row-parallel outputs → replicated

Layer parameters carry the leading layer axis; under pipeline
parallelism the stack is laid ``[vpp, pp, lpc, ...]`` and split over
``pp`` (``parallel/pipeline.pipeline_param_specs``), and a MoE model's
expert leaves ``[L, E, ...]`` split over ``ep``.  ``shard_params`` cuts this rank's blocks
out of a full tree; ``gather_params`` joins them back (checkpoints,
tests).  The spec trees are the single statement of the layout: the step
reads them for its grad reductions (``tp_partial_grads``) and ZeRO-1
(``training/optimizer.zero1_specs``) reads them for the optimizer state.
The serving re-layout (``serving_param_specs``, ``kv_pool_specs``,
``shard_for_serving``) belongs to ROADMAP.md Queue 1 item 11.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig, ParallelConfig
from ..parallel import mappings
from ..utils.tree import tree_leaves_with_path, tree_map

Params = dict

TP = "tp"
PP = "pp"
DP = "dp"
CP = "cp"
EP = "ep"
FSDP = "fsdp"
SP = "sp"


def P(*axes) -> tuple:
    """A spec: the axis (or None) of each dimension."""
    return tuple(axes)


def kv_shard_axes(cfg: ModelConfig, tp_size: int, tp_axes=TP):
    """The axis of the K/V projections: tp where the kv heads divide by
    it, else None (replicated; Falcon-7B's MQA, kv = 1)."""
    return tp_axes if cfg.kv_heads % max(tp_size, 1) == 0 else None


def norm_specs(cfg: ModelConfig, layer_axis: Optional[str] = None) -> Params:
    """One norm's specs (``{scale[, bias]}``), optionally layer-stacked."""
    s = {"scale": P(layer_axis, None) if layer_axis else P(None)}
    if cfg.norm_type == "layernorm":
        s["bias"] = P(layer_axis, None) if layer_axis else P(None)
    return s


def _layer_specs(cfg: ModelConfig, layer_axis: Optional[str],
                 tp_size: int, tp_axes=TP, fsdp_axes=None) -> Params:
    """Specs of the stacked layers (leading dim = the layer axis)."""
    L, T, F = layer_axis, tp_axes, fsdp_axes
    kv_tp = kv_shard_axes(cfg, tp_size, tp_axes)
    attn = {"wq": P(L, F, T), "wk": P(L, F, kv_tp), "wv": P(L, F, kv_tp),
            "wo": P(L, T, F)}
    if cfg.use_bias or cfg.qkv_bias:
        attn["bq"] = P(L, T)
        attn["bk"] = P(L, kv_tp)
        attn["bv"] = P(L, kv_tp)
    if cfg.use_bias:
        attn["bo"] = P(L, None)
    if cfg.num_experts > 0:
        mlp = {"router": P(L, None, None)}
        if cfg.is_glu:
            mlp["w_gate"] = P(L, EP, F, T)
        mlp["w_up"] = P(L, EP, F, T)
        mlp["w_down"] = P(L, EP, T, F)
    else:
        mlp = {}
        if cfg.is_glu:
            mlp["w_gate"] = P(L, F, T)
        mlp["w_up"] = P(L, F, T)
        mlp["w_down"] = P(L, T, F)
        if cfg.use_bias:
            if cfg.is_glu:
                mlp["b_gate"] = P(L, T)
            mlp["b_up"] = P(L, T)
            mlp["b_down"] = P(L, None)

    def norm_spec():
        s = {"scale": P(L, None)}
        if cfg.norm_type == "layernorm":
            s["bias"] = P(L, None)
        return s

    layer = {"input_norm": norm_spec(), "attn": attn, "mlp": mlp}
    if cfg.parallel_attn:
        if cfg.parallel_layernorm:
            layer["mlp_norm"] = norm_spec()
    else:
        layer["post_attn_norm"] = norm_spec()
    return layer


def param_specs(cfg: ModelConfig, parallel: ParallelConfig) -> Params:
    """The spec tree of ``models.model.init_params``' output."""
    layer_axis = PP if parallel.pipeline_parallel > 1 else None
    specs: Params = {
        "embedding": {"word": P(TP, None)},
        "layers": _layer_specs(cfg, layer_axis, parallel.tensor_parallel),
        "final_norm": {"scale": P(None)},
    }
    if cfg.norm_type == "layernorm":
        specs["final_norm"]["bias"] = P(None)
    if cfg.position_embedding_type == "absolute":
        specs["embedding"]["position"] = P(None, None)
    if cfg.tokentype_size:
        specs["embedding"]["tokentype"] = P(None, None)
    if not cfg.tie_embed_logits:
        specs["lm_head"] = P(None, TP)
    return specs


def activation_spec(parallel: ParallelConfig) -> tuple:
    """``[batch, seq, hidden]``: batch over dp, seq over cp."""
    return P(DP, CP, None)


def sequence_parallel_spec(parallel: ParallelConfig) -> tuple:
    """The norm and dropout regions under sequence parallelism: the
    sequence split over tp (reference tensor_parallel/layers.py:225-296)."""
    if parallel.sequence_parallel and parallel.tensor_parallel > 1:
        return P(DP, (CP, TP), None)
    return activation_spec(parallel)


def logits_spec(parallel: ParallelConfig) -> tuple:
    return P(DP, CP, TP)


def is_spec(x) -> bool:
    return isinstance(x, tuple)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def has_axis(spec: tuple, axis: str) -> bool:
    return any(axis in _axes(e) for e in spec)


def _blocks(entry, mesh) -> tuple:
    """``(parts, index)`` of a dimension split over ``entry``'s axes
    (row-major over a tuple of axes)."""
    parts, index = 1, 0
    for a in _axes(entry):
        parts, index = parts * mesh.size(a), index * mesh.size(a) \
            + mesh.index(a)
    return parts, index


def shard_tensor(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` (a contiguous copy)."""
    out = t
    for dim, entry in enumerate(spec):
        parts, index = _blocks(entry, mesh)
        if parts == 1:
            continue
        if out.shape[dim] % parts:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide over {entry} ({parts} parts)")
        size = out.shape[dim] // parts
        out = out.narrow(dim, index * size, size)
    # a copy even where the block is contiguous (a dim-0 split): a view
    # would keep the whole's storage alive
    return t if out is t else out.clone(memory_format=torch.contiguous_format)


def gather_tensor(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from every rank's block (a collective: every rank
    of each axis named in ``spec`` must call it)."""
    out = t
    for dim, entry in reversed(list(enumerate(spec))):
        for a in reversed(_axes(entry)):  # inner axis first
            out = mappings.all_gather(out, mesh.group(a), dim)
    return out


def shard_params(params: Params, specs: Params, mesh) -> Params:
    """This rank's blocks of the full tree ``params`` (JAX
    ``shard_params``: there a ``device_put``, here a slice a leaf)."""
    return tree_map(lambda p, s: shard_tensor(p, s, mesh), params, specs)


def gather_params(params: Params, specs: Params, mesh) -> Params:
    """The full tree from every rank's blocks."""
    return tree_map(lambda p, s: gather_tensor(p, s, mesh), params, specs)


def tp_partial_grads(specs: Params, sequence_parallel: bool) -> Params:
    """True for the leaves whose grad each tp rank holds only in part, so
    the step sums them over tp: under sequence parallelism every leaf the
    specs replicate over tp (norms, row-output biases, learned position
    and tokentype tables, the heads: each rank saw its sequence block),
    and always K/V projections replicated over tp (each rank's query
    heads attend to them; Falcon-7B's MQA)."""
    out: dict = {}
    for path, spec in tree_leaves_with_path(specs):
        replicated = not has_axis(spec, TP)
        kv = path[-1] in ("wk", "wv", "bk", "bv")
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = replicated and (sequence_parallel or kv)
    return out
