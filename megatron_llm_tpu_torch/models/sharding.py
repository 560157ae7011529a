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

The serving re-layout (``serving_param_specs``): heads over tp, the
stacked layer axis over pp (each stage holds a contiguous slab of
layers) and, with ``fsdp > 1``, each weight's non-tp dimension and the
word table's vocabulary over fsdp (residency alone: the model gathers a
leaf whole over the fsdp group just before it is used, ``fsdp_whole``).
The paged pool splits its layer axis over pp and its kv heads over tp
(``kv_pool_specs``); block ids stay global, so the serving engine keeps
one host ledger.  ``shard_for_serving`` cuts this rank's blocks and
builds the mesh; ``serving/cluster/sharded.py`` serves them.
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


def serving_param_specs(cfg: ModelConfig, parallel: ParallelConfig) -> Params:
    """The serving re-layout (JAX ``serving_param_specs``): pp splits the
    stacked LAYER axis, tp the heads (the only head-sharding axis, so
    heads divide tp and layers divide pp independently), fsdp each
    weight's non-tp dimension and the word table's vocabulary along
    ``("tp", "fsdp")``.  At pp = fsdp = 1 it is ``param_specs``."""
    pp = parallel.pipeline_parallel
    fsdp = parallel.fsdp
    if pp == 1 and fsdp == 1:
        return param_specs(cfg, parallel)
    layer_axis = PP if pp > 1 else None
    f = FSDP if fsdp > 1 else None
    embed_axes = (TP, FSDP) if fsdp > 1 else TP
    specs: Params = {
        "embedding": {"word": P(embed_axes, None)},
        "layers": _layer_specs(cfg, layer_axis, parallel.tensor_parallel,
                               fsdp_axes=f),
        "final_norm": {"scale": P(None)},
    }
    if cfg.norm_type == "layernorm":
        specs["final_norm"]["bias"] = P(None)
    if cfg.position_embedding_type == "absolute":
        specs["embedding"]["position"] = P(None, None)
    if cfg.tokentype_size:
        specs["embedding"]["tokentype"] = P(None, None)
    if not cfg.tie_embed_logits:
        specs["lm_head"] = P(f, TP)
    return specs


def assert_serving_geometry(cfg: ModelConfig, parallel: ParallelConfig,
                            what: str = "model") -> None:
    """The serving re-layout's divisibility, one axis at a time (JAX
    ``assert_serving_geometry``; ``ValueError`` where JAX asserts): heads
    divide tp, layers divide pp, hidden and the padded vocabulary divide
    the fsdp split."""
    tp = parallel.tensor_parallel
    pp = parallel.pipeline_parallel
    fsdp = parallel.fsdp
    if cfg.num_attention_heads % max(tp, 1):
        raise ValueError(
            f"serving re-layout shards {what} attention heads over tp = "
            f"{tp}, which must divide num_attention_heads = "
            f"{cfg.num_attention_heads} (pp shards layers, not heads: pick "
            "tp that divides the head count and put the rest of the "
            "submesh on pp/fsdp)")
    if pp > 1 and cfg.num_layers % pp:
        raise ValueError(
            f"serving re-layout shards the {what} layer stack over pp = "
            f"{pp}, which must divide num_layers = {cfg.num_layers} (each "
            "pipeline stage owns a contiguous slab of layers)")
    if fsdp > 1:
        if cfg.hidden_size % fsdp:
            raise ValueError(
                f"fsdp = {fsdp} splits each {what} weight's non-tp dim and "
                f"must divide hidden_size = {cfg.hidden_size}")
        if cfg.padded_vocab_size(tp) % (tp * fsdp):
            raise ValueError(
                f"fsdp = {fsdp} splits the {what} word embedding along "
                f"('tp', 'fsdp') and tp*fsdp = {tp * fsdp} must divide the "
                f"padded vocab {cfg.padded_vocab_size(tp)}")


def serving_specs_of(cfg: ModelConfig, parallel: ParallelConfig,
                     params: Params) -> Params:
    """``serving_param_specs``, mirrored through ``quantize_specs`` where
    ``params`` holds quantized ``{"q", "scale"}`` leaves (int8, int4
    group-wise, the int8 embedding: each scale co-sharded)."""
    from ..ops import quant

    def quantized(tree) -> bool:
        return quant.is_quantized(tree) or (
            isinstance(tree, dict) and any(map(quantized, tree.values())))

    specs = serving_param_specs(cfg, parallel)
    if quantized(params):
        specs = quant.quantize_specs(specs, params)
    return specs


def shard_for_serving(params: Params, cfg: ModelConfig,
                      parallel: ParallelConfig, ranks=None) -> tuple:
    """Build the mesh (over the world, or over the global ``ranks``) and
    cut this rank's blocks of the whole tree ``params`` in the serving
    re-layout → ``(params, mesh)``; ``(None, None)`` on a rank outside
    ``ranks``.  Every rank of the world calls it (the mesh's groups are
    made on all ranks)."""
    from ..parallel import mesh as mesh_lib

    assert_serving_geometry(cfg, parallel)
    mesh = mesh_lib.build_mesh(parallel, ranks=ranks)
    if mesh is None:
        return None, None
    specs = serving_specs_of(cfg, parallel, params)
    return shard_params(params, specs, mesh), mesh


def serving_head_axes(cfg: ModelConfig, mesh):
    """The axes the pool's kv heads split over: ``("tp",)`` where tp > 1
    divides the kv heads, else None (replicated: MQA and GQA pools whose
    kv heads do not divide tp, as ``kv_shard_axes``).  pp splits layers
    and fsdp never touches the pool, so block ids stay global."""
    tp = mesh.size(TP)
    if tp > 1 and cfg.kv_heads % tp == 0:
        return (TP,)
    return None


def kv_pool_specs(cfg: ModelConfig, mesh) -> tuple:
    """``(k_spec, v_spec)`` of the paged pool ``[L, n_blocks, kv, block,
    d]``: the layer axis over pp (where the layers divide it; a shallow
    stack keeps it whole), the heads over ``serving_head_axes``; blocks,
    rows and depth whole, so block ids are global on every rank.  An int8
    pool's ``{"q", "scale"}`` leaves (scale ``[L, n_blocks, kv, block]``)
    split alike."""
    ax = serving_head_axes(cfg, mesh)
    pp = mesh.size(PP)
    L = PP if (pp > 1 and cfg.num_layers % pp == 0) else None
    if cfg.kv_cache_quant == "int8":
        spec = {"q": P(L, None, ax, None, None),
                "scale": P(L, None, ax, None)}
    else:
        spec = P(L, None, ax, None, None)
    return spec, spec


def kv_local_dims(cfg: ModelConfig, mesh) -> tuple:
    """``(layers, kv_heads)`` of this rank's slice of a pool or dense
    cache under ``mesh`` (``kv_pool_specs``); the whole without one."""
    if mesh is None:
        return cfg.num_layers, cfg.kv_heads
    spec, _ = kv_pool_specs(cfg, mesh)
    spec = spec["q"] if isinstance(spec, dict) else spec
    layers, heads = cfg.num_layers, cfg.kv_heads
    if spec[0] is not None:
        layers //= mesh.size(PP)
    if spec[2] is not None:
        heads //= mesh.size(TP)
    return layers, heads


def shard_kv_pool(k_pool, v_pool, cfg: ModelConfig, mesh):
    """This rank's slice of a whole pool (``kv_pool_specs``)."""
    k_spec, v_spec = kv_pool_specs(cfg, mesh)
    return (tree_map(lambda a, s: shard_tensor(a, s, mesh), k_pool, k_spec),
            tree_map(lambda a, s: shard_tensor(a, s, mesh), v_pool, v_spec))


def fsdp_whole(tree, specs, mesh):
    """``tree`` (this rank's blocks) with every leaf whose spec splits a
    dimension over fsdp gathered whole along it over the fsdp group (the
    rest as they are): what a product reads under the residency split.
    The tp split of a dimension split over ``("tp", "fsdp")`` stays."""
    group = None if mesh is None else mesh.group(FSDP)
    if group is None:
        return tree

    def whole(t, spec):
        for dim, entry in enumerate(spec):
            if FSDP in _axes(entry):
                t = mappings.all_gather(t, group, dim)
        return t

    return tree_map(whole, tree, specs)


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
