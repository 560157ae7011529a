"""Causal language model: embedding → decoder stack → lm head (mirror of
``megatron_llm_tpu/models/model.py``).  ``forward`` serves inference and
training (differentiable through the kernels' autograd Functions; with a
``DropoutKey`` it applies embedding, hidden and attention dropout as the
JAX forward does with an rng);
``forward_cached`` / ``forward_cached_paged`` and the KV-cache and paged
block-pool helpers are what the serving engine drives; ``flops_per_token``
is the analytic count the training log reports against.

Cache layouts are the JAX package's: dense ``[L, b, kv_heads, max_len, d]``
and pool ``[L, n_blocks, kv_heads, block, d]`` (block 0 = trash), or with
``kv_cache_quant="int8"`` each side the ``{"q": int8 [.., d], "scale":
fp32 [..]}`` pair of ``ops/kv_quant.py`` (the scale leaf lacks the ``d``
axis); every cache helper maps over both leaves.  Where
the JAX functions return updated arrays, these update the caches IN
PLACE and return them, which saves a full cache copy per call; callers
that need the old contents pass a copy.

Under a current mesh with tp > 1 (``parallel/mesh.use_mesh``) the params
are this rank's shards (``models/sharding.py``): the word table is split
over the vocabulary (``embed`` looks up the ids this rank owns, zeros the
rest and sums over tp: an all-reduce, or under sequence parallelism a
reduce-scatter to the rank's sequence block, where the learned position
and tokentype rows of that block are added), and the lm head is
column-parallel, so ``forward`` returns this rank's vocabulary block of
the logits (``parallel/cross_entropy.vocab_parallel_cross_entropy`` takes
them).  ``init_params(..., tp=)`` pads the vocabulary for the split.
The cached forwards serve under the serving re-layout
(``models/sharding.serving_param_specs``): they gather the logits over
tp, so sampling sees the whole padded vocabulary; under pp every stage
embeds and the stack runs stage to stage (``stack_forward_cached``);
under fsdp the word table and the lm head are gathered whole over the
fsdp group where they are read.  The caches and pools they take are this
rank's slices (``sharding.kv_pool_specs``; ``init_kv_cache`` and
``init_kv_pool`` allocate them under the current mesh), and the fused
whole-stack kernels decline a mesh that splits the stack
(``kernels/decode_step.mesh_shards_stack``).

The cached forwards take ``lora=(arenas, mask)``, the multi-tenant LoRA
bundle of ``ops/lora.py``: layer-stacked arenas and a per-row mask ``[b,
Sr]`` (a verify window's mask is per slot).  The fused routes carry it
into the kernels' epilogue, the composed routes into every layer.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelConfig, PositionEmbeddingType
from ..ops import dropout as drop
from ..kernels.decode_step import (
    fused_decode_eligible,
    fused_decode_step,
    fused_decode_step_paged,
    fused_decode_verify_paged,
)
from ..ops.kv_quant import cache_update, init_quantized_cache, \
    is_quantized_cache, quantize_rows
from ..ops.lora import arena_sr
from ..ops.norms import norm_apply, norm_init
from ..ops.quant import embedding_lookup, is_quantized
from ..parallel import mappings
from ..parallel.mesh import current_mesh
from . import sharding
from .sharding import FSDP, TP
from .transformer import (
    AttnSideInputs,
    Params,
    init_stack_params,
    rope_tables,
    seq_slices,
    stack_forward,
    stack_forward_cached,
    tp_layout,
)


def default_device(device=None) -> torch.device:
    """The port runs on the card unless the caller asks for another
    device (the tests pass ``"cpu"``)."""
    return torch.device("cuda" if device is None else device)


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                tp: int = 1, place=None) -> Params:
    """Random parameters with the JAX package's distributions (normal, std
    ``init_method_std``; output layers scaled by ``1/sqrt(2 L)``; norms 1),
    drawn on ``device`` (default ``cuda``) from a ``torch.Generator``
    seeded with ``seed``.  The numbers differ from ``jax.random``'s; tests
    that compare with JAX copy JAX's weights with ``params_from_jax``.
    On the ``meta`` device it costs nothing and gives the shapes and dtypes
    alone (the checkpoint loader's template).

    ``place(path, t)`` takes each drawn matrix (``path`` its keys in the
    tree) as soon as it is drawn and returns what the tree keeps: a
    sharded run keeps its block, so one whole matrix is alive at a time.
    The draws do not change; the norms are left to the caller."""
    device = default_device(device)
    keep = (lambda path, t: t) if place is None else place
    gen = None
    if device.type != "meta":  # meta tensors draw nothing
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    h, dtype, std = cfg.hidden_size, cfg.dtype, cfg.init_method_std
    v = cfg.padded_vocab_size(tp)

    def normal(shape):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return (std * torch.randn(shape, generator=gen, device=device,
                                  dtype=torch.float32)).to(dtype)

    params: Params = {
        "embedding": {"word": keep(("embedding", "word"), normal((v, h)))},
        "layers": init_stack_params(
            cfg, gen, device,
            place=place and (lambda path, t: place(("layers",) + path, t))),
        "final_norm": norm_init(cfg.norm_type, h, dtype, device),
    }
    if cfg.position_embedding_type == PositionEmbeddingType.ABSOLUTE:
        params["embedding"]["position"] = keep(
            ("embedding", "position"),
            normal((cfg.max_position_embeddings, h)))
    if cfg.tokentype_size:
        params["embedding"]["tokentype"] = keep(
            ("embedding", "tokentype"), normal((cfg.tokentype_size, h)))
    if not cfg.tie_embed_logits:
        params["lm_head"] = keep(("lm_head",), normal((h, v)))
    return params


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
          position_ids: Optional[torch.Tensor] = None,
          tokentype_ids: Optional[torch.Tensor] = None,
          dropout_key=None) -> torch.Tensor:
    """Token (+ learned position, + tokentype) embedding, then embedding
    dropout with ``dropout_key`` (JAX ``model.py:77-93``).  The word table
    may be the per-row int8 form of ``ops/quant.quantize_embedding``: the
    lookup dequantizes only the gathered rows.  Under tp the word table
    is this rank's vocabulary block (``vocab_parallel_embed``)."""
    group, tp, rank, sp = tp_layout(cfg)
    word = _fsdp_word(cfg, params)
    if tp > 1:
        x = vocab_parallel_embed(word, tokens, group, rank,
                                 sp).to(cfg.dtype)
    else:
        x = embedding_lookup(word, tokens).to(cfg.dtype)
    if "position" in params["embedding"]:
        if position_ids is None:
            position_ids = torch.arange(tokens.shape[1],
                                        device=tokens.device)[None, :]
        x = x + params["embedding"]["position"][
            _seq_block(position_ids, x, sp, rank)]
    if tokentype_ids is not None and "tokentype" in params["embedding"]:
        x = x + params["embedding"]["tokentype"][
            _seq_block(tokentype_ids, x, sp, rank)]
    return drop.dropout(x, cfg.hidden_dropout, dropout_key,
                        seq_slices(cfg, x))


def _seq_block(ids: torch.Tensor, x: torch.Tensor, sp: bool, rank: int):
    """``ids [b, s]`` cut to the sequence block of ``x`` under sequence
    parallelism."""
    if not sp:
        return ids
    n = x.shape[1]
    return ids[:, rank * n:(rank + 1) * n]


def vocab_parallel_embed(word: torch.Tensor, tokens: torch.Tensor, group,
                         rank: int, sequence_parallel: bool) -> torch.Tensor:
    """The vocab-parallel lookup (reference VocabParallelEmbedding,
    tensor_parallel/layers.py:128-220): ``word`` holds rows ``[rank * v,
    (rank + 1) * v)``; ids outside it look up row 0 and are zeroed, and
    the partial rows are summed over tp (all-reduced, or reduce-scattered
    to this rank's sequence block).  One term of each sum is non-zero, so
    the result is the one-device lookup exactly."""
    v = (word["q"] if is_quantized(word) else word).shape[0]
    local = tokens - rank * v
    outside = (local < 0) | (local >= v)
    x = embedding_lookup(word, local.clamp(0, v - 1)).masked_fill(
        outside[..., None], 0)
    if sequence_parallel:
        return mappings.reduce_scatter_to_sequence_region(x, group)
    return mappings.reduce_from_tensor_region(x, group)


def _fsdp_word(cfg: ModelConfig, params: Params):
    """The word table as a product reads it: this rank's tp block, gathered
    over fsdp where the serving re-layout splits it there."""
    word = params["embedding"]["word"]
    mesh = current_mesh()
    if mesh is None or mesh.size(FSDP) == 1:
        return word
    spec = (TP, FSDP), None
    if is_quantized(word):
        spec = {"q": spec, "scale": spec[:1]}
    return sharding.fsdp_whole(word, spec, mesh)


def unembed_weight(cfg: ModelConfig, params: Params) -> torch.Tensor:
    if cfg.tie_embed_logits:
        return _fsdp_word(cfg, params).T
    head = params["lm_head"]
    mesh = current_mesh()
    if mesh is not None and mesh.size(FSDP) > 1:
        head = sharding.fsdp_whole(head, (FSDP, TP), mesh)
    return head


def unembed(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The lm head; under tp a column-parallel product (the sequence
    gathered first under sequence parallelism) giving this rank's
    vocabulary block of the logits."""
    group, tp, _, sp = tp_layout(cfg)
    if tp > 1:
        x = mappings.column_input(x, group, sp)
    return x @ unembed_weight(cfg, params)


def _rope(cfg, params, rope):
    if rope is not None:
        return rope
    return rope_tables(cfg, device=params["final_norm"]["scale"].device)


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   *, position_ids: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   tokentype_ids: Optional[torch.Tensor] = None,
                   rng: Optional[drop.DropoutKey] = None,
                   rope: Optional[tuple] = None, lora=None):
    """Forward through the final norm → ``(hidden [b, s, h], moe_aux)``,
    the aux the MoE stats summed over the layers (``models/moe.py``), a 0
    scalar for a dense model.  The split
    before the unembedding lets the training loss take the fused head
    (``parallel/cross_entropy.fused_linear_cross_entropy``).

    Dropout is on exactly when ``rng`` is given (JAX's ``deterministic =
    rng is None``): the key splits into the embedding's and the stack's,
    as JAX ``model.py:137-144`` does.  ``lora`` is ``(arenas, mask)``:
    layer-stacked LoRA factors and the per-row column mask
    (``ops/lora.py``), applied as projection epilogues down the stack;
    None means the base weights alone."""
    cos, sin = _rope(cfg, params, rope)
    embed_key = stack_key = None
    if rng is not None:
        embed_key, stack_key = drop.split(rng)
    x = embed(cfg, params, tokens, position_ids, tokentype_ids, embed_key)
    side = AttnSideInputs(rope_cos=cos, rope_sin=sin,
                          position_ids=position_ids, segment_ids=segment_ids)
    x, aux = stack_forward(cfg, params["layers"], x, side, stack_key,
                           lora=lora, return_aux=True)
    x = norm_apply(cfg.norm_type, x, params["final_norm"], cfg.norm_eps,
                   impl=cfg.norm_impl)
    return x, aux


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor, *,
            position_ids: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            tokentype_ids: Optional[torch.Tensor] = None,
            rng: Optional[drop.DropoutKey] = None,
            rope: Optional[tuple] = None, return_aux: bool = False,
            lora=None):
    """Full forward to logits ``[b, s, padded_vocab]`` (fp32), built on
    ``forward_hidden``; with ``return_aux`` also the MoE aux loss."""
    x, aux = forward_hidden(cfg, params, tokens, position_ids=position_ids,
                            segment_ids=segment_ids,
                            tokentype_ids=tokentype_ids, rng=rng, rope=rope,
                            lora=lora)
    logits = unembed(cfg, params, x).float()
    if return_aux:
        return logits, aux
    return logits


def forward_cached(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   k_cache, v_cache, cache_len,
                   *, rope: Optional[tuple] = None, empty_cache: bool = False,
                   last_logit_only: bool = False,
                   logit_rows: Optional[torch.Tensor] = None, lora=None,
                   position_ids: Optional[torch.Tensor] = None):
    """Incremental forward: consume ``tokens`` [b, s] at positions
    ``cache_len .. cache_len + s`` (``cache_len`` an int or a [b] tensor of
    per-row fills), write their K/V into the caches in place, and return
    ``(logits [b, s or 1, vocab] fp32, k_cache, v_cache)``.

    ``empty_cache=True`` promises ``cache_len == 0``: attention is then
    plain causal attention over the window (the flash kernel under
    ``attention_impl="flash"``).  ``logit_rows`` [b] unembeds one row per
    batch row; ``last_logit_only`` the last.

    One new token per row (``s == 1``) of a stack that
    ``kernels/decode_step.fused_decode_eligible`` accepts takes the fused
    whole-stack route (K12: one launch for every layer on the card, its
    plain version on the CPU), whose new rows are then written with
    ``cache_update`` (an int8 cache requantizes the kernel's
    fake-quantized rows to the same codes).  Everything else takes the
    composed per-layer path.  ``lora`` (``(arenas, mask)``) rides both
    routes: the kernel's epilogue, or each layer's ``_lora_add``.

    ``position_ids`` [b, s] embeds and rotates the tokens at other
    positions than the cache columns they are written to (a speculative
    verify's frozen rows clamp theirs to the tables, as XLA's gather
    clamps; the fused route rotates at ``cache_len`` clamped to the
    table, so there they may differ only by that clamp)."""
    cos, sin = _rope(cfg, params, rope)
    b, s = tokens.shape
    offs = torch.arange(s, device=tokens.device, dtype=torch.long)
    if not isinstance(cache_len, int):
        cache_len = torch.as_tensor(cache_len, device=tokens.device)
    if position_ids is not None:
        position_ids = torch.as_tensor(position_ids, device=tokens.device)
    elif isinstance(cache_len, int):
        position_ids = (cache_len + offs)[None, :].expand(b, s)
    else:
        position_ids = (cache_len.to(torch.long).reshape(-1, 1)
                        + offs[None, :]).expand(b, s)
    x = embed(cfg, params, tokens, position_ids)
    lora_sr = arena_sr(lora[0]) if lora is not None else 0
    if fused_decode_eligible(cfg, params, k_cache, s, lora_sr,
                             mesh=current_mesh()):
        hidden, k_rows, v_rows = fused_decode_step(
            cfg, params["layers"], x[:, 0], k_cache, v_cache, cache_len,
            (cos, sin), lora=lora)
        x = hidden[:, None, :]
        cache_update(k_cache, k_rows, cache_len)
        cache_update(v_cache, v_rows, cache_len)
    else:
        side = AttnSideInputs(rope_cos=cos, rope_sin=sin,
                              position_ids=position_ids,
                              cache_is_empty=empty_cache)
        x, k_cache, v_cache = stack_forward_cached(
            cfg, params["layers"], x, side, k_cache, v_cache, cache_len,
            lora=lora)
    if last_logit_only:
        x = x[:, -1:]
    elif logit_rows is not None:
        rows = torch.as_tensor(logit_rows, device=x.device).to(torch.long)
        x = torch.gather(x, 1, rows.reshape(b, 1, 1).expand(b, 1, x.shape[2]))
    return _logits(cfg, params, x), k_cache, v_cache


def forward_cached_paged(cfg: ModelConfig, params: Params,
                         tokens: torch.Tensor,   # [b, 1] pending tokens
                         k_pool,   # [L, n_blocks, kv, blk, d] or int8 dict
                         v_pool,
                         tables: torch.Tensor,   # [b, T] int block tables
                         fills: torch.Tensor,    # [b] fill levels
                         *, rope: Optional[tuple] = None,
                         use_fused: bool = False, lora=None):
    """Single-token decode over the paged pool: each slot's token attends
    the blocks its table names and its new K/V row lands in block
    ``tables[s, fill // blk]`` at offset ``fill % blk``.  Two routes, one
    contract (the JAX package's):

    * ``use_fused=True``: the whole-stack kernel reads the pool through
      the tables (K13), no dense view is built; an int8 pool's rows are
      requantized with ``quantize_rows`` before the append;
    * ``use_fused=False``: gather the tables into a dense working view,
      run ``forward_cached`` over it (per layer on the card the
      flash-decode kernel, K9 over an int8 pool) and scatter the new rows
      back.

    Returns ``(logits [b, 1, vocab] fp32, k_pool, v_pool)``; the pools are
    updated in place.  ``lora`` (``(arenas, [b, Sr] mask)``) rides either
    route."""
    cos, sin = _rope(cfg, params, rope)
    fills = torch.as_tensor(fills, device=tokens.device).to(torch.long)
    tables = torch.as_tensor(tables, device=tokens.device).to(torch.long)
    bk = _leaf(k_pool).shape[3]
    bids = torch.gather(tables, 1, (fills // bk)[:, None])[:, 0]
    offs = fills % bk
    if use_fused:
        x = embed(cfg, params, tokens, fills[:, None])
        hidden, k_rows, v_rows = fused_decode_step_paged(
            cfg, params["layers"], x[:, 0], k_pool, v_pool, tables, fills,
            (cos, sin), lora=lora)
        _append_fused_rows(k_pool, v_pool, k_rows, v_rows, bids, offs)
        return _logits(cfg, params, hidden[:, None, :]), k_pool, v_pool
    k_dense = cache_gather_blocks(k_pool, tables)
    v_dense = cache_gather_blocks(v_pool, tables)
    logits, k_dense, v_dense = forward_cached(
        cfg, params, tokens, k_dense, v_dense, fills, rope=(cos, sin),
        lora=lora)
    cache_append_rows(k_pool, cache_rows_at(k_dense, fills), bids, offs)
    cache_append_rows(v_pool, cache_rows_at(v_dense, fills), bids, offs)
    return logits, k_pool, v_pool


def _append_fused_rows(k_pool, v_pool, k_rows, v_rows, bids, offs) -> None:
    """Scatter a fused kernel's new rows into the pools: an int8 pool takes
    them through ``quantize_rows`` (they are already fake-quantized, so
    the codes are the ones the kernel attended)."""
    if is_quantized_cache(k_pool):
        k_rows, v_rows = quantize_rows(k_rows), quantize_rows(v_rows)
    cache_append_rows(k_pool, k_rows, bids, offs)
    cache_append_rows(v_pool, v_rows, bids, offs)


def _logits(cfg: ModelConfig, params: Params, hidden: torch.Tensor):
    """The final norm and the lm head → fp32 logits over the whole padded
    vocabulary (under tp each rank's block, gathered over tp)."""
    x = norm_apply(cfg.norm_type, hidden, params["final_norm"], cfg.norm_eps,
                   impl=cfg.norm_impl)
    group, tp, _, _ = tp_layout(cfg)
    logits = unembed(cfg, params, x).float()
    if tp > 1:
        logits = mappings.all_gather(logits, group, -1)
    return logits


def forward_cached_paged_verify(cfg: ModelConfig, params: Params,
                                window: torch.Tensor,  # [S, W] tokens
                                k_pool, v_pool,
                                tables: torch.Tensor,  # [S, T]
                                fills: torch.Tensor,   # [S]
                                bids: torch.Tensor,    # [S*W] dest blocks
                                offs: torch.Tensor,    # [S*W] dest offsets
                                *, rope: Optional[tuple] = None,
                                use_fused: bool = False, tree=None,
                                lora=None):
    """Speculative verify over the paged pool: row s of ``window`` holds
    ``[pending, draft_1 .. draft_{W-1}]`` at positions ``fills[s] ..
    fills[s] + W - 1``.  Returns logits for every window position ``[S,
    W, vocab]`` fp32 and appends the window's K/V rows at ``(bids,
    offs)`` (row ``s*W + j``); the caller rolls back by not advancing a
    slot's fill past its accepted prefix.  Each position equals the
    corresponding sequential single-token step:

    * ``use_fused=True``: one K14 launch splices the in-flight window
      rows over the columns the sequential steps would have written;
    * ``use_fused=False``: W ``forward_cached`` steps over one gathered
      dense view (not padded: the caller keeps the window inside the
      tables).

    ``tree = (depths [S, W], anc [S, W, W])`` makes the window a candidate
    tree (the resident draft model's): column j is a node at depth
    ``depths[s, j]`` whose ancestor at depth ``dd`` is node ``anc[s, j,
    dd]``, in breadth-first order (the root, the pending token, first).
    Node j runs at ``fills[s] + depths[s, j]`` and sees the slot's cache
    plus its own root path, so each node's logits are those of sequential
    steps down that path; its K/V row lands at ``(bids, offs)`` row ``s*W
    + j`` (node-indexed), and the caller compacts the accepted path with
    ``cache_move_rows``.  The fused arm is K14's tree mode; the composed
    arm walks the nodes over one gathered view, overlaying each node's
    ancestors' rows at ``fills + dd`` before its single-token step (JAX's
    walk; every index stays inside the view, where XLA would clamp).

    ``lora = (arenas, [S, Sr] mask)``: every window row, the pending token
    and each draft, runs under its slot's adapter (K14 repeats the mask
    over the window; the composed steps take it per slot)."""
    cos, sin = _rope(cfg, params, rope)
    S, W = window.shape
    fills = torch.as_tensor(fills, device=window.device).to(torch.long)
    tables = torch.as_tensor(tables, device=window.device).to(torch.long)
    bids = torch.as_tensor(bids, device=window.device).reshape(S * W)
    offs = torch.as_tensor(offs, device=window.device).reshape(S * W)
    depths = anc = None
    if tree is not None:
        depths = torch.as_tensor(tree[0], device=window.device).to(torch.long)
        anc = torch.as_tensor(tree[1], device=window.device).to(torch.long)
    if use_fused:
        off = (torch.arange(W, device=window.device)[None, :]
               if depths is None else depths)
        x = embed(cfg, params, window, fills[:, None] + off)
        hidden, k_rows, v_rows = fused_decode_verify_paged(
            cfg, params["layers"], x, k_pool, v_pool, tables, fills,
            (cos, sin), depths=depths, anc=anc, lora=lora)
        _append_fused_rows(k_pool, v_pool, k_rows, v_rows, bids, offs)
        return _logits(cfg, params, hidden), k_pool, v_pool
    k_dense = cache_gather_blocks(k_pool, tables)
    v_dense = cache_gather_blocks(v_pool, tables)
    if tree is not None:
        return _verify_tree_composed(cfg, params, window, k_pool, v_pool,
                                     k_dense, v_dense, fills, bids, offs,
                                     depths, anc, (cos, sin), lora)
    steps = []
    for j in range(W):
        lj, k_dense, v_dense = forward_cached(
            cfg, params, window[:, j:j + 1], k_dense, v_dense, fills + j,
            rope=(cos, sin), lora=lora)
        steps.append(lj)
    cache_append_rows(k_pool, cache_rows_range(k_dense, fills, W), bids, offs)
    cache_append_rows(v_pool, cache_rows_range(v_dense, fills, W), bids, offs)
    return torch.cat(steps, dim=1), k_pool, v_pool


def _verify_tree_composed(cfg, params, window, k_pool, v_pool, k_dense,
                          v_dense, fills, bids, offs, depths, anc, rope,
                          lora=None):
    """The composed tree arm of ``forward_cached_paged_verify``: before
    node j's single-token step at ``fills + depths[:, j]``, each slot's
    ancestors' stored rows (kept node-indexed, in the cache's own leaves,
    so int8 codes move verbatim) are overlaid at dense columns ``fills +
    dd``; columns past the node's position are masked by the step, so a
    sibling path's rows there are invisible."""
    S, W = window.shape
    ar = torch.arange(S, device=window.device)

    def overlay(dense, nodes, j):
        dj = depths[:, j]
        for dd in range(j):
            live = ar[dd < dj]
            if live.numel() == 0:
                continue
            src = anc[live, j, dd]
            cols = fills[live] + dd

            def put(dn, nd):
                # nd [L, S, kv, W(, d)] node rows → dense column per slot
                dn[:, live, :, cols] = nd[:, live, :, src].to(dn.dtype)

            _leafwise(put, dense, nodes)

    def new_nodes(dense):
        return _leafwise(lambda a: a.new_zeros(a.shape[:3] + (W,)
                                               + a.shape[4:]), dense)

    k_nodes, v_nodes = new_nodes(k_dense), new_nodes(v_dense)
    steps = []
    for j in range(W):
        overlay(k_dense, k_nodes, j)
        overlay(v_dense, v_nodes, j)
        pj = fills + depths[:, j]
        lj, k_dense, v_dense = forward_cached(
            cfg, params, window[:, j:j + 1], k_dense, v_dense, pj, rope=rope,
            lora=lora)
        steps.append(lj)

        def keep(nd, dn):
            nd[:, :, :, j:j + 1] = dn

        _leafwise(keep, k_nodes, cache_rows_at(k_dense, pj))
        _leafwise(keep, v_nodes, cache_rows_at(v_dense, pj))

    def node_rows(nodes):
        def f(a):
            tail = tuple(a.shape[4:])
            r = a.movedim(3, 2)                      # [L, S, W, kv(, d)]
            return r.reshape((a.shape[0], S * W, a.shape[2], 1) + tail)
        return _leafwise(f, nodes)

    cache_append_rows(k_pool, node_rows(k_nodes), bids, offs)
    cache_append_rows(v_pool, node_rows(v_nodes), bids, offs)
    return torch.cat(steps, dim=1), k_pool, v_pool


def init_kv_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                  dtype=None, device=None):
    """Empty stacked KV cache ``[L, b, kv_heads, max_len, d]`` x2; with
    ``cfg.kv_cache_quant == "int8"`` each side is the int8 ``{"q",
    "scale"}`` form (half the decode cache bytes of bf16).  Under a
    current serving mesh, this rank's slice (``sharding.kv_local_dims``:
    its layers under pp, its kv heads under tp)."""
    layers, heads = sharding.kv_local_dims(cfg, current_mesh())
    shape = (layers, batch_size, heads, max_len, cfg.head_dim)
    device = default_device(device)
    if cfg.kv_cache_quant == "int8":
        return (init_quantized_cache(shape, device),
                init_quantized_cache(shape, device))
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_kv_pool(cfg: ModelConfig, n_blocks: int, block_size: int,
                 dtype=None, device=None):
    """Empty paged pool ``[L, n_blocks, kv_heads, block, d]`` x2 (the
    cache layout with the batch axis read as the block axis)."""
    return init_kv_cache(cfg, n_blocks, block_size, dtype, device)


def _leaf(cache) -> torch.Tensor:
    """The tensor that carries a cache's shape (the int8 form's codes)."""
    return cache["q"] if isinstance(cache, dict) else cache


def _leafwise(fn, cache, *others):
    """``fn`` over a plain cache, or over each leaf of the int8 form (with
    the matching leaves of ``others``), as JAX's ``tree.map``."""
    if isinstance(cache, dict):
        return {k: fn(v, *(o[k] for o in others)) for k, v in cache.items()}
    return fn(cache, *others)


def cache_gather_blocks(pool, tables: torch.Tensor):
    """Per-slot block tables ``[S, T]`` → dense ``[L, S, kv, T*blk(, d)]``
    (new tensors).  Rows from trash or past-fill blocks hold finite
    garbage that decode attention masks."""
    S, T = tables.shape
    flat = tables.reshape(-1).to(torch.long)

    def g(a):
        L, _, kv, bk = a.shape[:4]
        tail = tuple(a.shape[4:])
        x = a.index_select(1, flat)
        x = x.view((L, S, T, kv, bk) + tail).transpose(2, 3)
        return x.reshape((L, S, kv, T * bk) + tail)

    return _leafwise(g, pool)


def cache_take_rows(cache, idx: torch.Tensor):
    """Batch rows ``idx`` of a dense cache ``[L, b, kv, max_len(, d)]``,
    every leaf, as NEW tensors (JAX's ``take`` on axis 1): a beam reorder
    must copy, since ``cache_update`` writes the caches in place and a
    view would alias the source rows."""
    idx = torch.as_tensor(idx, device=_leaf(cache).device).to(torch.long)
    return _leafwise(lambda a: a.index_select(1, idx), cache)


def cache_scatter_blocks(pool, dense, bids):
    """Publish a batch-1 dense cache ``[L, 1, kv, T*blk(, d)]``: its block
    i lands in pool block ``bids[i]`` (trash entries skip a block).  In
    place, every leaf; returns the pool."""
    bids = torch.as_tensor(bids, device=_leaf(pool).device).to(torch.long)

    def sc(p, d_):
        L, _, kv, W = d_.shape[:4]
        tail = tuple(d_.shape[4:])
        bk = p.shape[3]
        x = d_[:, 0].reshape((L, kv, W // bk, bk) + tail).transpose(1, 2)
        p[:, bids] = x.to(p.dtype)

    _leafwise(sc, pool, dense)
    return pool


def cache_append_rows(pool, rows, bids, offs):
    """Scatter one new row per slot: ``rows`` ``[L, S, kv, 1(, d)]``, slot
    s's row to offset ``offs[s]`` of block ``bids[s]``.  In place, every
    leaf (int8 rows move verbatim, never requantized)."""
    device = _leaf(pool).device
    bids = torch.as_tensor(bids, device=device).to(torch.long)
    offs = torch.as_tensor(offs, device=device).to(torch.long)

    def ap(p, r):
        # p[:, bids, :, offs]: separated advanced indices put the slot
        # axis first, so the update is [S, L, kv(, d)]
        p[:, bids, :, offs] = r[:, :, :, 0].transpose(0, 1).to(p.dtype)

    _leafwise(ap, pool, rows)
    return pool


def cache_move_rows(pool, src_bids, src_offs, dst_bids, dst_offs):
    """Copy pool rows ``(src_bids[i], src_offs[i])`` to ``(dst_bids[i],
    dst_offs[i])``, in place, every leaf (int8 codes and scales move
    verbatim).  Every source row is read before any destination row is
    written, so moves whose sources and destinations overlap (a tree
    verify's accepted path packed down to its depth positions) act at
    once; the index assignment alone does not promise an order over
    overlapping rows.  No-op entries point both sides at the trash block.
    Returns the pool."""
    device = _leaf(pool).device

    def idx(t):
        return torch.as_tensor(t, device=device).to(torch.long)

    sb, so, db, do = idx(src_bids), idx(src_offs), idx(dst_bids), \
        idx(dst_offs)

    def mv(p):
        rows = p[:, sb, :, so]       # a gathered copy [M, L, kv(, d)]
        p[:, db, :, do] = rows

    _leafwise(mv, pool)
    return pool


def cache_rows_at(dense, fills):
    """Each slot's row at its own fill: ``[L, S, kv, W(, d)]`` →
    ``[L, S, kv, 1(, d)]``."""
    fills = torch.as_tensor(fills, device=_leaf(dense).device).to(torch.long)

    def f(a):
        L, S, kv = a.shape[:3]
        tail = tuple(a.shape[4:])
        idx = fills.reshape((1, S, 1, 1) + (1,) * len(tail))
        return torch.gather(a, 3, idx.expand((L, S, kv, 1) + tail))

    return _leafwise(f, dense)


def cache_rows_range(dense, fills, width: int):
    """``width`` consecutive rows from each slot's own fill: ``[L, S, kv,
    Wd(, d)]`` → ``[L, S*width, kv, 1(, d)]``, row ``s*width + j`` slot s's
    window position j (the layout ``cache_append_rows`` takes)."""
    fills = torch.as_tensor(fills, device=_leaf(dense).device).to(torch.long)

    def f(a):
        L, S, kv = a.shape[:3]
        tail = tuple(a.shape[4:])
        idx = fills[:, None] + torch.arange(width, device=a.device)[None, :]
        idx = idx.reshape((1, S, 1, width) + (1,) * len(tail))
        rows = torch.gather(a, 3, idx.expand((L, S, kv, width) + tail))
        rows = rows.movedim(3, 2)                    # [L, S, W, kv(, d)]
        return rows.reshape((L, S * width, kv, 1) + tail)

    return _leafwise(f, dense)


def num_params(params: Params) -> int:
    total = 0
    for v in params.values():
        total += num_params(v) if isinstance(v, dict) else v.numel()
    return total


def flops_per_token(cfg: ModelConfig, seq_len: int) -> float:
    """Analytic forward FLOPs per token, the JAX package's count (reference
    FLOP estimate: megatron/model/language_model.py:370-384); a training
    step does three times this (forward, and a backward of twice it)."""
    h = cfg.hidden_size
    d = cfg.head_dim
    nq = cfg.num_attention_heads
    nkv = cfg.kv_heads
    n_mlp_mat = 3 if cfg.is_glu else 2
    mlp_mult = cfg.moe_top_k if cfg.num_experts > 0 else 1
    router = 2 * h * cfg.num_experts if cfg.num_experts > 0 else 0
    per_layer = (
        2 * h * (nq * d)  # wq
        + 2 * h * (nkv * d) * 2  # wk, wv
        + 2 * (nq * d) * h  # wo
        + 2 * 2 * nq * d * seq_len  # attention scores + context
        + mlp_mult * n_mlp_mat * 2 * h * cfg.ffn_size  # mlp matmuls
        + router
    )
    return float(cfg.num_layers * per_layer
                 + 2 * h * cfg.padded_vocab_size())
