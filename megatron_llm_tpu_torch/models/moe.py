"""Mixture-of-experts MLP with expert parallelism over the ``ep`` axis
(mirror of ``megatron_llm_tpu/models/moe.py``).

The formulation is the JAX package's GShard/Switch one: token-choice
top-k routing with capacity, as dense one-hot dispatch and combine
einsums over routing groups of the sequence (``group_size``); tokens past
an expert's capacity lose that expert's contribution; the auxiliary
load-balance loss is Switch's ``E * sum_e f_e * p_e`` over assignments.
The router stays fp32.

Expert parallelism (``models/sharding.py``: the expert leaves ``[L, E,
...]`` split over ``ep``) is written out where GSPMD derives it from the
einsums in JAX: every ep rank routes the same tokens (the batch is not
split over ep), runs its ``E / ep`` local experts on its slice of the
dispatch, and the combine is summed over the ep group
(``reduce_from_tensor_region``).  The experts' input and the combine
weights enter through ``copy_to_tensor_region``, so their backward sums
each rank's part over ep and the router's grad is the whole one on every
rank.  Under tp (without sequence parallelism) each expert's ffn is split
as the dense MLP's, the down projection's partial sums reduced over tp
before the combine.

Under data parallelism the JAX step routes the global batch: ``f_e`` and
the ``load`` are fractions over every dp rank's tokens.  ``moe_block``
averages them over the current mesh's dp group, and the aux loss takes
this rank's ``p_e`` against the global ``f_e``, so its mean over dp is
JAX's global aux.  The pipeline (``parallel/pipeline.py``) runs inside
``shard_local_stats``, as JAX's pipeline runs ``moe_block`` inside its
manual dp and cp region, where each shard's stats are its own and the
routing groups are cut from the shard's own sequence.

Under context parallelism (outside the pipeline) JAX routes the whole
sequence: ``group_size`` is taken of the whole length, and GSPMD keeps
each group of ``g`` tokens where its tokens are.  A rank here holds a
contiguous block of ``s / cp`` tokens of the sequence as the step laid
it out (the zigzag layout's ``[r, 2 cp - 1 - r]`` chunks are one
contiguous block of the permuted sequence, which JAX's groups are cut
from too), so the groups are the same groups wherever ``g`` divides the
block: each rank routes its own block, ``f_e`` and ``dropped`` are
averaged over cp, and ``aux`` is this rank's share (its ``p_e`` against
the global ``f_e``, over cp).  Where ``g`` does not divide the block (a
group would straddle two ranks), the block gathers the cp group's
tokens and router probabilities (``gather_from_sequence_region``, whose
backward sums the ranks' partial grads), every cp rank routes the whole
sequence alike, keeps its own block of the output, and takes ``1 / cp``
of the whole aux as its share.  The step sums the loss and the aux over
cp, as it sums the LM loss's shares.

Under sequence parallelism the router runs on this rank's ``s / tp``
block and its probabilities are gathered whole (``gather_whole``: the
backward keeps the block's grad, so the router's grad is this rank's
part, which the step sums over tp as it sums every replicated leaf's
under sequence parallelism); the experts take the sequence-gathered
input (``gather_from_sequence_region``, whose backward reduce-scatters
the ffn shards' partial grads) and the block's output leaves as this
rank's block (``split_region``, whose backward gathers the blocks'
grads), so everything between is the tp path without sequence
parallelism.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.activations import get_activation, is_glu
from ..parallel import mappings
from ..parallel.mesh import axis_info

Params = dict

_SHARD_LOCAL = [False]
_CHOICES = [None]


@contextlib.contextmanager
def shard_local_stats():
    """Routing stats over this dp shard's tokens alone inside the block
    (JAX's pipeline: ``moe_block`` runs inside the manual dp region)."""
    old = _SHARD_LOCAL[0]
    _SHARD_LOCAL[0] = True
    try:
        yield
    finally:
        _SHARD_LOCAL[0] = old


@contextlib.contextmanager
def record_choices(out: list):
    """Each ``moe_block`` call's expert choices (``[groups, g, k]`` ids, on
    the host) appended to ``out`` inside the block: a run's routing, to
    hold against another's."""
    old = _CHOICES[0]
    _CHOICES[0] = out
    try:
        yield out
    finally:
        _CHOICES[0] = old


def expert_shapes(cfg: ModelConfig) -> dict:
    """``{name: (shape of one layer's leaf, std)}`` of the expert leaves;
    the router ``[h, E]`` is drawn apart, in fp32."""
    h, f, E = cfg.hidden_size, cfg.ffn_size, cfg.num_experts
    std = cfg.init_method_std
    out_std = std / (2.0 * cfg.num_layers) ** 0.5 if cfg.use_scaled_init \
        else std
    shapes = {}
    if is_glu(cfg.activation):
        shapes["w_gate"] = ((E, h, f), std)
    shapes["w_up"] = ((E, h, f), std)
    shapes["w_down"] = ((E, f, h), out_std)
    return shapes


def init_moe_params(cfg: ModelConfig, generator: torch.Generator,
                    device) -> Params:
    """One layer's expert-stacked MLP weights ``[E, ...]`` and its fp32
    router ``[h, E]`` (JAX ``init_moe_params``' distributions)."""
    def normal(shape, std, dtype):
        if generator is None:  # the meta device
            return torch.empty(shape, dtype=dtype, device=device)
        return (std * torch.randn(shape, generator=generator, device=device,
                                  dtype=torch.float32)).to(dtype)

    p = {"router": normal((cfg.hidden_size, cfg.num_experts),
                          cfg.init_method_std, torch.float32)}
    for name, (shape, std) in expert_shapes(cfg).items():
        p[name] = normal(shape, std, cfg.dtype)
    return p


def capacity(cfg: ModelConfig, group_len: int) -> int:
    return max(1, math.ceil(cfg.moe_top_k * group_len
                            * cfg.moe_capacity_factor / cfg.num_experts))


def group_size(cfg: ModelConfig, seq_len: int) -> int:
    """Largest divisor of ``seq_len`` at most ``cfg.moe_group_size``."""
    g = min(cfg.moe_group_size, seq_len)
    while seq_len % g:
        g -= 1
    return g


def stats_zero(cfg: ModelConfig, device=None) -> dict:
    """The zero stats tree (the per-layer sum's start)."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"aux": z, "dropped": z.clone(),
            "load": torch.zeros(cfg.num_experts, dtype=torch.float32,
                                device=device)}


def aux_loss_of(aux) -> torch.Tensor:
    """The load-balance loss of either aux form (the stats dict of a MoE
    model, a scalar of a dense one)."""
    return aux["aux"] if isinstance(aux, dict) else aux


def add_stats(a, b):
    """Two stats trees summed leaf for leaf (None is the empty sum)."""
    if a is None:
        return b
    return {k: a[k] + b[k] for k in a}


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """Routed MLP → ``(out [b, s, h], stats)``: fp32 scalars ``aux`` (the
    load-balance loss) and ``dropped`` (the fraction of (token, choice)
    assignments lost to capacity) and ``load [E]`` (each expert's share
    of the assignments).  Under a current mesh with ep > 1 ``p``'s expert
    leaves are this rank's ``E / ep`` experts; under cp ``aux`` is this
    rank's share of the whole sequence's."""
    ep_group, ep, ep_rank = axis_info("ep")
    tp_group, tp, _ = axis_info("tp")
    cp_group, cp, _ = axis_info("cp")
    sp = tp > 1 and cfg.sequence_parallel_axis is not None
    whole_cp = cp > 1 and not _SHARD_LOCAL[0]
    E, k = cfg.num_experts, cfg.moe_top_k
    # the router on this rank's tokens (under sequence parallelism its
    # s / tp block), the probabilities gathered whole
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    if sp:
        x = mappings.gather_from_sequence_region(x, tp_group)
        probs = mappings.gather_whole(probs, tp_group)
    b_in, s_block, h = x.shape
    g = group_size(cfg, s_block * cp if whole_cp else s_block)
    gather_cp = whole_cp and s_block % g != 0
    if gather_cp:   # a group straddles cp blocks: route the whole sequence
        x = mappings.gather_from_sequence_region(x, cp_group)
        probs = mappings.gather_from_sequence_region(probs, cp_group)
    s_in = x.shape[1]
    x = x.reshape(b_in * (s_in // g), g, h)
    b, s, _ = x.shape
    C = capacity(cfg, s)
    act = get_activation(cfg.activation)
    probs = probs.reshape(b, s, E)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)         # [b, s, k]
    if k > 1:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    if _CHOICES[0] is not None:
        _CHOICES[0].append(gate_idx.detach().cpu())

    # position in the expert's queue: choice order first, then sequence
    # order; past the capacity the assignment is dropped
    with torch.no_grad():
        sels = []
        counts = torch.zeros((b, E), dtype=torch.float32, device=x.device)
        frac = torch.zeros(E, dtype=torch.float32, device=x.device)
        for j in range(k):
            onehot = F.one_hot(gate_idx[..., j], E).float()     # [b, s, E]
            pos = torch.cumsum(onehot, dim=1) - onehot + counts[:, None]
            counts = counts + onehot.sum(dim=1)
            within = (pos < C).float() * onehot
            frac = frac + onehot.sum(dim=(0, 1))
            slot = F.one_hot(pos.long().clamp(max=C), C + 1)[..., :C].float()
            sels.append(within[..., None] * slot)               # [b, s, E, C]
        dispatch = sum(sels)
    combine = sum(gate_vals[..., j, None, None] * sels[j] for j in range(k))

    f_e = frac / (b * s * k)
    dropped = 1.0 - dispatch.sum() / (b * s * k)
    dp_group, dp, _ = axis_info("dp")
    for group, n, on in ((dp_group, dp, not _SHARD_LOCAL[0]),
                         (cp_group, cp, whole_cp and not gather_cp)):
        if n > 1 and on:   # JAX's global fractions
            f_e = mappings.all_reduce(f_e.clone(), group) / n
            dropped = mappings.all_reduce(dropped.detach().clone(),
                                          group) / n
    p_e = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f_e * p_e)
    if whole_cp:
        aux = aux / cp

    e_local = p["w_up"].shape[0]
    if ep > 1:
        # every ep rank routes the same tokens; each runs its own experts
        x = mappings.copy_to_tensor_region(x, ep_group)
        combine = mappings.copy_to_tensor_region(combine, ep_group)
    # under tp the experts' ffn is split as the dense MLP's: a column
    # input (under sequence parallelism the gather above, whose backward
    # sums the partial grads), and the down projection's partial sums
    # reduced before the combine (so the combine weights' grad, and the
    # router's, are whole on every tp rank)
    if not sp:
        x = mappings.copy_to_tensor_region(x, tp_group)
    lo = ep_rank * e_local if ep > 1 else 0
    disp = dispatch[:, :, lo:lo + e_local]
    comb = combine[:, :, lo:lo + e_local]
    xin = torch.einsum("bsec,bsh->ebch", disp.to(x.dtype), x)
    if is_glu(cfg.activation):
        gate = torch.einsum("ebch,ehf->ebcf", xin, p["w_gate"])
        up = torch.einsum("ebch,ehf->ebcf", xin, p["w_up"])
        hidden = act(torch.cat([gate, up], dim=-1))
    else:
        hidden = act(torch.einsum("ebch,ehf->ebcf", xin, p["w_up"]))
    xout = torch.einsum("ebcf,efh->ebch", hidden, p["w_down"])
    xout = mappings.reduce_from_tensor_region(xout, tp_group)
    out = torch.einsum("ebch,bsec->bsh", xout, comb.to(x.dtype))
    if ep > 1:
        out = mappings.reduce_from_tensor_region(out, ep_group)
    out = out.reshape(b_in, s_in, h)
    if gather_cp:   # this rank's block; the rest's grads are other ranks'
        lo = axis_info("cp")[2] * s_block
        out = out[:, lo:lo + s_block]
    if sp:
        out = mappings.split_region(out, tp_group)
    return out, {"aux": aux, "dropped": dropped, "load": f_e}
