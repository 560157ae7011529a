"""Tensor- and sequence-parallel communication, written out.

The JAX package has no such module: it states the layout as one
``PartitionSpec`` a parameter (``models/sharding.py``) and a sequence
constraint on the residual stream (``models/transformer.py:seq_constrain``)
and GSPMD derives the collectives.  PyTorch derives nothing, so the port
writes them out as the reference does (megatron/core/tensor_parallel/
mappings.py), as ``torch.autograd.Function``s, each the other's adjoint:

- ``copy_to_tensor_region``: identity forward, all-reduce backward (the
  input of a column-parallel product);
- ``reduce_from_tensor_region``: all-reduce forward, identity backward
  (the output of a row-parallel product);
- ``gather_from_sequence_region``: all-gather along the sequence forward,
  reduce-scatter backward (a sequence-parallel input of a column-parallel
  product);
- ``reduce_scatter_to_sequence_region``: reduce-scatter along the
  sequence forward, all-gather backward (a row-parallel output back into
  the sequence-sharded residual stream);
- ``gather_from_data_region``: all-gather along the batch forward,
  reduce-scatter backward (the ICT loss's in-batch contexts under dp);
- ``gather_whole`` and ``split_region``: all-gather forward and this
  rank's block of the grad backward, and the reverse (reference
  ``gather_from_sequence_parallel_region(tensor_parallel_output_grad=
  False)`` and ``scatter_to_sequence_parallel_region``): a tensor every
  rank computes whole from the gathered blocks, such as the MoE router's
  probabilities under sequence parallelism (``models/moe.py``) and ring
  attention over a sequence every cp rank holds whole
  (``parallel/ring_attention.whole_sequence``);
- ``ppermute``: each rank's tensor sent to its destination in a
  permutation of the group, the reverse permutation backward (JAX's
  ``lax.ppermute``): the pipeline's stage-to-stage sends and the ring's
  K/V rotation (``parallel/pipeline.py``, ``parallel/ring_attention.py``).

Each takes a process group; with None (an axis of size 1) each returns its
input untouched and launches nothing.  ``launches`` counts the collectives
that did communicate.

The plain collectives below (``all_reduce``, ``all_gather``,
``reduce_scatter``) serve the step (grad reductions, ZeRO-1) and the
checkpoints.  NCCL takes one rank a GPU.  Several ranks sharing one GPU
(a host with one H100) talk over gloo, which takes no CUDA tensor for
some collectives and moved host memory at ~0.7 GB/s on an 8-core H100
host (``parallel/transport_probe.py``): a gloo group whose ranks share one
device exchanges through a ``DeviceMailbox`` instead, each rank's device
buffer mapped into the others with CUDA IPC, gloo carrying the barriers.
``initialize.pick_backend`` takes NCCL whenever each GPU has one rank, so
a gloo group of CUDA ranks on different devices is refused.  A
reduce-scatter under gloo is this rank's block of an all-reduce.  The
mailbox is the transport, not a fallback: the kernels run on the card,
and NCCL never takes this route.  A ``ppermute`` takes NCCL's
``batch_isend_irecv`` (one rank a GPU), gloo's send and receive (CPU
tensors) or the mailbox's point-to-point exchange (ranks sharing one
GPU); a group none of them serves raises.
"""

from __future__ import annotations

import functools
import socket

import torch
import torch.distributed as dist

launches = 0  # collectives that communicated (a group of size > 1)

_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          getattr(dist, "reduce_scatter_tensor", None))
_all_gather = getattr(dist, "all_gather_single",
                      getattr(dist, "all_gather_into_tensor", None))


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _count() -> None:
    global launches
    launches += 1


# ---------------------------------------------------------------------------
# gloo with CUDA tensors: a shared-device mailbox
# ---------------------------------------------------------------------------

MAILBOX_BYTES = 256 << 20  # each rank's buffer; a larger tensor goes in pieces


class DeviceMailbox:
    """The ranks of a gloo group that share one CUDA device exchange
    through each other's device buffer (``boxes``, one a rank, mapped into
    every rank with CUDA IPC), gloo carrying only the barriers: a piece is
    written into the rank's own box, a fence (the device synchronized, a
    barrier), every rank reads every box in rank order, a fence.  The sums
    run in rank order, so every rank gets the same bits."""

    def __init__(self, group, boxes: list, device):
        self.group, self.boxes, self.device = group, boxes, device
        self.rank = dist.get_rank(group)
        self.n = len(boxes)

    @classmethod
    def for_device(cls, group, device):
        """The group's mailbox on ``device`` when every rank of the group
        is on it (same host, same device), else None."""
        from torch.multiprocessing.reductions import reduce_tensor

        n = dist.get_world_size(group)
        me = (socket.gethostname(),
              str(torch.cuda.get_device_properties(device).uuid))
        everyone = [None] * n
        dist.all_gather_object(everyone, me, group=group)
        if any(e != me for e in everyone):
            return None
        own = torch.empty(MAILBOX_BYTES, dtype=torch.uint8, device=device)
        handles = [None] * n
        dist.all_gather_object(handles, reduce_tensor(own), group=group)
        rank = dist.get_rank(group)
        boxes = [own if r == rank else fn(*args)
                 for r, (fn, args) in enumerate(handles)]
        return cls(group, boxes, device)

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)

    def _pieces(self, flat: torch.Tensor):
        """``(offset, length, views)`` a piece of ``flat``: the views are
        each box's first ``length`` elements, as ``flat``'s dtype."""
        step = MAILBOX_BYTES // flat.element_size()
        for off in range(0, flat.numel(), step):
            k = min(step, flat.numel() - off)
            nbytes = k * flat.element_size()
            yield off, k, [b[:nbytes].view(flat.dtype) for b in self.boxes]

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``t`` (contiguous) reduced in place."""
        combine = {dist.ReduceOp.SUM: torch.add,
                   dist.ReduceOp.MAX: torch.maximum,
                   dist.ReduceOp.MIN: torch.minimum}[op]
        flat = t.view(-1)
        for off, k, views in self._pieces(flat):
            views[self.rank].copy_(flat[off:off + k])
            self._fence()
            acc = views[0].clone()
            for v in views[1:]:
                acc = combine(acc, v)
            flat[off:off + k].copy_(acc)
            self._fence()
        return t

    def all_gather(self, src: torch.Tensor) -> torch.Tensor:
        """The ranks' ``src`` (contiguous) joined along dim 0."""
        flat = src.view(-1)
        m = flat.numel()
        out = torch.empty(self.n * m, dtype=src.dtype, device=src.device)
        for off, k, views in self._pieces(flat):
            views[self.rank].copy_(flat[off:off + k])
            self._fence()
            for r, v in enumerate(views):
                out[r * m + off:r * m + off + k].copy_(v)
            self._fence()
        return out.view((self.n * src.shape[0],) + tuple(src.shape[1:]))

    def permute(self, t: torch.Tensor, pairs) -> torch.Tensor:
        """``t`` (contiguous) of the rank that sends to this one in
        ``pairs`` (``(src, dst)`` group ranks), zeros where none does: a
        sender writes its own box, a fence, a receiver reads its source's
        box, a fence.  Every rank of the group calls it."""
        src = {d: s for s, d in pairs}.get(self.rank)
        sends = any(s == self.rank for s, _ in pairs)
        flat = t.view(-1)
        out = torch.zeros_like(flat)
        for off, k, views in self._pieces(flat):
            if sends:
                views[self.rank].copy_(flat[off:off + k])
            self._fence()
            if src is not None:
                out[off:off + k].copy_(views[src])
            self._fence()
        return out.view(t.shape)


_MAILBOXES: dict = {}


def _mailbox(group, t: torch.Tensor):
    """The mailbox of a gloo group whose ranks share ``t``'s CUDA device,
    made at the group's first such collective; None for a tensor that is
    not on CUDA or a group that is not gloo."""
    if not (t.is_cuda and _gloo(group)):
        return None
    if group not in _MAILBOXES:
        _MAILBOXES[group] = DeviceMailbox.for_device(group, t.device)
    if _MAILBOXES[group] is None:
        raise RuntimeError(
            "a gloo group's CUDA ranks are on different devices: give "
            "each GPU one rank and use the NCCL backend")
    return _MAILBOXES[group]


def release_mailboxes() -> None:
    """Drop every mailbox and its mappings of the peers' buffers (before
    the world goes: a rank must not free a buffer its peers still map)."""
    boxes = [b for b in _MAILBOXES.values() if b is not None]
    _MAILBOXES.clear()
    for box in boxes:
        box.boxes = []
    if boxes:
        torch.cuda.synchronize()
        torch.cuda.ipc_collect()


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    """``all_reduce`` without its count."""
    box = _mailbox(group, t)
    if box is not None:
        return box.all_reduce(t, op) if t.is_contiguous() \
            else t.copy_(box.all_reduce(t.contiguous(), op))
    if not t.is_contiguous():
        c = t.contiguous()
        dist.all_reduce(c, op=op, group=group)
        return t.copy_(c)
    dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` IN PLACE; returns it."""
    if group_size(group) == 1:
        return t
    _count()
    return _all_reduce(t, group, op)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``t`` joined along ``dim`` in rank order (a new
    tensor)."""
    n = group_size(group)
    if n == 1:
        return t
    _count()
    dim = dim % t.ndim
    src = t.movedim(dim, 0).contiguous()
    box = _mailbox(group, t)
    if box is not None:
        return box.all_gather(src).movedim(0, dim)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=src.device)
    _all_gather(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ``group`` of ``t``, this rank's block of it along
    ``dim`` (a new tensor); ``dim`` must divide by the group size."""
    n = group_size(group)
    if n == 1:
        return t
    _count()
    dim = dim % t.ndim
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide by {n}")
    rows = t.shape[dim] // n
    if _gloo(group):
        # this rank's block of an all-reduce (of a copy: t may be a grad
        # that autograd hands to others too): gloo's own reduce-scatter
        # takes 1.2-1.7x its all-reduce's time (parallel/transport_probe.py)
        whole = _all_reduce(t.movedim(dim, 0).clone(
            memory_format=torch.contiguous_format), group, dist.ReduceOp.SUM)
        start = group_rank(group) * rows
        out = whole[start:start + rows].clone()
    else:
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((rows,) + tuple(src.shape[1:]), dtype=t.dtype,
                          device=t.device)
        _reduce_scatter(out, src, group=group)
    return out.movedim(0, dim)


def _permute(t: torch.Tensor, group, pairs) -> torch.Tensor:
    """``ppermute`` without autograd: this rank's tensor from its source
    in ``pairs`` (``(src, dst)`` ranks of ``group``), zeros without one; a
    pair ``(r, r)`` is a copy.  Every rank of the group calls it with the
    same ``pairs``; ``t`` of a rank that sends nothing only gives the
    shape and dtype."""
    pairs = [(int(a), int(b)) for a, b in pairs]
    dsts = [d for _, d in pairs]
    if len(set(dsts)) != len(dsts) or len({a for a, _ in pairs}) != \
            len(pairs):
        raise ValueError(f"ppermute: {pairs} is not a permutation")
    me = group_rank(group)
    src = {d: a for a, d in pairs}.get(me)
    dst = {a: d for a, d in pairs}.get(me)
    if group_size(group) == 1 or all(a == d for a, d in pairs):
        return t.clone() if src == me else torch.zeros_like(t)
    _count()
    t = t.contiguous()
    box = _mailbox(group, t)
    if box is not None:
        return box.permute(t, pairs)
    gloo = _gloo(group)
    if not gloo and not t.is_cuda:
        # gloo's CUDA tensors took the mailbox above (or it raised)
        raise RuntimeError(
            f"ppermute: a {dist.get_backend(group)} group cannot move "
            f"{t.device.type} tensors: NCCL takes CUDA tensors, one rank a "
            "GPU; gloo takes CPU tensors, or CUDA tensors of ranks that "
            "share one GPU")
    out = torch.zeros_like(t)
    if src == me:
        out.copy_(t)
    glob = functools.partial(dist.get_global_rank, group)
    if gloo:
        reqs = []
        if dst is not None and dst != me:
            reqs.append(dist.isend(t, glob(dst), group=group))
        if src is not None and src != me:
            reqs.append(dist.irecv(out, glob(src), group=group))
        for r in reqs:
            r.wait()
        return out
    ops = []
    if dst is not None and dst != me:
        ops.append(dist.P2POp(dist.isend, t, glob(dst), group))
    if src is not None and src != me:
        ops.append(dist.P2POp(dist.irecv, out, glob(src), group))
    if ops:
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    return out


def split(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (no communication)."""
    n = group_size(group)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, group_rank(group) * size, size)


# ---------------------------------------------------------------------------
# The autograd mappings
# ---------------------------------------------------------------------------


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatterToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return split(g, ctx.group, ctx.dim).contiguous(), None, None


class _SplitRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return split(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _permute(x, group, pairs)

    @staticmethod
    def backward(ctx, g):
        back = [(d, a) for a, d in ctx.pairs]
        return _permute(g, ctx.group, back), None, None


def ppermute(t: torch.Tensor, group, perm) -> torch.Tensor:
    """Differentiable ``lax.ppermute``: ``perm`` is ``(src, dst)`` pairs
    of group ranks; this rank gets the tensor of the rank that sends to
    it (zeros where none does), and the backward sends each grad back
    along the reverse pairs.  Every rank of ``group`` calls it with the
    same ``perm``."""
    perm = tuple((int(a), int(b)) for a, b in perm)
    if not t.requires_grad:
        return _permute(t, group, perm)
    return _PPermute.apply(t, group, perm)


SEQ_DIM = 1  # activations are [b, s, h]


def copy_to_tensor_region(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _CopyToRegion.apply(x, group)


def reduce_from_tensor_region(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceFromRegion.apply(x, group)


def gather_from_sequence_region(x: torch.Tensor, group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _GatherFromRegion.apply(x, group, SEQ_DIM)


def reduce_scatter_to_sequence_region(x: torch.Tensor,
                                      group) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return _ReduceScatterToRegion.apply(x, group, SEQ_DIM)


def gather_from_data_region(x: torch.Tensor, group) -> torch.Tensor:
    """``x [b_local, ...]`` → ``[b_local * dp, ...]`` in rank order; the
    backward sums every rank's grad of the whole and keeps this rank's
    rows."""
    if group_size(group) == 1:
        return x
    return _GatherFromRegion.apply(x, group, 0)


def gather_whole(x: torch.Tensor, group, dim: int = SEQ_DIM) -> torch.Tensor:
    """The ranks' blocks joined along ``dim`` (every rank computes on the
    whole alike); the backward keeps this rank's block of the whole's grad
    (every rank holds the same whole grad, so nothing is summed)."""
    if group_size(group) == 1:
        return x
    return _GatherWhole.apply(x, group, dim)


def split_region(x: torch.Tensor, group, dim: int = SEQ_DIM) -> torch.Tensor:
    """This rank's block of a tensor every rank holds whole alike; the
    backward all-gathers the blocks' grads into the whole's."""
    if group_size(group) == 1:
        return x
    return _SplitRegion.apply(x, group, dim)


def column_input(x: torch.Tensor, group, sequence_parallel: bool):
    """The input of a column-parallel product: the sequence gathered under
    sequence parallelism, else the tensor-region copy."""
    if sequence_parallel:
        return gather_from_sequence_region(x, group)
    return copy_to_tensor_region(x, group)


def row_output(x: torch.Tensor, group, sequence_parallel: bool):
    """The output of a row-parallel product: reduce-scattered back to the
    sequence shard under sequence parallelism, else all-reduced."""
    if sequence_parallel:
        return reduce_scatter_to_sequence_region(x, group)
    return reduce_from_tensor_region(x, group)
