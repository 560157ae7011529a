"""The process-group topology (mirror of ``megatron_llm_tpu/parallel/
mesh.py``; reference megatron/core/parallel_state.py:51-214).

The JAX package names one ``jax.sharding.Mesh`` with axes ``(dp, fsdp, pp,
cp, ep, tp, sp)`` and lets GSPMD derive the collectives.  Here the same
axes, in the same order (tp fastest-varying, dp outermost), are laid over
the flat ``torch.distributed`` world: rank ``r`` sits at the row-major
coordinates of ``r`` in the mesh shape, and each axis of size above 1 gets
one process group per line of the mesh along it.  ``build_mesh`` returns a
``Mesh`` holding this rank's coordinates and its group on each axis (None
where the axis has size 1, so a degree-1 axis launches nothing).

A mesh may also be laid over an explicit list of the world's ranks
(``build_mesh(parallel, ranks=...)``): ``replica_submeshes`` gives each
engine replica of the serving router its own mesh, JAX's disjoint device
slices, with one difference.  The router's process leads every replica
(``serving/cluster/router.py``), so global rank 0 is the first rank of
each replica's mesh; the replicas' other ranks are disjoint.

``use_mesh`` makes a mesh current for the model code, as the JAX
package's does; the model's layers read their tp group from
``current_mesh()``.  Without a current mesh everything runs on one
device, as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from ..config import ParallelConfig
from ..ops import dropout as drop

DATA_AXIS = "dp"
FSDP_AXIS = "fsdp"
PIPELINE_AXIS = "pp"
CONTEXT_AXIS = "cp"
EXPERT_AXIS = "ep"
TENSOR_AXIS = "tp"
SEQ_AXIS = "sp"  # named, always size 1 (as in JAX)
AXIS_ORDER = (DATA_AXIS, FSDP_AXIS, PIPELINE_AXIS, CONTEXT_AXIS,
              EXPERT_AXIS, TENSOR_AXIS, SEQ_AXIS)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the size of each axis, its own
    coordinate on each, and its process group on each axis of size above
    1 (``groups[axis]`` is None on a size-1 axis)."""

    shape: dict
    coords: dict
    groups: dict
    rank: int = 0
    world_size: int = 1
    backend: Optional[str] = None
    # the global rank of each mesh rank, in mesh order (None: the world's
    # ranks 0..world_size-1)
    ranks: Optional[tuple] = None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)


def _shape(parallel: ParallelConfig) -> tuple:
    return (parallel.data_parallel, getattr(parallel, "fsdp", 1),
            parallel.pipeline_parallel, parallel.context_parallel,
            parallel.expert_parallel, parallel.tensor_parallel, 1)


def build_mesh(parallel: ParallelConfig,
               ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """The mesh of ``parallel``'s degrees over the initialized world
    (``initialize.initialize_distributed``), or over the global ``ranks``
    in mesh order.  Every rank of the world must call it, in the same order
    as every other group creation: each axis's groups are created on all
    ranks, and each rank keeps its own.  A rank outside ``ranks`` gets
    None.  A world that is not initialized is a world of one process,
    which takes only the degree-1 mesh."""
    shape = _shape(parallel)
    n = int(np.prod(shape))
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    me = dist.get_rank() if initialized else 0
    if ranks is None:
        if n != world:
            raise ValueError(
                f"mesh shape {dict(zip(AXIS_ORDER, shape))} needs {n} ranks, "
                f"the world has {world}: launch one process per rank under "
                "torchrun (python -m torch.distributed.run --nproc_per_node "
                "N ...)")
        glob = list(range(n))
    else:
        glob = [int(r) for r in ranks]
        if len(glob) != n or len(set(glob)) != n or \
                not all(0 <= r < world for r in glob):
            raise ValueError(
                f"mesh shape {dict(zip(AXIS_ORDER, shape))} needs {n} "
                f"distinct ranks of the world of {world}, got {glob}")
    grid = np.asarray(glob).reshape(shape)
    groups = {}
    for a, axis in enumerate(AXIS_ORDER):
        if shape[a] == 1:
            continue
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines:  # every rank creates every group, in order
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[axis] = g
    if me not in glob:
        return None
    rank = glob.index(me)
    coords = dict(zip(AXIS_ORDER, (int(c) for c in
                                   np.unravel_index(rank, shape))))
    return Mesh(shape=dict(zip(AXIS_ORDER, shape)), coords=coords,
                groups=groups, rank=rank, world_size=n,
                backend=dist.get_backend() if initialized else None,
                ranks=None if ranks is None else tuple(glob))


def replica_ranks(parallel: ParallelConfig, replicas: int,
                  ranks: Sequence[int]) -> list:
    """The global ranks of each of ``replicas`` engine replicas of
    ``parallel``'s per-replica geometry (serving: pp·tp·fsdp ranks each),
    shared out of ``ranks``: replica ``r`` takes the first rank and the
    ``r``-th run of ``per - 1`` ranks after it.  The router's process
    leads every replica (``serving/cluster/router.py``), so ``1 + replicas
    * (per - 1)`` ranks serve ``replicas`` replicas of ``per``."""
    per = (parallel.pipeline_parallel * parallel.tensor_parallel
           * parallel.context_parallel * parallel.expert_parallel
           * parallel.data_parallel * getattr(parallel, "fsdp", 1))
    if replicas < 1:
        raise ValueError(f"replicas must be >= 1, got {replicas}")
    ranks = [int(r) for r in ranks]
    need = 1 + replicas * (per - 1)
    if need > len(ranks):
        raise ValueError(
            f"{replicas} replicas of {per} devices each need "
            f"{need} devices, have {len(ranks)}")
    return [[ranks[0]] + ranks[1 + r * (per - 1):1 + (r + 1) * (per - 1)]
            for r in range(replicas)]


def replica_submeshes(parallel: ParallelConfig, replicas: int,
                      ranks: Optional[Sequence[int]] = None) -> list:
    """JAX's ``replica_submeshes`` over processes: this rank's mesh of each
    of the ``replica_ranks`` replicas (over ``ranks``, default the
    world's), None where this rank is not in it.  Every rank of the world
    calls it, in the same order as every other group creation."""
    if ranks is None:
        initialized = dist.is_available() and dist.is_initialized()
        ranks = range(dist.get_world_size() if initialized else 1)
    return [build_mesh(parallel, ranks=r)
            for r in replica_ranks(parallel, replicas, ranks)]


def global_ranks(mesh: Mesh) -> list:
    """The global rank of each of ``mesh``'s ranks, in mesh order."""
    return list(mesh.ranks) if mesh.ranks is not None else \
        list(range(mesh.world_size))


def axis_ranks(mesh: Mesh, axis: str, index: int) -> list:
    """The global ranks whose coordinate on ``axis`` is ``index`` (a
    pipeline stage's ranks, for instance)."""
    shape = tuple(mesh.size(a) for a in AXIS_ORDER)
    ranks = np.asarray(global_ranks(mesh)).reshape(shape)
    return sorted(int(r) for r in
                  ranks.take(index, axis=AXIS_ORDER.index(axis)).ravel())


def single_device_mesh() -> Mesh:
    return Mesh(shape={a: 1 for a in AXIS_ORDER},
                coords={a: 0 for a in AXIS_ORDER}, groups={})


# ---------------------------------------------------------------------------
# Topology queries (group getters, reference parallel_state.py:217-481)
# ---------------------------------------------------------------------------


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.size(axis)


def tensor_parallel_size(mesh: Mesh) -> int:
    return axis_size(mesh, TENSOR_AXIS)


def pipeline_parallel_size(mesh: Mesh) -> int:
    return axis_size(mesh, PIPELINE_AXIS)


def data_parallel_size(mesh: Mesh) -> int:
    return axis_size(mesh, DATA_AXIS)


def fsdp_size(mesh: Mesh) -> int:
    return axis_size(mesh, FSDP_AXIS)


def context_parallel_size(mesh: Mesh) -> int:
    return axis_size(mesh, CONTEXT_AXIS)


def expert_parallel_size(mesh: Mesh) -> int:
    return axis_size(mesh, EXPERT_AXIS)


def pipeline_stage_layers(num_layers: int, pp: int, vpp: int = 1) -> list:
    """Layers per pipeline stage (they must divide evenly, as the
    reference's num_layers // pipeline size, transformer.py:845-895)."""
    chunks = pp * vpp
    if num_layers % chunks:
        raise ValueError(f"num_layers {num_layers} must divide into pp * vpp"
                         f" = {chunks} chunks")
    return [num_layers // chunks] * chunks


def stage_layer_ranges(num_layers: int, pp: int) -> list:
    """Each stage's ``[lo, hi)`` range of the contiguous layer split."""
    per = pipeline_stage_layers(num_layers, pp)[0]
    return [(s * per, (s + 1) * per) for s in range(pp)]


def is_first_stage(stage: int) -> bool:
    return stage == 0


def is_last_stage(stage: int, pp: int) -> bool:
    return stage == pp - 1


def prev_stage(stage: int, pp: int) -> int:
    """Cyclic neighbour on the pp axis (parallel_state.py:463-471)."""
    return (stage - 1) % pp


def next_stage(stage: int, pp: int) -> int:
    return (stage + 1) % pp


# ---------------------------------------------------------------------------
# The current mesh
# ---------------------------------------------------------------------------


# A stack for each thread that makes a mesh current, and one for the
# process that holds every current mesh: a thread that made none reads the
# process's (the backward of a CUDA tensor runs on autograd's device
# thread, and a layer recomputed there, ``recompute`` selective or full,
# must see the mesh its forward saw), while the scheduler threads of the
# router's replicas each read their own replica's mesh.
_MESH_STACK: list = []
_THREAD = threading.local()
_LOCK = threading.Lock()


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` current for the model code inside the block (and for
    the backward it starts)."""
    own = _THREAD.__dict__.setdefault("stack", [])
    own.append(mesh)
    with _LOCK:
        _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        own.pop()
        with _LOCK:
            for i in range(len(_MESH_STACK) - 1, -1, -1):
                if _MESH_STACK[i] is mesh:
                    del _MESH_STACK[i]
                    break


def current_mesh() -> Optional[Mesh]:
    own = _THREAD.__dict__.get("stack")
    if own:
        return own[-1]
    return _MESH_STACK[-1] if _MESH_STACK else None


def axis_info(axis: str) -> tuple:
    """``(group, size, index)`` of ``axis`` on the current mesh; ``(None,
    1, 0)`` without one."""
    mesh = current_mesh()
    if mesh is None:
        return None, 1, 0
    return mesh.group(axis), mesh.size(axis), mesh.index(axis)


# ---------------------------------------------------------------------------
# Per-shard dropout keys (the reference's CUDA RNG tracker,
# tensor_parallel/random.py:64-172; JAX's fold_in_axis)
# ---------------------------------------------------------------------------

TP_SALT = 2718  # the reference's seed offset (random.py:160-172)
PP_SALT = 100   # per-stage seed offset (reference initialize.py:179-193)


def fold_in_axis(key: drop.DropoutKey, mesh: Mesh, axis_name: str,
                 salt: int = TP_SALT) -> drop.DropoutKey:
    """A per-shard key along ``axis_name``: the key folded with ``salt``,
    then with this rank's index on the axis (JAX ``fold_in_axis``)."""
    return drop.fold_in(drop.fold_in(key, salt), mesh.index(axis_name))
