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

``use_mesh`` makes a mesh current for the model code, as the JAX
package's does; the model's layers read their tp group from
``current_mesh()``.  Without a current mesh everything runs on one
device, as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

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


def build_mesh(parallel: ParallelConfig) -> Mesh:
    """The mesh of ``parallel``'s degrees over the initialized world
    (``initialize.initialize_distributed``).  Every rank must call it, in
    the same order as every other group creation: each axis's groups are
    created on all ranks, and each rank keeps its own.  A world that is
    not initialized is a world of one process, which takes only the
    degree-1 mesh."""
    shape = _shape(parallel)
    n = int(np.prod(shape))
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    if n != world:
        raise ValueError(
            f"mesh shape {dict(zip(AXIS_ORDER, shape))} needs {n} ranks, the "
            f"world has {world}: launch one process per rank under torchrun "
            "(python -m torch.distributed.run --nproc_per_node N ...)")
    rank = dist.get_rank() if initialized else 0
    ranks = np.arange(n).reshape(shape)
    coords = dict(zip(AXIS_ORDER, (int(c) for c in
                                   np.unravel_index(rank, shape))))
    groups = {}
    for a, axis in enumerate(AXIS_ORDER):
        if shape[a] == 1:
            continue
        lines = np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
        for line in lines:  # every rank creates every group, in order
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return Mesh(shape=dict(zip(AXIS_ORDER, shape)), coords=coords,
                groups=groups, rank=rank, world_size=world,
                backend=dist.get_backend() if initialized else None)


def axis_ranks(mesh: Mesh, axis: str, index: int) -> list:
    """The ranks whose coordinate on ``axis`` is ``index`` (a pipeline
    stage's ranks, for instance)."""
    shape = tuple(mesh.size(a) for a in AXIS_ORDER)
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
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


# One stack for the process, not a thread's (JAX's is thread-local): the
# backward of a CUDA tensor runs on autograd's device thread, and a layer
# recomputed there (``recompute`` selective or full) must see the mesh its
# forward saw.
_MESH_STACK: list = []
_LOCK = threading.Lock()


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` current for the model code inside the block (and for
    the backward it starts)."""
    with _LOCK:
        _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        with _LOCK:
            _MESH_STACK.pop()


def current_mesh() -> Optional[Mesh]:
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
