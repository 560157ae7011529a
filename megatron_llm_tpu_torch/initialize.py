"""Process bootstrap (mirror of ``megatron_llm_tpu/initialize.py``;
reference megatron/initialize.py:124-151 ``_initialize_distributed``).

``initialize_distributed`` reads the environment ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR`` / ``MASTER_PORT``), or takes an ``init_method`` and the
rank and world size, and calls ``torch.distributed.init_process_group``
once.  The backend is NCCL for a world of CUDA devices with one rank
each, and gloo on the CPU or where several ranks share one device (NCCL
refuses two ranks on one GPU; ``parallel/mappings.py`` moves their CUDA
collectives through a shared-device mailbox, gloo carrying the
barriers).  Each rank takes
``cuda:LOCAL_RANK`` modulo the device count.

With no environment and no arguments it is a world of one process and
initializes nothing.  Where the environment says the world has more than
one rank, a failed rendezvous raises: the process never goes on to train
alone, which would train N divergent copies (the JAX docstring's rule).
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


class DistInfo(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    device: torch.device
    backend: Optional[str]


_INFO: Optional[DistInfo] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def pick_backend(device_type: str, local_world_size: int) -> str:
    """NCCL for one rank per CUDA device, else gloo."""
    if device_type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(device: str | torch.device = "cuda", *,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                           ) -> DistInfo:
    """Join the world (idempotent) → ``DistInfo``.  ``device`` is the
    device type the ranks train on (``"cuda"`` or ``"cpu"``)."""
    global _INFO
    if _INFO is not None:
        return _INFO
    device_type = torch.device(device).type
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None \
        else _env_int("WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank or 0
    if world_size is None and init_method is None:
        # no launcher: one process, nothing to join (nothing is kept, so a
        # later call under a launcher's environment still joins)
        return DistInfo(0, 1, 0, torch.device(device), None)
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    if device_type == "cuda":
        n_dev = torch.cuda.device_count()
        if n_dev == 0:
            raise RuntimeError("initialize_distributed: no CUDA device")
        dev = torch.device("cuda", local_rank % n_dev)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    local_world = _env_int("LOCAL_WORLD_SIZE") or world_size
    backend = pick_backend(device_type, local_world)
    if not dist.is_initialized():
        kwargs = dict(backend=backend, rank=rank, world_size=world_size,
                      timeout=timeout)
        if init_method is not None:
            kwargs["init_method"] = init_method
        if backend == "nccl":
            kwargs["device_id"] = dev
        # a failed rendezvous raises here (a timeout or a refused store):
        # there is no single-process fallback
        dist.init_process_group(**kwargs)
        if backend == "gloo" and world_size > 1:
            dist.barrier()
    _INFO = DistInfo(dist.get_rank(), dist.get_world_size(), local_rank,
                     dev, dist.get_backend())
    return _INFO


def is_initialized() -> bool:
    return _INFO is not None


def get_rank() -> int:
    """This process's rank (0 outside a world)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_rank_0() -> bool:
    return get_rank() == 0


def barrier() -> None:
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        dist.barrier()


def destroy() -> None:
    """Leave the world (the tests' spawned ranks, the smoke's phases): the
    peers' mapped buffers released on every rank first."""
    global _INFO
    if dist.is_available() and dist.is_initialized():
        from .parallel.mappings import release_mailboxes

        release_mailboxes()
        barrier()
        dist.destroy_process_group()
    _INFO = None
