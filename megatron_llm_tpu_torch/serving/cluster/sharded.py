"""One serving engine over a tp x pp (x fsdp) mesh of processes (mirror of
``megatron_llm_tpu/serving/cluster/sharded.py``).

JAX serves a sharded model from one process: GSPMD splits every jitted
step over the submesh, and the engine keeps one host ledger whose block
tables are replicated host int32.  The port runs one process a rank, so
the engine's host state and its device work are split between
processes.  The design: **rank 0 drives, the other ranks replay.**

- Rank 0 runs the ``ServingEngine``: the queue, the scheduler thread, the
  block ledger, the prefix trie and the first token's sampling.  Block
  ids are global (``models/sharding.kv_pool_specs`` splits the pool's
  layers over pp and its kv heads over tp, never its blocks), so the
  ledger is the single-device engine's, unchanged.
- Every device operation of the engine goes through one seam,
  ``serving/device_ops.DeviceOps``: the pool's allocation, each prefill
  piece (whole, chunked, a prefix hit's suffix over gathered blocks), the
  publication of a prefill into pool blocks, the decode and verify
  steps, and copy-on-write's block copies, in the order rank 0 makes
  them (pipelined decode dispatches step n+1 before it commits step n:
  the calls carry that order).  Rank 0's seam is a ``MeshDriver``: each
  call broadcasts the operation's name and its host arguments (tokens,
  tables, fills, seeds, knobs) over a gloo group of its own, then runs
  locally; every other rank runs ``MeshWorker.serve``, which receives
  the call and runs the same ``DeviceOps`` method on its own shards.
  This is the reference's choreography (its server's rank 0 fans each
  request out with ``send_do_generate`` and a broadcast of the inputs).
- Sampled tokens are the same on every rank: the cached forwards gather
  the logits over tp and send the last stage's hidden state to every
  stage under pp, so every rank samples the same ``(seed, count)``
  streams from the same logits and keeps the tokens for the next
  pipelined step.
- An idle engine does not reach the channel's timeout: rank 0 sends a
  no-op every ``HEARTBEAT_S`` seconds without traffic.  ``shutdown`` on
  rank 0 sends a stop that ends every worker's loop.  A worker whose
  operation raises writes its error into the world's store and leaves
  the mesh; rank 0's pending or next collective then fails at once and
  raises with the worker's message, and rank 0 leaves the mesh too, so
  no rank waits on a dead peer.  A mesh over the whole world is left by
  leaving the world; a replica's mesh behind the router (``build_cluster``,
  over ranks of its own) by dropping its own groups, so that the other
  replicas serve on and the router fails the requests over.

Under a mesh with pp > 1 the decode step runs the slots in pp contiguous
groups (``ServingEngine._decode_groups``), JAX's microbatch interleave;
in lockstep processes the groups run one after the other.  Speculative
n-gram verify steps go through the seam as well.  A resident draft
model, the host KV tier and adapters do not, and raise under a mesh
(ROADMAP.md, Queue 1 item 11).

At pp = tp = fsdp = 1 ``build_sharded_engine`` returns the plain
single-device engine, as JAX's does, so the fused kernels stay eligible.
"""

from __future__ import annotations

import datetime
import itertools
import threading
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ...config import ModelConfig, ParallelConfig
from ...models import model as model_lib
from ...models import sharding as shard_lib
from ...parallel import mappings
from ...parallel import mesh as mesh_lib
from ..device_ops import DeviceOps
from ..engine import EngineConfig, ServingEngine, check_engine_args
from ..metrics import ServingMetrics

# rank 0 sends a no-op after this long without traffic, well inside the
# channel's timeout (the workers wait on the channel between requests)
HEARTBEAT_S = 2.0
CHANNEL_TIMEOUT = datetime.timedelta(minutes=10)

_ENGINES = itertools.count()  # one channel a sharded engine, in order


class _Channel:
    """The control channel of one sharded engine: a gloo group over the
    mesh's global ranks of its own (its timeout bounds only the wait
    between operations, which the heartbeat keeps short), the mesh's
    first rank the source.  Every rank of the world makes it at the same
    point of its build, in order, those outside the mesh included."""

    def __init__(self, ranks):
        self.seq = next(_ENGINES)
        self.src = int(ranks[0])
        self.group = dist.new_group([int(r) for r in ranks],
                                    backend="gloo", timeout=CHANNEL_TIMEOUT)
        self.error_key = f"sharded_serving/{self.seq}/error"

    def send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=self.src, group=self.group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.src, group=self.group)
        return box[0]


def _store():
    return dist.distributed_c10d._get_default_store()


def _leave(mesh, channel: _Channel) -> None:
    """Leave the engine's mesh: every peer's pending collective with this
    rank fails at once rather than waiting out its timeout.  A mesh over
    the whole world leaves the world.  A replica's mesh destroys its own
    groups and drops this rank's every reference to them (a gloo group
    closes its connections only when it is freed), so the world and the
    other replicas' groups stay."""
    if not dist.is_initialized():
        return
    if mesh.ranks is None:
        dist.destroy_process_group()
        return
    groups = [g for g in (channel.group, *mesh.groups.values())
              if g is not None]
    channel.group = None
    mesh.groups.clear()
    while groups:
        g = groups.pop()
        mappings.release_mailbox(g)
        dist.destroy_process_group(g)
        del g


class MeshDriver(DeviceOps):
    """Rank 0's seam: each ``DeviceOps`` call is broadcast to the mesh's
    other ranks, then run here (see the module docstring)."""

    def __init__(self, cfg, params, device, mesh):
        super().__init__(cfg, params, device, mesh)
        self._channel = _Channel(mesh_lib.global_ranks(mesh))
        self._lock = threading.RLock()
        self._last = time.monotonic()
        self._failed: Optional[BaseException] = None
        self._closed = False
        self._quiet = threading.Event()
        self._beat = threading.Thread(target=self._heartbeat, daemon=True,
                                      name="sharded-serving-heartbeat")
        self._beat.start()

    def _call(self, name: str, *args, **kwargs):
        with self._lock:
            if self._failed is not None:
                raise RuntimeError(
                    f"sharded serving failed earlier: {self._failed}")
            if self._closed:
                raise RuntimeError("sharded serving engine is shut down")
            try:
                self._channel.send((name, args, kwargs))
                return getattr(DeviceOps, name)(self, *args, **kwargs)
            except Exception as e:  # noqa: BLE001 — re-raised with the cause
                raise self._fail(name, e) from e
            finally:
                self._last = time.monotonic()

    def _fail(self, name: str, e: BaseException) -> RuntimeError:
        """The error to raise for operation ``name``: a worker's own
        message where one left it in the store; the world is left."""
        why = []
        try:
            store = _store()
            if store.check([self._channel.error_key]):
                why.append(store.get(self._channel.error_key).decode())
        except Exception:  # noqa: BLE001 — the message is best effort
            pass
        err = RuntimeError(
            f"sharded serving: operation {name!r} failed"
            + (f" on {why[0]}" if why else f": {e}"))
        e.__traceback__ = None  # its frames may hold the groups
        self._failed = err
        self._quiet.set()
        _leave(self.mesh, self._channel)
        return err

    def _heartbeat(self) -> None:
        while not self._quiet.wait(HEARTBEAT_S / 4):
            with self._lock:
                if self._closed or self._failed is not None:
                    return
                if time.monotonic() - self._last < HEARTBEAT_S:
                    continue
                try:
                    self._channel.send(("noop", (), {}))
                except Exception as e:  # noqa: BLE001 — the next op raises
                    self._fail("noop", e)
                    return
                self._last = time.monotonic()

    def close(self) -> None:
        """End every worker's loop (the engine's shutdown)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._quiet.set()
            if self._failed is None:
                self._channel.send(("stop", (), {}))

    def abort(self) -> None:
        """The scheduler died: leave the world so that no worker waits in
        a collective on this rank."""
        with self._lock:
            if self._failed is None and not self._closed:
                self._failed = RuntimeError("rank 0's scheduler died")
                self._quiet.set()
                _leave(self.mesh, self._channel)


def _forward(name: str):
    def call(self, *args, **kwargs):
        return self._call(name, *args, **kwargs)

    call.__name__ = name
    return call


for _op in ("start", "prefill", "publish", "drop", "decode", "verify",
            "copy_block"):
    setattr(MeshDriver, _op, _forward(_op))


class MeshWorker:
    """What ``build_sharded_engine`` returns on every rank but 0: its
    shards and ``serve``, the loop that replays rank 0's operations."""

    def __init__(self, cfg: ModelConfig, params, device, mesh):
        self.cfg = cfg
        self.params = params
        self.mesh = mesh
        self.device = device
        self.ops = DeviceOps(cfg, params, device, mesh)
        self._channel = _Channel(mesh_lib.global_ranks(mesh))
        self.rebuild_spec: Optional[dict] = None

    def serve(self) -> None:
        """Replay rank 0's operations until its engine shuts down.  An
        operation that raises is written into the world's store for rank
        0, the world is left and the error raised here."""
        if self.device.index is not None:  # else: the current device
            torch.cuda.set_device(self.device)
        with torch.no_grad():
            while True:
                name, args, kwargs = self._channel.recv()
                if name == "stop":
                    return
                if name == "noop":
                    continue
                try:
                    getattr(self.ops, name)(*args, **kwargs)
                except BaseException as e:
                    _store().set(
                        self._channel.error_key,
                        f"rank {dist.get_rank()}: {type(e).__name__}: {e}")
                    # the traceback's frames may hold the groups: free
                    # them before leaving
                    e.__traceback__ = None
                    _leave(self.mesh, self._channel)
                    raise


def build_sharded_engine(cfg: ModelConfig, params,
                         engine_config: Optional[EngineConfig] = None,
                         parallel: Optional[ParallelConfig] = None,
                         devices: Optional[Sequence] = None,
                         metrics: Optional[ServingMetrics] = None,
                         draft_cfg: Optional[ModelConfig] = None,
                         draft_params=None, adapters=None, *, device=None,
                         ranks: Optional[Sequence[int]] = None):
    """One engine over a tp x pp (x fsdp) mesh: every rank of the world
    calls it with the same whole ``params`` (on any device) and keeps its
    blocks in the serving re-layout.  The mesh's first rank gets the
    ``ServingEngine``; every other rank of the mesh a ``MeshWorker`` whose
    ``serve()`` runs until the engine shuts down.  The mesh is the world,
    or the global ``ranks`` in mesh order (a replica of ``build_cluster``),
    and a rank outside them gets None.  This rank's device is
    ``devices[mesh rank]``, else ``device`` (default ``cuda``).

    At pp·tp·fsdp == 1 it returns the plain engine (on ``devices[0]``
    where given).  ``rebuild_spec`` records the call, as JAX's does."""
    parallel = parallel or ParallelConfig()
    spec = dict(cfg=cfg, params=params, engine_config=engine_config,
                parallel=parallel, devices=devices, draft_cfg=draft_cfg,
                draft_params=draft_params, adapters=adapters)
    n_sub = (parallel.pipeline_parallel * parallel.tensor_parallel
             * parallel.fsdp)
    if n_sub == 1:
        eng = ServingEngine(cfg, params, engine_config, metrics=metrics,
                            draft_cfg=draft_cfg, draft_params=draft_params,
                            adapters=adapters,
                            device=devices[0] if devices else device)
        eng.rebuild_spec = spec
        return eng
    from ...utils.tree import tree_map

    if draft_cfg is not None:
        shard_lib.assert_serving_geometry(draft_cfg, parallel,
                                          what="draft model")
    local, mesh = shard_lib.shard_for_serving(params, cfg, parallel.validate(),
                                              ranks=ranks)
    if mesh is None:
        _Channel(ranks)  # made on every rank of the world, in order
        return None
    check_engine_args(cfg, engine_config or EngineConfig(), mesh=mesh,
                      draft_cfg=draft_cfg, adapters=adapters)
    dev = model_lib.default_device(
        devices[mesh.rank] if devices else device)
    local = tree_map(lambda t: t.to(dev), local)
    if mesh.rank != 0:
        worker = MeshWorker(cfg, local, dev, mesh)
        worker.rebuild_spec = spec
        return worker
    eng = ServingEngine(cfg, local, engine_config, metrics=metrics,
                        mesh=mesh, draft_cfg=draft_cfg,
                        draft_params=draft_params, adapters=adapters,
                        device=dev)
    eng.rebuild_spec = spec
    return eng


def build_cluster(cfg: ModelConfig, params,
                  engine_config: Optional[EngineConfig] = None,
                  *, replicas: int = 1,
                  parallel: Optional[ParallelConfig] = None,
                  router_config=None,
                  devices: Optional[Sequence] = None,
                  draft_cfg: Optional[ModelConfig] = None,
                  draft_params=None, adapters=None, device=None):
    """``replicas`` engines of ``parallel``'s pp·tp·fsdp ranks each behind
    one :class:`~.router.Router` (rank 0's); JAX's ``build_cluster``.

    At degree 1 the replicas are engines of this process, replica ``i`` on
    ``devices[i]`` where given, else on ``device`` (default ``cuda``; on
    one card every replica shares it).  Above degree 1 every rank of the
    world calls it with the same whole ``params``: the replicas' meshes
    are ``parallel/mesh.replica_submeshes``'s (rank 0 leads each, the
    router's module docstring says why), replica ``r``'s mesh rank ``j``
    on ``devices[r * n + j]`` where given.  Rank 0 gets the Router; a
    worker rank gets its replica's ``MeshWorker`` (to ``serve()``), and a
    rank in no replica None.

    Replica metrics are built with ``register=False`` so that they do not
    fight over the process's ``"serving"`` collector; the router registers
    one ``"cluster"`` collector over them.  ``adapters`` (the cluster's
    LoRA registries) are item 11 (c)."""
    from .router import Router, RouterConfig

    if adapters is not None:
        raise NotImplementedError(
            "build_cluster(adapters=) is not ported yet (ROADMAP.md, Queue "
            "1 item 11 (c): the cluster's adapters)")
    parallel = parallel or ParallelConfig()
    engine_config = engine_config or EngineConfig()
    n_sub = (parallel.pipeline_parallel * parallel.tensor_parallel
             * parallel.fsdp)
    spec = dict(cfg=cfg, params=params, engine_config=engine_config,
                parallel=parallel, devices=None, draft_cfg=draft_cfg,
                draft_params=draft_params, adapters=adapters)

    def metrics():
        return ServingMetrics(engine_config.max_batch_size, register=False)

    if n_sub == 1:
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if devices is not None and replicas > len(devices):
            raise ValueError(
                f"{replicas} replicas of 1 devices each need {replicas} "
                f"devices, have {len(devices)}")
        engines = []
        for i in range(replicas):
            eng = ServingEngine(
                cfg, params, engine_config, metrics=metrics(),
                draft_cfg=draft_cfg, draft_params=draft_params,
                device=devices[i] if devices else device)
            eng.rebuild_spec = dict(spec, devices=None if devices is None
                                    else [devices[i]])
            engines.append(eng)
        return Router(engines, router_config or RouterConfig())
    if not dist.is_initialized():
        raise ValueError(
            f"{replicas} replicas of {n_sub} ranks run one process a rank, "
            f"{1 + replicas * (n_sub - 1)} in all: launch them under "
            "torchrun (python -m torch.distributed.run --nproc_per_node N "
            "...)")
    lists = mesh_lib.replica_ranks(parallel, replicas,
                                   range(dist.get_world_size()))
    built = []
    for r, ranks in enumerate(lists):
        built.append(build_sharded_engine(
            cfg, params, engine_config, parallel,
            devices=(None if devices is None
                     else list(devices[r * n_sub:(r + 1) * n_sub])),
            metrics=metrics(), draft_cfg=draft_cfg,
            draft_params=draft_params, device=device, ranks=ranks))
    if dist.get_rank() != lists[0][0]:
        return next((b for b in built if b is not None), None)
    return Router(built, router_config or RouterConfig())


def build_disagg_cluster(*args, **kwargs):
    """Disaggregated prefill/decode: ROADMAP.md Queue 1 item 11 (c)."""
    raise NotImplementedError(
        "build_disagg_cluster is not ported yet (ROADMAP.md, Queue 1 item "
        "11 (c): shipments between sharded pools, disaggregation)")
