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
  the world; rank 0's pending or next collective then fails at once and
  raises with the worker's message, and rank 0 leaves the world too, so
  no rank waits on a dead peer.

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
    mesh's ranks of its own (its timeout bounds only the wait between
    operations, which the heartbeat keeps short), rank 0 the source.
    Every rank makes it at the same point of its build, in order."""

    def __init__(self, mesh):
        self.seq = next(_ENGINES)
        self.group = dist.new_group(list(range(mesh.world_size)),
                                    backend="gloo", timeout=CHANNEL_TIMEOUT)
        self.error_key = f"sharded_serving/{self.seq}/error"

    def send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=0, group=self.group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def _store():
    return dist.distributed_c10d._get_default_store()


def _leave_world() -> None:
    """Leave the world: every peer's pending collective with this rank
    fails at once rather than waiting out its timeout."""
    if dist.is_initialized():
        dist.destroy_process_group()


class MeshDriver(DeviceOps):
    """Rank 0's seam: each ``DeviceOps`` call is broadcast to the mesh's
    other ranks, then run here (see the module docstring)."""

    def __init__(self, cfg, params, device, mesh):
        super().__init__(cfg, params, device, mesh)
        self._channel = _Channel(mesh)
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
        self._failed = err
        self._quiet.set()
        _leave_world()
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
                _leave_world()


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
        self._channel = _Channel(mesh)
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
                        f"rank {self.mesh.rank}: {type(e).__name__}: {e}")
                    _leave_world()
                    raise


def build_sharded_engine(cfg: ModelConfig, params,
                         engine_config: Optional[EngineConfig] = None,
                         parallel: Optional[ParallelConfig] = None,
                         devices: Optional[Sequence] = None,
                         metrics: Optional[ServingMetrics] = None,
                         draft_cfg: Optional[ModelConfig] = None,
                         draft_params=None, adapters=None, *, device=None):
    """One engine over a tp x pp (x fsdp) mesh: every rank of the world
    calls it with the same whole ``params`` (on any device) and keeps its
    blocks in the serving re-layout.  Rank 0 gets the ``ServingEngine``;
    every other rank a ``MeshWorker`` whose ``serve()`` runs until rank
    0's engine shuts down.  This rank's device is ``devices[rank]``, else
    ``device`` (default ``cuda``).

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
    local, mesh = shard_lib.shard_for_serving(params, cfg, parallel.validate())
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


def build_cluster(*args, **kwargs):
    """Engine replicas behind a router: ROADMAP.md Queue 1 item 11 (b)."""
    raise NotImplementedError(
        "build_cluster (replicas behind the router) is not ported yet "
        "(ROADMAP.md, Queue 1 item 11 (b): the router and replicas)")


def build_disagg_cluster(*args, **kwargs):
    """Disaggregated prefill/decode: ROADMAP.md Queue 1 item 11 (c)."""
    raise NotImplementedError(
        "build_disagg_cluster is not ported yet (ROADMAP.md, Queue 1 item "
        "11 (c): shipments between sharded pools, disaggregation)")
