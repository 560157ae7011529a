"""Multi-GPU serving (mirror of ``megatron_llm_tpu/serving/cluster``).

Two layers (the sharded-worker / replicated-frontend split):

* ``sharded.build_sharded_engine``: one ``ServingEngine`` over a tp x pp
  (x fsdp) mesh of processes, params in the serving re-layout
  (``models/sharding.serving_param_specs``), the paged pool split alike
  (``kv_pool_specs``), the mesh's first rank driving and its other ranks
  replaying the engine's device work (``sharded.py``'s docstring).
* ``router.Router``: least-loaded, health-aware dispatch over engine
  replicas, with sticky keys and drain / kill failover that resubmits the
  unfinished requests with their seeds (``router.py``'s docstring, which
  also says how sharded replicas share the router's process).

``sharded.build_cluster`` composes the two: N replicas
(``parallel/mesh.replica_submeshes``) behind one Router.  The
disaggregated cluster (``build_disagg_cluster``) is ROADMAP.md Queue 1
item 11 (c) and raises; ``ReplicaSupervisor`` / ``SupervisorConfig``,
the self-healing supervisor, are item 11 (d) and absent.
"""

from .router import Router, RouterConfig, RouterHandle  # noqa: F401
from .sharded import (  # noqa: F401
    MeshDriver,
    MeshWorker,
    build_cluster,
    build_disagg_cluster,
    build_sharded_engine,
)
