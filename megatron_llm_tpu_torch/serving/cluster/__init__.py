"""Multi-GPU serving (mirror of ``megatron_llm_tpu/serving/cluster``).

``sharded.build_sharded_engine``: one ``ServingEngine`` over a tp x pp (x
fsdp) mesh of processes, params in the serving re-layout
(``models/sharding.serving_param_specs``), the paged pool split alike
(``kv_pool_specs``), rank 0 driving and the other ranks replaying its
device work (``sharded.py``'s docstring).  The router, replicas and the
disaggregated cluster (``build_cluster``, ``build_disagg_cluster``) are
later slices of ROADMAP.md Queue 1 item 11 and raise.
"""

from .sharded import (  # noqa: F401
    MeshDriver,
    MeshWorker,
    build_cluster,
    build_disagg_cluster,
    build_sharded_engine,
)
