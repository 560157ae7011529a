"""Launch the REST text-generation server on a checkpoint (mirror of
``megatron_llm_tpu/tools/run_text_generation_server.py``; reference
tools/run_text_generation_server.py).  Usage::

    python -m megatron_llm_tpu_torch.tools.run_text_generation_server \\
        --load /path/to/ckpt --model llama2 --size 7b \\
        --tokenizer_type SentencePieceTokenizer \\
        --tokenizer_model /path/tokenizer.model --port 5000

``--load`` takes a release or a training checkpoint of ``checkpointing.py``
(the parameters alone are read).  ``--use_checkpoint_args`` takes the
model config from the checkpoint instead of ``--model`` / ``--size`` (a
checkpoint cut in depth, or a tiny test model).  ``--port 0`` binds a
free port; the line ``serving on HOST:PORT`` gives the one bound.
``--device`` (default ``cuda``) is where the engine runs.

The engine's flags are JAX's: ``--prefill_chunk N`` admits long prompts
N tokens an iteration between decode steps, ``--host_kv_blocks N`` puts a
pinned host arena of N blocks behind the pool (prefix spill, priority
preemption; requests carry ``"priority"``, default
``--default_priority``), ``--log_json`` streams the structured event log
to stderr, and ``GET /metrics?format=prometheus`` serves the Prometheus
scrape.  What the port does not run is refused by the engine's own
checks (``serving/engine.py:_refuse_unported``) when the server starts:
``--role`` other than ``mixed``.  ``--disagg`` and ``--supervise`` raise
here, naming their slices of ROADMAP Queue 1 item 11.

``--replicas N`` serves N engine replicas behind the health-aware
cluster router (``serving/cluster/router.py``; ``--router`` routes even
one): GET /cluster lists them, and ``--metrics_interval_s`` prints the
router's counters as ``{"cluster_metrics": ...}``.

``--tp N --pp M`` serves one model sharded over N x M ranks
(``serving/cluster/sharded.build_sharded_engine``) under a launcher::

    torchrun --nproc_per_node 2 -m \
        megatron_llm_tpu_torch.tools.run_text_generation_server --tp 2 ...

Every rank loads the checkpoint and keeps its shards; rank 0 serves PUT
/api over the sharded engine, the other ranks replay its device work,
and all of them return when rank 0's server shuts down.  With
``--replicas R`` as well the world is ``1 + R * (N * M - 1)`` ranks:
rank 0 leads every replica behind the router, each replica's other
ranks replay it (``serving/cluster/sharded.build_cluster``).  In a world
that is already joined (``initialize.initialize_distributed``), ``main``
runs on every rank alike.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import threading
import time
from typing import Callable, Optional


def _start_metrics_logger(service, interval_s: float):
    """Daemon thread printing a one-line JSON serving summary every
    ``interval_s``: the operational counters (queue, slots, tokens) and
    the prefix-cache and speculation rates, without scraping GET
    /metrics."""

    def loop():
        while True:
            time.sleep(interval_s)
            snap = service.metrics_snapshot()
            if "router" in snap:
                # cluster mode: the router-shaped snapshot (GET /cluster
                # has the full per-replica view)
                print(json.dumps({"cluster_metrics": snap["router"]}),
                      flush=True)
                continue
            print(json.dumps({"serving_metrics": {
                "completed": snap["completed"],
                "running": snap["running"],
                "queued": snap["queued"],
                "decode_tokens": snap["decode_tokens"],
                "ttft_p50_s": round(snap["ttft"]["p50_s"], 4),
                "prefix_hits": snap["prefix_hits"],
                "prefix_misses": snap["prefix_misses"],
                "prefix_hit_rate": round(snap["prefix_hit_rate"], 4),
                "prefix_blocks": snap["prefix_blocks"],
                "prefix_promotions": snap["prefix_promotions_total"],
                "spec_proposed": snap["spec_proposed"],
                "spec_accepted": snap["spec_accepted"],
                "spec_acceptance_rate": round(
                    snap["spec_acceptance_rate"], 4),
                "accepted_tokens_per_step_mean": round(
                    snap["accepted_tokens_per_step"]["mean"], 3),
                # tiered KV (all zero without --host_kv_blocks)
                "swap_out_blocks": snap["swap_out_blocks_total"],
                "swap_in_blocks": snap["swap_in_blocks_total"],
                "swap_bytes": snap["swap_bytes_total"],
                "preemptions": snap["preemptions_total"],
                "host_blocks_used": snap["host_blocks_used"],
                "host_blocks_free": snap["host_blocks_free"],
            }}), flush=True)

    t = threading.Thread(target=loop, name="serving-metrics-log",
                         daemon=True)
    t.start()
    return t


def get_args(argv=None):
    """``(parser, parsed args)``."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--load", required=True, help="checkpoint directory")
    ap.add_argument("--model", default="llama2",
                    choices=["llama", "llama2", "codellama", "falcon", "gpt"])
    ap.add_argument("--size", default="7b")
    ap.add_argument("--use_checkpoint_args", action="store_true",
                    help="take the model config from the checkpoint "
                         "(ignores --model / --size)")
    ap.add_argument("--tokenizer_type", default="SentencePieceTokenizer")
    ap.add_argument("--tokenizer_model", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=5000,
                    help="0 binds a free port")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (the tests pass "
                         "'cpu')")
    ap.add_argument("--max_batch_size", type=int, default=8,
                    help="KV slots = max concurrent decodes; prompts "
                         "beyond this queue")
    ap.add_argument("--max_tokens_to_generate", type=int, default=1024)
    ap.add_argument("--queue_size", type=int, default=32,
                    help="bounded admission queue depth; beyond it "
                         "requests get 503 + Retry-After")
    ap.add_argument("--max_seq_len", type=int, default=None,
                    help="per-slot cache width (prompt + generation); "
                         "default: the model's max_position_embeddings")
    ap.add_argument("--prefill_bucket", type=int, default=64,
                    help="pad prompt lengths up to a multiple of this "
                         "before the admission prefill")
    ap.add_argument("--prefill_chunk", type=int, default=None,
                    help="chunked prefill admission: at most this many "
                         "prompt tokens an iteration, between decode "
                         "steps; supersedes --prefill_bucket; default off")
    ap.add_argument("--no_pipeline_decode", action="store_true",
                    help="disable the one-step pipelined decode loop")
    ap.add_argument("--prefix_cache_blocks", type=int, default=256,
                    help="automatic prefix caching budget, in blocks")
    ap.add_argument("--no_prefix_cache", action="store_true",
                    help="disable automatic prefix caching")
    ap.add_argument("--kv_block_size", type=int, default=None,
                    help="paged KV cache block size in tokens")
    ap.add_argument("--kv_pool_blocks", type=int, default=None,
                    help="paged KV pool size in blocks")
    ap.add_argument("--host_kv_blocks", type=int, default=0,
                    help="tiered KV: a pinned host arena of this many "
                         "blocks behind the pool (prefix-cache spill, "
                         "priority preemption, oversubscribed admission); "
                         "0 = off")
    ap.add_argument("--default_priority", type=int, default=0,
                    help="QoS class of requests without 'priority' "
                         "(higher is admitted sooner; with "
                         "--host_kv_blocks it may preempt lower classes)")
    ap.add_argument("--metrics_interval_s", type=float, default=60.0,
                    help="print a one-line JSON serving-metrics summary "
                         "this often; 0 disables")
    ap.add_argument("--no_trace", action="store_true",
                    help="disable per-request span tracing (GET /trace)")
    ap.add_argument("--log_json", action="store_true",
                    help="stream the structured JSON event log (request "
                         "lifecycle lines with request_id correlation "
                         "ids) to stderr")
    ap.add_argument("--retry_after_s", type=float, default=1.0,
                    help="Retry-After hint returned with 503 backpressure")
    ap.add_argument("--request_deadline_s", type=float, default=None,
                    help="per-request wall-clock budget")
    ap.add_argument("--drain_timeout_s", type=float, default=30.0,
                    help="on SIGTERM, how long to let in-flight requests "
                         "finish before the listener stops")
    ap.add_argument("--weight_quant", default=None,
                    choices=["int8", "int4", "mixed"],
                    help="weight-only quantization applied after load "
                         "(ops/quant.py precision policies)")
    ap.add_argument("--quant_group_size", type=int, default=None,
                    help="int4 group size for --weight_quant int4/mixed")
    ap.add_argument("--quantize", default=None, choices=["int8"],
                    help="compatibility alias for --weight_quant")
    ap.add_argument("--kv_quant", default=None, choices=["int8"],
                    help="int8 KV cache (ops/kv_quant.py)")
    ap.add_argument("--speculative", default=None, choices=["pld"],
                    help="prompt-lookup speculative decoding for greedy "
                         "requests (generation/speculative.py)")
    ap.add_argument("--draft_len", type=int, default=0,
                    help="engine-side speculative decoding: max draft "
                         "tokens per slot per step; 0 = off")
    ap.add_argument("--spec_ngram", type=int, default=3,
                    help="trailing n-gram length the drafter matches on")
    ap.add_argument("--draft_model", default=None,
                    help="resident draft model preset (config.PRESETS, "
                         "e.g. 'tiny') for tree speculation; needs "
                         "--draft_len > 0")
    ap.add_argument("--draft_load", default=None,
                    help="checkpoint directory for --draft_model")
    ap.add_argument("--allow_random_draft", action="store_true",
                    help="allow --draft_model without --draft_load (a "
                         "random draft: tokens stay correct, acceptance "
                         "near zero)")
    ap.add_argument("--spec_reprobe_interval", type=int, default=None,
                    help="decode steps between speculation re-probes")
    ap.add_argument("--no_spec", action="store_true",
                    help="force engine-side speculative decoding off")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel shards of the sharded engine "
                         "(one rank each, under torchrun)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages of the sharded engine (one "
                         "rank each, under torchrun)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas on disjoint pp·tp device slices "
                         "behind the health-aware cluster router "
                         "(serving/cluster/; docs/serving.md 'Multi-chip "
                         "serving'): least-loaded dispatch, sticky streams, "
                         "drain-based failover.  Needs replicas x tp x pp "
                         "<= visible devices")
    ap.add_argument("--router", action="store_true",
                    help="route through the cluster router even with a "
                         "single replica (uniform ops surface: GET "
                         "/cluster, per-replica drain); implied by "
                         "--replicas > 1")
    ap.add_argument("--disagg", default=None, metavar="N:M",
                    help="disaggregated prefill/decode (not ported: "
                         "refused)")
    ap.add_argument("--role", default="mixed",
                    choices=["prefill", "decode", "mixed"],
                    help="engine role (only 'mixed' is ported)")
    ap.add_argument("--supervise", action="store_true",
                    help="cluster self-healing (not ported: refused)")
    ap.add_argument("--hang_timeout_s", type=float, default=10.0,
                    help="hung-step watchdog of --supervise")
    return ap, ap.parse_args(argv)


def build_server(args, ap):
    """The ``MegatronServer`` of parsed ``args``, its engine created (so
    an option the port refuses raises here, before the listener binds)."""
    from .. import checkpointing
    from .. import config as config_lib
    from ..generation.server import MegatronServer
    from ..models import families
    from ..models import model as model_lib
    from ..tokenizer.tokenizer import build_tokenizer

    if args.disagg is not None:
        raise NotImplementedError(
            "--disagg (shipments between sharded pools) is not ported yet "
            "(ROADMAP.md, Queue 1 item 11 (c))")
    if args.supervise:
        raise NotImplementedError(
            "--supervise (the cluster's supervisor) is not ported yet "
            "(ROADMAP.md, Queue 1 item 11 (d))")
    sharded = args.tp * args.pp > 1
    if sharded:
        from .. import initialize

        initialize.initialize_distributed(args.device)
    if args.use_checkpoint_args:
        cfg = checkpointing.load_config_from_checkpoint(args.load).model
    else:
        factory = {"llama": config_lib.llama1_config,
                   "llama2": config_lib.llama2_config,
                   "codellama": config_lib.codellama_config,
                   "falcon": config_lib.falcon_config,
                   "gpt": config_lib.gpt_config}[args.model]
        cfg = factory(args.size)
    if args.kv_quant:
        cfg = dataclasses.replace(cfg,
                                  kv_cache_quant=args.kv_quant).validate()
    tokenizer = build_tokenizer(args.tokenizer_type, args.tokenizer_model)
    params = checkpointing.load_params_for_inference(args.load, cfg,
                                                     device=args.device)
    wq = args.weight_quant or args.quantize
    if wq:
        from ..ops.quant import quantize_params, resolve_policy

        pol = resolve_policy(wq)
        if args.quant_group_size:
            pol = dataclasses.replace(pol, group_size=args.quant_group_size)
        params = quantize_params(params, pol)
        print(f"weights quantized: policy={wq} (attn={pol.attn or 'fp'}, "
              f"mlp={pol.mlp or 'fp'}, embedding={pol.embedding or 'fp'}, "
              f"group_size={pol.group_size})")

    draft_cfg = draft_params = None
    if args.draft_model and not args.no_spec and args.draft_len > 0:
        draft_cfg = families.draft_model(args.draft_model, cfg,
                                         kv_cache_quant=cfg.kv_cache_quant)
        if args.draft_load:
            draft_params = checkpointing.load_params_for_inference(
                args.draft_load, draft_cfg, device=args.device)
        elif args.allow_random_draft:
            draft_params = model_lib.init_params(draft_cfg, seed=0,
                                                 device=args.device)
            print("draft model: no --draft_load given, RANDOM INIT "
                  "(tokens stay correct, acceptance near zero)")
        else:
            ap.error("--draft_model without --draft_load would serve a "
                     "random-init draft; pass --draft_load CKPT, or "
                     "--allow_random_draft for smoke tests")

    if args.log_json:
        import sys

        from ..obs.logging import EVENT_LOG

        EVENT_LOG.configure(stream=sys.stderr)

    prefix_blocks = 0 if args.no_prefix_cache else args.prefix_cache_blocks
    server = MegatronServer(
        cfg, params, tokenizer,
        max_batch_size=args.max_batch_size,
        max_tokens_to_generate=args.max_tokens_to_generate,
        speculative=args.speculative,
        queue_size=args.queue_size,
        engine_max_seq_len=args.max_seq_len,
        retry_after_s=args.retry_after_s,
        request_deadline_s=args.request_deadline_s,
        prefill_bucket=args.prefill_bucket,
        prefill_chunk=args.prefill_chunk,
        pipeline_decode=not args.no_pipeline_decode,
        prefix_cache_blocks=prefix_blocks,
        kv_block_size=args.kv_block_size,
        kv_pool_blocks=args.kv_pool_blocks,
        host_kv_blocks=args.host_kv_blocks,
        default_priority=args.default_priority,
        spec_draft_len=0 if args.no_spec else args.draft_len,
        spec_ngram=args.spec_ngram,
        spec_reprobe_interval=args.spec_reprobe_interval,
        draft_cfg=draft_cfg,
        draft_params=draft_params,
        trace=not args.no_trace,
        replicas=args.replicas,
        router=args.router,
        role=args.role,
        device=args.device)
    cluster = args.replicas > 1 or args.router
    if sharded:
        from ..config import ParallelConfig
        from ..serving.cluster import build_cluster, build_sharded_engine

        par = ParallelConfig(tensor_parallel=args.tp,
                             pipeline_parallel=args.pp)
        if cluster:
            built = build_cluster(
                cfg, params, server.service.engine_config(),
                replicas=args.replicas, parallel=par, device=args.device)
        else:
            built = build_sharded_engine(
                cfg, params, server.service.engine_config(), par,
                device=args.device)
        # each rank keeps its shards alone: the rebuild recipes' whole
        # tree goes (its user, the supervisor, is item 11 (d))
        params = None
        if built is None or hasattr(built, "serve"):
            if built is not None:
                built.rebuild_spec = None
            return built  # a worker rank (or none): main runs its loop
        for eng in ([r.engine for r in built.replicas] if cluster
                    else [built]):
            eng.rebuild_spec = None
        server.service.use_sharded_engine(built)
        print(f"serving layout: tp={args.tp} heads, pp={args.pp} layer "
              "stages (rank 0 of the sharded engine"
              + (f", {args.replicas} replicas behind the router)"
                 if cluster else ")"))
    elif cluster:
        print(f"cluster: {args.replicas} replica(s) x tp=1 pp=1 behind the "
              "router (GET /cluster)")
    try:
        server.service.engine  # created now: refusals raise at launch
    except BaseException:
        server.service.close()
        raise
    return server


def main(argv=None,
         on_ready: Optional[Callable[[object], None]] = None) -> int:
    """Serve until SIGTERM (in the main thread) or until the server is
    shut down; ``on_ready(server)`` is called once the listener is bound
    (a caller that runs ``main`` on a thread stops it with
    ``server.graceful_shutdown()``)."""
    ap, args = get_args(argv)
    server = build_server(args, ap)
    if server is None:
        return 0  # a rank that no replica takes
    if hasattr(server, "serve"):
        server.serve()  # a worker rank of a sharded engine
        return 0
    prefix_blocks = 0 if args.no_prefix_cache else args.prefix_cache_blocks
    print(f"prefix cache: {prefix_blocks} blocks" if prefix_blocks
          else "prefix cache: disabled")
    if args.draft_len and not args.no_spec:
        print(f"speculative decoding: draft_len={args.draft_len} "
              + (f"draft_model={args.draft_model}" if args.draft_model
                 else f"ngram={args.spec_ngram}"))
    print("tracing: " + ("disabled (--no_trace)" if args.no_trace
                         else "on (GET /trace)"))
    if args.metrics_interval_s > 0:
        _start_metrics_logger(server.service, args.metrics_interval_s)
    server.run(args.host, args.port, block=False)
    print(f"serving on {args.host}:{server.port}", flush=True)

    if threading.current_thread() is threading.main_thread():
        # drain off the signal handler's frame: the drain waits on the
        # engine, which this thread must not block
        signal.signal(signal.SIGTERM, lambda signum, frame: threading.Thread(
            target=server.graceful_shutdown, args=(args.drain_timeout_s,),
            daemon=True).start())
    if on_ready is not None:
        on_ready(server)
    while server.serving():
        time.sleep(0.2)
    server.shutdown()
    if args.tp * args.pp > 1:
        server.service.close()  # the sharded engine's ranks stop
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
