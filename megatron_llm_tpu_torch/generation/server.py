"""REST text-generation server (mirror of
``megatron_llm_tpu/generation/server.py``).

``PUT /api`` takes the reference's JSON body (``prompts`` plus sampling
knobs) with the same validation and error strings.  Standard generation
goes to the continuous-batching engine and returns ``{"text",
"segments", "logprobs", "request_ids"}``; ``beam_width`` runs
``beam_search`` (``{"text", "segments", "scores"}``) and
``tokens_to_generate=0`` scores the prompts (``{"text", "logprobs"}``),
each one request at a time under a lock, on the one-shot KV-cached path
(``generation/generation.py``).  ``GenerationService(speculative="pld")``
sends eligible requests (greedy, no log-probs) through prompt-lookup
speculation under the same lock and tags each response ``"pld"`` or
``"fallback:<why>"``.  ``GET /metrics`` returns the engine's JSON metrics
snapshot, ``GET /metrics?format=prometheus`` the shared ``obs.REGISTRY``
(serving, SLO and resilience families) in the Prometheus 0.0.4 text
format, ``GET /trace`` the span ring as Chrome trace-event JSON, ``GET
/kv`` the paged pool (and the host tier).  Each answered generation
request leaves an ``http_response`` line in ``obs.logging.EVENT_LOG``
under its ``request_id``.  Built on the stdlib ``ThreadingHTTPServer``.
``draft_cfg``/``draft_params`` give the engine a resident draft model
(tree speculation with ``spec_draft_len > 0``).

Not in this slice, answered with an explicit error naming the ROADMAP
item: the multi-replica / sharded / disaggregated front-ends, and every
engine option the engine refuses (501 with its message).
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..analysis.sanitizers import make_lock
from ..config import ModelConfig
from ..obs.logging import EVENT_LOG
from ..obs.registry import REGISTRY
from ..tokenizer.tokenizer import Tokenizer
from .api import (
    beam_search_and_post_process,
    generate_and_post_process,
    pld_eligible,
    score_and_post_process,
)


class GenerationService:
    """Validates requests and runs generation through the engine; the
    HTTP plumbing is separate so this is directly unit-testable.

    ``device`` (default ``cuda``) is where the engine runs; the params
    must already live there."""

    def __init__(self, cfg: ModelConfig, params, tokenizer: Tokenizer,
                 max_batch_size: int = 8, max_tokens_to_generate: int = 1024,
                 speculative: str | None = None,
                 engine=None, queue_size: int = 32,
                 engine_max_seq_len: int | None = None,
                 retry_after_s: float = 1.0,
                 request_deadline_s: float | None = None,
                 prefill_bucket: int = 1,
                 prefill_chunk: int | None = None,
                 pipeline_decode: bool = True,
                 prefix_cache_blocks: int | None = None,
                 kv_block_size: int | None = None,
                 kv_pool_blocks: int | None = None,
                 host_kv_blocks: int = 0,
                 spec_draft_len: int = 0,
                 spec_ngram: int = 3,
                 spec_reprobe_interval: int | None = None,
                 draft_cfg: ModelConfig | None = None,
                 draft_params=None,
                 default_priority: int = 0,
                 trace: bool = True,
                 tensor_parallel: int = 1,
                 pipeline_parallel: int = 1,
                 replicas: int = 1,
                 router: bool = False,
                 role: str = "mixed",
                 device=None):
        if tensor_parallel * pipeline_parallel * replicas > 1 or router:
            # JAX routes these through build_cluster and its Router; the
            # launch entry serves --tp / --pp over build_sharded_engine
            raise NotImplementedError(
                "MegatronServer(tensor_parallel=, pipeline_parallel=, "
                "replicas=, router=) builds the cluster behind the router, "
                "which is not ported yet (ROADMAP.md, Queue 1 item 11 (b)); "
                "a sharded engine is served by "
                "tools/run_text_generation_server --tp/--pp under torchrun")
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_batch_size = max_batch_size
        self.max_tokens_to_generate = max_tokens_to_generate
        # prompt-lookup speculation (generation/speculative.py) for
        # eligible requests; the response's "speculative" field says which
        # path served each one
        self.speculative = speculative
        self.queue_size = queue_size
        self.engine_max_seq_len = min(
            engine_max_seq_len or cfg.max_position_embeddings,
            cfg.max_position_embeddings)
        self.retry_after_s = retry_after_s
        self.request_deadline_s = request_deadline_s
        self.prefill_bucket = prefill_bucket
        self.prefill_chunk = prefill_chunk
        self.pipeline_decode = pipeline_decode
        self.prefix_cache_blocks = prefix_cache_blocks
        self.kv_block_size = kv_block_size
        self.kv_pool_blocks = kv_pool_blocks
        self.host_kv_blocks = host_kv_blocks
        self.spec_draft_len = spec_draft_len
        self.spec_ngram = spec_ngram
        self.spec_reprobe_interval = spec_reprobe_interval
        self.role = role
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.default_priority = default_priority
        self.trace_enabled = trace
        self.device = device
        self._engine = engine
        # the one-shot paths (beam search, scoring, PLD) run one request
        # at a time
        self.lock = make_lock("server.generate")
        self._engine_init_lock = make_lock("server.engine_init")
        self._draining = False

    def engine_config(self):
        """The ``EngineConfig`` of this service's knobs."""
        from ..serving import EngineConfig

        extra = {}
        if self.prefix_cache_blocks is not None:
            extra["prefix_cache_blocks"] = self.prefix_cache_blocks
        if self.kv_block_size is not None:
            extra["kv_block_size"] = self.kv_block_size
        if self.kv_pool_blocks is not None:
            extra["kv_pool_blocks"] = self.kv_pool_blocks
        if self.host_kv_blocks:
            extra["host_kv_blocks"] = self.host_kv_blocks
        if self.spec_reprobe_interval is not None:
            extra["spec_reprobe_interval"] = self.spec_reprobe_interval
        return EngineConfig(
            max_batch_size=self.max_batch_size,
            max_seq_len=self.engine_max_seq_len,
            max_queue_size=self.queue_size,
            retry_after_s=self.retry_after_s,
            default_deadline_s=self.request_deadline_s,
            prefill_bucket=self.prefill_bucket,
            prefill_chunk=self.prefill_chunk,
            pipeline_decode=self.pipeline_decode,
            spec_draft_len=self.spec_draft_len,
            spec_ngram=self.spec_ngram,
            trace=self.trace_enabled,
            role=self.role,
            **extra)

    @property
    def engine(self):
        """The continuous-batching engine, created on first use."""
        with self._engine_init_lock:
            if self._engine is None:
                from ..serving import ServingEngine

                self._engine = ServingEngine(
                    self.cfg, self.params, self.engine_config(),
                    draft_cfg=self.draft_cfg,
                    draft_params=self.draft_params, device=self.device)
            return self._engine

    def use_sharded_engine(self, engine) -> None:
        """Serve over rank 0's engine of ``build_sharded_engine`` (the
        launch entry's ``--tp`` / ``--pp``).  The whole params are dropped:
        beam search, scoring and prompt-lookup speculation, which run
        them outside the engine, answer 501 (ROADMAP.md, Queue 1 item 11
        (a)'s remainder)."""
        if self.speculative is not None:
            raise NotImplementedError(
                "--speculative pld over a sharded engine is not ported yet "
                "(ROADMAP.md, Queue 1 item 11 (a)'s remainder)")
        with self._engine_init_lock:
            self._engine = engine
            self.params = None

    def metrics_snapshot(self) -> dict:
        """Point-in-time serving metrics (GET /metrics); an engine that was
        never created reports an empty snapshot."""
        with self._engine_init_lock:
            engine = self._engine
        if engine is None:
            from ..serving import ServingMetrics

            # register=False: a throwaway must not displace a live
            # engine's collector in the shared registry
            return ServingMetrics(self.max_batch_size,
                                  register=False).snapshot()
        return engine.metrics.snapshot()

    def prometheus_metrics(self) -> str:
        """The shared ``obs.REGISTRY`` in the Prometheus text format (GET
        /metrics?format=prometheus): serving, SLO and resilience
        metrics from one scrape."""
        # the resilience collector registers when the module is imported
        from .. import metrics as _resilience  # noqa: F401

        return REGISTRY.prometheus_text()

    def trace_snapshot(self) -> dict:
        """Chrome trace-event JSON of the engine's span ring (GET /trace);
        an engine that was never created reports an empty trace."""
        with self._engine_init_lock:
            engine = self._engine
        if engine is None:
            return {"traceEvents": [], "displayTimeUnit": "ms",
                    "otherData": {"dropped_events": 0}}
        return engine.trace.chrome_trace()

    def kv_snapshot(self) -> dict:
        with self._engine_init_lock:
            engine = self._engine
        if engine is None:
            return {"pool": None, "slots": {}}
        return engine.kv_snapshot()

    def drain(self, timeout: float | None = 30.0) -> bool:
        """Stop accepting generation requests and wait for the in-flight
        ones; True once idle."""
        with self._engine_init_lock:
            self._draining = True
            engine = self._engine
        if engine is None:
            return True
        return engine.drain(timeout)

    def close(self) -> None:
        with self._engine_init_lock:
            if self._engine is not None:
                self._engine.shutdown()
                self._engine = None

    def handle(self, body: dict) -> tuple[int, dict | str]:
        """Returns (http_status, response_json_or_error_string); the
        validation and its messages are the JAX server's."""
        if "prompts" not in body:
            return 400, "prompts argument required"
        if "max_len" in body:
            return 400, ("max_len is no longer used.  "
                         "Replace with tokens_to_generate")
        if "sentences" in body:
            return 400, "sentences is no longer used.  Replace with prompts"
        prompts = body["prompts"]
        if not isinstance(prompts, list) or \
                not all(isinstance(p, str) for p in prompts):
            return 400, "prompts is not a list of strings"
        if len(prompts) == 0:
            return 400, "prompts is empty"

        tokens_to_generate = body.get("tokens_to_generate", 64)
        if not isinstance(tokens_to_generate, int) or \
                isinstance(tokens_to_generate, bool):
            return 400, "tokens_to_generate must be an integer greater than 0"
        if tokens_to_generate < 0:
            return 400, ("tokens_to_generate must be an integer greater "
                         "than or equal to 0")
        if tokens_to_generate > self.max_tokens_to_generate:
            return 400, (f"tokens_to_generate must be at most "
                         f"{self.max_tokens_to_generate}")

        logprobs = body.get("logprobs", False)
        if not isinstance(logprobs, bool):
            return 400, "logprobs must be a boolean value"
        if tokens_to_generate == 0 and not logprobs:
            return 400, "tokens_to_generate=0 implies logprobs should be True"

        temperature = body.get("temperature", 1.0)
        if not isinstance(temperature, (int, float)) or \
                not 0.0 < temperature <= 100.0:
            return 400, "temperature must be a positive number less than " \
                        "or equal to 100.0"
        top_k = body.get("top_k", 0)
        if not isinstance(top_k, int) or isinstance(top_k, bool) or \
                not 0 <= top_k <= 1000:
            return 400, "top_k must be an integer equal to or greater " \
                        "than 0 and less than or equal to 1000"
        top_p = body.get("top_p", 0.0)
        if not isinstance(top_p, (int, float)) or not 0.0 <= top_p <= 1.0:
            return 400, "top_p must be less than or equal to 1 and greater " \
                        "than or equal to 0"
        if top_p > 0.0 and top_k > 0:
            return 400, "cannot set both top-k and top-p samplings"

        add_BOS = body.get("add_BOS", False)
        if not isinstance(add_BOS, bool):
            return 400, "add_BOS must be a boolean value"
        if any(len(p) == 0 for p in prompts) and not add_BOS:
            return 400, "Empty prompts require add_BOS=true"

        random_seed = body.get("random_seed", -1)
        if not isinstance(random_seed, int) or isinstance(random_seed, bool):
            return 400, "random_seed must be integer"
        if random_seed < -1:
            return 400, "random_seed must be a positive integer"

        no_early_term = body.get("no_early_termination", False)
        if not isinstance(no_early_term, bool):
            return 400, "no_early_termination must be a boolean value"

        priority = body.get("priority", self.default_priority)
        if not isinstance(priority, int) or isinstance(priority, bool):
            return 400, "priority must be an integer (higher = sooner; " \
                        "may preempt lower classes under tiered KV)"

        beam_width = body.get("beam_width", None)
        if beam_width is not None:
            if not isinstance(beam_width, int) or beam_width < 1:
                return 400, "beam_width must be an integer > 0"
            if len(prompts) > 1:
                return 400, "When doing beam_search, batch size must be 1"
        stop_token = body.get("stop_token", None)
        length_penalty = body.get("length_penalty", 1.0)

        if self.params is None and (beam_width is not None
                                    or tokens_to_generate == 0):
            return 501, ("beam search and scoring over a sharded engine are "
                         "not ported yet (ROADMAP.md, Queue 1 item 11 (a)'s "
                         "remainder)")
        if beam_width is not None:
            with self.lock:
                try:
                    res = beam_search_and_post_process(
                        self.cfg, self.params, self.tokenizer, prompts[0],
                        tokens_to_generate=tokens_to_generate,
                        beam_size=beam_width, stop_token=stop_token,
                        length_penalty=length_penalty,
                        num_return_gen=beam_width, add_BOS=add_BOS,
                        return_segments=True)
                except ValueError as e:
                    return 400, str(e)
            return 200, {"text": res.texts, "segments": res.segments,
                         "scores": res.scores}
        if tokens_to_generate == 0:
            with self.lock:
                try:
                    res = score_and_post_process(
                        self.cfg, self.params, self.tokenizer, prompts)
                except ValueError as e:
                    return 400, str(e)
            return 200, {"text": res.texts, "logprobs": res.logprobs}
        return self._handle_generate(
            prompts, tokens_to_generate, logprobs=logprobs, top_k=top_k,
            top_p=top_p, temperature=temperature, add_BOS=add_BOS,
            use_eos_stop=not no_early_term, random_seed=random_seed,
            priority=priority)

    def _handle_generate(self, prompts, tokens_to_generate, *, logprobs,
                         top_k, top_p, temperature, add_BOS, use_eos_stop,
                         random_seed, priority=0):
        """Standard generation through the engine, with the legacy batch
        contract: every prompt runs to ``max(prompt_len) +
        tokens_to_generate`` tokens."""
        try:
            ids = []
            for p in prompts:
                t = self.tokenizer.tokenize(p)
                if add_BOS and self.tokenizer.bos is not None:
                    t = [self.tokenizer.bos] + t
                if len(t) == 0:
                    raise ValueError(
                        "a prompt tokenized to zero tokens (empty prompt "
                        "with a BOS-less tokenizer?)")
                ids.append(t)
        except ValueError as e:
            return 400, str(e)
        lengths = [len(t) for t in ids]
        total_budget = max(lengths) + tokens_to_generate
        budget = min(self.engine_max_seq_len,
                     self.cfg.max_position_embeddings)
        if total_budget > budget:
            return 400, (f"prompt + tokens_to_generate = {total_budget} "
                         f"exceeds the sequence budget = {budget}")

        spec_tag = None
        if self.speculative == "pld":
            ok, reason = pld_eligible("pld", top_k, top_p, logprobs, lengths)
            if ok:
                # PLD's multi-token verify loop is the one-shot path
                with self.lock:
                    try:
                        res = generate_and_post_process(
                            self.cfg, self.params, self.tokenizer, prompts,
                            tokens_to_generate=tokens_to_generate,
                            return_output_log_probs=logprobs,
                            return_segments=True, top_k_sampling=top_k,
                            top_p_sampling=top_p, temperature=temperature,
                            add_BOS=add_BOS,
                            use_eod_token_for_early_termination=use_eos_stop,
                            random_seed=random_seed, speculative="pld")
                    except ValueError as e:
                        return 400, str(e)
                return 200, {"text": res.texts, "segments": res.segments,
                             "logprobs": res.logprobs,
                             "speculative": res.speculative}
            spec_tag = f"fallback:{reason}"

        from ..serving import QueueFull

        if self._draining:
            return 503, {"message": "server is draining (shutting down); "
                                    "not accepting generation requests",
                         "retry_after": int(math.ceil(self.retry_after_s))}
        specs = [dict(prompt=t, max_new_tokens=total_budget - len(t),
                      eos_id=self.tokenizer.eod, temperature=temperature,
                      top_k=top_k, top_p=top_p,
                      seed=(None if random_seed < 0 else random_seed + i),
                      use_eos_stop=use_eos_stop, return_logprobs=logprobs,
                      priority=priority)
                 for i, t in enumerate(ids)]
        try:
            handles = self.engine.submit_many(specs)
        except QueueFull as e:
            return 503, {"message": str(e),
                         "retry_after": int(math.ceil(e.retry_after_s))}
        except ValueError as e:
            return 400, str(e)
        except NotImplementedError as e:
            # an engine option this slice does not port: the refusal's
            # message names its ROADMAP item
            return 501, str(e)
        rids = [h.rid for h in handles]
        try:
            results = [h.result() for h in handles]
        except RuntimeError as e:
            for rid in rids:
                EVENT_LOG.emit("server", "http_response", request_id=rid,
                               status=500)
            return 500, str(e)
        texts, segments, lps = [], [], []
        for r in results:
            texts.append(self.tokenizer.detokenize(r.tokens))
            segments.append(
                [self.tokenizer.detokenize([t]) for t in r.tokens])
            if logprobs:
                lps.append(r.logprobs)
        resp = {"text": texts, "segments": segments,
                "logprobs": lps if logprobs else None,
                "request_ids": rids}
        if spec_tag is not None:
            # the requested speculative path did not serve these prompts
            resp["speculative"] = spec_tag
        for rid, r in zip(rids, results):
            EVENT_LOG.emit("server", "http_response", request_id=rid,
                           status=200, finish_reason=r.finish_reason)
        return 200, resp


class _Handler(BaseHTTPRequestHandler):
    service: GenerationService  # injected by MegatronServer.run

    def log_message(self, *args):  # quiet by default
        pass

    def _respond(self, status: int, payload, ctype: str | None = None):
        if isinstance(payload, str):
            body = payload.encode()
            ctype = ctype or "text/plain"
        else:
            body = json.dumps(payload).encode()
            ctype = ctype or "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if status == 503 and isinstance(payload, dict) \
                and "retry_after" in payload:
            self.send_header("Retry-After", str(payload["retry_after"]))
        self.end_headers()
        self.wfile.write(body)

    def do_PUT(self):
        if self.path.rstrip("/") != "/api":
            self._respond(404, "not found")
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._respond(400, "invalid JSON body")
            return
        status, payload = self.service.handle(body)
        self._respond(status, payload)

    do_POST = do_PUT

    def do_GET(self):
        url = urlparse(self.path)
        route = url.path.rstrip("/")
        if route == "/metrics":
            if parse_qs(url.query).get("format", ["json"])[0] == \
                    "prometheus":
                self._respond(
                    200, self.service.prometheus_metrics(),
                    ctype="text/plain; version=0.0.4; charset=utf-8")
                return
            self._respond(200, self.service.metrics_snapshot())
            return
        if route == "/kv":
            self._respond(200, self.service.kv_snapshot())
            return
        if route == "/trace":
            # load in chrome://tracing or Perfetto (obs/trace.py)
            self._respond(200, self.service.trace_snapshot())
            return
        self._respond(404, "not found")


class MegatronServer:
    """HTTP front-end: ``run(host, port, block=False)`` serves on a thread;
    ``port`` is the bound port (pass 0 for an ephemeral one)."""

    def __init__(self, cfg: ModelConfig, params, tokenizer: Tokenizer,
                 **service_kw):
        self.service = GenerationService(cfg, params, tokenizer, **service_kw)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def run(self, host: str = "0.0.0.0", port: int = 5000,
            block: bool = True):
        handler = type("Handler", (_Handler,), {"service": self.service})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        if block:
            self._httpd.serve_forever()
        else:
            self._thread = threading.Thread(target=self._httpd.serve_forever,
                                            daemon=True)
            self._thread.start()
        return self._httpd

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def serving(self) -> bool:
        """Whether the listener thread of ``run(block=False)`` is up."""
        t = self._thread
        return t is not None and t.is_alive()

    def graceful_shutdown(self, drain_timeout_s: float = 30.0) -> bool:
        """Drain in-flight generations (new submissions get 503), then stop
        the listener; returns whether the drain completed in time."""
        drained = self.service.drain(drain_timeout_s)
        self.shutdown()
        return drained

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.service.close()
