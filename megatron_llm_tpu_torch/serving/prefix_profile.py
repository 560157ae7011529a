"""What a prefix hit costs and gives, on one CUDA card.

    python3 -m megatron_llm_tpu_torch.serving.prefix_profile [--layers N]

Serves Llama-2-7B widths (bf16, random weights from a seed, the flash and
norm kernels, the fused decode step, 4 slots, 64-token blocks and prefill
bucket) through ``ServingEngine`` on an idle engine and reports, on the
host clock around work that ends in a stream sync:

1. **admissions**: a 1024-token request with one new token, first and
   then repeated, with the prefix cache off (one cold pass) and on (a cold
   run in two pieces split at the last whole block before the last token;
   the repeat a hit of 960 tokens that prefills the last piece only);
2. **pieces**: the cold run's 960-token piece, the 64-token suffix piece
   over a 2048-column view, and a one-pass 1024-token prefill, each alone
   between CUDA events;
3. **logits**: the first-token logits of the hit against the one-pass
   prefill's (what a single cold pass would have given the repeat) and
   against the cold two-piece run's.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import llama2_config
from ..models import model as model_lib
from .engine import EngineConfig, ServingEngine, _Request


def _admissions(dev, cfg, params, pcb: int, rng, n: int = 4):
    """(first, repeat) admission milliseconds of ``n`` fresh prompts."""
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch_size=4, max_seq_len=2048, prefill_bucket=64,
        kv_block_size=64, prefix_cache_blocks=pcb), device=dev)
    engine.start()
    try:
        for _ in range(2):  # warm-up: Triton compile, cuBLAS handles
            engine.submit(rng.integers(0, cfg.vocab_size, 1024).tolist(), 1,
                          use_eos_stop=False).result(600)
        first, repeat = [], []
        for _ in range(n):
            prompt = rng.integers(0, cfg.vocab_size, 1024).tolist()
            for out in (first, repeat):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine.submit(prompt, 1, use_eos_stop=False).result(600)
                out.append((time.perf_counter() - t0) * 1e3)
        return first, repeat, engine
    except Exception:
        engine.shutdown()
        raise


def _event_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(cfg, dev) -> dict:
    """The three reports of the module doc for ``cfg`` on ``dev``."""
    params = model_lib.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    report = {}
    off_first, off_repeat, engine = _admissions(dev, cfg, params, 0, rng)
    engine.shutdown()
    on_first, on_repeat, engine = _admissions(dev, cfg, params, 256, rng)
    report["admission_ms"] = {
        "cache_off": {"first": off_first, "repeat": off_repeat},
        "cache_on": {"first_two_pieces": on_first, "repeat_hit": on_repeat}}
    try:
        prompt = rng.integers(0, cfg.vocab_size, 1024).tolist()
        engine.submit(prompt, 1, use_eos_stop=False).result(600)
        engine.pause()
        while engine._inflight is not None or engine._active:
            time.sleep(0.01)
        with torch.no_grad():
            def fresh():
                return model_lib.init_kv_cache(cfg, 1, 2048, device=dev)

            one_pass = np.asarray([prompt], np.int64)
            report["piece_ms"] = {
                "cold_piece_960": _event_ms(
                    lambda: engine._prefill_piece(prompt[:960], *fresh(), 0)),
                "suffix_piece_64": _event_ms(
                    lambda: engine._prefill_piece(prompt[960:], *fresh(),
                                                  960)),
                "one_pass_1024": _event_ms(
                    lambda: engine._prefill(one_pass, 1024, False))}
            req = _Request(prompt, 1, use_eos_stop=False)
            lease = engine.prefix_cache.match_and_acquire(prompt)
            hit, _, _ = engine._prefill_cached(req, lease)
            engine.prefix_cache.release(lease)
            cold, _, _ = engine._prefill_cached(req, None)
            single, _, _, _ = engine._prefill(one_pass, 1024, False)
    finally:
        engine.shutdown()
    diff = (hit - single).abs()
    top2 = torch.topk(single[0], 2).values
    report["first_token_logits"] = {
        "hit_vs_one_pass_max_abs": float(diff.max()),
        "hit_vs_one_pass_mean_abs": float(diff.mean()),
        "one_pass_std": float(single.std()),
        "one_pass_top2_gap": float(top2[0] - top2[1]),
        "same_argmax": bool(hit.argmax() == single.argmax()),
        "hit_equals_cold_two_pieces": bool(torch.equal(hit, cold))}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prefix_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    cfg = llama2_config("7b", params_dtype="bfloat16",
                        attention_impl="flash", norm_impl="pallas",
                        num_layers=args.layers)
    report = measure(cfg, dev)
    print(f"card: {smi}; llama2-7b widths, {args.layers} layers, bf16, "
          "fused decode, 4 slots, 64-token blocks; host clock with syncs "
          "(admissions), CUDA events (pieces)")
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
