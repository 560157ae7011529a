"""Where a served request's device time goes, on one CUDA card.

    python3 -m megatron_llm_tpu_torch.serving.profile [--model M]
        [--layers N] [--kv_quant int8] [--weight_quant int8|int4|mixed]
        [--fused_decode] [--spec_draft_len K [--draft tiny|self]]
        [--adapters N [--lora_rank R] [--lora_targets T ...]]

Serves Llama-2-7B (``--model llama2``) or Falcon-7B (``falcon``) widths
(bf16, random weights from a seed, the flash and norm kernels, 4 slots,
64-token KV blocks, the engine's other defaults (prefix cache, span
tracing): the configurations ``chip_smoke.py`` serves; with
``--kv_quant int8`` an int8 KV cache, with ``--weight_quant`` the weights
quantized by that ``ops/quant.py`` preset) through ``ServingEngine`` and
traces two windows with ``torch.profiler`` (CUDA activity only).  Decode
takes the composed per-layer route unless ``--fused_decode`` asks for the
whole-stack kernel (K13, one launch a step); ``--spec_draft_len K`` turns
on speculation (verify steps of K + 1 tokens a slot, through K14 when
fused) with the n-gram drafter, or with ``--draft`` a resident draft
model (``tiny``: the tiny preset, random; ``self``: the target itself)
proposing trees (K14's tree mode).  ``--adapters N`` serves multi-tenant
LoRA: N random adapters of rank ``--lora_rank`` over ``--lora_targets``
(all seven by default), each resident in its own arena slot, the requests
under them in turn, so each step carries the arena (K13/K14 with the
LoRA epilogue when fused).  With speculation the decode requests carry
``spec_force`` and repeated spans, so that every step drafts:

1. **prefill**: the admission of one 1024-token prompt;
2. **decode**: steady batched decode of 4 requests (prompts of 512-1024
   tokens), every slot busy.

For each window it prints the host-clock window, the device's busy time
(the union of its kernel and copy intervals) and idle share, and the
device time by kernel family (the port's kernels, cuBLAS matmuls, the
``copy_`` kernels: layout copies and the casts that quantized weights
cost ``mm`` on every call; memcpys, the largest other kernels), per
prefill or per decode step.  The
profiler slows the host's launches, so where the host bounds the step
the traced window, and with it the idle share, is longer than an
untraced run's; the device times are not.  The traces go to
``build/profile/`` (not kept by git).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..config import falcon_config, llama2_config
from ..models import model as model_lib
from ..models.families import draft_model
from ..ops.lora import LORA_TARGETS, init_lora_adapter
from ..ops.quant import quantize_params
from .adapters import AdapterRegistry
from .engine import EngineConfig, ServingEngine

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_FAMILIES = (("fused_decode_step", ("decode_step_kernel",)),
             ("flash_attention_fwd", ("flash_fwd_kernel",)),
             ("flash_decode", ("flash_decode_kernel",)),
             ("flash_decode_int8", ("flash_decode_int8_kernel",)),
             ("rmsnorm_fwd", ("rms_fwd_kernel",)),
             ("layernorm_fwd", ("ln_fwd_kernel",)),
             ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet")),
             # copy_ kernels: mm's per-call bf16 copies of int8 / int4
             # weights, and layout copies (the dense gather's reshape)
             ("direct_copy", ("direct_copy_kernel",)))
_MODELS = {"llama2": llama2_config, "falcon": falcon_config}


def _family(name: str, cat: str, families=_FAMILIES) -> str:
    if cat != "kernel":
        return cat
    low = name.lower()
    for family, keys in families:
        if any(k in low for k in keys):
            return family
    return "other"


def device_summary(trace: Path, window_s: float, units: int,
                   families=_FAMILIES) -> dict:
    """Busy time, idle share and time by family (``families``: ``(name,
    substrings of kernel names)`` pairs, first match wins) from a chrome
    trace."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy_us, end = 0.0, -np.inf
    for a, b in spans:  # union of intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_family, others = {}, {}
    for e in events:
        fam = _family(e["name"], e["cat"], families)
        by_family[fam] = by_family.get(fam, 0.0) + e["dur"]
        if fam == "other":
            others[e["name"]] = others.get(e["name"], 0.0) + e["dur"]
    top = sorted(others.items(), key=lambda kv: -kv[1])[:6]
    per = 1e3 * units  # us -> ms per unit
    return {
        "window_ms_per_unit": window_s * 1e3 / units,
        "device_busy_ms_per_unit": busy_us / per,
        "device_idle_share": max(0.0, 1.0 - busy_us / (window_s * 1e6)),
        "ms_per_unit_by_family": {k: v / per for k, v in
                                  sorted(by_family.items(),
                                         key=lambda kv: -kv[1])},
        "largest_other_kernels_ms_per_unit": {k[:90]: v / per
                                              for k, v in top},
    }


def random_adapter(cfg, gen: torch.Generator, rank: int,
                   targets=LORA_TARGETS, b_std: float = 0.02):
    """``init_lora_adapter`` with B drawn N(0, b_std^2) from ``gen`` as
    well, so the epilogue moves real numbers (a zero B would serve an
    adapter that changes nothing), as the JAX package's LoRA bench
    makes its adapters."""
    ad = init_lora_adapter(cfg, gen, rank, targets)
    for f in ad.factors.values():
        f["b"].normal_(generator=gen).mul_(b_std)
    return ad


def adapter_registry(cfg, n: int, rank: int, targets=LORA_TARGETS,
                     device=None, seed: int = 0,
                     n_adapters: Optional[int] = None) -> AdapterRegistry:
    """A registry of ``n`` arena slots with ``n_adapters`` (default ``n``)
    random adapters ``t0, t1, ...`` registered (``random_adapter``, drawn
    on ``device`` from ``seed``)."""
    reg = AdapterRegistry(cfg, n, rank, targets, device=device)
    gen = torch.Generator(device=reg.device).manual_seed(seed)
    for i in range(n if n_adapters is None else n_adapters):
        reg.register(f"t{i}", random_adapter(cfg, gen, rank, targets))
    return reg


def _traced(name: str, run):
    """Run ``run()`` under the profiler → (trace path, host seconds,
    whatever ``run`` returned)."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    path = TRACE_DIR / f"{name}.json"
    prof.export_chrome_trace(str(path))
    return path, window_s, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama2", choices=sorted(_MODELS))
    ap.add_argument("--layers", type=int, default=32,
                    help="depth (both 7B models have 32)")
    ap.add_argument("--decode-steps", type=int, default=48)
    ap.add_argument("--kv_quant", default="none", choices=("none", "int8"))
    ap.add_argument("--weight_quant", default=None,
                    choices=("int8", "int4", "mixed"))
    ap.add_argument("--fused_decode", action="store_true",
                    help="decode through the whole-stack kernel")
    ap.add_argument("--spec_draft_len", type=int, default=0,
                    help="draft tokens a slot (0: no speculation)")
    ap.add_argument("--draft", default=None, choices=("tiny", "self"),
                    help="a resident draft model (default: n-gram drafts)")
    ap.add_argument("--adapters", type=int, default=0,
                    help="LoRA adapters, one arena slot each (0: none)")
    ap.add_argument("--lora_rank", type=int, default=32)
    ap.add_argument("--lora_targets", nargs="+", default=list(LORA_TARGETS),
                    choices=LORA_TARGETS)
    args = ap.parse_args(argv)
    if args.draft and not args.spec_draft_len:
        ap.error("--draft needs --spec_draft_len > 0")
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    cfg = _MODELS[args.model]("7b", params_dtype="bfloat16",
                              attention_impl="flash", norm_impl="pallas",
                              fused_decode=args.fused_decode,
                              num_layers=args.layers,
                              kv_cache_quant=args.kv_quant)
    params = model_lib.init_params(cfg, seed=0, device=dev)
    if args.weight_quant:
        params = quantize_params(params, args.weight_quant)
    draft = {}
    if args.draft == "self":
        draft = dict(draft_cfg=cfg, draft_params=params)
    elif args.draft == "tiny":
        dcfg = draft_model("tiny", cfg, params_dtype="bfloat16")
        draft = dict(draft_cfg=dcfg, draft_params=model_lib.init_params(
            dcfg, seed=1, device=dev))
    reg = None
    if args.adapters:
        reg = adapter_registry(cfg, args.adapters, args.lora_rank,
                               args.lora_targets, device=dev)
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch_size=4, max_seq_len=2048, prefill_bucket=64,
        kv_block_size=64, spec_draft_len=args.spec_draft_len,
        adapter_cache_slots=args.adapters), device=dev, adapters=reg,
        **draft)
    rng = np.random.default_rng(0)

    def aid(i):
        return f"t{i % args.adapters}" if args.adapters else None

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    def spec_prompt(n):
        """n tokens of a 64-token span repeated: the n-gram drafter's
        trailing n-gram always has an earlier occurrence."""
        span = prompt(64)
        return (span * (n // 64 + 1))[:n]

    try:
        # warm-up: Triton compile, cuBLAS handles, pinned staging buffers
        for h in engine.submit_many([dict(prompt=prompt(n), max_new_tokens=8,
                                          use_eos_stop=False,
                                          adapter_id=aid(i))
                                     for i, n in enumerate((64, 1024))]):
            h.result(600)

        route = "fused" if args.fused_decode else "composed"
        tag = (f"{args.model}-{args.weight_quant or 'bf16'}-kv{args.kv_quant}"
               f"-{route}-spec{args.spec_draft_len}"
               f"{'-' + args.draft if args.draft else ''}"
               f"{f'-lora{args.adapters}x{args.lora_rank}' if reg else ''}")
        pre_path, pre_s, _ = _traced(f"prefill-{tag}", lambda: engine.submit(
            prompt(1024), 1, use_eos_stop=False,
            adapter_id=aid(0)).result(600))
        report = {"prefill_1024": device_summary(pre_path, pre_s, 1)}

        new = args.decode_steps + 40
        snap0 = engine.metrics.snapshot()
        make = spec_prompt if args.spec_draft_len else prompt
        handles = engine.submit_many([dict(prompt=make(n), max_new_tokens=new,
                                           use_eos_stop=False,
                                           spec_force=args.spec_draft_len > 0,
                                           adapter_id=aid(i))
                                      for i, n in enumerate((512, 640, 768,
                                                             1024))])
        while True:  # all four admitted, decode under way
            snap = engine.metrics.snapshot()
            if snap["admitted"] >= snap0["admitted"] + 4 and \
                    snap["decode_iterations"] >= snap0["decode_iterations"] + 4:
                break
            time.sleep(0.005)

        def decode_window():
            # (verify steps commit several tokens: the requests may end
            # before the window does)
            it0 = engine.metrics.snapshot()["decode_iterations"]
            while engine.metrics.snapshot()["decode_iterations"] \
                    < it0 + args.decode_steps \
                    and not all(h.done() for h in handles):
                time.sleep(0.001)
            return engine.metrics.snapshot()["decode_iterations"] - it0

        m0 = engine.metrics.snapshot()
        dec_path, dec_s, steps = _traced(f"decode-{tag}",
                                         decode_window)
        m1 = engine.metrics.snapshot()
        for h in handles:
            h.result(600)
        report["decode_step_batch4"] = device_summary(dec_path, dec_s, steps)
        report["decode_step_batch4"].update(
            tokens_per_step=(m1["decode_tokens"] - m0["decode_tokens"])
            / max(1, m1["decode_iterations"] - m0["decode_iterations"]),
            verify_steps=m1["spec_steps"] - m0["spec_steps"],
            step_routes=m1["step_routes"])
    finally:
        engine.shutdown()
    print(f"card: {smi}; {args.model}-7b widths, {args.layers} layers, "
          f"bf16, weights {args.weight_quant or 'bf16'}, KV cache "
          f"{args.kv_quant}, {route} decode, spec_draft_len "
          f"{args.spec_draft_len}, draft {args.draft or 'n-gram'}, "
          f"{args.adapters} LoRA adapters of rank {args.lora_rank}; traces "
          f"in {TRACE_DIR}")
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
