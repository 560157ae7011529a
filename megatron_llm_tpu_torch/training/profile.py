"""Where a training step's device time goes, on one CUDA card.

    python3 -m megatron_llm_tpu_torch.training.profile [--layers N]

Builds the step ``chip_smoke.py`` trains (Llama-2-7B widths cut to
``--layers`` layers, bf16 params with fp32 master weights and AdamW,
selective recompute, the flash-attention and RMSNorm kernels, seq 4096,
global batch 2 as two microbatches of 1), takes one untraced warm-up step
and one timed untraced step, then traces one step with ``torch.profiler``
(CUDA activity only).  It prints the untraced step time, the traced
window, the device's busy time and idle share, and the device time by
kernel family (the port's kernels, cuBLAS matmuls, elementwise and
reduction kernels, copies) and the largest kernels by name.  The trace goes
to ``build/profile/train.json`` (not kept by git).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import OptimizerConfig, RuntimeConfig, TrainConfig, \
    llama2_config
from ..models import model as model_lib
from ..serving.profile import _traced, device_summary
from .step import init_train_state, make_train_step, to_device_batch

_FAMILIES = (("flash_attention_fwd", ("flash_fwd_kernel",)),
             ("flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
             ("flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
             ("rmsnorm_fwd", ("rms_fwd_kernel",)),
             ("rmsnorm_bwd", ("rms_bwd_kernel",)),
             ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet")),
             ("elementwise", ("elementwise",)),
             ("reduce", ("reduce",)))


def _largest_kernels(trace, n: int = 12) -> dict:
    """The ``n`` kernel names with the most device time in the trace."""
    by_name: dict = {}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return {name[:100]: us / 1e3 for name, us in top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    cfg = RuntimeConfig(
        model=llama2_config("7b", num_layers=args.layers,
                            params_dtype="bfloat16", attention_impl="flash",
                            norm_impl="pallas", recompute="selective"),
        optimizer=OptimizerConfig(lr_warmup_iters=2),
        train=TrainConfig(train_iters=10, micro_batch_size=1,
                          global_batch_size=2,
                          seq_length=args.seq)).validate()
    state = init_train_state(cfg, model_lib.init_params(
        cfg.model, seed=cfg.train.seed, device=dev))
    step = make_train_step(cfg, dev)
    rng = np.random.default_rng(0)

    def batch():
        text = rng.integers(0, cfg.model.vocab_size, (2, 1, args.seq + 1))
        return to_device_batch({"tokens": text[..., :-1],
                                "labels": text[..., 1:],
                                "loss_mask": np.ones((2, 1, args.seq),
                                                     np.float32)}, dev)

    state, _ = step(state, batch())  # warm-up: Triton compile, cuBLAS
    b = batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, b)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    b = batch()
    path, window_s, (state, metrics) = _traced("train", lambda: step(state, b))
    report = device_summary(path, window_s, 1, _FAMILIES)
    report["largest_kernels_ms"] = _largest_kernels(path)
    report["untraced_step_ms"] = untraced_s * 1e3
    report["loss"] = float(metrics["loss"])
    print(f"card: {smi}; llama2-7b widths, {args.layers} layers, bf16, seq "
          f"{args.seq}, 2 microbatches of 1; per train step; trace {path}")
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
