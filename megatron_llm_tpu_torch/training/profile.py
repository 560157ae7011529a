"""Where a training step's device time goes, on one CUDA card.

    python3 -m megatron_llm_tpu_torch.training.profile [--model M]
        [--layers N] [--seq S] [--dropout P] [--recompute R]

Builds a step ``chip_smoke.py`` trains (bf16 params with fp32 master
weights and AdamW, the flash-attention and norm kernels, global batch 2 as
two microbatches of 1): ``--model llama2`` Llama-2-7B widths cut to 8
layers at seq 4096 (phase 7), ``falcon`` Falcon-7B widths cut to 8 layers
at seq 2048 (phase 10), ``gpt`` GPT-1.3B at full depth, seq 1024 (phase
11, which sets ``--dropout 0.1``: hidden and attention dropout, the
latter routing attention to the einsum path).  The step gets the base
dropout key ``pretrain`` builds.  It takes one untraced warm-up step and
one timed untraced step, then traces one step with ``torch.profiler``
(CUDA activity only).  It prints the untraced step time, the traced window, the
device's busy time, its idle share of the traced window and of the
untraced step (the profiler slows the host's launches, so where the host
bounds the step the first overstates it), and the device time by kernel
family (the port's kernels, the dropout masks' random numbers, cuBLAS
matmuls, elementwise and reduction kernels, copies) and the largest
kernels by name.  The trace goes to ``build/profile/train-<model>.json``
(not kept by git).  Needs a CUDA device.
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
    falcon_config, gpt_config, llama2_config
from ..models import model as model_lib
from ..ops import dropout as drop
from ..serving.profile import _traced, device_summary
from .step import init_train_state, make_train_step, to_device_batch

_FAMILIES = (("flash_attention_fwd", ("flash_fwd_kernel",)),
             ("flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
             ("flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
             ("rmsnorm_fwd", ("rms_fwd_kernel",)),
             ("rmsnorm_bwd", ("rms_bwd_kernel",)),
             ("layernorm_fwd", ("ln_fwd_kernel",)),
             ("layernorm_bwd", ("ln_bwd_kernel",)),
             ("dropout_rng", ("distribution",)),
             ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet")),
             ("elementwise", ("elementwise",)),
             ("reduce", ("reduce",)))


# model -> (preset, size, layers (None: the preset's), seq, dropout)
_MODELS = {"llama2": (llama2_config, "7b", 8, 4096, 0.0),
           "falcon": (falcon_config, "7b", 8, 2048, 0.0),
           "gpt": (gpt_config, "1.3b", None, 1024, 0.1)}


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
    ap.add_argument("--model", default="llama2",
                    choices=sorted(_MODELS))
    ap.add_argument("--layers", type=int, default=None,
                    help="default: the model's row of _MODELS")
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--dropout", type=float, default=None,
                    help="hidden and attention dropout")
    ap.add_argument("--recompute", default="selective",
                    choices=["none", "selective", "full"])
    args = ap.parse_args(argv)
    preset, size, layers, seq, rate = _MODELS[args.model]
    layers = layers if args.layers is None else args.layers
    seq = seq if args.seq is None else args.seq
    rate = rate if args.dropout is None else args.dropout
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    cfg = RuntimeConfig(
        model=preset(size, **({} if layers is None
                               else {"num_layers": layers}),
                     params_dtype="bfloat16", attention_impl="flash",
                     norm_impl="pallas", recompute=args.recompute,
                     hidden_dropout=rate, attention_dropout=rate),
        optimizer=OptimizerConfig(lr_warmup_iters=2),
        train=TrainConfig(train_iters=10, micro_batch_size=1,
                          global_batch_size=2,
                          seq_length=seq)).validate()
    state = init_train_state(cfg, model_lib.init_params(
        cfg.model, seed=cfg.train.seed, device=dev))
    train_step = make_train_step(cfg, dev)
    base_rng = drop.key(cfg.train.seed)

    def step(state, b):
        return train_step(state, b, base_rng)

    rng = np.random.default_rng(0)

    def batch():
        text = rng.integers(0, cfg.model.vocab_size, (2, 1, seq + 1))
        return to_device_batch({"tokens": text[..., :-1],
                                "labels": text[..., 1:],
                                "loss_mask": np.ones((2, 1, seq),
                                                     np.float32)}, dev)

    state, _ = step(state, batch())  # warm-up: Triton compile, cuBLAS
    b = batch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = step(state, b)
    torch.cuda.synchronize()
    untraced_s = time.perf_counter() - t0
    b = batch()
    path, window_s, (state, metrics) = _traced(f"train-{args.model}",
                                               lambda: step(state, b))
    report = device_summary(path, window_s, 1, _FAMILIES)
    report["largest_kernels_ms"] = _largest_kernels(path)
    report["untraced_step_ms"] = untraced_s * 1e3
    busy_ms = report["device_busy_ms_per_unit"]
    report["untraced_idle_share"] = max(0.0, 1.0 - busy_ms
                                        / report["untraced_step_ms"])
    report["loss"] = float(metrics["loss"])
    print(f"card: {smi}; {args.model}-{size} widths, "
          f"{cfg.model.num_layers} layers, bf16, seq {seq}, 2 microbatches "
          f"of 1, recompute {args.recompute}, dropout {rate}; per train "
          f"step; trace {path}")
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
