"""Show that two training runs whose grad norms sum in other groupings
differ only through the clip factor: ``chip_smoke.py``'s phase 55 (ZeRO-1
against the replicated optimizer) and phase 57 (1F1B against
interleaved), both with grad clipping off, through the smoke's own rank
functions (two ranks on one card over gloo)::

    python3 -m megatron_llm_tpu_torch.parallel.clip_order_probe \
        [--layers 2 4] [--device cpu]

Phase 55 runs at each depth of ``--layers`` (it trains unclipped in the
smoke too); phase 57 at the smoke's depth with ``clip_grad = 0`` (the
smoke keeps clipping there).  Prints one JSON line a run: ZeRO-1's worst
per-leaf readings, or 1F1B against interleaved, and the logged grad
norms.  ``--device cpu`` runs at tiny widths in bf16 on the host.  Run it
from a checkout: it imports ``chip_smoke.py`` from the repository root.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _smoke(device: str, layers: int):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    cs.ZERO_LAYERS = layers
    if device == "cpu":
        _tiny(cs)
    return cs


def _tiny(cs):
    """The smoke's Llama-2 cases at tiny bf16 widths, with the card's
    memory and timing calls stubbed."""
    import torch

    from ..config import llama2_config
    from ..kernels import _timing

    def llama(**kw):
        kw.setdefault("num_layers", cs.PAR_LAYERS)
        return llama2_config("7b", hidden_size=256, num_attention_heads=2,
                             ffn_hidden_size=512, vocab_size=512,
                             params_dtype="bfloat16", attention_impl="flash",
                             norm_impl="pallas", recompute="selective", **kw)

    cs._llama_par = llama
    cs.PAR_SEQ = 64
    cs.PAR_NEED = ()
    for name in ("empty_cache", "synchronize", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    _timing.event_ms = lambda fn, iters=5, warmup=2: (fn(), 0.0)[1]


def _rank(rank, world, rdv, out_dir, smi, phase, layers, device):
    import torch

    if device == "cpu":
        torch.set_num_threads(1)
    cs = _smoke(device, layers)
    if phase == "55":
        cases = cs._par_cases
        cs._par_cases = lambda: [c for c in cases() if c[0][:2] == "55"]
        cs._par_rank(rank, world, rdv, out_dir, smi, device=device)
        return
    cases = cs._item10_cases
    cs._item10_cases = lambda: [c for c in cases() if c[0][:2] == "57"]
    par_cfg = cs._par_cfg

    def unclipped(*a, **k):
        cfg = par_cfg(*a, **k)
        return dataclasses.replace(cfg, optimizer=dataclasses.replace(
            cfg.optimizer, clip_grad=0.0))

    cs._par_cfg = unclipped
    cs._item10_rank(rank, world, rdv, out_dir, smi, device=device)


def _spawn(phase, layers, device, smi) -> dict:
    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="clip_order_probe_")
    try:
        mp.start_processes(_rank, args=(2, os.path.join(work, "rdv"), work,
                                        smi, phase, layers, device),
                           nprocs=2, join=True, start_method="spawn")
        with open(os.path.join(work, "rank0.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    smi = "cpu"
    if args.device == "cuda":
        from ..kernels import build

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        build.build_all(names=("flash_attention", "flash_attention_bwd"))
    runs = [("55", n) for n in args.layers] + [("57", None)]
    for phase, layers in runs:
        t0 = time.perf_counter()
        rec = _spawn(phase, layers or 2, args.device, smi)
        for label, r in rec.items():
            print(json.dumps({
                "run": label, "layers": layers, "clip_grad": 0.0,
                "zero1_vs_replicated": r.get("zero1_vs_replicated"),
                "vs_1f1b": r.get("vs_1f1b"), "grad_norms": r["grad_norms"],
                "seconds": time.perf_counter() - t0, "card": smi}),
                flush=True)


if __name__ == "__main__":
    main()
