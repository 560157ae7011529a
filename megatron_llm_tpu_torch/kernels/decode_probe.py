"""Where the fused decode step's time goes, phase by phase, on one NVIDIA
GPU: ``csrc/decode_step.cu`` built with ``-DDECODE_STEP_STAMPS`` (its
per-phase ``%globaltimer`` stamps; the package's own build has none) into
``build/probe/``, launched with the wrappers' own arguments, at the shape
``chip_smoke.py`` phase 3 times: Llama-2-7B, 32 layers, 4 rows, fills
1/97/1056/2044 over a shuffled pool of 64-token blocks, bf16 weights and
cache, and int8 weights and cache; then K14 (a window of 4, 16 rows) and
K13 with a LoRA arena (4 slots x rank 32, every target, rows at slots
-1/0/2/3), bf16::

    python3 -m megatron_llm_tpu_torch.kernels.decode_probe

For each phase of a layer (norm+q/k/v, attention, wo, norm+gate/up,
w_down, and each LoRA x·A phase) it prints the median over the layers of
the slowest block's work time (the phase's entry to the end of the
block's work), the median of the blocks' mean wait in the grid barrier
after it, the bytes the phase streams (its layer weights; the attention
phase the live cache; a LoRA phase its A arenas), and the GB/s those bytes
imply over the slowest block's time; for the bf16 body's GEMV phases also
where a block's time goes (the blocks' mean: waiting for boxes to land,
staging inputs, the products, the grid barrier before the combine, the
combine and epilogues).  Beside it, the package's build of
the same call timed in a CUDA graph (``_timing.cuda_ms``).  With
``--parent DIR`` (another commit's ``csrc/``, e.g. unpacked with ``git
archive``) each case is also timed against that commit's build of the
kernel, in turns A B B A.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import _timing as tm
from . import build
from . import decode_step as ds

PROBE_DIR = build.BUILD_DIR.parent / "probe"
PHASES = ("xa_qkv", "qkv", "attn", "xa_wo", "wo", "xa_gateup", "gateup",
          "xa_down", "down")
STAMP_GRID = 1024          # kStampGrid of csrc/decode_step.cu
STAMP_SLOTS = 8            # kStampSlots
# the bf16 body's GEMV phases: thread 0's time by kind (slots 3-7)
PARTS = ("box_wait", "staging", "products", "barrier", "combine")
FILLS = (1, 97, 1056, 2044)
BLOCK = 64                 # pool block


def _target():
    h = hashlib.sha256((build.CSRC / "decode_step.cu").read_bytes())
    for header in sorted(build.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return PROBE_DIR / f"decode_step_stamps-{h.hexdigest()[:12]}.so"


def stamped_build():
    """``build.build_all``'s ``extra`` entry of the stamped build (its
    ``-Xptxas -v`` report comes back as its output)."""
    return ("decode_step_stamps", build.CSRC / "decode_step.cu", _target(),
            ("-DDECODE_STEP_STAMPS", "-Xptxas", "-v"))


_lib = None


def _stamped():
    global _lib
    if _lib is None:
        if not _target().exists():
            build.build_all((), extra=(stamped_build(),))
        _lib = ctypes.CDLL(str(_target()))
        _lib.decode_step_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_void_p]
        _lib.decode_step_launch.restype = ctypes.c_int
        _lib.decode_step_stamps.argtypes = [ctypes.c_void_p]
        _lib.decode_step_stamps.restype = ctypes.c_int
    return _lib


def _phase_bytes(cfg, stacked, lora) -> dict:
    """Bytes each phase streams a layer: weights (and int8 / int4 scales),
    the attention's live cache, a LoRA phase's A arenas."""
    L = cfg.num_layers

    def wb(grp, name):
        w = stacked[grp][name]
        ts = (w["q"], w["scale"]) if isinstance(w, dict) else (w,)
        return sum(t.numel() * t.element_size() for t in ts) // L

    out = {"qkv": sum(wb("attn", n) for n in ("wq", "wk", "wv")),
           "wo": wb("attn", "wo"),
           "gateup": wb("mlp", "w_gate") + wb("mlp", "w_up"),
           "down": wb("mlp", "w_down")}
    if lora is not None:
        arenas = lora[0]

        def ab(names):
            return sum(arenas[n]["a"][0].numel() * 4 for n in names
                       if n in arenas)

        out.update(xa_qkv=ab(("wq", "wk", "wv")), xa_wo=ab(("wo",)),
                   xa_gateup=ab(("w_gate", "w_up")),
                   xa_down=ab(("w_down",)))
    return out


def phase_split(cfg, stacked, x, kp, vp, tables, fills, rope, lora=None):
    """One stamped launch of K13 (``x`` [b, h]) or K14 (``x`` [S, W, h])
    over the pool ``kp``/``vp``: ``{phase: {work_us, wait_us, bytes,
    gbps}}`` (medians over the layers; see the module's doc)."""
    lib = _stamped()
    L = cfg.num_layers
    W = x.shape[1] if x.dim() == 3 else 1
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if lora is not None and W > 1:
        lora = ds._window_lora(lora, W)
    a, _, keep = ds._prepare("decode_probe", cfg, stacked, x2, kp, vp,
                             torch.as_tensor(tables, device=x.device),
                             ds._fills(fills, x2.shape[0] // W, x.device),
                             W, rope, lora=lora)
    stamps = torch.zeros(L, len(PHASES), STAMP_GRID, STAMP_SLOTS,
                         dtype=torch.int64, device=x.device)
    build.check(lib.decode_step_stamps(stamps.data_ptr()), "stamps")
    cq8 = int(isinstance(kp, dict))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    body = ctypes.c_int(-1)
    for _ in range(2):           # the second launch is the one read
        stamps.zero_()
        build.check(lib.decode_step_launch(
            ctypes.addressof(a), ds._DTYPE_CODES[x.dtype], cq8, stream,
            ctypes.byref(body)), "decode_probe")
    torch.cuda.synchronize()
    build.check(lib.decode_step_stamps(None), "stamps")
    del keep
    st = stamps.cpu()
    grid = int((st[0, 1, :, 0] != 0).sum())
    parts = st[:, :, :grid, 3:].to(torch.float64) / 1e3   # us, summed
    st = st[:, :, :grid, :3]
    ran = st[..., 0] != 0                                 # [L, phase, block]
    st = (st - st[st != 0].min()).to(torch.float64) / 1e3  # us from start
    kv = cfg.kv_heads * cfg.head_dim
    fl = [int(f) for f in torch.as_tensor(fills).reshape(-1)]
    c_item = 1 if cq8 else 2
    nbytes = _phase_bytes(cfg, stacked, lora)
    nbytes["attn"] = 2 * sum(fl) * kv * c_item + (2 * sum(fl) * 4 * (
        kv // cfg.head_dim) if cq8 else 0)
    out = {}
    for p, name in enumerate(PHASES):
        if not bool(ran[:, p].all()):
            continue                                    # phase not run
        work = (st[:, p, :, 1] - st[:, p, :, 0]).max(1).values
        wait = (st[:, p, :, 2] - st[:, p, :, 1]).mean(1)
        w_us = statistics.median(work.tolist())
        out[name] = dict(work_us=round(w_us, 2),
                         wait_us=round(statistics.median(wait.tolist()), 2),
                         bytes=int(nbytes.get(name, 0)),
                         gbps=round(nbytes.get(name, 0) / w_us / 1e3, 1))
        if bool(parts[:, p].any()):      # the TMA body's GEMV phases
            # median over layers of the blocks' mean time in each part
            out[name]["parts_us"] = {
                k: round(statistics.median(parts[:, p, :, j].mean(1)
                                           .tolist()), 2)
                for j, k in enumerate(PARTS)}
    out["layers_us"] = round(float(st[..., 2][ran].max()), 1)
    out["grid"] = grid
    out["body"] = {0: "cuda cores", 2: "tma"}.get(body.value, body.value)
    return out


def kernel_name(mangled: str) -> str:
    """A decode_step kernel instantiation's name for ``build.print_ptxas``
    (the stamped build's report: the package's build is the same code
    without the stamps)."""
    t = "bf16" if "nv_bfloat16" in mangled else "fp32"
    c = "int8" if re.search(r"(13__nv_bfloat16|f)aE", mangled) else t
    return f"decode_step_kernel<{t}, cache {c}>"


def print_split(label: str, split: dict, ms: float, smi: str) -> None:
    print(f"decode_probe {label}: {ms:.4f} ms a call (graph replays), "
          f"stamped launch {split['layers_us']:.1f} us over the layers, "
          f"{split['grid']} blocks, body {split['body']}; card {smi}")
    for name in PHASES:
        if name in split:
            r = split[name]
            print(f"  {name:9s} work {r['work_us']:8.2f} us  barrier wait "
                  f"{r['wait_us']:7.2f} us  {r['bytes'] / 1e6:8.2f} MB  "
                  f"{r['gbps']:7.1f} GB/s"
                  + ("" if "parts_us" not in r else "  blocks' mean us: "
                     + " ".join(f"{k} {v}" for k, v in r["parts_us"].items())))
    print("decode_probe_split " + json.dumps({"case": label, **split}))


# the fields the fused step's launch struct gained with the TMA body (a
# parent build's struct is the rest, in the same order)
_NEW_FIELDS = ("gpart", "gcap")


def parent_call(lib, cfg, st, x, kp, vp, tables, fills, rope, lora=None):
    """A call of K13 (``x`` [b, h]) or K14 (``x`` [S, W, h]) through a build
    of the parent commit's ``decode_step.cu`` (``lib``: its launch struct
    is ``_Args`` without ``_NEW_FIELDS``, its launcher takes no body
    report)."""

    class Parent(ctypes.Structure):
        _fields_ = [f for f in ds._Args._fields_ if f[0] not in _NEW_FIELDS]

    W = x.shape[1] if x.dim() == 3 else 1
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if lora is not None and W > 1:
        lora = ds._window_lora(lora, W)
    a, _, keep = ds._prepare("decode_probe", cfg, st, x2, kp, vp,
                             torch.as_tensor(tables, device=x.device),
                             ds._fills(fills, x2.shape[0] // W, x.device),
                             W, rope, lora=lora)
    pa = Parent()
    for name, _ in Parent._fields_:
        setattr(pa, name, getattr(a, name))
    build.check(lib.decode_step_launch(
        ctypes.addressof(pa), ds._DTYPE_CODES[x.dtype],
        int(isinstance(kp, dict)),
        torch.cuda.current_stream(x.device).cuda_stream), "parent")
    del keep


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a directory holding another commit's "
                         "decode_step.cu and its headers: each case is "
                         "timed against it in turns A B B A (this build, "
                         "the parent's, the parent's, this build)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    from ..config import llama2_config
    from ..models import model as M
    from ..ops import lora as tl
    from ..ops.quant import quantize_params
    from ..serving.profile import random_adapter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    t0 = time.perf_counter()
    extra = [stamped_build()]
    if args.parent:
        src = Path(args.parent) / "decode_step.cu"
        h = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        extra.append(("decode_step_parent", src,
                      PROBE_DIR / f"decode_step_parent-{h}.so", ()))
    logs = build.build_all(("decode_step",), extra=extra)
    build.print_ptxas(logs["decode_step_stamps"], kernel_name)
    print(f"build: {time.perf_counter() - t0:.1f} s; nvcc seconds "
          f"{ {n: round(v, 1) for n, v in build.NVCC_SECONDS.items()} }")
    parent = None
    if args.parent:
        parent = ctypes.CDLL(str(extra[1][2]))
        parent.decode_step_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_void_p]
        parent.decode_step_launch.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b, W = len(FILLS), 4
    fills = torch.tensor(FILLS, device=dev)
    for form in ("bf16", "int8"):
        cfg = llama2_config("7b", params_dtype="bfloat16",
                            kv_cache_quant="int8" if form == "int8"
                            else "none")
        params = M.init_params(cfg, seed=7, device=dev)
        if form == "int8":
            params = quantize_params(params, "int8")
        st = params["layers"]
        rope = M.rope_tables(cfg, device=dev)
        n_tbl = 2048 // BLOCK
        shape = (cfg.num_layers, 1 + b * n_tbl, cfg.kv_heads, BLOCK,
                 cfg.head_dim)
        if form == "int8":
            kp, vp = ({"q": torch.randint(-127, 128, shape, generator=gen,
                                          device=dev, dtype=torch.int8),
                       "scale": 0.002 + 0.01 * torch.rand(
                           shape[:-1], generator=gen, device=dev)}
                      for _ in range(2))
        else:
            kp, vp = (torch.randn(shape, generator=gen, device=dev,
                                  dtype=torch.bfloat16) for _ in range(2))
        tables = (1 + torch.randperm(b * n_tbl, generator=gen, device=dev)
                  ).reshape(b, n_tbl).to(torch.int32)
        x = (0.02 * torch.randn(b, W, cfg.hidden_size, generator=gen,
                                device=dev)).to(torch.bfloat16)
        x0 = x[:, 0].contiguous()
        cases = [(f"K13 {form}", x0, None)]
        if form == "bf16":
            arenas = tl.make_arenas(cfg, 4, 32, tl.LORA_TARGETS, device=dev)
            for s_ in range(4):
                ad = random_adapter(cfg, gen, 32, tl.LORA_TARGETS)
                tl.install_adapter(arenas, ad.factors, s_, ad.scale, 32)
            lora = (arenas, tl.slot_mask(torch.tensor([-1, 0, 2, 3],
                                                      device=dev), 4, 32))
            cases += [("K14 bf16 W4", x, None), ("K13+LoRA bf16", x0, lora)]
        for label, xc, lo in cases:
            if xc.dim() == 3:
                call = lambda: ds.fused_decode_verify_paged(  # noqa: E731
                    cfg, st, xc, kp, vp, tables, fills, rope, lora=lo)
            else:
                call = lambda: ds.fused_decode_step_paged(  # noqa: E731
                    cfg, st, xc, kp, vp, tables, fills, rope, lora=lo)
            ms = tm.cuda_ms(call, iters=5, warmup=2)
            if parent is not None:
                old = lambda: parent_call(  # noqa: E731
                    parent, cfg, st, xc, kp, vp, tables, fills, rope, lo)
                t = [ms, tm.cuda_ms(old, iters=5, warmup=2),
                     tm.cuda_ms(old, iters=5, warmup=2),
                     tm.cuda_ms(call, iters=5, warmup=2)]
                print(f"decode_probe {label} A B B A (this build, parent): "
                      f"{t[0]:.4f} {t[1]:.4f} {t[2]:.4f} {t[3]:.4f} ms; "
                      f"card {smi}")
            split = phase_split(cfg, st, xc, kp, vp, tables, fills, rope,
                                lora=lo)
            print_split(label, split, ms, smi)
        del params, st, kp, vp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
