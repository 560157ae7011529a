"""Decode attention (K8-K11) on one NVIDIA GPU, case by case: the
package's build of ``csrc/flash_decode.cu`` timed beside its bound and one
PyTorch call for the same function, and beside other builds of the
kernels in turns::

    python3 -m megatron_llm_tpu_torch.kernels.decode_attention_probe \
        [--parent DIR] [--variant 'NAME=OLD=>NEW' ...]

Cases (bf16 q and cache, or an int8 cache; head dim 128; max_len 2048;
pools of 64-token blocks, shuffled): the smoke's row (b4, 32 q / 32 kv
heads, fills 1/97/1056/2048) for K8-K11; b4 at 32/8 and 64/8 heads
(Llama-3-8B's and Llama-2-70B's or Code Llama 34B's attention widths) for
K8, K9 and K11; b1 at fill 2048 for K8 and K9.  Each line gives the
kernel's time (``_timing.cuda_ms``, a CUDA graph between events), its
bound (each input byte read once, the output written once, at 3.35 TB/s),
SDPA's time over a bf16 copy of what the kernel reads, and its error
against the kernel's plain version.  With ``--parent DIR`` (another
commit's ``csrc/``, e.g. ``git archive <commit> megatron_llm_tpu_torch/csrc
| tar -x -C build/parent``) each case is timed against that commit's build
in turns A B B A (this build, the parent's, the parent's, this build);
a parent from before the split body (no ``flash_decode_split_cols``) is
called through its own C interface (``_OLD_ARGTYPES``).  Each
``--variant`` builds a copy of the package's source with one text
replaced (e.g. ``'split512=kSplitCols = 256;=>kSplitCols = 512;'``,
``'ring64k=kRingBudget = 98304;=>kRingBudget = 65536;'``) and times it
once between the turns.  Every build goes to ``build/probe/``; the
``-Xptxas -v`` report of the package's source is printed first.  With
``--stamps`` the source is also built with ``-DFD_STAMPS`` (per-block
``%globaltimer`` stamps; the package's build has none) and one launch of
K8 and K9 at the smoke's row and at 64/8 heads is split by block: the
span, the waves of live blocks, and each live block's time from entry to
its first tile, over its walk, in its combine and in its ticket and merge.
``--serve-parent DIR`` (another commit's whole checkout) runs
``chip_smoke.py``'s smoke-serve and quant-serve phases (Llama-2-7B, the
composed decode through K8 / K9) from this checkout and from DIR in turns
A B B A, one process each, and prints their decode tok/s.  The results
also go to ``build/probe/decode_attention_probe.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from . import _timing as tm
from . import build
from . import flash_decode as fd

PROBE_DIR = build.BUILD_DIR.parent / "probe"
OUT = PROBE_DIR / "decode_attention_probe.json"
MAX_LEN, BLOCK, D = 2048, 64, 128
# (label, kernels, b, q heads, kv heads, fills)
CASES = (
    ("smoke row b4 nq32 kv32", ("dense", "int8", "paged", "paged_int8"), 4,
     32, 32, (1, 97, 1056, 2048)),
    ("gqa b4 nq32 kv8", ("dense", "int8", "paged_int8"), 4, 32, 8,
     (1, 97, 1056, 2048)),
    ("gqa b4 nq64 kv8", ("dense", "int8", "paged_int8"), 4, 64, 8,
     (1, 97, 1056, 2048)),
    ("b1 nq32 kv32 fill 2048", ("dense", "int8"), 1, 32, 32, (2048,)),
)
_ENTRY = {"dense": "flash_decode_launch", "int8": "flash_decode_int8_launch",
          "paged": "flash_decode_paged_launch",
          "paged_int8": "flash_decode_paged_int8_launch"}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C interface before the split body (no scratch, tickets or body)
_OLD_ARGTYPES = {
    "flash_decode_launch": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
    "flash_decode_int8_launch": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
    "flash_decode_paged_launch": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    "flash_decode_paged_int8_launch": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
}


def _out(name: str, src: Path, flags=()):
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(build.CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return PROBE_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _extra(name: str, src: Path, flags=()):
    """``build.build_all``'s ``extra`` entry for ``src`` with ``flags``."""
    return (name, src, _out(name, src, flags), tuple(flags))


def _variant(name: str, spec: str) -> tuple:
    """``build.build_all``'s ``extra`` entry for ``--variant NAME=OLD=>NEW``:
    a copy of ``csrc/flash_decode.cu`` in ``build/probe/`` with OLD
    replaced by NEW, built against the package's headers."""
    old, new = spec.split("=>", 1)
    text = (build.CSRC / "flash_decode.cu").read_text()
    if old not in text:
        raise SystemExit(f"--variant {name}: {old!r} not in flash_decode.cu")
    src = PROBE_DIR / f"flash_decode_{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text.replace(old, new))
    return _extra(f"flash_decode_{name}", src, ("-I", str(build.CSRC)))


def _inputs(kind, b, nq, kv, fills, gen, dev):
    """q, the kernel's leaves, tables (paged) and lens of one case."""
    q = torch.randn(b, nq, D, generator=gen, device=dev, dtype=torch.bfloat16)
    lens = torch.tensor(fills, dtype=torch.int32, device=dev)
    n_tbl = MAX_LEN // BLOCK
    if kind.startswith("paged"):
        tables = (1 + torch.randperm(b * n_tbl, generator=gen, device=dev)
                  ).reshape(b, n_tbl).to(torch.int32)
        for i, n in enumerate(fills):
            tables[i, -(-n // BLOCK):] = 0
        shape = (1 + b * n_tbl, kv, BLOCK, D)
    else:
        tables = None
        shape = (b, kv, MAX_LEN, D)
    if kind.endswith("int8"):
        kq = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vq = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        ks, vs = (0.002 + 0.01 * torch.rand(shape[:-1], generator=gen,
                                            device=dev) for _ in range(2))
        leaves = (kq, ks, vq, vs)
    else:
        leaves = tuple(torch.randn(shape, generator=gen, device=dev,
                                   dtype=torch.bfloat16) for _ in range(2))
    return q, leaves, tables, lens


def lib_call(lib, kind, q, leaves, tables, lens):
    """A zero-argument launch of ``kind``'s entry in ``lib`` (any build of
    ``csrc/flash_decode.cu``, before or after the split body) on these
    operands; returns the output."""
    name = _ENTRY[kind]
    fn = getattr(lib, name)
    split = hasattr(lib, "flash_decode_split_cols")
    fn.argtypes = fd._ARGTYPES[name] if split else _OLD_ARGTYPES[name]
    fn.restype = _I
    b, n_heads, d = q.shape
    kv = leaves[0].shape[1]
    if tables is not None:
        block, n_tbl = leaves[0].shape[2], tables.shape[1]
        ptrs = [t.data_ptr() for t in (q, *leaves, lens, tables)]
        shape_args, width = [block, n_tbl], block * n_tbl
    else:
        ptrs = [t.data_ptr() for t in (q, *leaves, lens)]
        shape_args, width = [leaves[0].shape[2]], leaves[0].shape[2]
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(d)
    if split:
        ns = -(-width // lib.flash_decode_split_cols())
        n_part = b * n_heads * ns * (d + 2) if ns > 1 else 0
        part = torch.empty(max(n_part, 1), dtype=torch.float32,
                           device=q.device)
        tickets = torch.zeros(b * kv, dtype=torch.int32, device=q.device)
        body = ctypes.c_int(-1)
        head = ptrs + [out.data_ptr(), part.data_ptr(), tickets.data_ptr()]
        tail = [n_part]
    else:
        head, tail = ptrs + [out.data_ptr()], []

    def run():
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = head + [b, n_heads, kv, *shape_args, d, scale,
                       fd._DTYPE_CODES[q.dtype], *tail, stream]
        if split:
            args.append(ctypes.byref(body))
        build.check(fn(*args), name)
        return out

    run.keep = (part, tickets) if split else ()
    return run


def _bound_and_library(kind, q, leaves, tables, lens, fills):
    """(bound ms, by, SDPA over a bf16 copy of the kernel's operands)."""
    b, nq, d = q.shape
    kv = leaves[0].shape[1]
    fill = float(sum(fills))
    nbytes = 2 * q.numel() * 2 + b * 4
    if kind.endswith("int8"):
        nbytes += 2 * fill * kv * (d + 4)
    else:
        nbytes += 2 * fill * kv * d * 2
    if tables is not None:
        nbytes += sum(-(-n // BLOCK) for n in fills) * 4
    bms, by = tm.bound_ms(nbytes, 4.0 * fill * nq * d)
    if kind.endswith("int8"):
        kd, vd = ((c.float() * s[..., None]).to(torch.bfloat16)
                  for c, s in ((leaves[0], leaves[1]),
                               (leaves[2], leaves[3])))
    else:
        kd, vd = leaves
    if tables is not None:
        kd, vd = (fd.gather_blocks(t, tables).contiguous() for t in (kd, vd))
    width = kd.shape[2]
    mask = (torch.arange(width, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    lib_ms = tm.cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=nq != kv))
    return bms, by, lib_ms


def _plain(kind, q, leaves, tables, lens):
    if kind == "dense":
        return fd.flash_decode_plain(q, *leaves, lens)
    if kind == "int8":
        return fd.flash_decode_int8_plain(q, *leaves, lens)
    if kind == "paged":
        return fd.flash_decode_paged_plain(q, *leaves, tables, lens)
    return fd.flash_decode_paged_int8_plain(q, *leaves, tables, lens)


def stamp_split(lib, kind, q, leaves, tables, lens) -> dict:
    """One stamped launch of ``kind`` from ``lib`` (a ``-DFD_STAMPS``
    build): microseconds by block (medians and maxima over the live
    blocks), the span, and the live blocks' entry offsets (the waves)."""
    run = lib_call(lib, kind, q, leaves, tables, lens)
    for _ in range(3):
        run()
    b = q.shape[0]
    kv = leaves[0].shape[1]
    width = leaves[0].shape[2] * (1 if tables is None else tables.shape[1])
    grid = b * kv * -(-width // lib.flash_decode_split_cols())
    buf = torch.zeros(grid, 6, dtype=torch.int64, device=q.device)
    lib.flash_decode_stamps.argtypes = [ctypes.c_void_p]
    lib.flash_decode_stamps(buf.data_ptr())
    run()
    torch.cuda.synchronize()
    lib.flash_decode_stamps(None)
    st = buf.cpu().double()
    t0 = float(st[:, 1].min())
    live = st[:, 2] > 0
    lv = st[live]

    def us(x):
        x = x.sort().values
        return dict(median=float(x[len(x) // 2]) / 1e3,
                    max=float(x[-1]) / 1e3)

    out = {"span_us": float(st[:, 5].max() - t0) / 1e3,
           "blocks": grid, "live": int(live.sum()),
           "sms": len(set(lv[:, 0].long().tolist())),
           "entry_us": us(lv[:, 1] - t0),
           "to_first_tile_us": us(lv[:, 2] - lv[:, 1]),
           "walk_us": us(lv[:, 3] - lv[:, 2]),
           "combine_us": us(lv[:, 4] - lv[:, 3]),
           "ticket_merge_us": us(lv[:, 5] - lv[:, 4]),
           "life_us": us(lv[:, 5] - lv[:, 1]),
           "dead_exit_us": us(st[~live][:, 5] - t0) if (~live).any()
           else None}
    return out


# chip_smoke.py's smoke-serve and quant-serve phases, run from the
# checkout given as the first argument
_SERVE = r"""
import dataclasses, subprocess, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke
from megatron_llm_tpu_torch.config import llama2_config
from megatron_llm_tpu_torch.kernels import _timing, launch_counters
chip_smoke.timing = _timing
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout.strip()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
cfg = llama2_config("7b", params_dtype="bfloat16", attention_impl="flash",
                    norm_impl="pallas", fused_decode=False)
counters = launch_counters()
chip_smoke.serve(torch, cfg, dev, counters, smi, "llama2-7b",
                 ("flash_decode",))
chip_smoke.serve(torch, dataclasses.replace(cfg, kv_cache_quant="int8"), dev,
                 counters, smi, "llama2-7b int8", ("flash_decode_int8",),
                 forbid=("flash_decode",), policy="int8")
"""


def serve_ab(parent: str) -> list:
    """Smoke-serve and quant-serve decode tok/s from this checkout (A) and
    ``parent`` (B), in turns A B B A."""
    here = str(build.CSRC.parents[1])
    rows = []
    for name, root in (("A", here), ("B", parent), ("B", parent),
                       ("A", here)):
        res = subprocess.run([sys.executable, "-c", _SERVE, root], cwd=root,
                             capture_output=True, text=True, timeout=900)
        rates = re.findall(r"^serve (llama2-7b(?: int8)?): .*decode "
                           r"([\d.]+) tok/s", res.stdout, re.M)
        print(f"serve {name} ({root}): rc {res.returncode}; decode tok/s "
              f"{dict(rates)}", flush=True)
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:])
        rows.append(dict(turn=name, root=root, rc=res.returncode,
                         decode_tok_s={k: float(v) for k, v in rates}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="a directory holding another commit's "
                         "flash_decode.cu and its headers, timed in turns "
                         "A B B A")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=OLD=>NEW: the package's source with OLD "
                         "replaced by NEW, timed once a case")
    ap.add_argument("--stamps", action="store_true",
                    help="split one launch of K8 / K9 by block "
                         "(a -DFD_STAMPS build)")
    ap.add_argument("--serve-parent", default=None,
                    help="another commit's whole checkout: smoke-serve and "
                         "quant-serve from both, in turns A B B A")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    src = build.CSRC / "flash_decode.cu"
    extra = [_extra("flash_decode_ptxas", src, ("-Xptxas", "-v"))]
    if args.parent:
        extra.append(_extra("flash_decode_parent",
                            Path(args.parent) / "flash_decode.cu"))
    if args.stamps:
        extra.append(_extra("flash_decode_stamps", src, ("-DFD_STAMPS",)))
    variants = []
    for v in args.variant:
        name, spec = v.split("=", 1)
        variants.append(name)
        extra.append(_variant(name, spec))
    t0 = time.perf_counter()
    logs = build.build_all(("flash_decode",), extra=extra)
    print(f"build: {time.perf_counter() - t0:.1f} s; nvcc seconds "
          f"{ {n: round(s, 1) for n, s in build.NVCC_SECONDS.items()} }")
    build.print_ptxas(logs["flash_decode_ptxas"])
    libs = {e[0]: ctypes.CDLL(str(e[2])) for e in extra[1:]}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    with torch.no_grad():
        for label, kinds, b, nq, kv, fills in CASES:
            for kind in kinds:
                q, leaves, tables, lens = _inputs(kind, b, nq, kv, fills,
                                                  gen, dev)
                wrapper = {"dense": fd.flash_decode,
                           "int8": fd.flash_decode_int8,
                           "paged": fd.flash_decode_paged,
                           "paged_int8": fd.flash_decode_paged_int8}[kind]
                if tables is None:
                    call = lambda: wrapper(q, *leaves, lens)  # noqa: E731
                else:
                    call = lambda: wrapper(  # noqa: E731
                        q, *leaves, tables, lens)
                got = call()
                torch.cuda.synchronize()
                err = (got.float() - _plain(kind, q, leaves, tables, lens)
                       .float()).abs().max().item()
                row = dict(case=label, kernel=wrapper.__name__,
                           max_abs_err=err)
                bms, by, lib_ms = _bound_and_library(kind, q, leaves,
                                                     tables, lens, fills)
                row.update(bound_ms=bms, bound_by=by, sdpa_ms=lib_ms)
                ms = tm.cuda_ms(call)
                line = f"{wrapper.__name__} [{label}]: ms {ms:.4f}"
                if args.parent:
                    old = lib_call(libs["flash_decode_parent"], kind, q,
                                   leaves, tables, lens)
                    row["parent_max_abs_diff"] = (
                        old().float() - got.float()).abs().max().item()
                    t = [ms, tm.cuda_ms(old), tm.cuda_ms(old),
                         tm.cuda_ms(call)]
                    row["abba_ms"] = t
                    line += (f"; A B B A (this build, parent) {t[0]:.4f} "
                             f"{t[1]:.4f} {t[2]:.4f} {t[3]:.4f}")
                for name in variants:
                    var = lib_call(libs[f"flash_decode_{name}"], kind, q,
                                   leaves, tables, lens)
                    row[f"variant_{name}_ms"] = tm.cuda_ms(var)
                    row[f"variant_{name}_max_abs_diff"] = (
                        var().float() - got.float()).abs().max().item()
                    line += f"; {name} {row[f'variant_{name}_ms']:.4f}"
                if args.stamps and kind in ("dense", "int8") \
                        and label != "gqa b4 nq32 kv8":
                    row["stamps"] = stamp_split(
                        libs["flash_decode_stamps"], kind, q, leaves,
                        tables, lens)
                    print(f"stamps {wrapper.__name__} [{label}]: "
                          f"{json.dumps(row['stamps'])}", flush=True)
                row["ms"] = ms
                line += (f"; sdpa {lib_ms:.4f}; bound {bms:.4f} ({by}); "
                         f"max_abs_err {err:.3e}; card {smi}")
                print(line, flush=True)
                results.append(row)
                del q, leaves, tables, lens
                torch.cuda.empty_cache()
    serve = serve_ab(args.serve_parent) if args.serve_parent else None
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({"card": smi, "cases": results,
                               "serve": serve}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
