"""Tuning probe for the flash-attention kernels K1 (forward), K2 (dQ) and
K3 (dK/dV) on one NVIDIA GPU: what ``nvcc -Xptxas -v`` reports for their
sources, K1 built at 4 and at 8 warps a block, K2's tensor-core body, K3
with its walk split and unsplit, and SDPA's forward and backward as the
yardsticks, each at the shapes of ``chip_smoke.py`` phase 3, bf16 and
causal; then K2's fp32 CUDA-core body beside its bf16 tensor-core body at
a small shape::

    python3 -m megatron_llm_tpu_torch.kernels.attention_probe

Times are CUDA events around 20 (K2, K3: 5) launches captured in a CUDA
graph, L2-warm (``_timing.cuda_ms``), two versions of a kernel timed
twice each in turns (A B B A); SDPA's backward is its forward and
backward between events less its forward (``_timing.event_ms``).  The
8-warp K1 is a copy of its source with one constant changed, built into
``build/probe/``; nothing here changes what the package builds.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from . import _timing as tm
from . import build
from . import flash_attention as fa

PROBE_DIR = build.BUILD_DIR.parent / "probe"
SHAPES = (("prefill b1 s1024 h32 d128", 1, 1024, 32, 32, 128),
          ("falcon b1 s2048 hq71 hk1 d64", 1, 2048, 71, 1, 64),
          ("train b1 s4096 h32 d128", 1, 4096, 32, 32, 128))


def _nvcc(src: Path, out: Path) -> str:
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v",
           "-I", str(build.CSRC), "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout + res.stderr


def ptxas_report(log: str) -> list:
    """(kernel, registers, spill bytes stored) for each compiled kernel."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), spill))
    return rows


def _demangle(name: str) -> str:
    for key in ("flash_fwd_mma_kernel", "flash_fwd_kernel",
                "flash_bwd_dkv_mma_kernel", "flash_bwd_dkv_kernel",
                "flash_bwd_dq_mma_kernel", "flash_bwd_dq_kernel",
                "dkv_sum_splits_kernel"):
        if key in name:
            t = ("bf16" if "nv_bfloat16" in name else "fp16"
                 if "__half" in name else "fp32")
            d = re.search(r"Li(64|128)E", name)
            return f"{key}<{t}{', d' + d.group(1) if d else ''}>"
    return name


def _variant(name: str, old: str, new: str) -> Path:
    """A copy of ``csrc/<name>.cu`` with one constant changed, in
    ``build/probe/``."""
    text = (build.CSRC / f"{name}.cu").read_text()
    if old not in text:
        raise RuntimeError(f"{name}.cu: {old!r} not found")
    out = PROBE_DIR / f"{name}_{new.split()[2]}_{new.split()[-1][:-1]}.cu"
    out.write_text(text.replace(old, new))
    return out


def sdpa_bwd_ms(qt, kt, vt, do, gqa: bool, iters: int = 5) -> float:
    """SDPA's causal backward (dQ, dK, dV in one call): its forward and
    backward between CUDA events less its forward."""
    qt, kt, vt = (x.detach().requires_grad_(True) for x in (qt, kt, vt))
    dot = do.transpose(1, 2).contiguous()

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=gqa)

    with torch.no_grad():
        f_ms = tm.event_ms(fwd, iters)
    return tm.event_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot),
                       iters) - f_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    w8_src = _variant("flash_attention", "constexpr int kFwdWarps = 4;",
                      "constexpr int kFwdWarps = 8;")
    for name, src in (("flash_attention", build.CSRC / "flash_attention.cu"),
                      ("flash_attention_bwd",
                       build.CSRC / "flash_attention_bwd.cu"),
                      ("flash_attention_w8", w8_src)):
        for kern, regs, spill in ptxas_report(
                _nvcc(src, PROBE_DIR / f"{name}.so")):
            print(f"ptxas {name}: {_demangle(kern)}: {regs} registers, "
                  f"{spill} bytes spilled")
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd8 = ctypes.CDLL(str(PROBE_DIR / "flash_attention_w8.so")
                       ).flash_attention_launch
    fwd8.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, Fl, I, I, P, P]
    fwd8.restype = I

    def k1_w8(q, k, v):
        b, sq, hq, d = q.shape
        o = torch.empty_like(q)
        lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
        build.check(fwd8(q.data_ptr(), k.data_ptr(), v.data_ptr(), None,
                         o.data_ptr(), lse.data_ptr(), b, sq, k.shape[1],
                         hq, k.shape[2], d, float(d ** -0.5), 1, 1,
                         torch.cuda.current_stream().cuda_stream,
                         ctypes.byref(ctypes.c_int(-1))), "w8")
        return o, lse

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, b, s, hq, hk, d in SHAPES:
        q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                                   dtype=torch.bfloat16)
                       for h in (hq, hk, hk, hq))
        w4 = lambda: fa.flash_attention_fwd(q, k, v, causal=True)  # noqa
        w8f = lambda: k1_w8(q, k, v)  # noqa: E731
        o4, lse = w4()
        o8, _ = w8f()
        torch.cuda.synchronize()
        same = torch.equal(o4, o8)
        t = [tm.cuda_ms(f) for f in (w4, w8f, w8f, w4)]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = tm.cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=hq != hk))
        flop = 4.0 * d * hq * b * s * (s + 1) / 2
        print(f"K1 [{name}]: 4 warps {t[0]:.4f} {t[3]:.4f} ms "
              f"({flop / min(t[0], t[3]) / 1e9:.1f} TFLOP/s), 8 warps "
              f"{t[1]:.4f} {t[2]:.4f} ms (O bit for bit equal: {same}); "
              f"SDPA {sdpa:.4f} ms")
        delta = (do.float() * o4.float()).sum(-1).transpose(1, 2).contiguous()
        splits = fa._dkv_splits(b, hk, s, hq // hk, fa._sm_count(dev))
        dflt = lambda: fa.flash_attention_bwd_dkv(  # noqa: E731
            q, k, v, do, lse, delta, causal=True)
        one = lambda: fa.flash_attention_bwd_dkv(  # noqa: E731
            q, k, v, do, lse, delta, causal=True, splits=1)
        t = [tm.cuda_ms(f, 5) for f in (dflt, one, one, dflt)]
        print(f"K3 [{name}]: {splits} split(s) {t[0]:.4f} {t[3]:.4f} ms "
              f"({2 * flop / min(t[0], t[3]) / 1e9:.1f} TFLOP/s), unsplit "
              f"{t[1]:.4f} {t[2]:.4f} ms")
        ms = tm.cuda_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal=True), 5)
        print(f"K2 [{name}]: {ms:.4f} ms "
              f"({1.5 * flop / ms / 1e9:.1f} TFLOP/s); "
              f"SDPA backward {sdpa_bwd_ms(qt, kt, vt, do, hq != hk):.4f} "
              "ms (dQ, dK, dV)")
        del q, k, v, do, qt, kt, vt, o4, o8, lse, delta
        torch.cuda.empty_cache()
    # K2's two bodies on the same values: fp32 (CUDA cores) and bf16
    b, s, h, d = 1, 1024, 8, 128
    x32 = [torch.randn(b, s, h, d, generator=gen, device=dev)
           for _ in range(4)]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (x.to(dtype) for x in x32)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        ms = tm.cuda_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, causal=True), 5)
        print(f"K2 [b{b} s{s} h{h} d{d} {dtype}]: {ms:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
