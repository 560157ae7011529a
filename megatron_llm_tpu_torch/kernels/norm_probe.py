"""Tuning probe for K5 and K7, the one-pass RMSNorm and LayerNorm
backwards, on one NVIDIA GPU: K5's compiled kernel's registers and spills
(Triton's ``n_regs`` and ``n_spills``) and the time of ``rmsnorm_bwd``
(both launches) at hidden 4096, 4544, 8192 and 16384 (4096 rows, bf16);
then ``rmsnorm_bwd`` against ``F.rms_norm``'s backward at Llama-2-7B's
training rows (4096 x 4096), and ``layernorm_bwd`` (K7's pass and column
sum; its registers and spills) against ``F.layer_norm``'s at Falcon-7B's
(2048 x 4544) and GPT-1.3B's (4096 x 2048), each in turns A B B A, the
factor being the A times over the B times::

    python3 -m megatron_llm_tpu_torch.kernels.norm_probe

Kernel times are CUDA events around 20 calls captured in a CUDA graph
(``_timing.cuda_ms``); the library's backward is its forward and backward
between events less its forward (``_timing.event_ms``).
"""

from __future__ import annotations

import subprocess
import sys

import torch
import torch.nn.functional as F

from . import _timing as tm
from . import rmsnorm as rn


def main() -> int:
    if not torch.cuda.is_available():
        print("norm_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = 4096
    for hidden in (4096, 4544, 8192, 16384):
        x, dy = (torch.randn(rows, hidden, generator=gen, device=dev,
                             dtype=torch.bfloat16) for _ in range(2))
        w = (1.0 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
             ).to(torch.bfloat16)
        _, rstd = rn.rmsnorm_fwd(x, w, 1e-5)
        _, _, k = rn.launch_rms_bwd(x, w, rstd, dy)
        ms = tm.cuda_ms(lambda: rn.rmsnorm_bwd(x, w, rstd, dy))
        nbytes = 3 * x.numel() * 2 + 2 * hidden * 2 + rows * 4
        print(f"K5 [rows {rows} h {hidden}]: {getattr(k, 'n_regs', '?')} "
              f"registers, {getattr(k, 'n_spills', '?')} spills; {ms:.4f} "
              f"ms (bound {nbytes / tm.PEAK_BYTES_S * 1e3:.4f}, bytes)")
        del x, dy, w, rstd

    def lib_ms(fwd, inputs, dy):
        with torch.no_grad():
            f = tm.event_ms(fwd, iters=20)
        return tm.event_ms(lambda: torch.autograd.grad(fwd(), inputs, dy),
                           iters=20) - f

    def abba(label, kern, lib):
        t = [kern(), lib(), lib(), kern()]
        print(f"{label}: {t[0]:.4f} {t[3]:.4f} ms; library backward "
              f"{t[1]:.4f} {t[2]:.4f} ms; factor "
              f"{(t[0] + t[3]) / (t[1] + t[2]):.3f}")

    h = 4096
    x, dy = (torch.randn(rows, h, generator=gen, device=dev,
                         dtype=torch.bfloat16) for _ in range(2))
    w = (1.0 + 0.1 * torch.randn(h, generator=gen, device=dev)
         ).to(torch.bfloat16)
    _, rstd = rn.rmsnorm_fwd(x, w, 1e-5)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    abba(f"K5 rmsnorm_bwd [rows {rows} h {h}]",
         lambda: tm.cuda_ms(lambda: rn.rmsnorm_bwd(x, w, rstd, dy)),
         lambda: lib_ms(lambda: F.rms_norm(xr, (h,), wr, 1e-5), (xr, wr),
                        dy))
    for _, n, h in tm.LN_SHAPES:
        x, w, b = tm.ln_inputs(n, h, gen, dev)
        dy = torch.randn(n, h, generator=gen, device=dev,
                         dtype=torch.bfloat16)
        _, mean, rstd = rn.layernorm_fwd(x, w, b, 1e-5)
        xr, wr, br = (t.clone().requires_grad_(True) for t in (x, w, b))
        k = rn.launch_ln_bwd(x, w, mean, rstd, dy)[3]
        abba(f"K7 layernorm_bwd [rows {n} h {h}] "
             f"({getattr(k, 'n_regs', '?')} registers, "
             f"{getattr(k, 'n_spills', '?')} spills)",
             lambda: tm.cuda_ms(lambda: rn.layernorm_bwd(
                 x, w, mean, rstd, dy)),
             lambda: lib_ms(lambda: F.layer_norm(xr, (h,), wr, br, 1e-5),
                            (xr, wr, br), dy))
    return 0


if __name__ == "__main__":
    sys.exit(main())
