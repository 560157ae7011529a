"""Accuracy probe for the flash-attention backward kernels K2 (dQ) and K3
(dK/dV) on one NVIDIA GPU: over several random draws at ``chip_smoke.py``
phase 3's shapes (bf16, N(0, 1) inputs), the elements where the kernel
and its plain version differ by more than phase 3's tolerance (atol 2e-3
+ 2^-6 relative), and each side's error against a float64 backward of
the same bf16 inputs (max and root mean square)::

    python3 -m megatron_llm_tpu_torch.kernels.attention_accuracy_probe [DRAWS]

A kernel as accurate as its plain version shows the same error against
float64; an element past the pairwise tolerance then marks a rounding of
P or dS that went the other way on one side (a sum that cancels), not a
fault of either.  Each draw also counts the elements where the kernel is
further from float64 than the plain version by more than that tolerance
(``f64_rule_violations``, the rule phase 3 holds every K2/K3 case to),
with the first such element's three values.
"""

from __future__ import annotations

import json
import sys

import torch

from . import build
from . import flash_attention as fa

ATOL, RTOL = 2e-3, 2.0 ** -6   # chip_smoke.py phase 3's bf16 tolerance
# (name, b, s, heads, d, segments): packed sequences ("seq", 4 a row),
# the encoders' tail pads ("pad", 0-200 a row, not causal), or none
CASES = (("segments b2 s2048 h32", 2, 2048, 32, 128, "seq"),
         ("train b1 s4096 h32", 1, 4096, 32, 128, None),
         ("encoder b8 s512 h16 d64", 8, 512, 16, 64, "pad"))


def packed_segments(b, s, gen, dev):
    """4 packed sequences per row at random boundaries, int32 [b, s]."""
    cuts = torch.sort(torch.randint(1, s, (b, 3), generator=gen,
                                    device=dev), dim=1).values
    pos = torch.arange(s, device=dev)
    return (pos[None, :, None] >= cuts[:, None, :]).sum(-1).to(
        torch.int32).contiguous()


def pad_segments(b, s, gen, dev, max_pads):
    """The encoders' pad segments, int32 [b, s]: content in segment 1, a
    tail of 0 to ``max_pads`` pads in segment 0 (row 0 without pads)."""
    pads = torch.randint(0, max_pads + 1, (b,), generator=gen, device=dev)
    pads[0] = 0
    pos = torch.arange(s, device=dev)
    return (pos[None, :] < (s - pads)[:, None]).to(torch.int32).contiguous()


def _segments(kind, b, s, gen, dev):
    if kind == "seq":
        return packed_segments(b, s, gen, dev)
    if kind == "pad":
        return pad_segments(b, s, gen, dev, 200)
    return None


def f64_bwd(q, k, v, o, lse, do, causal, seg):
    """The plain backward in float64 (no bf16 rounding of P and dS), a
    batch row at a time."""
    parts = [fa.flash_attention_bwd_plain(
        q[i:i + 1].double(), k[i:i + 1].double(), v[i:i + 1].double(),
        o[i:i + 1].double(), lse[i:i + 1].double(), do[i:i + 1].double(),
        causal=causal, segment_ids=None if seg is None else seg[i:i + 1])
        for i in range(q.shape[0])]
    return [torch.cat([p[j] for p in parts]) for j in range(3)]


@torch.no_grad()
def probe(name, b, s, h, d, kind, seed, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    seg = _segments(kind, b, s, gen, dev)
    causal = kind != "pad"
    kw = dict(causal=causal, segment_ids=seg)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    got = (fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw),
           *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw))
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    truth = f64_bwd(q, k, v, o, lse, do, causal, seg)
    out = {}
    for g_name, g, p, t in zip(("dq", "dk", "dv"), got, plain, truth):
        bad = (g.float() - p.float()).abs() > ATOL + RTOL * p.float().abs()
        rec = {"beyond_tolerance": int(bad.sum()), "of": g.numel(),
               "kernel_vs_f64_max": float((g.double() - t).abs().max()),
               "plain_vs_f64_max": float((p.double() - t).abs().max()),
               "kernel_vs_f64_rms": float((g.double() - t).pow(2).mean()
                                          .sqrt()),
               "plain_vs_f64_rms": float((p.double() - t).pow(2).mean()
                                         .sqrt())}
        if bad.any():
            at = tuple(torch.nonzero(bad)[0].tolist())
            rec["first"] = {"at": list(at), "kernel": float(g[at]),
                            "plain": float(p[at]), "f64": float(t[at])}
        worse = ((g.double() - t).abs() > (p.double() - t).abs() + ATOL
                 + RTOL * t.abs())
        rec["f64_rule_violations"] = int(worse.sum())
        if worse.any():
            at = tuple(torch.nonzero(worse)[0].tolist())
            rec["first_violation"] = {
                "at": list(at), "kernel": float(g[at]), "plain": float(p[at]),
                "f64": float(t[at])}
        out[g_name] = rec
    return out


def main() -> int:
    draws = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    dev = torch.device("cuda", 0)
    build.build_all(names=("flash_attention", "flash_attention_bwd"))
    for case in CASES:
        for seed in range(draws):
            print(case[0], "draw", seed,
                  json.dumps(probe(*case, seed, dev)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
