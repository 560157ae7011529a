"""Logit-level trust harness against a reference model (mirror of
``megatron_llm_tpu/tools/verify_correctness.py``; reference
verify_correctness.py:113-173).

The port's model and the reference run on the same batches; the report
gives the max and mean absolute logit error and the loss delta, and passes
when the average over batches of the per-batch max |Δlogit| is at most
``tolerance`` (1e-3, the reference's fp32 gate).

Library use::

    report = verify(cfg, params, hf_model, batches)

``hf_model`` is any callable of a ``[b, s]`` token tensor that returns an
object with ``.logits`` (a ``transformers`` model) or a logits tensor.
``verify`` runs with TF32 off and ``float32_matmul_precision("highest")``
(the JAX harness's ``default_matmul_precision("highest")``), and restores
the caller's settings on exit.

CLI use (a local HF directory; the reference model needs ``transformers``,
which this module imports inside ``main`` alone)::

    python -m megatron_llm_tpu_torch.tools.verify_correctness \\
        --hf_path /weights/Llama-2-7b-hf --iters 10 --seq_length 512

With ``--load`` the port's weights come from a checkpoint of
``checkpointing.py`` instead of converting the HF weights.  With
``--data_path`` the batches are the tokens of a ``.bin``/``.idx`` dataset
(``data_batches``: documents concatenated and cut into rows, as JAX's CLI
does); without it, random tokens.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from .. import checkpointing
from ..config import ModelConfig
from ..models import model as model_lib
from ..parallel.cross_entropy import cross_entropy
from . import hf_interop
from ..safetensors_io import hf_state_dict

def hf_forward(hf_model, tokens) -> torch.Tensor:
    """The reference's logits ``[b, s, vocab]`` as fp32 on the host."""
    with torch.no_grad():
        out = hf_model(torch.as_tensor(np.asarray(tokens)))
    logits = getattr(out, "logits", out)
    return logits.float().cpu()


def verify_step(cfg: ModelConfig, params, hf_model, tokens) -> dict:
    """One batch → its error statistics (reference verify_step,
    verify_correctness.py:113-128)."""
    tokens = np.asarray(tokens)
    ref = hf_forward(hf_model, tokens)
    device = params["final_norm"]["scale"].device
    with torch.no_grad():
        ours = model_lib.forward(cfg, params,
                                 torch.as_tensor(tokens, device=device))
    ours = ours[..., :cfg.vocab_size].float().cpu()
    abs_err = (ours - ref).abs()
    labels = torch.as_tensor(np.roll(tokens, -1, axis=-1))[:, :-1]
    our_loss = float(cross_entropy(ours[:, :-1], labels,
                                   vocab_size=cfg.vocab_size).mean())
    ref_loss = float(cross_entropy(ref[:, :-1], labels,
                                   vocab_size=cfg.vocab_size).mean())
    return {
        "max_abs_err": float(abs_err.max()),
        "avg_abs_err": float(abs_err.mean()),
        "our_loss": our_loss,
        "hf_loss": ref_loss,
        "loss_delta": abs(our_loss - ref_loss),
    }


def verify(cfg: ModelConfig, params, hf_model,
           batches: Iterable[np.ndarray], tolerance: float = 1e-3) -> dict:
    """Run every batch and aggregate as the reference does (the average of
    the per-batch max); ``passed`` is ``avg(max|Δlogit|) <= tolerance``.

    fp32 matmuls run at full precision: TF32 alone would cost about 1e-3
    of logit error at 7B width and hide a conversion bug behind the
    hardware's rounding."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        steps = [verify_step(cfg, params, hf_model, b) for b in batches]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
    avg_max = float(np.mean([s["max_abs_err"] for s in steps]))
    return {
        "iters": len(steps),
        "avg_max_abs_err": avg_max,
        "max_abs_err": max(s["max_abs_err"] for s in steps),
        "avg_abs_err": float(np.mean([s["avg_abs_err"] for s in steps])),
        "avg_loss_delta": float(np.mean([s["loss_delta"] for s in steps])),
        "tolerance": tolerance,
        "passed": avg_max <= tolerance,
        "steps": steps,
    }


def random_batches(vocab_size: int, iters: int, batch_size: int,
                   seq_length: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size, (batch_size, seq_length))
            for _ in range(iters)]


def data_batches(data_path: str, iters: int, batch_size: int,
                 seq_length: int) -> list:
    """Up to ``iters`` batches ``[batch_size, seq_length]`` of the
    documents of the indexed dataset at ``data_path``, concatenated in
    order and cut into rows (JAX ``_data_batches``)."""
    from ..data.indexed_dataset import MMapIndexedDataset

    ds = MMapIndexedDataset(data_path)
    batches, row, buf = [], [], []
    for i in range(len(ds)):
        buf.extend(np.asarray(ds[i]).tolist())
        while len(buf) >= seq_length:
            row.append(np.asarray(buf[:seq_length]))
            buf = buf[seq_length:]
            if len(row) == batch_size:
                batches.append(np.stack(row))
                row = []
                if len(batches) == iters:
                    return batches
    if not batches:
        raise ValueError(f"not enough data in {data_path} for one batch")
    return batches


def _hf_reference(hf_path: str):
    """The HF reference model, on the host, in eval mode."""
    import transformers

    return transformers.AutoModelForCausalLM.from_pretrained(
        hf_path).eval()


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--hf_path", required=True,
                   help="local HF model directory of the reference")
    p.add_argument("--model_family", default=None,
                   choices=[None, "llama", "falcon", "gpt2"],
                   help="defaults to the HF config's model_type")
    p.add_argument("--load", default=None,
                   help="port checkpoint root; default converts the HF "
                        "weights")
    p.add_argument("--data_path", default=None,
                   help=".bin/.idx prefix for real eval batches "
                        "(default random tokens)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--seq_length", type=int, default=512)
    p.add_argument("--tolerance", type=float, default=1e-3)
    p.add_argument("--device", default="cuda",
                   help="torch device of the port's side (the tests pass "
                        "'cpu')")
    args = p.parse_args(argv)

    hf_cfg = json.loads((Path(args.hf_path) / "config.json").read_text())
    family = args.model_family or hf_cfg["model_type"]
    cfg = hf_interop.config_from_hf(
        hf_cfg, family, params_dtype="float32", attention_impl="dot",
        norm_impl="xla", recompute="none", seq_length=args.seq_length)
    if args.load:
        params = checkpointing.load_params_for_inference(
            args.load, cfg, device=args.device)
    else:
        params = hf_interop.CONVERTERS_FROM_HF[family](
            hf_state_dict(args.hf_path), cfg, device=args.device)

    if args.data_path:
        batches = data_batches(args.data_path, args.iters, args.batch_size,
                               args.seq_length)
    else:
        batches = random_batches(cfg.vocab_size, args.iters,
                                 args.batch_size, args.seq_length)
    report = verify(cfg, params, _hf_reference(args.hf_path), batches,
                    tolerance=args.tolerance)
    steps = report.pop("steps")
    for i, s in enumerate(steps):
        print(f"iter {i}: max|Δ|={s['max_abs_err']:.3e} "
              f"avg|Δ|={s['avg_abs_err']:.3e} "
              f"loss ours={s['our_loss']:.4f} hf={s['hf_loss']:.4f}")
    print(json.dumps(report))
    return 0 if report["passed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
