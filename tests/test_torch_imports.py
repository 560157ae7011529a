"""The port imports neither JAX nor anything of the JAX package, and its
weight tools need neither ``transformers`` nor ``safetensors``."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import torch

import megatron_llm_tpu_torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    names = ["megatron_llm_tpu_torch"]
    for info in pkgutil.walk_packages(megatron_llm_tpu_torch.__path__,
                                      "megatron_llm_tpu_torch."):
        # the Triton kernel body imports triton, which only the card's
        # machine has; its launcher imports it at the first CUDA launch
        if not info.name.endswith("_triton"):
            names.append(info.name)
    return names


def test_port_imports_no_jax():
    names = _modules()
    assert "megatron_llm_tpu_torch.serving.engine" in names
    assert "megatron_llm_tpu_torch.kernels.flash_decode" in names
    assert "megatron_llm_tpu_torch.kernels.decode_step" in names
    assert "megatron_llm_tpu_torch.serving.profile" in names
    assert "megatron_llm_tpu_torch.training.driver" in names
    assert "megatron_llm_tpu_torch.ops.dropout" in names
    assert "megatron_llm_tpu_torch.ops.quant" in names
    assert "megatron_llm_tpu_torch.finetune" in names
    assert "megatron_llm_tpu_torch.serving.prefix_cache" in names
    assert "megatron_llm_tpu_torch.obs.trace" in names
    assert "megatron_llm_tpu_torch.models.families" in names
    assert "megatron_llm_tpu_torch.ops.lora" in names
    assert "megatron_llm_tpu_torch.serving.adapters" in names
    assert "megatron_llm_tpu_torch.serving.adapters.registry" in names
    assert "megatron_llm_tpu_torch.generation.speculative" in names
    assert "megatron_llm_tpu_torch.tools.text_generation_cli" in names
    for new in ("checkpointing", "metrics", "resilience.io",
                "resilience.chaos", "safetensors_io",
                "tools.hf_interop", "tools.verify_correctness",
                "tools.checkpoint_util", "tools.verify_checkpoint"):
        assert f"megatron_llm_tpu_torch.{new}" in names
    code = (
        "import importlib, json, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "roots = ('jax', 'megatron_llm_tpu', 'orbax', 'transformers', "
        "'safetensors')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_imports_no_jax():
    code = (
        "import json, sys\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('megatron_llm_tpu'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        import pytest

        pytest.skip("this host has a card: the script would run")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:  # the script alone, without the package
            (tmp_path / "chip_smoke.py").write_text(
                (ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
