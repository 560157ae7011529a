"""The port's ``tools/preprocess_data.py`` and ``tools/merge_datasets.py``
against the JAX package's, on the CPU: the same jsonl, tokenizer files
and flags give the same ``.bin`` / ``.idx`` bytes.

The JAX tool runs in this process with one worker; the port's runs here
with one worker and in a subprocess with several (its pool forks, as the
JAX tool's does; a subprocess keeps JAX's threads out of the fork).
"""

import importlib.util
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from megatron_llm_tpu.tools import merge_datasets as jmerge
from megatron_llm_tpu.tools import preprocess_data as jpre
from megatron_llm_tpu_torch.data.indexed_dataset import MMapIndexedDataset
from megatron_llm_tpu_torch.tokenizer.tokenizer import build_tokenizer
from megatron_llm_tpu_torch.tools import merge_datasets as tmerge
from megatron_llm_tpu_torch.tools import preprocess_data as tpre

ROOT = Path(__file__).resolve().parents[1]
WORDS = ["hello", "world", "the", "don't", "123", "x²", "5½", "café", "中",
         ",", ".", "!", "\n", "--", "it's"]


def _jax_tokenizer_tests():
    spec = importlib.util.spec_from_file_location(
        "jax_native_tokenizer_tests",
        ROOT / "tests" / "data" / "test_native_tokenizers.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    _jax_tokenizer_tests()._make_gpt2_files(d)
    rng = random.Random(3)
    with open(d / "text.jsonl", "w", encoding="utf-8") as f:
        for _ in range(70):
            words = [rng.choice(WORDS) for _ in range(rng.randrange(0, 60))]
            f.write(json.dumps({"text": " ".join(words),
                                "title": rng.choice(WORDS)}) + "\n")
    with open(d / "chat.jsonl", "w", encoding="utf-8") as f:
        for i in range(30):
            turns = [{"role": "system", "text": "the world"}] if i % 3 else []
            for _ in range(rng.randrange(1, 4)):
                turns.append({"from": "human", "value": " ".join(
                    rng.choice(WORDS) for _ in range(rng.randrange(1, 9)))})
                turns.append({"role": "assistant", "content": " ".join(
                    rng.choice(WORDS) for _ in range(rng.randrange(1, 9)))})
            key = ("conversation", "messages", "conversations")[i % 3]
            f.write(json.dumps({key: turns}) + "\n")
    return d


def _same_bytes(a: str, b: str):
    for ext in (".bin", ".idx"):
        assert Path(a + ext).read_bytes() == Path(b + ext).read_bytes(), ext


def _flags(corpus, name, extra):
    return ["--input", str(corpus / name), "--tokenizer_type", "gpt2-bpe",
            "--tokenizer_model", str(corpus), *extra]


@pytest.mark.parametrize("extra", [
    [],
    ["--append_eod"],
    ["--append_eod", "--json_keys", "text", "title"],
])
def test_preprocess_text_bytes_equal_jax(corpus, tmp_path, extra):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    jpre.main(_flags(corpus, "text.jsonl", extra) + ["--output_prefix", j])
    stats = tpre.main(_flags(corpus, "text.jsonl", extra)
                      + ["--output_prefix", t])
    keys = ["text", "title"] if "title" in extra else ["text"]
    sfx = (["_document"] if len(keys) == 1
           else [f"_{k}_document" for k in keys])
    for s in sfx:
        _same_bytes(t + s, j + s)
    assert stats["documents"] == 70
    assert stats["tokens"] == int(MMapIndexedDataset(t + sfx[0]).sizes.sum())


def test_preprocess_instruction_bytes_equal_jax(corpus, tmp_path):
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    flags = _flags(corpus, "chat.jsonl", ["--append_eod",
                                          "--instruction_data"])
    jpre.main(flags + ["--output_prefix", j])
    tpre.main(flags + ["--output_prefix", t])
    for s in ("_text_document", "_role_document"):
        _same_bytes(t + s, j + s)
    text = MMapIndexedDataset(t + "_text_document")
    role = MMapIndexedDataset(t + "_role_document")
    assert role.dtype == np.int64 and len(text) == len(role) == 30
    np.testing.assert_array_equal(text.sizes, role.sizes)


def test_preprocess_with_workers_bytes_equal_jax(corpus, tmp_path):
    """Four workers in the port's pool (built by the worker initializer)
    write what one JAX worker writes."""
    j, t = str(tmp_path / "jax"), str(tmp_path / "port")
    flags = _flags(corpus, "text.jsonl", ["--append_eod"])
    jpre.main(flags + ["--output_prefix", j])
    out = subprocess.run(
        [sys.executable, "-m", "megatron_llm_tpu_torch.tools.preprocess_data",
         *flags, "--output_prefix", t, "--workers", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    _same_bytes(t + "_document", j + "_document")
    # and the documents decode to their text
    tok = build_tokenizer("gpt2-bpe", str(corpus))
    ds = MMapIndexedDataset(t + "_document")
    lines = (corpus / "text.jsonl").read_text(encoding="utf-8").splitlines()
    for i in (0, 5, 69):
        ids = ds[i].tolist()
        assert ids[-1] == tok.eod
        assert tok.detokenize(ids[:-1]) == json.loads(lines[i])["text"]


def test_merge_datasets_bytes_equal_jax(corpus, tmp_path):
    parts = []
    for k in range(3):
        p = str(tmp_path / f"part{k}")
        lines = (corpus / "text.jsonl").read_text().splitlines()
        (tmp_path / f"part{k}.jsonl").write_text(
            "\n".join(lines[k * 20:(k + 1) * 20 + k]) + "\n")
        tpre.main(["--input", str(tmp_path / f"part{k}.jsonl"),
                   "--output_prefix", p, "--tokenizer_type", "gpt2-bpe",
                   "--tokenizer_model", str(corpus), "--append_eod"])
        parts.append(p + "_document")
    j, t = str(tmp_path / "jmerged"), str(tmp_path / "tmerged")
    assert jmerge.main(["--input", *parts, "--output_prefix", j]) == 0
    assert tmerge.main(["--input", *parts, "--output_prefix", t]) == 0
    _same_bytes(t, j)
    assert tmerge.merge(parts, str(tmp_path / "again")) == 20 + 21 + 22
