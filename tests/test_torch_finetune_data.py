"""Training I/O end to end, the port against the JAX package, on the CPU.

A corpus is written as jsonl, tokenized with a byte-level GPT-2 BPE (the
JAX tokenizer tests' vocabulary files) and preprocessed by the port's
tool; both packages then read the same ``.bin`` / ``.idx`` prefixes:

- ``finetune.build_datasets`` gives the same samples (blended, one
  prefix, instruction data);
- three ``pretrain`` steps of a tiny fp32 Llama from JAX's weights on the
  blended data give JAX's losses, at the families test's limits (rel
  1e-5, abs 1e-5);
- the eval step's registry metrics agree to 1e-5;
- a ``profile_dir`` run writes a Chrome trace on the CPU;
- ``tools/run_text_generation_server.main`` on a tiny release checkpoint
  answers a PUT with the JAX server's text.
"""

import importlib.util
import json
import random
import threading
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.generation.server import MegatronServer as JServer
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.tokenizer.tokenizer import build_tokenizer as jbuild
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu_torch import checkpointing
from megatron_llm_tpu_torch import finetune as tfinetune
from megatron_llm_tpu_torch.config import OptimizerConfig as TOpt
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import TrainConfig as TTrain
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.data.samplers import BatchIterator
from megatron_llm_tpu_torch.tools import preprocess_data
from megatron_llm_tpu_torch.tools import run_text_generation_server as rtgs
from megatron_llm_tpu_torch.training import driver as tdriver
from megatron_llm_tpu_torch.training.step import to_device_batch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORDS = ["hello", "world", "the", "don't", "123", "x²", "café", ",", ".",
         "!", "it's", "worlds", "hello world", "the the"]
VOCAB = 272  # the 256 bytes, 15 merges, <|endoftext|>


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    _load("jax_native_tokenizer_tests",
          ROOT / "tests" / "data" / "test_native_tokenizers.py"
          )._make_gpt2_files(d)
    rng = random.Random(5)
    for name, n in (("a", 50), ("b", 40)):
        with open(d / f"{name}.jsonl", "w", encoding="utf-8") as f:
            for _ in range(n):
                f.write(json.dumps({"text": " ".join(
                    rng.choice(WORDS)
                    for _ in range(rng.randrange(3, 30)))}) + "\n")
    with open(d / "chat.jsonl", "w", encoding="utf-8") as f:
        for _ in range(40):
            f.write(json.dumps({"conversation": [
                {"role": "user", "text": " ".join(
                    rng.choice(WORDS) for _ in range(rng.randrange(2, 9)))},
                {"role": "assistant", "text": " ".join(
                    rng.choice(WORDS) for _ in range(rng.randrange(2, 9)))},
            ]}) + "\n")
    for name, extra in (("a", []), ("b", []),
                        ("chat", ["--instruction_data"])):
        preprocess_data.main(["--input", str(d / f"{name}.jsonl"),
                              "--output_prefix", str(d / name),
                              "--tokenizer_type", "gpt2-bpe",
                              "--tokenizer_model", str(d), "--append_eod",
                              *extra])
    return d


def _data_argv(corpus, kind):
    return {
        "blended": ["--data_path", "0.7", str(corpus / "a_document"),
                    "0.3", str(corpus / "b_document"), "--split", "80,10,10"],
        "single": ["--data_path", str(corpus / "a_document"),
                   "--split", "90,5,5"],
        "instruction": ["--instruction_data", "--data_path",
                        str(corpus / "chat"), "--split", "80,10,10",
                        "--scalar_loss_mask", "0.1"],
    }[kind]


def _both_entries():
    return _load("jax_finetune", ROOT / "finetune.py"), tfinetune


@pytest.mark.parametrize("kind", ["blended", "single", "instruction"])
def test_build_datasets_matches_jax(corpus, tmp_path, kind):
    jfin, tfin = _both_entries()
    base = ["--model", "tiny", "--seq_length", "24", "--train_iters", "6",
            "--global_batch_size", "4", "--micro_batch_size", "2",
            "--eval_iters", "2", "--seed", "17", "--dp", "1",
            *_data_argv(corpus, kind)]
    sets = []
    for k, mod in enumerate((jfin, tfin)):
        args = mod.parse_args(base + ["--data_cache_dir",
                                      str(tmp_path / f"cache{k}")])
        sets.append(mod.build_datasets(args, mod.build_config(args)))
    for want, got in zip(*sets):
        assert (want is None) == (got is None)
        if want is None:
            continue
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want) > 0
        for i in range(len(got)):
            a, b = got[i], want[i]
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def _run_cfgs(train_kw):
    model = dict(vocab_size=VOCAB)
    opt = dict(lr=1e-3, min_lr=1e-4, lr_warmup_iters=1, weight_decay=0.1,
               clip_grad=1.0)
    train = dict(dict(train_iters=3, micro_batch_size=2, global_batch_size=4,
                      seq_length=24, log_interval=1, seed=17), **train_kw)
    jc = JRun(model=jtiny(**model), parallel=JPar(), optimizer=JOpt(**opt),
              train=JTrain(**train)).validate()
    tc = TRun(model=ttiny(**model), optimizer=TOpt(**opt),
              train=TTrain(**train)).validate()
    return jc, tc


def _blended(corpus, tmp_path, nums):
    """Each package's train split of the blended corpus."""
    from megatron_llm_tpu.data.blendable_dataset import \
        BlendableDataset as JBlend
    from megatron_llm_tpu.data.gpt_dataset import build_gpt_datasets as jgpt
    from megatron_llm_tpu_torch.data.blendable_dataset import \
        BlendableDataset as TBlend
    from megatron_llm_tpu_torch.data.gpt_dataset import \
        build_gpt_datasets as tgpt

    out = []
    for k, (gpt, blend) in enumerate(((jgpt, JBlend), (tgpt, TBlend))):
        parts = [gpt(str(corpus / p), "80,10,10", nums, 24, 17,
                     str(tmp_path / f"c{k}"))[0]
                 for p in ("a_document", "b_document")]
        out.append(blend(parts, [0.7, 0.3], nums[0]))
    return out


def test_pretrain_on_blended_indexed_data_matches_jax(corpus, tmp_path,
                                                      capsys):
    jc, tc = _run_cfgs({})
    jtrain, ttrain = _blended(corpus, tmp_path, [12, 4, 4])
    jp = jm.init_params(jax.random.key(0), jc.model)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    eod = jbuild("gpt2-bpe", str(corpus)).eod
    capsys.readouterr()
    jdriver.pretrain(jc, jtrain, params=jp, eod_token=eod)
    jlosses = [float(line.split("lm loss:")[1].split("|")[0])
               for line in capsys.readouterr().out.splitlines()
               if "lm loss:" in line]
    seen = []
    tdriver.pretrain(tc, ttrain, params=tp, eod_token=eod, device="cpu",
                     on_step=lambda it, m, s: seen.append(float(m["loss"])))
    assert len(seen) == len(jlosses) == 3
    for got, want in zip(seen, jlosses):
        # JAX's log line prints 7 significant digits
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5)


def test_eval_metrics_match_jax(corpus, tmp_path):
    """The eval step with registry metrics, on instruction batches (an
    assistant mask below 1 elsewhere), at 1e-5; and the driver writes
    ``valid/<name>`` and ``valid/lm_loss_ppl``."""
    from megatron_llm_tpu.data.instruction_dataset import \
        build_instruction_datasets as jinst
    from megatron_llm_tpu_torch.data.instruction_dataset import \
        build_instruction_datasets as tinst

    names = ("perplexity", "accuracy", "instruct_accuracy",
             "count_loss_mask", "count_instruct_mask")
    jc, tc = _run_cfgs(dict(metrics=names))
    jp = jm.init_params(jax.random.key(1), jc.model)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jds = jinst(str(corpus / "chat"), "1", 24, 3, scalar_loss_mask=0.1)[0]
    tds = tinst(str(corpus / "chat"), "1", 24, 3, scalar_loss_mask=0.1)[0]
    kw = dict(global_batch_size=4, grad_accum=2, seq_length=24, eod_token=0)
    jstep = jdriver.make_eval_step(jc, names)
    tstep = tdriver.make_eval_step(tc, names, "cpu")
    for jb, tb in zip(BatchIterator(jds, **kw), BatchIterator(tds, **kw)):
        flat = {k: np.reshape(v, (-1,) + v.shape[2:]) for k, v in tb.items()}
        want = jstep(jp, {k: jnp.asarray(np.reshape(v, (-1,) + v.shape[2:]))
                          for k, v in jb.items()})
        got = tstep(tp, to_device_batch(flat, "cpu"))
        assert set(got) == set(want) == {"lm_loss", *names}
        for k in got:
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5,
                                                  abs=1e-5), k
        break

    class Rec:
        def __init__(self):
            self.rows = {}

        def add_scalar(self, tag, value, step):
            self.rows[tag] = value

    rec = Rec()
    res = tdriver.evaluate_and_print_results(
        "test", tc, tp, iter(BatchIterator(tds, **kw)), tstep, "cpu", rec,
        3)
    assert set(rec.rows) == {f"valid/{k}" for k in res} | {
        "valid/lm_loss_ppl"}
    assert rec.rows["valid/lm_loss_ppl"] == pytest.approx(
        np.exp(res["lm_loss"]), rel=1e-6)


def test_finetune_main_on_indexed_data_resumes(corpus, tmp_path, capsys):
    """``finetune.main`` with ``--data_path``, a tokenizer, registry
    metrics, TensorBoard, the profiler window and ``--save``; a
    ``--load`` resume continues with the saved ``consumed_samples``."""
    base = ["--model", "tiny", "--device", "cpu", "--seq_length", "24",
            "--global_batch_size", "4", "--micro_batch_size", "2",
            "--params_dtype", "float32", "--log_interval", "1",
            "--tokenizer_type", "gpt2-bpe", "--tokenizer_model",
            str(corpus), "--eval_interval", "2", "--eval_iters", "1",
            "--metrics", "perplexity", "accuracy", "count_loss_mask",
            "--save", str(tmp_path / "ck"), "--save_interval", "2",
            "--data_cache_dir", str(tmp_path / "cache"),
            *_data_argv(corpus, "blended")]
    assert tfinetune.main(base + [
        "--train_iters", "3", "--tensorboard_dir", str(tmp_path / "tb"),
        "--profile_dir", str(tmp_path / "prof"), "--profile_step_start",
        "2", "--profile_step_end", "2"]) == 0
    out = capsys.readouterr().out
    assert "perplexity:" in out and "count_loss_mask:" in out
    assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
    trace = json.loads((tmp_path / "prof" / "trace_iters_2-2.json")
                       .read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    assert checkpointing.load_meta(str(tmp_path / "ck"), 3)[
        "consumed_samples"] == 12
    assert tfinetune.main(base + ["--train_iters", "4", "--load",
                                  str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "consumed_samples=12" in out
    assert " iteration        4/       4 | consumed samples:           16" \
        in out


def test_vocab_grows_for_extra_ids(corpus, tmp_path, capsys):
    """Extra ids past the preset's vocab grow the embedding (JAX
    ``finetune.py:396-411``); ``a,b`` and ``a b`` forms both split."""
    transformers = pytest.importorskip("transformers")
    transformers.GPT2TokenizerFast(
        vocab_file=str(corpus / "vocab.json"),
        merges_file=str(corpus / "merges.txt")).save_pretrained(
            str(tmp_path / "hf"))
    extra = [f"<x{i}>" for i in range(300)]
    assert tfinetune.main([
        "--model", "tiny", "--device", "cpu", "--seq_length", "24",
        "--train_iters", "1", "--global_batch_size", "2",
        "--tokenizer_type", "hf", "--tokenizer_model", str(tmp_path / "hf"),
        "--vocab_extra_ids_list", ",".join(extra[:150]), *extra[150:],
        "--eval_iters", "0", "--data_cache_dir", str(tmp_path / "cache"),
        *_data_argv(corpus, "single")]) == 0
    assert f"vocab grown to {VOCAB + 300}" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The server's launch entry
# ---------------------------------------------------------------------------

SERVE = dict(max_batch_size=2, engine_max_seq_len=64, prefill_bucket=8,
             kv_block_size=8, prefix_cache_blocks=0, trace=False,
             max_tokens_to_generate=32)
SERVE_FLAGS = ["--max_batch_size", "2", "--max_seq_len", "64",
               "--prefill_bucket", "8", "--kv_block_size", "8",
               "--no_prefix_cache", "--no_trace", "--max_tokens_to_generate",
               "32", "--metrics_interval_s", "0", "--device", "cpu",
               "--host", "127.0.0.1", "--port", "0"]


@pytest.fixture(scope="module")
def release(corpus, tmp_path_factory):
    jc = jtiny(vocab_size=VOCAB, fused_decode=False)
    tc = ttiny(vocab_size=VOCAB, fused_decode=False)
    jp = jm.init_params(jax.random.key(3), jc)
    root = tmp_path_factory.mktemp("release")
    checkpointing.save_release_params(
        str(root), params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu"), TRun(model=tc))
    return str(root), jc, jp


def _put(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api", data=json.dumps(body).encode(),
        method="PUT", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


def test_server_entry_answers_like_the_jax_server(corpus, release):
    root, jc, jp = release
    jserver = JServer(jc, jp, jbuild("gpt2-bpe", str(corpus)), **SERVE)
    jserver.run("127.0.0.1", 0, block=False, graceful_sigterm=False)
    ready = threading.Event()
    box = {}

    def on_ready(server):
        box["server"] = server
        ready.set()

    thread = threading.Thread(target=lambda: box.setdefault("rc", rtgs.main(
        ["--load", root, "--use_checkpoint_args", "--tokenizer_type",
         "gpt2-bpe", "--tokenizer_model", str(corpus), *SERVE_FLAGS],
        on_ready=on_ready)))
    thread.start()
    try:
        assert ready.wait(120), "the server did not start"
        body = {"prompts": ["hello world", "the café, don't",
                            "123 x² it's"], "tokens_to_generate": 7}
        js, jout = _put(jserver.port, body)
        ts, tout = _put(box["server"].port, body)
        assert js == ts == 200
        assert tout["text"] == jout["text"]
        assert all(t.startswith(p) for t, p in zip(tout["text"],
                                                   body["prompts"]))
    finally:
        if "server" in box:
            assert box["server"].graceful_shutdown(10.0)
        thread.join(60)
        jserver.shutdown()
    assert not thread.is_alive() and box.get("rc") == 0


# flags the entry passes through: their cases serve and match JAX's text
NOW_SERVED = ("prefill_chunk", "host_kv_blocks")


@pytest.mark.parametrize("flags,match", [
    (["--prefill_chunk", "16"], "prefill_chunk"),
    (["--host_kv_blocks", "4"], "host_kv_blocks"),
    (["--role", "decode"], "role"),
    (["--tp", "2", "--replicas", "2"], "sharded"),
    (["--disagg", "1:1"], "item 11"),
])
def test_server_entry_refuses_what_is_not_ported(corpus, release, flags,
                                                 match):
    root, jc, jp = release
    argv = ["--load", root, "--use_checkpoint_args", "--tokenizer_type",
            "gpt2-bpe", "--tokenizer_model", str(corpus), *SERVE_FLAGS,
            *flags]
    if match not in NOW_SERVED:
        with pytest.raises(NotImplementedError, match=match):
            rtgs.main(argv)
        return
    # ported since: the entry passes the flag through and serves the JAX
    # server's text with the same option
    opt = {match: int(flags[1])}
    jserver = JServer(jc, jp, jbuild("gpt2-bpe", str(corpus)),
                      **{**SERVE, **opt})
    jserver.run("127.0.0.1", 0, block=False, graceful_sigterm=False)
    ready = threading.Event()
    box = {}

    def on_ready(server):
        box["server"] = server
        ready.set()

    thread = threading.Thread(target=lambda: box.setdefault(
        "rc", rtgs.main(argv, on_ready=on_ready)))
    thread.start()
    try:
        assert ready.wait(120), "the server did not start"
        engine = box["server"].service.engine
        assert getattr(engine.config, match) == opt[match]
        body = {"prompts": ["hello world", "the café, don't"],
                "tokens_to_generate": 7}
        js, jout = _put(jserver.port, body)
        ts, tout = _put(box["server"].port, body)
        assert js == ts == 200
        assert tout["text"] == jout["text"]
    finally:
        if "server" in box:
            assert box["server"].graceful_shutdown(10.0)
        thread.join(60)
        jserver.shutdown()
    assert not thread.is_alive() and box.get("rc") == 0
