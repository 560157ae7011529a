"""The BERT tasks of the port (``tasks/classification.py``, ``glue.py``,
``race.py``, ``orqa.py``, ``main.py``) against the JAX package's, on the
CPU.

Classification and multiple-choice logits (weights carried across with
``params_from_jax``; fp32, sums in another order) within the tolerance
below; the MNLI / QQP / RACE parsers' rows and ORQA's metrics equal to
JAX's; the tiny overfit tests of the JAX suite restated through
``pretrain_custom``; ``tasks/main``'s routing and its refusals.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ModelConfig as JModel
from megatron_llm_tpu.tasks import classification as jcls
from megatron_llm_tpu.tasks import glue as jglue
from megatron_llm_tpu.tasks import orqa as jorqa
from megatron_llm_tpu.tasks import race as jrace
from megatron_llm_tpu_torch import checkpointing
from megatron_llm_tpu_torch.config import ModelConfig as TModel
from megatron_llm_tpu_torch.config import OptimizerConfig, RuntimeConfig, \
    TrainConfig
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.models import encdec as tencdec
from megatron_llm_tpu_torch.tasks import classification as tcls
from megatron_llm_tpu_torch.tasks import glue as tglue
from megatron_llm_tpu_torch.tasks import main as tmain
from megatron_llm_tpu_torch.tasks import orqa as torqa
from megatron_llm_tpu_torch.tasks import race as trace
from megatron_llm_tpu_torch.training.driver import pretrain_custom
from megatron_llm_tpu_torch.utils.tree import tree_leaves_with_path

torch.set_num_threads(1)

# fp32 on both sides, the sums in another order
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)


class ByteTok:
    vocab_size = 256

    def tokenize(self, text):
        return list(text.encode())


def _kw(seq):
    return dict(vocab_size=256, hidden_size=32, num_layers=2,
                num_attention_heads=4, num_kv_heads=4, ffn_hidden_size=64,
                max_position_embeddings=seq, norm_type="layernorm",
                activation="gelu", position_embedding_type="absolute",
                use_bias=True, tie_embed_logits=True, tokentype_size=2,
                params_dtype="float32", attention_impl="dot",
                recompute="none", make_vocab_size_divisible_by=8,
                seq_length=seq)


def _rows():
    return [("abc def", "ghi", "pos"), ("xyz", "", "neg"),
            ("hello world", "foo bar", "pos"), ("qrs tuv", "", "neg")]


_MNLI_HEADER = ("index\tpromptID\tpairID\tgenre\tsentence1_binary_parse\t"
                "sentence2_binary_parse\tsentence1_parse\tsentence2_parse\t"
                "sentence1\tsentence2\tlabel1\tgold_label")


def _mnli_row(i, s1, s2, gold):
    return (f"{i}\t{i}p\t{i}pair\tfiction\t(p)\t(p)\t(p)\t(p)\t"
            f"{s1}\t{s2}\t{gold}\t{gold}")


def _race_dir(tmp_path):
    d = tmp_path / "middle"
    d.mkdir(exist_ok=True)
    docs = [{
        "article": "The quick brown fox jumps over the lazy dog .\n"
                   "It was a sunny day .",
        "questions": ["What did the fox jump over?", "The day was _ ."],
        "options": [["the dog", "the moon", "a fence", "a river"],
                    ["rainy", "sunny", "cloudy", "dark"]],
        "answers": ["A", "B"],
    }, {
        "article": "Tom  has three apples . He eats one .",
        "questions": ["How many apples are left?"],
        "options": [["one", "two", "three", "none"]],
        "answers": ["B"],
    }]
    (d / "1.txt").write_text("\n".join(json.dumps(x) for x in docs) + "\n")
    return str(d)


def _samples_equal(jds, tds):
    assert len(jds) == len(tds)
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert list(a) == list(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), (i, k)


# ---------------------------------------------------------------------------
# Logits against JAX
# ---------------------------------------------------------------------------


def test_classification_logits_loss_and_accuracy_match_jax():
    jc, tc = JModel(**_kw(32)).validate(), TModel(**_kw(32)).validate()
    jp = jcls.init_classification_params(jax.random.key(0), jc, 2)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jds = jcls.ClassificationDataset(_rows(), ByteTok(), 32, 250, 251, 0)
    tds = tcls.ClassificationDataset(_rows(), ByteTok(), 32, 250, 251, 0)
    _samples_equal(jds, tds)
    batch = {k: np.stack([tds[i][k] for i in range(4)]) for k in tds[0]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jcls.classification_forward(jc, jp, jb["tokens"], jb["pad_mask"],
                                       jb["tokentype_ids"])
    with torch.no_grad():
        got = tcls.classification_forward(tc, tp, tb["tokens"],
                                          tb["pad_mask"], tb["tokentype_ids"])
        loss = tcls.classification_loss(tc, tp, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(loss),
                               float(jcls.classification_loss(jc, jp, jb)),
                               rtol=1e-5)
    assert tcls.classification_accuracy(tc, tp, tds, batch_size=3) == \
        jcls.classification_accuracy(jc, jp, jds, batch_size=3)


def test_multichoice_logits_loss_and_accuracy_match_jax(tmp_path):
    jc, tc = JModel(**_kw(96)).validate(), TModel(**_kw(96)).validate()
    jp = jrace.init_multichoice_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    path = _race_dir(tmp_path)
    jds = jrace.RaceDataset([path], ByteTok(), 96, 250, 251, 0,
                            max_qa_length=24)
    tds = trace.RaceDataset([path], ByteTok(), 96, 250, 251, 0,
                            max_qa_length=24)
    _samples_equal(jds, tds)
    batch = {k: np.stack([tds[i][k] for i in range(3)]) for k in tds[0]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = jrace.multichoice_forward(jc, jp, jb["tokens"], jb["pad_mask"],
                                     jb["tokentype_ids"])
    with torch.no_grad():
        got = trace.multichoice_forward(tc, tp, tb["tokens"], tb["pad_mask"],
                                        tb["tokentype_ids"])
        loss = trace.multichoice_loss(tc, tp, tb)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(loss),
                               float(jrace.multichoice_loss(jc, jp, jb)),
                               rtol=1e-5)
    assert trace.multichoice_accuracy(tc, tp, tds, batch_size=2) == \
        jrace.multichoice_accuracy(jc, jp, jds, batch_size=2)


def test_init_trees_match_jax():
    jc, tc = JModel(**_kw(32)).validate(), TModel(**_kw(32)).validate()
    for jinit, tinit in (
            (lambda: jcls.init_classification_params(jax.random.key(0), jc,
                                                     3),
             lambda: tcls.init_classification_params(tc, 3, device="cpu")),
            (lambda: jrace.init_multichoice_params(jax.random.key(0), jc),
             lambda: trace.init_multichoice_params(tc, device="cpu"))):
        want = {tuple(str(k.key) for k in p): leaf.shape
                for p, leaf in jax.tree.leaves_with_path(jinit())}
        got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tinit())}
        assert got == want


# ---------------------------------------------------------------------------
# Parsers and metrics, equal to JAX's
# ---------------------------------------------------------------------------


def test_glue_rows_equal_jax(tmp_path):
    mnli = tmp_path / "dev.tsv"
    mnli.write_text("\n".join([
        _MNLI_HEADER,
        _mnli_row(0, "A man   is eating .", "The man  is dining .",
                  "entailment"),
        _mnli_row(1, "A dog runs . Fast", "A cat\tsleeps.", "contradiction"),
        "short\trow",
        _mnli_row(2, "Hello there.", "General remark.", "neutral"),
    ]) + "\n")
    mnli_test = tmp_path / "test_matched.tsv"
    mnli_test.write_text("\t".join(f"c{i}" for i in range(10)) + "\n" +
                         "\t".join(["7", "7p", "7pair", "travel", "(p)",
                                    "(p)", "(p)", "(p)", "First.",
                                    "Second."]) + "\n")
    qqp = tmp_path / "train.tsv"
    qqp.write_text("\n".join([
        "id\tqid1\tqid2\tquestion1\tquestion2\tis_duplicate",
        "0\t1\t2\tHow do I cook rice?\tHow to cook rice?\t1",
        "1\t3\t4\tWhat is JAX?\tWho wrote Hamlet?\t0",
        "2\t5\t6\tbroken row with missing fields",
    ]) + "\n")
    qqp_test = tmp_path / "test.tsv"
    qqp_test.write_text("id\tquestion1\tquestion2\n0\tIs it real?\tIs it?\n")
    for task, f in (("mnli", mnli), ("mnli", mnli_test), ("qqp", qqp),
                    ("qqp", qqp_test)):
        assert tglue.load_glue_rows(task, str(f)) == \
            jglue.load_glue_rows(task, str(f))
    bad = tmp_path / "bad.tsv"
    bad.write_text(_MNLI_HEADER + "\n" + _mnli_row(0, "a.", "b.", "maybe")
                   + "\n")
    with pytest.raises(ValueError, match="maybe"):
        tglue.load_mnli(str(bad))
    assert tglue.clean_text("one . two\nthree") == \
        jglue.clean_text("one . two\nthree")
    j = tmp_path / "d.jsonl"
    j.write_text(json.dumps({"text_a": "a", "text_b": "b", "label": 1})
                 + "\n")
    t = tmp_path / "d.tsv"
    t.write_text("sentence1\tsentence2\tlabel\nfoo\tbar\tpos\n")
    for f in (j, t):
        assert tcls.load_rows(str(f)) == jcls.load_rows(str(f))


def test_race_rows_equal_jax(tmp_path):
    path = _race_dir(tmp_path)
    assert trace.read_race_questions(path) == \
        jrace.read_race_questions(path)


def test_orqa_metrics_equal_jax(tmp_path):
    texts = ["He was born in París in 1822.", "the answer is forty two",
             "fortytwo concatenated", "The Quick,  Brown-Fox!", "a an the"]
    answers = [["Paris"], ["forty two"], ["forty two"], ["brown fox"],
               ["missing", "the"]]
    for t in texts:
        assert torqa.normalize_text(t) == jorqa.normalize_text(t)
        assert torqa.normalize_answer(t) == jorqa.normalize_answer(t)
        for a in answers:
            for mt in ("string", "regex"):
                assert torqa.has_answer(t, a, mt) == \
                    jorqa.has_answer(t, a, mt)
    retrieved = [texts[:3], texts[2:], texts[::-1]]
    for mt in ("string", "regex"):
        assert torqa.calculate_topk_hits(retrieved, answers[:3], (1, 2, 3),
                                         mt) == \
            jorqa.calculate_topk_hits(retrieved, answers[:3], (1, 2, 3), mt)
    preds = ["Paris", "the Forty-Two", "nothing"]
    gold = [["paris"], ["forty two"], ["x", "y"]]
    assert torqa.exact_match_accuracy(preds, gold) == \
        jorqa.exact_match_accuracy(preds, gold)
    nq = tmp_path / "nq.tsv"
    nq.write_text('who wrote hamlet\t["Shakespeare", "W. Shakespeare"]\n'
                  "capital of france\t['Paris']\nbare\tanswer text\n")
    assert torqa.read_nq_file(str(nq)) == jorqa.read_nq_file(str(nq))
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((5, 8)).astype(np.float32)
    qs = rng.standard_normal((3, 8)).astype(np.float32)
    args = (["q0", "q1", "q2"], answers[:3], texts, vecs, lambda q: qs)
    assert torqa.evaluate_retriever(None, None, *args, top_ks=(1, 2, 5)) == \
        jorqa.evaluate_retriever(None, None, *args, top_ks=(1, 2, 5))


def test_orqa_main_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(1)
    texts = ["the sky is blue", "grass is green", "snow is white",
             "coal is black"]
    (tmp_path / "ev.jsonl").write_text("\n".join(
        json.dumps({"id": i * 10, "text": t}) for i, t in enumerate(texts)))
    (tmp_path / "qa.tsv").write_text(
        'what color is the sky\t["blue"]\nwhat is green\t["grass"]\n')
    ids = np.asarray([0, 10, 20, 30], np.int64)
    np.savez(tmp_path / "store.npz", ids=ids,
             vecs=rng.standard_normal((4, 6)).astype(np.float32))
    np.save(tmp_path / "q.npy", rng.standard_normal((2, 6)).astype(
        np.float32))
    argv = ["--qa_file", str(tmp_path / "qa.tsv"), "--evidence_texts",
            str(tmp_path / "ev.jsonl"), "--embedding_path",
            str(tmp_path / "store.npz"), "--query_embeds",
            str(tmp_path / "q.npy"), "--top_ks", "1", "2", "4"]
    assert jorqa.main(argv) == 0
    want = capsys.readouterr().out
    assert tmain.main(["--task", "orqa", *argv]) == 0
    assert capsys.readouterr().out == want


# ---------------------------------------------------------------------------
# The JAX suite's tiny finetunes, through pretrain_custom
# ---------------------------------------------------------------------------


def _cfg(seq, iters, gbs, lr):
    return RuntimeConfig(
        model=TModel(**_kw(seq)),
        optimizer=OptimizerConfig(lr=lr, min_lr=lr, weight_decay=0.0,
                                  clip_grad=1.0, lr_decay_style="constant"),
        train=TrainConfig(train_iters=iters, micro_batch_size=gbs,
                          global_batch_size=gbs, seq_length=seq,
                          log_interval=0, seed=0)).validate()


def test_finetune_overfits_tiny_classification_task(tmp_path):
    """A 2-layer BERT overfits four rows (JAX's test_finetune_overfits_
    tiny_task), starting from a BERT release checkpoint through
    ``load_release_params`` as the task's ``main`` does."""
    cfg = _cfg(32, 60, 4, 3e-3)
    ds = tcls.ClassificationDataset(_rows(), ByteTok(), 32, 250, 251, 0)
    bert = tencdec.init_bert_params(cfg.model, seed=1, device="cpu")
    checkpointing.save_release_params(str(tmp_path / "bert"), {
        k: v for k, v in bert.items()
        if k not in ("lm_head", "binary_head")})
    params = tcls.init_classification_params(cfg.model, ds.num_classes,
                                             seed=0, device="cpu")
    params = tcls.load_pretrained_trunk(str(tmp_path / "bert"), params,
                                        "classification_head")
    assert torch.equal(params["layers"]["attn"]["wq"],
                       bert["layers"]["attn"]["wq"])
    losses = []

    def loss_fn(rcfg, p, mb, rng, deterministic):
        return tcls.classification_loss(rcfg.model, p, mb, rng,
                                        deterministic)

    state = pretrain_custom(cfg, ds, params, loss_fn, device="cpu",
                            on_step=lambda i, m, s: losses.append(
                                float(m["loss"])))
    assert losses[-1] < 0.5 * losses[0]
    assert tcls.classification_accuracy(cfg.model, state.params, ds,
                                        batch_size=2) == 1.0


def test_finetune_overfits_tiny_race_task(tmp_path):
    """Three questions learned (their choices differ within the 48-byte qa
    room; at 24 bytes the first question's four choices are cut away)."""
    cfg = _cfg(96, 40, 3, 3e-3)
    ds = trace.RaceDataset([_race_dir(tmp_path)], ByteTok(), 96, 250, 251,
                           0, max_qa_length=48)
    params = trace.init_multichoice_params(cfg.model, seed=0, device="cpu")

    def loss_fn(rcfg, p, mb, rng, deterministic):
        return trace.multichoice_loss(rcfg.model, p, mb, rng, deterministic)

    state = pretrain_custom(cfg, ds, params, loss_fn, device="cpu")
    assert trace.multichoice_accuracy(cfg.model, state.params, ds) == 1.0


# ---------------------------------------------------------------------------
# tasks/main
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["wikitext", "lambada", "msdp"])
def test_main_refuses_the_gpt_tasks(task):
    with pytest.raises(NotImplementedError, match="item 12"):
        tmain.main(["--task", task])


@pytest.mark.parametrize("task,target,prefix", [
    ("classification", "classification", []),
    ("glue", "classification", []),
    ("mnli", "classification", ["--task", "mnli"]),
    ("qqp", "classification", ["--task", "qqp"]),
    ("race", "race", []),
])
def test_main_routes_the_bert_tasks(monkeypatch, task, target, prefix):
    import importlib

    seen = []
    mod = importlib.import_module(f"megatron_llm_tpu_torch.tasks.{target}")
    monkeypatch.setattr(mod, "main", lambda argv: seen.append(argv))
    assert tmain.main(["--task", task, "--x", "1"]) == 0
    assert seen == [prefix + ["--x", "1"]]


def test_main_rejects_an_unknown_task():
    with pytest.raises(SystemExit):
        tmain.main(["--task", "nope"])
