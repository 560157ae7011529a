"""Open-retrieval QA (ORQA) evaluation: top-k retrieval accuracy (a copy
of ``megatron_llm_tpu/tasks/orqa.py`` over the port's
``models/realm_indexer.mips_search``).

Reference parity: tasks/orqa/evaluate_utils.py (ORQAEvaluator) +
tasks/orqa/unsupervised/qa_utils.py's calculate_matches — given a question
set with gold answer strings and an evidence corpus, embed questions with
the biencoder query tower, retrieve top-k evidence blocks by exact MIPS
(models/realm_indexer.py), and report the fraction of questions whose
answer string appears in at least one of the top-k blocks.

All answer matching here is original (clean-room) implementation — the
reference vendors DPR's matcher, which is CC-BY-NC licensed and not
reproduced.  Covered behaviors: token-subsequence containment
(``match_type='string'``), regex answers (``match_type='regex'``), and
SQuAD-style reader exact-match scoring (``exact_match_accuracy``).

Question file format (reference NQ tsv, tasks/orqa/unsupervised/nq.py):
one question per line, ``question\t["answer 1", "answer 2", ...]``.
"""

from __future__ import annotations

import ast
import json
import unicodedata
from typing import Optional, Sequence

import numpy as np


def normalize_text(s: str) -> str:
    s = unicodedata.normalize("NFD", s)
    s = "".join(c for c in s if unicodedata.category(c) != "Mn")
    return " ".join(
        "".join(c.lower() if c.isalnum() else " " for c in s).split())


def has_answer(block_text: str, answers: Sequence[str],
               match_type: str = "string") -> bool:
    """True iff any answer matches the block.

    ``match_type='string'``: normalized answer occurs as a token
    subsequence of the normalized block text (retrieval hit criterion).
    ``match_type='regex'``: each answer is a regex searched over the
    raw block text (the reference's curated-set mode,
    qa_utils.py:133-139) — original implementation.
    """
    if match_type == "regex":
        return any(regex_match(block_text, a) for a in answers)
    block_tokens = normalize_text(block_text).split()
    n = len(block_tokens)
    for ans in answers:
        a = normalize_text(ans).split()
        if not a:
            continue
        m = len(a)
        for i in range(n - m + 1):
            if block_tokens[i:i + m] == a:
                return True
    return False


def regex_match(text: str, pattern: str) -> bool:
    """Search ``pattern`` anywhere in ``text`` (case/unicode-insensitive);
    invalid patterns count as no-match rather than crashing the eval."""
    import re

    try:
        compiled = re.compile(pattern,
                              re.IGNORECASE | re.UNICODE | re.MULTILINE)
    except re.error:
        return False
    return compiled.search(text) is not None


def normalize_answer(s: str) -> str:
    """SQuAD-style answer normalization: lowercase, strip punctuation,
    drop English articles, collapse whitespace.  Used for reader
    exact-match scoring (distinct from ``normalize_text``, whose
    alnum-only folding is the retrieval-containment criterion)."""
    import re
    import string

    s = s.lower()
    s = "".join(c for c in s if c not in string.punctuation)
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def exact_match_score(prediction: str, ground_truth: str) -> bool:
    return normalize_answer(prediction) == normalize_answer(ground_truth)


def metric_max_over_ground_truths(metric_fn, prediction: str,
                                  ground_truths: Sequence[str]):
    """Best score of ``prediction`` against any gold answer (standard
    multi-reference QA scoring)."""
    return max((metric_fn(prediction, gt) for gt in ground_truths),
               default=False)


def exact_match_accuracy(predictions: Sequence[str],
                         answers: Sequence[Sequence[str]]) -> float:
    """Reader EM: fraction of predictions exactly matching (after
    normalization) any gold answer."""
    assert len(predictions) == len(answers)
    if not predictions:
        return 0.0
    hits = sum(
        bool(metric_max_over_ground_truths(exact_match_score, p, a))
        for p, a in zip(predictions, answers))
    return hits / len(predictions)


def read_nq_file(path: str):
    """→ (questions [str], answers [list[str]]) from the tsv format."""
    questions, answers = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            q, ans = line.split("\t", 1)
            try:
                parsed = ast.literal_eval(ans)
            except (ValueError, SyntaxError):
                parsed = [ans]
            if isinstance(parsed, str):
                parsed = [parsed]
            questions.append(q)
            answers.append([str(a) for a in parsed])
    return questions, answers


def calculate_topk_hits(retrieved_texts: Sequence[Sequence[str]],
                        answers: Sequence[Sequence[str]],
                        top_ks: Sequence[int] = (1, 5, 20, 100),
                        match_type: str = "string") -> dict:
    """calculate_matches equivalent: hit@k = fraction of questions whose
    gold answer appears in any of the first k retrieved blocks.
    ``match_type='regex'`` treats each answer as a pattern (curated
    question sets)."""
    assert len(retrieved_texts) == len(answers)
    max_k = max(top_ks)
    # first rank (0-based) at which the answer appears, or max_k
    first_hit = []
    for blocks, ans in zip(retrieved_texts, answers):
        rank = max_k
        for i, b in enumerate(blocks[:max_k]):
            if has_answer(b, ans, match_type=match_type):
                rank = i
                break
        first_hit.append(rank)
    first_hit = np.asarray(first_hit)
    return {f"top{k}_accuracy": float(np.mean(first_hit < k))
            for k in top_ks}


def evaluate_retriever(
    cfg,
    params,
    questions: Sequence[str],
    answers: Sequence[Sequence[str]],
    block_texts: Sequence[str],
    block_vecs: np.ndarray,
    encode_question,
    top_ks: Sequence[int] = (1, 5, 20),
    match_type: str = "string",
) -> dict:
    """End-to-end unsupervised ORQA eval (reference ORQAEvaluator.evaluate,
    tasks/orqa/evaluate_utils.py:78-135).

    ``encode_question(questions) -> [n, d]`` abstracts tokenization:
    callers bind their tokenizer and the biencoder's query tower
    (``models/biencoder.embed_batches``).
    """
    from ..models.realm_indexer import mips_search

    q_vecs = np.asarray(encode_question(questions))
    idx, _scores = mips_search(np.asarray(block_vecs), q_vecs,
                               top_k=max(top_ks))
    retrieved = [[block_texts[j] for j in row] for row in idx]
    stats = calculate_topk_hits(retrieved, answers, top_ks,
                                match_type=match_type)
    return stats


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--qa_file", required=True,
                   help="tsv: question\\t[answers]")
    p.add_argument("--evidence_texts", required=True,
                   help="jsonl with {'id': int, 'text': str} per block")
    p.add_argument("--embedding_path", required=True,
                   help="BlockDataStore npz from the REALM indexer")
    p.add_argument("--query_embeds", required=True,
                   help="npy [n, d] precomputed question embeddings (run "
                        "the biencoder query tower via tools/ or a "
                        "notebook; kept separate so this CLI needs no "
                        "checkpoint plumbing)")
    p.add_argument("--top_ks", type=int, nargs="+", default=[1, 5, 20])
    p.add_argument("--match_type", default="string",
                   choices=["string", "regex"],
                   help="regex: answers are patterns (curated sets)")
    ns = p.parse_args(argv)

    from ..models.realm_indexer import BlockDataStore, mips_search

    questions, answers = read_nq_file(ns.qa_file)
    texts = {}
    with open(ns.evidence_texts) as f:
        for line in f:
            row = json.loads(line)
            texts[int(row["id"])] = row["text"]
    store = BlockDataStore.load(ns.embedding_path)
    ids, vecs = store.as_arrays()
    q_vecs = np.load(ns.query_embeds)
    idx, _ = mips_search(vecs, q_vecs, top_k=max(ns.top_ks))
    retrieved = [[texts[int(ids[j])] for j in row] for row in idx]
    stats = calculate_topk_hits(retrieved, answers, ns.top_ks,
                                match_type=ns.match_type)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
