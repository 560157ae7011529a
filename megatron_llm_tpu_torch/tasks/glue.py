"""GLUE dataset-specific processors: MNLI and QQP, in the distributions'
actual shipped formats (a copy of ``megatron_llm_tpu/tasks/glue.py``).

Reference parity: tasks/glue/mnli.py (column layout 0/8/9/last, 10-column
test files get ``test_label``), tasks/glue/qqp.py (6-column train rows
id/qid1/qid2/question1/question2/is_duplicate, 3-column test rows), and
tasks/data_utils.py:clean_text.  Rows feed
``tasks.classification.ClassificationDataset`` with the task's fixed label
map — unlike the generic TSV harness, the maps and column positions here
match the files GLUE actually distributes.
"""

from __future__ import annotations

import re
from typing import Optional

MNLI_LABELS = {"contradiction": 0, "entailment": 1, "neutral": 2}
QQP_LABELS = {"0": 0, "1": 1}


def clean_text(text: str) -> str:
    """Collapse whitespace and re-attach sentence dots (reference
    tasks/data_utils.py:9-17)."""
    text = text.replace("\n", " ")
    text = re.sub(r"\s+", " ", text)
    for _ in range(3):
        text = text.replace(" . ", ". ")
    return text


def load_mnli(path: str, test_label: str = "contradiction") -> list[tuple]:
    """MNLI TSV → [(text_a, text_b, label)].

    Shipped dev/train files carry the parse columns: sentence1 at index 8,
    sentence2 at 9, gold label last.  Test files have 10 columns and no
    gold label — every row gets ``test_label`` (the reference's
    placeholder convention, mnli.py test_label)."""
    rows = []
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        is_test = len(header) == 10
        for line in f:
            row = line.rstrip("\n").split("\t")
            if len(row) < 10:
                continue
            text_a = clean_text(row[8].strip())
            text_b = clean_text(row[9].strip())
            label = test_label if is_test else row[-1].strip()
            if not text_a or not text_b:
                continue
            if label not in MNLI_LABELS:
                raise ValueError(
                    f"bad MNLI label {label!r} in {path} (expected one of "
                    f"{sorted(MNLI_LABELS)})")
            rows.append((text_a, text_b, label))
    return rows


def load_qqp(path: str, test_label: str = "0") -> list[tuple]:
    """QQP TSV → [(question1, question2, label)].

    Train/dev rows: id, qid1, qid2, question1, question2, is_duplicate
    (6 columns; occasional malformed rows are skipped, matching the
    reference's ignore-and-count behavior, qqp.py:61-67).  Test rows:
    id, question1, question2 (3 columns) → ``test_label``."""
    rows = []
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        is_test = len(header) == 3
        for line in f:
            row = line.rstrip("\n").split("\t")
            if is_test:
                if len(row) != 3:
                    continue
                text_a = clean_text(row[1].strip())
                text_b = clean_text(row[2].strip())
                label = test_label
            else:
                if len(row) != 6:
                    continue
                text_a = clean_text(row[3].strip())
                text_b = clean_text(row[4].strip())
                label = row[5].strip()
            if not text_a or not text_b:
                continue
            if label not in QQP_LABELS:
                raise ValueError(f"bad QQP label {label!r} in {path}")
            rows.append((text_a, text_b, label))
    return rows


GLUE_TASKS = {
    "mnli": (load_mnli, MNLI_LABELS),
    "qqp": (load_qqp, QQP_LABELS),
}


def load_glue_rows(task: str, path: str,
                   test_label: Optional[str] = None) -> tuple[list, dict]:
    """→ (rows, label_map) for a GLUE task in its shipped format."""
    loader, labels = GLUE_TASKS[task]
    rows = loader(path, **({"test_label": test_label} if test_label else {}))
    return rows, dict(labels)
