"""Task dispatch (mirror of ``megatron_llm_tpu/tasks/main.py``; reference:
tasks/main.py).

Usage:
  python -m megatron_llm_tpu_torch.tasks.main --task classification ...
  python -m megatron_llm_tpu_torch.tasks.main --task mnli|qqp ...
  python -m megatron_llm_tpu_torch.tasks.main --task race ...
  python -m megatron_llm_tpu_torch.tasks.main --task orqa ...

The GPT tasks (``wikitext``, ``lambada``, ``msdp``) are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

UNPORTED = ("wikitext", "lambada", "msdp")


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--task", required=True)
    ns, rest = p.parse_known_args(
        list(sys.argv[1:] if argv is None else argv))
    task = ns.task
    if task in UNPORTED:
        raise NotImplementedError(
            f"--task {task}: the GPT tasks (tasks/zeroshot.py, "
            "tasks/msdp.py) are not ported yet (ROADMAP.md, Queue 1 item "
            "12: the rest)")
    if task in ("classification", "glue"):
        from .classification import main as cmain

        cmain(rest)
        return 0
    if task in ("mnli", "qqp"):
        from .classification import main as cmain

        cmain(["--task", task, *rest])
        return 0
    if task == "race":
        from .race import main as rmain

        rmain(rest)
        return 0
    if task == "orqa":
        from .orqa import main as omain

        return omain(rest)
    raise SystemExit(f"unknown --task {task!r}; choose from wikitext, "
                     "lambada, classification, glue, mnli, qqp, race, "
                     "orqa, msdp")


if __name__ == "__main__":
    raise SystemExit(main())
