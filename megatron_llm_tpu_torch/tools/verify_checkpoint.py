"""Offline checkpoint integrity verifier (mirror of
``megatron_llm_tpu/tools/verify_checkpoint.py`` on the port's checkpoint
format).

Answers "will a resume from this directory work?" without starting a
training job: checks the tracker, the payload's ``COMMITTED`` marker, its
``state.json`` and safetensors headers, and the saved config and meta
JSON.  Exits non-zero on anything that would break (or silently degrade)
a resume, so it can gate a restart::

    python -m megatron_llm_tpu_torch.tools.verify_checkpoint /path/to/ckpts
    python -m megatron_llm_tpu_torch.tools.verify_checkpoint /path/to/ckpts \
        --iteration 5000 --strict

``--strict`` promotes hygiene findings (stray ``iter_*.tmp`` staging dirs
from crashed saves, older incomplete checkpoints) from warnings to
errors.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..checkpointing import (
    RELEASE,
    STAGING_SUFFIX,
    STATE_JSON,
    TRACKER_FILENAME,
    checkpoint_dir,
    is_complete,
    list_iterations,
    read_tracker,
)
from .. import safetensors_io


class _Report:
    def __init__(self):
        self.errors: list[str] = []
        self.warnings: list[str] = []

    def error(self, msg: str) -> None:
        self.errors.append(msg)
        print(f"ERROR: {msg}")

    def warn(self, msg: str) -> None:
        self.warnings.append(msg)
        print(f"WARNING: {msg}")


def _check_payload(root: str, iteration: int | str, rep: _Report) -> None:
    """Deep-check one checkpoint: marker, payload headers, config/meta."""
    ckpt = checkpoint_dir(root, iteration)
    if not ckpt.is_dir():
        rep.error(f"{ckpt}: checkpoint directory does not exist")
        return
    if not is_complete(root, iteration):
        rep.error(f"{ckpt}: incomplete (no completeness marker): torn by "
                  "a crash mid-save?")
        return
    payload = ckpt / ("params" if iteration == RELEASE else "state")
    # the structure and every tensor file's header must parse: a truncated
    # file passes the marker check but still breaks the restore
    try:
        json.loads((payload / STATE_JSON).read_text())
    except (OSError, ValueError) as e:
        rep.error(f"{payload / STATE_JSON}: unreadable ({e})")
    try:
        safetensors_io.open_sharded(payload)
    except (OSError, ValueError, KeyError) as e:
        rep.error(f"{payload}: unreadable tensor files ({e})")
    cfg = ckpt / "config.json"
    if cfg.exists():
        try:
            from ..config import RuntimeConfig

            RuntimeConfig.from_json(cfg.read_text())
        except Exception as e:  # noqa: BLE001, any parse error
            rep.error(f"{cfg}: config does not parse/validate ({e})")
    else:
        rep.warn(f"{ckpt}: no config.json (resume cannot cross-check the "
                 "run configuration)")
    meta = ckpt / "meta.json"
    if meta.exists():
        try:
            parsed = json.loads(meta.read_text())
            if not isinstance(parsed, dict):
                raise ValueError("meta.json is not an object")
        except (OSError, ValueError) as e:
            rep.error(f"{meta}: unreadable meta ({e}) — resume would lose "
                      "the dataloader position (consumed_samples)")


def verify(root: str, iteration: int | None = None,
           strict: bool = False) -> int:
    rep = _Report()
    rootp = Path(root)
    if not rootp.is_dir():
        rep.error(f"{root}: not a directory")
        return 1

    tracker_file = rootp / TRACKER_FILENAME
    target = read_tracker(root)
    if not tracker_file.exists():
        rep.warn(f"{root}: no {TRACKER_FILENAME} (resume would scan for "
                 "the newest complete checkpoint)")
    elif target is None:
        rep.error(f"{tracker_file}: exists but does not parse — torn or "
                  "corrupt tracker")

    if iteration is not None:
        _check_payload(root, iteration, rep)
    elif target is not None:
        _check_payload(root, target, rep)
    else:
        iters = list_iterations(root)
        complete = [it for it in iters if is_complete(root, it)]
        if complete:
            _check_payload(root, complete[-1], rep)
        elif (rootp / RELEASE).is_dir():
            _check_payload(root, RELEASE, rep)
        else:
            rep.error(f"{root}: no loadable checkpoint at all")

    # hygiene: leftovers from crashed saves, and incomplete non-target dirs
    hygiene = rep.error if strict else rep.warn
    for p in sorted(rootp.glob(f"iter_*{STAGING_SUFFIX}")):
        hygiene(f"{p}: stray staging directory from a crashed save "
                "(safe to delete; the next save to this iteration "
                "clears it)")
    for it in list_iterations(root):
        if it != iteration and it != target and not is_complete(root, it):
            hygiene(f"{checkpoint_dir(root, it)}: incomplete checkpoint "
                    "(not the resume target; safe to delete)")

    if rep.errors:
        print(f"FAIL: {len(rep.errors)} error(s), "
              f"{len(rep.warnings)} warning(s)")
        return 1
    tag = target if target is not None else "(scan)"
    print(f"OK: {root} (tracker -> {tag}), {len(rep.warnings)} warning(s)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root", help="checkpoint root directory")
    ap.add_argument("--iteration", type=int, default=None,
                    help="verify this iteration instead of the tracker "
                         "target")
    ap.add_argument("--strict", action="store_true",
                    help="treat hygiene findings (stray staging dirs, "
                         "incomplete non-target checkpoints) as errors")
    args = ap.parse_args(argv)
    return verify(args.root, iteration=args.iteration, strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
