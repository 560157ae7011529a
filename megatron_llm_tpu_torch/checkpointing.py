"""Crash-safe checkpoints of the port's training state (mirror of
``megatron_llm_tpu/checkpointing.py``, with the same public functions and
semantics, on torch-native files).

What is kept from the JAX package (and its reference):

- tracker semantics: ``latest_checkpointed_iteration.txt`` holds the
  iteration or ``release``;
- args in the checkpoint: the ``RuntimeConfig`` as ``config.json``, read
  back by ``load_config_from_checkpoint`` (``--use_checkpoint_args``);
- resumable data order: ``consumed_samples`` in ``meta.json``;
- the crash-safe commit: a save is written into ``iter_*.tmp``, committed
  with one ``os.replace``, and the tracker moves last (itself tmp +
  ``os.replace``), so a kill at any point leaves the previous state or
  the new one.  An unpinned load whose tracker target is torn falls back,
  loudly and counted, to the newest complete checkpoint; a pinned torn
  one fails.  I/O runs under bounded retries, ``keep`` garbage-collects
  old iterations, and the chaos points carry the JAX package's names
  (``ckpt-begin``, ``ckpt-staging``, ``ckpt-pre-commit``,
  ``ckpt-pre-tracker``).

The payload (``state/``, or ``params/`` for a release) is the tree's
tensors in safetensors files (``safetensors_io.py``), keyed by their
dotted path (``params.layers.attn.wq``, ``opt.mu...``, ``guard.ewma``),
beside ``state.json``, which holds the tree's structure and its host
scalars (``TrainState.iteration`` / ``skipped``, ``OptState.step``, the
``ScalerState``) and its ``None`` leaves (``nu`` for SGD, ``master`` for
fp32 params).  A ``COMMITTED`` marker is written last inside the payload;
``is_complete`` checks it.

A load is driven by a template tree: keys must match exactly, shapes and
dtypes must agree, and each tensor is read into the template's own
tensor (so a resume at 7B never holds two copies of the state; the
template is consumed), or onto ``device`` for a ``meta`` template.
There is no resharding: the port trains on one device.
A release load refreshes the fp32 master copy from the loaded params, so
the first optimizer step starts from them (the JAX package keeps the
template's master there).

Layout:  <root>/iter_0000010/{state/, config.json, meta.json}
         <root>/release/{params/, config.json}
         <root>/latest_checkpointed_iteration.txt

The JAX package writes orbax checkpoints: neither package reads the
other's checkpoints, and converting between the formats is out of scope.
Weights cross between the packages through the HF format
(``tools/checkpoint_util.py``).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from pathlib import Path
from typing import Any, List, Optional

import torch

from . import metrics as metrics_lib
from . import safetensors_io as st
from .config import RuntimeConfig
from .resilience import atomic_write_text, chaos, with_retries

logger = logging.getLogger(__name__)

TRACKER_FILENAME = "latest_checkpointed_iteration.txt"
RELEASE = "release"
STAGING_SUFFIX = ".tmp"
STATE_JSON = "state.json"
COMMIT_MARKER = "COMMITTED"  # written last inside a payload directory


def checkpoint_dir(root: str, iteration: int | str) -> Path:
    """``iter_%07d``, or ``release`` for conversion outputs."""
    if iteration == RELEASE:
        return Path(root) / RELEASE
    return Path(root) / f"iter_{int(iteration):07d}"


def _payload(root: str, iteration: int | str) -> Path:
    return checkpoint_dir(root, iteration) / (
        "params" if iteration == RELEASE else "state")


def read_tracker(root: str) -> Optional[int | str]:
    """The tracker's target, or None when absent or unparseable (a torn
    write or bitrot is treated as no tracker, so load can fall back to a
    directory scan)."""
    tracker = Path(root) / TRACKER_FILENAME
    if not tracker.exists():
        return None
    content = tracker.read_text().strip()
    if content == RELEASE:
        return RELEASE
    try:
        return int(content)
    except ValueError:
        logger.warning("unparseable tracker %s (content %r); ignoring it",
                       tracker, content[:64])
        return None


def write_tracker(root: str, iteration: int | str) -> None:
    """Advance the tracker atomically (tmp + ``os.replace``)."""
    Path(root).mkdir(parents=True, exist_ok=True)
    chaos().point("tracker-write")
    atomic_write_text(Path(root) / TRACKER_FILENAME, str(iteration),
                      site="tracker-replace")


def is_complete(root: str, iteration: int | str) -> bool:
    """True iff the checkpoint's payload finished writing."""
    return (_payload(root, iteration) / COMMIT_MARKER).is_file()


def list_iterations(root: str) -> List[int]:
    """All on-disk iteration numbers (complete or not), ascending; staging
    directories are skipped."""
    out = []
    for p in Path(root).glob("iter_*"):
        if p.name.endswith(STAGING_SUFFIX) or not p.is_dir():
            continue
        try:
            out.append(int(p.name[len("iter_"):]))
        except ValueError:
            continue
    return sorted(out)


def latest_complete_iteration(root: str) -> Optional[int]:
    """Newest iteration whose payload is complete, or None."""
    if not Path(root).is_dir():
        return None
    for it in reversed(list_iterations(root)):
        if is_complete(root, it):
            return it
    return None


# ---------------------------------------------------------------------------
# The payload: tensors in safetensors files, the structure in state.json
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _encode(tree, path: str, tensors: dict):
    """The JSON node of ``tree``; tensor leaves go into ``tensors``."""
    if isinstance(tree, torch.Tensor):
        tensors[path] = tree.detach()
        return {"tensor": path}
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return {"namedtuple": type(tree).__name__,
                "fields": {f: _encode(getattr(tree, f), _join(path, f),
                                      tensors) for f in tree._fields}}
    if isinstance(tree, dict):
        return {"dict": {str(k): _encode(v, _join(path, str(k)), tensors)
                         for k, v in tree.items()}}
    if isinstance(tree, (bool, int, float)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at {path!r}")


def _join(path: str, key: str) -> str:
    return f"{path}.{key}" if path else key


def _write_payload(directory: Path, tree) -> None:
    """Tensors, then ``state.json``, then the marker, each fsynced."""
    if directory.exists():  # a retried attempt starts over
        shutil.rmtree(directory)
    directory.mkdir(parents=True)
    tensors: dict = {}
    node = _encode(tree, "", tensors)
    st.save_sharded(tensors, directory, fsync=True)
    _write_synced(directory / STATE_JSON, json.dumps(node))
    _write_synced(directory / COMMIT_MARKER, "")


def _write_synced(path: Path, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


class _Reader:
    """Decodes a payload against a template; counts the tensors it takes
    so a load can refuse a file that holds more than the template."""

    def __init__(self, directory: Path, device=None, cast: bool = False):
        self.files = st.open_sharded(directory)
        self.device = None if device is None else torch.device(device)
        self.cast = cast
        self.taken = 0

    def tensor(self, key: str, like, path: str):
        src = self.files.file_of(key)
        spec = src.spec(key)
        if spec.shape != like.shape:
            raise ValueError(f"checkpoint leaf {path!r} has shape "
                             f"{tuple(spec.shape)}, the template "
                             f"{tuple(like.shape)}")
        dtype = spec.dtype
        if dtype != like.dtype and not self.cast:
            raise ValueError(f"checkpoint leaf {path!r} is {dtype}, the "
                             f"template {like.dtype}")
        self.taken += 1
        if like.device.type != "meta" and _same_device(self.device,
                                                       like.device):
            # into the template's own storage: a resume never holds two
            # copies of the state
            with torch.no_grad():
                return src.read_into(key, like)
        return src.get(key, self.device or like.device, like.dtype)

    def decode(self, node, like, path: str = ""):
        where = path or "<root>"
        if isinstance(like, torch.Tensor):
            if not isinstance(node, dict) or "tensor" not in node:
                raise ValueError(f"checkpoint has no tensor at {where!r}")
            return self.tensor(node["tensor"], like, where)
        if like is None:
            if node is not None:
                raise ValueError(f"checkpoint holds a value at {where!r} "
                                 "where the template has None")
            return None
        if _is_namedtuple(like):
            if not isinstance(node, dict) or "namedtuple" not in node:
                raise ValueError(f"checkpoint has no {type(like).__name__} "
                                 f"at {where!r}")
            fields = node["fields"]
            if set(fields) != set(like._fields):
                raise ValueError(
                    f"{type(like).__name__} fields at {where!r} differ: "
                    f"checkpoint {sorted(fields)}, template "
                    f"{sorted(like._fields)}")
            return type(like)(**{
                f: self.decode(fields[f], getattr(like, f), _join(path, f))
                for f in like._fields})
        if isinstance(like, dict):
            if not isinstance(node, dict) or "dict" not in node:
                raise ValueError(f"checkpoint has no dict at {where!r}")
            sub = node["dict"]
            if set(sub) != {str(k) for k in like}:
                raise ValueError(
                    f"keys at {where!r} differ: checkpoint {sorted(sub)}, "
                    f"template {sorted(str(k) for k in like)}")
            return {k: self.decode(sub[str(k)], v, _join(path, str(k)))
                    for k, v in like.items()}
        if isinstance(like, (bool, int, float)):
            if not isinstance(node, dict) or "value" not in node:
                raise ValueError(f"checkpoint has no value at {where!r}")
            return node["value"]
        raise TypeError(f"cannot restore a {type(like).__name__} at "
                        f"{where!r}")


def _same_device(want: Optional[torch.device], have: torch.device) -> bool:
    return want is None or (want.type == have.type
                            and want.index in (None, have.index))


def _read_payload(directory: Path, template, *, device=None,
                  cast: bool = False, subtree: Optional[str] = None):
    node = json.loads((directory / STATE_JSON).read_text())
    if subtree is not None:  # e.g. the params of a full training state
        if "namedtuple" in node:
            node = node["fields"][subtree]
        else:
            node = node["dict"][subtree]
    reader = _Reader(directory, device=device, cast=cast)
    out = reader.decode(node, template)
    if subtree is None and reader.taken != len(reader.files):
        raise ValueError(
            f"{directory} holds {len(reader.files)} tensors, the template "
            f"{reader.taken}: the trees differ")
    return out


# ---------------------------------------------------------------------------
# Save and load
# ---------------------------------------------------------------------------


def save_checkpoint(
    root: str,
    state: Any,
    cfg: Optional[RuntimeConfig] = None,
    iteration: Optional[int | str] = None,
    meta: Optional[dict] = None,
    *,
    retries: int = 3,
    keep: int = 0,
) -> Path:
    """Write ``state`` (a ``TrainState`` or any tree of tensors, host
    scalars and None), ``cfg`` and ``meta`` (host numbers
    such as ``consumed_samples``) and advance the tracker.

    Crash-safe: everything lands in ``iter_*.tmp`` first, one
    ``os.replace`` commits it, and the tracker moves last.  The payload
    write is retried ``retries`` times with exponential backoff; with
    ``keep > 0`` complete iterations beyond the newest ``keep`` are
    deleted."""
    if iteration is None:
        iteration = int(state.iteration)
    chaos().point("ckpt-begin")
    final = checkpoint_dir(root, iteration)
    staging = final.with_name(final.name + STAGING_SUFFIX)
    if staging.exists():  # stale leftover from a previous crash
        shutil.rmtree(staging)
    staging.mkdir(parents=True)
    chaos().point("ckpt-staging")
    try:
        with_retries(lambda: _write_payload(staging / "state", state),
                     site="ckpt-state-save", attempts=retries)
        if cfg is not None:
            _write_synced(staging / "config.json", cfg.to_json())
        if meta is not None:
            _write_synced(staging / "meta.json", json.dumps(meta))
        chaos().point("ckpt-pre-commit")
        if final.exists():  # re-saving the same iteration
            shutil.rmtree(final)
        os.replace(staging, final)  # the atomic commit
    except Exception:
        # a failed save (I/O gave up) must not litter the root; a
        # SimulatedCrash or a kill tears through this as a crash would
        shutil.rmtree(staging, ignore_errors=True)
        raise
    chaos().point("ckpt-pre-tracker")
    write_tracker(root, iteration)
    metrics_lib.RESILIENCE_EVENTS.inc("checkpoint_saves")
    if keep > 0:
        _gc_old_checkpoints(root, iteration, keep)
    return final


def _gc_old_checkpoints(root: str, current: int | str, keep: int) -> None:
    """Drop complete iterations beyond the newest ``keep`` (never the
    tracker's target, never ``release``) and stale staging directories
    other than the current iteration's."""
    target = read_tracker(root)
    complete = [it for it in list_iterations(root) if is_complete(root, it)]
    survivors = set(complete[-keep:])
    if isinstance(target, int):
        survivors.add(target)
    for it in complete:
        if it not in survivors:
            shutil.rmtree(checkpoint_dir(root, it), ignore_errors=True)
            metrics_lib.RESILIENCE_EVENTS.inc("checkpoint_gc_deleted")
    current_staging = checkpoint_dir(root, current).name + STAGING_SUFFIX
    for p in Path(root).glob(f"iter_*{STAGING_SUFFIX}"):
        if p.name != current_staging:
            shutil.rmtree(p, ignore_errors=True)


def load_meta(root: str, iteration: Optional[int | str] = None) -> dict:
    if iteration is None:
        iteration = read_tracker(root)
        if iteration is None:
            return {}
    meta_file = checkpoint_dir(root, iteration) / "meta.json"
    if not meta_file.exists():
        return {}
    return json.loads(meta_file.read_text())


def resolve_load_target(root: str) -> int | str:
    """The tracker's target if complete; else the newest complete
    iteration (with a loud warning: the torn-checkpoint recovery path);
    else a complete ``release``; else FileNotFoundError."""
    target = read_tracker(root)
    if target is not None and is_complete(root, target):
        return target
    fallback = latest_complete_iteration(root)
    if fallback is None and is_complete(root, RELEASE):
        fallback = RELEASE
    if fallback is None:
        if target is None:
            raise FileNotFoundError(
                f"no {TRACKER_FILENAME} under {root} and no complete "
                "checkpoint found; nothing to load")
        raise FileNotFoundError(
            f"tracker under {root} points at {target!r} which is torn or "
            "missing, and no complete checkpoint exists to fall back to")
    if target is not None:
        logger.warning(
            "tracker under %s points at %r which is incomplete (interrupted "
            "save?); falling back to newest complete checkpoint %r",
            root, target, fallback)
    else:
        logger.warning(
            "no usable tracker under %s; recovered newest complete "
            "checkpoint %r by directory scan", root, fallback)
    metrics_lib.RESILIENCE_EVENTS.inc("checkpoint_fallbacks")
    return fallback


def load_checkpoint(
    root: str,
    template: Any,
    iteration: Optional[int | str] = None,
    *,
    retries: int = 3,
    device=None,
) -> tuple[Any, int | str]:
    """Restore a tree shaped like ``template`` → ``(state, iteration)``;
    the template's tensors receive the checkpoint's values.

    Unpinned, the tracker's target is loaded, or (if it is torn) the
    newest complete checkpoint; a pinned incomplete iteration fails hard.
    A ``release`` checkpoint (params only, a conversion's output) restores
    ``template.params`` and keeps the template's fresh optimizer state,
    its fp32 master refreshed from the loaded params."""
    if iteration is None:
        iteration = resolve_load_target(root)
    if iteration == RELEASE:
        params = load_release_params(root, template.params, device=device)
        state = template._replace(params=params)
        opt = getattr(state, "opt", None)
        if opt is not None and opt.master is not None:
            from .utils.tree import tree_leaves

            with torch.no_grad():
                for m, p in zip(tree_leaves(opt.master), tree_leaves(params)):
                    m.copy_(p)
        return state, iteration
    path = checkpoint_dir(root, iteration)
    if not is_complete(root, iteration):
        raise FileNotFoundError(
            f"checkpoint {path} has no complete state/ payload: the save "
            "was interrupted or the directory was lost; refusing to fall "
            "back silently from a pinned iteration (pin "
            "iteration='release' to load base weights)")
    state = with_retries(
        lambda: _read_payload(path / "state", template, device=device),
        site="ckpt-restore", attempts=retries)
    return state, iteration


def load_config_from_checkpoint(
    root: str, iteration: Optional[int | str] = None
) -> RuntimeConfig:
    """The saved ``RuntimeConfig`` (``--use_checkpoint_args``)."""
    if iteration is None:
        iteration = read_tracker(root)
        if iteration is None:
            raise FileNotFoundError(f"no checkpoint tracker under {root}")
    cfg_file = checkpoint_dir(root, iteration) / "config.json"
    return RuntimeConfig.from_json(cfg_file.read_text())


def save_release_params(root: str, params: Any,
                        cfg: Optional[RuntimeConfig] = None) -> Path:
    """Write a params-only ``release`` checkpoint (the output of weight
    conversion), with the same staged commit as ``save_checkpoint``."""
    final = checkpoint_dir(root, RELEASE)
    staging = final.with_name(final.name + STAGING_SUFFIX)
    if staging.exists():
        shutil.rmtree(staging)
    staging.mkdir(parents=True)
    try:
        _write_payload(staging / "params", params)
        if cfg is not None:
            _write_synced(staging / "config.json", cfg.to_json())
        if final.exists():
            shutil.rmtree(final)
        os.replace(staging, final)
    except Exception:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    write_tracker(root, RELEASE)
    return final


def load_release_params(root: str, template: Any, device=None) -> Any:
    """The params of a ``release`` checkpoint, shaped like ``template``,
    on the template's device (or ``device``)."""
    return _read_payload(_payload(root, RELEASE), template, device=device)


def load_params_for_inference(root: str, model_cfg: Any,
                              iteration: Optional[int | str] = None,
                              device=None) -> Any:
    """The parameter tree alone, for serving or evaluation, from a
    ``release`` or a full training checkpoint (whose optimizer moments and
    master are never read), on ``device`` (default ``cuda``) in
    ``model_cfg``'s dtype.  The template is ``init_params`` on the
    ``meta`` device: shapes and dtypes, no memory."""
    from .models import model as model_lib

    template = model_lib.init_params(model_cfg, device="meta")
    device = model_lib.default_device(device)
    if iteration is None:
        iteration = resolve_load_target(root)
    if not is_complete(root, iteration):
        raise FileNotFoundError(
            f"checkpoint {checkpoint_dir(root, iteration)} is incomplete")
    payload = _payload(root, iteration)
    return _read_payload(payload, template, device=device, cast=True,
                         subtree=None if iteration == RELEASE else "params")
