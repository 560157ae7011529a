"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``<repo>/build/kernels/<name>-<hash>.so`` for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The hash covers the source and the flags, so an edited kernel rebuilds
and an unchanged one is reused; each build started counts as a compile
for the recompilation guard (``analysis/sanitizers.no_recompiles``).
A source in ``SPLIT`` compiles as several translation units at once (``-c
-D<MACRO>=i``, one kernel each, and one the C interface) linked into the
one library: ``decode_step.cu``'s four instantiations took ~200 s in one
``nvcc``, ``flash_decode.cu``'s four kernels (96 instantiations) ~99 s.  ``build_all`` starts every ``nvcc`` at once (and records each
one's seconds); ``load`` builds (if needed) and opens one library.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..analysis.sanitizers import note_compile

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "flash_decode",
           "decode_step")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


# sources built as separate translation units in parallel and linked into
# one library: the macro that selects a unit, and the number of units
SPLIT = {"decode_step": ("DECODE_STEP_PART", 5),
         "flash_decode": ("FLASH_DECODE_PART", 5)}

# seconds each nvcc of the last ``build_all`` took, by name (its own wall
# time: the builds run in parallel); a split source's units under
# ``<name>.<i>`` and under its name the time to its last unit's end plus
# its link's own seconds
NVCC_SECONDS: dict = {}


class _Started:
    """The ``nvcc`` processes of one library (one, or one a unit of a split
    source, whose objects are linked when all have ended)."""

    def __init__(self, name, tmp, out, units):
        self.name, self.tmp, self.out = name, tmp, out
        self.units = units          # [(label, proc, log, obj or None, t0)]
        self.t0 = min(u[4] for u in units)
        self.last_end = self.t0

    def poll(self) -> bool:
        """True once every unit has ended; records each unit's seconds."""
        done = True
        for label, proc, _, _, t0 in self.units:
            if proc.poll() is None:
                done = False
            elif label not in NVCC_SECONDS:
                self.last_end = time.perf_counter()
                NVCC_SECONDS[label] = self.last_end - t0
        return done


def _spawn(cmd, log_path):
    log = open(log_path, "w+")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True)
    return proc, log


def _start(name: str, src=None, out=None, flags=()):
    """Start ``nvcc`` for one source (``csrc/<name>.cu``, or ``src`` into
    ``out`` with extra ``flags``); None when the library is current."""
    out = _target(name) if out is None else out
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    note_compile(f"nvcc:{name}")
    # a probe's copy of a split source (``flash_decode_<variant>.cu``)
    # splits as its source does
    split = SPLIT.get(src.stem) or next(
        (v for k, v in SPLIT.items() if src.stem.startswith(k + "_")), None)
    units = []
    if split is None:
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        proc, log = _spawn(cmd, out.with_suffix(f".{os.getpid()}.log"))
        units.append((name, proc, log, None, time.perf_counter()))
    else:
        macro, n = split
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        for i in range(n):
            obj = out.with_suffix(f".{os.getpid()}.{i}.o")
            cmd = [nvcc_path(), *compile_flags, *flags, "-c",
                   f"-D{macro}={i}", "-o", str(obj), str(src)]
            proc, log = _spawn(cmd,
                               out.with_suffix(f".{os.getpid()}.{i}.log"))
            units.append((f"{name}.{i}", proc, log, obj,
                          time.perf_counter()))
    return _Started(name, tmp, out, units)


def _finish(name: str, started) -> str:
    """Wait for ``_start``'s nvcc (and link a split source's objects); its
    output."""
    if started is None:
        return ""
    texts, failed = [], []
    for label, proc, log, _, _ in started.units:
        proc.wait()
        log.seek(0)
        texts.append(log.read())
        log.close()
        os.unlink(log.name)
        if proc.returncode != 0:
            failed.append(label)
    started.poll()
    text = "".join(texts)
    objs = [u[3] for u in started.units if u[3] is not None]
    if failed:
        for obj in objs:
            if obj.exists():
                obj.unlink()
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{text}")
    if objs:
        t_link = time.perf_counter()
        res = subprocess.run([nvcc_path(), "-shared", "-o",
                              str(started.tmp), *map(str, objs)],
                             capture_output=True, text=True)
        NVCC_SECONDS[name] = (started.last_end - started.t0
                              + time.perf_counter() - t_link)
        for obj in objs:
            obj.unlink()
        if res.returncode != 0:
            raise RuntimeError(f"linking {name} failed:\n{res.stdout}"
                               f"{res.stderr}")
    os.replace(started.tmp, started.out)
    return text


def build_all(names=SOURCES, extra=()) -> dict:
    """Compile every listed source in parallel (one nvcc each, one a unit
    of a split source), and beside them each ``(name, src, out, flags)``
    of ``extra`` (a probe's variant of a source); ``{name: nvcc
    output}``.  Each build's own seconds go to ``NVCC_SECONDS``."""
    with _lock:
        NVCC_SECONDS.clear()
        started = {n: _start(n) for n in names}
        started.update({e[0]: _start(*e) for e in extra})
        pending = [s for s in started.values() if s is not None]
        while pending:
            pending = [s for s in pending if not s.poll()]
            time.sleep(0.2)
        return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def print_ptxas(log: str, name=None) -> None:
    """One line for each kernel instantiation of an ``nvcc -Xptxas -v``
    log: its name (mangled, or through ``name``), registers, and stack
    frame and spills."""
    kern, frame = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kern = m.group(1) if name is None else name(m.group(1))
            frame = ""
        elif kern and "stack frame" in line:
            frame = line.strip()
        elif kern and "Used" in line and "registers" in line:
            print(f"ptxas {kern}: {line.split(':', 1)[-1].strip()}; {frame}")
            kern = None


def check(err: int, what: str) -> None:
    """Raise when a launch function returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
