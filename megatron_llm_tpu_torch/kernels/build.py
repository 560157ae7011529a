"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``<repo>/build/kernels/<name>-<hash>.so`` for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The hash covers the source and the flags, so an edited kernel rebuilds
and an unchanged one is reused.  ``build_all`` starts one ``nvcc`` per
source at once (and records each one's seconds); ``load`` builds (if
needed) and opens one library.
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


# seconds each nvcc of the last ``build_all`` took, by name (its own wall
# time: the builds run in parallel)
NVCC_SECONDS: dict = {}


def _start(name: str, src=None, out=None, flags=()):
    """Start ``nvcc`` for one source (``csrc/<name>.cu``, or ``src`` into
    ``out`` with extra ``flags``); None when the library is current."""
    out = _target(name) if out is None else out
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(f".{os.getpid()}.log"), "w+")
    src = CSRC / f"{name}.cu" if src is None else src
    cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, log, time.perf_counter()


def _finish(name: str, started) -> str:
    """Wait for ``_start``'s nvcc; its output."""
    if started is None:
        return ""
    proc, tmp, out, log, t0 = started
    proc.wait()
    NVCC_SECONDS.setdefault(name, time.perf_counter() - t0)
    log.seek(0)
    text = log.read()
    log.close()
    os.unlink(log.name)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{text}")
    os.replace(tmp, out)
    return text


def build_all(names=SOURCES, extra=()) -> dict:
    """Compile every listed source in parallel (one nvcc each), and beside
    them each ``(name, src, out, flags)`` of ``extra`` (a probe's variant
    of a source); ``{name: nvcc output}``.  Each build's own seconds go to
    ``NVCC_SECONDS``."""
    with _lock:
        NVCC_SECONDS.clear()
        started = {n: _start(n) for n in names}
        started.update({e[0]: _start(*e) for e in extra})
        pending = {n: s for n, s in started.items() if s is not None}
        while pending:
            for n, s in list(pending.items()):
                if s[0].poll() is not None:
                    NVCC_SECONDS[n] = time.perf_counter() - s[4]
                    del pending[n]
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
