"""Build the port's host-side C++ helpers with ``g++`` and load them with
ctypes (mirror of ``megatron_llm_tpu/utils/native.py``).

Each source compiles on its own into
``<repo>/build/native/<name>-<hash>.so``::

    g++ -O3 -shared -fPIC -std=c++17 -o build/native/<name>-<hash>.so <src>

The hash covers the source and the flags, as ``kernels/build.py`` does for
``nvcc``: an edited source rebuilds and an unchanged one is reused.  The
compile writes to a temporary name and renames, so parallel workers racing
the build load a complete library or build their own.

Unlike JAX's loader, a failed build raises: the native and numpy index
builders draw different random streams, so a silent fallback would change
the mix of samples.  Callers that want the Python paths ask for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import uuid
from pathlib import Path

from ..analysis.sanitizers import note_compile

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: dict = {}


class NativeBuildError(RuntimeError):
    """``g++`` is missing or failed on a helper's source."""


def target(src: Path, flags=GXX_FLAGS) -> Path:
    h = hashlib.sha256(Path(src).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:12]}.so"


def compile_and_load(src: Path, timeout: int = 300,
                     compiler: str = "g++") -> ctypes.CDLL:
    """Build ``src`` into ``build/native/`` if its hashed library is
    missing, then open it.  Raises ``NativeBuildError`` when the compiler
    is missing or fails."""
    src = Path(src)
    out = target(src)
    with _lock:
        if out in _libs:
            return _libs[out]
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{uuid.uuid4().hex}.tmp")
            note_compile(f"{compiler}:{src.name}")
            try:
                done = subprocess.run(
                    [compiler, *GXX_FLAGS, "-o", str(tmp), str(src)],
                    capture_output=True, text=True, timeout=timeout)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise NativeBuildError(
                    f"building {src.name} with {compiler} failed: {e}") \
                    from e
            if done.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeBuildError(
                    f"{compiler} failed on {src.name} (exit "
                    f"{done.returncode}):\n{done.stderr[-4000:]}")
            tmp.replace(out)  # atomic publish
        lib = ctypes.CDLL(str(out))
        _libs[out] = lib
        return lib
