"""Atomic filesystem commits and bounded retry around checkpoint I/O
(mirror of ``megatron_llm_tpu/resilience/io.py``).

- ``atomic_write_text``: tmp file + fsync + ``os.replace``; a reader sees
  the old content or the new, never a torn write (rename(2) is atomic
  within one filesystem);
- ``with_retries``: exponential backoff, capped, around a checkpoint read
  or write, because a shared filesystem fails transiently and a long run
  must not die on one error.

Both consult the chaos controller so the failure paths are testable.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, TypeVar

from .chaos import chaos

T = TypeVar("T")
BASE_DELAY_S = 0.05  # the first retry's wait; it doubles each retry
MAX_DELAY_S = 2.0


def atomic_write_text(path: str | Path, text: str,
                      site: str = "atomic-replace") -> None:
    """Write ``text`` to ``path`` so a crash never leaves a torn file."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    chaos().point(site)  # crash window: tmp written, target untouched
    os.replace(tmp, path)


def with_retries(fn: Callable[[], T], *, site: str, attempts: int = 3) -> T:
    """Run ``fn`` with exponential backoff on ``OSError``.

    ``site`` names the operation for chaos injection and event counting.
    The last failure propagates once ``attempts`` are exhausted.
    """
    from .. import metrics as metrics_lib

    assert attempts >= 1
    for attempt in range(attempts):
        try:
            chaos().io_attempt(site)
            return fn()
        except OSError:
            if attempt + 1 >= attempts:
                metrics_lib.RESILIENCE_EVENTS.inc("io_giveups")
                raise
            metrics_lib.RESILIENCE_EVENTS.inc("io_retries")
            time.sleep(min(BASE_DELAY_S * 2 ** attempt, MAX_DELAY_S))
    raise AssertionError("unreachable")
