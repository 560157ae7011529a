"""Fault tolerance for long runs (mirror of
``megatron_llm_tpu/resilience``):

- ``io``      atomic filesystem commits (tmp + ``os.replace``) and
              retry with exponential backoff around checkpoint I/O;
- ``anomaly`` the train step's NaN / loss-spike guard, carried in the
              ``TrainState`` so skip decisions survive a checkpoint;
- ``chaos``   the deterministic fault-injection harness the recovery
              tests drive; inert in production.
"""

from .anomaly import GuardState, guard_update, init_guard_state  # noqa: F401
from .chaos import Chaos, SimulatedCrash, chaos, poison_nan  # noqa: F401
from .io import atomic_write_text, with_retries  # noqa: F401
