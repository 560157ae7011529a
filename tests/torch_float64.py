"""Run the JAX package and the port in float64, for the tests that hold
an fp32 comparison's limit to the fp32 rounding noise it has to absorb.

Both packages pin fp32 in places: casts (``.astype(jnp.float32)``,
``.float()``), the ``"float32"`` entry of each config's dtype table, the
rope and mask tables' default dtypes, and the port's host arithmetic for
the lr schedule and Adam's bias corrections, which rounds to fp32 as
JAX's step does.  ``float64_everywhere`` widens each of them to float64
for the duration of a ``with`` block (and turns on ``jax_enable_x64``),
so the same code runs in float64 throughout.  Parameters drawn inside the
block come from float64 random streams; draw them outside and cast.
"""

from __future__ import annotations

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@contextlib.contextmanager
def float64_everywhere():
    import megatron_llm_tpu.config as jconfig
    import megatron_llm_tpu_torch.config as tconfig
    from megatron_llm_tpu.models import transformer as jtransformer
    from megatron_llm_tpu_torch.models import transformer as ttransformer
    from megatron_llm_tpu_torch.ops import attention as tattention
    from megatron_llm_tpu_torch.training import optimizer as toptimizer
    from megatron_llm_tpu_torch.training import schedule as tschedule

    mp = pytest.MonkeyPatch()
    to_fp32 = torch.Tensor.float
    try:
        with jax.enable_x64(True):
            mp.setattr(jnp, "float32", jnp.float64)
            mp.setattr(torch, "float32", torch.float64)
            mp.setattr(torch.Tensor, "float",
                       lambda t, *a, **k: t if t.dtype == torch.float64
                       else to_fp32(t, *a, **k))
            mp.setitem(jconfig._DTYPES, "float32", jnp.float64)
            mp.setitem(tconfig._DTYPES, "float32", torch.float64)
            mp.setattr(jtransformer.rope_tables, "__defaults__",
                       (jnp.float64,))
            mp.setattr(ttransformer.rope_tables, "__defaults__",
                       (torch.float64, None))
            mask_defaults = list(tattention.make_causal_mask.__defaults__)
            mask_defaults[0] = torch.float64
            mp.setattr(tattention.make_causal_mask, "__defaults__",
                       tuple(mask_defaults))
            mp.setattr(tschedule, "_f", np.float64)
            mp.setattr(toptimizer, "np",
                       types.SimpleNamespace(float32=np.float64))
            yield
    finally:
        mp.undo()


def as_float64(tree):
    """A JAX parameter tree (or numpy leaves) cast to float64 numpy."""
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float64), tree)
