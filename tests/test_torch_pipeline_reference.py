"""Pipeline parallelism against JAX, case by case: JAX's
``test_pipeline_matches_reference`` (dp, pp, tp, vpp, M) cases that fit
worlds of 2 and 4 CPU ranks, each held against JAX's unpipelined loss and
grads and against JAX's ``pipeline_loss`` (helpers and limits:
``tests/test_torch_pipeline.py``)."""

import numpy as np
import pytest
import torch

import test_torch_pipeline as tpl
import torch_world

torch.set_num_threads(1)

CASES = {
    "pp2_m3": (1, 2, 1, 1, 3),
    "pp4_m4": (1, 4, 1, 1, 4),
    "pp2_vpp2_m4": (1, 2, 1, 2, 4),     # interleaved, JAX's tight order
    "pp4_vpp2_m4": (1, 4, 1, 2, 4),
    "pp2_vpp2_m5": (1, 2, 1, 2, 5),     # JAX's legacy order (M % pp)
    "pp2_vpp3_m6": (1, 2, 1, 3, 6),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        jobs, names = [], []
        for name, degrees in CASES.items():
            dp, pp, tp, vpp, M = degrees
            if dp * pp * tp != world:
                continue
            kw, batch = tpl.case_inputs(degrees)
            jobs.append(("pipeline_case",
                         {"params": tpl._jparams(kw), "batch": batch},
                         tpl._meta(kw, dp, pp, tp, vpp, M)))
            names.append(name)
        tmp = tmp_path_factory.mktemp(f"piperef{world}")
        out.update(zip(names, torch_world.run_world(world, tmp, jobs)))
    return out


def check_case(out, degrees, name):
    kw, batch = tpl.case_inputs(degrees)
    params = tpl._jparams(kw)
    for what, (loss, grads) in (
            ("unpipelined", tpl._reference(kw, params, batch)),
            ("JAX pipeline", tpl._jax_pipeline(kw, degrees, params, batch))):
        np.testing.assert_allclose(float(out["loss"]), loss, **tpl.LOSS_TOL)
        tpl._assert_grads(out["grads"], grads, f"{name} vs {what}")


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_reference(worlds, name):
    """The port's pipelined loss and grads at each of JAX's (dp, pp, tp,
    vpp, M) cases equal JAX's unpipelined loss and grads and JAX's
    ``pipeline_loss`` and its grads."""
    check_case(worlds[name], CASES[name], name)
