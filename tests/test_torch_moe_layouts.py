"""Mixture of experts under context parallelism (the contiguous and zigzag
layouts) and under tensor parallelism with sequence parallelism, in gloo
worlds of two and four CPU ranks, against the JAX package.

- ``moe_block``: each rank routes its block of the sequence as the step
  lays it out (cp: ``s / cp`` contiguous tokens, or the zigzag chunk
  pair; SP: ``s / tp`` tokens, gathered inside the block); the output
  gathered back, the aux summed over cp (each rank's share) and the
  dropped fraction and load, against JAX's ``moe_block`` on the whole
  sequence (the permuted one under zigzag, as JAX's step permutes it);
- one microbatch's loss and gathered grads through the step
  (``training/step.step_grads``) at cp = 2 and at tp = 2 + SP, against
  JAX's unsharded ``compute_loss`` (what JAX's GSPMD step computes; the
  router's grad included);
- two steps of ``pretrain`` at each layout against JAX's driver at the
  same degrees on its CPU mesh;
- routing groups that straddle the two cp blocks (the default 512-token
  group of a 32-token sequence: one group) are routed whole on both
  ranks, with JAX's result.

The limits are ``tests/test_torch_moe.py``'s: outputs 2e-5, grads rtol
5e-4 / atol 5e-5, train losses 1e-4; the stats 1e-6.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ParallelConfig as JPar
from megatron_llm_tpu.config import RuntimeConfig as JRun
from megatron_llm_tpu.config import OptimizerConfig as JOpt
from megatron_llm_tpu.config import TrainConfig as JTrain
from megatron_llm_tpu.models import moe as jmoe
from megatron_llm_tpu.parallel.ring_attention import zigzag_indices
from megatron_llm_tpu.training import driver as jdriver
from megatron_llm_tpu.training import step as jstep

import test_torch_moe as tm
import torch_world

torch.set_num_threads(1)

# routing groups of 8 tokens: whole inside a cp block (16) and a zigzag
# chunk (8); the default 512 makes one group of the whole 32 tokens
KW = dict(tm.BASE, moe_group_size=8)
LAYOUTS = {"cp2": (KW, dict(context_parallel=2)),
           "cp2_zigzag": (KW, dict(context_parallel=2,
                                   context_parallel_layout="zigzag")),
           "cp2_straddling": (tm.BASE, dict(context_parallel=2)),
           "tp2_sp": (KW, dict(tensor_parallel=2, sequence_parallel=True)),
           "tp2_sp_cp2_straddling": (tm.BASE, dict(
               tensor_parallel=2, sequence_parallel=True,
               context_parallel=2))}
WORLD = {name: par.get("tensor_parallel", 1) * par.get("context_parallel", 1)
         for name, (_, par) in LAYOUTS.items()}


def _x():
    return np.random.default_rng(1).normal(size=(2, 32, 32)).astype(
        np.float32)


def _layer():
    return jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.key(1), tm._jcfg()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = {}
    for size in sorted(set(WORLD.values())):
        jobs, names = [], []
        for name, (kw, par) in LAYOUTS.items():
            if WORLD[name] != size:
                continue
            meta = dict(model=("ModelConfig", kw), parallel=par,
                        train=dict(seq_length=32, micro_batch_size=4,
                                   global_batch_size=4))
            jobs.append(("moe_layout_case",
                         {"x": _x(), "layer": _layer(),
                          "params": tm._jparams(),
                          "batch": tm._grad_batch()}, meta))
            names.append(name)
            jobs.append(("pretrain_case",
                         {"params": tm._jparams(),
                          "batches": tm._batches()},
                         dict(model=("ModelConfig", kw), parallel=par,
                              optimizer=tm.OPT, train=tm.TRAIN)))
            names.append(f"{name}_train")
        out.update(zip(names, torch_world.run_world(
            size, tmp_path_factory.mktemp(f"moe_layouts{size}"), jobs)))
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_moe_block_layouts_match_jax(world, name):
    """The routed MLP's output, the aux (the ranks' shares summed), the
    dropped fraction and the load equal JAX's on the whole sequence."""
    jc = tm._jcfg(**LAYOUTS[name][0])
    x = _x()
    order = zigzag_indices(32, 2) if "zigzag" in name else np.arange(32)
    jo, js = jmoe.moe_block(jc, jax.tree.map(jnp.asarray, _layer()),
                            jnp.asarray(x[:, order]))
    want = np.empty_like(x)
    want[:, order] = np.asarray(jo)
    out = world[name]
    np.testing.assert_allclose(out["out"], want, **tm.OUT_TOL)
    for k in ("aux", "dropped", "load"):
        np.testing.assert_allclose(out[k], np.asarray(js[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", [n for n in LAYOUTS if "zigzag" not in n])
def test_moe_step_grads_layouts_match_jax(world, name):
    """One microbatch's loss (the aux term included) and every gathered
    grad, the router's among them, equal JAX's unsharded ones."""
    rt = JRun(model=tm._jcfg(**LAYOUTS[name][0]), optimizer=JOpt(),
              train=JTrain(seq_length=32)).validate()
    jb = {k: jnp.asarray(v) for k, v in tm._grad_batch().items()}
    loss, grads = jax.value_and_grad(
        lambda p: jstep.compute_loss(rt, p, jb))(
            jax.tree.map(jnp.asarray, tm._jparams()))
    out = world[name]
    np.testing.assert_allclose(float(out["loss"]), float(loss), **tm.OUT_TOL)
    flat = torch_world.flatten(out["grads"])
    for k, w in torch_world.flatten(jax.tree.map(np.asarray,
                                                 grads)).items():
        np.testing.assert_allclose(flat[k], w, **tm.GRAD_TOL, err_msg=k)
    assert np.abs(flat["layers/mlp/router"]).sum() > 0


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_moe_train_layouts_match_jax(world, name, capsys):
    """Two steps of the port's ``pretrain`` log JAX's driver's losses at
    the same degrees (JAX's GSPMD step on its CPU mesh)."""
    kw, par = LAYOUTS[name]
    jc = JRun(model=tm._jcfg(**kw), parallel=JPar(**par),
              optimizer=JOpt(**tm.OPT), train=JTrain(**tm.TRAIN)).validate()
    batches = {k: {n: jnp.asarray(a) for n, a in v.items()}
               for k, v in tm._batches().items()}
    capsys.readouterr()
    jdriver.pretrain(jc, params=jax.tree.map(jnp.asarray,
                                             tm._jparams()),
                     batch_provider=tm._provider(batches))
    want = [float(x) for x in re.findall(r"lm loss: ([0-9.E+-]+) \|",
                                         capsys.readouterr().out)]
    got = world[f"{name}_train"]["losses"]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, **tm.STEP_TOL)
