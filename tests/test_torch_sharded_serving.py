"""Sharded serving: the port's ``build_sharded_engine`` in gloo worlds of 2
and 4 CPU ranks against the JAX package (mirror of
``tests/serving/test_cluster.py``'s sharded-engine parity and
``tests/serving/test_pp_serving.py``).

One world of each size (``tests/torch_world.py``) runs every case of the
module; JAX's single-chip engine and its ``forward_cached`` run in the
pytest process on JAX's tiny fp32 config, whose weights cross to the
ranks.  Greedy tokens are held equal to JAX's, as JAX's own sharded
engines are held to its single-chip engine; logits within 1e-4.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.ops import quant as jquant
from megatron_llm_tpu.serving import EngineConfig as JEngineConfig
from megatron_llm_tpu.serving import ServingEngine as JServingEngine
from megatron_llm_tpu_torch import checkpointing
from megatron_llm_tpu_torch.config import RuntimeConfig as TRun
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.serving import EngineConfig, ServingEngine
from megatron_llm_tpu_torch.tools import run_text_generation_server as rtgs

import torch_world

torch.set_num_threads(1)

KW = dict(num_layers=2, vocab_size=64, make_vocab_size_divisible_by=8)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(max_batch_size=2, max_seq_len=64, max_queue_size=32,
              prefill_bucket=16)
TP2, PP2 = dict(tensor_parallel=2), dict(pipeline_parallel=2)
FSDP2 = dict(fsdp=2)
CACHES = ("none", "int8")


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, KW["vocab_size"],
                         int(rng.integers(4, 12))).tolist()
            for _ in range(n)]


def _specs(seed=0, new=10, **kw):
    return [dict(prompt=p, max_new_tokens=new, seed=i, use_eos_stop=False,
                 **kw) for i, p in enumerate(_prompts(3, seed))]


GREEDY = _specs()
SPEC = _specs(seed=7, new=12)
SAMPLED = [dict(s, temperature=0.8, top_k=8, top_p=0.9) for s in _specs(3)]


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(jax.random.key(0), jtiny(**KW))


def _jax_tokens(jp, specs, kv_quant="none", weights=None, **ec):
    import dataclasses

    cfg = jtiny(**KW)
    if kv_quant != "none":
        cfg = dataclasses.replace(cfg, kv_cache_quant=kv_quant).validate()
    if weights:
        jp = jquant.quantize_params(jp, weights)
    engine = JServingEngine(cfg, jp, JEngineConfig(**ENGINE, **ec)).start()
    try:
        return [list(h.result(120).tokens)
                for h in engine.submit_many(specs)]
    finally:
        engine.shutdown()


def _run(name, parallel, batches, kv_quant=None, weights=None, **ec):
    return dict(name=name, parallel=parallel, batches=batches,
                kv_quant=None if kv_quant == "none" else kv_quant,
                weights=weights, engine=dict(ENGINE, **ec))


def _world2_runs():
    runs = []
    for cache in CACHES:
        for pipe in (True, False):
            tag = f"{cache}_{'pipelined' if pipe else 'classic'}"
            runs.append(_run(f"tp2_{tag}", TP2, [GREEDY], cache,
                             pipeline_decode=pipe))
            runs.append(_run(f"pp2_{tag}", PP2, [GREEDY], cache,
                             pipeline_decode=pipe, sanitize=True))
    runs.append(_run("pp2_spec", PP2, [SPEC], spec_draft_len=3,
                     sanitize=True))
    runs.append(_run("pp2_nospec", PP2, [SPEC], sanitize=True))
    runs.append(_run("tp2_int8_weights", TP2, [GREEDY], weights="int8"))
    runs.append(_run("fsdp2", FSDP2, [GREEDY]))
    runs.append(_run("tp2_sampled", TP2, [SAMPLED]))
    # 4-token blocks: the prompts (4-11 tokens) share whole blocks
    runs.append(_run("tp2_prefix", TP2, [GREEDY, GREEDY], kv_block_size=4))
    return runs


@pytest.fixture(scope="module")
def release(jparams, tmp_path_factory):
    root = tmp_path_factory.mktemp("release")
    checkpointing.save_release_params(
        str(root), params_from_jax(jax.tree.map(np.asarray, jparams),
                                   device="cpu"), TRun(model=ttiny(**KW)))
    return str(root)


CLI_BODY = {"prompts": ["3 14 15 9 2 6", "5 35 8 9"], "tokens_to_generate": 7}


def _cli_argv(root, tp=1):
    return ["--load", root, "--use_checkpoint_args", "--tokenizer_type",
            "null", "--max_batch_size", "2", "--max_seq_len", "64",
            "--prefill_bucket", "8", "--kv_block_size", "8", "--no_trace",
            "--max_tokens_to_generate", "32", "--metrics_interval_s", "0",
            "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
            "--tp", str(tp)]


FWD_TOKENS = np.random.default_rng(5).integers(1, 64, (2, 9)).astype(np.int64)
FWD_STEP = np.random.default_rng(6).integers(1, 64, (2, 1)).astype(np.int64)
LAYOUTS = {"tp2": TP2, "pp2": PP2, "fsdp2": FSDP2}


@pytest.fixture(scope="module")
def worlds(jparams, release, tmp_path_factory):
    params = jax.tree.map(np.asarray, jparams)
    model = ("tiny_config", KW)
    jobs2 = [
        ("sharded_serving_case", {"params": params},
         dict(model=model, runs=_world2_runs())),
        ("sharded_forward_case",
         {"params": params, "tokens": FWD_TOKENS, "step": FWD_STEP},
         dict(model=model, layouts=LAYOUTS, block=6)),
        ("serving_cli_case", {},
         dict(argv=_cli_argv(release, tp=2), body=CLI_BODY)),
        # the last job: its fault leaves the world
        ("sharded_lifecycle_case", {"params": params},
         dict(model=model, engine=ENGINE, timeout_s=2, idle_s=4,
              prompt=_prompts(1)[0])),
    ]
    jobs4 = [("sharded_serving_case", {"params": params},
              dict(model=model, runs=[
                  _run("tp2pp2", dict(TP2, **PP2), [GREEDY],
                       sanitize=True)]))]
    out2 = torch_world.run_world(2, tmp_path_factory.mktemp("w2"), jobs2)
    out4 = torch_world.run_world(4, tmp_path_factory.mktemp("w4"), jobs4)
    return {"serve": json.loads(str(out2[0]["result"])),
            "forward": out2[1],
            "cli": json.loads(str(out2[2]["result"])),
            "life": json.loads(str(out2[3]["result"])),
            "serve4": json.loads(str(out4[0]["result"]))}


@pytest.fixture(scope="module")
def jax_refs(jparams):
    return {"none": _jax_tokens(jparams, GREEDY),
            "int8": _jax_tokens(jparams, GREEDY, "int8"),
            "int8_weights": _jax_tokens(jparams, GREEDY, weights="int8"),
            "spec": _jax_tokens(jparams, SPEC)}


@pytest.mark.parametrize("cache", CACHES)
@pytest.mark.parametrize("pipeline", ["pipelined", "classic"])
@pytest.mark.parametrize("layout", ["tp2", "pp2"])
def test_sharded_engine_tokens_match_jax(worlds, jax_refs, layout, cache,
                                         pipeline):
    """tp = 2 and pp = 2 across fp32 / int8 caches and pipelined /
    classic decode commit JAX's single-chip engine's greedy tokens; every
    rank sampled the same tokens at every step; pp = 2 splits each step
    into two groups with the block ledger balanced."""
    res = worlds["serve"][f"{layout}_{cache}_{pipeline}"]
    for batch in res["tokens"]:
        assert batch == jax_refs[cache]
    assert res["ranks_agree"] and res["steps"] > 0
    assert res["groups"] == (2 if layout == "pp2" else 1)
    assert res["fused"] == [False, False]
    if layout == "pp2":
        assert res["leaks"] == []


@pytest.mark.parametrize("spec", ["spec", "nospec"])
def test_pp_engine_speculative_matches_jax(worlds, jax_refs, spec):
    """pp = 2 with n-gram speculation on and off commits JAX's tokens."""
    res = worlds["serve"][f"pp2_{spec}"]
    assert res["tokens"] == [jax_refs["spec"]]
    assert res["groups"] == 2 and res["leaks"] == [] and res["ranks_agree"]


@pytest.mark.parametrize("name,ref", [("tp2pp2", "none"), ("fsdp2", "none"),
                                      ("tp2_int8_weights", "int8_weights")])
def test_other_layouts_match_jax(worlds, jax_refs, name, ref):
    """tp2 x pp2 (a world of 4), fsdp = 2 and int8 weights at tp = 2
    (against JAX's int8 single-chip engine) commit JAX's tokens."""
    res = (worlds["serve4"] if name == "tp2pp2" else worlds["serve"])[name]
    assert res["tokens"] == [jax_refs[ref]]
    assert res["ranks_agree"]
    if name == "tp2pp2":
        assert res["groups"] == 2 and res["leaks"] == []


def test_sampled_tokens_match_one_device_engine(worlds, jparams):
    """Seeded top-k / top-p sampling at tp = 2 commits the port's
    one-device engine's tokens (the same ``(seed, count)`` streams over
    the same logits) and every rank sampled the same."""
    engine = ServingEngine(
        ttiny(**KW), params_from_jax(jax.tree.map(np.asarray, jparams),
                                     device="cpu"),
        EngineConfig(**ENGINE), device="cpu").start()
    try:
        want = [list(h.result(120).tokens)
                for h in engine.submit_many(SAMPLED)]
    finally:
        engine.shutdown()
    res = worlds["serve"]["tp2_sampled"]
    assert res["tokens"] == [want] and res["ranks_agree"]


def test_prefix_hit_commits_the_cold_tokens(worlds, jax_refs):
    """The default prefix cache gives hits when the same prompts come
    again, and the hits commit the cold run's tokens."""
    res = worlds["serve"]["tp2_prefix"]
    cold, again = res["tokens"]
    assert res["prefix_hits"] > 0 and again == cold == jax_refs["none"]


@pytest.mark.parametrize("name", ["tp2_none_pipelined", "pp2_none_pipelined",
                                  "fsdp2"])
def test_resident_bytes_are_split(worlds, name):
    """Rank 0 holds under 0.75 of the whole tree at tp = 2, pp = 2 and
    fsdp = 2; the pp pool holds half the layers, the tp pool half the
    heads."""
    b = worlds["serve"][name]["bytes"]
    assert b["params"] < 0.75 * b["whole"], b
    if name != "fsdp2":
        assert 2 * b["pool"] == b["whole_pool"], b


def test_pp_kv_snapshot_stages(worlds):
    """``kv_snapshot()["stages"]``: contiguous layer slabs over the stack,
    disjoint ranks, the same ledger view on every stage."""
    stages = worlds["serve"]["pp2_none_pipelined"]["stages"]
    assert [s["stage"] for s in stages] == [0, 1]
    assert stages[0]["layers"] == [0, KW["num_layers"] // 2]
    assert stages[1]["layers"] == [KW["num_layers"] // 2, KW["num_layers"]]
    assert stages[0]["devices"] == [0] and stages[1]["devices"] == [1]
    for key in ("blocks_free", "blocks_used", "fragmentation"):
        assert stages[0][key] == stages[1][key]
    four = worlds["serve4"]["tp2pp2"]["stages"]
    assert [s["devices"] for s in four] == [[0, 1], [2, 3]]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_forward_logits_match_jax(worlds, jparams, layout):
    """``forward_cached`` (a prefill, then one step) and
    ``forward_cached_paged`` (the step over the prefill's rows in a pool)
    on each layout's shards are within 1e-4 of JAX's ``forward_cached``,
    and every rank holds the same logits."""
    cfg = jtiny(**KW)
    b, s = FWD_TOKENS.shape
    jk, jv = jm.init_kv_cache(cfg, b, 2 * s)
    pre, jk, jv = jm.forward_cached(cfg, jparams, jnp.asarray(FWD_TOKENS),
                                    jk, jv, jnp.int32(0), empty_cache=True)
    step, _, _ = jm.forward_cached(cfg, jparams, jnp.asarray(FWD_STEP), jk,
                                   jv, jnp.int32(s))
    out = worlds["forward"][layout]
    np.testing.assert_allclose(out["prefill"], np.asarray(pre), **LOGIT_TOL)
    for key in ("step", "paged"):
        np.testing.assert_allclose(out[key], np.asarray(step), **LOGIT_TOL)
    for key in ("prefill", "step", "paged"):
        assert bool(out[f"{key}_agree"])


def test_cli_tp2_answers_like_the_one_rank_service(worlds, release):
    """``run_text_generation_server --tp 2`` in a world of two answers PUT
    /api with the in-process tp = 1 service's texts, and every rank's
    ``main`` returns 0 when rank 0's server shuts down."""
    ready, box = threading.Event(), {}

    def on_ready(server):
        box["server"] = server
        ready.set()

    thread = threading.Thread(target=lambda: box.setdefault(
        "rc", rtgs.main(_cli_argv(release), on_ready=on_ready)))
    thread.start()
    try:
        assert ready.wait(120), "the server did not start"
        req = urllib.request.Request(
            f"http://127.0.0.1:{box['server'].port}/api",
            data=json.dumps(CLI_BODY).encode(), method="PUT",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            want = json.loads(resp.read())["text"]
    finally:
        if "server" in box:
            box["server"].graceful_shutdown(10.0)
        thread.join(60)
    cli = worlds["cli"]
    assert cli["status"] == 200 and cli["text"] == want
    assert cli["rc"] == 0 and not cli["alive"]


def test_cli_tp2_without_a_world_names_torchrun(release):
    """``--tp 2`` in a world of one raises, naming the launcher."""
    with pytest.raises(ValueError, match="torchrun"):
        rtgs.main(_cli_argv(release, tp=2))


def test_idle_engine_outlives_the_channel_timeout(worlds):
    """An engine idle for twice its channel's timeout still serves (rank
    0's heartbeat), and its shutdown ends every rank's loop."""
    life = worlds["life"]
    assert len(life["idle_tokens"]) == len(_prompts(1)[0]) + 4
    assert life["all_returned"]


def test_worker_fault_raises_on_rank_0(worlds):
    """A worker whose decode raises makes rank 0's request raise with the
    worker's own message, at once, and rank 0 leaves the world."""
    life = worlds["life"]
    assert life["fault"] is not None
    assert "rank 1" in life["fault"] and "injected worker fault" in \
        life["fault"]
    assert life["fault_s"] < 30 and life["world_left"]


@pytest.mark.cuda
def test_engine_serves_on_cuda_without_an_index():
    """The server entry's default ``--device cuda`` names no index: the
    engine's scheduler thread takes the starting thread's current device
    (it died on ``torch.cuda.set_device`` before)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    cfg = ttiny(**KW)
    params = params_from_jax(jax.tree.map(
        np.asarray, jm.init_params(jax.random.key(0), jtiny(**KW))),
        device="cuda")
    engine = ServingEngine(cfg, params, EngineConfig(**ENGINE),
                           device="cuda").start()
    try:
        res = engine.submit(_prompts(1)[0], 4, use_eos_stop=False).result(120)
    finally:
        engine.shutdown()
    assert res.finish_reason == "length"
