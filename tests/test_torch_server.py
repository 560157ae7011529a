"""The port's HTTP server against the JAX package's, on the CPU.

Both servers listen on ``127.0.0.1:0`` with the same tiny weights (JAX's,
carried across with ``params_from_jax``) and the slice's engine
configuration, and answer the same PUT /api bodies.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import tiny_config as jtiny
from megatron_llm_tpu.generation.server import MegatronServer as JServer
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.tokenizer.tokenizer import NullTokenizer as JNull
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation import MegatronServer
from megatron_llm_tpu_torch.tokenizer import NullTokenizer

torch.set_num_threads(1)

SERVICE = dict(max_batch_size=2, engine_max_seq_len=64, prefill_bucket=8,
               kv_block_size=8, prefix_cache_blocks=0, trace=False,
               max_tokens_to_generate=32)


def _call(port, body, method="PUT", path="/api"):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            raw = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    try:
        return status, json.loads(raw)
    except json.JSONDecodeError:
        return status, raw.decode()


@pytest.fixture(scope="module")
def servers():
    jc = jtiny(fused_decode=False)
    tc = ttiny(fused_decode=False)
    jp = jm.init_params(jax.random.key(0), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jserver = JServer(jc, jp, JNull(jc.vocab_size), **SERVICE)
    tserver = MegatronServer(tc, tp, NullTokenizer(tc.vocab_size),
                             device="cpu", **SERVICE)
    jserver.run("127.0.0.1", 0, block=False, graceful_sigterm=False)
    tserver.run("127.0.0.1", 0, block=False)
    try:
        yield jserver.port, tserver.port
    finally:
        tserver.shutdown()
        jserver.shutdown()


def test_greedy_text_matches_jax(servers):
    jport, tport = servers
    rng = np.random.default_rng(0)
    prompts = [" ".join(str(t) for t in rng.integers(1, 250, n))
               for n in (4, 11, 7)]
    body = {"prompts": prompts, "tokens_to_generate": 9, "logprobs": True}
    js, jout = _call(jport, body)
    ts, tout = _call(tport, body)
    assert js == ts == 200
    assert tout["text"] == jout["text"]
    assert tout["segments"] == jout["segments"]
    # fp32 logprobs through two layers, summed in another order
    for got, want in zip(tout["logprobs"], jout["logprobs"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the legacy batch contract: every prompt runs to max(len) + 9 tokens
    assert all(len(t.split()) == 11 + 9 for t in tout["text"])
    assert len(tout["request_ids"]) == 3


@pytest.mark.parametrize("body", [
    {},
    {"prompts": ["1 2"], "max_len": 4},
    {"sentences": ["1 2"]},
    {"prompts": "1 2"},
    {"prompts": []},
    {"prompts": ["1"], "tokens_to_generate": "4"},
    {"prompts": ["1"], "tokens_to_generate": -1},
    {"prompts": ["1"], "tokens_to_generate": 33},
    {"prompts": ["1"], "logprobs": 1},
    {"prompts": ["1"], "tokens_to_generate": 0},
    {"prompts": ["1"], "temperature": 0.0},
    {"prompts": ["1"], "top_k": 1001},
    {"prompts": ["1"], "top_p": 1.5},
    {"prompts": ["1"], "top_k": 2, "top_p": 0.5},
    {"prompts": ["1"], "add_BOS": "yes"},
    {"prompts": [""]},
    {"prompts": ["1"], "random_seed": -2},
    {"prompts": ["1"], "no_early_termination": 1},
    {"prompts": ["1"], "priority": 1.5},
    {"prompts": ["1"], "beam_width": 0},
    {"prompts": ["1", "2"], "beam_width": 2},
    {"prompts": [" ".join(["5"] * 40)], "tokens_to_generate": 30},
])
def test_invalid_bodies_match_jax(servers, body):
    jport, tport = servers
    want = _call(jport, body)
    got = _call(tport, body)
    assert want[0] == 400
    assert got == want


def test_unported_modes_name_the_roadmap(servers):
    _, tport = servers
    status, msg = _call(tport, {"prompts": ["1 2"], "beam_width": 2,
                                "tokens_to_generate": 4})
    assert status == 501 and "ROADMAP" in msg
    status, msg = _call(tport, {"prompts": ["1 2"], "tokens_to_generate": 0,
                                "logprobs": True})
    assert status == 501 and "ROADMAP" in msg


def test_get_metrics_and_kv(servers):
    _, tport = servers
    _call(tport, {"prompts": ["3 4 5"], "tokens_to_generate": 2})
    status, snap = _call(tport, None, method="GET", path="/metrics")
    assert status == 200 and snap["completed"] >= 1
    assert snap["decode_tokens"] >= 1
    status, kv = _call(tport, None, method="GET", path="/kv")
    assert status == 200 and kv["pool"]["block_size"] == 8
    assert _call(tport, None, method="GET", path="/nope")[0] == 404
