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
from megatron_llm_tpu.generation.server import GenerationService as JService
from megatron_llm_tpu.generation.server import MegatronServer as JServer
from megatron_llm_tpu.models import model as jm
from megatron_llm_tpu.tokenizer.tokenizer import NullTokenizer as JNull
from megatron_llm_tpu_torch.config import tiny_config as ttiny
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.generation import (
    GenerationService,
    MegatronServer,
)
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


@pytest.mark.parametrize("body", [
    {"prompts": ["3 14 15 92"], "beam_width": 2, "tokens_to_generate": 6},
    {"prompts": ["65 35 89"], "beam_width": 3, "tokens_to_generate": 7,
     "length_penalty": 0.5},
    {"prompts": ["27 18 28"], "beam_width": 2, "tokens_to_generate": 8,
     "stop_token": "first", "length_penalty": 0.0},
    {"prompts": ["1 2"], "beam_width": 2, "tokens_to_generate": 30},
    {"prompts": [" ".join(["5"] * 110)], "beam_width": 2,
     "tokens_to_generate": 30},
])
def test_beam_bodies_match_jax(servers, body):
    """``beam_width`` runs beam search on both servers: the same
    hypotheses (text, segments) and scores within 1e-4; a stop token the
    beams meet and a length penalty change them alike; a budget past the
    position table is the same 400."""
    jport, tport = servers
    body = dict(body)
    if body.get("stop_token") == "first":
        # the prompt's first greedy token: a hypothesis finishes at once
        _, out = _call(jport, {"prompts": body["prompts"],
                               "tokens_to_generate": 1})
        body["stop_token"] = int(out["text"][0].split()[-1])
    js, jout = _call(jport, body)
    ts, tout = _call(tport, body)
    assert ts == js == (400 if len(body["prompts"][0]) > 100 else 200)
    if js != 200:
        assert tout == jout
        return
    assert tout.keys() == jout.keys() == {"text", "segments", "scores"}
    assert tout["text"] == jout["text"]
    assert tout["segments"] == jout["segments"]
    np.testing.assert_allclose(tout["scores"], jout["scores"], rtol=1e-4,
                               atol=1e-4)
    assert len(tout["text"]) == body["beam_width"]


def test_score_bodies_match_jax(servers):
    """``tokens_to_generate=0`` scores the prompts on both servers: the
    same text and per-token log-probs within 1e-4."""
    jport, tport = servers
    rng = np.random.default_rng(1)
    prompts = [" ".join(str(t) for t in rng.integers(1, 250, n))
               for n in (5, 12, 1)]
    body = {"prompts": prompts, "tokens_to_generate": 0, "logprobs": True}
    js, jout = _call(jport, body)
    ts, tout = _call(tport, body)
    assert js == ts == 200
    assert tout.keys() == jout.keys() == {"text", "logprobs"}
    assert tout["text"] == jout["text"]
    assert [len(x) for x in tout["logprobs"]] == [4, 11, 0]
    for got, want in zip(tout["logprobs"], jout["logprobs"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pld_services():
    """Plain and ``speculative="pld"`` services, the port's and JAX's, over
    one tiny model (JAX's weights carried across)."""
    jc = jtiny(num_layers=1, vocab_size=256, make_vocab_size_divisible_by=8,
               fused_decode=False)
    tc = ttiny(num_layers=1, vocab_size=256, make_vocab_size_divisible_by=8,
               fused_decode=False)
    jp = jm.init_params(jax.random.key(2), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    kw = dict(max_batch_size=2, engine_max_seq_len=64, prefix_cache_blocks=0,
              trace=False)
    svcs = {"jax": JService(jc, jp, JNull(jc.vocab_size),
                            speculative="pld", **kw),
            "plain": GenerationService(tc, tp, NullTokenizer(tc.vocab_size),
                                       device="cpu", **kw),
            "pld": GenerationService(tc, tp, NullTokenizer(tc.vocab_size),
                                     speculative="pld", device="cpu", **kw)}
    try:
        yield svcs
    finally:
        for svc in svcs.values():
            svc.close()


@pytest.mark.parametrize("body,tag", [
    ({"prompts": ["7 8 9 10", "11 12 13 14"], "tokens_to_generate": 8},
     "pld"),
    ({"prompts": ["7 8 9", "10 11 12 13 14"], "tokens_to_generate": 4},
     "pld"),
    ({"prompts": ["7 8 9 10"], "tokens_to_generate": 4, "top_k": 4,
      "random_seed": 3}, "fallback:"),
    ({"prompts": ["7 8"], "tokens_to_generate": 4}, "fallback:"),
    ({"prompts": ["7 8 9 10"], "tokens_to_generate": 4, "logprobs": True},
     "fallback:"),
])
def test_pld_service_matches_jax(pld_services, body, tag):
    """``speculative="pld"``: eligible bodies are served by PLD with JAX's
    text and the plain service's, tagged ``"pld"``; the others fall back to
    the engine with JAX's tag (a seeded sampled body gives the plain
    service's text: JAX's draws cannot be matched)."""
    js, jout = pld_services["jax"].handle(dict(body))
    ps, pout = pld_services["plain"].handle(dict(body))
    ss, sout = pld_services["pld"].handle(dict(body))
    assert js == ps == ss == 200
    assert sout["speculative"] == jout["speculative"]
    assert sout["speculative"].startswith(tag)
    assert "speculative" not in pout
    assert sout["text"] == pout["text"]
    if "top_k" not in body:
        assert sout["text"] == jout["text"]


def test_text_generation_cli(servers, monkeypatch, capsys):
    """The REPL client against the port's server: a non-integer token
    count asks again, a prompt prints the server's text, EOF ends it."""
    from megatron_llm_tpu_torch.tools import text_generation_cli as cli

    _, tport = servers
    answers = iter(["5 6 7", "three", "5 6 7", "3"])

    def fake_input(prompt=""):
        try:
            return next(answers)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", fake_input)
    assert cli.main([f"127.0.0.1:{tport}"]) == 0
    out = capsys.readouterr().out
    assert "Number of tokens must be an integer" in out
    _, want = _call(tport, {"prompts": ["5 6 7"], "tokens_to_generate": 3})
    assert out.splitlines()[-1] == want["text"][0]
    assert cli.main([]) == 2


def test_get_metrics_and_kv(servers):
    _, tport = servers
    _call(tport, {"prompts": ["3 4 5"], "tokens_to_generate": 2})
    status, snap = _call(tport, None, method="GET", path="/metrics")
    assert status == 200 and snap["completed"] >= 1
    assert snap["decode_tokens"] >= 1
    status, kv = _call(tport, None, method="GET", path="/kv")
    assert status == 200 and kv["pool"]["block_size"] == 8
    assert _call(tport, None, method="GET", path="/nope")[0] == 404
