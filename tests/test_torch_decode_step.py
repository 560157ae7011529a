"""The fused whole-stack decode step (K12, K13, K14): the port's plain
versions against the JAX package's Pallas kernels in interpret mode, and
the port's own bitwise contracts, on the CPU.

Config: Llama-style, hidden 256, 3 layers, head dim 128 (64 under 4
heads), ffn 512, fp32.  The JAX weights cross over with
``convert.params_from_jax``; caches, hidden inputs and tables are made with
numpy from a seed and handed to both.  Tolerance 2e-5 relative and
absolute, as the JAX package's own fused-vs-composed test: the same
function in fp32, the TPU kernel's softmax online by cache block and the
plain version's whole, sums in another order.  ``test_torch_cuda.py``
holds the CUDA kernel against these plain versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import llama2_config as jllama2
from megatron_llm_tpu.kernels import decode_step as jds
from megatron_llm_tpu.models import model as jmodel
from megatron_llm_tpu.models.transformer import rope_tables as jrope_tables
from megatron_llm_tpu.ops import quant as jquant
from megatron_llm_tpu.ops.rope import apply_rope as japply_rope
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.kernels import decode_step as tds
from megatron_llm_tpu_torch.models import model as tmodel
from megatron_llm_tpu_torch.ops import quant as tquant
from megatron_llm_tpu_torch.ops.kv_quant import quantize_rows
from megatron_llm_tpu_torch.ops.rope import apply_rope as tapply_rope

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_LEN = 256


def _kw(**kw):
    base = dict(hidden_size=256, num_layers=3, num_attention_heads=2,
                num_kv_heads=2, ffn_hidden_size=512, vocab_size=128,
                seq_length=256, max_position_embeddings=256,
                params_dtype="float32", attention_impl="dot")
    base.update(kw)
    return base


def _setup(policy=None, gsz=64, **kw):
    """(JAX cfg, port cfg, JAX params, port params): JAX's random init,
    quantized under ``policy`` on the JAX side, copied across."""
    jc, tc = jllama2("7b", **_kw(**kw)), tllama2("7b", **_kw(**kw))
    jp = jmodel.init_params(jax.random.key(0), jc)
    if policy is not None:
        jp = jquant.quantize_params(jp, dataclasses.replace(
            jquant.POLICIES[policy], group_size=gsz))
    return jc, tc, jp, params_from_jax(jp, device="cpu")


def _cache(rng, shape, form):
    """One cache side as (jax leaf/dict, torch leaf/dict): fp32 values,
    bf16 values, or int8 codes with O(1) dequantized values."""
    if form == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = rng.uniform(0.002, 0.012, shape[:-1]).astype(np.float32)
        return ({"q": jnp.asarray(q), "scale": jnp.asarray(s)},
                {"q": torch.from_numpy(q), "scale": torch.from_numpy(s)})
    a = rng.normal(size=shape).astype(np.float32)
    if form == "bf16":
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _caches(rng, cfg, b, form, width=MAX_LEN):
    shape = (cfg.num_layers, b, cfg.kv_heads, width, cfg.head_dim)
    (jk, tk), (jv, tv) = _cache(rng, shape, form), _cache(rng, shape, form)
    return jk, jv, tk, tv


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# rows returned in bf16 (a bf16 cache) are each rounded once from fp32
# values that differ by fp32 reassociation; a value next to a rounding
# boundary lands one bf16 step (2^-7 relative) apart
BF16_ROWS_TOL = dict(rtol=2.0 ** -7, atol=2e-5)


def _rows_close(got, want, tol=TOL):
    for g, w in zip(got, want):
        _close(g, w, BF16_ROWS_TOL if g.dtype == torch.bfloat16 else tol)


def _trope(tc):
    return tmodel.rope_tables(tc, device="cpu")


# ---------------------------------------------------------------------------
# K12 against the Pallas kernel
# ---------------------------------------------------------------------------

K12_CASES = {
    "mha-scalar-37": dict(heads=(2, 2), fills=37),
    "gqa-scalar-100": dict(heads=(4, 2), fills=100),
    "mqa-scalar-128": dict(heads=(4, 1), fills=128),
    "mha-scalar-0": dict(heads=(2, 2), fills=0),
    "gqa-vector": dict(heads=(4, 2), fills=[0, 37, 100, 128]),
    "bf16-cache": dict(heads=(2, 2), fills=[37, 128, 1], form="bf16"),
    "int8-cache": dict(heads=(2, 2), fills=[37, 128, 1], form="int8"),
    "int8-weights": dict(heads=(2, 2), fills=[100, 0], policy="int8"),
    "int4-weights": dict(heads=(2, 2), fills=[100, 5], policy="int4"),
    "mixed-int8-cache": dict(heads=(4, 2), fills=[37, 128],
                             policy="mixed", form="int8"),
}


@pytest.mark.parametrize("name", list(K12_CASES))
def test_fused_decode_step_plain_matches_pallas(name):
    c = K12_CASES[name]
    nq, nkv = c["heads"]
    jc, tc, jp, tp = _setup(c.get("policy"), num_attention_heads=nq,
                            num_kv_heads=nkv)
    rng = np.random.default_rng(1)
    fills = c["fills"]
    b = len(fills) if isinstance(fills, list) else 2
    jk, jv, tk, tv = _caches(rng, jc, b, c.get("form", "fp32"))
    x = rng.normal(size=(b, jc.hidden_size)).astype(np.float32)
    jfill = jnp.asarray(fills, jnp.int32)
    tfill = torch.tensor(fills) if isinstance(fills, list) else fills
    want = jds.fused_decode_step(jc, jp["layers"], jnp.asarray(x), jk, jv,
                                 jfill, jrope_tables(jc), interpret=True)
    got = tds.fused_decode_step(tc, tp["layers"], torch.from_numpy(x), tk,
                                tv, tfill, _trope(tc))
    _rows_close(got, want)


# ---------------------------------------------------------------------------
# K13 and K14 against the Pallas kernels, over a shuffled pool
# ---------------------------------------------------------------------------

BLOCK = 128


def _pool(dense, tables):
    """Re-lay a dense cache (torch leaves [L, b, kv, width(, d)]) as a pool
    at the tables' ids, as (jax, torch); block 0 (trash) and the unused
    ids hold large finite garbage."""
    b, T = tables.shape

    def one(leaf):
        arr = leaf.numpy()
        L, _, kv = arr.shape[:3]
        garbage = 127 if arr.dtype == np.int8 else 1e4
        pool = np.full((L, 1 + b * T, kv, BLOCK) + arr.shape[4:], garbage,
                       arr.dtype)
        for bi in range(b):
            for j in range(T):
                pool[:, tables[bi, j]] = arr[:, bi, :,
                                             j * BLOCK:(j + 1) * BLOCK]
        return jnp.asarray(pool), torch.from_numpy(pool)

    if isinstance(dense, dict):
        pairs = {k: one(v) for k, v in dense.items()}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    return one(dense)


def _paged_setup(form, policy=None, heads=(4, 2), fills=(37, 128, 1)):
    jc, tc, jp, tp = _setup(policy, num_attention_heads=heads[0],
                            num_kv_heads=heads[1],
                            kv_cache_quant="int8" if form == "int8"
                            else "none")
    rng = np.random.default_rng(2)
    b = len(fills)
    _, _, tk, tv = _caches(rng, jc, b, form)
    tables = (rng.permutation(b * (MAX_LEN // BLOCK)) + 1).reshape(
        b, -1).astype(np.int32)
    jkp, tkp = _pool(tk, tables)
    jvp, tvp = _pool(tv, tables)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, rng=rng, tk=tk, tv=tv,
                tables=tables, jkp=jkp, jvp=jvp, tkp=tkp, tvp=tvp,
                fills=np.asarray(fills, np.int32))


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_fused_decode_step_paged_plain_matches_pallas(form):
    s = _paged_setup(form)
    b = len(s["fills"])
    x = s["rng"].normal(size=(b, 256)).astype(np.float32)
    want = jds.fused_decode_step_paged(
        s["jc"], s["jp"]["layers"], jnp.asarray(x), s["jkp"], s["jvp"],
        jnp.asarray(s["tables"]), jnp.asarray(s["fills"]),
        jrope_tables(s["jc"]), interpret=True)
    got = tds.fused_decode_step_paged(
        s["tc"], s["tp"]["layers"], torch.from_numpy(x), s["tkp"], s["tvp"],
        torch.from_numpy(s["tables"]), torch.from_numpy(s["fills"]),
        _trope(s["tc"]))
    _rows_close(got, want)


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_fused_decode_verify_paged_plain_matches_pallas(form):
    s = _paged_setup(form)
    b, W = len(s["fills"]), 3
    x = s["rng"].normal(size=(b, W, 256)).astype(np.float32)
    want = jds.fused_decode_verify_paged(
        s["jc"], s["jp"]["layers"], jnp.asarray(x), s["jkp"], s["jvp"],
        jnp.asarray(s["tables"]), jnp.asarray(s["fills"]),
        jrope_tables(s["jc"]), interpret=True)
    got = tds.fused_decode_verify_paged(
        s["tc"], s["tp"]["layers"], torch.from_numpy(x), s["tkp"], s["tvp"],
        torch.from_numpy(s["tables"]), torch.from_numpy(s["fills"]),
        _trope(s["tc"]))
    _rows_close(got, want)


# ---------------------------------------------------------------------------
# The port's bitwise contracts
# ---------------------------------------------------------------------------


def _equal(a, b):
    assert torch.equal(a, b)


@pytest.mark.parametrize("form,policy", [("fp32", None), ("bf16", None),
                                         ("int8", "int8"), ("fp32", "int4")])
def test_paged_equals_dense_bitwise(form, policy):
    """K13 over a shuffled pool gives K12 over the dense cache bit for
    bit (hidden and rows)."""
    s = _paged_setup("int8" if form == "int8" else "fp32", policy)
    if form == "bf16":
        s["tk"], s["tv"] = s["tk"].to(torch.bfloat16), s["tv"].to(
            torch.bfloat16)
        s["tkp"], s["tvp"] = s["tkp"].to(torch.bfloat16), s["tvp"].to(
            torch.bfloat16)
    b = len(s["fills"])
    x = torch.from_numpy(s["rng"].normal(size=(b, 256)).astype(np.float32))
    fills = torch.from_numpy(s["fills"])
    dense = tds.fused_decode_step(s["tc"], s["tp"]["layers"], x, s["tk"],
                                  s["tv"], fills, _trope(s["tc"]))
    paged = tds.fused_decode_step_paged(
        s["tc"], s["tp"]["layers"], x, s["tkp"], s["tvp"],
        torch.from_numpy(s["tables"]), fills, _trope(s["tc"]))
    for a, b_ in zip(paged, dense):
        _equal(a, b_)


def _append(tc, pool, rows, tables, pos):
    """The host's pool write of returned rows at each slot's ``pos``."""
    S = tables.shape[0]
    bids = tables[torch.arange(S), pos // BLOCK]
    if isinstance(pool, dict):
        rows = quantize_rows(rows)
    tmodel.cache_append_rows(pool, rows, bids, pos % BLOCK)


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_verify_equals_sequential_bitwise(form):
    """K14 over a W = 3 window gives W sequential K13 steps (with the
    host's pool writes between them) bit for bit."""
    s = _paged_setup(form, "int8" if form == "int8" else None)
    b, W = len(s["fills"]), 3
    x = torch.from_numpy(s["rng"].normal(size=(b, W, 256)).astype(
        np.float32))
    tables = torch.from_numpy(s["tables"]).long()
    fills = torch.from_numpy(s["fills"]).long()
    copy = (lambda p: {k: v.clone() for k, v in p.items()}) \
        if form == "int8" else (lambda p: p.clone())
    kp, vp = copy(s["tkp"]), copy(s["tvp"])
    hs, ks, vs = [], [], []
    for j in range(W):
        h, kr, vr = tds.fused_decode_step_paged(
            s["tc"], s["tp"]["layers"], x[:, j], kp, vp, tables, fills + j,
            _trope(s["tc"]))
        _append(s["tc"], kp, kr, tables, fills + j)
        _append(s["tc"], vp, vr, tables, fills + j)
        hs.append(h)
        ks.append(kr)
        vs.append(vr)
    h, kr, vr = tds.fused_decode_verify_paged(
        s["tc"], s["tp"]["layers"], x, s["tkp"], s["tvp"], tables, fills,
        _trope(s["tc"]))
    _equal(h, torch.stack(hs, 1))
    _equal(kr, torch.stack(ks, 2).reshape(kr.shape))
    _equal(vr, torch.stack(vs, 2).reshape(vr.shape))


# ---------------------------------------------------------------------------
# forward_cached through the fused route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fills", [50, [50, 0, 127]], ids=["scalar", "rows"])
@pytest.mark.parametrize("form", ["none", "int8"])
def test_forward_cached_fused_matches_jax(fills, form):
    """The port's ``forward_cached`` at s = 1 takes the fused route (its
    plain version here); JAX's takes the composed one off a TPU: the same
    logits and cache rows."""
    jc, tc, jp, tp = _setup(kv_cache_quant=form)
    assert tds.fused_decode_eligible(tc, tp, tmodel.init_kv_cache(
        tc, 1, 8, device="cpu")[0], 1)
    rng = np.random.default_rng(3)
    b = 3 if isinstance(fills, list) else 2
    jk, jv, tk, tv = _caches(rng, jc, b, "int8" if form == "int8"
                             else "fp32")
    tok = rng.integers(0, 128, (b, 1)).astype(np.int32)
    jfill = jnp.asarray(fills, jnp.int32)
    tfill = torch.tensor(fills) if isinstance(fills, list) else fills
    want, wk, wv = jmodel.forward_cached(jc, jp, jnp.asarray(tok), jk, jv,
                                         jfill)
    got, gk, gv = tmodel.forward_cached(tc, tp, torch.from_numpy(tok)
                                        .long(), tk, tv, tfill)
    _close(got, want)
    # the caches' written rows: dequantized values within one code step
    tol = dict(rtol=2e-5, atol=2e-2) if form == "int8" else TOL
    for g, w in ((gk, wk), (gv, wv)):
        if form == "int8":
            g = g["q"].float() * g["scale"][..., None]
            w = np.asarray(w["q"], np.float32) * np.asarray(
                w["scale"])[..., None]
        _close(g, w, tol)


# ---------------------------------------------------------------------------
# The predicates
# ---------------------------------------------------------------------------

REJECTS = {
    "layernorm": dict(cfg=dict(norm_type="layernorm")),
    "learned-positions": dict(cfg=dict(position_embedding_type="absolute")),
    "biases": dict(cfg=dict(use_bias=True)),
    "qkv-bias": dict(cfg=dict(qkv_bias=True)),
    "moe": dict(cfg=dict(num_experts=4)),
    "parallel-attn": dict(cfg=dict(parallel_attn=True)),
    "gelu-mlp": dict(cfg=dict(activation="gelu")),
    "fused-off": dict(cfg=dict(fused_decode=False)),
    "head-dim-32": dict(cfg=dict(num_attention_heads=8)),
    "group-16": dict(cfg=dict(hidden_size=2048, num_attention_heads=16,
                              num_kv_heads=1)),
    "half-quantized": dict(half=True),
    # a stacked LoRA rank off the kernel's 32-column tiles
    "lora": dict(lora_sr=100),
    "two-tokens": dict(s=2),
    "block-8": dict(block=8),
    "block-96": dict(block=96),
    "rows-65": dict(slots=65),
    "window-9": dict(window=9),
}


def _predicates(tc, tp, block=128, slots=4, window=4, s=1, lora_sr=0):
    k_cache = tmodel.init_kv_cache(tc, slots, 8, device="cpu")[0]
    k_pool = tmodel.init_kv_pool(tc, 4, block, device="cpu")[0]
    return (tds.fused_decode_eligible(tc, tp, k_cache, s, lora_sr),
            tds.fused_paged_decode_eligible(tc, tp, k_pool, slots, 2,
                                            lora_sr),
            tds.fused_paged_verify_eligible(tc, tp, k_pool, slots, window, 2,
                                            lora_sr))


@pytest.mark.parametrize("policy", [None, "int8", "int4", "mixed"])
def test_predicates_accept(policy):
    tc = tllama2("7b", **_kw())
    tp = tmodel.init_params(tc, device="cpu")
    if policy:
        tp = tquant.quantize_params(tp, dataclasses.replace(
            tquant.POLICIES[policy], group_size=64))
    assert _predicates(tc, tp) == (True, True, True)


@pytest.mark.parametrize("name", list(REJECTS))
def test_predicates_reject(name):
    c = REJECTS[name]
    tc = tllama2("7b", **_kw(**c.get("cfg", {})))
    shapes = tllama2("7b", **_kw(**{k: v for k, v in c.get("cfg", {}).items()
                                    if k in ("hidden_size",
                                             "num_attention_heads",
                                             "num_kv_heads")}))
    tp = tmodel.init_params(shapes, device="cpu")
    if c.get("half"):
        q = tquant.quantize_params(tp, "int8")
        tp = {**tp, "layers": {**tp["layers"], "attn": q["layers"]["attn"]}}
    got = _predicates(tc, tp, block=c.get("block", 128),
                      slots=c.get("slots", 4), window=c.get("window", 4),
                      s=c.get("s", 1), lora_sr=c.get("lora_sr", 0))
    if name in ("block-8", "block-96", "window-9"):
        assert got[0] and not any(got[1 if "block" in name else 2:])
    elif name == "rows-65":
        assert got == (False, False, False)
    elif name == "two-tokens":
        assert got == (False, True, True)
    else:
        assert got == (False, False, False)


# ---------------------------------------------------------------------------
# Helpers and refusals
# ---------------------------------------------------------------------------


def test_rope_helpers_match_apply_rope():
    """The rotation matrix and the per-row (C, S) factors both equal
    interleaved-pair RoPE (JAX's and the port's apply_rope)."""
    tc = tllama2("7b", **_kw())
    cos, sin = _trope(tc)
    d = tc.head_dim
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 1, 1, d)).astype(np.float32)
    pos = np.asarray([[0], [37], [255]])
    want = np.asarray(japply_rope(jnp.asarray(x), *jrope_tables(
        jllama2("7b", **_kw())), jnp.asarray(pos)))[:, 0, 0]
    t = tapply_rope(torch.from_numpy(x), cos, sin,
                    torch.from_numpy(pos))[:, 0, 0]
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-6)
    for i, p in enumerate(pos[:, 0]):
        r = tds.rope_rotation_matrix(cos, sin, int(p), d)
        np.testing.assert_allclose((torch.from_numpy(x[i, 0]) @ r).numpy()[0],
                                   want[i], rtol=1e-6, atol=1e-6)
    c, s = tds.rope_rows((cos, sin), torch.from_numpy(pos[:, 0]), d)
    xt = torch.from_numpy(x[:, 0, 0])
    got = xt * c + (xt @ tds.pair_swap_matrix(d)) * s
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_rope_rows_clamp_past_the_table():
    """Window positions past the RoPE table read its last row instead of
    raising (the caller discards those rows)."""
    tc = tllama2("7b", **_kw())
    rope = _trope(tc)
    c, s = tds.rope_rows(rope, torch.tensor([255, 256, 300]), tc.head_dim)
    assert torch.equal(c[1], c[0]) and torch.equal(s[2], s[0])


@pytest.mark.parametrize("gsz", [64, 128])
def test_int4_tile_matches_pallas_helper(gsz):
    rng = np.random.default_rng(5)
    packed = rng.integers(-128, 128, (128, 96)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, (256 // gsz, 96)).astype(np.float32)
    want = jds._int4_tile(jnp.asarray(packed)[None],
                          jnp.asarray(scale)[None], jnp.float32, gsz)
    got = tds.int4_tile(torch.from_numpy(packed), torch.from_numpy(scale),
                        torch.float32, gsz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mlp_chunks_match_jax():
    for ffn in (128, 256, 384, 512, 1024, 11008, 13824, 28672):
        assert tds.mlp_chunks(ffn) == jds._mlp_chunks(ffn)


def test_unported_options_raise():
    """The LoRA epilogue and K14's tree mode are ported: a LoRA mask that
    does not match the rows and the arena, and a window that is not a
    breadth-first tree, are refused with ValueError (as the kernel's own
    checks refuse them on the card)."""
    from megatron_llm_tpu_torch.ops import lora as tl

    _, tc, _, tp = _setup()
    x = torch.zeros(1, 256)
    k, v = tmodel.init_kv_cache(tc, 1, 8, device="cpu")
    arenas = tl.make_arenas(tc, 2, 16, ("wq",), device="cpu")
    with pytest.raises(ValueError, match="LoRA"):
        tds.fused_decode_step(tc, tp["layers"], x, k, v, 0, _trope(tc),
                              lora=(arenas, torch.zeros(2, 32)))
    kp, vp = tmodel.init_kv_pool(tc, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="tree"):
        tds.fused_decode_verify_paged(
            tc, tp["layers"], x[:, None].expand(1, 2, 256), kp, vp,
            torch.ones(1, 1), [0], _trope(tc), depths=torch.tensor([[0, 2]]),
            anc=torch.zeros(1, 2, 2))


# ---------------------------------------------------------------------------
# The bf16 body's work schedule and the forms it takes
# ---------------------------------------------------------------------------

# (hidden, heads, kv heads, ffn, attention bits, MLP bits, group): Llama-2-7B
# in each weight form, and a small stack whose widths leave ragged TMA
# boxes (q/k/v and gate/up tiles past the matrices' edges; w_down in three
# segments whose last chunks run short)
SCHEDULE_FORMS = {
    "llama2-7b-bf16": (4096, 32, 32, 11008, 0, 0, 0),
    "llama2-7b-int8": (4096, 32, 32, 11008, 8, 8, 0),
    "llama2-7b-int4": (4096, 32, 32, 11008, 4, 4, 128),
    "llama2-7b-mixed": (4096, 32, 32, 11008, 8, 4, 128),
    "ragged-boxes": (320, 5, 1, 480, 8, 8, 0),
}


@pytest.mark.parametrize("form", list(SCHEDULE_FORMS))
def test_gemv_schedule_covers_each_item_once_in_a_fixed_order(form):
    """``gemv_plan`` / ``gemv_item`` / ``gemv_block_items`` (the kernel's
    ``geo``, ``item_of`` and round-robin items): over every grid size from
    1 to 132 blocks, each (tile, chunk) item of each phase is taken exactly
    once; a tile's chunks, in chunk order, cut each contraction segment
    into consecutive runs of whole 32-row pieces and tile its columns; the
    combine's 32-column units cover each matrix once; and what a chunk
    covers depends on neither the grid nor the row count (the plan takes no
    row count: only the scratch sizes scale with rows)."""
    h, nq, nkv, ffn, aq, mq, gsz = SCHEDULE_FORMS[form]
    cfg = tllama2("7b", hidden_size=h, num_attention_heads=nq,
                  num_kv_heads=nkv, ffn_hidden_size=ffn)
    assert tds._kernel_fits_stack(
        cfg, {"layers": {"attn": {"wq": torch.empty(0, dtype=cfg.dtype)}}},
        aq, mq, gsz)
    plan = tds.gemv_plan(cfg, aq, mq)
    nseg = (1, 1, 1, tds.mlp_chunks(ffn))
    for ph, segs in zip(plan, nseg):
        items = [tds.gemv_item(ph, it) for it in range(ph["items"])]
        chunks = {}
        for i in items:
            chunks.setdefault(i["t"], []).append((i["c"], i["k0"], i["k1"]))
            # whole stages of 16 stored rows (int4: 32 rows)
            assert i["k0"] % 32 == 0 and i["k1"] % 32 == 0
            assert 0 <= i["k0"] < i["k1"] <= ph["K"]
            assert i["n0"] % ph["cols"] == 0 and i["n0"] < ph["N"][i["m"]]
        assert len(chunks) == ph["ntiles"]
        for t, cs in chunks.items():
            assert [c for c, _, _ in cs] == list(range(ph["nch"]))
            kseg = ph["K"] // segs
            for s in range(segs):
                run = cs[s * ph["cps"]:(s + 1) * ph["cps"]]
                assert run[0][1] == s * kseg and run[-1][2] == (s + 1) * kseg
                assert all(a[2] == b[1] for a, b in zip(run, run[1:]))
        cols = sorted({(i["m"], i["n0"]) for i in items})
        assert len(cols) == ph["ntiles"]
        for m, n in enumerate(ph["N"]):
            starts = [n0 for mm, n0 in cols if mm == m]
            assert starts == list(range(0, n, ph["cols"]))
        # the combine's units: every (tile, 32 columns) inside the matrix
        units = [(t, j) for t in range(ph["ntiles"])
                 for j in range(0, ph["cols"], 32)
                 if tds.gemv_item(ph, t * ph["nch"])["n0"] + j
                 < ph["N"][tds.gemv_item(ph, t * ph["nch"])["m"]]]
        assert len(units) == sum(n // 32 for n in ph["N"])
        for grid in range(1, 133):
            seen = np.zeros(ph["items"], np.int64)
            for b in range(grid):
                for it in tds.gemv_block_items(ph, b, grid):
                    seen[it] += 1
            assert (seen == 1).all(), (grid, form)
    for rows in (1, 4, 16, 64):
        need = max(p["nch"] * rows * p["ntiles"] * p["cols"] for p in plan)
        assert need == rows * max(p["nch"] * p["ntiles"] * p["cols"]
                                  for p in plan)


@pytest.mark.parametrize("form", ["int8", "int4", "mixed", None])
@pytest.mark.parametrize("rows,window,lora_sr", [(1, 1, 0), (64, 8, 1024),
                                                 (16, 4, 128)])
def test_predicates_accept_the_kernel_forms(form, rows, window, lora_sr):
    """The predicates take every form the bf16 and fp32 bodies run:
    plain, int8, int4 and mixed weights, rows up to 64 and windows up to
    8 (slots x window), a LoRA arena up to 1024 columns."""
    tc = tllama2("7b", **_kw())
    tp = tmodel.init_params(tc, device="cpu")
    if form:
        tp = tquant.quantize_params(tp, dataclasses.replace(
            tquant.POLICIES[form], group_size=64))
    got = _predicates(tc, tp, slots=rows // window, window=window,
                      lora_sr=lora_sr)
    assert got == (True, True, True)
