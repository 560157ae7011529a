"""The LoRA epilogue of the fused decode step (K12, K13, K14 and K14's
tree mode): the port's plain versions against the JAX package's Pallas
kernels with ``lora=`` in interpret mode (the first run of that Pallas
code: no JAX test passes ``lora=`` to it), the port's bitwise contracts
with an arena, ``forward_cached*`` with ``lora=`` on both routes against
JAX's, and the predicates at the port's stacked-rank limits.

Config: Llama-style, hidden 256, 3 layers, head dim 128 (64 under 4
heads), ffn 512, fp32, as ``test_torch_decode_step.py``.  The arena: 4
slots x rank 32 (Sr 128, which the TPU kernel takes too), every target;
each adapter from JAX's ``init_lora_adapter`` with a non-zero B
(``jax.random`` x 0.05), crossing as numpy.  Masks put rows at slots -1,
0 and 3.  Tolerance 2e-5 relative and absolute, as the decode-step tests:
the same fp32 function, sums in another order.
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
from megatron_llm_tpu.ops import lora as jl
from megatron_llm_tpu.ops import quant as jquant
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.convert import adapter_from_jax, params_from_jax
from megatron_llm_tpu_torch.kernels import decode_step as tds
from megatron_llm_tpu_torch.models import model as tmodel
from megatron_llm_tpu_torch.ops import lora as tl
from megatron_llm_tpu_torch.ops.kv_quant import quantize_rows

torch.set_num_threads(1)

# JAX's model functions as one program a config and shape (called eagerly,
# each op of the model compiles on its own)
_jforward_cached = jax.jit(jmodel.forward_cached, static_argnums=0,
                           static_argnames="empty_cache")
_jforward_cached_paged = jax.jit(jmodel.forward_cached_paged, static_argnums=0)
_jforward_cached_paged_verify = jax.jit(
    jmodel.forward_cached_paged_verify, static_argnums=0)
# JAX's whole-stack kernels as one program a config (around the Pallas
# kernel in interpret mode, each op would compile on its own)
_jfused_decode_step = jax.jit(jds.fused_decode_step, static_argnums=0,
                               static_argnames="interpret")
_jfused_decode_step_paged = jax.jit(
    jds.fused_decode_step_paged, static_argnums=0, static_argnames="interpret")
_jfused_decode_verify_paged = jax.jit(
    jds.fused_decode_verify_paged, static_argnums=0,
    static_argnames="interpret")

TOL = dict(rtol=2e-5, atol=2e-5)
MAX_LEN = 256
BLOCK = 128
N_SLOTS, RANK = 4, 32
SLOTS = [-1, 0, 3]


def _kw(**kw):
    base = dict(hidden_size=256, num_layers=3, num_attention_heads=2,
                num_kv_heads=2, ffn_hidden_size=512, vocab_size=128,
                seq_length=256, max_position_embeddings=256,
                params_dtype="float32", attention_impl="dot")
    base.update(kw)
    return base


def _setup(policy=None, **kw):
    jc, tc = jllama2("7b", **_kw(**kw)), tllama2("7b", **_kw(**kw))
    jp = jmodel.init_params(jax.random.key(0), jc)
    if policy is not None:
        jp = jquant.quantize_params(jp, dataclasses.replace(
            jquant.POLICIES[policy], group_size=64))
    return jc, tc, jp, params_from_jax(jp, device="cpu")


def _arenas(jc, tc, targets=jl.LORA_TARGETS):
    """Both packages' arenas with the same adapter in each slot."""
    jar = jl.make_arenas(jc, N_SLOTS, RANK, targets)
    tar = tl.make_arenas(tc, N_SLOTS, RANK, targets, device="cpu")
    for s in range(N_SLOTS):
        ad = jl.init_lora_adapter(jc, jax.random.key(100 + s), RANK,
                                  targets=targets)
        ad = dataclasses.replace(ad, factors={
            t: {"a": f["a"],
                "b": jax.random.normal(jax.random.key(200 + s),
                                       f["b"].shape) * 0.05}
            for t, f in ad.factors.items()})
        jar = jl.install_adapter(jar, ad.factors, s, ad.scale, RANK)
        tad = adapter_from_jax({"rank": ad.rank, "alpha": ad.alpha,
                                "targets": ad.targets,
                                "factors": jax.tree.map(np.asarray,
                                                        ad.factors)},
                               device="cpu")
        tl.install_adapter(tar, tad.factors, s, tad.scale, RANK)
    return jar, tar


def _masks(slots):
    return (jl.slot_mask(jnp.asarray(slots, jnp.int32), N_SLOTS, RANK),
            tl.slot_mask(torch.tensor(slots), N_SLOTS, RANK))


def _cache(rng, shape, form):
    if form == "int8":
        q = rng.integers(-127, 128, shape).astype(np.int8)
        s = rng.uniform(0.002, 0.012, shape[:-1]).astype(np.float32)
        return ({"q": jnp.asarray(q), "scale": jnp.asarray(s)},
                {"q": torch.from_numpy(q), "scale": torch.from_numpy(s)})
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _caches(rng, cfg, b, form):
    shape = (cfg.num_layers, b, cfg.kv_heads, MAX_LEN, cfg.head_dim)
    (jk, tk), (jv, tv) = _cache(rng, shape, form), _cache(rng, shape, form)
    return jk, jv, tk, tv


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **TOL)


def _trope(tc):
    return tmodel.rope_tables(tc, device="cpu")


def _pool(dense, tables):
    """A dense cache (torch leaves) re-laid as a pool at the tables' ids,
    as (jax, torch); unused blocks hold large finite garbage."""
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


def _paged(form, policy=None, heads=(4, 2), fills=(37, 128, 1)):
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
    jar, tar = _arenas(jc, tc)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, rng=rng, tk=tk, tv=tv,
                tables=tables, jkp=jkp, jvp=jvp, tkp=tkp, tvp=tvp,
                jar=jar, tar=tar, fills=np.asarray(fills, np.int32))


# ---------------------------------------------------------------------------
# The plain versions against the Pallas kernels with lora=
# ---------------------------------------------------------------------------

K12_CASES = {
    "fp32": dict(),
    "gqa-int8-cache": dict(heads=(4, 2), form="int8"),
    "int8-weights": dict(policy="int8"),
    "int4-weights": dict(policy="int4"),
}


@pytest.mark.parametrize("name", list(K12_CASES))
def test_fused_decode_step_lora_plain_matches_pallas(name):
    c = K12_CASES[name]
    nq, nkv = c.get("heads", (2, 2))
    jc, tc, jp, tp = _setup(c.get("policy"), num_attention_heads=nq,
                            num_kv_heads=nkv)
    rng = np.random.default_rng(1)
    fills = [37, 128, 0]
    jk, jv, tk, tv = _caches(rng, jc, 3, c.get("form", "fp32"))
    x = rng.normal(size=(3, jc.hidden_size)).astype(np.float32)
    jar, tar = _arenas(jc, tc)
    jm, tm_ = _masks(SLOTS)
    want = _jfused_decode_step(jc, jp["layers"], jnp.asarray(x), jk, jv,
                                 jnp.asarray(fills, jnp.int32),
                                 jrope_tables(jc), lora=(jar, jm),
                                 interpret=True)
    got = tds.fused_decode_step(tc, tp["layers"], torch.from_numpy(x), tk,
                                tv, torch.tensor(fills), _trope(tc),
                                lora=(tar, tm_))
    _close(got, want)


@pytest.mark.parametrize("form,policy", [("fp32", None), ("int8", "int8")])
def test_fused_decode_step_paged_lora_plain_matches_pallas(form, policy):
    s = _paged(form, policy)
    x = s["rng"].normal(size=(3, 256)).astype(np.float32)
    jm, tm_ = _masks(SLOTS)
    want = _jfused_decode_step_paged(
        s["jc"], s["jp"]["layers"], jnp.asarray(x), s["jkp"], s["jvp"],
        jnp.asarray(s["tables"]), jnp.asarray(s["fills"]),
        jrope_tables(s["jc"]), lora=(s["jar"], jm), interpret=True)
    got = tds.fused_decode_step_paged(
        s["tc"], s["tp"]["layers"], torch.from_numpy(x), s["tkp"], s["tvp"],
        torch.from_numpy(s["tables"]), torch.from_numpy(s["fills"]),
        _trope(s["tc"]), lora=(s["tar"], tm_))
    _close(got, want)


@pytest.mark.parametrize("form,policy", [("fp32", None), ("int8", "int4")])
def test_fused_decode_verify_lora_plain_matches_pallas(form, policy):
    """K14 with a per-slot mask, each slot's row repeated over its W = 3
    window rows (JAX repeats it for the kernel)."""
    s = _paged(form, policy)
    x = s["rng"].normal(size=(3, 3, 256)).astype(np.float32)
    jm, tm_ = _masks(SLOTS)
    want = _jfused_decode_verify_paged(
        s["jc"], s["jp"]["layers"], jnp.asarray(x), s["jkp"], s["jvp"],
        jnp.asarray(s["tables"]), jnp.asarray(s["fills"]),
        jrope_tables(s["jc"]), lora=(s["jar"], jm), interpret=True)
    got = tds.fused_decode_verify_paged(
        s["tc"], s["tp"]["layers"], torch.from_numpy(x), s["tkp"], s["tvp"],
        torch.from_numpy(s["tables"]), torch.from_numpy(s["fills"]),
        _trope(s["tc"]), lora=(s["tar"], tm_))
    _close(got, want)


# a hedged tree (the engine's shape), a chain and a rider
TREES = (([0, 1, 1, 2], {(3, 1): 1}),
         ([0, 1, 2, 3], {(j, dd): dd for j in range(4) for dd in range(j)}),
         ([0, 0, 0, 0], {}))


def _tree(specs):
    W = 4
    depths = np.zeros((len(specs), W), np.int32)
    anc = np.zeros((len(specs), W, W), np.int32)
    for s, (dep, links) in enumerate(specs):
        depths[s] = dep
        for (j, dd), a in links.items():
            anc[s, j, dd] = a
    return depths, anc


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_fused_decode_verify_tree_lora_plain_matches_pallas(form):
    s = _paged(form)
    x = s["rng"].normal(size=(3, 4, 256)).astype(np.float32)
    depths, anc = _tree(TREES)
    jm, tm_ = _masks([3, -1, 0])
    want = _jfused_decode_verify_paged(
        s["jc"], s["jp"]["layers"], jnp.asarray(x), s["jkp"], s["jvp"],
        jnp.asarray(s["tables"]), jnp.asarray(s["fills"]),
        jrope_tables(s["jc"]), depths=jnp.asarray(depths),
        anc=jnp.asarray(anc), lora=(s["jar"], jm), interpret=True)
    got = tds.fused_decode_verify_paged(
        s["tc"], s["tp"]["layers"], torch.from_numpy(x), s["tkp"], s["tvp"],
        torch.from_numpy(s["tables"]), torch.from_numpy(s["fills"]),
        _trope(s["tc"]), depths=torch.from_numpy(depths),
        anc=torch.from_numpy(anc), lora=(s["tar"], tm_))
    _close(got, want)


# ---------------------------------------------------------------------------
# The port's bitwise contracts with an arena
# ---------------------------------------------------------------------------


def _eq(a, b):
    for p, q in zip(a, b):
        assert torch.equal(p, q)


@pytest.mark.parametrize("form,policy", [("fp32", None), ("int8", "int8"),
                                         ("fp32", "int4")])
def test_lora_contracts_bitwise(form, policy):
    """Slot -1 rows equal the call without an arena; each row of a mixed
    batch equals that row with the others' inputs and slots changed (the
    same batch shape: a CPU matmul's blocking follows the shape, as the
    engine's decode batch keeps its shape; the card tests run the row
    truly alone); K13 equals K12; and the adapters act."""
    s = _paged(form, policy)
    x = torch.from_numpy(s["rng"].normal(size=(3, 256)).astype(np.float32))
    fills = torch.from_numpy(s["fills"])
    tables = torch.from_numpy(s["tables"])
    _, mask = _masks(SLOTS)
    lora = (s["tar"], mask)
    rope = _trope(s["tc"])
    st = s["tp"]["layers"]
    paged = tds.fused_decode_step_paged(s["tc"], st, x, s["tkp"], s["tvp"],
                                        tables, fills, rope, lora=lora)
    _eq(paged, tds.fused_decode_step(s["tc"], st, x, s["tk"], s["tv"],
                                     fills, rope, lora=lora))
    base = tds.fused_decode_step_paged(s["tc"], st, x, s["tkp"], s["tvp"],
                                       tables, fills, rope)
    assert torch.equal(paged[0][0], base[0][0])
    assert torch.equal(paged[1][:, 0], base[1][:, 0])
    assert not torch.equal(paged[0][1:], base[0][1:])
    other = torch.from_numpy(s["rng"].normal(size=(3, 256)).astype(
        np.float32))
    for i in range(3):
        keep = torch.arange(3) == i
        xi = torch.where(keep[:, None], x, other)
        slots = torch.where(keep, torch.tensor(SLOTS), (i + 1) % 4)
        alone = tds.fused_decode_step_paged(
            s["tc"], st, xi, s["tkp"], s["tvp"], tables, fills, rope,
            lora=(s["tar"], tl.slot_mask(slots, N_SLOTS, RANK)))
        assert torch.equal(alone[0][i], paged[0][i])
        assert torch.equal(alone[1][:, i], paged[1][:, i])


def _append(pool, rows, tables, pos):
    S = tables.shape[0]
    bids = tables[torch.arange(S), pos // BLOCK]
    if isinstance(pool, dict):
        rows = quantize_rows(rows)
    tmodel.cache_append_rows(pool, rows, bids, pos % BLOCK)


def _copy(p):
    return {k: v.clone() for k, v in p.items()} if isinstance(p, dict) \
        else p.clone()


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_lora_verify_and_trees_equal_sequential_bitwise(form):
    """K14 with an arena equals W sequential K13 steps with the arena (and
    the host's pool writes between them); a chain tree equals the linear
    window, and each path of a hedged tree sequential K13 steps."""
    s = _paged(form, "int8" if form == "int8" else None)
    W = 4
    x = torch.from_numpy(s["rng"].normal(size=(3, W, 256)).astype(
        np.float32))
    tables = torch.from_numpy(s["tables"]).long()
    fills = torch.from_numpy(s["fills"]).long()
    _, mask = _masks(SLOTS)
    lora = (s["tar"], mask)
    rope = _trope(s["tc"])
    st = s["tp"]["layers"]
    kp, vp = _copy(s["tkp"]), _copy(s["tvp"])
    hs, ks = [], []
    for j in range(W):
        h, kr, vr = tds.fused_decode_step_paged(
            s["tc"], st, x[:, j], kp, vp, tables, fills + j, rope, lora=lora)
        _append(kp, kr, tables, fills + j)
        _append(vp, vr, tables, fills + j)
        hs.append(h)
        ks.append(kr)
    verify = tds.fused_decode_verify_paged(s["tc"], st, x, s["tkp"],
                                           s["tvp"], tables, fills, rope,
                                           lora=lora)
    assert torch.equal(verify[0], torch.stack(hs, 1))
    assert torch.equal(verify[1], torch.stack(ks, 2).reshape(
        verify[1].shape))
    depths, anc = _tree([TREES[1]] * 3)
    _eq(tds.fused_decode_verify_paged(
        s["tc"], st, x, s["tkp"], s["tvp"], tables, fills, rope,
        depths=torch.from_numpy(depths), anc=torch.from_numpy(anc),
        lora=lora), verify)
    depths, anc = _tree([TREES[0]] * 3)
    tree = tds.fused_decode_verify_paged(
        s["tc"], st, x, s["tkp"], s["tvp"], tables, fills, rope,
        depths=torch.from_numpy(depths), anc=torch.from_numpy(anc),
        lora=lora)
    rows = torch.arange(3) * W
    for path in ([0, 1, 3], [0, 2]):
        kp, vp = _copy(s["tkp"]), _copy(s["tvp"])
        for t, node in enumerate(path):
            out = tds.fused_decode_step_paged(s["tc"], st, x[:, node], kp,
                                              vp, tables, fills + t, rope,
                                              lora=lora)
            assert torch.equal(tree[0][:, node], out[0])
            assert torch.equal(tree[1][:, rows + node], out[1])
            _append(kp, out[1], tables, fills + t)
            _append(vp, out[2], tables, fills + t)


# ---------------------------------------------------------------------------
# forward_cached* with lora= against JAX's, on both routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
@pytest.mark.parametrize("form", ["none", "int8"])
def test_forward_cached_lora_matches_jax(fused, form):
    """The port's ``forward_cached`` at s = 1 (the fused route's plain
    version, or the composed route) against JAX's (composed off a TPU),
    logits 1e-4; then a 5-token prefill with lora (composed on both)."""
    kw = dict(kv_cache_quant=form, fused_decode=fused)
    jc, tc, jp, tp = _setup(**kw)
    assert tds.fused_decode_eligible(tc, tp, tmodel.init_kv_cache(
        tc, 1, 8, device="cpu")[0], 1, N_SLOTS * RANK) == fused
    rng = np.random.default_rng(3)
    jk, jv, tk, tv = _caches(rng, jc, 3, "int8" if form == "int8"
                             else "fp32")
    jar, tar = _arenas(jc, tc)
    jm, tm_ = _masks(SLOTS)
    fills = [50, 0, 127]
    tok = rng.integers(0, 128, (3, 1)).astype(np.int32)
    want, _, _ = _jforward_cached(jc, jp, jnp.asarray(tok), jk, jv,
                                       jnp.asarray(fills, jnp.int32),
                                       lora=(jar, jm))
    got, _, _ = tmodel.forward_cached(tc, tp, torch.from_numpy(tok).long(),
                                      tk, tv, torch.tensor(fills),
                                      lora=(tar, tm_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    toks = rng.integers(0, 128, (3, 5)).astype(np.int32)
    jk, jv = jmodel.init_kv_cache(jc, 3, 16)
    tk, tv = tmodel.init_kv_cache(tc, 3, 16, device="cpu")
    want, _, _ = _jforward_cached(jc, jp, jnp.asarray(toks), jk, jv, 0,
                                       empty_cache=True, lora=(jar, jm))
    got, _, _ = tmodel.forward_cached(tc, tp, torch.from_numpy(toks).long(),
                                      tk, tv, 0, empty_cache=True,
                                      lora=(tar, tm_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "composed"])
def test_forward_cached_paged_lora_matches_jax(fused):
    """``forward_cached_paged`` and ``forward_cached_paged_verify`` (a
    linear window and a tree) with ``lora=`` on the fused and composed
    routes against JAX's, logits 1e-4."""
    s = _paged("fp32")
    tc, jc = s["tc"], s["jc"]
    jm, tm_ = _masks(SLOTS)
    tables = s["tables"]
    fills = s["fills"]
    tok = s["rng"].integers(0, 128, (3, 1)).astype(np.int32)
    want, _, _ = _jforward_cached_paged(
        jc, s["jp"], jnp.asarray(tok), s["jkp"], s["jvp"],
        jnp.asarray(tables), jnp.asarray(fills), lora=(s["jar"], jm))
    got, _, _ = tmodel.forward_cached_paged(
        tc, s["tp"], torch.from_numpy(tok).long(), _copy(s["tkp"]),
        _copy(s["tvp"]), torch.from_numpy(tables), torch.from_numpy(fills),
        use_fused=fused, lora=(s["tar"], tm_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    W = 4
    win = s["rng"].integers(0, 128, (3, W)).astype(np.int32)
    pos = fills[:, None] + np.arange(W)[None, :]
    bids = np.take_along_axis(tables, pos // BLOCK, 1).reshape(-1)
    offs = (pos % BLOCK).reshape(-1)
    depths, anc = _tree(TREES)
    for tree in (None, (depths, anc)):
        want, _, _ = _jforward_cached_paged_verify(
            jc, s["jp"], jnp.asarray(win), s["jkp"], s["jvp"],
            jnp.asarray(tables), jnp.asarray(fills), jnp.asarray(bids),
            jnp.asarray(offs), lora=(s["jar"], jm),
            tree=None if tree is None else tuple(map(jnp.asarray, tree)))
        got, _, _ = tmodel.forward_cached_paged_verify(
            tc, s["tp"], torch.from_numpy(win).long(), _copy(s["tkp"]),
            _copy(s["tvp"]), torch.from_numpy(tables),
            torch.from_numpy(fills), torch.from_numpy(bids),
            torch.from_numpy(offs), use_fused=fused, lora=(s["tar"], tm_),
            tree=None if tree is None else tuple(map(torch.from_numpy,
                                                     tree)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# The predicates at the port's limits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lora_sr,ok", [(0, True), (32, True), (96, True),
                                        (128, True), (1024, True),
                                        (16, False), (100, False),
                                        (1056, False)])
def test_predicates_take_the_kernels_lora_limits(lora_sr, ok):
    """Every predicate takes a stacked rank in whole 32-column tiles up to
    1024 (the TPU's multiple of 128 does not apply) and refuses the rest,
    so the engine then takes the composed route with the adapters."""
    tc = tllama2("7b", **_kw())
    tp = tmodel.init_params(tc, device="cpu")
    k_cache = tmodel.init_kv_cache(tc, 4, 8, device="cpu")[0]
    k_pool = tmodel.init_kv_pool(tc, 4, 128, device="cpu")[0]
    got = (tds.fused_decode_eligible(tc, tp, k_cache, 1, lora_sr),
           tds.fused_paged_decode_eligible(tc, tp, k_pool, 4, 2, lora_sr),
           tds.fused_paged_verify_eligible(tc, tp, k_pool, 4, 4, 2,
                                           lora_sr))
    assert got == (ok, ok, ok)
