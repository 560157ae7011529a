"""K14's tree mode and the tree arms of ``forward_cached_paged_verify``:
the port's plain versions against the JAX package (the Pallas kernel in
interpret mode, the composed arm, ``cache_move_rows``), and the port's
bitwise contracts, on the CPU.

Config: Llama-style, hidden 256, 3 layers, 4 query heads over 2 KV heads
(head dim 64), ffn 512, fp32; pools of 128-token blocks under shuffled
tables with large finite garbage in the blocks no table names.  The JAX
weights cross over with ``convert.params_from_jax``; caches, hidden
inputs and tables are made with numpy from a seed and handed to both.
Against JAX the tolerance is 2e-5 relative and absolute (the JAX
package's own fused-vs-composed tolerance: the same function in fp32,
the softmax and sums in another order; the rows an int8 pool stores may
land one code step apart next to a rounding boundary, so they compare
dequantized within one step, 0.012 at these scales).  Inside the port:
bit for bit.  ``test_torch_cuda.py`` holds the CUDA kernel against these
plain versions on the card.
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
from megatron_llm_tpu_torch.config import llama2_config as tllama2
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.kernels import decode_step as tds
from megatron_llm_tpu_torch.models import model as tmodel
from megatron_llm_tpu_torch.ops.kv_quant import quantize_rows

torch.set_num_threads(1)

# JAX's whole-stack kernels as one program a config (around the Pallas
# kernel in interpret mode, each op would compile on its own)
_jfused_decode_verify_paged = jax.jit(
    jds.fused_decode_verify_paged, static_argnums=0,
    static_argnames="interpret")

TOL = dict(rtol=2e-5, atol=2e-5)
INT8_ROW_TOL = dict(rtol=0, atol=0.012)
BLOCK, MAX_LEN, W = 128, 256, 4
# a depth-1 hedge beside a two-deep chain: the engine's tree shape
BRANCHED = ([0, 1, 1, 2], {(3, 1): 1})
PATHS = ([0, 1, 3], [0, 2])


def _kw(**kw):
    base = dict(hidden_size=256, num_layers=3, num_attention_heads=4,
                num_kv_heads=2, ffn_hidden_size=512, vocab_size=128,
                seq_length=256, max_position_embeddings=256,
                params_dtype="float32", attention_impl="dot")
    base.update(kw)
    return base


def _setup(form="fp32", policy=None, fills=(37, 126, 1), gsz=64):
    """Both packages' configs and params (JAX's init, quantized under
    ``policy``, copied across), and a shuffled pool as (jax, torch)."""
    kv = "int8" if form == "int8" else "none"
    jc, tc = jllama2("7b", **_kw(kv_cache_quant=kv)), \
        tllama2("7b", **_kw(kv_cache_quant=kv))
    jp = jmodel.init_params(jax.random.key(0), jc)
    if policy is not None:
        jp = jquant.quantize_params(jp, dataclasses.replace(
            jquant.POLICIES[policy], group_size=gsz))
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(2)
    b = len(fills)
    T = MAX_LEN // BLOCK
    tables = (rng.permutation(b * T) + 1).reshape(b, T).astype(np.int32)
    shape = (jc.num_layers, 1 + b * T, jc.kv_heads, BLOCK, jc.head_dim)

    def side():
        if form == "int8":
            q = rng.integers(-127, 128, shape).astype(np.int8)
            s = rng.uniform(0.002, 0.012, shape[:-1]).astype(np.float32)
            return ({"q": jnp.asarray(q), "scale": jnp.asarray(s)},
                    {"q": torch.from_numpy(q), "scale": torch.from_numpy(s)})
        a = rng.normal(size=shape).astype(np.float32)
        a[:, 0] = 1e4   # the trash block: finite garbage no row may see
        return jnp.asarray(a), torch.from_numpy(a)

    (jk, tk), (jv, tv) = side(), side()
    x = rng.normal(size=(b, W, jc.hidden_size)).astype(np.float32)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, jk=jk, jv=jv, tk=tk, tv=tv,
                tables=tables, fills=np.asarray(fills, np.int32), x=x, rng=rng)


def _topology(b, shape):
    depths_row, anc_set = shape
    depths = np.tile(np.asarray(depths_row, np.int32), (b, 1))
    anc = np.zeros((b, W, W), np.int32)
    for (j, dd), a in anc_set.items():
        anc[:, j, dd] = a
    return depths, anc


def _chain(b):
    depths = np.tile(np.arange(W, dtype=np.int32), (b, 1))
    anc = np.tile(np.arange(W, dtype=np.int32), (b, W, 1))
    return depths, anc


def _clone(pool):
    if isinstance(pool, dict):
        return {k: v.clone() for k, v in pool.items()}
    return pool.clone()


def _rope(tc):
    return tmodel.rope_tables(tc, device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _port_tree(s, depths, anc):
    return tds.fused_decode_verify_paged(
        s["tc"], s["tp"]["layers"], _t(s["x"]), s["tk"], s["tv"],
        _t(s["tables"]), _t(s["fills"]), _rope(s["tc"]), depths=_t(depths),
        anc=_t(anc))


# ---------------------------------------------------------------------------
# The plain tree version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form,policy", [("fp32", None), ("int8", None),
                                         ("fp32", "int8")])
def test_plain_tree_matches_pallas(form, policy):
    s = _setup(form, policy)
    b = len(s["fills"])
    depths, anc = _topology(b, BRANCHED)
    want = _jfused_decode_verify_paged(
        s["jc"], s["jp"]["layers"], jnp.asarray(s["x"]), s["jk"], s["jv"],
        jnp.asarray(s["tables"]), jnp.asarray(s["fills"]),
        jrope_tables(s["jc"]), depths=jnp.asarray(depths),
        anc=jnp.asarray(anc), interpret=True)
    got = _port_tree(s, depths, anc)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **TOL)


# ---------------------------------------------------------------------------
# Bitwise contracts inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form,policy", [("fp32", None), ("int8", None),
                                         ("fp32", "int8"), ("fp32", "int4")])
def test_chain_tree_equals_linear_bitwise(form, policy):
    """An explicit chain through the tree arm is the linear window, bit
    for bit: hidden and rows."""
    s = _setup(form, policy)
    b = len(s["fills"])
    linear = tds.fused_decode_verify_paged(
        s["tc"], s["tp"]["layers"], _t(s["x"]), s["tk"], s["tv"],
        _t(s["tables"]), _t(s["fills"]), _rope(s["tc"]))
    tree = _port_tree(s, *_chain(b))
    for a, c in zip(tree, linear):
        assert torch.equal(a, c)


def _append(pool, rows, tables, pos):
    """The host's pool write of a step's returned rows at each slot's
    ``pos``."""
    S = tables.shape[0]
    bids = tables[torch.arange(S), pos // BLOCK]
    if isinstance(pool, dict):
        rows = quantize_rows(rows)
    tmodel.cache_append_rows(pool, rows, bids, pos % BLOCK)


@pytest.mark.parametrize("form,policy", [("fp32", None), ("int8", None),
                                         ("int8", "int8"), ("fp32", "int4")])
def test_branched_tree_equals_sequential_bitwise(form, policy):
    """Every node of a branched tree (fill 126: depth-2 nodes cross the
    128 block edge) is what sequential K13 steps down its root path give,
    with the host's pool writes between them, bit for bit."""
    s = _setup(form, policy)
    b = len(s["fills"])
    depths, anc = _topology(b, BRANCHED)
    h, kr, vr = _port_tree(s, depths, anc)
    tables, fills = _t(s["tables"]).long(), _t(s["fills"]).long()
    x = _t(s["x"])
    rows = [s_ * W for s_ in range(b)]
    for path in PATHS:
        kp, vp = _clone(s["tk"]), _clone(s["tv"])
        for t, node in enumerate(path):
            hs, ks, vs = tds.fused_decode_step_paged(
                s["tc"], s["tp"]["layers"], x[:, node], kp, vp, tables,
                fills + t, _rope(s["tc"]))
            assert torch.equal(h[:, node], hs)
            assert torch.equal(kr[:, [r + node for r in rows]], ks)
            assert torch.equal(vr[:, [r + node for r in rows]], vs)
            _append(kp, ks, tables, fills + t)
            _append(vp, vs, tables, fills + t)


def _lay(s):
    """Node-indexed landing spots (node j at position fill + j), what the
    engine passes in tree mode."""
    pos = s["fills"][:, None] + np.arange(W)[None, :]
    bids = np.take_along_axis(s["tables"], pos // BLOCK, 1).reshape(-1)
    return bids.astype(np.int32), (pos % BLOCK).reshape(-1).astype(np.int32)


def _window(s):
    return s["rng"].integers(0, 128, (len(s["fills"]), W)).astype(np.int32)


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_composed_tree_matches_jax(form):
    """The composed arm's logits and node-indexed pool writes against the
    JAX package's composed walk on the same pools."""
    s = _setup(form)
    b = len(s["fills"])
    depths, anc = _topology(b, BRANCHED)
    bids, offs = _lay(s)
    window = _window(s)
    want, wk, wv = jmodel.forward_cached_paged_verify(
        s["jc"], s["jp"], jnp.asarray(window), s["jk"], s["jv"],
        jnp.asarray(s["tables"]), jnp.asarray(s["fills"]),
        jnp.asarray(bids), jnp.asarray(offs), use_fused=False,
        tree=(jnp.asarray(depths), jnp.asarray(anc)))
    got, gk, gv = tmodel.forward_cached_paged_verify(
        s["tc"], s["tp"], _t(window).long(), _clone(s["tk"]),
        _clone(s["tv"]), _t(s["tables"]), _t(s["fills"]), _t(bids),
        _t(offs), use_fused=False, tree=(_t(depths), _t(anc)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w in ((gk, wk), (gv, wv)):
        if form == "int8":
            g = (g["q"].float() * g["scale"][..., None]).numpy()
            w = np.asarray(w["q"], np.float32) * np.asarray(
                w["scale"])[..., None]
            np.testing.assert_allclose(g, w, **INT8_ROW_TOL)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_composed_tree_and_compaction_equal_sequential(form):
    """The composed arm: every node's logits equal composed sequential
    steps down its root path, bit for bit; after ``cache_move_rows``
    packs the accepted path [0, 1, 3] to depth positions, the pool equals
    the sequential pool over every slot's live rows."""
    s = _setup(form)
    b = len(s["fills"])
    depths, anc = _topology(b, BRANCHED)
    bids, offs = _lay(s)
    window = _t(_window(s)).long()
    tables, fills = _t(s["tables"]).long(), _t(s["fills"]).long()
    got, kp, vp = tmodel.forward_cached_paged_verify(
        s["tc"], s["tp"], window, _clone(s["tk"]), _clone(s["tv"]), tables,
        fills, _t(bids), _t(offs), use_fused=False,
        tree=(_t(depths), _t(anc)))
    seq = {}
    for path in PATHS:
        ks, vs = _clone(s["tk"]), _clone(s["tv"])
        for t, node in enumerate(path):
            lg, ks, vs = tmodel.forward_cached_paged(
                s["tc"], s["tp"], window[:, node:node + 1], ks, vs, tables,
                fills + t, use_fused=False)
            assert torch.equal(got[:, node], lg[:, 0])
        seq[tuple(path)] = (ks, vs)
    path = PATHS[0]
    src = [(tables[i, (fills[i] + n) // BLOCK], (fills[i] + n) % BLOCK)
           for i in range(b) for n in path]
    dst = [(tables[i, (fills[i] + t) // BLOCK], (fills[i] + t) % BLOCK)
           for i in range(b) for t in range(len(path))]
    move = [torch.tensor([p[k] for p in pairs]) for pairs in (src, dst)
            for k in (0, 1)]
    tmodel.cache_move_rows(kp, *move)
    tmodel.cache_move_rows(vp, *move)
    for got_pool, want_pool in ((kp, seq[tuple(path)][0]),
                                (vp, seq[tuple(path)][1])):
        g = tmodel.cache_gather_blocks(got_pool, tables)
        w = tmodel.cache_gather_blocks(want_pool, tables)
        for leaf in (("q", "scale") if form == "int8" else (None,)):
            gl = g[leaf] if leaf else g
            wl = w[leaf] if leaf else w
            for i in range(b):
                n = int(fills[i]) + len(path)
                assert torch.equal(gl[:, i, :, :n], wl[:, i, :, :n])


def test_fused_and_composed_tree_arms_agree():
    """The fused arm (K14's tree mode, plain) and the composed walk give
    the same logits and the same pool."""
    s = _setup()
    b = len(s["fills"])
    depths, anc = _topology(b, BRANCHED)
    bids, offs = _lay(s)
    window = _t(_window(s)).long()
    outs = []
    for fused in (True, False):
        outs.append(tmodel.forward_cached_paged_verify(
            s["tc"], s["tp"], window, _clone(s["tk"]), _clone(s["tv"]),
            _t(s["tables"]), _t(s["fills"]), _t(bids), _t(offs),
            use_fused=fused, tree=(_t(depths), _t(anc))))
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(), **TOL)
    for a, c in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_allclose(a.numpy(), c.numpy(), **TOL)


# ---------------------------------------------------------------------------
# cache_move_rows and the tree check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["fp32", "int8"])
def test_cache_move_rows_matches_jax_with_overlap(form):
    """Overlapping moves (a row moved onto a position another move reads)
    act at once, as JAX's gather-then-scatter; trash -> trash entries are
    no-ops; int8 leaves move verbatim."""
    s = _setup(form)
    src_b = np.asarray([5, 5, 5, 0, 2], np.int32)
    src_o = np.asarray([10, 11, 12, 0, 3], np.int32)
    dst_b = np.asarray([5, 5, 5, 0, 4], np.int32)
    dst_o = np.asarray([11, 12, 13, 0, 100], np.int32)
    want = jmodel.cache_move_rows(s["jk"], src_b, src_o, dst_b, dst_o)
    got = tmodel.cache_move_rows(_clone(s["tk"]), _t(src_b), _t(src_o),
                                 _t(dst_b), _t(dst_o))
    pairs = ((got["q"], want["q"]), (got["scale"], want["scale"])) \
        if form == "int8" else ((got, want),)
    for g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        # the trash block takes duplicate writes in no promised order
        np.testing.assert_array_equal(g[:, 1:], w[:, 1:])


BAD_TREES = {
    "root-not-0": ([1, 1, 1, 2], {}),
    "depth-past-index": ([0, 2, 2, 2], {}),
    "depth-falls": ([0, 1, 2, 1], {(2, 1): 1}),
    "ancestor-after-node": ([0, 1, 1, 2], {(3, 1): 3}),
    "ancestor-negative": ([0, 1, 1, 2], {(3, 1): -1}),
}


@pytest.mark.parametrize("name", list(BAD_TREES))
def test_bad_trees_raise(name):
    s = _setup()
    b = len(s["fills"])
    depths, anc = _topology(b, BAD_TREES[name])
    with pytest.raises(ValueError, match="tree"):
        _port_tree(s, depths, anc)


def test_good_trees_pass_the_check():
    for depths, anc in (_chain(3), _topology(3, BRANCHED),
                        (np.zeros((3, W), np.int32),
                         np.zeros((3, W, W), np.int32))):
        tds.check_tree(_t(depths), _t(anc))
