"""The split cache walk of the decode-attention kernels (K8-K11) on the
CPU: the Python mirror of the kernels' split plan, and the split-then-merge
plain version against the JAX package's Pallas kernels in interpret mode.

The CUDA kernels cut each row's walk into splits of ``SPLIT_COLS``
columns and merge the splits' fp32 partial states in split order;
``flash_decode_split_plain`` does the same in plain torch.  Shapes are
``[b=5, nq 8, kv 8/g, max_len 512, d 128]``, fills ``C - 1``, ``C``,
``C + 1``, the width and 0 (C = ``SPLIT_COLS``); pools are shuffled, table
entries past a row's fill point at the trash block 0, which holds large
finite garbage.  ``test_torch_cuda.py`` holds the kernels against their
plain versions on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.kernels import flash_decode as jfd
from megatron_llm_tpu_torch.kernels import flash_decode as tfd

torch.set_num_threads(1)

CSRC = Path(tfd.__file__).resolve().parents[1] / "csrc"
C = tfd.SPLIT_COLS
B, NQ, MAX_LEN, D = 5, 8, 512, 128
FILLS = [C - 1, C, C + 1, MAX_LEN, 0]
# fp32 on both sides: the same function, the TPU kernel's softmax tiled
# online over 512 columns and the split version's merged over 256-column
# splits; sums in another order
TOL = dict(rtol=1e-5, atol=1e-5)


def test_split_cols_mirror_the_cuda_source():
    """``SPLIT_COLS`` and the body code are the CUDA source's constants."""
    src = (CSRC / "flash_decode.cu").read_text()
    assert int(re.search(r"constexpr int kSplitCols = (\d+);", src)
               .group(1)) == C
    common = (CSRC / "common.cuh").read_text()
    assert int(re.search(r"kBodySplit = (\d+);", common).group(1)) \
        == tfd._BODY_SPLIT
    # a multiple of every pool block the engine and the tests use, and of
    # the kernels' 64-row tiles
    assert all(C % blk == 0 for blk in (16, 64, 128))


@pytest.mark.parametrize("width", [MAX_LEN, 2048, 300])
@pytest.mark.parametrize("fill", [1, C - 1, C, C + 1, 2 * C + 7, 300, 512,
                                  2048, 0, 5000])
def test_decode_splits_cover_the_fill_once_in_order(fill, width):
    n = width if fill <= 0 or fill > width else fill
    plan = tfd.decode_splits(fill, width)
    assert plan == tfd.decode_splits(fill, width)
    cols = [j for s0, s1 in plan for j in range(s0, s1)]
    assert cols == list(range(n))          # once each, in order
    assert all(s1 > s0 for s0, s1 in plan)
    for s0, s1 in plan:
        assert s0 % 128 == 0 and s0 % 64 == 0 and s0 % 16 == 0
        assert s1 == n or s1 % C == 0
    assert len(plan) == -(-n // C) <= tfd.n_splits(width)


def _inputs(rng, kv, int8):
    q = rng.normal(size=(B, NQ, D)).astype(np.float32)
    if int8:
        shape = (B, kv, MAX_LEN, D)
        kq = rng.integers(-127, 128, shape).astype(np.int8)
        vq = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.002, 0.012, shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.002, 0.012, shape[:-1]).astype(np.float32)
        return q, (kq, ks, vq, vs)
    k = rng.normal(size=(B, kv, MAX_LEN, D)).astype(np.float32)
    v = rng.normal(size=(B, kv, MAX_LEN, D)).astype(np.float32)
    return q, (k, v)


def _tables(rng, block):
    n_tbl = MAX_LEN // block
    tables = (rng.permutation(B * n_tbl) + 1).reshape(B, n_tbl)
    for i, n in enumerate(FILLS):
        tables[i, -(-n // block):] = 0
    return tables.astype(np.int32)


def _pool(dense, tables, garbage):
    n_tbl = tables.shape[1]
    block = dense.shape[2] // n_tbl
    pool = np.full((1 + B * n_tbl, dense.shape[1], block) + dense.shape[3:],
                   garbage, dense.dtype)
    for bi in range(B):
        for j in range(n_tbl):
            if tables[bi, j]:
                pool[tables[bi, j]] = dense[bi, :, j * block:(j + 1) * block]
    return pool


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _split(q, caches, fills, tables=None):
    """The split plain version over dense (k, v) or int8 (kq, ks, vq, vs)
    leaves, or their pools through ``tables``."""
    t = [_t(a) for a in caches]
    kw = {} if tables is None else {"tables": _t(tables)}
    if len(t) == 4:
        return tfd.flash_decode_split_plain(_t(q), t[0], t[2], _t(fills),
                                            k_scale=t[1], v_scale=t[3], **kw)
    return tfd.flash_decode_split_plain(_t(q), t[0], t[1], _t(fills), **kw)


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("kind", ["dense", "int8", "paged", "paged_int8"])
def test_split_plain_matches_pallas(kind, group):
    """Split-then-merge in the kernels' order against the Pallas kernel the
    kernels replace (K8, K9, K10, K11), in interpret mode."""
    rng = np.random.default_rng(11 + group)
    int8 = kind.endswith("int8")
    q, dense = _inputs(rng, NQ // group, int8)
    fills = np.asarray(FILLS, np.int32)
    jq, jl = jnp.asarray(q), jnp.asarray(fills)
    if kind.startswith("paged"):
        tables = _tables(rng, 64)
        garbage = (127, 1e4, 127, 1e4) if int8 else (1e4, 1e4)
        pools = [_pool(a, tables, g) for a, g in zip(dense, garbage)]
        call = jfd.flash_decode_paged_int8 if int8 else jfd.flash_decode_paged
        want = call(jq, *(jnp.asarray(a) for a in pools), jnp.asarray(tables),
                    jl, interpret=True)
        got = _split(q, pools, fills, tables)
    else:
        call = jfd.flash_decode_int8 if int8 else jfd.flash_decode
        want = call(jq, *(jnp.asarray(a) for a in dense), jl, interpret=True)
        got = _split(q, dense, fills)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the one-pass plain version the wrappers take on the CPU, over the
    # dense cache (where a pool's fill-0 row averages the trash block, the
    # width it walks, the dense row averages its own cache: rows 0-3 only)
    plain = tfd.flash_decode_int8_plain if int8 else tfd.flash_decode_plain
    one = plain(_t(q), *(_t(a) for a in dense), _t(fills))
    rows = slice(0, B - 1) if kind.startswith("paged") else slice(0, B)
    np.testing.assert_allclose(got[rows].numpy(), one[rows].numpy(), **TOL)


@pytest.mark.parametrize("kind", ["dense", "int8", "paged"])
def test_split_plain_row_alone_equals_its_row_in_a_batch(kind):
    """A row's bits depend only on its own q, cache and fill."""
    rng = np.random.default_rng(21)
    int8 = kind == "int8"
    q, dense = _inputs(rng, 2, int8)
    fills = np.asarray(FILLS, np.int32)
    tables = None
    if kind == "paged":
        tables = _tables(rng, 64)
        dense = [_pool(a, tables, 1e4) for a in dense]
    batch = _split(q, dense, fills, tables)
    for i in range(B):
        if tables is None:
            alone = _split(q[i:i + 1], [a[i:i + 1] for a in dense],
                           fills[i:i + 1])
        else:
            alone = _split(q[i:i + 1], dense, fills[i:i + 1],
                           tables[i:i + 1])
        assert torch.equal(alone[0], batch[i]), i
