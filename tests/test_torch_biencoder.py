"""The ICT biencoder (``models/biencoder.py``) and the REALM index
(``models/realm_indexer.py``) through the port against the JAX package,
fp32 on the CPU.

Tiny BERT towers (2 layers, hidden 32, 4 heads); weights carried across
with ``params_from_jax``; batches and corpora made with numpy from a seed.
Embeddings, the retrieval loss and every gradient are held within fp32
reassociation; retrieval (``DenseIndex``, ``mips_search``, ``IndexBuilder``
over shards) must give JAX's top-k, and each package reads the other's
store files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_llm_tpu.config import ModelConfig as JModelConfig
from megatron_llm_tpu.data import ict_dataset as jict
from megatron_llm_tpu.data import indexed_dataset as jidx
from megatron_llm_tpu.models import biencoder as jbi
from megatron_llm_tpu.models import realm_indexer as jrealm
from megatron_llm_tpu_torch.config import ModelConfig as TModelConfig
from megatron_llm_tpu_torch.convert import params_from_jax
from megatron_llm_tpu_torch.data import ict_dataset as tict
from megatron_llm_tpu_torch.data import indexed_dataset as tidx
from megatron_llm_tpu_torch.models import biencoder as tbi
from megatron_llm_tpu_torch.models import realm_indexer as trealm
from megatron_llm_tpu_torch.utils.tree import tree_leaves, \
    tree_leaves_with_path

torch.set_num_threads(1)

KW = dict(vocab_size=96, hidden_size=32, num_layers=2, num_attention_heads=4,
          num_kv_heads=4, ffn_hidden_size=64, max_position_embeddings=48,
          norm_type="layernorm", activation="gelu",
          position_embedding_type="absolute", use_bias=True,
          tie_embed_logits=True, tokentype_size=2, params_dtype="float32",
          attention_impl="dot", recompute="none",
          make_vocab_size_divisible_by=8, seq_length=48)
# fp32 on both sides, sums in another order
EMB_TOL = dict(rtol=1e-4, atol=2e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
# (shared, projection_dim, pooling)
TOWERS = [(False, 0, "cls"), (True, 0, "mean"), (False, 16, "mean"),
          (True, 16, "cls")]


def _pair(shared, proj):
    jc, tc = JModelConfig(**KW).validate(), TModelConfig(**KW).validate()
    jp = jbi.init_biencoder_params(jax.random.key(0), jc,
                                   projection_dim=proj, shared=shared)
    return jc, jp, tc, params_from_jax(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _batch(seed=0, b=4):
    rng = np.random.default_rng(seed)
    q_len = rng.integers(4, 17, b)
    c_len = rng.integers(10, 49, b)
    return {
        "query_tokens": rng.integers(1, 90, (b, 16)).astype(np.int32),
        "query_pad_mask": (np.arange(16)[None] < q_len[:, None]).astype(
            np.float32),
        "context_tokens": rng.integers(1, 90, (b, 48)).astype(np.int32),
        "context_pad_mask": (np.arange(48)[None] < c_len[:, None]).astype(
            np.float32),
    }


def _tb(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("shared,proj,pooling", TOWERS)
def test_embeddings_loss_and_grads_match_jax(shared, proj, pooling):
    jc, jp, tc, tp = _pair(shared, proj)
    assert ("context" in tp) == (not shared)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = _tb(batch)
    jq, jctx = jax.jit(lambda p, b: jbi.biencoder_forward(
        jc, p, b["query_tokens"], b["query_pad_mask"],
        b["context_tokens"], b["context_pad_mask"], pooling=pooling))(jp, jb)
    with torch.no_grad():
        tq, tctx = tbi.biencoder_forward(
            tc, tp, tb["query_tokens"], tb["query_pad_mask"],
            tb["context_tokens"], tb["context_pad_mask"], pooling=pooling)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **EMB_TOL)
    np.testing.assert_allclose(tctx.numpy(), np.asarray(jctx), **EMB_TOL)
    scores = tbi.retrieval_scores(tq, tctx)
    assert float(tbi.retrieval_accuracy(scores)) == float(
        jbi.retrieval_accuracy(jnp.asarray(np.asarray(jq) @ np.asarray(
            jctx).T)))

    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jbi.retrieval_loss(jc, p, jb, pooling=pooling)))(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    t_loss = tbi.retrieval_loss(tc, tp, tb, pooling=pooling)
    # mean pooling leaves the pooler out of the graph: JAX's grad is 0
    grads = torch.autograd.grad(t_loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(t_loss.detach()), float(j_loss),
                               **LOSS_TOL)
    for (path, t), g in zip(tree_leaves_with_path(tp), grads):
        g = torch.zeros_like(t) if g is None else g
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(_leaf(j_grads, path)),
                                   err_msg=".".join(path), **GRAD_TOL)


def test_init_tree_matches_jax():
    for shared, proj, _ in TOWERS:
        _, jp, tc, _ = _pair(shared, proj)
        tp = tbi.init_biencoder_params(tc, seed=1, device="cpu",
                                       projection_dim=proj, shared=shared)
        want = {tuple(str(k.key) for k in path): leaf.shape
                for path, leaf in jax.tree.leaves_with_path(jp)}
        got = {p: tuple(t.shape) for p, t in tree_leaves_with_path(tp)}
        assert got == want


@pytest.fixture(scope="module")
def evidence(tmp_path_factory):
    """A sentence corpus the port writes, and both packages' ICT datasets
    over it."""
    root = tmp_path_factory.mktemp("evidence")
    rng = np.random.default_rng(3)
    b = tidx.MMapIndexedDatasetBuilder(str(root / "s"), dtype=np.int32)
    for _ in range(14):
        for _ in range(int(rng.integers(2, 5))):
            b.add_item(rng.integers(1, 80, int(rng.integers(5, 11))))
        b.end_document()
    b.finalize()
    jds = jict.ICTDataset(jidx.MMapIndexedDataset(str(root / "s")), 16, 48,
                          jict.ICTSpecialTokens(cls=90, sep=91, pad=0),
                          seed=1)
    tds = tict.ICTDataset(tidx.MMapIndexedDataset(str(root / "s")), 16, 48,
                          tict.ICTSpecialTokens(cls=90, sep=91, pad=0),
                          seed=1)
    return root, jds, tds


class _Blocks:
    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        s = self.ds[i]
        return {"tokens": s["context_tokens"],
                "pad_mask": s["context_pad_mask"]}


@pytest.mark.parametrize("shared,proj,pooling", TOWERS[2:])
def test_dense_index_top_k_matches_jax(evidence, shared, proj, pooling):
    _, jds, tds = evidence
    jc, jp, tc, tp = _pair(shared, proj)
    jidx_ = jbi.DenseIndex(jc, jp, batch_size=8, pooling=pooling)
    tidx_ = tbi.DenseIndex(tc, tp, batch_size=8, pooling=pooling)
    j_emb = jidx_.build(_Blocks(jds))
    t_emb = tidx_.build(_Blocks(tds))
    np.testing.assert_allclose(t_emb, j_emb, **EMB_TOL)
    q = np.stack([tds[i]["query_tokens"] for i in range(6)])
    m = np.stack([tds[i]["query_pad_mask"] for i in range(6)])
    j_i, j_s = jidx_.retrieve(q, m, top_k=5)
    t_i, t_s = tidx_.retrieve(q, m, top_k=5)
    np.testing.assert_array_equal(t_i, j_i)
    np.testing.assert_allclose(t_s, j_s, **EMB_TOL)


def test_mips_search_matches_jax():
    rng = np.random.default_rng(5)
    blocks = rng.standard_normal((300, 24)).astype(np.float32)
    queries = rng.standard_normal((7, 24)).astype(np.float32)
    for k in (1, 10, 300, 500):
        j_i, j_s = jrealm.mips_search(blocks, queries, k)
        t_i, t_s = trealm.mips_search(blocks, queries, k)
        np.testing.assert_array_equal(t_i, j_i)
        np.testing.assert_allclose(t_s, j_s, rtol=1e-6, atol=1e-6)


def test_index_builder_shards_merge_like_jax(evidence):
    """Two ranks' shards merged by rank 0: the port's store equals JAX's
    built over the same blocks, and each package loads the other's file;
    the top-k from either store is the same."""
    root, jds, tds = evidence
    jc, jp, tc, tp = _pair(False, 16)
    # world 2 without a process group: save each rank's shard, then merge
    for rank in (0, 1):
        b = trealm.IndexBuilder(tc, tp, tds, str(root / "port.npz"),
                                batch_size=5, rank=rank, world=2,
                                pooling="mean")
        b.build()
        b.store.save_shard(rank)
    merged = trealm.BlockDataStore(str(root / "port.npz"))
    merged.merge_shards_and_save()
    jstore = jrealm.IndexBuilder(jc, jp, jds, str(root / "jax.npz"),
                                 batch_size=5,
                                 pooling="mean").build_and_save_index()
    t_ids, t_vecs = trealm.BlockDataStore.load(
        str(root / "port.npz")).as_arrays()
    j_ids, j_vecs = jstore.as_arrays()
    np.testing.assert_array_equal(t_ids, j_ids)
    assert len(set(t_ids.tolist())) == len(t_ids)
    np.testing.assert_allclose(t_vecs, j_vecs, **EMB_TOL)
    # cross-reading: each package loads the other's merged store
    x_ids, x_vecs = jrealm.BlockDataStore.load(
        str(root / "port.npz")).as_arrays()
    np.testing.assert_array_equal(x_ids, t_ids)
    np.testing.assert_array_equal(x_vecs, t_vecs)
    y_ids, _ = trealm.BlockDataStore.load(str(root / "jax.npz")).as_arrays()
    np.testing.assert_array_equal(y_ids, j_ids)
    q = np.random.default_rng(0).standard_normal((5, 16)).astype(np.float32)
    np.testing.assert_array_equal(trealm.mips_search(t_vecs, q, 4)[0],
                                  jrealm.mips_search(j_vecs, q, 4)[0])
