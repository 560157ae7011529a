"""The port's BERT, T5 and ICT datasets against the JAX package's: over a
sentence-per-item corpus (and a titles corpus) that the port's
``indexed_dataset`` writes, the mappings and every sample are equal byte
for byte, both packages reading the same files.  The numpy draws are the
same code on the same seeds, so nothing here has a tolerance."""

import numpy as np
import pytest

from megatron_llm_tpu.data import bert_dataset as jbert
from megatron_llm_tpu.data import ict_dataset as jict
from megatron_llm_tpu.data import indexed_dataset as jidx
from megatron_llm_tpu.data import t5_dataset as jt5
from megatron_llm_tpu_torch.data import bert_dataset as tbert
from megatron_llm_tpu_torch.data import ict_dataset as tict
from megatron_llm_tpu_torch.data import indexed_dataset as tidx
from megatron_llm_tpu_torch.data import t5_dataset as tt5

VOCAB = 96


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 documents of 2-6 sentences of 4-14 tokens, and one 2-4 token
    title per document, written by the port."""
    root = tmp_path_factory.mktemp("encdec_corpus")
    rng = np.random.default_rng(0)
    sents = tidx.MMapIndexedDatasetBuilder(str(root / "sentences"),
                                           dtype=np.int32)
    titles = tidx.MMapIndexedDatasetBuilder(str(root / "titles"),
                                            dtype=np.int32)
    for _ in range(24):
        for _ in range(int(rng.integers(2, 7))):
            sents.add_item(rng.integers(1, 80, int(rng.integers(4, 15))))
        sents.end_document()
        titles.add_doc(rng.integers(1, 80, int(rng.integers(2, 5))))
    sents.finalize()
    titles.finalize()
    return str(root / "sentences"), str(root / "titles")


def _same_samples(jds, tds, n=None):
    """Equal lengths, mappings and samples (keys, dtypes, shapes, bytes)."""
    assert len(jds) == len(tds) > 0
    np.testing.assert_array_equal(np.asarray(jds.mapping),
                                  np.asarray(tds.mapping))
    for i in range(len(jds) if n is None else min(n, len(jds))):
        a, b = jds[i], tds[i]
        assert list(a) == list(b)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, (i, k)
            assert x.tobytes() == y.tobytes(), (i, k)


@pytest.mark.parametrize("seq,prob,epochs,seed", [
    (48, 0.15, 1, 0), (32, 0.3, 2, 7)])
def test_bert_samples_equal_jax(corpus, seq, prob, epochs, seed):
    path, _ = corpus
    jsp = jbert.BertSpecialTokens(cls=92, sep=93, mask=94, pad=0)
    tsp = tbert.BertSpecialTokens(cls=92, sep=93, mask=94, pad=0)
    jds = jbert.BertDataset(jidx.MMapIndexedDataset(path), seq, VOCAB, jsp,
                            masked_lm_prob=prob, num_epochs=epochs,
                            seed=seed)
    tds = tbert.BertDataset(tidx.MMapIndexedDataset(path), seq, VOCAB, tsp,
                            masked_lm_prob=prob, num_epochs=epochs,
                            seed=seed)
    _same_samples(jds, tds)


@pytest.mark.parametrize("sentinels", [None, [70, 71, 72, 73, 74]])
def test_t5_samples_equal_jax(corpus, sentinels):
    path, _ = corpus
    jds = jt5.T5Dataset(jidx.MMapIndexedDataset(path), 48, 24, VOCAB,
                        jt5.T5SpecialTokens(bos=0, eos=1, pad=0), seed=3,
                        sentinel_ids=sentinels)
    tds = tt5.T5Dataset(tidx.MMapIndexedDataset(path), 48, 24, VOCAB,
                        tt5.T5SpecialTokens(bos=0, eos=1, pad=0), seed=3,
                        sentinel_ids=sentinels)
    _same_samples(jds, tds)


@pytest.mark.parametrize("titles,one_sent", [(False, False), (True, False),
                                             (True, True)])
def test_ict_samples_and_blocks_equal_jax(corpus, titles, one_sent):
    path, tpath = corpus
    kw = dict(remove_prob=0.9, seed=1, use_one_sent_blocks=one_sent)
    jds = jict.ICTDataset(
        jidx.MMapIndexedDataset(path), 16, 48,
        jict.ICTSpecialTokens(cls=90, sep=91, pad=0),
        titles=jidx.MMapIndexedDataset(tpath) if titles else None, **kw)
    tds = tict.ICTDataset(
        tidx.MMapIndexedDataset(path), 16, 48,
        tict.ICTSpecialTokens(cls=90, sep=91, pad=0),
        titles=tidx.MMapIndexedDataset(tpath) if titles else None, **kw)
    _same_samples(jds, tds)
    # the evidence blocks the REALM indexer reads
    for start, end, doc, _ in np.asarray(tds.mapping):
        for a, b in zip(jds.get_block(int(start), int(end), int(doc)),
                        tds.get_block(int(start), int(end), int(doc))):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_port_corpus_reads_the_same_in_both_packages(corpus):
    path, _ = corpus
    j, t = jidx.MMapIndexedDataset(path), tidx.MMapIndexedDataset(path)
    np.testing.assert_array_equal(np.asarray(j.sizes), np.asarray(t.sizes))
    np.testing.assert_array_equal(np.asarray(j.doc_idx),
                                  np.asarray(t.doc_idx))
    for i in range(len(t)):
        assert np.asarray(j[i]).tobytes() == np.asarray(t[i]).tobytes()
