"""The port's data layer against the JAX package's, on the CPU.

The same documents, prefixes, splits and seeds go through both packages'
``data/`` modules; every comparison is exact (bytes, index arrays,
samples).  The C++ index helpers are built by each package from its own
copy of ``index_helpers.cpp``: the port's into ``build/native/``.
"""

import ctypes
import itertools
from pathlib import Path

import numpy as np
import pytest

from megatron_llm_tpu.data import blendable_dataset as jblend
from megatron_llm_tpu.data import gpt_dataset as jgpt
from megatron_llm_tpu.data import index_helpers as jih
from megatron_llm_tpu.data import indexed_dataset as jidx
from megatron_llm_tpu.data import instruction_dataset as jinst
from megatron_llm_tpu.data import samplers as jsamplers
from megatron_llm_tpu_torch.data import blendable_dataset as tblend
from megatron_llm_tpu_torch.data import gpt_dataset as tgpt
from megatron_llm_tpu_torch.data import index_helpers as tih
from megatron_llm_tpu_torch.data import indexed_dataset as tidx
from megatron_llm_tpu_torch.data import instruction_dataset as tinst
from megatron_llm_tpu_torch.data import samplers as tsamplers
from megatron_llm_tpu_torch.utils import native


def _docs(n=40, vocab=300, seed=0, lo=1, hi=60):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def _write_both(tmp_path, docs, dtype=np.uint16, name="c"):
    j, t = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
    jidx.write_dataset(str(j), docs, dtype)
    tidx.write_dataset(str(t), docs, dtype)
    return str(j), str(t)


# ---------------------------------------------------------------------------
# The .bin/.idx format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint16, np.int32, np.int64])
def test_bin_idx_bytes_equal_jax(tmp_path, dtype):
    j, t = _write_both(tmp_path, _docs() + [[]] + _docs(5, seed=1), dtype)
    for ext in (".bin", ".idx"):
        assert Path(t + ext).read_bytes() == Path(j + ext).read_bytes()
    ds = tidx.MMapIndexedDataset(t)
    ref = jidx.MMapIndexedDataset(j)
    assert ds.dtype == ref.dtype and len(ds) == len(ref)
    np.testing.assert_array_equal(ds.sizes, ref.sizes)
    np.testing.assert_array_equal(ds.doc_idx, ref.doc_idx)
    for i in (0, 3, len(ds) - 1):
        np.testing.assert_array_equal(ds[i], ref[i])
        np.testing.assert_array_equal(ds.get(i, 1, 2) if ds.sizes[i] > 2
                                      else ds[i], ref.get(i, 1, 2)
                                      if ref.sizes[i] > 2 else ref[i])
    assert tidx.best_dtype(32000) == jidx.best_dtype(32000) == np.uint16
    assert tidx.best_dtype(128256) == jidx.best_dtype(128256) == np.int32


def test_builder_merge_bytes_equal_jax(tmp_path):
    a = _write_both(tmp_path, _docs(7, seed=2), name="a")
    b = _write_both(tmp_path, _docs(9, seed=3), name="b")
    out = {}
    for k, (mod, (pa, pb)) in enumerate(((jidx, (a[0], b[0])),
                                         (tidx, (a[1], b[1])))):
        prefix = str(tmp_path / f"merged{k}")
        builder = mod.MMapIndexedDatasetBuilder(prefix, np.uint16)
        builder.add_doc([1, 2, 3])
        builder.merge_file(pa)
        builder.merge_file(pb)
        builder.finalize()
        out[k] = prefix
    for ext in (".bin", ".idx"):
        assert (Path(out[1] + ext).read_bytes()
                == Path(out[0] + ext).read_bytes())


# ---------------------------------------------------------------------------
# The C++ helpers and their numpy twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_length,num_epochs", [(8, 1), (17, 3), (64, 2)])
def test_sample_idx_native_python_and_jax_agree(seq_length, num_epochs):
    rng = np.random.default_rng(seq_length)
    sizes = rng.integers(1, 50, 30).astype(np.int32)
    doc_idx = np.tile(np.arange(30, dtype=np.int32), num_epochs)
    rng.shuffle(doc_idx)
    tokens = int(sizes.sum())
    args = (sizes, doc_idx, seq_length, num_epochs, tokens)
    got = tih.build_sample_idx(*args)
    np.testing.assert_array_equal(got, tih.build_sample_idx(*args,
                                                            native=False))
    np.testing.assert_array_equal(got, jih.build_sample_idx(*args))
    np.testing.assert_array_equal(got, jih.build_sample_idx_py(*args))
    assert got.dtype == np.int32


@pytest.mark.parametrize("weights", [[0.7, 0.3], [1, 1, 1], [0.05, 0.9, 0.05]])
def test_blending_indices_native_python_and_jax_agree(weights):
    w = np.asarray(weights, np.float64) / np.sum(weights)
    got = tih.build_blending_indices(w, 1000)
    for want in (tih.build_blending_indices(w, 1000, native=False),
                 jih.build_blending_indices(w, 1000),
                 jih.build_blending_indices_py(w, 1000)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _sentences(seed=0):
    rng = np.random.default_rng(seed)
    per_doc = rng.integers(1, 8, 25)
    doc_sent_idx = np.concatenate([[0], np.cumsum(per_doc)]).astype(np.int64)
    sent_sizes = rng.integers(1, 40, int(per_doc.sum())).astype(np.int32)
    return sent_sizes, doc_sent_idx


@pytest.mark.parametrize("native", [True, False])
def test_bert_mapping_matches_jax(native):
    """The two paths draw different random streams (mt19937 against
    numpy's Generator): each matches JAX's same path exactly."""
    sent_sizes, doc_sent_idx = _sentences()
    args = (sent_sizes, doc_sent_idx, 64, 0.2, 2, 7)
    got = tih.build_bert_mapping(*args, native=native)
    want = (jih.build_bert_mapping(*args) if native
            else jih.build_bert_mapping_py(*args))
    assert jih.native_available()
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == 3 and len(got) > 0


@pytest.mark.parametrize("native", [True, False])
def test_blocks_mapping_matches_jax(native):
    sent_sizes, doc_sent_idx = _sentences(1)
    title_sizes = np.random.default_rng(2).integers(
        1, 6, len(doc_sent_idx) - 1).astype(np.int32)
    kw = dict(num_epochs=2, max_num_samples=50, max_seq_length=48,
              long_sentence_len=35, use_one_sent_blocks=False, seed=3)
    got = tih.build_blocks_mapping(doc_sent_idx, sent_sizes, title_sizes,
                                   native=native, **kw)
    if native:
        want = jih.build_blocks_mapping(doc_sent_idx, sent_sizes,
                                        title_sizes, **kw)
    else:
        want = jih.build_blocks_mapping_py(
            doc_sent_idx, sent_sizes, title_sizes, kw["num_epochs"],
            kw["max_num_samples"], kw["max_seq_length"],
            kw["long_sentence_len"], kw["use_one_sent_blocks"], kw["seed"])
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == 4 and len(got) > 0


def test_gxx_failure_raises_rather_than_falling_back(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeBuildError, match="broken.cpp"):
        native.compile_and_load(bad)
    with pytest.raises(native.NativeBuildError, match="no-such-compiler"):
        native.compile_and_load(bad, compiler="no-such-compiler")
    # the index helpers raise too when their library cannot be built: no
    # numpy fallback unless asked for
    monkeypatch.setattr(tih, "_lib", None)
    monkeypatch.setattr(tih, "compile_and_load",
                        lambda src: native.compile_and_load(
                            src, compiler="no-such-compiler"))
    sizes, doc_idx = np.array([5, 7], np.int32), np.array([0, 1], np.int32)
    with pytest.raises(native.NativeBuildError):
        tih.build_sample_idx(sizes, doc_idx, 4, 1, 12)
    assert tih.build_sample_idx(sizes, doc_idx, 4, 1, 12,
                                native=False).shape == (3, 2)


def test_native_library_is_hashed_and_reused(tmp_path, monkeypatch):
    src = tmp_path / "one.cpp"
    src.write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    lib = native.compile_and_load(src)
    lib.one.restype = ctypes.c_int
    assert lib.one() == 1
    built = list((tmp_path / "build").glob("one-*.so"))
    assert len(built) == 1 and built[0] == native.target(src)
    assert native.compile_and_load(src) is lib
    src.write_text('extern "C" int one() { return 2; }\n')
    assert native.target(src) != built[0]   # an edit rebuilds


# ---------------------------------------------------------------------------
# GPT, blended and instruction datasets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_samples,seq_length,seed", [
    (20, 16, 1234),     # one epoch
    (300, 32, 7),       # several epochs, separate last epoch
    (57, 9, 3),
])
def test_gpt_dataset_matches_jax(tmp_path, num_samples, seq_length, seed):
    j, t = _write_both(tmp_path, _docs(60, seed=seed))
    docs = np.arange(5, 50, dtype=np.int32)
    want = jgpt.GPTDataset("train", jidx.MMapIndexedDataset(j), docs,
                           num_samples, seq_length, seed,
                           str(tmp_path / "jcache"))
    got = tgpt.GPTDataset("train", tidx.MMapIndexedDataset(t), docs,
                          num_samples, seq_length, seed,
                          str(tmp_path / "tcache"))
    for name in ("doc_idx", "sample_idx", "shuffle_idx"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(got) == len(want) >= num_samples
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i]["text"], want[i]["text"])
    # the cache files carry JAX's names (the prefix part aside)
    jnames = sorted(p.name.replace("jax_c", "X")
                    for p in (tmp_path / "jcache").iterdir())
    tnames = sorted(p.name.replace("port_c", "X")
                    for p in (tmp_path / "tcache").iterdir())
    assert [n.split("_", 2)[2] for n in tnames] == \
        [n.split("_", 2)[2] for n in jnames]


def test_gpt_index_cache_is_reused(tmp_path, monkeypatch):
    _, t = _write_both(tmp_path, _docs(30))
    ds = tidx.MMapIndexedDataset(t)
    docs = np.arange(30, dtype=np.int32)
    first = tgpt.GPTDataset("train", ds, docs, 40, 16, 5, str(tmp_path))
    files = sorted(tmp_path.glob("*.npy"))
    assert len(files) == 3
    stamps = [f.stat().st_mtime_ns for f in files]

    def no_rebuild(*a, **k):
        raise AssertionError("the index was rebuilt")

    monkeypatch.setattr(tih, "build_sample_idx", no_rebuild)
    again = tgpt.GPTDataset("train", ds, docs, 40, 16, 5, str(tmp_path))
    assert [f.stat().st_mtime_ns for f in files] == stamps
    np.testing.assert_array_equal(again.shuffle_idx, first.shuffle_idx)
    # another seed is another cache entry
    monkeypatch.undo()
    tgpt.GPTDataset("train", ds, docs, 40, 16, 6, str(tmp_path))
    assert len(list(tmp_path.glob("*.npy"))) == 6


@pytest.mark.parametrize("split", ["969,30,1", "80,10,10", "1"])
def test_build_gpt_datasets_and_split_match_jax(tmp_path, split):
    j, t = _write_both(tmp_path, _docs(50, seed=4))
    assert tgpt.get_train_valid_test_split(split, 50) == \
        jgpt.get_train_valid_test_split(split, 50)
    nums = [30, 6, 6]
    want = jgpt.build_gpt_datasets(j, split, nums, 16, 9,
                                   str(tmp_path / "j"))
    got = tgpt.build_gpt_datasets(t, split, nums, 16, 9,
                                  str(tmp_path / "t"))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert len(g) == len(w)
            for i in range(len(g)):
                np.testing.assert_array_equal(g[i]["text"], w[i]["text"])


def test_blendable_dataset_matches_jax(tmp_path):
    a = _write_both(tmp_path, _docs(40, seed=5), name="a")
    b = _write_both(tmp_path, _docs(30, seed=6), name="b")
    sets = {}
    for k, (gpt, idx, pa, pb) in enumerate(((jgpt, jidx, a[0], b[0]),
                                            (tgpt, tidx, a[1], b[1]))):
        parts = [gpt.GPTDataset("train", idx.MMapIndexedDataset(p),
                                np.arange(n, dtype=np.int32), 80, 16, 11,
                                str(tmp_path / f"cache{k}"))
                 for p, n in ((pa, 40), (pb, 30))]
        mod = jblend if k == 0 else tblend
        sets[k] = mod.BlendableDataset(parts, [0.7, 0.3], 150)
    want, got = sets[0], sets[1]
    np.testing.assert_array_equal(got.dataset_index, want.dataset_index)
    np.testing.assert_array_equal(got.dataset_sample_index,
                                  want.dataset_sample_index)
    for i in range(len(got)):
        np.testing.assert_array_equal(got[i]["text"], want[i]["text"])
    for paths in (["corpus"], ["0.3", "a", "0.7", "b"]):
        assert tblend.parse_data_paths(paths) == \
            jblend.parse_data_paths(paths)


def _instruction_both(tmp_path, n=30):
    rng = np.random.default_rng(8)
    text, role = [], []
    for _ in range(n):
        k = int(rng.integers(3, 40))
        text.append(rng.integers(0, 200, k).tolist())
        role.append(rng.integers(0, 3, k).tolist())
    prefixes = []
    for k, mod in enumerate((jidx, tidx)):
        p = str(tmp_path / f"inst{k}")
        mod.write_dataset(p + "_text_document", text, np.uint16)
        mod.write_dataset(p + "_role_document", role, np.int64)
        prefixes.append(p)
    return prefixes


@pytest.mark.parametrize("scalar_loss_mask", [0.0, 0.25])
def test_instruction_dataset_matches_jax(tmp_path, scalar_loss_mask):
    j, t = _instruction_both(tmp_path)
    want = jinst.build_instruction_datasets(j, "80,10,10", 24, 3,
                                            pad_token=5,
                                            scalar_loss_mask=scalar_loss_mask)
    got = tinst.build_instruction_datasets(t, "80,10,10", 24, 3,
                                           pad_token=5,
                                           scalar_loss_mask=scalar_loss_mask)
    assert int(tinst.Role.assistant) == int(jinst.Role.assistant) == 2
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for i in range(len(g)):
            a, b = g[i], w[i]
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_instruction_batches_through_batch_iterator_match_jax(tmp_path):
    """``BatchIterator`` was ported with mock text: on instruction samples
    (tokens / labels / loss_mask, no ``text``) both packages give the same
    batches, from a resumed position across an epoch's end."""
    j, t = _instruction_both(tmp_path, 40)
    want = jinst.build_instruction_datasets(j, "1", 16, 4,
                                            scalar_loss_mask=0.1)[0]
    got = tinst.build_instruction_datasets(t, "1", 16, 4,
                                           scalar_loss_mask=0.1)[0]
    kw = dict(global_batch_size=4, grad_accum=2, seq_length=16,
              consumed_samples=8, shuffle=True, seed=9, eod_token=0)
    # 10 batches an epoch: 15 from sample 8 cross into the next one
    jbatches = list(itertools.islice(
        jsamplers.BatchIterator(want, **kw), 15))
    tbatches = list(itertools.islice(
        tsamplers.BatchIterator(got, **kw), 15))
    assert len(tbatches) == len(jbatches) == 15
    for jb, tb in zip(jbatches, tbatches):
        assert jb.keys() == tb.keys() == {"tokens", "labels", "loss_mask"}
        for k in jb:
            assert tb[k].shape == (2, 2, 16)
            np.testing.assert_array_equal(tb[k], np.asarray(jb[k]))
