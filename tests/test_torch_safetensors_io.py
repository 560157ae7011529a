"""The port's safetensors reader and writer against the ``safetensors``
package: the same bytes on disk and the same tensors back, for every
dtype the port writes, empty and 0-d tensors, metadata and sharded
directories with their index."""

import json
import struct

import pytest
import torch
from safetensors import safe_open
from safetensors.torch import load_file as ref_load
from safetensors.torch import save_file as ref_save

from megatron_llm_tpu_torch import safetensors_io as sio

torch.set_num_threads(1)


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w.bf16": torch.randn(3, 5, generator=g).to(torch.bfloat16),
        "w.f16": torch.randn(7, generator=g).to(torch.float16),
        "w.f32": torch.randn(2, 3, 4, generator=g),
        "q.i8": torch.randint(-128, 128, (9,), dtype=torch.int8,
                              generator=g),
        "ids.i64": torch.randint(-2**40, 2**40, (5,), dtype=torch.int64,
                                 generator=g),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(3.5),
        "mask": torch.tensor([True, False, True]),
        "u8": torch.arange(6, dtype=torch.uint8),
        "i16": torch.arange(-2, 2, dtype=torch.int16),
        "i32": torch.arange(3, dtype=torch.int32),
        "f64": torch.randn(2, generator=g, dtype=torch.float64),
    }


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}],
                         ids=["no-metadata", "metadata"])
def test_writer_is_byte_identical_to_the_package(tmp_path, metadata):
    t = _tensors()
    ref_save(t, tmp_path / "ref.safetensors", metadata=metadata)
    sio.save_file(t, tmp_path / "port.safetensors", metadata=metadata)
    assert (tmp_path / "ref.safetensors").read_bytes() == \
        (tmp_path / "port.safetensors").read_bytes()


def test_metadata_of_several_keys(tmp_path):
    """The package orders several metadata keys by a hash map, so only the
    parsed header and the data bytes can match; they must."""
    t = _tensors(1)
    meta = {"format": "pt", "source": "test", "a": "1"}
    ref_save(t, tmp_path / "ref.safetensors", metadata=meta)
    sio.save_file(t, tmp_path / "port.safetensors", metadata=meta)
    ref, port = ((tmp_path / n).read_bytes()
                 for n in ("ref.safetensors", "port.safetensors"))
    (n_ref,), (n_port,) = struct.unpack("<Q", ref[:8]), \
        struct.unpack("<Q", port[:8])
    assert n_ref == n_port
    assert json.loads(ref[8:8 + n_ref]) == json.loads(port[8:8 + n_port])
    assert ref[8 + n_ref:] == port[8 + n_port:]
    assert sio.SafeFile(tmp_path / "ref.safetensors").metadata() == meta


@pytest.mark.parametrize("dtype", [None, torch.float32],
                         ids=["own-dtype", "cast-fp32"])
def test_reader_reads_the_package_files(tmp_path, dtype):
    t = _tensors(2)
    ref_save(t, tmp_path / "ref.safetensors")
    got = sio.load_file(tmp_path / "ref.safetensors", dtype=dtype)
    assert set(got) == set(t)
    for k, v in t.items():
        want = v if dtype is None else v.to(dtype)
        assert got[k].dtype == want.dtype and got[k].shape == want.shape
        assert torch.equal(got[k], want), k


def test_package_reads_the_port_files(tmp_path):
    t = _tensors(3)
    sio.save_file(t, tmp_path / "port.safetensors", {"format": "pt"})
    got = ref_load(tmp_path / "port.safetensors")
    for k, v in t.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    with safe_open(tmp_path / "port.safetensors", "pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_an_unaligned_leaf_reads_back(tmp_path):
    """A file whose bf16 data starts at an odd offset (the package never
    writes one, other writers may) is copied before reinterpretation."""
    t = {"a": torch.ones(3, dtype=torch.uint8),
         "b": torch.tensor([1.5, -2.0], dtype=torch.bfloat16)}
    header = {"a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "BF16", "shape": [2], "data_offsets": [3, 7]}}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    data = (t["a"].numpy().tobytes()
            + t["b"].view(torch.int16).numpy().tobytes())
    (tmp_path / "odd.safetensors").write_bytes(
        struct.pack("<Q", len(raw)) + raw + data)
    got = sio.load_file(tmp_path / "odd.safetensors")
    assert torch.equal(got["a"], t["a"]) and torch.equal(got["b"], t["b"])


def test_sharded_directory_and_index(tmp_path):
    """Shards of at most ``max_shard_bytes`` in insertion order, their
    index, and the lazy mapping over them; each shard is the package's
    bytes."""
    g = torch.Generator().manual_seed(4)
    t = {f"layer.{i}.w": torch.randn(16, 16, generator=g) for i in range(5)}
    names = sio.save_sharded(t, tmp_path, max_shard_bytes=2 * 16 * 16 * 4)
    assert names == [f"model-0000{i}-of-00003.safetensors"
                     for i in (1, 2, 3)]
    index = json.loads((tmp_path / sio.SAFE_INDEX).read_text())
    assert index["metadata"]["total_size"] == 5 * 16 * 16 * 4
    assert index["weight_map"] == {
        "layer.0.w": names[0], "layer.1.w": names[0],
        "layer.2.w": names[1], "layer.3.w": names[1],
        "layer.4.w": names[2]}
    for name in names:
        shard = {k: v for k, v in t.items()
                 if index["weight_map"][k] == name}
        ref_save(shard, tmp_path / "ref.safetensors",
                 metadata={"format": "pt"})
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / "ref.safetensors").read_bytes()
    lazy = sio.open_sharded(tmp_path)
    assert sorted(lazy) == sorted(t) and len(lazy) == 5
    for k, v in t.items():
        assert torch.equal(lazy[k], v)


def test_one_shard_is_a_single_file(tmp_path):
    t = _tensors(5)
    assert sio.save_sharded(t, tmp_path) == [sio.SAFE_WEIGHTS]
    assert not (tmp_path / sio.SAFE_INDEX).exists()
    got = sio.hf_state_dict(tmp_path)
    assert all(torch.equal(got[k], v) for k, v in t.items())


def test_hf_state_dict_reads_pytorch_model_bin(tmp_path):
    t = {k: v for k, v in _tensors(6).items() if v.numel()}
    torch.save(t, tmp_path / sio.BIN_WEIGHTS)
    got = sio.hf_state_dict(tmp_path)
    assert set(got) == set(t)
    assert all(torch.equal(got[k], v) for k, v in t.items())
    with pytest.raises(FileNotFoundError):
        sio.hf_state_dict(tmp_path / "nowhere")


class _Counted(dict):
    """A mapping that offers specs and counts the leaves asked for."""

    def __init__(self, tensors):
        super().__init__(tensors)
        self.asked = []

    def __getitem__(self, k):
        self.asked.append(k)
        return super().__getitem__(k)

    def spec(self, k):
        t = super().__getitem__(k)
        return torch.empty(t.shape, dtype=t.dtype, device="meta")


def test_a_lazy_mapping_is_written_a_leaf_at_a_time(tmp_path):
    """The writer plans files and headers from the specs and asks for each
    leaf once, when it is written; the files are the package's bytes, and
    a leaf that does not match its spec is refused."""
    g = torch.Generator().manual_seed(5)
    t = {f"layer.{i}.w": torch.randn(16, 16, generator=g) for i in range(5)}
    lazy = _Counted(t)
    names = sio.save_sharded(lazy, tmp_path, max_shard_bytes=2 * 16 * 16 * 4)
    assert sorted(lazy.asked) == sorted(t)
    index = json.loads((tmp_path / sio.SAFE_INDEX).read_text())
    for name in names:
        ref_save({k: v for k, v in t.items()
                  if index["weight_map"][k] == name},
                 tmp_path / "ref.safetensors", metadata={"format": "pt"})
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / "ref.safetensors").read_bytes()
    assert sio.nbytes(lazy) == 5 * 16 * 16 * 4
    bad = _Counted({"w": torch.ones(4)})
    bad.spec = lambda k: torch.empty(5, device="meta")
    with pytest.raises(ValueError, match="spec"):
        sio.save_file(bad, tmp_path / "bad.safetensors")
