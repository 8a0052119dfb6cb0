"""The port's pure-Python msgpack reader against flax's own restore."""

from pathlib import Path

import msgpack
import numpy as np
import pytest
from flax import serialization

from shm_tpu_torch.utils.checkpoint import (
    load_checkpoint, packb, save_checkpoint, unpackb,
)

ROOT = Path(__file__).resolve().parents[1]
CKPTS = ["data/4dof/models/temporal_vae.msgpack", "data/4dof/models/cnn.msgpack"]


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("rel", CKPTS)
def test_reader_matches_flax_bit_for_bit(rel):
    path = ROOT / rel
    ours = dict(_flatten(load_checkpoint(path)))
    ref = dict(_flatten(serialization.msgpack_restore(path.read_bytes())))
    assert ours.keys() == ref.keys()
    for key, want in ref.items():
        got = ours[key]
        want = np.asarray(want)
        assert isinstance(got, np.ndarray), key
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key


def test_cnn_checkpoint_holds_batch_stats():
    tree = load_checkpoint(ROOT / "data/4dof/models/cnn.msgpack")
    assert set(tree) == {"params", "batch_stats"}
    for bn in ("bn1", "bn2"):
        assert set(tree["batch_stats"][bn]) == {"mean", "var"}
        assert np.all(tree["batch_stats"][bn]["var"] > 0)


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 65535, 2**31, 2**40, -1, -32, -33,
    -200, -40000, -2**40, 1.5, -0.0, "", "a", "x" * 40, "é" * 200,
    "y" * 70000, b"", b"\x00\x01", b"z" * 300, b"w" * 70000,
    [], [1, 2, 3], list(range(20)), list(range(70000)),
    {}, {"a": 1}, {f"k{i}": i for i in range(20)}, {"n": {"m": [1, {"o": None}]}},
], ids=repr)
def test_unpackb_matches_msgpack(obj):
    assert unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_unpackb_float32():
    data = msgpack.packb(1.25, use_single_float=True)
    assert data[0] == 0xCA and unpackb(data) == 1.25


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "uint8", "bool", "float16"])
def test_ndarray_ext_roundtrip(rng, dtype):
    a = (rng.normal(size=(3, 5, 2)) * 10).astype(dtype)
    tree = {"w": a, "nested": {"s": a[0, 0, 0:1].reshape(())}}
    got = unpackb(serialization.msgpack_serialize(tree))
    assert got["w"].dtype == a.dtype and np.array_equal(got["w"], a)
    assert np.array_equal(got["nested"]["s"], a[0, 0, 0])


def test_truncated_and_trailing_data_raise():
    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        unpackb(data[:-1])
    with pytest.raises(ValueError, match="trailing"):
        unpackb(data + b"\x00")


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "nope.msgpack")


# --- the writer ---------------------------------------------------------------

@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, 255, 65535, 2**31, 2**40, -1, -32, -33,
    -200, -40000, -2**40, 1.5, -0.0, "", "a", "x" * 40, "y" * 70000,
    b"", b"\x00\x01", b"z" * 300, b"w" * 70000,
    [], [1, 2, 3], list(range(20)), list(range(70000)),
    {}, {"a": 1}, {f"k{i}": i for i in range(20)}, {"n": {"m": [1, {"o": None}]}},
], ids=repr)
def test_packb_matches_msgpack(obj):
    assert packb(obj) == msgpack.packb(obj, use_bin_type=True)


@pytest.mark.parametrize("rel", CKPTS)
def test_writer_reproduces_the_committed_files_byte_for_byte(rel, tmp_path):
    path = ROOT / rel
    save_checkpoint(load_checkpoint(path), tmp_path / "copy.msgpack")
    assert (tmp_path / "copy.msgpack").read_bytes() == path.read_bytes()


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8", "bool"])
def test_written_arrays_are_restored_by_flax(rng, dtype, tmp_path):
    a = (rng.normal(size=(3, 5, 2)) * 10).astype(dtype)
    tree = {"params": {"w": a, "deep": {"v": a[0].copy()}}}
    save_checkpoint(tree, tmp_path / "t.msgpack")
    got = serialization.msgpack_restore((tmp_path / "t.msgpack").read_bytes())
    assert got["params"]["w"].dtype == a.dtype
    assert np.array_equal(got["params"]["w"], a)
    assert np.array_equal(got["params"]["deep"]["v"], a[0])
    template = {"params": {"w": np.zeros_like(a), "deep": {"v": np.zeros_like(a[0])}}}
    back = serialization.from_bytes(template, (tmp_path / "t.msgpack").read_bytes())
    assert np.array_equal(back["params"]["w"], a)


def test_packb_refuses_what_it_cannot_encode():
    with pytest.raises(TypeError, match="cannot pack"):
        packb({"a": object()})
    with pytest.raises(ValueError, match="object arrays"):
        packb(np.array([object()]))
