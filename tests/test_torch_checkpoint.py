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
CKPTS = [f"data/{root}/models/{name}.msgpack"
         for root in ("4dof", "4dof_mingru", "4dof_attention")
         for name in ("temporal_vae", "cnn")]
VAE_ROOTS = {"lstm": "data/4dof", "min_gru": "data/4dof_mingru",
             "attention": "data/4dof_attention"}


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


# --- the VAE trees of the three cell families -----------------------------------

@pytest.mark.parametrize("cell", list(VAE_ROOTS))
def test_vae_tree_survives_the_port_bit_for_bit(cell):
    """``vae_to_flax(vae_from_flax(p)) == p`` on the committed checkpoint of
    each family: the transposes and head reshapes are undone exactly."""
    from shm_tpu_torch.config import Stage4DofConfig, replace
    from shm_tpu_torch.convert import tree_cell, vae_from_flax, vae_to_flax

    tree = load_checkpoint(ROOT / VAE_ROOTS[cell] / "models/temporal_vae.msgpack")["params"]
    assert tree_cell(tree) == cell
    vae = vae_from_flax(tree, replace(Stage4DofConfig().vae, cell=cell))
    back = dict(_flatten(vae_to_flax(vae)))
    want = dict(_flatten(tree))
    assert back.keys() == want.keys()
    for key, a in want.items():
        b = back[key]
        assert b.dtype == np.float32 and b.flags["C_CONTIGUOUS"], key
        assert b.shape == a.shape and b.tobytes() == np.asarray(a).tobytes(), key
    # and from the state dict alone, as the trainer saves it
    again = dict(_flatten(vae_to_flax(vae.state_dict())))
    assert all(np.array_equal(again[k], back[k]) for k in back)


@pytest.mark.parametrize("cell, shapes", [
    ("min_gru", {("encoder_lstm", "layer0", "w_ih"): (12, 256),
                 ("decoder_lstm", "layer1", "b_ih"): (256,)}),
    ("attention", {("encoder_lstm", "layer0", "attn", "query", "kernel"): (128, 4, 32),
                   ("encoder_lstm", "layer0", "attn", "query", "bias"): (4, 32),
                   ("decoder_lstm", "layer1", "attn", "out", "kernel"): (4, 32, 128),
                   ("decoder_lstm", "layer0", "mlp_in", "kernel"): (128, 512),
                   ("decoder_lstm", "layer0", "mlp_out", "kernel"): (512, 128),
                   ("encoder_lstm", "in_proj", "kernel"): (12, 128),
                   ("decoder_lstm", "final_norm", "scale"): (128,)}),
])
def test_committed_vae_trees_have_the_flax_shapes(cell, shapes):
    tree = load_checkpoint(ROOT / VAE_ROOTS[cell] / "models/temporal_vae.msgpack")["params"]
    flat = dict(_flatten(tree))
    for key, shape in shapes.items():
        assert flat[key].shape == shape and flat[key].dtype == np.float32


@pytest.mark.parametrize("cell", list(VAE_ROOTS))
def test_random_tree_has_the_committed_trees_structure(cell):
    from shm_tpu_torch.config import Stage4DofConfig, replace
    from shm_tpu_torch.convert import random_flax_vae_params

    cfg = replace(Stage4DofConfig().vae, cell=cell)
    made = dict(_flatten(random_flax_vae_params(np.random.default_rng(0), cfg)))
    tree = load_checkpoint(ROOT / VAE_ROOTS[cell] / "models/temporal_vae.msgpack")["params"]
    want = dict(_flatten(tree))
    assert made.keys() == want.keys()
    assert all(made[k].shape == want[k].shape and made[k].dtype == np.float32
               for k in want)


def test_tree_of_another_family_is_refused():
    from shm_tpu_torch.config import VAEConfig
    from shm_tpu_torch.convert import (
        random_flax_vae_params, vae_from_flax, vae_state_dict,
    )

    rng = np.random.default_rng(0)
    small = dict(input_dim=5, latent_dim=4, hidden_dim=32, num_layers=1)
    trees = {c: random_flax_vae_params(rng, VAEConfig(cell=c, **small))
             for c in VAE_ROOTS}
    for have, tree in trees.items():
        for asked in VAE_ROOTS:
            if asked == have:
                vae_from_flax(tree, VAEConfig(cell=asked, **small))
                continue
            with pytest.raises(ValueError, match=f"holds a {have!r} VAE, not "
                                                 f"the {asked!r}"):
                vae_state_dict(tree, 1, True, asked)
    with pytest.raises(ValueError, match="unknown cell 'gru'"):
        random_flax_vae_params(rng, VAEConfig(cell="gru", **small))
