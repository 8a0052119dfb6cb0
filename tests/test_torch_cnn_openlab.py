"""The port's ``CNNOpenLab`` (``models/cnn.py``) and its converter
(``convert.cnn_openlab_*``) against flax's ``shm_tpu.models.CNNOpenLab``, on
the CPU.

- Random flax variables (GroupNorm scale and bias drawn away from (1, 0))
  and seeded inputs: eval-mode logits within atol 1e-5 of both of the JAX
  model's ``conv_impl``s (``im2col`` and ``lax``, one parameter tree).
- The committed checkpoints of ``data/openlab`` and
  ``data/openlab_attention`` load, and score committed raw windows within
  the same 1e-5.
- The converter both ways, bit for bit; the port's msgpack loads in the
  JAX package to the same arrays.
- Training mode: fc1's dropout mask carried across from flax, logits within
  1e-5; the fresh init's truncated kaiming-normal scale.
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.models import CNNOpenLab as JaxCNNOpenLab
from shm_tpu.utils.checkpoint import load_params
from shm_tpu_torch.convert import (
    cnn_openlab_from_flax, cnn_openlab_state_dict, cnn_openlab_to_flax,
)
from shm_tpu_torch.models.cnn import CNNOpenLab
from shm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
X_SHAPE = (200, 4, 1)
CKPT = "output/CNN_Training/artifacts/cnn_model_openlab.msgpack"


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _random_variables(seed):
    rng = np.random.default_rng(seed)
    v = _np_tree(JaxCNNOpenLab().init({"params": jax.random.PRNGKey(seed)},
                                      jnp.zeros((2,) + X_SHAPE)))
    for name, leaves in v["params"].items():
        if name.endswith("_gn"):
            c = leaves["scale"].shape
            leaves["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            leaves["bias"] = rng.uniform(-0.3, 0.3, c).astype(np.float32)
        elif "bias" in leaves:
            leaves["bias"] = rng.uniform(-0.1, 0.1, leaves["bias"].shape
                                         ).astype(np.float32)
    return v


@pytest.mark.parametrize("conv_impl", ["im2col", "lax"])
@pytest.mark.parametrize("seed", [0, 1])
def test_eval_logits_match_flax(seed, conv_impl):
    v = _random_variables(seed)
    x = np.random.default_rng(10 + seed).normal(size=(6,) + X_SHAPE).astype(np.float32)
    want = JaxCNNOpenLab(conv_impl=conv_impl).apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = cnn_openlab_from_flax(v)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("root", ["data/openlab", "data/openlab_attention"])
def test_committed_checkpoints_load_and_score(root):
    v = load_checkpoint(ROOT / root / CKPT)
    assert set(v) == {"params", "batch_stats"} and v["batch_stats"] == {}
    mu, sd = np.load(ROOT / root / "output/CNN_Training/artifacts/cnn_raw_mu_sd.npy")
    Xr = np.load(ROOT / "data/openlab/extracted/X_raw.npy", mmap_mode="r")
    idx = np.linspace(0, len(Xr) - 1, 8).astype(int)
    x = np.nan_to_num(np.clip((Xr[idx] - mu) / sd, -10, 10), nan=0.0,
                      posinf=0.0, neginf=0.0).astype(np.float32)[..., None]
    jv = load_params(JaxCNNOpenLab().init({"params": jax.random.PRNGKey(0)},
                                          jnp.zeros((2,) + X_SHAPE)),
                     ROOT / root / CKPT)
    want = JaxCNNOpenLab().apply(jv, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = cnn_openlab_from_flax(v)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("source", ["random", "committed"])
def test_converter_round_trip_bit_for_bit(source, tmp_path):
    v = (_random_variables(3) if source == "random"
         else load_checkpoint(ROOT / "data/openlab" / CKPT))
    cnn = cnn_openlab_from_flax(v)
    back = cnn_openlab_to_flax(cnn)
    assert back["batch_stats"] == {}
    for layer, leaves in v["params"].items():
        for name, a in leaves.items():
            b = back["params"][layer][name]
            assert b.dtype == np.float32 and np.array_equal(a, b), f"{layer}.{name}"
    sd = cnn_openlab_state_dict(back)
    assert all(torch.equal(sd[k], t) for k, t in cnn.state_dict().items())
    # the port's checkpoint loads in the JAX package to the same arrays
    save_checkpoint(back, tmp_path / "cnn.msgpack")
    template = JaxCNNOpenLab().init({"params": jax.random.PRNGKey(1)},
                                    jnp.zeros((2,) + X_SHAPE))
    jv = _np_tree(load_params(template, tmp_path / "cnn.msgpack"))
    for layer, leaves in v["params"].items():
        for name, a in leaves.items():
            assert np.array_equal(jv["params"][layer][name], a)


def test_training_mode_dropout_matches_flax():
    """fc1's keep mask that flax draws, carried across: the same logits;
    eval mode ignores a mask."""
    v = _random_variables(4)
    x = np.random.default_rng(5).normal(size=(8,) + X_SHAPE).astype(np.float32)
    jmodel = JaxCNNOpenLab()
    key = jax.random.PRNGKey(9)
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        # the Dropout call on ones draws the mask the real call draws
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            masks.append(np.asarray(next_fun(jnp.ones_like(args[0]), *args[1:],
                                             **kwargs)) != 0)
            return args[0]
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        jmodel.apply(v, jnp.asarray(x), train=True, rngs={"dropout": key})
    want = jmodel.apply(v, jnp.asarray(x), train=True, rngs={"dropout": key})
    [mask] = masks
    assert mask.shape == (8, 128) and 0.4 < mask.mean() < 0.8
    cnn = cnn_openlab_from_flax(v).train()
    with torch.no_grad():
        got = cnn(torch.from_numpy(x), dropout_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        cnn.eval()
        assert torch.equal(cnn(torch.from_numpy(x)),
                           cnn(torch.from_numpy(x), dropout_mask=torch.from_numpy(~mask)))


def test_init_parameters_are_truncated_kaiming_normal():
    cnn = CNNOpenLab()
    cnn.init_parameters(torch.Generator().manual_seed(0))
    w = cnn.b4_conv.weight.detach()
    fan_in = w[0].numel()
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    # a normal truncated at 2 sd keeps 0.7737 of 1 / 0.87962566^2 variance
    assert abs(float(w.std()) / (2.0 / fan_in) ** 0.5 - 1.0) < 0.02
    assert all(float(getattr(cnn, f"b{i}_conv").bias.detach().abs().max()) == 0.0
               for i in range(1, 5))
    assert torch.equal(cnn.b1_gn.weight, torch.ones(32))
    other = CNNOpenLab()
    other.init_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(cnn.state_dict().values(),
                                                 other.state_dict().values()))
