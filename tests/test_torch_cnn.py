"""The port's CNN4DOF on the trained checkpoint against flax's CNN4DOF.

The JAX model flattens NHWC (25, 3, 32) into fc1 while the port flattens
NCHW (32, 25, 3), so fc1's rows are permuted once at load; a wrong
permutation moves the logits by far more than the tolerance (atol 1e-4:
both sides run float32, with convolutions summed in different orders).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.utils.checkpoint import load_params
from shm_tpu_torch.convert import cnn4dof_from_flax, cnn4dof_state_dict
from shm_tpu_torch.models.cnn import stack_vae_residual_nhwc
from shm_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "data/4dof/models/cnn.msgpack"

# pytest-xdist runs several test files at once on the same cores; torch's
# default of one thread per core makes those workers spin against each other.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jcnn = JaxCNN4DOF(conv_impl="im2col")
    template = jcnn.init({"params": jax.random.PRNGKey(0)},
                         jnp.zeros((2, 100, 12, 2)))
    jvars = load_params(template, CKPT)
    return jcnn, jvars, cnn4dof_from_flax(load_checkpoint(CKPT))


def _logits(models, x):
    jcnn, jvars, cnn = models
    want = np.asarray(jcnn.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = cnn(torch.from_numpy(x)).numpy()
    return got, want


def test_trained_cnn_matches_flax(models):
    x = np.random.default_rng(0).normal(size=(64, 100, 12, 2)).astype(np.float32)
    got, want = _logits(models, x)
    assert got.shape == (64, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_trained_cnn_matches_flax_on_vae_shaped_input(models):
    """Inputs shaped like the pipeline's: [Z, squared residual >= 0]."""
    rng = np.random.default_rng(1)
    Z = rng.normal(size=(32, 100, 12)).astype(np.float32)
    recon = (Z + rng.normal(scale=0.3, size=Z.shape)).astype(np.float32)
    x = stack_vae_residual_nhwc(torch.from_numpy(Z), torch.from_numpy(recon))
    assert x.shape == (32, 100, 12, 2)
    np.testing.assert_allclose(x[..., 1].numpy(), (Z - recon) ** 2, rtol=1e-6)
    got, want = _logits(models, x.numpy())
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fc1_permutation_is_needed(models):
    """Loading fc1 without the NHWC -> NCHW row permutation disagrees."""
    _, _, cnn = models
    variables = load_checkpoint(CKPT)
    sd = cnn4dof_state_dict(variables)
    unpermuted = torch.from_numpy(
        np.ascontiguousarray(variables["params"]["fc1"]["kernel"].T))
    assert not torch.equal(sd["fc1.weight"], unpermuted)
    # the permutation only reorders fc1's input columns
    assert torch.equal(sd["fc1.weight"].sort(dim=1).values,
                       unpermuted.sort(dim=1).values)


def test_conv_and_batchnorm_layouts():
    variables = load_checkpoint(CKPT)
    sd = cnn4dof_state_dict(variables)
    k = variables["params"]["conv2"]["kernel"]                    # HWIO
    assert sd["conv2.weight"].shape == (k.shape[3], k.shape[2], 3, 3)
    np.testing.assert_array_equal(sd["conv2.weight"][5, 3].numpy(), k[:, :, 3, 5])
    np.testing.assert_array_equal(sd["bn1.running_var"].numpy(),
                                  variables["batch_stats"]["bn1"]["var"])
