"""The transposed layout of the hybrid (``make_hybrid_fn(fused_layout=
"transposed")``) and its CNN (``cnn4dof_apply_transposed``) against the JAX
package, on the CPU.

The CNN is data/4dof's trained CNN4DOF (its running statistics included),
carried over by ``convert.cnn4dof_from_flax``; the VAE an LSTM VAE at the
4DOF window shape (T=100, D=12) but H=32, weights made with numpy from a
seed (``convert.random_flax_vae_params``). Bars:

- ``cnn4dof_apply_transposed`` against the JAX function: logits atol 1e-4
  in float32 (``tests/test_torch_cnn.py``'s bar: both float32, the products
  summed in other orders); in bf16 the predicted class equal;
- the hybrid against the JAX hybrid in the same layout (``fused_interpret=
  True``, float32): ``tests/test_ops.py:85-117``'s bars, mse atol 1e-6,
  gate and ``y_pred`` equal, logits atol 1e-4. The JAX fused gate runs its
  default tanh-form sigmoid, the port its default logistic (float32
  rounding apart);
- the port's two layouts: mse bit for bit (the residual is the NHWC one
  permuted), gates and ``y_pred`` equal, logits atol 1e-4;
- ``make_dp_hybrid_shardmap`` on two CPU shards against one device: mse
  within 1e-6 (``tests/test_torch_parallel.py``), gates and ``y_pred``
  equal.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu.models.cnn import cnn4dof_apply_transposed as jax_apply_transposed
from shm_tpu.pipeline import make_hybrid_fn as jax_make_hybrid_fn
from shm_tpu.utils.checkpoint import load_params
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import (cnn4dof_from_flax, random_flax_vae_params,
                                   vae_from_flax)
from shm_tpu_torch.models.cnn import cnn4dof_apply_transposed
from shm_tpu_torch.ops import fused_vae_gate
from shm_tpu_torch.parallel import make_dp_hybrid_shardmap, make_mesh
from shm_tpu_torch.pipeline import make_hybrid_fn
from shm_tpu_torch.utils.checkpoint import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "data/4dof/models/cnn.msgpack"
N, T, D = 24, 100, 12
LOGIT_ATOL, MSE_ATOL, MESH_MSE_ATOL = 1e-4, 1e-6, 1e-6
torch.set_num_threads(1)


@functools.cache
def _cnns():
    jcnn = JaxCNN4DOF(conv_impl="im2col")
    template = jcnn.init({"params": jax.random.PRNGKey(0)},
                         jnp.zeros((2, T, D, 2)))
    return jcnn, load_params(template, CKPT), cnn4dof_from_flax(load_checkpoint(CKPT))


@functools.cache
def _vaes():
    cfg = VAEConfig(input_dim=D, latent_dim=16, hidden_dim=32, num_layers=2,
                    use_layernorm=True)
    rng = np.random.default_rng(2024)
    params = random_flax_vae_params(rng, cfg)
    jvae = jax_vae_from_config(JaxVAEConfig(D, 16, 32, 2, 0.0,
                                            use_layernorm=True))
    W = rng.normal(size=(N, T, D)).astype(np.float32)
    return jvae, params, vae_from_flax(params, cfg), W


def _cnn_inputs(seed: int):
    """[T, Dp, N] windows and squared residuals shaped like the pipeline's."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(N, T, D)).astype(np.float32)
    R = (rng.normal(scale=0.3, size=Z.shape) ** 2).astype(np.float32)
    pad = lambda a: np.ascontiguousarray(
        np.pad(a, ((0, 0), (0, 0), (0, 16 - D))).transpose(1, 2, 0))
    return pad(Z), pad(R)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transposed_cnn_matches_jax(dtype):
    jcnn, jvars, cnn = _cnns()
    Zt, Rt = _cnn_inputs(7)
    want = np.asarray(jax_apply_transposed(jvars, jnp.asarray(Zt), jnp.asarray(Rt),
                                           d_real=D, dtype=getattr(jnp, dtype)))
    got = cnn4dof_apply_transposed(cnn, torch.from_numpy(Zt), torch.from_numpy(Rt),
                                   d_real=D, dtype=getattr(torch, dtype))
    assert got.shape == (N, 2) and got.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_ATOL)
        # and against the port's NHWC CNN4DOF on the same inputs
        x = torch.stack([torch.from_numpy(Zt[:, :D]).permute(2, 0, 1),
                         torch.from_numpy(Rt[:, :D]).permute(2, 0, 1)], dim=-1)
        with torch.no_grad():
            np.testing.assert_allclose(got.numpy(), cnn(x).numpy(),
                                       atol=LOGIT_ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(1), want.argmax(1))


def test_transposed_cnn_refuses_training_mode_and_other_dtypes():
    _, _, cnn = _cnns()
    Zt, Rt = (torch.from_numpy(a) for a in _cnn_inputs(7))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cnn4dof_apply_transposed(cnn, Zt, Rt, dtype=torch.float16)
    cnn.train()
    try:
        with pytest.raises(ValueError, match="eval"):
            cnn4dof_apply_transposed(cnn, Zt, Rt)
    finally:
        cnn.eval()


def _jax_hybrid(layout: str):
    jvae, params, _, W = _vaes()
    jcnn, jvars, _ = _cnns()
    fn = jax_make_hybrid_fn(jvae, jcnn, use_fused_vae=True,
                            fused_dtype=jnp.float32, fused_interpret=True,
                            fused_batch_tile=32, fused_layout=layout)
    return fn(params, jvars, jnp.asarray(W), jnp.zeros(D), jnp.ones(D),
              jnp.float32(_threshold()))


@functools.cache
def _threshold() -> float:
    """Midway between the two middle mse of the port's NHWC hybrid: half the
    windows on each side of the gate."""
    m = np.sort(_port_hybrid("nhwc").mse.numpy())
    return float(0.5 * (m[N // 2 - 1] + m[N // 2]))


def _port_hybrid(layout: str, thr=None):
    _, _, vae, W = _vaes()
    _, _, cnn = _cnns()
    fn = make_hybrid_fn(vae, cnn, use_fused_vae=True, fused_layout=layout)
    thr = 0.0 if thr is None else thr
    return fn(torch.from_numpy(W), torch.zeros(D), torch.ones(D),
              torch.tensor(thr, dtype=torch.float32))


def test_transposed_hybrid_matches_jax():
    thr = _threshold()
    ref = _jax_hybrid("transposed")
    got = _port_hybrid("transposed", thr)
    np.testing.assert_allclose(got.mse.numpy(), np.asarray(ref.mse), atol=MSE_ATOL)
    np.testing.assert_array_equal(got.anomalous.numpy(), np.asarray(ref.anomalous))
    assert 0 < int(got.anomalous.sum()) < N
    np.testing.assert_array_equal(got.y_pred.numpy(), np.asarray(ref.y_pred))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits),
                               atol=LOGIT_ATOL)


def test_transposed_hybrid_matches_the_nhwc_hybrid():
    thr = _threshold()
    ref = _port_hybrid("nhwc", thr)
    before = fused_vae_gate.transposed_launches
    got = _port_hybrid("transposed", thr)
    assert fused_vae_gate.transposed_launches == before   # the CPU never launches
    assert torch.equal(got.mse, ref.mse)
    assert torch.equal(got.anomalous, ref.anomalous)
    assert torch.equal(got.y_pred, ref.y_pred)
    np.testing.assert_allclose(got.logits.numpy(), ref.logits.numpy(),
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got.p_struct.numpy(), ref.p_struct.numpy(),
                               atol=LOGIT_ATOL)


def test_transposed_hybrid_raises_as_jax():
    _, _, vae, _ = _vaes()
    _, _, cnn = _cnns()
    with pytest.raises(ValueError, match="unknown fused_layout"):
        make_hybrid_fn(vae, cnn, use_fused_vae=True, fused_layout="nchw")
    with pytest.raises(ValueError, match="requires use_fused_vae=True"):
        make_hybrid_fn(vae, cnn, fused_layout="transposed")
    cfg = VAEConfig(input_dim=D, latent_dim=4, hidden_dim=32, num_layers=2,
                    cell="min_gru")
    mingru = vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg),
                           cfg)
    with pytest.raises(ValueError, match="LSTM-kernel only"):
        make_hybrid_fn(mingru, cnn, use_fused_vae=True, fused_layout="transposed")
    with pytest.raises(ValueError, match="deterministic"):
        make_hybrid_fn(vae, cnn, use_fused_vae=True, sample=True,
                       fused_layout="transposed")


def test_transposed_hybrid_on_two_cpu_shards():
    _, _, vae, W = _vaes()
    _, _, cnn = _cnns()
    thr = torch.tensor(_threshold(), dtype=torch.float32)
    fn = make_dp_hybrid_shardmap(vae, cnn, make_mesh(2, device="cpu"),
                                 use_fused_vae=True, fused_layout="transposed")
    got = fn(torch.from_numpy(W), torch.zeros(D), torch.ones(D), thr)
    one = _port_hybrid("transposed", float(thr))
    np.testing.assert_allclose(got.mse.numpy(), one.mse.numpy(),
                               atol=MESH_MSE_ATOL)
    assert torch.equal(got.anomalous, one.anomalous)
    assert torch.equal(got.y_pred, one.y_pred)
