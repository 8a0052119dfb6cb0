"""Shared helpers of the tests that hold the port's serving surface
(``tests/test_torch_serve_*.py``) against the JAX package's.

The models are those of ``tests/test_serve*.py``: a 2-layer LSTM VAE with
LayerNorm (D=4, Z=3, H=16) and CNN4DOF at T=20, initialised by flax from
``PRNGKey(0)`` and carried into the port by ``shm_tpu_torch/convert.py``.
The JAX scorer runs the plain XLA path (``use_fused_vae=False``) with a
float32 CNN; the port's runs its plain path on the CPU. Both score in
float32, so per-window mse agrees within ``MSE_ATOL`` (the parity
standard), p_struct within ``P_ATOL``, and decisions exactly.
"""

from __future__ import annotations

import functools
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import torch

from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.models import vae_from_config
from shm_tpu.serve import HybridScorer as JaxHybridScorer
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import cnn4dof_from_flax, vae_from_flax
from shm_tpu_torch.serve import HybridScorer

T, D = 20, 4
MSE_ATOL = 2e-6
P_ATOL = 1e-5
KEYS = ("mse", "anomalous", "y_pred", "p_struct")


@functools.cache
def flax_models():
    """``(vae, cnn, vae_params, cnn_variables)`` of the JAX tests' recipe."""
    vae = vae_from_config(JaxVAEConfig(D, 3, 16, 2, 0.0, use_layernorm=True))
    cnn = JaxCNN4DOF(dropout=0.0)
    key = jax.random.PRNGKey(0)
    vp = vae.init({"params": key}, jnp.zeros((2, T, D)))["params"]
    cv = cnn.init({"params": key}, jnp.zeros((2, T, D, 2)))
    return vae, cnn, vp, cv


def jax_scorer(threshold: float = 1.0, rate=None, **kw):
    vae, cnn, vp, cv = flax_models()
    kw = {"min_bucket": 16, "max_batch": 32, "seq_len": T, **kw}
    sc = JaxHybridScorer(vae, cnn, vp, cv, np.zeros(D, np.float32),
                         np.ones(D, np.float32), threshold,
                         use_fused_vae=False, **kw)
    sc.expected_anomaly_rate = rate
    return sc


def port_scorer(threshold: float = 1.0, rate=None, **kw):
    """The port's scorer on the CPU with the flax weights carried over."""
    _, _, vp, cv = flax_models()
    cfg = VAEConfig(input_dim=D, latent_dim=3, hidden_dim=16, num_layers=2,
                    dropout=0.0, use_layernorm=True)
    kw = {"min_bucket": 16, "max_batch": 32, "seq_len": T, **kw}
    sc = HybridScorer(vae_from_flax(vp, cfg), cnn4dof_from_flax(cv, 2, T, D),
                      np.zeros(D, np.float32), np.ones(D, np.float32),
                      threshold, device="cpu", **kw)
    sc.expected_anomaly_rate = rate
    return sc


def assert_close_outputs(got, ref, mse_atol: float = MSE_ATOL,
                         p_atol: float = P_ATOL) -> None:
    """mse within ``mse_atol``, p_struct within ``p_atol``, decisions exact."""
    for k in ("anomalous", "y_pred"):
        np.testing.assert_array_equal(np.asarray(got[k]).astype(np.int64),
                                      np.asarray(ref[k]).astype(np.int64),
                                      err_msg=k)
    np.testing.assert_allclose(np.asarray(got["mse"], np.float64),
                               np.asarray(ref["mse"], np.float64),
                               rtol=0, atol=mse_atol, err_msg="mse")
    np.testing.assert_allclose(np.asarray(got["p_struct"], np.float64),
                               np.asarray(ref["p_struct"], np.float64),
                               rtol=0, atol=p_atol, err_msg="p_struct")


def windows(n: int, seed: int = 0, t: int = T, d: int = D) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, t, d)).astype(np.float32)


def req(url, data=None, headers=None, method=None):
    """``(status, content type, body)``; HTTP errors raise."""
    r = urllib.request.Request(url, data=data, headers=headers or {},
                               method=method)
    with urllib.request.urlopen(r, timeout=60) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def err_code(url, **kw) -> int:
    """The status of a request that must fail."""
    try:
        req(url, **kw)
    except urllib.error.HTTPError as e:
        e.read()
        return e.code
    raise AssertionError(f"{url}: expected an HTTP error")


def metrics(base: str) -> dict:
    return json.loads(req(base + "/metrics",
                          headers={"Accept": "application/json"})[2])


def octet(W: np.ndarray, **extra) -> dict:
    return {"Content-Type": "application/octet-stream",
            "X-Shape": ",".join(map(str, W.shape)), **extra}


def wait_for(pred, timeout: float = 30.0, msg: str = "condition") -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


# pytest-xdist runs several test files at once on the same cores
torch.set_num_threads(1)
