"""The port's VAE gate (plain version on the CPU) against the JAX package.

Inputs and weights are made with numpy from a seed and handed to both
sides. The JAX side is the Pallas kernel run in interpret mode in float32,
as ``tests/test_ops.py`` runs it, and the flax ``TemporalVAE``. Tolerances
are those of ``tests/test_ops.py``: mse atol 2e-6, resid atol 5e-6 (both
sides compute in float32; they differ in summation order and in the
sigmoid's form, which the Pallas kernel evaluates through tanh).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu.ops import fused_vae_gate as jax_fused_vae_gate
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import (
    fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
)
from shm_tpu_torch.ops import fused_vae as fused_vae_mod

MSE_ATOL, RESID_ATOL = 2e-6, 5e-6
N, T = 37, 16                      # ragged against every tile size

# pytest-xdist runs several test files at once on the same cores; torch's
# default of one thread per core makes those workers spin against each other.
torch.set_num_threads(1)

CASES = {  # name: (D, Z, H, L, layernorm, with_residual)
    "L2_H32_ln": (12, 16, 32, 2, True, True),
    "L1_H64_ln": (3, 8, 64, 1, True, True),
    "L2_H32_noln": (12, 5, 32, 2, False, True),
    "L2_H32_ln_gate_only": (12, 16, 32, 2, True, False),
}


def _setup(seed, D, Zd, H, L, ln):
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln)
    rng = np.random.default_rng(seed)
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(N, T, D)).astype(np.float32)
    return cfg, params, Z


@pytest.mark.parametrize("name", list(CASES))
def test_gate_matches_jax_pallas_interpret(name):
    D, Zd, H, L, ln, wr = CASES[name]
    cfg, params, Z = _setup(sum(map(ord, name)), D, Zd, H, L, ln)
    mse_j, resid_j = jax_fused_vae_gate(
        params, jnp.asarray(Z), num_layers=L, use_layernorm=ln,
        dtype=jnp.float32, interpret=True, batch_tile=32, with_residual=wr)

    w = vae_params_to_kernel_weights(vae_from_flax(params, cfg))
    before = fused_vae_gate.launches
    mse, resid = fused_vae_gate(w, torch.from_numpy(Z), num_layers=L,
                                use_layernorm=ln, with_residual=wr)
    assert fused_vae_gate.launches == before     # the CPU never launches
    assert mse.shape == (N,) and mse.dtype == torch.float32
    np.testing.assert_allclose(mse.numpy(), np.asarray(mse_j), atol=MSE_ATOL)
    if wr:
        assert resid.shape == (N, T, D)
        np.testing.assert_allclose(resid.numpy(), np.asarray(resid_j),
                                   atol=RESID_ATOL)
    else:
        assert resid is None and resid_j is None


@pytest.mark.parametrize("name", ["L2_H32_ln", "L1_H64_ln", "L2_H32_noln"])
def test_temporal_vae_matches_flax(name):
    D, Zd, H, L, ln, _ = CASES[name]
    cfg, params, Z = _setup(7 + len(name), D, Zd, H, L, ln)
    jcfg = JaxVAEConfig(D, Zd, H, L, 0.3, use_layernorm=ln)
    recon_j, mu_j, logvar_j = jax_vae_from_config(jcfg).apply(
        {"params": params}, jnp.asarray(Z), sample=False)

    vae = vae_from_flax(params, cfg)
    with torch.no_grad():
        recon, mu, logvar = vae(torch.from_numpy(Z))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=2e-6)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), atol=2e-6)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=2e-6)


def test_gate_reference_matches_module_path():
    """The kernel's plain version computes what the modules compute; the two
    add the biases at another point of the sum, so they agree to a few
    float32 ulps (atol 2e-6 and 1e-6 relative)."""
    D, Zd, H, L, ln, _ = CASES["L2_H32_ln"]
    cfg, params, Z = _setup(3, D, Zd, H, L, ln)
    vae = vae_from_flax(params, cfg)
    Zt = torch.from_numpy(Z)
    with torch.no_grad():
        recon, _, _ = vae(Zt)
    mse, resid = fused_vae_gate_reference(vae_params_to_kernel_weights(vae), Zt,
                                          num_layers=L, use_layernorm=ln)
    torch.testing.assert_close(resid, (Zt - recon) ** 2, atol=2e-6, rtol=1e-6)
    torch.testing.assert_close(mse, ((Zt - recon) ** 2).mean(dim=(1, 2)),
                               atol=2e-6, rtol=1e-6)


def test_empty_batch():
    D, Zd, H, L, ln, _ = CASES["L2_H32_ln"]
    cfg, params, _ = _setup(4, D, Zd, H, L, ln)
    w = vae_params_to_kernel_weights(vae_from_flax(params, cfg))
    mse, resid = fused_vae_gate(w, torch.zeros(0, T, D), num_layers=L,
                                use_layernorm=ln)
    assert mse.shape == (0,) and resid.shape == (0, T, D)


def test_kernel_weights_layout():
    D, Zd, H, L, ln, _ = CASES["L2_H32_ln"]
    cfg, params, _ = _setup(5, D, Zd, H, L, ln)
    w = vae_params_to_kernel_weights(vae_from_flax(params, cfg))
    p0 = params["encoder_lstm"]["layer0"]
    np.testing.assert_array_equal(w["enc0_wih"].numpy(), p0["w_ih"])
    np.testing.assert_array_equal(w["enc0_whh"].numpy(), p0["w_hh"])
    np.testing.assert_allclose(w["enc0_b"].numpy(), p0["b_ih"] + p0["b_hh"])
    np.testing.assert_array_equal(w["out_w"].numpy(),
                                  params["output_layer"]["kernel"])
    assert all(t.is_contiguous() and t.dtype == torch.float32
               for t in w.values())
    assert set(w) == {k for k in fused_vae_mod._WEIGHT_ORDER}


@pytest.mark.parametrize("bad, match", [
    (dict(num_layers=3), "1- or 2-layer"),
    (dict(H=48), "unsupported shape"),
    (dict(D=17), "unsupported shape"),
    (dict(dtype=torch.float64), "float32"),
])
def test_kernel_argument_checks(bad, match):
    """The checks the CUDA wrapper makes before a launch (run on the CPU)."""
    D, H = bad.get("D", 12), bad.get("H", 32)
    cfg = VAEConfig(input_dim=D, latent_dim=4, hidden_dim=H, num_layers=2)
    w = vae_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg), cfg))
    Z = torch.zeros(2, 5, D, dtype=bad.get("dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        fused_vae_mod._check(w, Z, bad.get("num_layers", 2), True)


def test_unsupported_device_raises():
    w = {}
    with pytest.raises(ValueError, match="unsupported device"):
        fused_vae_gate(w, torch.zeros(1, 2, 3, device="meta"), num_layers=1,
                       use_layernorm=False)
