"""The port's minGRU gate (plain version on the CPU) against the JAX package.

Inputs and weights are made with numpy from a seed and handed to both sides.
The JAX side is the Pallas kernel run in interpret mode in float32 with the
exact sigmoid, as ``tests/test_minrnn.py`` runs it. Tolerances are that
file's: mse atol 2e-6, resid atol 5e-6 (both sides compute in float32; they
differ in the order of sums inside the projections).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.ops import fused_mingru_gate as jax_fused_mingru_gate
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import (
    fused_mingru_gate, fused_mingru_gate_reference,
    mingru_params_to_kernel_weights,
)
from shm_tpu_torch.ops import fused_mingru as fused_mingru_mod
from shm_tpu_torch.train import reconstruction_mse, train_vae

MSE_ATOL, RESID_ATOL = 2e-6, 5e-6
torch.set_num_threads(1)      # see tests/test_torch_vae_gate.py

CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual)
    "L2_H32_ln_ragged": (37, 16, 12, 16, 32, 2, True, True),
    "L1_H64_noln": (40, 24, 3, 8, 64, 1, False, True),
    "L3_H32_ln": (24, 18, 4, 5, 32, 3, True, True),
    "L2_H32_ln_gate_only": (37, 16, 12, 16, 32, 2, True, False),
    "L2_H128_ln": (9, 20, 12, 16, 128, 2, True, True),
}


def _setup(seed, N, T, D, Zd, H, L, ln):
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell="min_gru")
    rng = np.random.default_rng(seed)
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(N, T, D)).astype(np.float32)
    return cfg, params, Z


@pytest.mark.parametrize("name", list(CASES))
def test_gate_matches_jax_pallas_interpret(name):
    N, T, D, Zd, H, L, ln, wr = CASES[name]
    cfg, params, Z = _setup(sum(map(ord, name)), N, T, D, Zd, H, L, ln)
    mse_j, resid_j = jax_fused_mingru_gate(
        params, jnp.asarray(Z), num_layers=L, use_layernorm=ln,
        dtype=jnp.float32, interpret=True, batch_tile=32,
        sigmoid_impl="exact", with_residual=wr)

    w = mingru_params_to_kernel_weights(vae_from_flax(params, cfg))
    before = fused_mingru_gate.launches
    mse, resid = fused_mingru_gate(w, torch.from_numpy(Z), num_layers=L,
                                   use_layernorm=ln, with_residual=wr)
    assert fused_mingru_gate.launches == before     # the CPU never launches
    assert mse.shape == (N,) and mse.dtype == torch.float32
    np.testing.assert_allclose(mse.numpy(), np.asarray(mse_j), atol=MSE_ATOL)
    if wr:
        assert resid.shape == (N, T, D)
        np.testing.assert_allclose(resid.numpy(), np.asarray(resid_j),
                                   atol=RESID_ATOL)
    else:
        assert resid is None and resid_j is None


@pytest.mark.parametrize("name", ["L2_H32_ln_ragged", "L1_H64_noln", "L3_H32_ln"])
def test_gate_reference_matches_module_path(name):
    """The kernel's plain version computes what the modules compute, with
    the recurrence in the other form (h + z*(h~ - h) against (1-z)*h + z*h~),
    so they agree to a few float32 ulps: atol 2e-6 and 1e-6 relative."""
    N, T, D, Zd, H, L, ln, _ = CASES[name]
    cfg, params, Z = _setup(3, N, T, D, Zd, H, L, ln)
    vae = vae_from_flax(params, cfg)
    Zt = torch.from_numpy(Z)
    with torch.no_grad():
        recon, _, _ = vae(Zt)
    mse, resid = fused_mingru_gate_reference(
        mingru_params_to_kernel_weights(vae), Zt, num_layers=L, use_layernorm=ln)
    torch.testing.assert_close(resid, (Zt - recon) ** 2, atol=2e-6, rtol=1e-6)
    torch.testing.assert_close(mse, ((Zt - recon) ** 2).mean(dim=(1, 2)),
                               atol=2e-6, rtol=1e-6)


def test_reconstruction_mse_routes_by_cell():
    """``fused=True`` on the CPU runs the cell's plain gate version, gate-only;
    it agrees with the padded-batch model path (atol 2e-6, 1e-6 relative)."""
    N, T, D, Zd, H, L, ln, _ = CASES["L2_H32_ln_ragged"]
    cfg, params, Z = _setup(8, N, T, D, Zd, H, L, ln)
    vae = vae_from_flax(params, cfg)
    a = reconstruction_mse(vae, Z, device="cpu", fused=True)
    b = reconstruction_mse(vae, Z, device="cpu", fused="auto", batch_size=16)
    assert a.shape == b.shape == (N,) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=2e-6, rtol=1e-6)


def test_empty_batch():
    N, T, D, Zd, H, L, ln, _ = CASES["L2_H32_ln_ragged"]
    cfg, params, _ = _setup(4, N, T, D, Zd, H, L, ln)
    w = mingru_params_to_kernel_weights(vae_from_flax(params, cfg))
    mse, resid = fused_mingru_gate(w, torch.zeros(0, T, D), num_layers=L,
                                   use_layernorm=ln)
    assert mse.shape == (0,) and resid.shape == (0, T, D)
    mse, resid = fused_mingru_gate(w, torch.zeros(0, T, D), num_layers=L,
                                   use_layernorm=ln, with_residual=False)
    assert mse.shape == (0,) and resid is None


def test_kernel_weights_layout():
    N, T, D, Zd, H, L, ln, _ = CASES["L2_H32_ln_ragged"]
    cfg, params, _ = _setup(5, N, T, D, Zd, H, L, ln)
    w = mingru_params_to_kernel_weights(vae_from_flax(params, cfg))
    p0 = params["encoder_lstm"]["layer0"]
    np.testing.assert_array_equal(w["enc0_wih"].numpy(), p0["w_ih"])
    np.testing.assert_array_equal(w["enc0_b"].numpy(), p0["b_ih"])
    np.testing.assert_array_equal(
        w["dec1_wih"].numpy(), params["decoder_lstm"]["layer1"]["w_ih"])
    np.testing.assert_array_equal(w["out_w"].numpy(),
                                  params["output_layer"]["kernel"])
    assert w["enc0_wih"].shape == (D, 2 * H) and w["dec0_wih"].shape == (H, 2 * H)
    assert all(t.is_contiguous() and t.dtype == torch.float32
               for t in w.values())
    order = fused_mingru_mod._WEIGHT_ORDER
    assert set(w) == {k for k in order
                      if not (k[:3] in ("enc", "dec") and int(k[3]) >= L)}
    assert len(order) == 4 * 4 + 8 + 2 * 4      # NUM_W of the C entry
    # each w_ih also as its 3xTF32 fragments [2H/8, ceil(K/8), 32, 4], after
    # the 24 plain pointers
    assert order[24:] == tuple(f"{p}{l}_wih_frag" for p in ("enc", "dec")
                               for l in range(4))
    for k in [f"{p}{l}_wih" for p in ("enc", "dec") for l in range(L)]:
        K = w[k].shape[0]
        assert w[f"{k}_frag"].shape == (2 * H // 8, -(-K // 8), 32, 4)


def test_kernel_weights_need_a_mingru_model():
    cfg = VAEConfig(input_dim=5, latent_dim=4, hidden_dim=32, num_layers=2)
    lstm = vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg), cfg)
    with pytest.raises(ValueError, match="expected a cell='min_gru' VAE"):
        mingru_params_to_kernel_weights(lstm)


@pytest.mark.parametrize("bad, match", [
    (dict(num_layers=5), "takes 1 to 4 layers"),
    (dict(num_layers=0), "takes 1 to 4 layers"),
    (dict(H=48), "unsupported shape"),
    (dict(D=17), "unsupported shape"),
    (dict(Zd=33), "unsupported shape"),
    (dict(dtype=torch.float64), "float32"),
    (dict(transpose=True), "contiguous"),
    (dict(Z_D=7), "does not match"),
])
def test_kernel_argument_checks(bad, match):
    """The checks the CUDA wrapper makes before a launch (run on the CPU)."""
    D, H, Zd = bad.get("D", 12), bad.get("H", 32), bad.get("Zd", 4)
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=2,
                    cell="min_gru")
    w = mingru_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg), cfg))
    Z = torch.zeros(2, 5, bad.get("Z_D", D), dtype=bad.get("dtype", torch.float32))
    if bad.get("transpose"):
        Z = torch.zeros(5, 2, D).transpose(0, 1)
    with pytest.raises(ValueError, match=match):
        fused_mingru_mod._check(w, Z, bad.get("num_layers", 2), True)


def test_check_names_the_weights_a_launch_needs():
    cfg = VAEConfig(input_dim=12, latent_dim=4, hidden_dim=32, num_layers=1,
                    use_layernorm=False, cell="min_gru")
    w = mingru_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg), cfg))
    need, H, Zd = fused_mingru_mod._check(w, torch.zeros(2, 5, 12), 1, False)
    assert (H, Zd) == (32, 4)
    assert "enc0_wih" in need and "dec0_b" in need and "out_b" in need
    assert not any(k.startswith(("enc1", "dec1", "ln_")) for k in need)
    w["mu_b"] = w["mu_b"].double()
    with pytest.raises(ValueError, match="weight mu_b must be contiguous float32"):
        fused_mingru_mod._check(w, torch.zeros(2, 5, 12), 1, False)


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mingru_gate({}, torch.zeros(1, 2, 3, device="meta"), num_layers=1,
                          use_layernorm=False)


def test_training_of_the_cell_is_not_ported():
    """No training kernel of the cell is ported (the JAX package has none):
    the cell trains on the plain autograd path, and ``use_kernel=True``
    raises, naming the cell."""
    N, T, D, Zd, H, L, ln, _ = CASES["L2_H32_ln_ragged"]
    cfg, params, Z = _setup(6, N, T, D, Zd, H, L, ln)
    from shm_tpu_torch.config import TrainConfig

    with pytest.raises(ValueError, match="cell='min_gru'"):
        train_vae(vae_from_flax(params, cfg), Z, Z[:8],
                  TrainConfig(epochs=1), use_kernel=True, device="cpu")
    res = train_vae(vae_from_flax(params, cfg), Z, Z[:8],
                    TrainConfig(epochs=1, batch_size=16), device="cpu")
    assert np.isfinite(res.history["train_total"]).all()
