"""The port's attention gate (plain version on the CPU) against the JAX package.

Inputs and weights are made with numpy from a seed and handed to both sides.
The JAX side is the Pallas kernel run in interpret mode in float32, as
``tests/test_fused_attention.py`` runs it. Tolerances are that file's: mse
atol 2e-6, resid atol 1e-5 (both sides compute in float32; four transformer
blocks of products, softmaxes and LayerNorms are summed in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.ops import fused_attention_gate as jax_fused_attention_gate
from shm_tpu_torch.config import TrainConfig, VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import (
    attention_params_to_kernel_weights, fused_attention_gate,
    fused_attention_gate_reference,
)
from shm_tpu_torch.ops import fused_attention as fused_attention_mod
from shm_tpu_torch.ops.fused_attention import (
    SMEM_LIMIT, long_shared_memory_bytes, plan, shared_memory_bytes,
    slot_floats,
)
from shm_tpu_torch.train import reconstruction_mse, train_vae

MSE_ATOL, RESID_ATOL = 2e-6, 1e-5
torch.set_num_threads(1)      # see tests/test_torch_vae_gate.py

CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual)
    "L2_H32_ln_ragged": (13, 16, 12, 16, 32, 2, True, True),
    "L1_H64_noln": (10, 24, 3, 8, 64, 1, False, True),
    "L2_H128_ln": (9, 12, 12, 16, 128, 2, True, True),
    "L2_H32_ln_gate_only": (13, 16, 12, 16, 32, 2, True, False),
    "L2_H32_T130": (5, 130, 5, 4, 32, 2, True, True),     # more than 128 keys
    # latents past 32, to the JAX kernel's 128 lanes
    "L2_H32_Z64": (13, 16, 12, 64, 32, 2, True, True),
    "L1_H64_Z128": (10, 24, 3, 128, 64, 1, True, True),
}


def _setup(seed, N, T, D, Zd, H, L, ln):
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell="attention")
    rng = np.random.default_rng(seed)
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(N, T, D)).astype(np.float32)
    return cfg, params, Z


@pytest.mark.parametrize("name", list(CASES))
def test_gate_matches_jax_pallas_interpret(name):
    N, T, D, Zd, H, L, ln, wr = CASES[name]
    cfg, params, Z = _setup(sum(map(ord, name)), N, T, D, Zd, H, L, ln)
    mse_j, resid_j = jax_fused_attention_gate(
        params, jnp.asarray(Z), num_layers=L, use_layernorm=ln,
        dtype=jnp.float32, interpret=True, batch_tile=8, with_residual=wr)

    w = attention_params_to_kernel_weights(vae_from_flax(params, cfg))
    before = fused_attention_gate.launches
    mse, resid = fused_attention_gate(w, torch.from_numpy(Z), num_layers=L,
                                      use_layernorm=ln, with_residual=wr)
    assert fused_attention_gate.launches == before     # the CPU never launches
    assert mse.shape == (N,) and mse.dtype == torch.float32
    np.testing.assert_allclose(mse.numpy(), np.asarray(mse_j), atol=MSE_ATOL)
    if wr:
        assert resid.shape == (N, T, D)
        np.testing.assert_allclose(resid.numpy(), np.asarray(resid_j),
                                   atol=RESID_ATOL)
    else:
        assert resid is None and resid_j is None


@pytest.mark.parametrize("name", ["L2_H32_ln_ragged", "L1_H64_noln", "L2_H128_ln"])
def test_gate_reference_matches_module_path(name):
    """The kernel's plain version computes what the modules compute, with
    the query scale folded into the packed weights, so they agree to a few
    float32 ulps through the blocks: atol 1e-5 and 1e-5 relative."""
    N, T, D, Zd, H, L, ln, _ = CASES[name]
    cfg, params, Z = _setup(3, N, T, D, Zd, H, L, ln)
    vae = vae_from_flax(params, cfg)
    Zt = torch.from_numpy(Z)
    with torch.no_grad():
        recon, _, _ = vae(Zt)
    mse, resid = fused_attention_gate_reference(
        attention_params_to_kernel_weights(vae), Zt, num_layers=L,
        use_layernorm=ln)
    torch.testing.assert_close(resid, (Zt - recon) ** 2, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(mse, ((Zt - recon) ** 2).mean(dim=(1, 2)),
                               atol=1e-5, rtol=1e-5)


def test_reconstruction_mse_routes_by_cell():
    """``fused=True`` on the CPU runs the cell's plain gate version, gate-only;
    it agrees with the padded-batch model path (atol 1e-5, 1e-5 relative)."""
    N, T, D, Zd, H, L, ln, _ = CASES["L2_H32_ln_ragged"]
    cfg, params, Z = _setup(8, N, T, D, Zd, H, L, ln)
    vae = vae_from_flax(params, cfg)
    a = reconstruction_mse(vae, Z, device="cpu", fused=True)
    b = reconstruction_mse(vae, Z, device="cpu", fused="auto", batch_size=8)
    assert a.shape == b.shape == (N,) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_empty_batch():
    N, T, D, Zd, H, L, ln, _ = CASES["L2_H32_ln_ragged"]
    cfg, params, _ = _setup(4, N, T, D, Zd, H, L, ln)
    w = attention_params_to_kernel_weights(vae_from_flax(params, cfg))
    mse, resid = fused_attention_gate(w, torch.zeros(0, T, D), num_layers=L,
                                      use_layernorm=ln)
    assert mse.shape == (0,) and resid.shape == (0, T, D)
    mse, resid = fused_attention_gate(w, torch.zeros(0, T, D), num_layers=L,
                                      use_layernorm=ln, with_residual=False)
    assert mse.shape == (0,) and resid is None


def test_kernel_weights_layout_and_query_scale():
    """q | k | v of a head sit side by side, and 1/sqrt(32) is folded into the
    query's weight and its bias (the model scales the biased projection)."""
    cfg, params, _ = _setup(5, 2, 4, 12, 16, 64, 2, True)
    H, heads, hd = 64, 2, 32
    w = attention_params_to_kernel_weights(vae_from_flax(params, cfg))
    attn = params["encoder_lstm"]["layer1"]["attn"]
    scale = np.float32(1.0 / np.sqrt(hd))
    wqkv = w["enc1_wqkv"].numpy().reshape(H, heads, 3, hd)
    bqkv = w["enc1_bqkv"].numpy().reshape(heads, 3, hd)
    np.testing.assert_allclose(wqkv[:, :, 0], attn["query"]["kernel"] * scale,
                               rtol=1e-7, atol=0)
    np.testing.assert_allclose(bqkv[:, 0], attn["query"]["bias"] * scale,
                               rtol=1e-7, atol=0)
    np.testing.assert_array_equal(wqkv[:, :, 1], attn["key"]["kernel"])
    np.testing.assert_array_equal(wqkv[:, :, 2], attn["value"]["kernel"])
    np.testing.assert_array_equal(bqkv[:, 2], attn["value"]["bias"])
    np.testing.assert_array_equal(w["enc1_wo"].numpy(),
                                  attn["out"]["kernel"].reshape(H, H))
    np.testing.assert_array_equal(
        w["dec0_w1"].numpy(), params["decoder_lstm"]["layer0"]["mlp_in"]["kernel"])
    np.testing.assert_array_equal(
        w["dec_fn_s"].numpy(), params["decoder_lstm"]["final_norm"]["scale"])
    assert w["enc_in_w"].shape == (12, H) and w["dec_in_w"].shape == (H, H)
    assert all(t.is_contiguous() and t.dtype == torch.float32
               for t in w.values())
    order = fused_attention_mod._WEIGHT_ORDER
    assert set(w) == set(order) and len(order) == 80     # NUM_W of the C entry


def test_kernel_weights_need_an_attention_model_with_heads_of_32():
    cfg = VAEConfig(input_dim=5, latent_dim=4, hidden_dim=32, num_layers=2,
                    cell="min_gru")
    other = vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg), cfg)
    with pytest.raises(ValueError, match="expected a cell='attention' VAE"):
        attention_params_to_kernel_weights(other)
    from shm_tpu_torch.models import TemporalVAE

    narrow = TemporalVAE(5, 4, 16, 1, cell="attention")   # one head of 16
    with pytest.raises(ValueError, match="heads of 32 columns"):
        attention_params_to_kernel_weights(narrow)


@pytest.mark.parametrize("T, H, rows, chunk", [
    (100, 128, 104, 128),      # 4DOF
    (200, 64, 200, 128),       # openLAB
    (80, 32, 80, 128),         # 1DOF
    (130, 32, 136, 128),
    (1, 32, 8, 128),
])
def test_shared_memory_bytes(T, H, rows, chunk):
    """The bytes the wrapper holds against the card's limit, from the
    kernel's layout: ``rows`` is T padded to the 8-row tile, ``chunk`` the
    MLP columns held at once."""
    nbytes = shared_memory_bytes(T, H)
    attn = 3 * rows * 36 + 32 * (-(-T // 4) * 4)
    floats = 2 * rows * (H + 4) + 512 + max(attn, rows * (chunk + 4))
    assert nbytes == 4 * floats <= SMEM_LIMIT
    assert nbytes % 16 == 0


@pytest.mark.parametrize("H, longest", [(128, 136), (64, 208), (32, 268)])
def test_shared_memory_plan_refuses_a_window_too_long_for_a_block(H, longest):
    """The resident body takes a window up to ``longest`` steps; one step
    more passes a block's shared memory, and the plan sends it, and any
    longer window, to the long body, whose shared memory does not grow with
    T and fits a block. Nothing is refused for its length."""
    assert plan(longest, H) == ("resident", shared_memory_bytes(longest, H), 0)
    assert shared_memory_bytes(longest, H) <= SMEM_LIMIT
    assert shared_memory_bytes(longest + 1, H) > SMEM_LIMIT
    for T in (longest + 1, 2000, 100_000):
        got = plan(T, H)
        assert got.body == "long"
        assert got.shared_bytes == long_shared_memory_bytes(H) <= SMEM_LIMIT
        # the stream and every head's q | k | v, rows padded to 8
        assert got.slot_floats == slot_floats(T, H) == 4 * (-(-T // 8) * 8) * H


@pytest.mark.parametrize("bad, match", [
    (dict(num_layers=3), "1- or 2-layer"),
    (dict(D=130), "unsupported shape"),
    (dict(Zd=129), "unsupported shape"),
    (dict(dtype=torch.float64), "float32"),
    (dict(transpose=True), "contiguous"),
    (dict(Z_D=7), "does not match"),
    (dict(T=0), "T >= 1"),
])
def test_kernel_argument_checks(bad, match):
    """The checks the CUDA wrapper makes before a launch (run on the CPU):
    past the kernel's bounds (D and Z to 128) a shape is refused."""
    D, Zd, T = bad.get("D", 12), bad.get("Zd", 4), bad.get("T", 5)
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=128, num_layers=2,
                    cell="attention")
    w = attention_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg), cfg))
    Z = torch.zeros(2, T, bad.get("Z_D", D), dtype=bad.get("dtype", torch.float32))
    if bad.get("transpose"):
        Z = torch.zeros(T, 2, D).transpose(0, 1)
    with pytest.raises(ValueError, match=match):
        fused_attention_mod._check(w, Z, bad.get("num_layers", 2), True)


def test_check_refuses_a_width_the_kernel_does_not_take():
    from shm_tpu_torch.models import TemporalVAE

    wide = TemporalVAE(12, 16, 256, 1, cell="attention")   # 8 heads of 32
    w = attention_params_to_kernel_weights(wide)
    with pytest.raises(ValueError, match="H=256"):
        fused_attention_mod._check(w, torch.zeros(2, 5, 12), 1, True)


def test_check_names_the_weights_a_launch_needs():
    cfg = VAEConfig(input_dim=3, latent_dim=4, hidden_dim=64, num_layers=1,
                    use_layernorm=False, cell="attention")
    w = attention_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg), cfg))
    need, H, Zd = fused_attention_mod._check(w, torch.zeros(2, 9, 3), 1, False)
    assert (H, Zd) == (64, 4)
    assert {"enc_in_w", "enc0_wqkv", "dec0_b2", "dec_fn_b", "out_b"} <= set(need)
    assert not any(k.startswith(("enc1", "dec1", "ln_")) for k in need)
    w["enc0_wo"] = w["enc0_wo"].t()
    with pytest.raises(ValueError, match="weight enc0_wo must be contiguous"):
        fused_attention_mod._check(w, torch.zeros(2, 9, 3), 1, False)


def test_unsupported_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        fused_attention_gate({}, torch.zeros(1, 2, 3, device="meta"),
                             num_layers=1, use_layernorm=False)


def test_training_of_the_cell_is_not_ported():
    """No training kernel of the cell is ported (the JAX package has none):
    the cell trains on the plain autograd path, and ``use_kernel=True``
    raises, naming the cell."""
    N, T, D, Zd, H, L, ln, _ = CASES["L2_H32_ln_ragged"]
    cfg, params, Z = _setup(6, N, T, D, Zd, H, L, ln)
    with pytest.raises(ValueError, match="cell='attention'"):
        train_vae(vae_from_flax(params, cfg), Z, Z[:8], TrainConfig(epochs=1),
                  use_kernel=True, device="cpu")
    res = train_vae(vae_from_flax(params, cfg), Z, Z[:8],
                    TrainConfig(epochs=1, batch_size=16), device="cpu")
    assert np.isfinite(res.history["train_total"]).all()
