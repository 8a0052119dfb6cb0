"""The port's attention stack and ``TemporalVAE(cell="attention")`` against
the JAX package's flax modules.

Inputs and weights are made with numpy from a seed and handed to both sides.
Both compute in float32; four transformer blocks of products, softmaxes and
LayerNorms summed in other orders agree within atol 1e-5 (the residual
tolerance of ``tests/test_fused_attention.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shm_tpu.models import TemporalVAE as JaxTemporalVAE
from shm_tpu.models.attention import AttentionStack as JaxAttentionStack
from shm_tpu.models.attention import sinusoidal_positions as jax_sinusoidal_positions
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.models import vae_from_config
from shm_tpu_torch.models.attention import (
    AttentionStack, FlaxLayerNorm, TransformerBlock, flax_layer_norm,
    sinusoidal_positions,
)

ATOL = 1e-5
torch.set_num_threads(1)      # see tests/test_torch_vae_gate.py


@pytest.mark.parametrize("T, dim", [(1, 32), (40, 32), (130, 64), (100, 128),
                                    (7, 5)])
def test_sinusoidal_positions_match_jax(T, dim):
    got = sinusoidal_positions(T, dim)
    want = np.asarray(jax_sinusoidal_positions(T, dim))
    assert got.shape == (T, dim) and got.dtype == torch.float32
    # the two exp() may round a frequency one way or the other, one float32
    # ulp apart, and the angle of row t carries t times that
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 + T * 2.0 ** -23)
    if dim > 1:                       # interleaved sin / cos
        np.testing.assert_allclose(got[0, :2].numpy(), [0.0, 1.0], atol=0)


def test_flax_layer_norm_formula():
    """Variance ``E[x^2] - E[x]^2`` clamped at 0: near torch's two-pass
    LayerNorm on ordinary rows, and finite on a constant row."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(5, 64)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=64).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.2, 0.2, size=64).astype(np.float32))
    torch.testing.assert_close(flax_layer_norm(x, w, b, 1e-6),
                               F.layer_norm(x, (64,), w, b, 1e-6),
                               atol=2e-6, rtol=1e-6)
    const = flax_layer_norm(torch.full((1, 64), 3.0), w, b, 1e-6)
    torch.testing.assert_close(const[0], b, atol=1e-6, rtol=0)


def _stack_pair(seed, D, H, L):
    """The same random attention stack on both sides (flax tree, port)."""
    cfg = VAEConfig(input_dim=D, latent_dim=4, hidden_dim=H, num_layers=L,
                    cell="attention")
    rng = np.random.default_rng(seed)
    params = random_flax_vae_params(rng, cfg)
    vae = vae_from_flax(params, cfg)
    return vae.encoder_lstm, JaxAttentionStack(H, L, 0.3), params["encoder_lstm"], rng


@pytest.mark.parametrize("H, L, T", [(32, 1, 12), (64, 2, 20), (128, 2, 9),
                                     (32, 2, 130)])
def test_stack_matches_flax(H, L, T):
    stack, jstack, tree, rng = _stack_pair(H + L, 5, H, L)
    assert stack.num_heads == H // 32
    x = rng.normal(size=(4, T, 5)).astype(np.float32)
    out_j, s_j = jstack.apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        out, summary = stack(torch.from_numpy(x))
    assert out.shape == (4, T, H) and summary.shape == (4, H)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(summary.numpy(), np.asarray(s_j), atol=ATOL)
    torch.testing.assert_close(summary, out.mean(dim=1), atol=1e-6, rtol=0)


def test_stack_broadcast_steps_matches_flax():
    """The constant-input decoder mode: one projected token broadcast over T,
    told apart by the positions."""
    cfg = VAEConfig(input_dim=5, latent_dim=4, hidden_dim=64, num_layers=2,
                    cell="attention")
    rng = np.random.default_rng(11)
    params = random_flax_vae_params(rng, cfg)
    stack = vae_from_flax(params, cfg).decoder_lstm
    v = rng.normal(size=(3, 64)).astype(np.float32)
    out_j, _ = JaxAttentionStack(64, 2, 0.3).apply(
        {"params": params["decoder_lstm"]}, jnp.asarray(v), broadcast_steps=17)
    with torch.no_grad():
        out, _ = stack(torch.from_numpy(v), broadcast_steps=17)
    assert out.shape == (3, 17, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    assert not torch.allclose(out[:, 0], out[:, 1])


def test_block_scales_the_biased_query():
    """flax divides the query by sqrt(head_dim) after adding its bias; a
    block that scaled only the weight would differ when the bias is large."""
    blk = TransformerBlock(32, 1).eval()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 6, 32)).astype(np.float32))
    with torch.no_grad():
        blk.query.bias.fill_(2.0)
        want = blk(x)
        blk.query.weight.mul_(1 / 32 ** 0.5)       # fold the scale by hand
        blk.query.bias.mul_(1 / 32 ** 0.5)
        h = blk.attn_norm(x)
        q, k, v = blk.query(h), blk.key(h), blk.value(h)
        o = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
        s = x + blk.out(o)
        got = s + blk.mlp_out(F.gelu(blk.mlp_in(blk.mlp_norm(s)),
                                     approximate="tanh"))
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-6)


def test_parameter_names_and_shapes():
    stack = AttentionStack(12, 128, 2)
    sd = stack.state_dict()
    assert sd["in_proj.weight"].shape == (128, 12)
    assert sd["layers.1.query.weight"].shape == (128, 128)
    assert sd["layers.0.out.weight"].shape == (128, 128)
    assert sd["layers.0.mlp_in.weight"].shape == (512, 128)
    assert sd["layers.0.mlp_out.weight"].shape == (128, 512)
    assert sd["layers.0.attn_norm.weight"].shape == (128,)
    assert sd["final_norm.bias"].shape == (128,)
    assert stack.num_heads == 4 and AttentionStack(3, 32).num_heads == 1
    assert isinstance(stack.final_norm, FlaxLayerNorm)
    assert stack.final_norm.eps == 1e-6
    with pytest.raises(ValueError, match="not divisible"):
        TransformerBlock(48, 5)


def test_dropout_in_training_mode_only():
    stack, _, _, rng = _stack_pair(5, 5, 32, 2)
    x = torch.from_numpy(rng.normal(size=(2, 8, 5)).astype(np.float32))
    with torch.no_grad():
        a, _ = stack(x)
        b, _ = stack(x)
        assert torch.equal(a, b)
        stack.train()
        c, _ = stack(x, generator=torch.Generator().manual_seed(0))
        d, _ = stack(x, generator=torch.Generator().manual_seed(0))
        assert not torch.equal(a, c) and torch.equal(c, d)
        # the masks drawn ahead of the forward, in its order, are its masks
        masks = stack.draw_dropout_masks(2, 8, torch.Generator().manual_seed(0),
                                         x.device)
        e, _ = stack(x, dropout_masks=masks)
        assert torch.equal(c, e)
    with pytest.raises(ValueError, match="keep-mask triple"):
        stack(x, dropout_masks=torch.ones(2, 8, 32))


CASES = {  # name: (D, Z, H, L, layernorm, T)
    "L2_H32_ln": (12, 16, 32, 2, True, 16),
    "L1_H64_noln": (3, 8, 64, 1, False, 24),
    "L2_H128_ln": (12, 16, 128, 2, True, 10),
    "L2_H32_T130": (5, 4, 32, 2, True, 130),       # more than 128 keys
}


@pytest.mark.parametrize("name", list(CASES))
def test_temporal_vae_matches_flax(name):
    D, Zd, H, L, ln, T = CASES[name]
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell="attention")
    rng = np.random.default_rng(len(name))
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(5, T, D)).astype(np.float32)
    jvae = JaxTemporalVAE(D, Zd, H, L, 0.3, ln, cell="attention")
    recon_j, mu_j, logvar_j = jvae.apply({"params": params}, jnp.asarray(Z))
    vae = vae_from_flax(params, cfg)
    assert vae.cell == "attention" and not vae.training
    with torch.no_grad():
        recon, mu, logvar = vae(torch.from_numpy(Z))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), atol=ATOL)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=ATOL)


def test_init_parameters_draws_as_flax_does():
    vae = vae_from_config(VAEConfig(input_dim=12, latent_dim=16, hidden_dim=128,
                                    num_layers=2, cell="attention"))
    vae.init_parameters(torch.Generator().manual_seed(0))
    blk = vae.encoder_lstm.layers[0]
    for lin in (blk.query, blk.mlp_in, blk.mlp_out, vae.decoder_lstm.in_proj):
        w = lin.weight.detach()
        std = (1.0 / lin.in_features) ** 0.5
        assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
        assert abs(float(w.std()) - std) < 0.1 * std     # variance 1/fan_in
        assert float(lin.bias.detach().abs().max()) == 0.0
    assert torch.equal(blk.attn_norm.weight.detach(), torch.ones(128))
    # the VAE's own heads keep torch's Linear init
    assert float(vae.fc_mu.bias.detach().abs().max()) > 0.0
