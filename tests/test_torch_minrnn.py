"""The port's minGRU stack and ``TemporalVAE(cell="min_gru")`` against the
JAX package's flax modules.

Inputs and weights are made with numpy from a seed and handed to both sides.
Both compute in float32; they differ in the order of sums inside the
projections, so the modules agree within atol 2e-6 (the tolerance of
``tests/test_minrnn.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.models import TemporalVAE as JaxTemporalVAE
from shm_tpu.models.minrnn import MinGRUStack as JaxMinGRUStack
from shm_tpu.models.minrnn import linear_recurrence as jax_linear_recurrence
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.models import TemporalVAE, vae_from_config
from shm_tpu_torch.models.minrnn import MinGRULayer, MinGRUStack, linear_recurrence

ATOL = 2e-6
torch.set_num_threads(1)      # see tests/test_torch_vae_gate.py


def _coefficients(seed, shape=(19, 5, 7)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("impl", ["sequential", "associative"])
def test_linear_recurrence_matches_jax(impl):
    a, b = _coefficients(0)
    want = np.asarray(jax_linear_recurrence(jnp.asarray(a), jnp.asarray(b), impl=impl))
    got = linear_recurrence(torch.from_numpy(a), torch.from_numpy(b), impl=impl)
    assert got.shape == a.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("T", [1, 2, 7, 16, 33])
def test_linear_recurrence_forms_agree(T):
    """The doubling form composes the same affine maps in another order."""
    a, b = _coefficients(T, (T, 3, 4))
    seq = linear_recurrence(torch.from_numpy(a), torch.from_numpy(b))
    par = linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                            impl="associative")
    torch.testing.assert_close(par, seq, atol=ATOL, rtol=1e-6)
    h = np.zeros_like(a[0])
    for t in range(T):                      # the definition, in numpy
        h = a[t] * h + b[t]
    np.testing.assert_allclose(seq[-1].numpy(), h, atol=ATOL)


def test_linear_recurrence_unknown_impl():
    with pytest.raises(ValueError, match="unknown linear_recurrence impl"):
        linear_recurrence(torch.zeros(2, 1), torch.zeros(2, 1), impl="blocked")


def _stack_pair(seed, D, H, L, scan_impl="sequential"):
    """The same random minGRU stack on both sides."""
    cfg = VAEConfig(input_dim=D, latent_dim=4, hidden_dim=H, num_layers=L,
                    cell="min_gru")
    rng = np.random.default_rng(seed)
    tree = random_flax_vae_params(rng, cfg)["encoder_lstm"]
    stack = MinGRUStack(D, H, L, dropout=0.3, scan_impl=scan_impl)
    with torch.no_grad():
        for l, layer in enumerate(stack.layers):
            layer.weight_ih.copy_(torch.from_numpy(tree[f"layer{l}"]["w_ih"].T))
            layer.bias_ih.copy_(torch.from_numpy(tree[f"layer{l}"]["b_ih"]))
    return stack.eval(), JaxMinGRUStack(H, L, 0.3, scan_impl=scan_impl), tree, rng


@pytest.mark.parametrize("scan_impl", ["sequential", "associative"])
@pytest.mark.parametrize("L", [1, 2, 3])
def test_stack_matches_flax(L, scan_impl):
    stack, jstack, tree, rng = _stack_pair(L, 5, 32, L, scan_impl)
    x = rng.normal(size=(6, 21, 5)).astype(np.float32)
    out_j, h_j = jstack.apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        out, h = stack(torch.from_numpy(x))
    assert out.shape == (6, 21, 32) and h.shape == (6, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=ATOL)
    torch.testing.assert_close(out[:, -1], h, atol=0, rtol=0)


def test_stack_broadcast_steps_matches_flax():
    """The constant-input decoder mode: one projection, T sweep steps."""
    stack, jstack, tree, rng = _stack_pair(7, 32, 32, 2)
    v = rng.normal(size=(4, 32)).astype(np.float32)
    out_j, h_j = jstack.apply({"params": tree}, jnp.asarray(v), broadcast_steps=13)
    with torch.no_grad():
        out, h = stack(torch.from_numpy(v), broadcast_steps=13)
        tiled, _ = stack(torch.from_numpy(v)[:, None].expand(4, 13, 32))
    assert out.shape == (4, 13, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=ATOL)
    torch.testing.assert_close(out, tiled, atol=ATOL, rtol=1e-6)


def test_layer_parameter_layout():
    layer = MinGRULayer(5, 8)
    assert layer.weight_ih.shape == (16, 5) and layer.bias_ih.shape == (16,)
    assert {n for n, _ in layer.named_parameters()} == {"weight_ih", "bias_ih"}
    bound = 1.0 / 8 ** 0.5
    assert float(layer.weight_ih.detach().abs().max()) <= bound


def test_stack_dropout_in_training_mode_only():
    stack, _, _, rng = _stack_pair(9, 5, 32, 2)
    x = torch.from_numpy(rng.normal(size=(3, 9, 5)).astype(np.float32))
    with torch.no_grad():
        a, _ = stack(x)
        b, _ = stack(x)
        assert torch.equal(a, b)                       # eval: no dropout
        stack.train()
        g = torch.Generator().manual_seed(1)
        c, _ = stack(x, generator=g)
        assert not torch.equal(a, c)
        mask = torch.ones(3, 9, 32)
        d, _ = stack(x, dropout_masks=mask)            # explicit unit mask
        torch.testing.assert_close(d, a, atol=0, rtol=0)
    with pytest.raises(ValueError, match="need 1 dropout masks"):
        stack(x, dropout_masks=[mask, mask])


CASES = {  # name: (D, Z, H, L, layernorm, T)
    "L2_H32_ln": (12, 16, 32, 2, True, 16),
    "L1_H64_noln": (3, 8, 64, 1, False, 24),
    "L3_H32_ln": (4, 5, 32, 3, True, 18),
}


@pytest.mark.parametrize("name", list(CASES))
def test_temporal_vae_matches_flax(name):
    D, Zd, H, L, ln, T = CASES[name]
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell="min_gru")
    rng = np.random.default_rng(len(name))
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(11, T, D)).astype(np.float32)
    jvae = JaxTemporalVAE(D, Zd, H, L, 0.3, ln, cell="min_gru")
    recon_j, mu_j, logvar_j = jvae.apply({"params": params}, jnp.asarray(Z))
    vae = vae_from_flax(params, cfg)
    assert vae.cell == "min_gru" and not vae.training
    with torch.no_grad():
        recon, mu, logvar = vae(torch.from_numpy(Z))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), atol=ATOL)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=ATOL)


def test_temporal_vae_sampled_path_takes_given_noise():
    cfg = VAEConfig(input_dim=5, latent_dim=4, hidden_dim=32, num_layers=2,
                    cell="min_gru")
    rng = np.random.default_rng(2)
    vae = vae_from_flax(random_flax_vae_params(rng, cfg), cfg)
    Z = torch.from_numpy(rng.normal(size=(3, 9, 5)).astype(np.float32))
    with torch.no_grad():
        _, mu, logvar = vae(Z)
        zero, _, _ = vae(Z, sample=True, eps=torch.zeros(3, 4))
        mean, _, _ = vae(Z)
        moved, _, _ = vae(Z, sample=True, eps=torch.ones(3, 4))
    torch.testing.assert_close(zero, mean, atol=0, rtol=0)
    assert not torch.allclose(moved, mean)
    assert mu.shape == logvar.shape == (3, 4)


def test_init_parameters_bounds_and_unknown_cell():
    vae = vae_from_config(VAEConfig(input_dim=5, latent_dim=4, hidden_dim=16,
                                    num_layers=2, cell="min_gru"))
    vae.init_parameters(torch.Generator().manual_seed(0))
    bound = 1.0 / 16 ** 0.5
    for stack in (vae.encoder_lstm, vae.decoder_lstm):
        for p in stack.parameters():
            assert 0.5 * bound < float(p.detach().abs().max()) <= bound
    assert set(vae.state_dict()) >= {"encoder_lstm.layers.1.weight_ih",
                                     "decoder_lstm.layers.0.bias_ih"}
    with pytest.raises(ValueError, match="unknown cell 'gru'"):
        TemporalVAE(cell="gru")
