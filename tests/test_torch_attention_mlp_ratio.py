"""Row 7's ``mlp_ratio`` (the MLP's width M = ``mlp_ratio * H``) in the
port's plain version on the CPU, against the JAX kernel.

The JAX side is ``shm_tpu/ops/fused_attention.py::fused_attention_gate`` in
interpret mode at ``dtype=float32``, as ``tests/test_fused_attention.py``
runs it, on a flax tree whose every block's ``mlp_in`` / ``mlp_out`` is
M wide (``convert.random_flax_vae_params(mlp_ratio=)``; the JAX
``TemporalVAE`` has no ``mlp_ratio``, so only its kernel and the plain gate
compute such a tree).
The tree reaches the port through ``convert.vae_from_flax``, which reads M
off ``mlp_in``. Bars: mse atol 2e-6 and residual atol 5e-6
(``tests/test_ops.py:30-31``). Also: JAX's error for a width that is not a
multiple of 128, in JAX's words; the error for weights of another width;
``mlp_ratio=4`` gives the default's bits; the flax ``AttentionStack`` at
``mlp_ratio`` r against the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.models.attention import AttentionStack as JaxStack
from shm_tpu.ops import fused_attention_gate as jax_gate
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import (
    random_flax_vae_params, tree_mlp_ratio, vae_from_flax, vae_to_flax,
)
from shm_tpu_torch.models.attention import AttentionStack
from shm_tpu_torch.ops import (
    attention_params_to_kernel_weights, fused_attention_gate,
    fused_attention_gate_reference,
)

MSE_ATOL, RESID_ATOL = 2e-6, 5e-6
torch.set_num_threads(1)

CASES = {  # name: (N, T, D, Z, H, L, layernorm, mlp_ratio, stream)
    "H32_r8_L1": (3, 16, 3, 4, 32, 1, True, 8, False),
    "H64_r2_L2": (4, 12, 5, 8, 64, 2, False, 2, False),
    "H32_r8_L2_stream": (2, 16, 4, 4, 32, 2, True, 8, True),
}


def _case(name):
    N, T, D, Zd, H, L, ln, r, stream = CASES[name]
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell="attention")
    rng = np.random.default_rng(sum(map(ord, name)))
    params = random_flax_vae_params(rng, cfg, mlp_ratio=r)
    assert params["decoder_lstm"][f"layer{L - 1}"]["mlp_out"]["kernel"].shape == (r * H, H)
    Z = rng.normal(size=(N, T, D)).astype(np.float32)
    return cfg, params, Z, dict(num_layers=L, use_layernorm=ln, stream=stream), r


@pytest.mark.parametrize("name", list(CASES))
def test_plain_gate_matches_jax_at_mlp_ratio(name):
    cfg, params, Z, kw, r = _case(name)
    mse_j, resid_j = jax_gate(params, jnp.asarray(Z), dtype=jnp.float32,
                              interpret=True, batch_tile=Z.shape[0],
                              mlp_ratio=r, **kw)
    vae = vae_from_flax(params, cfg)
    assert vae.mlp_ratio == r == tree_mlp_ratio(params, cfg.hidden_dim)
    w = attention_params_to_kernel_weights(vae)
    assert w["enc0_w1"].shape == (cfg.hidden_dim, r * cfg.hidden_dim)
    before = fused_attention_gate.launches, fused_attention_gate.mlp_launches
    mse, resid = fused_attention_gate(w, torch.from_numpy(Z), mlp_ratio=r, **kw)
    # the CPU never launches
    assert (fused_attention_gate.launches, fused_attention_gate.mlp_launches) == before
    np.testing.assert_allclose(mse.numpy(), np.asarray(mse_j), atol=MSE_ATOL)
    np.testing.assert_allclose(resid.numpy(), np.asarray(resid_j),
                               atol=RESID_ATOL)


def test_a_width_not_a_multiple_of_128_raises_with_jax_words():
    cfg, params, Z, kw, _ = _case("H32_r8_L1")
    msg = "mlp width 3\\*32 must be a multiple of 128"
    with pytest.raises(ValueError, match=msg):
        jax_gate(params, jnp.asarray(Z), dtype=jnp.float32, interpret=True,
                 mlp_ratio=3, **kw)
    w = attention_params_to_kernel_weights(vae_from_flax(params, cfg))
    for fn in (fused_attention_gate, fused_attention_gate_reference):
        with pytest.raises(ValueError, match=msg):
            fn(w, torch.from_numpy(Z), mlp_ratio=3, **kw)


@pytest.mark.parametrize("ratio", [4, 12])
def test_weights_of_another_width_raise(ratio):
    """Weights of M = 256 at H = 32 with ``mlp_ratio`` 4 (M = 128) or 12:
    the error names both widths."""
    cfg, params, Z, kw, _ = _case("H32_r8_L1")
    w = attention_params_to_kernel_weights(vae_from_flax(params, cfg))
    with pytest.raises(ValueError, match=f"enc0's MLP weights w1 \\(32, 256\\)"
                       f".* width mlp_ratio\\*H = {ratio}\\*32 = {32 * ratio}"):
        fused_attention_gate(w, torch.from_numpy(Z), mlp_ratio=ratio, **kw)


def test_mlp_ratio_4_is_the_default_bit_for_bit():
    cfg = VAEConfig(input_dim=3, latent_dim=4, hidden_dim=32, num_layers=2,
                    cell="attention")
    rng = np.random.default_rng(4)
    params = random_flax_vae_params(rng, cfg)
    vae = vae_from_flax(params, cfg)
    assert vae.mlp_ratio == 4
    w = attention_params_to_kernel_weights(vae)
    Z = torch.from_numpy(rng.normal(size=(3, 10, 3)).astype(np.float32))
    kw = dict(num_layers=2, use_layernorm=True)
    default = fused_attention_gate(w, Z, **kw)
    four = fused_attention_gate(w, Z, mlp_ratio=4, **kw)
    assert all(torch.equal(a, b) for a, b in zip(default, four))


def test_tree_of_another_width_round_trips():
    cfg, params, _, _, r = _case("H64_r2_L2")
    back = vae_to_flax(vae_from_flax(params, cfg))
    lay = back["decoder_lstm"]["layer1"]
    assert lay["mlp_in"]["kernel"].shape == (64, 128)
    assert np.array_equal(lay["mlp_out"]["kernel"],
                          params["decoder_lstm"]["layer1"]["mlp_out"]["kernel"])
    lay = params["encoder_lstm"]["layer0"]
    lay["mlp_in"] = {"kernel": np.zeros((64, 96), np.float32),
                     "bias": np.zeros(96, np.float32)}
    with pytest.raises(ValueError, match="not one multiple of H=64"):
        tree_mlp_ratio(params, 64)


@pytest.mark.parametrize("ratio", [2, 8])
def test_attention_stack_matches_flax_at_mlp_ratio(ratio):
    """The port's ``AttentionStack(mlp_ratio=r)`` against flax's, float32."""
    from shm_tpu_torch.convert import _attention_stack_sd

    B, T, D, H = 2, 9, 3, 32
    rng = np.random.default_rng(ratio)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    js = JaxStack(H, num_layers=2, mlp_ratio=ratio)
    v = jax.tree.map(np.asarray, js.init(jax.random.PRNGKey(ratio),
                                         jnp.asarray(x))["params"])
    want_out, want_sum = js.apply({"params": v}, jnp.asarray(x))
    sd = {}
    _attention_stack_sd(sd, "s", v, 2)
    stack = AttentionStack(D, H, 2, mlp_ratio=ratio)
    stack.load_state_dict({k[2:]: t for k, t in sd.items()})
    with torch.no_grad():
        out, summary = stack(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-5)
    np.testing.assert_allclose(summary.numpy(), np.asarray(want_sum), atol=2e-5)
