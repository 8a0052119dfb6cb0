"""Tests of the port's CUDA kernels; they need the card and skip without one.

Run them on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it also runs where only PyTorch is installed.
Kernel against plain version: both float32 on the card, summed in other
orders through a 2*L*T-step recurrence, so within atol 1e-4 + rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import (
    fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
)

CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual)
    "4dof_ragged": (77, 100, 12, 16, 128, 2, True, True),
    "openlab_L1_H64": (40, 200, 3, 8, 64, 1, True, True),
    "1dof_H32_noln": (33, 80, 12, 5, 32, 2, False, True),
    "gate_only": (50, 30, 12, 16, 128, 2, True, False),
}


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from shm_tpu_torch.device import set_full_f32_precision

    set_full_f32_precision()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_fused_vae_kernel_matches_plain_version(cuda_device, name):
    N, T, D, Zd, H, L, ln, wr = CASES[name]
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln)
    rng = np.random.default_rng(len(name))
    vae = vae_from_flax(random_flax_vae_params(rng, cfg), cfg).to(cuda_device)
    w = vae_params_to_kernel_weights(vae)
    Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32))
    Z = Z.to(cuda_device)
    before = fused_vae_gate.launches
    mse, resid = fused_vae_gate(w, Z, num_layers=L, use_layernorm=ln,
                                with_residual=wr)
    torch.cuda.synchronize()
    assert fused_vae_gate.launches == before + 1
    mse_p, resid_p = fused_vae_gate_reference(w, Z, num_layers=L,
                                              use_layernorm=ln,
                                              with_residual=wr)
    torch.testing.assert_close(mse, mse_p, atol=1e-4, rtol=1e-4)
    if wr:
        torch.testing.assert_close(resid, resid_p, atol=1e-4, rtol=1e-4)
    else:
        assert resid is None


@pytest.mark.cuda
def test_fused_vae_kernel_refuses_bad_input(cuda_device):
    cfg = VAEConfig(input_dim=12, latent_dim=4, hidden_dim=48, num_layers=1)
    vae = vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg),
                        cfg).to(cuda_device)
    w = vae_params_to_kernel_weights(vae)
    with pytest.raises(ValueError, match="unsupported shape"):
        fused_vae_gate(w, torch.zeros(2, 5, 12, device=cuda_device),
                       num_layers=1, use_layernorm=True)
