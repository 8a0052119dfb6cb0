"""Hand-written CUDA kernels (sources under ``csrc/``), each with its plain
PyTorch version and a launch counter."""

from shm_tpu_torch.ops.fused_vae import (
    fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
)

__all__ = ["fused_vae_gate", "fused_vae_gate_reference",
           "vae_params_to_kernel_weights"]
