"""Hand-written CUDA kernels (sources under ``csrc/``), each with its plain
PyTorch version and a launch counter."""

from shm_tpu_torch.ops.fused_vae import (
    fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
)
from shm_tpu_torch.ops.lstm_train import (
    lstm2_dec_head, lstm2_dec_head_reference, lstm2_enc_last,
    lstm2_scan_reference, vae_train_forward,
)

__all__ = ["fused_vae_gate", "fused_vae_gate_reference",
           "vae_params_to_kernel_weights", "lstm2_enc_last", "lstm2_dec_head",
           "lstm2_scan_reference", "lstm2_dec_head_reference",
           "vae_train_forward"]
