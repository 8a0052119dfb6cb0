"""Hand-written CUDA kernels (sources under ``csrc/``), each with its plain
PyTorch version and a launch counter."""

import torch

from shm_tpu_torch.ops.fused_attention import (
    attention_params_to_kernel_weights, fused_attention_gate,
    fused_attention_gate_reference,
)
from shm_tpu_torch.ops.fused_mingru import (
    fused_mingru_gate, fused_mingru_gate_reference,
    mingru_params_to_kernel_weights,
)
from shm_tpu_torch.ops.fused_vae import (
    fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
)
from shm_tpu_torch.ops.lstm_train import (
    fwd_scan_info, lstm2_dec_head, lstm2_dec_head_reference, lstm2_enc_last,
    lstm2_reverse_scan_reference, lstm2_scan_reference,
    lstm2_scan_stash_reference, vae_train_forward,
)

# cell family -> (weights from a TemporalVAE, the fused gate, its plain version)
FUSED_GATES = {
    "lstm": (vae_params_to_kernel_weights, fused_vae_gate,
             fused_vae_gate_reference),
    "min_gru": (mingru_params_to_kernel_weights, fused_mingru_gate,
                fused_mingru_gate_reference),
    "attention": (attention_params_to_kernel_weights, fused_attention_gate,
                  fused_attention_gate_reference),
}


def fused_gate_for(model):
    """``(weights_fn, gate_fn)`` of the fused kernel of ``model.cell``;
    ``ValueError`` for a cell with no kernel."""
    cell = getattr(model, "cell", "lstm")
    if cell not in FUSED_GATES:
        raise ValueError(f"no fused kernel for cell={cell!r}")
    return FUSED_GATES[cell][:2]


def auto_fused_gate(device) -> bool:
    """The one rule by which a surface that defaults its fused flag
    (``HybridScorer(use_fused_vae=None)``,
    ``reconstruction_mse(fused="auto")``) turns the fused gate on: always on
    a CUDA device, never on the CPU. It does not look at the model: for a
    cell or a shape its kernel does not take, :func:`fused_gate_for` and the
    wrapper's checks raise, and nothing gives way to the plain modules on
    the card."""
    return torch.device(device).type == "cuda"


__all__ = ["auto_fused_gate", "fused_gate_for", "FUSED_GATES",
           "fused_vae_gate", "fused_vae_gate_reference",
           "vae_params_to_kernel_weights",
           "fused_mingru_gate", "fused_mingru_gate_reference",
           "mingru_params_to_kernel_weights",
           "fused_attention_gate", "fused_attention_gate_reference",
           "attention_params_to_kernel_weights",
           "lstm2_enc_last", "lstm2_dec_head",
           "lstm2_scan_reference", "lstm2_dec_head_reference",
           "lstm2_scan_stash_reference", "lstm2_reverse_scan_reference",
           "vae_train_forward", "fwd_scan_info"]
