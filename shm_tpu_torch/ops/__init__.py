"""Hand-written CUDA kernels (sources under ``csrc/``), each with its plain
PyTorch version and a launch counter."""

import functools

import torch

from shm_tpu_torch.ops import fused_mingru
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
    ``ValueError`` for a cell with no kernel. An attention model whose MLP
    is not 4H wide gets the gate with its ``mlp_ratio`` bound."""
    cell = getattr(model, "cell", "lstm")
    if cell not in FUSED_GATES:
        raise ValueError(f"no fused kernel for cell={cell!r}")
    weights_fn, gate = FUSED_GATES[cell][:2]
    ratio = getattr(model, "mlp_ratio", 4)
    if cell == "attention" and ratio != 4:
        gate = functools.partial(gate, mlp_ratio=ratio)
    return weights_fn, gate


# the JAX rule's clauses: the attention kernel's heads of 32 columns packed
# in <= 128 columns, and the layer counts it sends to its kernels
_ATTENTION_H_STEP, _ATTENTION_H_MAX = 32, 128
_JAX_KERNEL_LAYERS = (1, 2)


def auto_fused_gate(model, device) -> bool:
    """The one rule by which a surface that defaults its fused flag
    (``HybridScorer(use_fused_vae=None)``, ``OpenLabScorer``,
    ``reconstruction_mse(fused="auto")``, the 4DOF commands) turns the fused
    gate on for ``model`` on ``device``: never on the CPU; on a CUDA device
    wherever the JAX package's ``auto_fused_gate``
    (``shm_tpu/ops/__init__.py``) runs its kernel on its chip, the plain
    modules wherever it computes on XLA. So it is False for an attention
    VAE whose H is no multiple of 32 or past 128, and for any cell at L not
    1 or 2, with one deliberate difference: the port's minGRU kernel takes L
    up to 4 and computes the same function there, so a minGRU VAE of 3 or 4
    layers keeps it. The rule reads the model's cell, ``hidden_dim`` and
    ``num_layers`` before any launch; a shape inside the rule whose kernel
    check refuses it (an LSTM of H > 128) still raises, and nothing falls
    back after a failed build or launch."""
    if torch.device(device).type != "cuda":
        return False
    cell = getattr(model, "cell", "lstm")
    layers = getattr(model, "num_layers", 0)
    if cell == "attention":
        H = getattr(model, "hidden_dim", 0)
        if H % _ATTENTION_H_STEP or H > _ATTENTION_H_MAX:
            return False
    if cell == "min_gru":
        return 1 <= layers <= fused_mingru._L_MAX
    return cell in FUSED_GATES and layers in _JAX_KERNEL_LAYERS


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
