"""Hybrid gate -> attribution inference (counterpart of ``shm_tpu/pipeline.py``).

One pass per batch: normalize -> deterministic VAE (mse, residual) -> strict
``mse > threshold`` gate -> CNN4DOF on [Z, residual] for every window ->
``y_pred`` / ``p_struct`` selected by the gate.

Label convention: 0 = Normal, 1 = Sensor Fault, 2 = Structural Fault (CNN
argmax {0, 1} -> {1, 2}). ``p_struct`` = p(structural) on anomalous windows,
0 elsewhere.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from shm_tpu_torch.data.windows import normalize_windows
from shm_tpu_torch.models.cnn import CNN4DOF, stack_vae_residual_nhwc
from shm_tpu_torch.models.vae import TemporalVAE

_KEYS = ("mse", "anomalous", "y_pred", "p_struct")


class HybridOutputs(NamedTuple):
    """Per-window outputs of one hybrid pass (tensors on the models' device)."""

    mse: torch.Tensor        # (N,) gate reconstruction MSE
    anomalous: torch.Tensor  # (N,) bool gate decision (mse > threshold, strict)
    y_pred: torch.Tensor     # (N,) int32 in {0, 1, 2}
    p_struct: torch.Tensor   # (N,) p(structural | anomalous), else 0
    logits: torch.Tensor     # (N, 2) raw CNN logits (diagnostics)


def make_vae_pass(vae: TemporalVAE, *, use_fused_vae: bool = False):
    """``fn(Z) -> (mse, xin)`` for normalized (N, T, D) ``Z``: one
    deterministic VAE pass, the gate's MSE (N,) and the CNN's NHWC input
    [Z, residual^2] (N, T, D, 2).

    ``use_fused_vae=True`` runs the pass through the fused gate of
    ``vae.cell`` (``fused_vae_gate`` for ``"lstm"``, ``fused_mingru_gate`` for
    ``"min_gru"``, ``fused_attention_gate`` for ``"attention"``: the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor) and raises
    ``ValueError`` for a cell with no kernel; ``False`` runs the plain
    :class:`TemporalVAE` modules. The kernel weights are taken from ``vae``
    once, here. The caller chooses the grad mode.
    """
    if use_fused_vae:
        from shm_tpu_torch.ops import fused_gate_for

        weights_fn, fused_gate = fused_gate_for(vae)
        weights = weights_fn(vae)

    def vae_pass(Z: torch.Tensor):
        Z = Z.contiguous()
        if use_fused_vae:
            mse, resid = fused_gate(weights, Z, num_layers=vae.num_layers,
                                    use_layernorm=vae.use_layernorm)
            return mse, torch.stack([Z, resid], dim=-1)
        recon, _, _ = vae(Z)
        return ((Z - recon) ** 2).mean(dim=(1, 2)), stack_vae_residual_nhwc(Z, recon)

    return vae_pass


def hybrid_outputs(vae_pass, cnn: CNN4DOF, W: torch.Tensor, mean: torch.Tensor,
                   std: torch.Tensor, threshold: torch.Tensor) -> HybridOutputs:
    """One hybrid pass of raw (N, T, D) ``W`` through ``vae_pass`` (a
    :func:`make_vae_pass` function) and ``cnn``; the caller chooses the grad
    mode."""
    mse, xin = vae_pass(normalize_windows(W, mean, std))
    anom = mse > threshold                                # strict >
    logits = cnn(xin)
    cls01 = torch.argmax(logits, dim=1).to(torch.int32)
    probs = torch.softmax(logits, dim=1)
    y_pred = torch.where(anom, cls01 + 1, torch.zeros_like(cls01))
    p_struct = torch.where(anom, probs[:, 1], torch.zeros_like(probs[:, 1]))
    return HybridOutputs(mse=mse, anomalous=anom, y_pred=y_pred,
                         p_struct=p_struct, logits=logits)


def make_hybrid_fn(vae: TemporalVAE, cnn: CNN4DOF, *,
                   use_fused_vae: bool = False):
    """``fn(W, mean, std, threshold) -> HybridOutputs`` for raw (N, T, D) ``W``;
    the VAE pass is :func:`make_vae_pass`'s (``use_fused_vae`` as there)."""
    vae_pass = make_vae_pass(vae, use_fused_vae=use_fused_vae)

    @torch.inference_mode()
    def hybrid(W: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
               threshold: torch.Tensor) -> HybridOutputs:
        return hybrid_outputs(vae_pass, cnn, W, mean, std, threshold)

    return hybrid


def run_hybrid_batched(hybrid_fn, W: np.ndarray, mean: torch.Tensor,
                       std: torch.Tensor, threshold: torch.Tensor, *,
                       batch_size: int = 8192) -> Dict[str, np.ndarray]:
    """Run ``hybrid_fn`` over a window stack in zero-padded fixed-size batches
    on the device of ``mean`` and return numpy arrays."""
    N = W.shape[0]
    if N == 0:
        return {k: np.zeros((0,), np.float32) for k in _KEYS}
    bs = min(batch_size, N)
    nb = -(-N // bs)
    pad = nb * bs - N
    W = np.asarray(W, np.float32)
    Wp = np.concatenate([W, np.zeros((pad,) + W.shape[1:], np.float32)]) if pad else W
    outs = []
    for i in range(nb):
        Wb = torch.from_numpy(np.ascontiguousarray(Wp[i * bs:(i + 1) * bs]))
        o = hybrid_fn(Wb.to(mean.device), mean, std, threshold)
        outs.append((o, bs if i < nb - 1 else bs - pad))
    return concat_hybrid_outputs(outs)


def concat_hybrid_outputs(outs) -> Dict[str, np.ndarray]:
    """Concatenate ``(HybridOutputs, n_real_windows)`` pairs into host arrays,
    trimming each dispatch to its un-padded window count."""
    return {k: np.concatenate([getattr(o, k)[:n].cpu().numpy() for o, n in outs])
            for k in _KEYS}


__all__ = ["HybridOutputs", "make_vae_pass", "hybrid_outputs", "make_hybrid_fn",
           "run_hybrid_batched", "concat_hybrid_outputs"]
