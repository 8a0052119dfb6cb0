"""Hybrid gate -> attribution inference (counterpart of ``shm_tpu/pipeline.py``).

One pass per batch: normalize -> VAE (mse, residual; deterministic unless
``sample=True``) -> strict ``mse > threshold`` gate -> CNN4DOF on [Z,
residual] for every window -> ``y_pred`` / ``p_struct`` selected by the
gate.

Label convention: 0 = Normal, 1 = Sensor Fault, 2 = Structural Fault (CNN
argmax {0, 1} -> {1, 2}). ``p_struct`` = p(structural) on anomalous windows,
0 elsewhere.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from shm_tpu_torch.data.windows import normalize_windows
from shm_tpu_torch.models.cnn import (CNN4DOF, cnn4dof_apply_transposed,
                                      stack_vae_residual_nhwc)
from shm_tpu_torch.models.vae import TemporalVAE

_KEYS = ("mse", "anomalous", "y_pred", "p_struct")


class HybridOutputs(NamedTuple):
    """Per-window outputs of one hybrid pass (tensors on the models' device)."""

    mse: torch.Tensor        # (N,) gate reconstruction MSE
    anomalous: torch.Tensor  # (N,) bool gate decision (mse > threshold, strict)
    y_pred: torch.Tensor     # (N,) int32 in {0, 1, 2}
    p_struct: torch.Tensor   # (N,) p(structural | anomalous), else 0
    logits: torch.Tensor     # (N, 2) raw CNN logits (diagnostics)


def make_vae_pass(vae: TemporalVAE, *, use_fused_vae: bool = False,
                  fused_dtype: Optional[torch.dtype] = torch.float32,
                  sample: bool = False, fused_layout: str = "nhwc"):
    """``fn(Z, generator=None) -> (mse, xin)`` for normalized (N, T, D)
    ``Z``: one VAE pass, the gate's MSE (N,) and the CNN's NHWC input
    [Z, residual^2] (N, T, D, 2).

    ``use_fused_vae=True`` runs the pass through the fused gate of
    ``vae.cell`` (``fused_vae_gate`` for ``"lstm"``, ``fused_mingru_gate`` for
    ``"min_gru"``, ``fused_attention_gate`` for ``"attention"``: the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor) and raises
    ``ValueError`` for a cell with no kernel; ``False`` runs the plain
    :class:`TemporalVAE` modules. The kernel weights are taken from ``vae``
    once, here. ``fused_dtype`` is the fused gate's ``dtype`` (float32, the
    port's default, or ``torch.bfloat16``: the kernel's bf16 instance, as
    the JAX package serves), or ``None``: the VAE's own ``dtype``, as the
    JAX function's ``fused_dtype or vae_model.dtype``. The attention gate
    then also reads the windows
    and writes the residual in that type, and the residual is cast back to
    float32 for the CNN; the LSTM and minGRU gates keep float32 io, as in
    ``shm_tpu/pipeline.py``. The plain path ignores ``fused_dtype`` and runs
    the modules at the VAE's ``dtype``.
    ``sample=True`` (plain path only) decodes ``mu + eps * exp(0.5 *
    logvar)`` with eps drawn from ``generator``. The caller chooses the grad
    mode.

    ``fused_layout="transposed"`` (with ``use_fused_vae=True`` and an
    ``"lstm"`` VAE) is the JAX function's other layout
    (``shm_tpu/pipeline.py:86-103``): ``xin`` is then ``(Zt, resid_t)``, both
    [T, Dp, N], the LSTM gate's residual in ``residual_layout="transposed"``
    and Zt built from Z the same way (D padded to Dp; N is not padded, as
    the port has no batch tile), the input of
    :func:`cnn4dof_apply_transposed`. It never runs the NHWC path; a cell
    other than ``"lstm"``, the plain VAE or an unknown layout raises
    ``ValueError``, as in JAX.
    """
    if use_fused_vae and sample:
        raise ValueError("fused VAE kernel is deterministic (sample=False only)")
    transposed = fused_layout == "transposed"
    if transposed and getattr(vae, "cell", "lstm") != "lstm":
        raise ValueError("fused_layout='transposed' is LSTM-kernel only")
    if fused_layout not in ("nhwc", "transposed"):
        raise ValueError(f"unknown fused_layout {fused_layout!r}")
    if transposed and not use_fused_vae:
        raise ValueError("fused_layout='transposed' requires use_fused_vae=True")
    gate_dtype = vae.dtype if fused_dtype is None else fused_dtype
    layout = {}
    if transposed:
        from shm_tpu_torch.ops.fused_vae import padded_features

        layout = {"residual_layout": "transposed"}
    if use_fused_vae:
        from shm_tpu_torch.ops import fused_gate_for

        weights_fn, fused_gate = fused_gate_for(vae)
        weights = weights_fn(vae, gate_dtype)
        io_dtype = (gate_dtype if getattr(vae, "cell", "lstm") == "attention"
                    else None)

    def vae_pass(Z: torch.Tensor, generator: Optional[torch.Generator] = None):
        Z = Z.contiguous()
        if use_fused_vae:
            mse, resid = fused_gate(weights, Z, num_layers=vae.num_layers,
                                    use_layernorm=vae.use_layernorm,
                                    dtype=gate_dtype, io_dtype=io_dtype,
                                    **layout)
            if transposed:
                # Zt as the kernel reads the windows (shm_tpu/pipeline.py:100-103)
                Zt = F.pad(Z, (0, padded_features(Z.shape[2]) - Z.shape[2]))
                return mse, (Zt.permute(1, 2, 0).to(resid.dtype), resid)
            return mse, torch.stack([Z, resid.to(Z.dtype)], dim=-1)
        recon, _, _ = vae(Z, sample=sample, generator=generator)
        return ((Z - recon) ** 2).mean(dim=(1, 2)), stack_vae_residual_nhwc(Z, recon)

    return vae_pass


def hybrid_outputs(vae_pass, cnn: CNN4DOF, W: torch.Tensor, mean: torch.Tensor,
                   std: torch.Tensor, threshold: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> HybridOutputs:
    """One hybrid pass of raw (N, T, D) ``W`` through ``vae_pass`` (a
    :func:`make_vae_pass` function) and ``cnn``; the caller chooses the grad
    mode."""
    mse, xin = vae_pass(normalize_windows(W, mean, std), generator=generator)
    anom = mse > threshold                                # strict >
    logits = cnn(xin)
    cls01 = torch.argmax(logits, dim=1).to(torch.int32)
    probs = torch.softmax(logits, dim=1)
    y_pred = torch.where(anom, cls01 + 1, torch.zeros_like(cls01))
    p_struct = torch.where(anom, probs[:, 1], torch.zeros_like(probs[:, 1]))
    return HybridOutputs(mse=mse, anomalous=anom, y_pred=y_pred,
                         p_struct=p_struct, logits=logits)


def make_hybrid_fn(vae: TemporalVAE, cnn: CNN4DOF, *, sample: bool = False,
                   use_fused_vae: bool = False,
                   fused_dtype: Optional[torch.dtype] = torch.float32,
                   fused_layout: str = "nhwc"):
    """``fn(W, mean, std, threshold, generator=None) -> HybridOutputs`` for
    raw (N, T, D) ``W``; the VAE pass is :func:`make_vae_pass`'s
    (``use_fused_vae``, ``fused_dtype`` and ``sample`` as there).
    ``sample=True`` draws the VAE's eps from the ``generator`` given to
    ``fn`` (on the models' device), as the JAX function draws it from its
    ``key``; it raises ``ValueError`` with ``use_fused_vae=True``, as in
    ``shm_tpu/pipeline.py``.

    ``fused_layout="transposed"`` (see :func:`make_vae_pass`) runs the
    CNN4DOF-shaped ``cnn`` through :func:`cnn4dof_apply_transposed` on the
    gate's transposed residual, in ``fused_dtype``, or bf16 where it is
    None (JAX: ``fused_dtype or bf16``); ``cnn.dtype`` is not read there.
    """
    vae_pass = make_vae_pass(vae, use_fused_vae=use_fused_vae,
                             fused_dtype=fused_dtype, sample=sample,
                             fused_layout=fused_layout)
    if fused_layout == "transposed":
        cnn_dtype = torch.bfloat16 if fused_dtype is None else fused_dtype
        apply_cnn = lambda xin: cnn4dof_apply_transposed(
            cnn, *xin, d_real=vae.input_dim, dtype=cnn_dtype)
    else:
        apply_cnn = cnn

    @torch.inference_mode()
    def hybrid(W: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
               threshold: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> HybridOutputs:
        return hybrid_outputs(vae_pass, apply_cnn, W, mean, std, threshold,
                              generator)

    return hybrid


def run_hybrid_batched(hybrid_fn, W: np.ndarray, mean: torch.Tensor,
                       std: torch.Tensor, threshold: torch.Tensor, *,
                       batch_size: int = 8192,
                       generator: Optional[torch.Generator] = None,
                       ) -> Dict[str, np.ndarray]:
    """Run ``hybrid_fn`` over a window stack in zero-padded fixed-size batches
    on the device of ``mean`` and return numpy arrays; ``generator`` (for a
    ``sample=True`` function) is passed to every batch in turn."""
    N = W.shape[0]
    if N == 0:
        return {k: np.zeros((0,), np.float32) for k in _KEYS}
    bs = min(batch_size, N)
    nb = -(-N // bs)
    pad = nb * bs - N
    W = np.asarray(W, np.float32)
    Wp = np.concatenate([W, np.zeros((pad,) + W.shape[1:], np.float32)]) if pad else W
    kw = {} if generator is None else {"generator": generator}
    outs = []
    for i in range(nb):
        Wb = torch.from_numpy(np.ascontiguousarray(Wp[i * bs:(i + 1) * bs]))
        o = hybrid_fn(Wb.to(mean.device), mean, std, threshold, **kw)
        outs.append((o, bs if i < nb - 1 else bs - pad))
    return concat_hybrid_outputs(outs)


def concat_hybrid_outputs(outs) -> Dict[str, np.ndarray]:
    """Concatenate ``(HybridOutputs, n_real_windows)`` pairs into host arrays,
    trimming each dispatch to its un-padded window count."""
    return {k: np.concatenate([getattr(o, k)[:n].cpu().numpy() for o, n in outs])
            for k in _KEYS}


__all__ = ["HybridOutputs", "make_vae_pass", "hybrid_outputs", "make_hybrid_fn",
           "run_hybrid_batched", "concat_hybrid_outputs"]
