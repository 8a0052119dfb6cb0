"""The whole deterministic minGRU-VAE gate as one hand-written CUDA kernel.

Counterpart of ``shm_tpu/ops/fused_mingru.py``: ``fused_mingru_gate`` maps
normalized windows Z [N, T, D] to the per-window reconstruction MSE [N] and,
with ``with_residual``, the squared residual [N, T, D], with z = mu, for a
``TemporalVAE(cell="min_gru")``.

- On a CUDA tensor it launches ``csrc/fused_mingru.cu`` (built with nvcc for
  ``sm_90a`` at first use) and adds one to ``fused_mingru_gate.launches``; a
  failed launch raises. There is no fallback.
- On a CPU tensor it runs :func:`fused_mingru_gate_reference`, the plain
  PyTorch version of the same arithmetic, which the tests hold against the
  JAX kernel and ``chip_smoke.py`` holds the CUDA kernel against.

The kernel source states its bound on the card and what its design does
about it. Computation is float32 with float32 accumulation; the MSE divides
by the real ``T * D``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.ops._build import load_library, raise_on_error
from shm_tpu_torch.ops._gate import (
    check_weights, check_windows, dispatch_gate, f32, pointer_array,
)

_HIDDEN = (32, 64, 128)
_D_MAX, _Z_MAX, _L_MAX = 16, 32, 4
# pointer order of the C entry (csrc/fused_mingru.cu: shm_fused_mingru_gate_f32)
_WEIGHT_ORDER = tuple(
    [f"enc{l}_wih" for l in range(_L_MAX)] + [f"enc{l}_b" for l in range(_L_MAX)]
    + ["ln_scale", "ln_bias", "mu_w", "mu_b", "z2h_w", "z2h_b"]
    + [f"dec{l}_wih" for l in range(_L_MAX)] + [f"dec{l}_b" for l in range(_L_MAX)]
    + ["out_w", "out_b"])


def mingru_params_to_kernel_weights(vae: TemporalVAE) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from a ``cell="min_gru"`` :class:`TemporalVAE`,
    on its device: ``*_wih`` [in, 2H] (the z half first), matmul weights
    [in, out], biases 1-D; every tensor contiguous float32."""
    if vae.cell != "min_gru":
        raise ValueError(f"expected a cell='min_gru' VAE, got {vae.cell!r}")
    w = {}
    for stack, prefix in ((vae.encoder_lstm, "enc"), (vae.decoder_lstm, "dec")):
        for l, layer in enumerate(stack.layers):
            w[f"{prefix}{l}_wih"] = f32(layer.weight_ih.t())
            w[f"{prefix}{l}_b"] = f32(layer.bias_ih)
    if vae.layer_norm is not None:
        w["ln_scale"] = f32(vae.layer_norm.weight)
        w["ln_bias"] = f32(vae.layer_norm.bias)
    for name, fc in (("mu", vae.fc_mu), ("z2h", vae.fc_latent_to_hidden),
                     ("out", vae.output_layer)):
        w[f"{name}_w"] = f32(fc.weight.t())
        w[f"{name}_b"] = f32(fc.bias)
    return w


def _sweep(z: torch.Tensor, hc: torch.Tensor, T: int) -> torch.Tensor:
    """h_t = h_{t-1} + z_t * (h~_t - h_{t-1}) from h = 0 -> [N, T, H];
    ``z`` / ``hc`` are [N, T, H], or [N, H] when constant over T."""
    const = z.dim() == 2
    h = torch.zeros_like(z if const else z[:, 0])
    hs = []
    for t in range(T):
        zt, ht = (z, hc) if const else (z[:, t], hc[:, t])
        h = h + zt * (ht - h)
        hs.append(h)
    return torch.stack(hs, dim=1)


def fused_mingru_gate_reference(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: (mse [N], resid [N, T, D] | None)."""
    N, T, D = Z.shape
    H = weights["mu_w"].shape[0]
    Z = Z.to(torch.float32)

    def layer(prefix, l, inp):
        g = inp @ weights[f"{prefix}{l}_wih"] + weights[f"{prefix}{l}_b"]
        return _sweep(torch.sigmoid(g[..., :H]), g[..., H:], T)

    seq = Z
    for l in range(num_layers):
        seq = layer("enc", l, seq)
    h_last = seq[:, -1]
    if use_layernorm:
        h_last = F.layer_norm(h_last, (H,), weights["ln_scale"],
                              weights["ln_bias"], eps=1e-5)
    mu = h_last @ weights["mu_w"] + weights["mu_b"]
    seq = torch.tanh(mu @ weights["z2h_w"] + weights["z2h_b"])  # constant input
    for l in range(num_layers):
        seq = layer("dec", l, seq)
    resid = (Z - (seq @ weights["out_w"] + weights["out_b"])) ** 2
    mse = resid.sum(dim=(1, 2)) / (T * D)
    return mse, (resid if with_residual else None)


def _check(weights, Z, num_layers, use_layernorm):
    check_windows(Z)
    if not 1 <= num_layers <= _L_MAX:
        raise ValueError(f"the fused minGRU kernel takes 1 to {_L_MAX} layers, "
                         f"got {num_layers}")
    H, Zd = weights["mu_w"].shape
    D = Z.shape[2]
    if H not in _HIDDEN or D > _D_MAX or Zd > _Z_MAX:
        raise ValueError(f"unsupported shape for the fused minGRU kernel: "
                         f"H={H} (need one of {_HIDDEN}), D={D} (<= {_D_MAX}), "
                         f"Z={Zd} (<= {_Z_MAX})")
    if weights["enc0_wih"].shape != (D, 2 * H):
        raise ValueError(f"enc0_wih {tuple(weights['enc0_wih'].shape)} does "
                         f"not match D={D}, H={H}")
    need = [k for k in _WEIGHT_ORDER
            if not (k[:3] in ("enc", "dec") and int(k[3]) >= num_layers)
            and (use_layernorm or not k.startswith("ln_"))]
    check_weights(weights, need, Z.device)
    return need, H, Zd


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C entry declared (built at first
    use, never at import)."""
    lib = load_library("fused_mingru")
    fn = lib.shm_fused_mingru_gate_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    return lib


def _launch(weights, Z, num_layers, use_layernorm, with_residual):
    need, H, Zd = _check(weights, Z, num_layers, use_layernorm)
    N, T, D = Z.shape
    mse = torch.empty(N, device=Z.device, dtype=torch.float32)
    resid = torch.empty_like(Z) if with_residual else None
    if N == 0:
        return mse, resid
    lib = _library()
    ptrs = pointer_array(weights, _WEIGHT_ORDER, need)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = lib.shm_fused_mingru_gate_f32(
            Z.data_ptr(), resid.data_ptr() if with_residual else None,
            mse.data_ptr(), ptrs, len(_WEIGHT_ORDER), N, T, D, H, Zd,
            num_layers, int(use_layernorm), int(with_residual), stream)
    raise_on_error(lib, err, "fused_mingru_gate")
    fused_mingru_gate.launches += 1
    return mse, resid


def fused_mingru_gate(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused deterministic minGRU-VAE pass: (mse [N], resid [N, T, D] | None).

    ``weights`` comes from :func:`mingru_params_to_kernel_weights`. A CUDA
    tensor runs the kernel; a CPU tensor runs the plain version.
    """
    return dispatch_gate("fused_mingru_gate", Z, _launch,
                         fused_mingru_gate_reference, weights,
                         num_layers=num_layers, use_layernorm=use_layernorm,
                         with_residual=with_residual)


# kernel launches so far; callers reset it to 0 to count one run's launches
fused_mingru_gate.launches = 0


__all__ = ["fused_mingru_gate", "fused_mingru_gate_reference",
           "mingru_params_to_kernel_weights"]
