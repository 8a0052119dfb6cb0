"""The whole deterministic LSTM-VAE gate as one hand-written CUDA kernel.

Counterpart of ``shm_tpu/ops/fused_vae.py``: ``fused_vae_gate`` maps
normalized windows Z [N, T, D] to the per-window reconstruction MSE [N] and,
with ``with_residual``, the squared residual [N, T, D], with z = mu.

- On a CUDA tensor it launches ``csrc/fused_vae.cu`` (built with nvcc for
  ``sm_90a`` at first use) and adds one to ``fused_vae_gate.launches``; a
  failed launch raises. There is no fallback.
- On a CPU tensor it runs :func:`fused_vae_gate_reference`, the plain
  PyTorch version of the same arithmetic, which the tests hold against the
  JAX kernel and ``chip_smoke.py`` holds the CUDA kernel against.

The kernel computes every LSTM gate product of both stacks on the tensor
cores in 3xTF32. It reads those weights as TF32 fragments that
:func:`vae_params_to_kernel_weights` packs once (``tf32x3_fragments``, K
padded to a multiple of 8); the plain version reads them as given. The
kernel source states its bound on the card and what its design does about
it. Computation is float32 with float32 accumulation (the tensor cores
truncate their sums, so each pair of k-steps is summed apart and added to
the float32 sum to nearest); the MSE divides by the real ``T * D`` (no
feature padding). The same source also holds the float32
FMA body that the probe variants of ``shm_tpu_torch/tools/probe_vpu_bound.py``
time (C entry ``shm_fused_vae_probe``), which reaches the shipping body too.
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
    check_fragments, check_weights, check_windows, dispatch_gate, f32,
    pointer_array, tf32x3_fragments,
)

# the kernel's tensor-core products: every LSTM weight of both stacks
_PRODUCTS = tuple(f"{p}{l}_{k}" for p in ("enc", "dec") for l in range(2)
                  for k in ("wih", "whh"))
# pointer order of the C entry (csrc/fused_vae.cu: shm_fused_vae_gate_f32)
_WEIGHT_ORDER = (
    "enc0_wih", "enc0_whh", "enc0_b", "enc1_wih", "enc1_whh", "enc1_b",
    "ln_scale", "ln_bias", "mu_w", "mu_b", "z2h_w", "z2h_b",
    "dec0_wih", "dec0_whh", "dec0_b", "dec1_wih", "dec1_whh", "dec1_b",
    "out_w", "out_b",
) + tuple(f"{k}_frag" for k in _PRODUCTS)
_HIDDEN = (32, 64, 128)
_D_MAX, _Z_MAX = 16, 32


def vae_params_to_kernel_weights(vae: TemporalVAE) -> Dict[str, torch.Tensor]:
    """The kernel's weight dict from a :class:`TemporalVAE`, on its device.

    Matmul weights are [in, out] (LSTM ``*_wih`` [in, 4H], ``*_whh`` [H, 4H],
    gates i|f|g|o), biases 1-D (the cell's ``bias_ih + bias_hh``); every
    tensor is contiguous float32. Each LSTM weight also comes as
    ``*_frag``, its ``tf32x3_fragments`` (the input rows padded with zeros
    to a multiple of 8: D=12 to 16, D=3 to 8), which is what the kernel
    reads.
    """
    w = {}
    for stack, prefix in ((vae.encoder_lstm, "enc"), (vae.decoder_lstm, "dec")):
        for l, layer in enumerate(stack.layers):
            p = f"{prefix}{l}"
            w[f"{p}_wih"] = f32(layer.weight_ih.t())
            w[f"{p}_whh"] = f32(layer.weight_hh.t())
            w[f"{p}_b"] = f32(layer.bias_ih + layer.bias_hh)
            for k in ("wih", "whh"):
                w[f"{p}_{k}_frag"] = tf32x3_fragments(w[f"{p}_{k}"])
    if vae.layer_norm is not None:
        w["ln_scale"] = f32(vae.layer_norm.weight)
        w["ln_bias"] = f32(vae.layer_norm.bias)
    w["mu_w"] = f32(vae.fc_mu.weight.t())
    w["mu_b"] = f32(vae.fc_mu.bias)
    w["z2h_w"] = f32(vae.fc_latent_to_hidden.weight.t())
    w["z2h_b"] = f32(vae.fc_latent_to_hidden.bias)
    w["out_w"] = f32(vae.output_layer.weight.t())
    w["out_b"] = f32(vae.output_layer.bias)
    return w


def fused_vae_gate_reference(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel: (mse [N], resid [N, T, D] | None)."""
    N, T, D = Z.shape
    H = weights["enc0_whh"].shape[0]
    Z = Z.to(torch.float32)

    def step(h, c, gates):
        i, f, g, o = gates.split(H, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    zeros = Z.new_zeros(N, H)
    hs, cs = [zeros] * num_layers, [zeros] * num_layers
    for t in range(T):
        inp = Z[:, t]
        for l in range(num_layers):
            g = (inp @ weights[f"enc{l}_wih"] + hs[l] @ weights[f"enc{l}_whh"]
                 + weights[f"enc{l}_b"])
            hs[l], cs[l] = step(hs[l], cs[l], g)
            inp = hs[l]
    h_last = hs[-1]
    if use_layernorm:
        h_last = F.layer_norm(h_last, (H,), weights["ln_scale"],
                              weights["ln_bias"], eps=1e-5)
    mu = h_last @ weights["mu_w"] + weights["mu_b"]
    dec_in = torch.tanh(mu @ weights["z2h_w"] + weights["z2h_b"])
    xp_const = dec_in @ weights["dec0_wih"] + weights["dec0_b"]   # once

    hs, cs = [zeros] * num_layers, [zeros] * num_layers
    acc = Z.new_zeros(N)
    resid = [] if with_residual else None
    for t in range(T):
        g = xp_const + hs[0] @ weights["dec0_whh"]
        hs[0], cs[0] = step(hs[0], cs[0], g)
        for l in range(1, num_layers):
            g = (hs[l - 1] @ weights[f"dec{l}_wih"]
                 + hs[l] @ weights[f"dec{l}_whh"] + weights[f"dec{l}_b"])
            hs[l], cs[l] = step(hs[l], cs[l], g)
        y_t = hs[-1] @ weights["out_w"] + weights["out_b"]
        r_t = (Z[:, t] - y_t) ** 2
        if with_residual:
            resid.append(r_t)
        acc = acc + r_t.sum(dim=1)
    mse = acc / (T * D)
    return mse, (torch.stack(resid, dim=1) if with_residual else None)


def _check(weights, Z, num_layers, use_layernorm):
    check_windows(Z)
    if num_layers not in (1, 2):
        raise ValueError("the fused kernel supports 1- or 2-layer presets")
    H = weights["enc0_whh"].shape[0]
    D = Z.shape[2]
    Zd = weights["mu_w"].shape[1]
    if H not in _HIDDEN or D > _D_MAX or Zd > _Z_MAX:
        raise ValueError(f"unsupported shape for the fused kernel: H={H} "
                         f"(need one of {_HIDDEN}), D={D} (<= {_D_MAX}), "
                         f"Z={Zd} (<= {_Z_MAX})")
    if weights["enc0_wih"].shape != (D, 4 * H):
        raise ValueError(f"enc0_wih {tuple(weights['enc0_wih'].shape)} does "
                         f"not match D={D}, H={H}")
    need = [k for k in _WEIGHT_ORDER
            if (num_layers == 2 or "1_" not in k)
            and (use_layernorm or not k.startswith("ln_"))]
    check_weights(weights, need, Z.device)
    check_fragments(weights, need)
    return need, H, Zd


@functools.cache
def _library() -> ctypes.CDLL:
    """The built kernel library with its C entries declared (built at first
    use, never at import)."""
    lib = load_library("fused_vae")
    fn = lib.shm_fused_vae_gate_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    # the probe variants of the same kernel (tools/probe_vpu_bound.py)
    fn = lib.shm_fused_vae_probe
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
                   + [ctypes.c_float, ctypes.c_void_p])
    lib.shm_fused_vae_info.restype = ctypes.c_int
    lib.shm_fused_vae_info.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def kernel_info(T: int, H: int, L: int) -> dict:
    """How the card takes the shipping kernel for windows of T steps at width
    H with L layers: registers and local-memory (spill) bytes a thread,
    threads and dynamic shared bytes a block, windows a block, blocks an SM
    at once."""
    if H not in _HIDDEN or L not in (1, 2) or T < 1:
        raise ValueError(f"unsupported shape for the fused kernel: T={T}, "
                         f"H={H}, L={L}")
    lib = _library()
    out = (ctypes.c_int * 6)()
    raise_on_error(lib, lib.shm_fused_vae_info(T, H, L, out),
                   "fused_vae_gate info")
    return dict(zip(("registers", "spill_bytes", "threads", "shared_bytes",
                     "windows_per_block", "blocks_per_sm"), out))


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
        err = lib.shm_fused_vae_gate_f32(
            Z.data_ptr(), resid.data_ptr() if with_residual else None,
            mse.data_ptr(), ptrs, len(_WEIGHT_ORDER), N, T, D, H, Zd,
            num_layers, int(use_layernorm), int(with_residual), stream)
    raise_on_error(lib, err, "fused_vae_gate")
    fused_vae_gate.launches += 1
    return mse, resid


def fused_vae_gate(
    weights: Dict[str, torch.Tensor], Z: torch.Tensor, *, num_layers: int,
    use_layernorm: bool, with_residual: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused deterministic VAE pass: (mse [N], resid [N, T, D] | None).

    ``weights`` comes from :func:`vae_params_to_kernel_weights`. A CUDA
    tensor runs the kernel; a CPU tensor runs the plain version.
    """
    return dispatch_gate("fused_vae_gate", Z, _launch,
                         fused_vae_gate_reference, weights,
                         num_layers=num_layers, use_layernorm=use_layernorm,
                         with_residual=with_residual)


# kernel launches so far; callers reset it to 0 to count one run's launches
fused_vae_gate.launches = 0


__all__ = ["fused_vae_gate", "fused_vae_gate_reference", "kernel_info",
           "vae_params_to_kernel_weights"]
