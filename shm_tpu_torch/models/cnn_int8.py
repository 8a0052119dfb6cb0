"""Post-training int8 quantization of the 4DOF attribution CNN, for inference
(counterpart of ``shm_tpu/models/cnn_int8.py``; not wired into the
pipeline, as in the JAX package).

The scheme is the JAX package's, step for step:

- **BatchNorm folding**: inference BatchNorm is an affine map per channel,
  folded into the preceding convolution exactly (W' = W * g/sqrt(v+eps),
  b' = (b - m) * g/sqrt(v+eps) + beta).
- **conv1 stays float**, in ``dtype`` (bf16 by default): its input channel 1
  is the squared VAE residual, whose heavy tail 8-bit input quantization
  does not survive.
- **conv2 / fc1 / fc2 weights**: symmetric int8 with one scale per output
  column (max|W'| / 127).
- **Activations**: one dynamic symmetric scale per window (max|h_n| / 127).
  A window's scale factors out of its products exactly, so 8-bit rounding
  within the window is the only error.
- **Products**: int8 x int8 summed exactly in int32: on the card through
  ``torch._int_mm`` (cuBLAS; rows padded to at least 17 and the depth and
  width to multiples of 8, as it requires), on the CPU through an int32
  matrix product. Rounding is half to even, as ``jnp.round``'s.

Everything runs in the JAX package's NHWC layout: the weights come from the
port's :class:`~shm_tpu_torch.models.cnn.CNN4DOF` through
``convert.cnn4dof_to_flax`` (the JAX variables' layout) or from flax
variables directly, so the codes and scales are the JAX module's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

_BN_EPS = 1e-5      # CNN4DOF's BatchNorm epsilon


def _t(a) -> torch.Tensor:
    """A float32 CPU tensor copy of an array (numpy, JAX or torch)."""
    return torch.tensor(np.asarray(a, np.float32))


def _fold_bn(kernel, bias, bn_p: Mapping, bn_s: Mapping
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """An inference BatchNorm (scale / bias, running mean / var) folded into
    the preceding convolution's kernel [..., cout] and bias [cout]."""
    s = _t(bn_p["scale"]) * torch.rsqrt(_t(bn_s["var"]) + _BN_EPS)
    return _t(kernel) * s, (_t(bias) - _t(bn_s["mean"])) * s + _t(bn_p["bias"])


def _quant_w(w2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-column int8 quantization of a [K, cout] float32 matrix:
    (codes int8, scale float32 [cout])."""
    scale = torch.clamp(w2d.abs().amax(dim=0), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w2d / scale), -127, 127).to(torch.int8)
    return q, scale


@dataclass
class QuantCNN4DOF:
    """Folded conv1 (float) and int8 conv2 / fc1 / fc2, on one device."""

    k1: torch.Tensor          # float [18, 16] folded conv1 im2col weights
    b1: torch.Tensor          # f32   [16]
    w2: torch.Tensor          # int8  [144, 32] (3*3*16, BN2 folded)
    s2: torch.Tensor          # f32   [32]      weight scale per cout
    b2: torch.Tensor          # f32   [32]
    wf1: torch.Tensor         # int8  [2400, 128] (rows in NHWC order t, d, c)
    sf1: torch.Tensor         # f32   [128]
    bf1: torch.Tensor         # f32   [128]
    wf2: torch.Tensor         # int8  [128, num_classes]
    sf2: torch.Tensor         # f32   [num_classes]
    bf2: torch.Tensor         # f32   [num_classes]

    def to(self, device) -> "QuantCNN4DOF":
        return QuantCNN4DOF(**{k: getattr(self, k).to(device)
                               for k in self.__dataclass_fields__})


def _im2col(x: torch.Tensor, kt: int = 3, kw: int = 3) -> torch.Tensor:
    """SAME-padded [B, T, D, cin] -> [B, T, D, kt*kw*cin] patches, (i, j)
    major and cin minor (the JAX module's order)."""
    B, T, D, cin = x.shape
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kt // 2, kt // 2))
    return torch.cat([xp[:, i:i + T, j:j + D, :]
                      for i in range(kt) for j in range(kw)], dim=-1)


def _q_sample(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window symmetric quantization over every axis but the first:
    (int8 x_q, float32 scale [B]) with x ~= x_q * scale."""
    a = torch.clamp(x.reshape(x.shape[0], -1).abs().amax(dim=1),
                    min=1e-12) / 127.0
    sh = (x.shape[0],) + (1,) * (x.dim() - 1)
    q = torch.clamp(torch.round(x / a.reshape(sh)), -127, 127).to(torch.int8)
    return q, a


def _mm_i8(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 [..., K] x int8 [K, N] -> exact int32 [..., N]: ``torch._int_mm``
    on the card (rows padded to at least 17, K and N to multiples of 8, as
    it requires), an int32 product on the CPU (|sum| <= 127^2 K < 2^31)."""
    lead, (K, N) = a.shape[:-1], w.shape
    a2 = a.reshape(-1, K)
    M = a2.shape[0]
    if a.device.type == "cuda":
        Kp, Np, Mp = -(-K // 8) * 8, -(-N // 8) * 8, max(M, 17)
        ap = F.pad(a2, (0, Kp - K, 0, Mp - M)).contiguous()
        wp = F.pad(w, (0, Np - N, 0, Kp - K)).contiguous()
        out = torch._int_mm(ap, wp)[:M, :N]
    else:
        out = a2.to(torch.int32) @ w.to(torch.int32)
    return out.reshape(*lead, N)


def _pool22(h: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID, of NHWC [B, T, D, C]."""
    return F.max_pool2d(h.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def quantize_cnn4dof(cnn: Union[Mapping, "torch.nn.Module"],
                     dtype: torch.dtype = torch.bfloat16,
                     seq_len: int = 100, num_features: int = 12
                     ) -> QuantCNN4DOF:
    """Quantize a trained CNN4DOF: a port :class:`CNN4DOF` (its windows of
    ``seq_len`` x ``num_features``) or the JAX model's flax variables
    (``{"params", "batch_stats"}``). No calibration data: the activation
    scales are per window at inference. ``dtype`` is the float conv1's
    compute and storage type (bf16, as the JAX package serves it; float32
    for the equivalence tests). On the CPU; move it with ``.to(device)``."""
    if isinstance(cnn, torch.nn.Module):
        from shm_tpu_torch.convert import cnn4dof_to_flax

        cnn = cnn4dof_to_flax(cnn, seq_len, num_features)
    p, bs = cnn["params"], cnn["batch_stats"]
    k1, b1 = _fold_bn(p["conv1"]["kernel"], p["conv1"]["bias"], p["bn1"],
                      bs["bn1"])
    k2, b2 = _fold_bn(p["conv2"]["kernel"], p["conv2"]["bias"], p["bn2"],
                      bs["bn2"])
    w2, s2 = _quant_w(k2.reshape(-1, k2.shape[-1]))
    wf1, sf1 = _quant_w(_t(p["fc1"]["kernel"]))
    wf2, sf2 = _quant_w(_t(p["fc2"]["kernel"]))
    return QuantCNN4DOF(
        k1=k1.reshape(-1, k1.shape[-1]).to(dtype), b1=b1, w2=w2, s2=s2, b2=b2,
        wf1=wf1, sf1=sf1, bf1=_t(p["fc1"]["bias"]),
        wf2=wf2, sf2=sf2, bf2=_t(p["fc2"]["bias"]))


@torch.inference_mode()
def cnn4dof_int8_apply(q: QuantCNN4DOF, xin: torch.Tensor) -> torch.Tensor:
    """The quantized forward: NHWC [N, T, D, 2] float input -> [N, classes]
    float32 logits. conv1 runs in ``q.k1``'s type with a float32 sum and
    result; conv2 / fc1 / fc2 run int8 x int8 -> int32 with per-window
    activation scales."""
    # operands in k1's type, their exact products summed in float32
    h = _im2col(xin.to(q.k1.dtype)).float() @ q.k1.float() + q.b1
    h = _pool22(torch.relu(h))
    xq, a = _q_sample(h)
    h = (_mm_i8(_im2col(xq), q.w2).float() * (q.s2 * a[:, None, None, None])
         + q.b2)
    h = _pool22(torch.relu(h))
    h = h.reshape(h.shape[0], -1)                        # [N, 2400], NHWC
    xq, a = _q_sample(h)
    h = torch.relu(_mm_i8(xq, q.wf1).float() * (q.sf1 * a[:, None]) + q.bf1)
    xq, a = _q_sample(h)
    return _mm_i8(xq, q.wf2).float() * (q.sf2 * a[:, None]) + q.bf2


@torch.inference_mode()
def cnn4dof_folded_apply(cnn: Union[Mapping, "torch.nn.Module"],
                         xin: torch.Tensor, seq_len: int = 100,
                         num_features: int = 12) -> torch.Tensor:
    """The BatchNorm-folded float32 forward (the float network the quantized
    one approximates), on ``xin``'s device: the folding's reference."""
    if isinstance(cnn, torch.nn.Module):
        from shm_tpu_torch.convert import cnn4dof_to_flax

        cnn = cnn4dof_to_flax(cnn, seq_len, num_features)
    p, bs = cnn["params"], cnn["batch_stats"]
    dev = xin.device
    k1, b1 = _fold_bn(p["conv1"]["kernel"], p["conv1"]["bias"], p["bn1"],
                      bs["bn1"])
    k2, b2 = _fold_bn(p["conv2"]["kernel"], p["conv2"]["bias"], p["bn2"],
                      bs["bn2"])
    mm = lambda x, k: x @ k.reshape(-1, k.shape[-1]).to(dev)
    h = torch.relu(mm(_im2col(xin.float()), k1) + b1.to(dev))
    h = _pool22(h)
    h = _pool22(torch.relu(mm(_im2col(h), k2) + b2.to(dev)))
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ _t(p["fc1"]["kernel"]).to(dev) + _t(p["fc1"]["bias"]).to(dev))
    return h @ _t(p["fc2"]["kernel"]).to(dev) + _t(p["fc2"]["bias"]).to(dev)


__all__ = ["QuantCNN4DOF", "quantize_cnn4dof", "cnn4dof_int8_apply",
           "cnn4dof_folded_apply"]
