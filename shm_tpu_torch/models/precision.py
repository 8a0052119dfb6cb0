"""The compute precision of the plain modules: the JAX modules' ``dtype``
(flax's rule, ``shm_tpu/models/vae.py:21``: "compute precision; params stay
fp32").

A module of ``dtype=torch.bfloat16`` keeps float32 parameters and casts
them, and its input, to bf16 where flax's layers cast them:

- a dense layer (:func:`dense`, flax's ``nn.Dense(dtype=)``): input, kernel
  and bias in bf16, the product's result in bf16 (summed in float32 and
  rounded once), then the bias added in bf16;
- a norm (:func:`norm`, flax's ``nn.LayerNorm`` / ``nn.GroupNorm(dtype=)``):
  statistics and normalisation in float32 from the bf16 input, the result
  rounded to bf16 once;
- every other operation on bf16 tensors, each result rounded to bf16, in
  the JAX package's formulas: :func:`sigmoid` ``1 / (1 + exp(-x))`` (XLA's
  bf16 logistic), :func:`gelu_tanh` and :func:`silu` as ``jax.nn`` writes
  them, :func:`softmax` as ``jax.nn.softmax`` (its sum in float32, rounded),
  their constants rounded to bf16 first. torch's own bf16 activations
  compute in float32 and round once, which rounds another way.

float32 is the default everywhere and keeps the float32 modules' own
arithmetic; any other type raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = (torch.float32, torch.bfloat16)


def compute_dtype(dtype: torch.dtype, who: str) -> torch.dtype:
    """``dtype`` if it is float32 or bfloat16, else ``ValueError``."""
    if dtype not in DTYPES:
        raise ValueError(f"{who} computes in float32 or bfloat16, got {dtype}")
    return dtype


def dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` as flax's ``nn.Dense(dtype=dtype)`` computes it: the
    product of ``x`` and the kernel cast to ``dtype``, its result in
    ``dtype``, then the bias cast to ``dtype`` added."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype (rounded to it first, as
    JAX rounds a constant to the array's type)."""
    return torch.tensor(v, dtype=torch.float64).to(like.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``torch.sigmoid`` in float32; in bf16 ``1 / (1 + exp(-x))`` with
    every operation rounded (what XLA computes for a bf16 logistic)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``F.silu`` in float32; in bf16 ``x * sigmoid(x)`` (``jax.nn.silu``)."""
    return F.silu(x) if x.dtype == torch.float32 else x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU: ``F.gelu(approximate="tanh")`` in float32; in bf16
    ``jax.nn.gelu(approximate=True)``'s formula, ``x * 0.5 * (1 + tanh(
    sqrt(2/pi) (x + 0.044715 x^3)))``, every operation rounded."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    inner = _const(math.sqrt(2 / math.pi), x) * (
        x + _const(0.044715, x) * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def softmax(s: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim: ``torch.softmax`` in float32; in bf16
    ``jax.nn.softmax``'s ``exp(s - max) / sum``, the sum taken in float32
    and rounded."""
    if s.dtype == torch.float32:
        return torch.softmax(s, dim=-1)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True, dtype=torch.float32).to(s.dtype)


def norm(fn, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``fn`` (a norm) of ``x`` computed in float32 and cast to ``dtype``,
    as flax's norms with ``dtype`` compute (float32 statistics)."""
    return fn(x.to(torch.float32)).to(dtype)


__all__ = ["DTYPES", "compute_dtype", "dense", "norm", "sigmoid", "silu",
           "gelu_tanh", "softmax"]
