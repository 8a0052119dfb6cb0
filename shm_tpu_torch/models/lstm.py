"""LSTM layers written out in plain PyTorch (counterpart of ``shm_tpu/models/lstm.py``).

This is the port's non-kernel reference path, for scoring and for training,
so it is a Python time loop under autograd and not ``torch.nn.LSTM`` (cuDNN).
Parameters use torch's own ``nn.LSTM`` naming and layout: ``weight_ih``
[4H, in], ``weight_hh`` [4H, H] with gates in i|f|g|o order, and the two
biases ``bias_ih`` and ``bias_hh`` [4H] that the JAX layer trains separately
as ``b_ih`` and ``b_hh`` (the cell adds them; the optimizer does not).

``dtype`` is the JAX layer's compute precision (``shm_tpu/models/lstm.py:
64-90``, :mod:`shm_tpu_torch.models.precision`): in bf16 the input, both
weights and the merged bias are cast to bf16, each product's result is
bf16, and the carry h, c and the gates stay bf16 at every step; the
parameters stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from shm_tpu_torch.models.precision import compute_dtype, sigmoid


def uniform_init_(module: nn.Module, bound: float,
                  generator: Optional[torch.Generator] = None) -> None:
    """Every parameter of ``module`` ~ U(-bound, bound), in place."""
    with torch.no_grad():
        for p in module.parameters():
            p.uniform_(-bound, bound, generator=generator)


class LSTMLayer(nn.Module):
    """Single LSTM layer: [B, T, D] -> outputs [B, T, H] and final (h, c).

    With ``broadcast_steps`` the input is one [B, D] vector fed at every one
    of ``broadcast_steps`` steps; its projection is computed once.
    ``dtype``: the compute precision (module docstring).
    """

    def __init__(self, input_dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        self.dtype = compute_dtype(dtype, "LSTMLayer")
        self.weight_ih = nn.Parameter(torch.empty(4 * H, input_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * H, H))
        self.bias_ih = nn.Parameter(torch.empty(4 * H))
        self.bias_hh = nn.Parameter(torch.empty(4 * H))
        uniform_init_(self, 1.0 / H ** 0.5)

    def forward(self, x: torch.Tensor, broadcast_steps: Optional[int] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        H, dt = self.hidden_dim, self.dtype
        bias = self.bias_ih + self.bias_hh
        w_hh_t = self.weight_hh.t()
        if dt == torch.float32:
            proj = lambda v: F.linear(v, self.weight_ih, bias)
        else:
            # the sum of the two biases in float32, then cast (as in JAX)
            x, w_ih, bias, w_hh_t = (t.to(dt) for t in (
                x, self.weight_ih, bias, w_hh_t))
            proj = lambda v: F.linear(v, w_ih) + bias
        if broadcast_steps is None:
            B, T, _ = x.shape
            xp = proj(x)                                          # [B, T, 4H]
        else:
            B, T = x.shape[0], broadcast_steps
            xp_const = proj(x)                                    # [B, 4H], once
        h = x.new_zeros(B, H)
        c = x.new_zeros(B, H)
        outs = []
        for t in range(T):
            xp_t = xp[:, t] if broadcast_steps is None else xp_const
            gates = xp_t + h @ w_hh_t
            i, f, g, o = gates.split(H, dim=1)
            c = sigmoid(f) * c + sigmoid(i) * torch.tanh(g)
            h = sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1), (h, c)


MaskArg = Union[None, torch.Tensor, Sequence[torch.Tensor]]


class LSTMStack(nn.Module):
    """Multi-layer LSTM; returns (outputs of the last layer, its final h).

    Inter-layer dropout has torch ``nn.LSTM`` semantics, as in the JAX stack:
    inverted dropout on every layer's output but the last, in training mode
    only. ``dropout_masks`` gives the inverted masks explicitly (one
    [B, T, H] tensor of 0 or 1/keep per layer gap; a single tensor for a
    2-layer stack), so that a test can feed both frameworks the same mask;
    without it the mask is drawn from ``generator``. ``dtype`` is every
    layer's (:class:`LSTMLayer`); the outputs are in it.
    """

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = float(dropout)
        self.dtype = compute_dtype(dtype, "LSTMStack")
        self.layers = nn.ModuleList(
            LSTMLayer(input_dim if l == 0 else hidden_dim, hidden_dim, dtype)
            for l in range(num_layers))

    def forward(self, x: torch.Tensor, broadcast_steps: Optional[int] = None,
                dropout_masks: MaskArg = None,
                generator: Optional[torch.Generator] = None):
        return run_stack(self, x, broadcast_steps, dropout_masks, generator)


def run_stack(stack: nn.Module, x: torch.Tensor,
              broadcast_steps: Optional[int], dropout_masks: MaskArg,
              generator: Optional[torch.Generator]):
    """Run the recurrent layers ``stack.layers`` one after another with the
    inter-layer dropout of ``stack.dropout``; shared by the LSTM and minGRU
    stacks. Returns (outputs of the last layer, its final h)."""
    if isinstance(dropout_masks, torch.Tensor):
        dropout_masks = [dropout_masks]
    gaps = len(stack.layers) - 1
    if dropout_masks is not None and len(dropout_masks) != gaps:
        raise ValueError(f"need {gaps} dropout masks, got "
                         f"{len(dropout_masks)}")
    out, h_last = x, None
    for l, layer in enumerate(stack.layers):
        out, (h_last, _) = layer(
            out, broadcast_steps=broadcast_steps if l == 0 else None)
        if l == gaps:
            break
        # a bf16 stack's output times the float32 mask, rounded to bf16 once
        if dropout_masks is not None:
            out = (out * dropout_masks[l]).to(out.dtype)
        elif stack.training and stack.dropout > 0.0:
            keep = 1.0 - stack.dropout
            mask = torch.rand(out.shape, generator=generator,
                              device=out.device) < keep
            out = (out * (mask.to(torch.float32) / keep)).to(out.dtype)
    return out, h_last


__all__ = ["LSTMLayer", "LSTMStack", "run_stack", "uniform_init_"]
