"""LSTM layers written out in plain PyTorch (counterpart of ``shm_tpu/models/lstm.py``).

This is the port's non-kernel reference path, so it is a Python time loop and
not ``torch.nn.LSTM`` (cuDNN). Parameters use torch's layout: ``weight_ih``
[4H, in], ``weight_hh`` [4H, H] with gates in i|f|g|o order, and one
``bias`` [4H] holding the JAX layer's ``b_ih + b_hh``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class LSTMLayer(nn.Module):
    """Single LSTM layer: [B, T, D] -> outputs [B, T, H] and final (h, c).

    With ``broadcast_steps`` the input is one [B, D] vector fed at every one
    of ``broadcast_steps`` steps; its projection is computed once.
    """

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        self.weight_ih = nn.Parameter(torch.empty(4 * H, input_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * H, H))
        self.bias = nn.Parameter(torch.empty(4 * H))
        bound = 1.0 / H ** 0.5
        for p in (self.weight_ih, self.weight_hh, self.bias):
            nn.init.uniform_(p, -bound, bound)

    def forward(self, x: torch.Tensor, broadcast_steps: Optional[int] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        H = self.hidden_dim
        if broadcast_steps is None:
            B, T, _ = x.shape
            xp = F.linear(x, self.weight_ih, self.bias)           # [B, T, 4H]
        else:
            B, T = x.shape[0], broadcast_steps
            xp_const = F.linear(x, self.weight_ih, self.bias)     # [B, 4H], once
        h = x.new_zeros(B, H)
        c = x.new_zeros(B, H)
        w_hh_t = self.weight_hh.t()
        outs = []
        for t in range(T):
            xp_t = xp[:, t] if broadcast_steps is None else xp_const
            gates = xp_t + h @ w_hh_t
            i, f, g, o = gates.split(H, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1), (h, c)


class LSTMStack(nn.Module):
    """Multi-layer LSTM; returns (outputs of the last layer, its final h).

    Inference only: the inter-layer dropout of the JAX stack is not applied.
    """

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1):
        super().__init__()
        self.layers = nn.ModuleList(
            LSTMLayer(input_dim if l == 0 else hidden_dim, hidden_dim)
            for l in range(num_layers))

    def forward(self, x: torch.Tensor, broadcast_steps: Optional[int] = None):
        out, h_last = x, None
        for l, layer in enumerate(self.layers):
            out, (h_last, _) = layer(
                out, broadcast_steps=broadcast_steps if l == 0 else None)
        return out, h_last


__all__ = ["LSTMLayer", "LSTMStack"]
