"""minGRU temporal stack (counterpart of ``shm_tpu/models/minrnn.py``).

The opt-in ``cell="min_gru"`` family ("Were RNNs All We Needed?", Feng et al.,
arXiv:2410.01201): gate and candidate depend on the input only,

    z_t  = sigmoid(W_z x_t + b_z)
    h~_t = W_h x_t + b_h
    h_t  = (1 - z_t) * h_{t-1} + z_t * h~_t,        h_0 = 0

so a layer is one projection over all steps and a first-order linear
recurrence ``h_t = a_t h_{t-1} + b_t`` with ``a = 1 - z``, ``b = z * h~``.
Parameters use torch's layout: ``weight_ih`` [2H, in] and ``bias_ih`` [2H],
the z half first (the transposes of the flax ``w_ih`` / ``b_ih``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shm_tpu_torch.models.lstm import MaskArg, run_stack, uniform_init_


def linear_recurrence(a: torch.Tensor, b: torch.Tensor, *,
                      impl: str = "sequential") -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` with ``h_0 = 0``, along dim 0.

    ``a`` / ``b``: [T, ...] elementwise coefficients. ``"sequential"`` is a
    time loop of one multiply-add per step; ``"associative"`` composes the
    affine maps ``(a2, b2) o (a1, b1) = (a1 * a2, a2 * b1 + b2)`` in log2(T)
    doubling passes. Both are exact: the same float32 operations in another
    association order.
    """
    if impl == "sequential":
        h = torch.zeros_like(a[0])
        hs = []
        for t in range(a.shape[0]):
            h = a[t] * h + b[t]
            hs.append(h)
        return torch.stack(hs)
    if impl == "associative":
        A, Bc, d = a, b, 1
        while d < a.shape[0]:
            # element t composes with the prefix that ends at t - d
            Bc = torch.cat([Bc[:d], A[d:] * Bc[:-d] + Bc[d:]])
            A = torch.cat([A[:d], A[d:] * A[:-d]])
            d *= 2
        return Bc
    raise ValueError(f"unknown linear_recurrence impl {impl!r}")


class MinGRULayer(nn.Module):
    """Single minGRU layer: [B, T, D] -> outputs [B, T, H] and (h_T, h_T).

    With ``broadcast_steps`` the input is one [B, D] vector fed at every one
    of ``broadcast_steps`` steps: the projection is computed once, the
    coefficients are constant over T, and h still sweeps from 0 toward h~.
    """

    def __init__(self, input_dim: int, hidden_dim: int,
                 scan_impl: str = "sequential"):
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        self.scan_impl = scan_impl
        self.weight_ih = nn.Parameter(torch.empty(2 * H, input_dim))
        self.bias_ih = nn.Parameter(torch.empty(2 * H))
        uniform_init_(self, 1.0 / H ** 0.5)

    def forward(self, x: torch.Tensor, broadcast_steps: Optional[int] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        H = self.hidden_dim
        g = F.linear(x, self.weight_ih, self.bias_ih)    # [B, (T,) 2H]
        if broadcast_steps is None:
            g = g.transpose(0, 1)                         # [T, B, 2H]
        z = torch.sigmoid(g[..., :H])
        a, b = 1.0 - z, z * g[..., H:]
        if broadcast_steps is not None:
            T = broadcast_steps
            a, b = a.expand(T, *a.shape), b.expand(T, *b.shape)
        hs = linear_recurrence(a, b, impl=self.scan_impl)  # [T, B, H]
        return hs.transpose(0, 1), (hs[-1], hs[-1])


class MinGRUStack(nn.Module):
    """Multi-layer minGRU with the stack interface of
    :class:`shm_tpu_torch.models.lstm.LSTMStack`: returns (outputs of the
    last layer, its final h); inverted dropout on every layer's output but
    the last, in training mode only (or the explicit ``dropout_masks``)."""

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 dropout: float = 0.0, scan_impl: str = "sequential"):
        super().__init__()
        self.dropout = float(dropout)
        self.layers = nn.ModuleList(
            MinGRULayer(input_dim if l == 0 else hidden_dim, hidden_dim,
                        scan_impl)
            for l in range(num_layers))

    def forward(self, x: torch.Tensor, broadcast_steps: Optional[int] = None,
                dropout_masks: MaskArg = None,
                generator: Optional[torch.Generator] = None):
        return run_stack(self, x, broadcast_steps, dropout_masks, generator)


__all__ = ["MinGRULayer", "MinGRUStack", "linear_recurrence"]
