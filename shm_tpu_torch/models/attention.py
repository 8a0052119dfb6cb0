"""Attention (transformer) temporal stack (counterpart of
``shm_tpu/models/attention.py``), the opt-in ``cell="attention"`` family.

Pre-LN blocks (LayerNorm -> multi-head self-attention -> residual; LayerNorm
-> tanh-GELU MLP -> residual), a closing LayerNorm, fixed sinusoidal
positions, and the encoder summary = mean over T. The arithmetic is the flax
modules', which differs from torch's own layers in three places:

- LayerNorm inside the stack has eps 1e-6 and the variance
  ``E[x^2] - E[x]^2`` clamped at 0 (:func:`flax_layer_norm`);
- the query is scaled by ``1/sqrt(head_dim)`` AFTER its bias is added;
- GELU is the tanh approximation.

Parameters are plain ``nn.Linear`` / scale-bias pairs in torch's [out, in]
layout (flax ``query/key/value.kernel`` [H, heads, hd] -> weight
[heads*hd, H]; ``out.kernel`` [heads, hd, H] -> weight [H, heads*hd]), not
``nn.MultiheadAttention``.

``dtype`` is the JAX modules' compute precision (``shm_tpu/models/
attention.py:87-103``, :121-152; :mod:`shm_tpu_torch.models.precision`). In
bf16 every dense layer (``in_proj``, q, k, v, ``out``, the MLP's two) runs as
flax's ``nn.Dense(dtype=bf16)``; each LayerNorm computes in float32 and
rounds its output to bf16 (flax's float32 statistics); the attention is
flax's ``MultiHeadDotProductAttention(dtype=bf16)`` with its default
``force_fp32_for_softmax=False``: the query divided by ``sqrt(head_dim)``
rounded to bf16, the scores, the softmax (its sum in float32, rounded) and
P.V in bf16; GELU, the residual sums and the mean over T in bf16. The
sinusoidal table stays float32 until it is cast to bf16 and added. The
parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from shm_tpu_torch.models.precision import (compute_dtype, dense, gelu_tanh,
                                            norm, softmax)

HEAD_DIM = 32       # head size at every preset width (128 -> 4 heads, 32 -> 1)
STACK_LN_EPS = 1e-6  # flax LayerNorm default: the stack's internal norms


def sinusoidal_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Fixed sin/cos positional encoding [seq_len, dim], float32:
    ``pe[t, 2i] = sin(t / 10000^(2i/dim))``, ``pe[t, 2i+1] = cos(...)``."""
    half = (dim + 1) // 2
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    inv_freq = torch.exp(
        -math.log(10000.0)
        * (2.0 * torch.arange(half, dtype=torch.float32, device=device)) / dim
    )[None, :]
    ang = pos * inv_freq                                          # [T, half]
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)    # [T, half, 2]
    return pe.reshape(seq_len, 2 * half)[:, :dim]


def flax_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm over the last dim as flax computes it: variance
    ``mean(x^2) - mean(x)^2`` clamped at 0."""
    mean = x.mean(dim=-1, keepdim=True)
    mean2 = (x * x).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class FlaxLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = STACK_LN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flax_layer_norm(x, self.weight, self.bias, self.eps)


class TransformerBlock(nn.Module):
    """Pre-LN transformer encoder block over [B, T, H]. Dropout (training
    mode only) sits on the attention weights and after ``out`` and
    ``mlp_out``. As flax's ``MultiHeadDotProductAttention`` draws it
    (``broadcast_dropout=True``), the attention weights' mask is one
    [1, 1, T, T] draw a call, shared by every window and head; the two
    residual masks are drawn at full [B, T, H] shape. The draws come from
    ``generator`` in that order, or are given (``masks``, as
    :meth:`draw_dropout_masks` draws them)."""

    def __init__(self, hidden_dim: int, num_heads: int, dropout: float = 0.0,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = hidden_dim
        if H % num_heads:
            raise ValueError(f"hidden_dim {H} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.dropout = float(dropout)
        self.dtype = compute_dtype(dtype, "TransformerBlock")
        self.attn_norm = FlaxLayerNorm(H)
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)
        self.out = nn.Linear(H, H)
        self.mlp_norm = FlaxLayerNorm(H)
        self.mlp_in = nn.Linear(H, mlp_ratio * H)
        self.mlp_out = nn.Linear(mlp_ratio * H, H)

    def draw_dropout_masks(self, B: int, T: int, generator, device):
        """This block's keep masks for a [B, T, H] input, drawn as its
        forward draws them: the attention weights' [1, 1, T, T], then the
        two residual masks [B, T, H] (boolean)."""
        keep = 1.0 - self.dropout
        H = self.out.out_features
        return tuple(torch.rand(shape, generator=generator, device=device)
                     < keep for shape in ((1, 1, T, T), (B, T, H), (B, T, H)))

    def _drop(self, x: torch.Tensor, generator, shape=None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inverted dropout of ``x`` with one keep mask of ``shape`` (default
        ``x.shape``; drawn from ``generator`` unless given), broadcast over
        the rest."""
        if not self.training or self.dropout <= 0.0:
            return x
        keep = 1.0 - self.dropout
        if mask is None:
            mask = torch.rand(x.shape if shape is None else shape,
                              generator=generator, device=x.device) < keep
        return x * (mask.to(x.dtype) / keep)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                masks: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> torch.Tensor:
        m_w, m_a, m_m = masks if masks is not None else (None, None, None)
        if self.dtype != torch.float32:
            return self._forward_cast(x, generator, m_w, m_a, m_m)
        B, T, H = x.shape
        heads = self.num_heads
        hd = H // heads
        h = self.attn_norm(x)
        split = lambda t: t.view(B, T, heads, hd).transpose(1, 2)  # [B,h,T,hd]
        q = split(self.query(h)) / math.sqrt(hd)
        k, v = split(self.key(h)), split(self.value(h))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)          # [B,h,T,T]
        w = self._drop(w, generator, (1, 1, T, T), m_w)
        h = self.out((w @ v).transpose(1, 2).reshape(B, T, H))
        x = x + self._drop(h, generator, mask=m_a)
        h = self.mlp_out(F.gelu(self.mlp_in(self.mlp_norm(x)),
                                approximate="tanh"))
        return x + self._drop(h, generator, mask=m_m)

    def _forward_cast(self, x, generator, m_w, m_a, m_m) -> torch.Tensor:
        """The forward in ``self.dtype`` with flax's semantics (module
        docstring); ``x`` is already in it."""
        dt = self.dtype
        B, T, H = x.shape
        heads = self.num_heads
        hd = H // heads
        h = norm(self.attn_norm, x, dt)
        split = lambda t: t.view(B, T, heads, hd).transpose(1, 2)  # [B,h,T,hd]
        q = split(dense(self.query, h, dt)) / torch.tensor(
            math.sqrt(hd), dtype=torch.float32).to(dt)
        k, v = split(dense(self.key, h, dt)), split(dense(self.value, h, dt))
        w = softmax(q @ k.transpose(-1, -2))                        # [B,h,T,T]
        w = self._drop(w, generator, (1, 1, T, T), m_w)
        h = dense(self.out, (w @ v).transpose(1, 2).reshape(B, T, H), dt)
        x = x + self._drop(h, generator, mask=m_a)
        h = dense(self.mlp_in, norm(self.mlp_norm, x, dt), dt)
        h = dense(self.mlp_out, gelu_tanh(h), dt)
        return x + self._drop(h, generator, mask=m_m)


class AttentionStack(nn.Module):
    """Transformer stack with the temporal-stack interface of
    :class:`shm_tpu_torch.models.lstm.LSTMStack`: returns (out [B, T, H],
    summary [B, H]); the summary is the mean over T. With
    ``broadcast_steps`` the input is one [B, D] vector: it is projected once
    and broadcast over T, and the positions tell the steps apart.

    ``num_heads=None`` derives ``max(1, hidden_dim // 32)``. ``dtype``: the
    compute precision of every layer (module docstring); the outputs are in
    it.
    """

    def __init__(self, input_dim: int, hidden_dim: int, num_layers: int = 1,
                 dropout: float = 0.0, num_heads: Optional[int] = None,
                 mlp_ratio: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        H = hidden_dim
        self.hidden_dim = H
        self.num_heads = num_heads or max(1, H // HEAD_DIM)
        self.mlp_ratio = mlp_ratio
        self.dropout = float(dropout)
        self.dtype = compute_dtype(dtype, "AttentionStack")
        self.in_proj = nn.Linear(input_dim, H)
        self.layers = nn.ModuleList(
            TransformerBlock(H, self.num_heads, dropout, mlp_ratio, dtype)
            for _ in range(num_layers))
        self.final_norm = FlaxLayerNorm(H)

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh parameters as flax draws them: every kernel from a normal
        of variance 1/fan_in truncated at two standard deviations
        (``lecun_normal``), biases 0, LayerNorm at (1, 0)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    std = (1.0 / m.in_features) ** 0.5 / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    m.bias.zero_()
                elif isinstance(m, FlaxLayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def draw_dropout_masks(self, B: int, T: int, generator, device) -> list:
        """The stack's keep masks for a batch of B windows of T steps, one
        (attention weights, residual, residual) triple a block
        (:meth:`TransformerBlock.draw_dropout_masks`), drawn in the order
        its training forward draws them from ``generator``: passed back as
        ``dropout_masks``, the forward runs with the same masks (a
        data-parallel trainer slices the residual ones by shard)."""
        return [block.draw_dropout_masks(B, T, generator, device)
                for block in self.layers]

    def forward(self, x: torch.Tensor, broadcast_steps: Optional[int] = None,
                dropout_masks: Optional[list] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(out, summary). ``dropout_masks``: one keep-mask triple a block
        (:meth:`draw_dropout_masks`), else training mode draws them from
        ``generator``."""
        if dropout_masks is not None and (
                not isinstance(dropout_masks, (list, tuple))
                or len(dropout_masks) != len(self.layers)):
            raise ValueError(f"the attention stack takes one keep-mask "
                             f"triple a block ({len(self.layers)}, as "
                             "draw_dropout_masks draws them)")
        dt = self.dtype
        tok = self.in_proj(x) if dt == torch.float32 else dense(self.in_proj, x, dt)
        T = x.shape[1] if broadcast_steps is None else broadcast_steps
        if broadcast_steps is not None:
            tok = tok[:, None, :].expand(-1, T, -1)
        out = tok + sinusoidal_positions(T, self.hidden_dim, x.device).to(dt)[None]
        for i, block in enumerate(self.layers):
            out = block(out, generator,
                        None if dropout_masks is None else dropout_masks[i])
        out = (self.final_norm(out) if dt == torch.float32
               else norm(self.final_norm, out, dt))
        return out, out.mean(dim=1)


__all__ = ["AttentionStack", "TransformerBlock", "FlaxLayerNorm",
           "flax_layer_norm", "sinusoidal_positions", "HEAD_DIM",
           "STACK_LN_EPS"]
