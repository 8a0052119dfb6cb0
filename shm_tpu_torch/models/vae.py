"""Temporal VAE (counterpart of ``shm_tpu/models/vae.py``).

Temporal encoder -> summary state [-> LayerNorm, eps 1e-5] -> fc_mu / fc_logvar
-> z -> ``tanh(fc_latent_to_hidden(z))`` fed at every step of the temporal
decoder -> linear output head. ``cell`` selects the temporal-stack family:
``"lstm"`` (default; summary = last hidden state), ``"min_gru"``
(:mod:`shm_tpu_torch.models.minrnn`) or ``"attention"``
(:mod:`shm_tpu_torch.models.attention`; summary = mean over T). The stacks
keep the attribute names ``encoder_lstm`` / ``decoder_lstm`` for every cell:
they are the checkpoint's names. ``sample=False`` decodes the posterior mean (z = mu,
deterministic scoring); ``sample=True`` decodes ``mu + eps * exp(0.5 * logvar)``
with ``eps`` given or drawn from ``generator`` (training and stochastic
validation). Dropout is active in training mode only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.models.lstm import LSTMStack, MaskArg, uniform_init_


class TemporalVAE(nn.Module):
    def __init__(self, input_dim: int = 12, latent_dim: int = 16,
                 hidden_dim: int = 128, num_layers: int = 2,
                 use_layernorm: bool = True, dropout: float = 0.0,
                 cell: str = "lstm", scan_impl: str = "sequential"):
        super().__init__()
        H, Z, D = hidden_dim, latent_dim, input_dim
        self.input_dim, self.latent_dim, self.hidden_dim = D, Z, H
        self.num_layers = num_layers
        self.use_layernorm = use_layernorm
        self.dropout = float(dropout)
        self.cell = cell
        # time-scan form for cell="min_gru"; the other cells ignore it
        self.scan_impl = scan_impl
        if cell == "lstm":
            Stack = LSTMStack
        elif cell == "min_gru":
            from shm_tpu_torch.models.minrnn import MinGRUStack

            def Stack(i, h, l, drop):
                return MinGRUStack(i, h, l, drop, scan_impl=scan_impl)
        elif cell == "attention":
            from shm_tpu_torch.models.attention import AttentionStack as Stack
        else:
            raise ValueError(f"unknown cell {cell!r} "
                             "(expected 'lstm', 'min_gru' or 'attention')")
        self.encoder_lstm = Stack(D, H, num_layers, dropout)
        # eps is torch's 1e-5, as in the JAX model (not flax's 1e-6 default)
        self.layer_norm = nn.LayerNorm(H, eps=1e-5) if use_layernorm else None
        self.fc_mu = nn.Linear(H, Z)
        self.fc_logvar = nn.Linear(H, Z)
        self.fc_latent_to_hidden = nn.Linear(Z, H)
        self.decoder_lstm = Stack(H, H, num_layers, dropout)
        self.output_layer = nn.Linear(H, D)

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh parameters, as the JAX model draws them: LSTM and minGRU
        weights and biases ~ U(+-1/sqrt(H)), the attention stack as flax
        draws it (``AttentionStack.init_parameters``); the VAE's dense kernels
        and biases ~ U(+-1/sqrt(fan_in)) (torch's ``nn.Linear`` default);
        LayerNorm at (1, 0). ``generator`` is a CPU generator; the values are
        copied to the module's device."""
        cpu = TemporalVAE(self.input_dim, self.latent_dim, self.hidden_dim,
                          self.num_layers, self.use_layernorm, self.dropout,
                          self.cell, self.scan_impl)
        for stack in (cpu.encoder_lstm, cpu.decoder_lstm):
            if self.cell == "attention":
                stack.init_parameters(generator)
            else:
                uniform_init_(stack, 1.0 / self.hidden_dim ** 0.5, generator)
        for fc in (cpu.fc_mu, cpu.fc_logvar, cpu.fc_latent_to_hidden,
                   cpu.output_layer):
            uniform_init_(fc, 1.0 / fc.in_features ** 0.5, generator)
        self.load_state_dict(cpu.state_dict())

    def encode(self, x: torch.Tensor, dropout_masks: MaskArg = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        _, h_last = self.encoder_lstm(x, dropout_masks=dropout_masks,
                                      generator=generator)
        if self.layer_norm is not None:
            h_last = self.layer_norm(h_last)
        return self.fc_mu(h_last), self.fc_logvar(h_last)

    def decode(self, z: torch.Tensor, seq_len: int,
               dropout_masks: MaskArg = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h0 = torch.tanh(self.fc_latent_to_hidden(z))               # [B, H]
        decoded, _ = self.decoder_lstm(h0, broadcast_steps=seq_len,
                                       dropout_masks=dropout_masks,
                                       generator=generator)
        return self.output_layer(decoded)                           # [B, T, D]

    def forward(self, x: torch.Tensor, sample: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[Tuple[MaskArg, MaskArg]] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(recon, mu, logvar). ``dropout_masks`` is an (encoder, decoder)
        pair of explicit inverted masks (see :class:`LSTMStack`)."""
        m_enc, m_dec = dropout_masks if dropout_masks is not None else (None, None)
        mu, logvar = self.encode(x, m_enc, generator)
        if sample:
            if eps is None:
                eps = torch.randn(mu.shape, generator=generator,
                                  device=mu.device, dtype=mu.dtype)
            z = mu + eps * torch.exp(0.5 * logvar)
        else:
            z = mu
        return self.decode(z, x.shape[1], m_dec, generator), mu, logvar


def vae_from_config(cfg: VAEConfig) -> TemporalVAE:
    return TemporalVAE(input_dim=cfg.input_dim, latent_dim=cfg.latent_dim,
                       hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                       use_layernorm=cfg.use_layernorm, dropout=cfg.dropout,
                       cell=cfg.cell)


def vae_loss(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, kl_weight,
             mask: Optional[torch.Tensor] = None,
             count: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, recon_loss, kl): total = MSE(recon, x) + w * KL, mean-reduced.

    ``mask``: per-window validity [B] of a padded batch; the masked means
    equal the unpadded reduction. ``count`` (with ``mask``): the number of
    valid windows the means divide by instead of ``mask.sum()``; a shard of
    a data-parallel batch passes the whole batch's, so that the shards'
    losses sum to the batch's.
    """
    if mask is None:
        recon_loss = torch.mean((recon - x) ** 2)
        kl = -0.5 * torch.mean(1.0 + logvar - mu ** 2 - torch.exp(logvar))
    else:
        m = mask.to(recon.dtype)
        n = m.sum() if count is None else count
        denom_r = torch.clamp(n * (x.shape[1] * x.shape[2]), min=1.0)
        recon_loss = torch.sum(((recon - x) ** 2) * m[:, None, None]) / denom_r
        denom_k = torch.clamp(n * mu.shape[1], min=1.0)
        kl_terms = (1.0 + logvar - mu ** 2 - torch.exp(logvar)) * m[:, None]
        kl = -0.5 * torch.sum(kl_terms) / denom_k
    return recon_loss + kl_weight * kl, recon_loss, kl


__all__ = ["TemporalVAE", "vae_from_config", "vae_loss"]
