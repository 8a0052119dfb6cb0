"""Temporal LSTM-VAE, deterministic inference (counterpart of ``shm_tpu/models/vae.py``).

LSTM encoder -> last hidden state [-> LayerNorm, eps 1e-5] -> fc_mu / fc_logvar
-> z = mu -> ``tanh(fc_latent_to_hidden(z))`` fed at every step of the LSTM
decoder -> linear output head. Only the LSTM cell and ``sample=False`` are
ported; the sampled path belongs to training.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.models.lstm import LSTMStack


class TemporalVAE(nn.Module):
    def __init__(self, input_dim: int = 12, latent_dim: int = 16,
                 hidden_dim: int = 128, num_layers: int = 2,
                 use_layernorm: bool = True):
        super().__init__()
        H, Z, D = hidden_dim, latent_dim, input_dim
        self.input_dim, self.latent_dim, self.hidden_dim = D, Z, H
        self.num_layers = num_layers
        self.use_layernorm = use_layernorm
        self.encoder_lstm = LSTMStack(D, H, num_layers)
        # eps is torch's 1e-5, as in the JAX model (not flax's 1e-6 default)
        self.layer_norm = nn.LayerNorm(H, eps=1e-5) if use_layernorm else None
        self.fc_mu = nn.Linear(H, Z)
        self.fc_logvar = nn.Linear(H, Z)
        self.fc_latent_to_hidden = nn.Linear(Z, H)
        self.decoder_lstm = LSTMStack(H, H, num_layers)
        self.output_layer = nn.Linear(H, D)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, h_last = self.encoder_lstm(x)
        if self.layer_norm is not None:
            h_last = self.layer_norm(h_last)
        return self.fc_mu(h_last), self.fc_logvar(h_last)

    def decode(self, z: torch.Tensor, seq_len: int) -> torch.Tensor:
        h0 = torch.tanh(self.fc_latent_to_hidden(z))               # [B, H]
        decoded, _ = self.decoder_lstm(h0, broadcast_steps=seq_len)
        return self.output_layer(decoded)                           # [B, T, D]

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(recon, mu, logvar), decoding the posterior mean (z = mu)."""
        mu, logvar = self.encode(x)
        return self.decode(mu, x.shape[1]), mu, logvar


def vae_from_config(cfg: VAEConfig) -> TemporalVAE:
    if cfg.cell != "lstm":
        raise NotImplementedError(
            f"cell={cfg.cell!r} is not ported yet (LSTM cell only)")
    return TemporalVAE(input_dim=cfg.input_dim, latent_dim=cfg.latent_dim,
                       hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                       use_layernorm=cfg.use_layernorm)


__all__ = ["TemporalVAE", "vae_from_config"]
