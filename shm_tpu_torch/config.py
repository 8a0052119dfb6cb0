"""Typed, frozen configuration for the port (counterpart of ``shm_tpu/config.py``).

Only the dataclasses the ported 4DOF paths read are kept: ``VAEConfig``,
``CNNConfig``, ``TrainConfig`` and the windowing / split / threshold / model /
training fields of ``Stage4DofConfig``. Defaults are identical to the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class VAEConfig:
    """Temporal-VAE hyperparameters (4DOF preset by default)."""

    input_dim: int = 12
    latent_dim: int = 16
    hidden_dim: int = 128
    num_layers: int = 2
    dropout: float = 0.3
    use_layernorm: bool = True
    # temporal-stack family: "lstm" (reference parity), "min_gru" or
    # "attention" (opt-in presets; scoring only, their training is not ported)
    cell: str = "lstm"


@dataclass(frozen=True)
class CNNConfig:
    """CNN classifier hyperparameters."""

    variant: str = "4dof"
    input_channels: int = 2
    num_classes: int = 2
    dropout: float = 0.5
    seq_len: int = 100
    num_features: int = 12


@dataclass(frozen=True)
class TrainConfig:
    """Shared optimizer/loop settings."""

    seed: int = 42
    epochs: int = 50
    batch_size: int = 256
    lr: float = 1e-3
    weight_decay: float = 1e-5
    grad_clip: float = 2.0
    kl_warmup_ratio: float = 0.30
    early_stop_patience: int = 0  # 0 disables early stopping
    decoupled_wd: bool = False    # False = torch Adam L2 coupling; True = AdamW


@dataclass(frozen=True)
class Stage4DofConfig:
    """4DOF stage: windowing, per-run time-fraction splits and models."""

    seq_len: int = 100
    num_features: int = 12
    stride: int = 1
    train_frac: Tuple[float, float] = (0.0, 0.4)
    val_frac: Tuple[float, float] = (0.4, 0.7)
    test_frac: Tuple[float, float] = (0.7, 1.0)
    threshold_percentile: float = 99.0
    vae: VAEConfig = field(
        default_factory=lambda: VAEConfig(
            input_dim=12, latent_dim=16, hidden_dim=128, num_layers=2,
            dropout=0.3, use_layernorm=True,
        )
    )
    vae_train: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            epochs=50, batch_size=256, lr=1e-3, weight_decay=1e-5,
            grad_clip=2.0, kl_warmup_ratio=0.30,
        )
    )
    cnn: CNNConfig = field(
        default_factory=lambda: CNNConfig(
            variant="4dof", input_channels=2, num_classes=2, dropout=0.5,
            seq_len=100, num_features=12,
        )
    )
    cnn_train: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            epochs=50, batch_size=100, lr=1e-4, weight_decay=5e-5,
            grad_clip=0.0, early_stop_patience=15,
        )
    )


def replace(cfg, **kw):
    """dataclasses.replace passthrough for config overrides."""
    return dataclasses.replace(cfg, **kw)


__all__ = ["VAEConfig", "CNNConfig", "TrainConfig", "Stage4DofConfig",
           "replace"]
