"""Typed, frozen configuration for the port (counterpart of ``shm_tpu/config.py``).

Only the dataclasses the ported paths read are kept: ``VAEConfig``,
``CNNConfig``, ``TrainConfig``, ``SDOFParams`` (the 1-DOF oscillator the
simulator integrates), ``Stage1DofConfig``, ``SystemConfig`` and
``FaultGenConfig`` (4DOF data generation) and ``Stage4DofConfig``. Defaults
are identical to the JAX package's.
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
    # "attention" (opt-in presets, not parity models)
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
class SDOFParams:
    """Single-DOF oscillator of the 1-DOF stage."""

    m: float = 100.0
    k: float = 1000.0
    c: float = 0.0
    x0: float = 0.01
    v0: float = 0.0
    t_total: float = 30.0
    dt: float = 0.01


@dataclass(frozen=True)
class Stage1DofConfig:
    """1-DOF stage: signal variants, windowing, the half-and-half split and
    the no-LayerNorm VAE preset."""

    sdof: SDOFParams = field(default_factory=SDOFParams)
    # seen variants: drift, amplitude-scaled, time-stretched (low-frequency)
    drift_rate: float = 0.001
    amp_scale: float = 1.5
    lowfreq_factor: float = 0.6
    # unseen variants: analytic signals at this amplitude and frequency
    unseen_amplitude: float = 0.01
    unseen_base_freq_hz: float = 0.33
    seq_len: int = 80
    stride: int = 1
    train_frac: float = 0.5
    segment_len: int = 100
    vae: VAEConfig = field(
        default_factory=lambda: VAEConfig(
            input_dim=12, latent_dim=5, hidden_dim=32, num_layers=2,
            dropout=0.2, use_layernorm=False,
        )
    )
    train: TrainConfig = field(
        default_factory=lambda: TrainConfig(
            epochs=100, batch_size=64, lr=1e-3, weight_decay=0.0,
            grad_clip=0.0, kl_warmup_ratio=0.30,
        )
    )


@dataclass(frozen=True)
class SystemConfig:
    """N-DOF chain system of the 4DOF stage."""

    mass: Tuple[float, ...] = (60.0, 50.0, 50.0, 40.0)
    stiffness: Tuple[float, ...] = (300000.0, 240000.0, 200000.0, 160000.0)
    damping_ratio: float = 0.02
    beta: float = 0.25
    gamma: float = 0.5
    num_dofs: int = 4
    dt: float = 0.01
    t_total: float = 10.0

    @property
    def steps(self) -> int:
        return int(self.t_total / self.dt) + 1


@dataclass(frozen=True)
class FaultGenConfig:
    """Fault run generation (``gen-faults``)."""

    force_rms: float = 200.0
    force_seed: int = 42
    # structural faults: the stiffness scaled by each factor (10-40 %)
    stiffness_scales: Tuple[float, ...] = (0.9, 0.8, 0.7, 0.6)
    # ``--legacy-faults``: the regime of the reference's committed data tree
    # (stiff_red_{8,9,18,19,30,40}pct), whose mild cases do not saturate
    # the gate
    legacy_stiffness_scales: Tuple[float, ...] = (0.92, 0.91, 0.82, 0.81,
                                                  0.70, 0.60)
    # sensor faults, each on one DOF triplet, magnitude relative to the
    # channel's std
    noise_rel_mag: float = 0.50     # on DOF 4
    spikes_rel_mag: float = 5.00    # on DOF 1, 1% of samples
    spikes_freq: float = 0.01
    drift_rel_mag: float = 10.0     # on DOF 2
    bias_rel_mag: float = 2.00      # on DOF 3


@dataclass(frozen=True)
class Stage4DofConfig:
    """4DOF stage: data generation, windowing, per-run time-fraction splits
    and models."""

    system: SystemConfig = field(default_factory=SystemConfig)
    faults: FaultGenConfig = field(default_factory=FaultGenConfig)
    # normal runs (gen-normal): per-run mass/stiffness jitter and damping
    n_normal_runs: int = 10
    base_seed: int = 2025
    normal_force_rms: float = 50.0
    jitter_lo: float = 0.98
    jitter_hi: float = 1.02
    zeta_lo: float = 0.015
    zeta_hi: float = 0.025
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


__all__ = ["VAEConfig", "CNNConfig", "TrainConfig", "SDOFParams",
           "Stage1DofConfig", "SystemConfig", "FaultGenConfig",
           "Stage4DofConfig", "replace"]
