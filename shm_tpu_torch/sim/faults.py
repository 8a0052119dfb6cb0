"""Sensor-fault injectors (counterpart of ``shm_tpu/sim/faults.py``).

Each injector corrupts one channel of a run, a float32 tensor on any
device; the arithmetic runs there. The randomness comes from ``jax.random``
keys as the JAX package draws it, reproduced on the host by
:mod:`shm_tpu_torch.sim.prng` (a key is its uint32 (2,) array), so a key
gives the same faults in both packages: noise within a few float32 ulps,
spike positions exactly. Magnitudes are ``rel_mag * std(channel)`` with
``ddof=1`` and a std of 0 taken as 1. Structural faults are runs simulated
again with scaled stiffness (``cli/stage4dof.py::cmd_gen_faults``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from shm_tpu_torch.sim import prng


def _host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


def inject_noise(key: np.ndarray, x: torch.Tensor, magnitude) -> torch.Tensor:
    """Additive Gaussian noise of std ``magnitude``."""
    return x + magnitude * _host(prng.normal(key, tuple(x.shape)), x)


def inject_spikes(key: np.ndarray, x: torch.Tensor, magnitude,
                  freq: float = 0.01) -> torch.Tensor:
    """Spikes ~ N(magnitude, magnitude / 4) added at ``int(n * freq)``
    distinct samples of the (n,) channel ``x``: the first slots of a random
    permutation."""
    n = x.shape[0]
    k = int(n * freq)
    kperm, kmag = prng.split(key)
    hit = torch.zeros(n, dtype=torch.bool, device=x.device)
    hit[torch.from_numpy(prng.permutation(kperm, n)[:k].astype(np.int64))
        .to(x.device)] = True
    mags = magnitude + (magnitude / 4.0) * _host(prng.normal(kmag, (n,)), x)
    return torch.where(hit, x + mags, x)


def linspace01(n: int, like: torch.Tensor) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` in float32 as XLA computes it: ``i``
    times the float32 reciprocal of ``n - 1``, the last point exactly 1."""
    if n < 2:
        return like.new_zeros(n)
    step = torch.tensor(1.0, dtype=torch.float32) / (n - 1)
    ramp = torch.arange(n, dtype=torch.float32) * step
    ramp[-1] = 1.0
    return ramp.to(device=like.device, dtype=like.dtype)


def inject_drift(x: torch.Tensor, magnitude) -> torch.Tensor:
    """A linear drift from 0 to ``magnitude`` over the (n,) channel."""
    return x + linspace01(x.shape[0], x) * magnitude


def inject_bias(x: torch.Tensor, magnitude) -> torch.Tensor:
    """A constant offset."""
    return x + magnitude


FAULT_KINDS = ("noise", "spikes", "drift", "bias")


def inject_sensor_fault_triplet(
    key: np.ndarray,
    run: torch.Tensor,       # (T, 3*nd) laid out [x | v | a]
    kind: str,
    dof: int,                # 1-based
    rel_mag: float,
    num_dofs: int = 4,
    spikes_freq: float = 0.01,
) -> torch.Tensor:
    """A copy of ``run`` with the (x, v, a) channels of DOF ``dof``
    corrupted by ``kind``, each channel with its own key of
    ``split(key, 3)`` and the magnitude ``rel_mag * std`` (``ddof=1``; a
    std of 0 counts as 1)."""
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}")
    cols = [dof - 1, num_dofs + dof - 1, 2 * num_dofs + dof - 1]
    out = run.clone()
    for c, k in zip(cols, prng.split(key, len(cols))):
        ch = run[:, c]
        std = torch.std(ch, correction=1)
        mag = torch.where(std > 0, std, torch.ones_like(std)) * rel_mag
        if kind == "noise":
            new = inject_noise(k, ch, mag)
        elif kind == "spikes":
            new = inject_spikes(k, ch, mag, spikes_freq)
        elif kind == "drift":
            new = inject_drift(ch, mag)
        else:
            new = inject_bias(ch, mag)
        out[:, c] = new
    return out


# the four sensor-fault runs: name -> (kind, corrupted DOF, relative magnitude)
SENSOR_FAULT_CASES: Tuple[Tuple[str, str, int, float], ...] = (
    ("noise_x4", "noise", 4, 0.50),
    ("spikes_x1", "spikes", 1, 5.00),
    ("drift_x2", "drift", 2, 10.0),
    ("bias_x3", "bias", 3, 2.00),
)


__all__ = [
    "inject_noise",
    "inject_spikes",
    "inject_drift",
    "inject_bias",
    "inject_sensor_fault_triplet",
    "linspace01",
    "SENSOR_FAULT_CASES",
    "FAULT_KINDS",
]
