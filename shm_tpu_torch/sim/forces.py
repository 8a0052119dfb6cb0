"""Smoothed Gaussian excitation forces (counterpart of ``shm_tpu/sim/forces.py``).

White noise scaled by ``rms``, then a centred rolling mean over 0.5 s
(``window = int(0.5 / dt)`` samples, ``left = window // 2`` behind and the
rest ahead, fewer at the edges) on each DOF:

- ``smoothed_gaussian_force_np``: numpy's legacy global RNG seeded with
  ``seed``, in float64, returned as float32. The same numpy code as the JAX
  package's function, so bit for bit the same forces (``gen-normal`` and
  ``gen-faults`` use it);
- ``smoothed_gaussian_force``: the noise from a ``jax.random`` key through
  :mod:`shm_tpu_torch.sim.prng`, smoothed in float32 on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from shm_tpu_torch.device import resolve_device
from shm_tpu_torch.sim import prng


def _window_bounds(window: int):
    """Centred-window offsets: the mean covers [i - left, i + right]; an
    even window has its extra sample behind."""
    left = window // 2
    right = window - 1 - left
    return left, right


def smoothed_gaussian_force_np(
    t_total: float, dt: float, num_dofs: int, rms: float, seed: int
) -> np.ndarray:
    """float32 (steps, num_dofs) force of one run, from ``np.random.seed(seed)``."""
    np.random.seed(seed)
    steps = int(t_total / dt) + 1
    base = np.random.randn(steps, num_dofs) * rms

    window = max(int(0.5 / dt), 1)
    left, right = _window_bounds(window)
    csum = np.cumsum(np.concatenate([np.zeros((1, num_dofs)), base], axis=0), axis=0)
    i = np.arange(steps)
    lo = np.maximum(i - left, 0)
    hi = np.minimum(i + right, steps - 1)
    sums = csum[hi + 1] - csum[lo]
    cnts = (hi - lo + 1).astype(np.float64)[:, None]
    return (sums / cnts).astype(np.float32)


def _smooth(base: torch.Tensor, window: int) -> torch.Tensor:
    """Centred rolling mean along dim -2 of float32 ``base`` (..., steps, nd)."""
    steps = base.shape[-2]
    left, right = _window_bounds(window)
    zero = base.new_zeros(base.shape[:-2] + (1, base.shape[-1]))
    csum = torch.cumsum(torch.cat([zero, base], dim=-2), dim=-2)
    i = torch.arange(steps, device=base.device)
    lo = torch.clamp(i - left, min=0)
    hi = torch.clamp(i + right, max=steps - 1)
    sums = csum[..., hi + 1, :] - csum[..., lo, :]
    return sums / (hi - lo + 1).to(base.dtype)[:, None]


def smoothed_gaussian_force(
    key: np.ndarray, t_total: float, dt: float, num_dofs: int, rms: float,
    batch: Optional[int] = None, device=None,
) -> torch.Tensor:
    """float32 (steps, num_dofs), or (batch, steps, num_dofs) with ``batch``,
    from one key: the noise is ``jax.random.normal(key, shape) * rms`` of
    the JAX function (drawn on the host), the smoothing runs on ``device``
    (None = the CUDA card)."""
    device = resolve_device(device)
    steps = int(t_total / dt) + 1
    window = max(int(0.5 / dt), 1)
    shape = (steps, num_dofs) if batch is None else (batch, steps, num_dofs)
    base = prng.normal(key, shape) * np.float32(rms)
    return _smooth(torch.from_numpy(base).to(device), window)


__all__ = ["smoothed_gaussian_force", "smoothed_gaussian_force_np"]
