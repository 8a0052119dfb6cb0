"""1-DOF signal variants, seen and unseen (counterpart of ``shm_tpu/sim/signals.py``).

Each generator returns a dict of 12 named float32 channels on the device of
its inputs; :func:`variants_to_matrix` stacks them into the (T, 12) column
order of the stage's CSVs. Every constant multiplies a float32 tensor as a
float32 scalar, in the JAX functions' order of operations, so the two
packages differ only where their ``sin`` / ``arcsin`` round differently.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

SEEN_COLUMNS = [
    "x_original", "x_drift", "x_amplitude_scaled", "x_lowfreq",
    "v_original", "v_drift", "v_amplitude_scaled", "v_lowfreq",
    "a_original", "a_drift", "a_amplitude_scaled", "a_lowfreq",
]

UNSEEN_COLUMNS = [
    "x_original", "x_envelope", "x_triangle", "x_square",
    "v_original", "v_envelope", "v_triangle", "v_square",
    "a_original", "a_envelope", "a_triangle", "a_square",
]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: piecewise-linear ``fp`` over the sorted
    grid ``xp`` at ``x``, constant beyond either end. The same steps as JAX:
    ``i = clip(searchsorted(xp, x, side="right"), 1, len(xp) - 1)``, then
    ``fp[i-1] + (x - xp[i-1]) / dx * (fp[i] - fp[i-1])``, with a zero-width
    interval (``|dx| <= spacing(eps)``) giving ``fp[i-1]``. The last
    multiply-add is one fused operation (``addcmul``), as XLA contracts it."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # np.spacing(eps): eps is a power of two, so its spacing is eps ** 2
    dx0 = dx.abs() <= torch.finfo(xp.dtype).eps ** 2
    q = delta / torch.where(dx0, torch.ones_like(dx), dx)
    f = torch.where(dx0, fp[i - 1], torch.addcmul(fp[i - 1], q, df))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def make_clean_variants(
    t: torch.Tensor,
    x: torch.Tensor,
    v: torch.Tensor,
    a: torch.Tensor,
    drift_rate: float = 0.001,
    amp_scale: float = 1.5,
    lowfreq_factor: float = 0.6,
) -> Dict[str, torch.Tensor]:
    """Four variants per channel: original / drift / amplitude-scaled /
    low-frequency, the last the series time-stretched, ``y(alpha t)`` by
    linear interpolation."""
    if not (0.0 < lowfreq_factor <= 1.0):
        raise ValueError(f"lowfreq_factor must be in (0, 1], got {lowfreq_factor}")
    t_scaled = t * lowfreq_factor
    out: Dict[str, torch.Tensor] = {}
    for name, y in (("x", x), ("v", v), ("a", a)):
        out[f"{name}_original"] = y
        out[f"{name}_drift"] = y + drift_rate * t
        out[f"{name}_amplitude_scaled"] = y * amp_scale
        out[f"{name}_lowfreq"] = interp(t_scaled, t, y)
    return out


def _triangle_wave(t: torch.Tensor, f: float) -> torch.Tensor:
    return (2.0 / math.pi) * torch.arcsin(torch.sin(2.0 * math.pi * f * t))


def _square_wave(t: torch.Tensor, f: float) -> torch.Tensor:
    return torch.sign(torch.sin(2.0 * math.pi * f * t))


def _gradient(y: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """``np.gradient`` of a uniform grid: central differences, one-sided at
    the two edges."""
    fwd = (y[1] - y[0]) / dt
    bwd = (y[-1] - y[-2]) / dt
    mid = (y[2:] - y[:-2]) / (2.0 * dt)
    return torch.cat([fwd[None], mid, bwd[None]])


def make_unseen_variants(
    t: torch.Tensor,
    amplitude: float = 0.01,
    base_freq_hz: float = 0.33,
) -> Dict[str, torch.Tensor]:
    """Four analytic displacements (sinusoid, enveloped sinusoid, triangle,
    square) at ``amplitude``; velocity and acceleration by
    :func:`_gradient` applied once and twice."""
    w = 2.0 * math.pi * base_freq_hz
    x_ori = amplitude * torch.sin(w * t)
    env = 0.5 * (1.0 + torch.sin(0.2 * w * t))
    x_env = amplitude * env * torch.sin(w * t)
    x_tri = amplitude * _triangle_wave(t, base_freq_hz)
    x_sqr = amplitude * _square_wave(t, base_freq_hz)

    dt = t[1] - t[0]
    out: Dict[str, torch.Tensor] = {}
    for name, xsig in (("original", x_ori), ("envelope", x_env),
                       ("triangle", x_tri), ("square", x_sqr)):
        vsig = _gradient(xsig, dt)
        out[f"x_{name}"] = xsig
        out[f"v_{name}"] = vsig
        out[f"a_{name}"] = _gradient(vsig, dt)
    return out


def variants_to_matrix(variants: Dict[str, torch.Tensor],
                       columns: Sequence[str]) -> torch.Tensor:
    """Stack named channels into a (T, F) matrix in the given column order."""
    return torch.stack([variants[c] for c in columns], dim=1)


__all__ = [
    "SEEN_COLUMNS",
    "UNSEEN_COLUMNS",
    "interp",
    "make_clean_variants",
    "make_unseen_variants",
    "variants_to_matrix",
]
