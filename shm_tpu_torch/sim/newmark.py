"""Newmark-beta structural dynamics (counterpart of ``shm_tpu/sim/newmark.py``).

Plain PyTorch on the device, float32 throughout, as the JAX package runs
with x64 off. The JAX package integrates with ``lax.scan`` under ``vmap``
and no Pallas kernel; here a batch of R runs steps together through one
Python time loop of batched 4x4 products (``einsum`` of [R, n, n] by
[R, n]), with no host synchronisation inside the loop. Products run in full
float32 on the card: call :func:`shm_tpu_torch.device.set_full_f32_precision`
first (the commands do), or cuBLAS may use TF32.

- 1-DOF free vibration (:func:`simulate_free_vibration_sdof`): scalar
  Newmark steps from ``(x0, v0)``;
- N-DOF chain (:func:`compute_matrices`, :func:`newmark_ndof`,
  :func:`simulate_runs`): M diagonal, K of the chain's springs, Rayleigh
  damping fitted to the first two modes from the eigenvalues of
  ``M^-1/2 K M^-1/2``; zero initial state, a0 from equilibrium; the
  explicit inverse of ``K_eff`` and the +-1e5 clip of every state, as the
  JAX functions have them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from shm_tpu_torch.config import SDOFParams, SystemConfig
from shm_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# 1-DOF free vibration
# ---------------------------------------------------------------------------


def simulate_free_vibration_sdof(p: SDOFParams = SDOFParams(), device=None):
    """Free vibration of a single-DOF oscillator: float32 ``(t, x, v, a)``
    on ``device`` (None = the CUDA card), ``t`` the grid
    ``arange(0, t_total + dt, dt)``. Every constant is a float32 scalar, as
    the JAX function's traced arguments are."""
    device = resolve_device(device)
    t = torch.from_numpy(np.arange(0.0, p.t_total + p.dt, p.dt,
                                   dtype=np.float32)).to(device)
    n = int(t.shape[0])
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    m, k, c, x0, v0, dt = map(f32, (p.m, p.k, p.c, p.x0, p.v0, p.dt))
    beta, gamma = f32(0.25), f32(0.5)

    a0 = (-k * x0 - c * v0) / m
    k_eff = m / (beta * dt ** 2) + gamma * c / (beta * dt) + k
    c0 = 1.0 / (beta * dt ** 2)
    c1 = 1.0 / (beta * dt)
    c2 = 1.0 / (2.0 * beta) - 1.0

    x, v, a = x0, v0, a0
    xs, vs, accs = [x], [v], [a]
    for _ in range(n - 1):
        b = m * (c0 * x + c1 * v + c2 * a) - c * (v + (1.0 - gamma) * dt * a)
        x_n = b / k_eff
        a_n = c0 * (x_n - x) - c1 * v - c2 * a
        v_n = v + dt * ((1.0 - gamma) * a + gamma * a_n)
        x, v, a = x_n, v_n, a_n
        xs.append(x)
        vs.append(v)
        accs.append(a)
    return t, torch.stack(xs), torch.stack(vs), torch.stack(accs)


# ---------------------------------------------------------------------------
# N-DOF chain system
# ---------------------------------------------------------------------------


def chain_stiffness_matrix(k: torch.Tensor) -> torch.Tensor:
    """Chain stiffness from the spring constants (..., nd) -> (..., nd, nd):
    ``K = diag(k_i + k_{i+1}) - offdiag(k_{i+1})``, with ``k_{nd+1} = 0``."""
    k_next = torch.cat([k[..., 1:], torch.zeros_like(k[..., :1])], dim=-1)
    off = -k[..., 1:]
    return (torch.diag_embed(k + k_next) + torch.diag_embed(off, 1)
            + torch.diag_embed(off, -1))


def rayleigh_damping(M: torch.Tensor, K: torch.Tensor, zeta) -> torch.Tensor:
    """Rayleigh damping ``C = alpha M + beta K`` (batched over leading dims)
    whose damping ratio is ``zeta`` at the first two natural frequencies,
    from ``eigvalsh(M^-1/2 K M^-1/2)`` (M diagonal); alpha floored at 0,
    beta at 1e-4."""
    inv_sqrt_m = 1.0 / torch.sqrt(torch.diagonal(M, dim1=-2, dim2=-1))
    A = inv_sqrt_m[..., :, None] * K * inv_sqrt_m[..., None, :]
    omegas = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(A), min=1e-12))
    o1, o2 = omegas[..., 0], omegas[..., 1]
    Amat = torch.stack([torch.stack([1.0 / (2 * o1), o1 / 2], dim=-1),
                        torch.stack([1.0 / (2 * o2), o2 / 2], dim=-1)], dim=-2)
    z = torch.as_tensor(zeta, dtype=Amat.dtype, device=Amat.device)
    z = z[..., None].expand(Amat.shape[:-1])
    ab = torch.linalg.solve(Amat, z)
    alpha = torch.clamp(ab[..., 0], min=0.0)
    beta = torch.clamp(ab[..., 1], min=1e-4)
    return alpha[..., None, None] * M + beta[..., None, None] * K


def compute_matrices(m: torch.Tensor, k: torch.Tensor, zeta
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(M, C, K) of chain systems, batched over the leading dims of
    ``m``, ``k`` (..., nd) and ``zeta`` (...)."""
    M = torch.diag_embed(m)
    K = chain_stiffness_matrix(k)
    return M, rayleigh_damping(M, K, zeta), K


def newmark_ndof(M: torch.Tensor, C: torch.Tensor, K: torch.Tensor,
                 force: torch.Tensor, dt: float, beta: float = 0.25,
                 gamma: float = 0.5, clip: float = 1e5) -> torch.Tensor:
    """Newmark-beta integration of ``M a + C v + K x = F(t)``.

    ``M``, ``C``, ``K``: (nd, nd), or (R, nd, nd) for R runs at once;
    ``force``: (steps, nd) or (R, steps, nd). Returns (steps, 3 nd), or
    (R, steps, 3 nd), laid out ``[x | v | a]``.
    """
    if M.dim() == 2:
        return newmark_ndof(M[None], C[None], K[None], force[None], dt, beta,
                            gamma, clip)[0]
    R, nd = M.shape[0], M.shape[-1]
    steps = force.shape[1]
    mv = lambda A, x: torch.einsum("rij,rj->ri", A, x)

    a0c = 1.0 / (beta * dt ** 2)
    a1c = gamma / (beta * dt)
    a2c = 1.0 / (beta * dt)
    a3c = 1.0 / (2.0 * beta) - 1.0
    a4c = gamma / beta - 1.0
    a5c = (dt / 2.0) * (gamma / beta - 2.0)

    K_eff_inv = torch.linalg.inv(a0c * M + a1c * C + K)
    M_inv = torch.linalg.inv(M)

    x = force.new_zeros(R, nd)
    v = force.new_zeros(R, nd)
    a = torch.nan_to_num(mv(M_inv, force[:, 0] - mv(C, v) - mv(K, x)), nan=0.0)
    out = force.new_empty(3, steps, R, nd)
    out[0, 0], out[1, 0], out[2, 0] = x, v, a
    F = force.transpose(0, 1)                                 # [steps, R, nd]
    for t in range(1, steps):
        P = (F[t] + mv(M, a0c * x + a2c * v + a3c * a)
             + mv(C, a1c * x + a4c * v + a5c * a))
        x_n = mv(K_eff_inv, P)
        a_n = a0c * (x_n - x) - a2c * v - a3c * a
        v_n = v + dt * ((1.0 - gamma) * a + gamma * a_n)
        x = torch.clamp(x_n, -clip, clip)
        v = torch.clamp(v_n, -clip, clip)
        a = torch.clamp(a_n, -clip, clip)
        out[0, t], out[1, t], out[2, t] = x, v, a
    return out.permute(2, 1, 0, 3).reshape(R, steps, 3 * nd)


def simulate_runs(mass, stiffness, zeta, forces, cfg: SystemConfig = SystemConfig(),
                  device=None) -> torch.Tensor:
    """Integrate R runs at once on ``device`` (None = the CUDA card).

    mass, stiffness: (R, nd); zeta: (R,); forces: (R, steps, nd), numpy or
    tensors, taken as float32. Returns float32 (R, steps, 3 nd).
    """
    device = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32).to(device)
    M, C, K = compute_matrices(f32(mass), f32(stiffness), f32(zeta))
    return newmark_ndof(M, C, K, f32(forces), cfg.dt, cfg.beta, cfg.gamma)


__all__ = [
    "simulate_free_vibration_sdof",
    "chain_stiffness_matrix",
    "rayleigh_damping",
    "compute_matrices",
    "newmark_ndof",
    "simulate_runs",
]
