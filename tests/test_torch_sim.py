"""The port's simulators (``shm_tpu_torch/sim``) against the JAX package's on
the CPU, at full length (1,001 steps of the 4DOF chain, 3,001 of the 1-DOF
oscillator). Both run float32; tolerances are stated where used.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu import sim as J
from shm_tpu.config import SDOFParams as JaxSDOFParams
from shm_tpu.config import SystemConfig as JaxSystemConfig
from shm_tpu.sim.faults import SENSOR_FAULT_CASES as JAX_CASES
from shm_tpu_torch import sim as P
from shm_tpu_torch.config import SDOFParams, SystemConfig
from shm_tpu_torch.sim import prng

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SYS = SystemConfig()
MASS = np.array(SYS.mass)
STIFF = np.array(SYS.stiffness)
# per channel, max |port - jax| over max |jax|: two float32 Newmark runs of
# 1,001 steps whose 4x4 products and eigenvalues sum in other orders; the
# port reads <= 4.7e-5 on the 10 normal runs (the JAX package on the CPU
# against its own TPU-made CSVs: <= 1.03e-4)
CHANNEL_RTOL = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(got - ref).max(axis=-2) / np.abs(ref).max(axis=-2)).max())


def test_force_np_is_bit_exact_with_jax():
    for seed in (42, 2025, 2034):
        got = P.smoothed_gaussian_force_np(10.0, 0.01, 4, 50.0, seed)
        ref = J.smoothed_gaussian_force_np(10.0, 0.01, 4, 50.0, seed)
        assert got.dtype == np.float32 and got.shape == (1001, 4)
        assert np.array_equal(got, ref)
    # an even and an odd window, and dt larger than the window
    for dt in (0.02, 0.03, 1.0):
        assert np.array_equal(P.smoothed_gaussian_force_np(5.0, dt, 2, 1.0, 3),
                              J.smoothed_gaussian_force_np(5.0, dt, 2, 1.0, 3))


@pytest.mark.parametrize("batch", [None, 3])
def test_keyed_force_matches_jax(batch):
    """The noise within 4 float32 ulps (tests/test_torch_sim_prng.py), then
    a float32 cumulative sum over 1,001 steps in another order: within
    4e-6 of the force's max (measured 4.3e-7)."""
    got = P.smoothed_gaussian_force(prng.PRNGKey(7), 10.0, 0.01, 4, 50.0,
                                    batch=batch, device="cpu").numpy()
    ref = np.asarray(J.smoothed_gaussian_force(jax.random.PRNGKey(7), 10.0,
                                               0.01, 4, 50.0, batch=batch))
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 4e-6 * np.abs(ref).max()


def test_matrices_match_jax():
    m = torch.tensor(MASS, dtype=torch.float32)
    k = torch.tensor(STIFF, dtype=torch.float32)
    Mj, Cj, Kj = J.compute_matrices(jnp.asarray(MASS, jnp.float32),
                                    jnp.asarray(STIFF, jnp.float32), 0.02)
    M, C, K = P.compute_matrices(m, k, 0.02)
    assert torch.equal(K, P.chain_stiffness_matrix(k))
    assert np.array_equal(K.numpy(), np.asarray(Kj))
    assert np.array_equal(M.numpy(), np.asarray(Mj))
    # eigvalsh and the 2x2 solve in float32: rtol 1e-6 of the largest entry
    assert np.abs(C.numpy() - np.asarray(Cj)).max() <= 1e-6 * np.abs(np.asarray(Cj)).max()
    # batched over runs with their own damping ratios
    zs = np.array([0.015, 0.02, 0.025], np.float32)
    Mb, Cb, Kb = P.compute_matrices(m.expand(3, 4), k.expand(3, 4), torch.from_numpy(zs))
    for i, z in enumerate(zs):
        _, Ci, _ = P.compute_matrices(m, k, float(z))
        torch.testing.assert_close(Cb[i], Ci, rtol=1e-6, atol=0)
    # the floors: a stiff, light chain asks for a negative alpha
    _, Cf, _ = P.compute_matrices(m, k * 1e4, 1e-6)
    _, Cfj, _ = J.compute_matrices(jnp.asarray(MASS, jnp.float32),
                                   jnp.asarray(STIFF * 1e4, jnp.float32), 1e-6)
    np.testing.assert_allclose(Cf.numpy(), np.asarray(Cfj), rtol=1e-5)


def _normal_batch(R=4):
    rng = np.random.default_rng(2025)
    mass = MASS * rng.uniform(0.98, 1.02, (R, 4))
    stiff = STIFF * rng.uniform(0.98, 1.02, (R, 4))
    zeta = rng.uniform(0.015, 0.025, R)
    forces = np.stack([P.smoothed_gaussian_force_np(10.0, 0.01, 4, 50.0, 2025 + i)
                       for i in range(R)])
    return mass, stiff, zeta, forces


def test_simulate_runs_matches_jax_at_full_length():
    mass, stiff, zeta, forces = _normal_batch()
    got = P.simulate_runs(mass, stiff, zeta, forces, SYS, device="cpu")
    ref = np.asarray(J.simulate_runs(mass, stiff, zeta, forces, JaxSystemConfig()))
    assert got.shape == ref.shape == (4, 1001, 12) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) <= CHANNEL_RTOL
    assert (got[:, 0, :8] == 0).all()                 # zero initial state


def test_newmark_single_run_equals_batched_and_jax():
    """One run alone equals its row of a batch bit for bit (the same float32
    operations), and the JAX integrator within CHANNEL_RTOL."""
    mass, stiff, zeta, forces = _normal_batch(3)
    batched = P.simulate_runs(mass, stiff, zeta, forces, SYS, device="cpu")
    for i in range(3):
        f32 = lambda a: torch.tensor(a, dtype=torch.float32)
        M, C, K = P.compute_matrices(f32(mass[i]), f32(stiff[i]), f32(zeta[i]))
        one = P.newmark_ndof(M, C, K, torch.from_numpy(forces[i]), SYS.dt)
        assert torch.equal(one, batched[i])
        Mj, Cj, Kj = J.compute_matrices(*(jnp.asarray(a, jnp.float32) for a in
                                          (mass[i], stiff[i], zeta[i])))
        ref = J.newmark_ndof(Mj, Cj, Kj, jnp.asarray(forces[i]), SYS.dt)
        assert _rel(one.numpy()[None], np.asarray(ref)[None]) <= CHANNEL_RTOL


def test_newmark_clips_a_runaway_state():
    """An unstable step (negative stiffness) grows until the +-1e5 clip."""
    M = torch.eye(2)
    K = -1e4 * torch.eye(2)
    F = torch.ones(200, 2)
    out = P.newmark_ndof(M, torch.zeros(2, 2), K, F, 0.01)
    ref = np.asarray(J.newmark_ndof(jnp.eye(2), jnp.zeros((2, 2)), -1e4 * jnp.eye(2),
                                    jnp.ones((200, 2)), 0.01))
    assert float(out.abs().max()) == 1e5 and float(np.abs(ref).max()) == 1e5
    assert np.array_equal(out.numpy() == 1e5, ref == 1e5)


def test_sdof_free_vibration_matches_jax():
    """3,001 undamped float32 steps: the phase error grows with time, and
    the JAX package's own float32 run sits 4.9e-4 (x) to 8.8e-4 (a) of each
    signal's max from the float64 recurrence; the port within 2e-3 of the
    JAX run (measured 2.7e-4 / 2.8e-4 / 9.6e-4). The time grid exactly."""
    t, x, v, a = (np.asarray(q) for q in J.simulate_free_vibration_sdof(JaxSDOFParams()))
    tp, xp, vp, ap = P.simulate_free_vibration_sdof(SDOFParams(), device="cpu")
    assert np.array_equal(tp.numpy(), t) and tp.dtype == torch.float32
    for got, ref in ((xp, x), (vp, v), (ap, a)):
        assert got.shape == ref.shape == (3001,) and got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() <= 2e-3 * np.abs(ref).max()
    assert float(xp[0]) == np.float32(0.01) and float(vp[0]) == 0.0


@pytest.fixture(scope="module")
def nominal():
    """A committed healthy run, the run each injector corrupts here."""
    return np.loadtxt(ROOT / "data/4dof/raw/normal/normal_seed2025.csv",
                      delimiter=",", skiprows=1, dtype=np.float32)


def test_fault_cases_are_jax_s():
    assert P.SENSOR_FAULT_CASES == JAX_CASES
    assert P.FAULT_KINDS == ("noise", "spikes", "drift", "bias")


@pytest.mark.parametrize("case", range(4))
def test_sensor_fault_triplet_matches_jax(nominal, case):
    """Each case on the committed run, keyed as gen-faults keys it
    (fold_in(PRNGKey(42), case)): only the DOF's three channels change;
    every channel within 1e-6 of its max (the noise within 4 ulps, the std
    in another summation order; measured <= 1.9e-7); the spike positions
    exactly JAX's."""
    name, kind, dof, rel = P.SENSOR_FAULT_CASES[case]
    got = P.inject_sensor_fault_triplet(
        prng.fold_in(prng.PRNGKey(42), case), torch.from_numpy(nominal), kind,
        dof, rel).numpy()
    ref = np.asarray(J.inject_sensor_fault_triplet(
        jax.random.fold_in(jax.random.PRNGKey(42), case), jnp.asarray(nominal),
        kind, dof, rel))
    cols = [dof - 1, 4 + dof - 1, 8 + dof - 1]
    rest = [c for c in range(12) if c not in cols]
    assert np.array_equal(got[:, rest], nominal[:, rest])
    assert np.all(np.abs(got - ref).max(axis=0) <= 1e-6 * np.abs(ref).max(axis=0))
    if kind == "spikes":
        for c in cols:
            hit = np.nonzero(got[:, c] != nominal[:, c])[0]
            assert len(hit) == 10
            assert np.array_equal(hit, np.nonzero(ref[:, c] != nominal[:, c])[0])


def test_each_injector_against_jax(nominal):
    x = nominal[:, 0]
    k, kj = prng.PRNGKey(5), jax.random.PRNGKey(5)
    t = torch.from_numpy(x)
    close = lambda a, b: (np.abs(a - np.asarray(b)).max()
                          <= 1e-6 * np.abs(np.asarray(b)).max())
    assert close(P.inject_noise(k, t, 0.3).numpy(), J.inject_noise(kj, jnp.asarray(x), 0.3))
    sp = P.inject_spikes(k, t, 2.0, 0.05).numpy()
    spj = np.asarray(J.inject_spikes(kj, jnp.asarray(x), 2.0, 0.05))
    assert close(sp, spj) and np.array_equal(sp != x, spj != x)
    assert (sp != x).sum() == 50
    assert np.array_equal(P.inject_drift(t, 3.0).numpy(),
                          np.asarray(J.inject_drift(jnp.asarray(x), 3.0)))
    assert np.array_equal(P.inject_bias(t, 3.0).numpy(),
                          np.asarray(J.inject_bias(jnp.asarray(x), 3.0)))
    for n in (1, 2, 3, 1001):
        assert np.array_equal(P.faults.linspace01(n, t).numpy(),
                              np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_flat_channel_takes_a_std_of_one(nominal):
    run = torch.from_numpy(nominal).clone()
    run[:, 2] = 0.0
    out = P.inject_sensor_fault_triplet(prng.PRNGKey(0), run, "bias", 3, 2.0)
    assert torch.equal(out[:, 2], torch.full((1001,), 2.0))
    with pytest.raises(ValueError, match="unknown fault kind"):
        P.inject_sensor_fault_triplet(prng.PRNGKey(0), run, "dropout", 3, 2.0)
