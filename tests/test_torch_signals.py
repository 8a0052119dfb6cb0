"""The port's 1-DOF signal variants (``shm_tpu_torch/sim/signals.py``) against
the JAX package's (``shm_tpu/sim/signals.py``), both on the CPU in float32,
from the same numpy-made inputs. Tolerances are stated where they are used.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.sim import signals as jsig
from shm_tpu_torch.sim import signals as sig

torch.set_num_threads(1)

# the oscillator's float32 time grid, as both packages build it
T_GRID = np.arange(0.0, 30.0 + 0.01, 0.01, dtype=np.float32)


def _both(fn_port, fn_jax, *arrays, **kw):
    got = fn_port(*(torch.from_numpy(a) for a in arrays), **kw)
    ref = fn_jax(*(jnp.asarray(a) for a in arrays), **kw)
    return got, ref


def test_columns_are_the_jax_package_s():
    assert sig.SEEN_COLUMNS == jsig.SEEN_COLUMNS
    assert sig.UNSEEN_COLUMNS == jsig.UNSEEN_COLUMNS


@pytest.mark.parametrize("where", ["grid", "off_grid", "beyond", "stretched"])
def test_interp_matches_jnp_interp(where):
    """At grid points, between them, beyond both ends (the end values), and
    at 0.6 t as the low-frequency variant asks. The same searchsorted side,
    clipping and lerp in float32: equal bit for bit."""
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(0.0, 10.0, 200)).astype(np.float32)
    fp = rng.normal(size=200).astype(np.float32)
    if where == "grid":
        x = xp.copy()
    elif where == "off_grid":
        x = rng.uniform(xp[0], xp[-1], 500).astype(np.float32)
    elif where == "beyond":
        x = np.array([-5.0, xp[0] - 1e-3, xp[0], xp[-1], xp[-1] + 1e-3, 50.0],
                     np.float32)
    else:
        xp, fp = T_GRID, np.sin(T_GRID).astype(np.float32)
        x = T_GRID * np.float32(0.6)
    got, ref = _both(sig.interp, jnp.interp, x, xp, fp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_interp_zero_width_interval_takes_the_left_value():
    """A repeated grid point (dx = 0) gives fp[i-1], as JAX's guard does."""
    xp = np.array([0.0, 1.0, 1.0, 2.0], np.float32)
    fp = np.array([0.0, 10.0, 20.0, 30.0], np.float32)
    x = np.array([0.5, 1.0, 1.5, 2.0], np.float32)
    got, ref = _both(sig.interp, jnp.interp, x, xp, fp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.isfinite(got.numpy()).all()


def test_seen_variants_every_channel():
    """make_clean_variants of one numpy-made (t, x, v, a): every channel
    within 1e-7 relative to its peak (elementwise float32 on both sides; the
    interpolation equal bit for bit above)."""
    rng = np.random.default_rng(0)
    t = T_GRID
    x, v, a = (np.cumsum(rng.normal(size=(3, t.size)), axis=1) * 1e-3).astype(np.float32)
    got, ref = _both(sig.make_clean_variants, jsig.make_clean_variants, t, x, v, a,
                     drift_rate=0.001, amp_scale=1.5, lowfreq_factor=0.6)
    assert set(got) == set(sig.SEEN_COLUMNS) == set(ref)
    for c in sig.SEEN_COLUMNS:
        r = np.asarray(ref[c])
        assert np.abs(got[c].numpy() - r).max() <= 1e-7 * np.abs(r).max(), c
    M = sig.variants_to_matrix(got, sig.SEEN_COLUMNS).numpy()
    np.testing.assert_array_equal(M, np.stack([got[c].numpy() for c in sig.SEEN_COLUMNS], 1))


@pytest.mark.parametrize("factor", [0.0, 1.5])
def test_lowfreq_factor_out_of_range_raises(factor):
    t = torch.from_numpy(T_GRID)
    with pytest.raises(ValueError, match="lowfreq_factor"):
        sig.make_clean_variants(t, t, t, t, lowfreq_factor=factor)


# every unseen channel against the JAX package on the same grid, max |diff|
# over the channel's peak: torch's and XLA's float32 sin / arcsin round
# differently in the last bit (arcsin near +-1 turns that into a few ulps of
# the triangle), and the velocity and acceleration divide differences of
# neighbours by 2 dt twice; the port reads <= 9.3e-7 on x (x_triangle),
# 3.6e-5 on v, 1.6e-4 on a (a_envelope)
UNSEEN_RTOL = {"x": 5e-6, "v": 1e-4, "a": 5e-4}


def test_unseen_variants_every_channel():
    got, ref = _both(sig.make_unseen_variants, jsig.make_unseen_variants, T_GRID,
                     amplitude=0.01, base_freq_hz=0.33)
    assert set(got) == set(sig.UNSEEN_COLUMNS) == set(ref)
    for c in sig.UNSEEN_COLUMNS:
        g, r = got[c].numpy(), np.asarray(ref[c])
        assert g.dtype == np.float32 and g.shape == T_GRID.shape
        if c.endswith("_square"):
            np.testing.assert_array_equal(g, r, err_msg=c)
        else:
            assert np.abs(g - r).max() <= UNSEEN_RTOL[c[0]] * np.abs(r).max(), c


def test_square_wave_signs():
    """sign(sin(2 pi f t)): 0 at t=0, +-1 elsewhere on the grid (no other
    grid point is a zero crossing at 0.33 Hz), equal to JAX's everywhere,
    and flipping where the sine does."""
    got, ref = _both(sig._square_wave, jsig._square_wave, T_GRID, f=0.33)
    g = got.numpy()
    np.testing.assert_array_equal(g, np.asarray(ref))
    assert g[0] == 0.0 and set(np.unique(g[1:])) == {-1.0, 1.0}
    half = 1.0 / (2 * 0.33)
    flips = np.nonzero(np.diff(g[1:]) != 0)[0] + 1
    np.testing.assert_allclose(T_GRID[flips], np.arange(1, len(flips) + 1) * half,
                               atol=0.011)


def test_triangle_wave_matches_jax():
    """(2/pi) arcsin(sin(.)) within 1e-6 of its unit peak: arcsin near +-1
    turns a last-bit difference of sin into a few ulps."""
    got, ref = _both(sig._triangle_wave, jsig._triangle_wave, T_GRID, f=0.33)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-6
    assert np.abs(got.numpy()).max() <= 1.0 + 1e-6


@pytest.mark.parametrize("n", [2, 3, 50])
def test_gradient_edges_and_middle(n):
    """np.gradient of a uniform grid: one-sided at both edges, central in
    between; the port equal to JAX's bit for bit and to numpy's (float64)
    within float32 rounding."""
    rng = np.random.default_rng(n)
    y = rng.normal(size=n).astype(np.float32)
    dt = np.float32(0.01)
    got, ref = _both(sig._gradient, jsig._gradient, y, np.array(dt))
    g = got.numpy()
    np.testing.assert_array_equal(g, np.asarray(ref))
    assert g[0] == np.float32((y[1] - y[0]) / dt)
    assert g[-1] == np.float32((y[-1] - y[-2]) / dt)
    np.testing.assert_allclose(g, np.gradient(y.astype(np.float64), float(dt)),
                               rtol=1e-5, atol=1e-5 * np.abs(g).max())


def test_variants_run_on_the_tensor_s_device_in_float32():
    t = torch.from_numpy(T_GRID)
    out = sig.make_unseen_variants(t)
    assert all(v.dtype == torch.float32 and v.device == t.device for v in out.values())
    assert math.isclose(float(out["x_original"].abs().max()), 0.01, rel_tol=1e-3)
