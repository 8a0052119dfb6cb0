"""The 1-DOF stage's window utilities (``compute_standardizer``,
``standardize``, ``destandardize``, ``stitch_windows``, ``segment_rmse``)
against the JAX package's (``shm_tpu/data/windows.py``) on the CPU, from the
same numpy-made inputs. Tolerances are stated where they are used.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.data import windows as jw
from shm_tpu_torch.data import windows as w

torch.set_num_threads(1)
t = torch.from_numpy


def test_compute_standardizer_is_the_population_std_with_a_floor():
    """ddof 0 (torch's default is 1), a constant feature floored to 1e-6;
    within 2 float32 ulps of JAX's and of numpy's float64 statistics (the
    sums run in other orders)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1500, 12)) * np.linspace(0.01, 2, 12)).astype(np.float32)
    x[:, 3] = 0.25                                    # zero std
    mean, std = w.compute_standardizer(t(x))
    jm, js = jw.compute_standardizer(jnp.asarray(x))
    assert float(std[3]) == float(js[3]) == np.float32(1e-6)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), rtol=2.4e-7, atol=1e-8)
    np.testing.assert_allclose(std.numpy(), np.asarray(js), rtol=2.4e-7)
    ref = x.astype(np.float64).std(axis=0)            # ddof 0
    keep = np.arange(12) != 3
    np.testing.assert_allclose(std.numpy()[keep], ref[keep], rtol=2.4e-7)
    assert not np.allclose(std.numpy()[keep], x[:, keep].std(axis=0, ddof=1), rtol=1e-5)


def test_standardize_and_back_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 12)).astype(np.float32)
    mean, std = (rng.normal(size=12).astype(np.float32),
                 rng.uniform(0.1, 2.0, 12).astype(np.float32))
    z = w.standardize(t(x), t(mean), t(std))
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jw.standardize(jnp.asarray(x), mean, std)))
    back = w.destandardize(z, t(mean), t(std))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jw.destandardize(jnp.asarray(z.numpy()), mean, std)))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("N, L, F, stride, full_len", [
    (1422, 80, 12, 1, 1501),     # test-seen's windows
    (40, 7, 3, 3, 130),          # stride 3, and rows 124-129 no window covers
    (6, 5, 2, 1, 12),            # the last two rows covered by no window
    (0, 5, 2, 1, 4),             # no window at all
])
def test_stitch_windows_matches_jax(N, L, F, stride, full_len):
    """Overlap-average back into a series: equal to JAX's scatter-add bit
    for bit (a sample sums its windows in the order of their starts, as
    the JAX package's scatter does on the CPU); a row no window covers is 0
    (the zero-count guard); two calls give the same bits."""
    rng = np.random.default_rng(N + L)
    W = rng.normal(size=(N, L, F)).astype(np.float32)
    got = w.stitch_windows(t(W), full_len, stride)
    ref = np.asarray(jw.stitch_windows(jnp.asarray(W), full_len, stride))
    assert got.dtype == torch.float32 and got.shape == (full_len, F)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), w.stitch_windows(t(W), full_len, stride).numpy())
    covered = (N - 1) * stride + L if N else 0
    assert (got.numpy()[covered:] == 0).all()
    if N:                                        # row 0: window 0 alone
        np.testing.assert_array_equal(got.numpy()[0], W[0, 0])


def test_stitch_windows_of_one_series_gives_it_back():
    """Windows cut from a series with make_windows average back to it."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    for stride in (1, 3):
        W = w.make_windows(t(x), 80, stride)
        full = (W.shape[0] - 1) * stride + 80
        np.testing.assert_allclose(w.stitch_windows(W, full, stride).numpy(), x[:full],
                                   rtol=1e-6, atol=1e-6)


def test_stitch_windows_that_do_not_fit_raise():
    with pytest.raises(ValueError, match="do not fit"):
        w.stitch_windows(torch.zeros(5, 4, 2), 7, 1)


@pytest.mark.parametrize("T, seg", [(1501, 100), (3001, 100), (200, 100), (7, 3),
                                    (40, 100)])
def test_segment_rmse_with_a_short_last_segment(T, seg):
    """ceil(T / seg) segments, the last one of T mod seg samples counting
    only those (1,501 test-seen samples: 16 segments, the last of 1; 3,001
    test-unseen samples: 31). Within 4e-7 relative of JAX's and of a
    float64 loop over the segments (float32 sums of up to 1,200 squares in
    other orders)."""
    rng = np.random.default_rng(T)
    y, p = rng.normal(size=(2, T, 12)).astype(np.float32)
    got = w.segment_rmse(t(y), t(p), seg).numpy()
    ref = np.asarray(jw.segment_rmse(jnp.asarray(y), jnp.asarray(p), seg))
    S = -(-T // seg)
    assert got.shape == ref.shape == (S,)
    np.testing.assert_allclose(got, ref, rtol=4e-7)
    loop = [np.sqrt(((p[s:s + seg].astype(np.float64) - y[s:s + seg]) ** 2).mean())
            for s in range(0, T, seg)]
    np.testing.assert_allclose(got, loop, rtol=4e-7)
    if T % seg:                                   # the short segment alone
        tail = T - (S - 1) * seg
        np.testing.assert_allclose(
            got[-1], np.sqrt(((p[-tail:] - y[-tail:]).astype(np.float64) ** 2).mean()),
            rtol=4e-7)
