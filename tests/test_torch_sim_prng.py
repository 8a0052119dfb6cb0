"""The port's numpy mirror of ``jax.random`` (``shm_tpu_torch/sim/prng.py``)
against ``jax.random`` itself: keys, split, fold_in, 32-bit bits, uniform
and permutation bit for bit; normal within 4 float32 ulps (the mirror's
``log1p`` is numpy's, not XLA's: about 1% of draws differ, by 1-3 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shm_tpu_torch.sim import prng

SEEDS = [0, 1, 42, 2025, 2 ** 31 - 1]
SHAPES = [(1,), (5,), (1001,), (3, 7), (4, 5, 6)]
NORMAL_ULPS = 4


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """float32 ulps between ``a`` and ``b`` of one sign (0 where equal, so
    that -0.0 and 0.0 agree)."""
    d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
    return np.where(a == b, 0, d)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_are_bit_exact(seed):
    k, kj = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert k.dtype == np.uint32 and np.array_equal(k, np.asarray(kj))
    for n in (1, 2, 3, 7, 64):
        assert np.array_equal(prng.split(k, n), np.asarray(jax.random.split(kj, n)))
    for d in (0, 1, 3, 12345, 2 ** 32 - 1):
        assert np.array_equal(prng.fold_in(k, d), np.asarray(jax.random.fold_in(kj, d)))
    # chains of both, as the fault generator uses them
    a, aj = prng.fold_in(k, 2), jax.random.fold_in(kj, 2)
    for _ in range(3):
        a, aj = prng.split(a, 3)[1], jax.random.split(aj, 3)[1]
    assert np.array_equal(a, np.asarray(aj))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_are_bit_exact(seed, shape):
    k, kj = prng.PRNGKey(seed), jax.random.PRNGKey(seed)
    assert np.array_equal(prng.random_bits(k, shape),
                          np.asarray(jax.random.bits(kj, shape, jnp.uint32)))
    u = prng.uniform(k, shape)
    assert u.dtype == np.float32 and u.shape == shape
    assert np.array_equal(u, np.asarray(jax.random.uniform(kj, shape)))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    assert np.array_equal(prng.uniform(k, shape, lo, 1.0),
                          np.asarray(jax.random.uniform(kj, shape, jnp.float32,
                                                        lo, 1.0)))


@pytest.mark.parametrize("shape", SHAPES + [(20000,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_within_a_few_ulps(seed, shape):
    got = prng.normal(prng.PRNGKey(seed), shape)
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert got.dtype == np.float32 and got.shape == shape
    assert int(_ulps(got, ref).max()) <= NORMAL_ULPS


def test_erfinv_tails_and_edges():
    """The polynomial's two branches (w < 5 and w >= 5) and the edges."""
    x = np.concatenate([np.linspace(-0.999999, 0.999999, 4001),
                        1 - np.logspace(-7, -1, 50), -(1 - np.logspace(-7, -1, 50)),
                        [0.0, -0.0]]).astype(np.float32)
    from jax.scipy.special import erfinv

    assert int(_ulps(prng.erfinv_f32(x), np.asarray(erfinv(jnp.asarray(x)))).max()) \
        <= NORMAL_ULPS
    assert np.isposinf(prng.erfinv_f32(np.float32([1.0]))).all()
    assert np.isneginf(prng.erfinv_f32(np.float32([-1.0]))).all()


@pytest.mark.parametrize("n", [1, 2, 10, 1001, 3000, 100000])
@pytest.mark.parametrize("seed", [0, 42, 2025])
def test_permutation_is_bit_exact(seed, n):
    got = prng.permutation(prng.PRNGKey(seed), n)
    ref = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    assert np.array_equal(got, ref)
    assert np.array_equal(np.sort(got), np.arange(n))


def test_permutation_rounds():
    # 1,001 samples (a 4DOF run) sort once; from ~1,600 on, twice
    assert prng.permutation_rounds(1001) == 1
    assert prng.permutation_rounds(3000) == 2
    assert prng.permutation_rounds(1) == 0


def test_threefry_known_answer():
    """Threefry-2x32's published test vector (Salmon et al. 2011): key and
    counter all ones -> (0x1cb996fc, 0xbb002be7)."""
    ones = np.uint32(0xFFFFFFFF)
    a, b = prng.threefry2x32(np.array([ones, ones]), np.array([ones]), np.array([ones]))
    assert (int(a[0]), int(b[0])) == (0x1CB996FC, 0xBB002BE7)


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError, match="32 bits"):
        prng.PRNGKey(2 ** 32)
