"""A numpy mirror of the ``jax.random`` functions the 4DOF simulators draw from.

The JAX package draws the sensor faults' noise from ``jax.random`` keys
(``PRNGKey(42)``, ``fold_in``, ``split``, ``normal``, ``permutation``); the
port has no JAX, so it reproduces those draws here, on the host (a few
thousand numbers a run).

What it mirrors: JAX 0.9.0's default PRNG, ``threefry2x32``, with
``jax_threefry_partitionable=True`` (the default since JAX 0.5.0), and JAX
with x64 off (32-bit seeds). A key is JAX's raw key data, a uint32 array of
shape (2,) (or (n, 2) for ``split``):

- ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]`` of a 32-bit seed,
  so ``[0, seed]``;
- ``split(key, n)[i]`` and ``fold_in(key, i)`` hash the 64-bit counter ``i``
  (as the word pair ``(hi, lo)``) under ``key``;
- ``random_bits(key, shape)[j]`` (32-bit) is the xor of the two words the
  hash gives for the row-major flat index ``j``;
- ``uniform`` puts the top 23 bits in the mantissa of [1, 2), subtracts 1,
  scales to [minval, maxval) in float32 and floors at ``minval``;
- ``normal`` is ``sqrt(2) * erfinv(u)`` with ``u`` uniform in
  [nextafter(-1, 0), 1), and ``erfinv`` is XLA's float32 polynomial (Giles,
  "Approximating the erfinv function", 2010) with its multiply-adds fused.
  XLA's ``log1p`` is not numpy's, so about one draw in a hundred differs from
  JAX's by 1-3 float32 ulps (``tests/test_torch_sim_prng.py`` states the
  bound);
- ``permutation(key, n)`` sorts ``arange(n)`` by fresh 32-bit keys, stably,
  in ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each round's keys from the
  second half of a ``split`` of the running key.

Keys, bits, uniforms and permutations are bit-exact with JAX.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

Shape = Union[int, Sequence[int]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of the word pairs
    ``(x0, x1)`` under ``key`` (uint32 (2,)), elementwise."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def _hash_iota(key: np.ndarray, shape: Shape) -> Tuple[np.ndarray, np.ndarray]:
    """The hash of every 64-bit flat index of ``shape`` under ``key``."""
    shape = _shape(shape)
    idx = np.arange(math.prod(shape), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0.reshape(shape), b1.reshape(shape)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` of a 32-bit seed: uint32 ``[0, seed]``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} does not fit 32 bits (JAX with x64 off)")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: uint32 (num, 2)."""
    b0, b1 = _hash_iota(key, (num,))
    return np.stack([b0, b1], axis=1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` of a 32-bit ``data``."""
    b0, b1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def random_bits(key: np.ndarray, shape: Shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` at 32 bits: uint32 of ``shape``."""
    b0, b1 = _hash_iota(key, shape)
    return b0 ^ b1


def uniform(key: np.ndarray, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(np.float32)


# XLA's float32 ErfInv (Giles 2010): a degree-8 polynomial in w - 2.5 for
# w = -log1p(-x^2) < 5, in sqrt(w) - 3 otherwise
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """``lax.erf_inv`` of float32 ``x`` as XLA evaluates it, each
    multiply-add fused (a float64 product and sum rounded once); +-inf at
    +-1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):                # x = +-1: w = inf
        w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    w64 = w.astype(np.float64)
    coef = lambda i: np.where(lt, np.float32(_ERFINV_W_LT_5[i]),
                              np.float32(_ERFINV_W_GE_5[i])).astype(np.float64)
    p = coef(0).astype(np.float32)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = (coef(i) + p.astype(np.float64) * w64).astype(np.float32)
    out = (p * x).astype(np.float32)
    edge = np.abs(x) == np.float32(1.0)
    return np.where(edge, np.copysign(np.float32(np.inf), x), out).astype(np.float32)


def normal(key: np.ndarray, shape: Shape = ()) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``, within a few float32 ulps
    (see the module docstring)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    with np.errstate(over="ignore"):
        return (np.float32(math.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def permutation_rounds(n: int) -> int:
    """The sort rounds of ``jax.random.permutation`` for ``n`` elements."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: int32 (n,)."""
    x = np.arange(n, dtype=np.int32)
    for _ in range(permutation_rounds(n)):
        key, subkey = split(key)
        x = x[np.argsort(random_bits(subkey, (n,)), kind="stable")]
    return x


__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform", "normal",
           "permutation", "permutation_rounds", "erfinv_f32", "threefry2x32"]
