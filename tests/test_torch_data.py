"""The port's config, windowing, CSV reader and metrics against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu import config as jax_config
from shm_tpu.data import windows as jax_windows
from shm_tpu.evals import metrics as jax_metrics
from shm_tpu_torch import config
from shm_tpu_torch.data import windows
from shm_tpu_torch.evals import accuracy, confusion_matrix
from shm_tpu_torch.utils.io import load_csv_numeric, load_json

# pytest-xdist runs several test files at once on the same cores; torch's
# default of one thread per core makes those workers spin against each other.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["VAEConfig", "CNNConfig"])
def test_config_defaults_match_jax(name):
    ours = dataclasses.asdict(getattr(config, name)())
    ref = dataclasses.asdict(getattr(jax_config, name)())
    assert ours == {k: ref[k] for k in ours}


def test_stage4dof_fields_match_jax():
    ours, ref = config.Stage4DofConfig(), jax_config.Stage4DofConfig()
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            b = {k: b[k] for k in a}
        assert a == b, f.name


@pytest.mark.parametrize("T, seq_len, stride", [(30, 10, 1), (30, 10, 3),
                                                (10, 10, 1), (9, 10, 1),
                                                (31, 7, 4)])
def test_make_windows_matches_jax(rng, T, seq_len, stride):
    x = rng.normal(size=(T, 4)).astype(np.float32)
    got = windows.make_windows(torch.from_numpy(x), seq_len, stride)
    want = np.asarray(jax_windows.make_windows(jnp.asarray(x), seq_len, stride))
    assert got.shape == want.shape == (
        windows.num_windows(T, seq_len, stride), seq_len, 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(windows.make_windows_np(x, seq_len, stride),
                                  want)


def test_normalize_windows_matches_jax(rng):
    W = rng.normal(size=(5, 8, 3)).astype(np.float32)
    W[0, 1, 2] = np.nan
    W[1, 2, 0] = np.inf
    W[2, 3, 1] = -np.inf
    mean = rng.normal(size=3).astype(np.float32)
    std = np.array([0.5, 2.0, 1e-6], np.float32)
    got = windows.normalize_windows(torch.from_numpy(W), torch.from_numpy(mean),
                                    torch.from_numpy(std)).numpy()
    want = np.asarray(jax_windows.normalize_windows(jnp.asarray(W),
                                                    jnp.asarray(mean),
                                                    jnp.asarray(std)))
    assert np.isfinite(got).all()
    assert got[0, 1, 2] == got[1, 2, 0] == got[2, 3, 1] == 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("frac", [(0.0, 0.4), (0.4, 0.7), (0.7, 1.0),
                                  (0.5, 0.2)])
def test_slice_frac(frac):
    x = np.arange(101)
    got = windows.slice_frac(x, frac)
    s = int(101 * frac[0])
    assert got[0] == s if len(got) else True
    assert len(got) == max(int(101 * frac[1]), s) - s


def test_load_csv_numeric(tmp_path):
    p = tmp_path / "run.csv"
    p.write_text("a,b,c\n1,2,3\n4.5,5,6\n")
    X = load_csv_numeric(p, 3)
    assert X.dtype == np.float32 and X.shape == (2, 3)
    np.testing.assert_array_equal(X, [[1, 2, 3], [4.5, 5, 6]])
    one = tmp_path / "one.csv"
    one.write_text("a,b,c\n1,2,3\n")
    assert load_csv_numeric(one, 3).shape == (1, 3)


@pytest.mark.parametrize("body, match", [
    ("a,b\n1,2\n", "Bad CSV shape"),
    ("a,b,c\n1,nan,3\n", "Non-finite"),
    ("a,b,c\n1,inf,3\n", "Non-finite"),
])
def test_load_csv_numeric_guards(tmp_path, body, match):
    p = tmp_path / "bad.csv"
    p.write_text(body)
    with pytest.raises(ValueError, match=match):
        load_csv_numeric(p, 3)


def test_missing_files_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_csv_numeric(tmp_path / "none.csv")
    with pytest.raises(FileNotFoundError):
        load_json(tmp_path / "none.json")


def test_metrics_match_jax(rng):
    y = rng.integers(0, 3, size=200)
    p = np.where(rng.random(200) < 0.8, y, rng.integers(0, 3, size=200))
    np.testing.assert_array_equal(confusion_matrix(y, p, 3),
                                  jax_metrics.confusion_matrix(y, p, 3))
    assert accuracy(y, p) == pytest.approx(jax_metrics.accuracy(y, p))
    assert accuracy([], []) == 0.0
