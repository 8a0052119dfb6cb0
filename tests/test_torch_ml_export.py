"""The five classical baselines on the device (``models/forest.py``,
``models/svm.py``, ``models/ml.py``) against the JAX package's
``forest_jax`` / ``svm_jax`` and against sklearn, on the CPU.

- For each committed joblib of ``data/openlab`` and
  ``data/openlab_attention``: the port's export arrays equal the JAX
  package's; the preprocessing equals sklearn's ``transform`` bit for bit;
  ``p_st`` on all 6,432 committed feature rows within 1e-6 of the JAX
  package's for the trees, 2e-5 for the SVM (float32 kernel sums in another
  order; the JAX package reads 9.5e-6 from sklearn itself).
- Against sklearn: the CART and HGB within 1e-6 everywhere. The JAX
  package (and so the port) rounds the RF / GB thresholds to the NEAREST
  float32, where sklearn compares a float32 feature with the float64
  threshold; a feature between the two takes the other branch. This test
  shows that this is the whole difference: with each threshold rounded
  DOWN to float32 (exact for a float32 feature) every row is within 1e-6
  of sklearn, and the shipped export differs on 1 RF row and 6 GB rows
  of the 6,432.
- The committed ``.export.npz`` files equal a fresh export; a missing or
  stale one raises, naming the command that writes it.
- ``SVC(probability=True)`` and ``CalibratedClassifierCV`` (sigmoid and
  isotonic), each fitted on a small seeded set: the port against sklearn and
  the JAX package.
"""

import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu_torch.models import forest, ml, svm

torch.set_num_threads(1)
warnings.filterwarnings("ignore", category=FutureWarning)
ROOT = Path(__file__).resolve().parents[1]
ROOTS = ("data/openlab", "data/openlab_attention")
NAMES = ("cart", "rf", "gb", "hgb", "svm_rbf")
ART = "output/ML_Baselines/artifacts"
# rows of the 6,432 where the nearest-float32 thresholds (JAX's and so the
# port's) take another branch than sklearn: the same models in both roots
SKLEARN_FLIPS = {"cart": 0, "rf": 1, "gb": 6, "hgb": 0}


@pytest.fixture(scope="module")
def features():
    return np.load(ROOT / "data/openlab/features/X_feat.npy").astype(np.float32)


def _joblib(root, name):
    import joblib

    return joblib.load(ROOT / root / ART / f"{name}.joblib")


def _jax_p(model, X):
    from shm_tpu.models import forest_jax as fj
    from shm_tpu.models import svm_jax as sj
    from sklearn.calibration import CalibratedClassifierCV

    Xd = fj.transform_features(model, X)
    est = model.steps[-1][1] if hasattr(model, "steps") else model
    if isinstance(est, CalibratedClassifierCV):
        return np.asarray(sj.calibrated_svm_predict_proba(
            sj.export_calibrated_svm(model), Xd), np.float64), Xd
    if type(est).__name__ == "SVC":
        return np.asarray(sj.svm_predict_proba(sj.export_svm(model), Xd),
                          np.float64), Xd
    return np.asarray(fj.ensemble_predict_proba(fj.export_ensemble(model), Xd),
                      np.float64), Xd


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("root", ROOTS)
def test_committed_model_against_jax_and_sklearn(root, name, features):
    from shm_tpu.models import forest_jax as fj
    from shm_tpu.models import svm_jax as sj

    model = _joblib(root, name)
    ex = ml.export_model(model)
    if ex["model_kind"] == "tree":
        j = fj.export_ensemble(model)
        for k in forest.TREE_ARRAYS:
            a, b = ex[k], np.asarray(getattr(j, k))
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert (int(ex["depth"]), str(ex["kind"]), float(ex["base_score"])) == (
            j.depth, j.kind, j.base_score)
    else:
        j = (sj.export_calibrated_svm(model) if ex["model_kind"] == "calibrated_svm"
             else sj.export_svm(model))
        for k in j._fields:
            assert np.array_equal(np.asarray(ex[k]), np.asarray(getattr(j, k))), k

    m = ml.load_export(ROOT / root / ART / f"{name}.joblib", "cpu")
    p = m.predict_proba(features)
    want, Xd = _jax_p(model, features)
    assert np.array_equal(m.transform(features).view(np.uint32), Xd.view(np.uint32))
    tol = 2e-5 if name == "svm_rbf" else 1e-6
    np.testing.assert_allclose(p, want, rtol=0, atol=tol)
    sk = model.predict_proba(features)[:, 1]
    if name == "svm_rbf":
        np.testing.assert_allclose(p, sk, rtol=0, atol=2e-5)
        return
    off = np.abs(p - sk) > 1e-6
    assert int(off.sum()) == SKLEARN_FLIPS[name]
    # thresholds rounded down to float32 compare as sklearn does: exact
    t64 = _sklearn_thresholds(model, ex)
    down = np.where(t64.astype(np.float32) > t64,
                    np.nextafter(t64.astype(np.float32), np.float32(-np.inf)),
                    t64.astype(np.float32))
    exact = forest.ensemble_from_arrays(dict(ex, threshold=down), "cpu")
    p_exact = forest.ensemble_predict_proba(
        exact, torch.from_numpy(m.transform(features))).numpy()
    np.testing.assert_allclose(p_exact, sk, rtol=0, atol=1e-6)


def _sklearn_thresholds(model, ex):
    """Each node's float64 threshold, padded as the export pads them."""
    est = model.steps[-1][1] if hasattr(model, "steps") else model
    name = type(est).__name__
    if name == "HistGradientBoostingClassifier":
        rows = [p[0].nodes["num_threshold"] for p in est._predictors]
    elif name == "GradientBoostingClassifier":
        rows = [e.tree_.threshold for e in est.estimators_[:, 0]]
    elif name == "RandomForestClassifier":
        rows = [e.tree_.threshold for e in est.estimators_]
    else:
        rows = [est.tree_.threshold]
    out = np.zeros(ex["threshold"].shape, np.float64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


@pytest.mark.parametrize("root", ROOTS)
def test_committed_exports_equal_a_fresh_export(root, tmp_path):
    for name in NAMES:
        jp = ROOT / root / ART / f"{name}.joblib"
        with np.load(ml.export_path(jp)) as z:
            committed = {k: z[k] for k in z.files}
        dst = tmp_path / f"{name}.joblib"
        shutil.copy(jp, dst)
        with np.load(ml.write_export(dst)) as z:
            fresh = {k: z[k] for k in z.files}
        assert committed.keys() == fresh.keys()
        for k in fresh:
            assert np.array_equal(committed[k], fresh[k]), f"{name}.{k}"
        assert str(committed["joblib_sha256"]) == ml.file_sha256(jp)


def test_missing_or_stale_export_raises(tmp_path):
    src = ROOT / "data/openlab" / ART / "cart.joblib"
    jp = tmp_path / "cart.joblib"
    shutil.copy(src, jp)
    with pytest.raises(FileNotFoundError, match=ml.EXPORT_COMMAND):
        ml.load_export(jp, "cpu")
    shutil.copy(ml.export_path(src), ml.export_path(jp))
    ml.load_export(jp, "cpu")                     # the same bytes: loads
    jp.write_bytes(jp.read_bytes() + b"\0")       # the joblib changed
    with pytest.raises(ValueError, match="sha256"):
        ml.load_export(jp, "cpu")
    ml.main([str(jp)])                            # the command rewrites it
    assert ml.load_export(jp, "cpu").kind == "tree"


def _small_set(seed=0, n=160, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.7 * rng.normal(size=n) > 0).astype(np.int64)
    X[rng.random(X.shape) < 0.03] = np.nan       # the imputer has work
    return X[:120], y[:120], X[120:]


@pytest.mark.parametrize("kind", ["svc", "sigmoid", "isotonic"])
def test_fitted_svms_against_sklearn_and_jax(kind, tmp_path):
    import joblib
    from sklearn.calibration import CalibratedClassifierCV
    from sklearn.impute import SimpleImputer
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC

    Xtr, ytr, Xte = _small_set()
    clf = (SVC(kernel="rbf", probability=True, random_state=0) if kind == "svc"
           else CalibratedClassifierCV(SVC(kernel="rbf", random_state=0),
                                       ensemble=False, method=kind, cv=3))
    model = Pipeline([("imputer", SimpleImputer(strategy="median")),
                      ("scaler", StandardScaler()), ("clf", clf)]).fit(Xtr, ytr)
    jp = tmp_path / "svm.joblib"
    joblib.dump(model, jp)
    ml.write_export(jp)
    m = ml.load_export(jp, "cpu")
    assert m.kind == ("svm" if kind == "svc" else "calibrated_svm")
    p = m.predict_proba(Xte)
    want, _ = _jax_p(model, Xte)
    np.testing.assert_allclose(p, want, rtol=0, atol=2e-5)
    np.testing.assert_allclose(p, model.predict_proba(Xte)[:, 1], rtol=0, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_coupling_and_interp_against_jax(seed):
    """libsvm's k=2 coupling and ``jnp.interp`` (isotonic) on their own."""
    import jax.numpy as jnp

    from shm_tpu.models import svm_jax as sj

    rng = np.random.default_rng(seed)
    f = rng.normal(scale=3.0, size=500).astype(np.float32)
    for first in (True, False):
        got = svm._proba_from_decision(torch.from_numpy(f), -1.7, 0.3, first)
        want = sj._proba_from_decision(jnp.asarray(f), -1.7, 0.3, first)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    xp = np.sort(rng.normal(size=20)).astype(np.float32)
    xp[5] = xp[4]                                  # a repeated threshold
    fp = np.sort(rng.uniform(size=20)).astype(np.float32)
    got = svm._interp(torch.from_numpy(f), torch.from_numpy(xp), torch.from_numpy(fp))
    want = jnp.interp(jnp.asarray(f), jnp.asarray(xp), jnp.asarray(fp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
