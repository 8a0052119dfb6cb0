"""The port's ``train-ml`` and ``validate-ml`` against the JAX package's, on
the CPU.

- ``train-ml`` on a small root of ``tests/torch_openlab_roots.py`` (every
  8th committed window): the
  same five sklearn fits from the same seed (the summary rows equal but for
  the seconds; the thresholds equal), and beside each joblib an export
  whose model scores the validation rows as the JAX package's exports of
  the JAX run's joblib do.
- ``validate-ml`` on that root: with ``--host-ml`` the JAX CLI's JSON
  exactly (both call sklearn); from the exports, the thresholds and
  matrices of its own p(ST), within 1e-6 of the JAX package's on-device
  exports, AUROC within 2e-5 of sklearn's; the RF's differs from sklearn's
  here (a float32 mean below a grid point, ROADMAP Queue 3).
- ``validate-ml`` on a copy of the committed root from the committed
  exports: ``validation_val/ml_val_summary.json``'s matrices and
  thresholds exactly, AUROC within 2e-4.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from shm_tpu_torch.cli import openlab as ol
from shm_tpu_torch.models import ml
from torch_openlab_roots import (
    OPENLAB, one_thread_pools, silence_jax_plots, small_root,
)

torch.set_num_threads(1)
NAMES = ("cart", "gb", "hgb", "rf", "svm_rbf")
ART = "output/ML_Baselines/artifacts"
VAL = "output/ML_Baselines/validation_val/ml_val_summary.json"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    import warnings

    from shm_tpu.cli import openlab as jol
    from shm_tpu.config import OpenLabConfig

    warnings.simplefilter("ignore", FutureWarning)
    base = tmp_path_factory.mktemp("openlab_ml")
    port, host, jax_root = (small_root(base / n, step=8, outputs=()) for n in
                            ("port", "host", "jax"))
    with pytest.MonkeyPatch.context() as mp, one_thread_pools():
        silence_jax_plots(mp)
        jp = jol.Paths(str(jax_root), "")
        jol.cmd_train_ml(jp, OpenLabConfig())
        jol.cmd_validate_ml(jp, OpenLabConfig())
        ol.main(["train-ml", "--root", str(port), "--device", "cpu"])
        shutil.copytree(port / "output", host / "output")
        ol.main(["validate-ml", "--root", str(port), "--device", "cpu",
                 "--no-plots"])
        ol.main(["validate-ml", "--root", str(host), "--device", "cpu",
                 "--no-plots", "--host-ml"])
    return port, host, jax_root


def _json(root, rel):
    return json.loads((root / rel).read_text())


def test_train_ml_fits_the_same_models(trained):
    port, host, jax_root = trained
    a, b = _json(port, f"{ART}/ml_val_summary.json"), _json(jax_root, f"{ART}/ml_val_summary.json")
    assert [r["name"] for r in a] == [r["name"] for r in b]
    for r, s in zip(a, b):
        assert r["status"] == s["status"] == "ok"
        assert {k: v for k, v in r.items() if k != "seconds"} == {
            k: v for k, v in s.items() if k != "seconds"}
    assert _json(port, f"{ART}/ml_training_info.json")["seed"] == 42
    header = (port / f"{ART}/ml_val_summary.csv").read_text().splitlines()[0]
    assert header == (jax_root / f"{ART}/ml_val_summary.csv").read_text().splitlines()[0]
    for name in NAMES:
        # validate-ml tuned them again, from sklearn on both roots
        assert np.array_equal(np.load(host / f"{ART}/{name}_threshold.npy"),
                              np.load(jax_root / f"{ART}/{name}_threshold.npy"))
        assert ml.export_path(port / f"{ART}/{name}.joblib").exists()


def test_exports_score_as_the_jax_exports(trained):
    import joblib

    from shm_tpu.cli import openlab as jol
    from test_torch_ml_export import _jax_p

    port, _, jax_root = trained
    X, _, masks = jol._ml_data(jol.Paths(str(jax_root), ""))
    Xv = X[masks["val"]]
    for name in NAMES:
        m = ml.load_export(port / f"{ART}/{name}.joblib", "cpu")
        want, _ = _jax_p(joblib.load(jax_root / f"{ART}/{name}.joblib"), Xv)
        tol = 2e-5 if name == "svm_rbf" else 1e-6
        np.testing.assert_allclose(m.predict_proba(Xv), want, rtol=0, atol=tol,
                                   err_msg=name)


def test_validate_ml_host_and_device(trained):
    """``--host-ml`` gives the JAX command's JSON (both call sklearn). From
    the exports the port tunes on its own on-device p(ST): within 1e-6 of
    the JAX package's on-device exports (2e-5 for the SVM), so a decision
    may differ from theirs only for a row within that of the threshold (an
    RF mean of 400 trees that lands on a grid point, summed in another
    float32 order). Both differ from sklearn's where a float64 p(ST) sits
    on a grid point that the float32 one misses (ROADMAP Queue 3): on this
    root the RF's tuned threshold (0.18 against sklearn's 0.19, a row at
    0.18 that float32 reads as 0.17999999)."""
    import joblib

    from shm_tpu.cli import openlab as jol
    from shm_tpu.config import OpenLabConfig
    from test_torch_ml_export import _jax_p

    port, host, jax_root = trained
    j = _json(jax_root, VAL)
    assert _json(host, VAL) == j
    d = _json(port, VAL)
    assert d.keys() == j.keys()
    X, y, masks = jol._ml_data(jol.Paths(str(jax_root), ""))
    Xv, yv = X[masks["val"]], y[masks["val"]]
    moved = []
    for name in j:
        p_port = ml.load_export(port / f"{ART}/{name}.joblib", "cpu").predict_proba(Xv)
        t = jol._tune_st_first(OpenLabConfig(), p_port, yv)["t"]
        cm = [[int(((yv == a) & ((p_port >= t) == b)).sum()) for b in (0, 1)]
              for a in (0, 1)]
        assert d[name]["threshold"] == t and d[name]["confusion_matrix"] == cm, name
        assert d[name]["auroc_st"] == pytest.approx(j[name]["auroc_st"], abs=2e-5)
        model = joblib.load(port / f"{ART}/{name}.joblib")
        p_dev, _ = _jax_p(model, Xv)
        tol = 2e-5 if name == "svm_rbf" else 1e-6
        flips = (p_port >= t) != (p_dev >= t)
        assert (np.abs(p_dev[flips] - t) <= tol).all(), name
        key = lambda r: (r["threshold"], r["confusion_matrix"])
        if key(d[name]) != key(j[name]):
            # sklearn's float64 p(ST) of some row sits on sklearn's tuned
            # threshold, the device's float32 one on the other side of it
            p_sk = model.predict_proba(Xv)[:, 1]
            t_sk = j[name]["threshold"]
            split = (p_dev >= t_sk) != (p_sk >= t_sk)
            assert split.any() and (np.abs(p_sk[split] - t_sk) <= 1e-6).all(), name
            moved.append(name)
    assert moved == ["rf"]


def test_validate_ml_reproduces_the_committed_summary(tmp_path):
    root = tmp_path / "openlab"
    shutil.copytree(OPENLAB, root, symlinks=True)
    ol.main(["validate-ml", "--root", str(root), "--device", "cpu", "--no-plots"])
    got, want = _json(root, VAL), _json(OPENLAB, VAL)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name]["confusion_matrix"] == want[name]["confusion_matrix"], name
        assert got[name]["threshold"] == want[name]["threshold"], name
        assert got[name]["auroc_st"] == pytest.approx(want[name]["auroc_st"],
                                                      abs=2e-4), name
