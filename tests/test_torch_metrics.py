"""The port's metrics (``shm_tpu_torch.evals``) against the JAX package's
``shm_tpu.evals`` and against scikit-learn, on seeded numpy data.

Against the JAX package: exact, since both compute the same numpy
expressions. Against sklearn: within 1e-12 (another summation order), and
the curves' areas rather than their point sets (the port keeps collinear
ROC points, which sklearn drops).
"""

import numpy as np
import pytest
from sklearn import metrics as skm

from shm_tpu import evals as jax_evals
from shm_tpu_torch import evals

SEEDS = [0, 1, 2, 3, 4]
FUNCS = ["confusion_matrix", "accuracy", "precision_recall_fscore",
         "binary_prf", "roc_curve", "auc", "roc_auc_score",
         "precision_recall_curve", "average_precision_score",
         "classification_report_dict"]


def _labels(seed, n=500, k=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    yhat = np.where(rng.random(n) < 0.7, y, rng.integers(0, k, n))
    return y, yhat


def _scores(seed, n=400, ties=False):
    """Binary labels and scores that rank positives higher; with ``ties``
    the scores take 12 distinct values, so many cut points hold several
    windows of both labels."""
    rng = np.random.default_rng(100 + seed)
    y = rng.integers(0, 2, n)
    s = rng.random(n) * 0.5 + y * rng.random(n) * 0.5
    if ties:
        s = np.round(s * 11) / 11
    return y, s


def _same(a, b):
    """Equal bit for bit, through dicts, tuples and arrays."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_the_port_exports_every_metric_of_the_jax_package():
    assert sorted(evals.__all__) == sorted(jax_evals.__all__) == sorted(FUNCS)


@pytest.mark.parametrize("seed", SEEDS)
def test_label_metrics_equal_the_jax_package(seed):
    y, yhat = _labels(seed)
    _same(evals.confusion_matrix(y, yhat, 3), jax_evals.confusion_matrix(y, yhat, 3))
    assert evals.accuracy(y, yhat) == jax_evals.accuracy(y, yhat)
    for beta in (1.0, 2.0):
        _same(evals.precision_recall_fscore(y, yhat, 3, beta),
              jax_evals.precision_recall_fscore(y, yhat, 3, beta))
    yb, ybh = y % 2, yhat % 2
    _same(evals.binary_prf(yb, ybh), jax_evals.binary_prf(yb, ybh))
    _same(evals.classification_report_dict(y, yhat, ["A", "B", "C"]),
          jax_evals.classification_report_dict(y, yhat, ["A", "B", "C"]))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("seed", SEEDS)
def test_curves_equal_the_jax_package(seed, ties):
    y, s = _scores(seed, ties=ties)
    for name in ("roc_curve", "precision_recall_curve"):
        _same(getattr(evals, name)(y, s), getattr(jax_evals, name)(y, s))
    for name in ("roc_auc_score", "average_precision_score"):
        assert getattr(evals, name)(y, s) == getattr(jax_evals, name)(y, s)
    fpr, tpr, _ = evals.roc_curve(y, s)
    assert evals.auc(fpr, tpr) == jax_evals.auc(fpr, tpr)


@pytest.mark.parametrize("seed", SEEDS)
def test_label_metrics_match_sklearn(seed):
    y, yhat = _labels(seed)
    np.testing.assert_array_equal(evals.confusion_matrix(y, yhat, 3),
                                  skm.confusion_matrix(y, yhat, labels=[0, 1, 2]))
    assert evals.accuracy(y, yhat) == pytest.approx(skm.accuracy_score(y, yhat),
                                                    abs=1e-12)
    r = evals.precision_recall_fscore(y, yhat, 3)
    p, rec, f, sup = skm.precision_recall_fscore_support(
        y, yhat, labels=[0, 1, 2], zero_division=0)
    np.testing.assert_allclose(r["precision"], p, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r["recall"], rec, rtol=0, atol=1e-12)
    np.testing.assert_allclose(r["fscore"], f, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(r["support"], sup)
    for avg in ("macro", "weighted"):
        want = skm.precision_recall_fscore_support(
            y, yhat, labels=[0, 1, 2], average=avg, zero_division=0)[:3]
        np.testing.assert_allclose(r[avg], want, rtol=0, atol=1e-12)
    f2 = evals.precision_recall_fscore(y, yhat, 3, beta=2.0)["fscore"]
    np.testing.assert_allclose(
        f2, skm.fbeta_score(y, yhat, beta=2.0, average=None, zero_division=0),
        rtol=0, atol=1e-12)
    yb, ybh = y % 2, yhat % 2
    b = evals.binary_prf(yb, ybh)
    assert b["precision"] == pytest.approx(
        skm.precision_score(yb, ybh, zero_division=0), abs=1e-12)
    assert b["recall"] == pytest.approx(skm.recall_score(yb, ybh), abs=1e-12)
    assert b["f1"] == pytest.approx(skm.f1_score(yb, ybh), abs=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_classification_report_matches_sklearn(seed):
    y, yhat = _labels(seed)
    ours = evals.classification_report_dict(y, yhat, ["A", "B", "C"])
    ref = skm.classification_report(y, yhat, target_names=["A", "B", "C"],
                                    output_dict=True, zero_division=0)
    for cls in ("A", "B", "C", "macro avg", "weighted avg"):
        for k in ("precision", "recall", "f1-score", "support"):
            assert ours[cls][k] == pytest.approx(ref[cls][k], abs=1e-12), (cls, k)
    assert ours["accuracy"]["accuracy"] == pytest.approx(ref["accuracy"], abs=1e-12)
    assert ours["accuracy"]["support"] == len(y)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("seed", SEEDS)
def test_ranking_metrics_match_sklearn(seed, ties):
    y, s = _scores(seed, ties=ties)
    assert evals.roc_auc_score(y, s) == pytest.approx(skm.roc_auc_score(y, s),
                                                      abs=1e-12)
    assert evals.average_precision_score(y, s) == pytest.approx(
        skm.average_precision_score(y, s), abs=1e-12)
    # the PR curve has sklearn's point set exactly; the ROC curve keeps
    # collinear points, so its area is compared
    prec, rec, thr = evals.precision_recall_curve(y, s)
    sp, sr, st = skm.precision_recall_curve(y, s)
    np.testing.assert_allclose(prec, sp, rtol=0, atol=1e-12)
    np.testing.assert_allclose(rec, sr, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(thr, st)
    fpr, tpr, rthr = evals.roc_curve(y, s)
    assert rthr[0] == np.inf and (np.diff(rthr[1:]) < 0).all()
    assert (np.diff(fpr) >= 0).all() and (np.diff(tpr) >= 0).all()
    assert evals.auc(fpr, tpr) == pytest.approx(skm.auc(*skm.roc_curve(y, s)[:2]),
                                                abs=1e-12)


def test_tied_scores_make_one_cut_point_each():
    y = np.array([0, 1, 1, 0, 1, 0])
    s = np.array([0.5, 0.5, 0.9, 0.1, 0.5, 0.1])
    fpr, tpr, thr = evals.roc_curve(y, s)
    np.testing.assert_array_equal(thr, [np.inf, 0.9, 0.5, 0.1])
    np.testing.assert_array_equal(tpr, [0, 1 / 3, 1, 1])
    np.testing.assert_array_equal(fpr, [0, 0, 1 / 3, 1])
    assert evals.roc_auc_score(y, s) == pytest.approx(skm.roc_auc_score(y, s),
                                                      abs=1e-12)
    assert evals.average_precision_score(y, s) == pytest.approx(
        skm.average_precision_score(y, s), abs=1e-12)


@pytest.mark.parametrize("label", [0, 1])
def test_single_class_input(label):
    """One class only: the ROC axis of the missing class is all zeros (no
    division by zero), and the label metrics follow zero_division=0."""
    y = np.full(50, label)
    s = np.random.default_rng(label).random(50)
    fpr, tpr, _ = evals.roc_curve(y, s)
    jfpr, jtpr, _ = jax_evals.roc_curve(y, s)
    _same((fpr, tpr), (jfpr, jtpr))
    missing = tpr if label == 0 else fpr
    assert not missing.any() and np.isfinite(fpr).all() and np.isfinite(tpr).all()
    assert evals.average_precision_score(y, s) == jax_evals.average_precision_score(y, s)
    yhat = 1 - y
    _same(evals.binary_prf(y, yhat), jax_evals.binary_prf(y, yhat))
    b = evals.binary_prf(y, yhat)
    assert b["precision"] == pytest.approx(skm.precision_score(
        y, yhat, zero_division=0, labels=[0, 1]), abs=1e-12)
    assert b["recall"] == pytest.approx(skm.recall_score(
        y, yhat, zero_division=0, labels=[0, 1]), abs=1e-12)
    r = evals.precision_recall_fscore(y, y, 3)
    assert r["support"].tolist() == [50 if c == label else 0 for c in range(3)]
    assert r["precision"][label] == 1.0 and r["fscore"][2] == 0.0


def test_empty_input():
    assert evals.accuracy([], []) == 0.0 == jax_evals.accuracy([], [])
    assert evals.confusion_matrix([], [], 2).tolist() == [[0, 0], [0, 0]]
