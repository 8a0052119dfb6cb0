"""The port's calibration (``shm_tpu_torch.calibrate``) against the JAX
package's ``shm_tpu.calibrate``, numpy and a sequential scan of the ST-first
rule written with sklearn, on seeded numpy data.

Against the JAX package and numpy: exact (the same numpy expressions).
Against the sequential scan: the same grid point, and its statistics within
1e-12.
"""

import numpy as np
import pytest
from sklearn.metrics import f1_score, fbeta_score, precision_score, recall_score

from shm_tpu import calibrate as jax_calibrate
from shm_tpu_torch import calibrate

SEEDS = [0, 1, 2, 3, 4]


@pytest.mark.parametrize("q", [50, 95, 99, 99.9])
@pytest.mark.parametrize("seed", SEEDS)
def test_percentile_threshold_equals_numpy_and_the_jax_package(seed, q):
    s = np.random.default_rng(seed).gamma(2.0, 0.3, 2010).astype(np.float32)
    t = calibrate.percentile_threshold(s, q)
    assert t == float(np.percentile(s, q)) == jax_calibrate.percentile_threshold(s, q)


@pytest.mark.parametrize("seed", SEEDS)
def test_summarize_scores_equals_the_jax_package(seed):
    s = np.random.default_rng(seed).gamma(2.0, 0.3, 804).astype(np.float32)
    got = calibrate.summarize_scores(s)
    assert got == jax_calibrate.summarize_scores(s)
    assert list(got) == ["n", "mean", "std", "p50", "p90", "p95", "p99",
                         "max", "min"]
    assert got["n"] == 804.0 and got["std"] == float(np.std(s))
    assert got["min"] <= got["p50"] <= got["p99"] <= got["max"]


def test_summarize_scores_of_nothing_is_empty():
    assert calibrate.summarize_scores(np.zeros(0)) == {}
    assert calibrate.summarize_scores([]) == jax_calibrate.summarize_scores([])


def _sequential_st_first(p_st, y, p_min_st=0.25, min_prec_sf=0.0, beta=2.0):
    """The ST-first rule as a scan over ascending t that replaces its pick
    only on a strict improvement, each statistic from sklearn."""
    best, fallback = None, None
    for t in np.linspace(0.01, 0.99, 99):
        yhat = (p_st >= t).astype(int)
        kw = dict(zero_division=0, labels=[0, 1])
        c = dict(
            t=float(t),
            prec_st=precision_score(y, yhat, pos_label=1, **kw),
            rec_st=recall_score(y, yhat, pos_label=1, **kw),
            prec_sf=precision_score(y, yhat, pos_label=0, **kw),
            rec_sf=recall_score(y, yhat, pos_label=0, **kw),
            f2_st=fbeta_score(y, yhat, beta=beta, pos_label=1, **kw),
            macro_f1=f1_score(y, yhat, average="macro", **kw))
        c["ok"] = c["prec_st"] >= p_min_st and (
            min_prec_sf <= 0 or c["prec_sf"] >= min_prec_sf)
        if fallback is None or c["f2_st"] > fallback["f2_st"]:
            fallback = c
        if not c["ok"]:
            continue
        key = (c["rec_st"], c["f2_st"], c["macro_f1"])
        if best is None or key > (best["rec_st"], best["f2_st"], best["macro_f1"]):
            best = c
    return (fallback, True) if best is None else (best, False)


def _data(seed, n=300):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.3).astype(int)
    p = np.clip(0.3 * y + rng.random(n) * 0.7, 0, 1)
    return p, y


def _check_against_scan(out, p, y, **kw):
    ref, fb = _sequential_st_first(p, y, **kw)
    assert out["used_fallback"] is fb
    assert out["t"] == ref["t"]
    for k in ("prec_st", "rec_st", "prec_sf", "rec_sf", "f2_st", "macro_f1"):
        assert out[k] == pytest.approx(ref[k], abs=1e-12), k
    assert out["meets_constraints"] is (not fb)


@pytest.mark.parametrize("seed", SEEDS)
def test_tune_threshold_st_first_matches_the_sequential_rule(seed):
    p, y = _data(seed)
    out = calibrate.tune_threshold_st_first(p, y)
    assert out == jax_calibrate.tune_threshold_st_first(p, y)
    _check_against_scan(out, p, y)


@pytest.mark.parametrize("seed", SEEDS)
def test_tune_threshold_st_first_with_an_sf_precision_floor(seed):
    p, y = _data(seed)
    kw = dict(p_min_st=0.4, min_prec_sf=0.9)
    out = calibrate.tune_threshold_st_first(p, y, **kw)
    assert out == jax_calibrate.tune_threshold_st_first(p, y, **kw)
    _check_against_scan(out, p, y, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_tune_threshold_st_first_breaks_ties_to_the_smallest_t(seed):
    """Scores on a coarse grid: many thresholds give the same predictions,
    so the lexicographic tie-break decides."""
    p, y = _data(seed)
    p = np.round(p * 4) / 4
    out = calibrate.tune_threshold_st_first(p, y)
    assert out == jax_calibrate.tune_threshold_st_first(p, y)
    _check_against_scan(out, p, y)


def test_tune_threshold_st_first_falls_back_when_no_t_meets_the_floor():
    # ST precision never reaches 0.25: scores anti-correlated with labels
    y = np.array([0] * 95 + [1] * 5)
    p = np.concatenate([np.linspace(0.5, 0.99, 95), np.full(5, 0.01)])
    out = calibrate.tune_threshold_st_first(p, y)
    assert out == jax_calibrate.tune_threshold_st_first(p, y)
    assert out["used_fallback"] and not out["meets_constraints"]
    _check_against_scan(out, p, y)


def test_tune_threshold_st_first_with_one_class_only():
    p = np.random.default_rng(9).random(60)
    for label in (0, 1):
        y = np.full(60, label)
        out = calibrate.tune_threshold_st_first(p, y)
        assert out == jax_calibrate.tune_threshold_st_first(p, y)
        assert all(np.isfinite(v) for v in out.values() if isinstance(v, float))
