"""Threshold calibration in numpy (counterpart of ``shm_tpu/calibrate.py``).

- gate threshold: a percentile of healthy-window MSE scores;
- score summaries;
- ST-first decision-threshold tuning over a fixed 99-point grid, the whole
  grid evaluated at once.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def percentile_threshold(scores, q: float) -> float:
    """q-th percentile with numpy's default linear interpolation."""
    return float(np.percentile(np.asarray(scores), q))


def summarize_scores(scores) -> Dict[str, float]:
    """n, mean, std (biased), p50/p90/p95/p99, max and min; {} when empty."""
    s = np.asarray(scores)
    if s.size == 0:
        return {}
    return {
        "n": float(s.size),
        "mean": float(np.mean(s)),
        "std": float(np.std(s)),
        "p50": float(np.percentile(s, 50)),
        "p90": float(np.percentile(s, 90)),
        "p95": float(np.percentile(s, 95)),
        "p99": float(np.percentile(s, 99)),
        "max": float(np.max(s)),
        "min": float(np.min(s)),
    }


def _fbeta(prec: np.ndarray, rec: np.ndarray, beta: float) -> np.ndarray:
    b2 = beta * beta
    denom = b2 * prec + rec
    return np.where(denom > 0,
                    (1 + b2) * prec * rec / np.where(denom > 0, denom, 1.0), 0.0)


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)


def tune_threshold_st_first(
    p_st: np.ndarray,
    y_true: np.ndarray,
    *,
    p_min_st: float = 0.25,
    min_prec_sf: float = 0.0,
    beta_for_f2_st: float = 2.0,
    grid_points: int = 99,
    grid_lo: float = 0.01,
    grid_hi: float = 0.99,
) -> Dict:
    """ST-first decision threshold: predict ST (1) if p(ST) >= t, else SF (0).

    Among the grid's thresholds whose ST precision reaches ``p_min_st`` (and
    SF precision ``min_prec_sf``, when set), the largest ST recall wins, ties
    broken by ST-F_beta, then macro-F1, then the smallest t. With no
    threshold meeting the floors, the best ST-F_beta overall (smallest t on
    a tie), flagged ``used_fallback``.
    """
    p_st = np.asarray(p_st, np.float64)
    y = np.asarray(y_true, np.int64)
    ts = np.linspace(grid_lo, grid_hi, grid_points)

    yhat = (p_st[None, :] >= ts[:, None]).astype(np.int64)   # (G, N)
    pos = y == 1
    neg = y == 0

    tp_st = (yhat & pos[None, :]).sum(axis=1).astype(np.float64)
    pred_st = yhat.sum(axis=1).astype(np.float64)
    n_st = float(pos.sum())
    tp_sf = ((1 - yhat) & neg[None, :]).sum(axis=1).astype(np.float64)
    pred_sf = (1 - yhat).sum(axis=1).astype(np.float64)
    n_sf = float(neg.sum())

    prec_st = _safe_div(tp_st, pred_st)
    rec_st = tp_st / n_st if n_st > 0 else np.zeros_like(tp_st)
    prec_sf = _safe_div(tp_sf, pred_sf)
    rec_sf = tp_sf / n_sf if n_sf > 0 else np.zeros_like(tp_sf)

    f2_st = _fbeta(prec_st, rec_st, beta_for_f2_st)
    f1_st = _fbeta(prec_st, rec_st, 1.0)
    f1_sf = _fbeta(prec_sf, rec_sf, 1.0)
    macro_f1 = 0.5 * (f1_st + f1_sf)

    meets_st = prec_st >= p_min_st
    meets_sf = (prec_sf >= min_prec_sf) if min_prec_sf > 0 else np.ones_like(meets_st)
    ok = meets_st & meets_sf

    used_fallback = not bool(ok.any())
    if used_fallback:
        i = int(np.argmax(f2_st))           # first (smallest t) of the maxima
    else:
        cand = np.where(ok)[0]
        order = np.lexsort((cand, -macro_f1[cand], -f2_st[cand], -rec_st[cand]))
        i = int(cand[order[0]])

    return {
        "t": float(ts[i]),
        "prec_sf": float(prec_sf[i]),
        "rec_sf": float(rec_sf[i]),
        "prec_st": float(prec_st[i]),
        "rec_st": float(rec_st[i]),
        "f2_st": float(f2_st[i]),
        "macro_f1": float(macro_f1[i]),
        "meets_prec_st": bool(meets_st[i]),
        "meets_prec_sf": bool(meets_sf[i]) if min_prec_sf > 0 else True,
        "meets_constraints": bool(ok[i]),
        "used_fallback": used_fallback,
    }


__all__ = ["percentile_threshold", "summarize_scores", "tune_threshold_st_first"]
