"""Classification metrics in numpy (counterpart of ``shm_tpu/evals/metrics.py``).

sklearn semantics (zero_division=0; ROC and PR curves at the distinct score
cut points, descending score; AP as sklearn's step sum), with no sklearn
import: a CUDA host may lack it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) count matrix, rows = true, cols = predicted."""
    y_true = np.asarray(y_true, np.int64)
    y_pred = np.asarray(y_pred, np.int64)
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    return cm


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if y_true.size else 0.0


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)


def precision_recall_fscore(
    y_true, y_pred, num_classes: int, beta: float = 1.0
) -> Dict[str, np.ndarray]:
    """Per-class precision / recall / F-beta / support, and their macro and
    support-weighted averages (zero_division=0)."""
    cm = confusion_matrix(y_true, y_pred, num_classes).astype(np.float64)
    tp = np.diag(cm)
    prec = _safe_div(tp, cm.sum(axis=0))
    rec = _safe_div(tp, cm.sum(axis=1))
    b2 = beta * beta
    f = _safe_div((1 + b2) * prec * rec, b2 * prec + rec)
    support = cm.sum(axis=1)
    total = max(support.sum(), 1.0)
    return {
        "precision": prec,
        "recall": rec,
        "fscore": f,
        "support": support.astype(np.int64),
        "macro": np.array([prec.mean(), rec.mean(), f.mean()]),
        "weighted": np.array([
            (prec * support).sum() / total,
            (rec * support).sum() / total,
            (f * support).sum() / total,
        ]),
    }


def binary_prf(y_true, y_pred) -> Dict[str, float]:
    """Binary precision / recall / F1 of the positive class (label 1)."""
    r = precision_recall_fscore(y_true, y_pred, 2)
    return {
        "precision": float(r["precision"][1]),
        "recall": float(r["recall"][1]),
        "f1": float(r["fscore"][1]),
    }


def _binary_clf_curve(y_true, score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fps, tps, thresholds) at the distinct score cut points, descending."""
    y_true = np.asarray(y_true).astype(np.int64)
    score = np.asarray(score, np.float64)
    order = np.argsort(-score, kind="stable")
    score = score[order]
    y_true = y_true[order]
    idx = np.r_[np.where(np.diff(score))[0], y_true.size - 1]
    tps = np.cumsum(y_true)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    return fps, tps, score[idx]


def roc_curve(y_true, score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) with sklearn's (0, 0) anchor at threshold inf;
    collinear points are kept (sklearn drops them; the area is the same)."""
    fps, tps, thr = _binary_clf_curve(y_true, score)
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thr = np.r_[np.inf, thr]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.zeros_like(fps)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    return fpr, tpr, thr


def auc(x, y) -> float:
    """Trapezoidal area under a curve given ascending x."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return float(np.trapezoid(y, x))


def roc_auc_score(y_true, score) -> float:
    fpr, tpr, _ = roc_curve(y_true, score)
    return auc(fpr, tpr)


def precision_recall_curve(y_true, score) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds) in sklearn's orientation: ascending
    thresholds, with the final (1, 0) anchor."""
    fps, tps, thr = _binary_clf_curve(y_true, score)
    prec = _safe_div(tps, tps + fps)
    rec = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    return np.r_[prec[::-1], 1.0], np.r_[rec[::-1], 0.0], thr[::-1]


def average_precision_score(y_true, score) -> float:
    """AP = sum_n (R_n - R_{n-1}) P_n (sklearn's step sum)."""
    prec, rec, _ = precision_recall_curve(y_true, score)
    return float(-np.sum(np.diff(rec) * prec[:-1]))


def classification_report_dict(y_true, y_pred, labels) -> Dict[str, Dict[str, float]]:
    """sklearn's ``classification_report(output_dict=True)`` shape: per-label
    precision / recall / f1-score / support, accuracy, macro and weighted
    averages."""
    r = precision_recall_fscore(y_true, y_pred, len(labels))
    out: Dict[str, Dict[str, float]] = {}
    for i, name in enumerate(labels):
        out[str(name)] = {
            "precision": float(r["precision"][i]),
            "recall": float(r["recall"][i]),
            "f1-score": float(r["fscore"][i]),
            "support": int(r["support"][i]),
        }
    total = int(r["support"].sum())
    out["accuracy"] = {"accuracy": accuracy(y_true, y_pred), "support": total}
    for avg, vals in (("macro avg", r["macro"]), ("weighted avg", r["weighted"])):
        out[avg] = {
            "precision": float(vals[0]),
            "recall": float(vals[1]),
            "f1-score": float(vals[2]),
            "support": total,
        }
    return out


__all__ = [
    "confusion_matrix",
    "accuracy",
    "precision_recall_fscore",
    "binary_prf",
    "roc_curve",
    "auc",
    "roc_auc_score",
    "precision_recall_curve",
    "average_precision_score",
    "classification_report_dict",
]
