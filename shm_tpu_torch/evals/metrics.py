"""Classification metrics in numpy (counterpart of ``shm_tpu/evals/metrics.py``)."""

from __future__ import annotations

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


__all__ = ["confusion_matrix", "accuracy"]
