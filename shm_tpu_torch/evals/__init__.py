"""Evaluation metrics."""

from shm_tpu_torch.evals.metrics import (
    accuracy,
    auc,
    average_precision_score,
    binary_prf,
    classification_report_dict,
    confusion_matrix,
    precision_recall_curve,
    precision_recall_fscore,
    roc_auc_score,
    roc_curve,
)

__all__ = [
    "confusion_matrix",
    "accuracy",
    "precision_recall_fscore",
    "roc_curve",
    "auc",
    "roc_auc_score",
    "precision_recall_curve",
    "average_precision_score",
    "binary_prf",
    "classification_report_dict",
]
