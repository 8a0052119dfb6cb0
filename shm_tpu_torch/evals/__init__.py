"""Evaluation metrics."""

from shm_tpu_torch.evals.metrics import accuracy, confusion_matrix

__all__ = ["accuracy", "confusion_matrix"]
