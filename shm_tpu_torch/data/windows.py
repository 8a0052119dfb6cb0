"""Sliding windows and standardization (counterpart of ``shm_tpu/data/windows.py``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def num_windows(T: int, seq_len: int, stride: int = 1) -> int:
    """Number of sliding windows over a length-T series (0 if too short)."""
    if T < seq_len:
        return 0
    return (T - seq_len) // stride + 1


def make_windows(x: torch.Tensor, seq_len: int, stride: int = 1) -> torch.Tensor:
    """Sliding windows of a (T, F) series -> (N, seq_len, F), as a view.

    Same windows as the JAX package's gather; a series shorter than
    ``seq_len`` gives an empty (0, seq_len, F) stack.
    """
    if x.shape[0] < seq_len:
        return x.new_zeros((0, seq_len) + tuple(x.shape[1:]))
    return x.unfold(0, seq_len, stride).movedim(-1, 1)


def normalize_windows(W: torch.Tensor, mean: torch.Tensor,
                      std: torch.Tensor) -> torch.Tensor:
    """(W - mean) / std with non-finite values mapped to 0."""
    return torch.nan_to_num((W - mean) / std, nan=0.0, posinf=0.0, neginf=0.0)


def compute_mean_std_from_windows(W: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature mean and population std over a window stack (N, L, F),
    flattened over (N, L); ``std == 0 -> 1e-6``."""
    X = W.reshape(-1, W.shape[-1])
    mean = X.mean(dim=0)
    std = X.std(dim=0, correction=0)
    return mean, torch.where(std == 0.0, torch.full_like(std, 1e-6), std)


def slice_frac(x, frac: Tuple[float, float]):
    """Slice a (T, ...) array to the [frac[0], frac[1]) time fraction
    (``int(n*f0) : int(n*f1)``, end clamped >= start)."""
    n = x.shape[0]
    s = int(n * float(frac[0]))
    e = max(int(n * float(frac[1])), s)
    return x[s:e]


def make_windows_np(x: np.ndarray, seq_len: int, stride: int = 1) -> np.ndarray:
    """Host-side :func:`make_windows` of a numpy series (a copy)."""
    return make_windows(torch.from_numpy(np.ascontiguousarray(x)),
                        seq_len, stride).contiguous().numpy()


__all__ = ["num_windows", "make_windows", "make_windows_np",
           "normalize_windows", "compute_mean_std_from_windows", "slice_frac"]
