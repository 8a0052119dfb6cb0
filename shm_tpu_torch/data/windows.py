"""Sliding windows, standardization, stitching and segment RMSE
(counterpart of ``shm_tpu/data/windows.py``)."""

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


def compute_standardizer(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-feature mean and population std over the time axis of a (T, F)
    series; ``std == 0 -> 1e-6``."""
    mean = x.mean(dim=0)
    std = x.std(dim=0, correction=0)
    return mean, torch.where(std == 0.0, torch.full_like(std, 1e-6), std)


def standardize(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return (x - mean) / std


def destandardize(xn: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return xn * std + mean


def stitch_windows(windows: torch.Tensor, full_len: int, stride: int = 1) -> torch.Tensor:
    """Overlap-average a window stack (N, L, F) back into a (full_len, F)
    float32 series; a sample no window covers is 0.

    The sum runs in a fixed order, one strided slice-add per window offset
    l = L-1 .. 0, so a sample adds its windows in the order of their starts
    (the order of the JAX package's scatter-add on the CPU) and two runs give
    the same bits: no atomics, unlike ``index_add_`` on the card."""
    N, L, F = windows.shape
    if N and (N - 1) * stride + L > full_len:
        raise ValueError(f"{N} windows of {L} at stride {stride} do not fit "
                         f"in {full_len} samples")
    w = windows.to(torch.float32)
    out = w.new_zeros((full_len, F))
    cnt = w.new_zeros((full_len,))
    span = (N - 1) * stride + 1
    for l in range(L - 1, -1, -1):
        out[l:l + span:stride] += w[:, l]
        cnt[l:l + span:stride] += 1.0
    cnt = torch.where(cnt == 0.0, torch.ones_like(cnt), cnt)
    return out / cnt[:, None]


def segment_rmse(y_true: torch.Tensor, y_pred: torch.Tensor,
                 segment_len: int) -> torch.Tensor:
    """RMSE of each ``segment_len``-sample segment of two (T, F) series ->
    (ceil(T / segment_len),); the last segment may be shorter and counts
    only its own samples."""
    T, F = y_true.shape
    S = -(-T // segment_len)
    e2 = torch.nn.functional.pad((y_pred - y_true) ** 2, (0, 0, 0, S * segment_len - T))
    sums = e2.reshape(S, segment_len, F).sum(dim=(1, 2))
    cnt = torch.full((S,), float(segment_len * F), dtype=sums.dtype, device=sums.device)
    cnt[-1] = float((T - (S - 1) * segment_len) * F)
    return torch.sqrt(sums / cnt)


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
           "normalize_windows", "compute_mean_std_from_windows",
           "compute_standardizer", "standardize", "destandardize",
           "stitch_windows", "segment_rmse", "slice_frac"]
