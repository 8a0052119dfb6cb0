"""Windowing and standardization."""

from shm_tpu_torch.data.windows import (
    compute_mean_std_from_windows, compute_standardizer, destandardize,
    make_windows, make_windows_np, normalize_windows, num_windows,
    segment_rmse, slice_frac, standardize, stitch_windows,
)

__all__ = ["compute_mean_std_from_windows", "compute_standardizer",
           "destandardize", "make_windows", "make_windows_np",
           "normalize_windows", "num_windows", "segment_rmse", "slice_frac",
           "standardize", "stitch_windows"]
