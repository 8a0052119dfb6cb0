"""Windowing and standardization."""

from shm_tpu_torch.data.windows import (
    compute_mean_std_from_windows, make_windows, make_windows_np,
    normalize_windows, num_windows, slice_frac,
)

__all__ = ["compute_mean_std_from_windows", "make_windows", "make_windows_np",
           "normalize_windows", "num_windows", "slice_frac"]
