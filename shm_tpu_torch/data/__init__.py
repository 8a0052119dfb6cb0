"""Windowing and standardization."""

from shm_tpu_torch.data.windows import (
    make_windows, make_windows_np, normalize_windows, num_windows, slice_frac,
)

__all__ = ["make_windows", "make_windows_np", "normalize_windows",
           "num_windows", "slice_frac"]
