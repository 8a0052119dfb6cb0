"""Split construction (counterpart of ``shm_tpu/data/splits.py``), pure
Python and numpy.

- 4DOF (``make-splits``): each run's windows split by index into contiguous
  40/30/30 time blocks (no shuffle), in the ``run_splits.json`` schema:
  ``files`` + ``window_indices`` per class, and ``totals``.
- openLAB: whole runs shuffled by Python's ``random`` (seed 42) and split
  40/30/30, with the rounding fixes of the reference.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

from shm_tpu_torch.data.windows import num_windows


def stable_int(s: str) -> int:
    """A string's stable hash: the first 8 hex digits of its md5."""
    return int(hashlib.md5(s.encode("utf-8")).hexdigest()[:8], 16)


def split_indices_contiguous(
    n: int, train_frac: float = 0.40, val_frac: float = 0.30
) -> Dict[str, List[int]]:
    """Contiguous train/val/test blocks of ``range(n)``; each size floored,
    the remainder to test."""
    if n <= 0:
        return {"train": [], "val": [], "test": []}
    n_tr = int(train_frac * n)
    n_va = int(val_frac * n)
    n_te = max(n - n_tr - n_va, 0)
    return {
        "train": list(range(0, n_tr)),
        "val": list(range(n_tr, n_tr + n_va)),
        "test": list(range(n_tr + n_va, n_tr + n_va + n_te)),
    }


def build_window_split_group(
    files_and_rows: Sequence[Tuple[str, int]],
    seq_len: int,
    stride: int,
    train_frac: float = 0.40,
    val_frac: float = 0.30,
) -> Tuple[Dict[str, object], int, int, int]:
    """The group dict of one class of runs and its train/val/test totals.

    ``files_and_rows``: (path, number of data rows without the header)
    pairs; a run too short for one window is left out.
    """
    files: List[str] = []
    win_map: Dict[str, Dict[str, List[int]]] = {}
    tr = va = te = 0
    for fp, n_rows in files_and_rows:
        n_win = num_windows(n_rows, seq_len, stride)
        if n_win <= 0:
            continue
        files.append(fp)
        split = split_indices_contiguous(n_win, train_frac, val_frac)
        win_map[fp] = split
        tr += len(split["train"])
        va += len(split["val"])
        te += len(split["test"])
    return {"files": files, "window_indices": win_map}, tr, va, te


def make_run_splits_json(
    normal: Sequence[Tuple[str, int]],
    sensor: Sequence[Tuple[str, int]],
    structural: Sequence[Tuple[str, int]],
    *,
    seq_len: int = 100,
    stride: int = 1,
    seed: int = 42,
    train_frac: float = 0.40,
    val_frac: float = 0.30,
) -> Dict:
    """The whole ``run_splits.json`` document of the three classes."""
    g_n, ntr, nva, nte = build_window_split_group(normal, seq_len, stride, train_frac, val_frac)
    g_s, s_tr, sva, ste = build_window_split_group(sensor, seq_len, stride, train_frac, val_frac)
    g_t, ttr, tva, tte = build_window_split_group(structural, seq_len, stride, train_frac, val_frac)
    return {
        "mode": "window_level_per_file",
        "seed": seed,
        "fractions": {"train": train_frac, "val": val_frac,
                      "test": round(1.0 - train_frac - val_frac, 10)},
        "seq_len": seq_len,
        "stride": stride,
        "normal": g_n,
        "sensor_fault": g_s,
        "structural_fault": g_t,
        "totals": {
            "normal": {"train": ntr, "val": nva, "test": nte},
            "sensor_fault": {"train": s_tr, "val": sva, "test": ste},
            "structural_fault": {"train": ttr, "val": tva, "test": tte},
        },
        "note": "Option A contiguous time-block split per file (no shuffle).",
    }


def run_based_split(
    run_ids: Sequence[str],
    *,
    seed: int = 42,
    train_frac: float = 0.40,
    val_frac: float = 0.30,
) -> Dict[str, List[str]]:
    """Shuffle the sorted run ids with Python's ``random`` seeded ``seed``
    and split them train/val/test, each at least one run: sizes rounded,
    then trimmed from test, val, train in that order (or test grown) until
    they sum to the number of runs."""
    import random as _random

    ids = sorted(str(r) for r in run_ids)
    n = len(ids)
    if n < 3:
        # each split needs a run: with n <= 2 the floors of 1 below could
        # never sum to n
        raise ValueError(f"Need at least 3 runs for a train/val/test split, "
                         f"got {n}")
    rng = _random.Random()
    rng.seed(seed)
    rng.shuffle(ids)
    n_tr = max(1, int(round(train_frac * n)))
    n_va = max(1, int(round(val_frac * n)))
    n_te = max(1, n - n_tr - n_va)
    while n_tr + n_va + n_te > n:
        if n_te > 1:
            n_te -= 1
        elif n_va > 1:
            n_va -= 1
        else:
            n_tr -= 1
    while n_tr + n_va + n_te < n:
        n_te += 1
    return {
        "train": ids[:n_tr],
        "val": ids[n_tr:n_tr + n_va],
        "test": ids[n_tr + n_va:],
    }


__all__ = [
    "stable_int",
    "split_indices_contiguous",
    "build_window_split_group",
    "make_run_splits_json",
    "run_based_split",
]
