"""JSON / npy / CSV artifact io (counterpart of ``shm_tpu/utils/io.py``).

numpy only: the CSV reader is the ``np.loadtxt`` branch of the JAX package's
``load_csv_numeric``, with the same shape and finiteness guards; the table
writer prints every value as pandas' ``to_csv`` does (the shortest text that
reads back to the same float32 or float64), so either package's tables load
in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np


def ensure_dir(path: str | Path) -> Path:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def save_json(obj: Any, path: str | Path, indent: int = 2) -> None:
    p = Path(path)
    ensure_dir(p.parent)
    with p.open("w", encoding="utf-8") as f:
        json.dump(obj, f, indent=indent)


def save_npy(arr, path: str | Path) -> None:
    p = Path(path)
    ensure_dir(p.parent)
    np.save(p, np.asarray(arr), allow_pickle=False)


def load_json(path: str | Path) -> Any:
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"Missing: {p}")
    with p.open("r", encoding="utf-8") as f:
        return json.load(f)


def load_csv_numeric(path: str | Path, num_features: int | None = None) -> np.ndarray:
    """Numeric CSV with one header row -> float32 (rows, cols).

    Raises on a shape other than 2-D with ``num_features`` columns, and on any
    non-finite value (run CSVs are simulator output and must be all-finite).
    """
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"Missing CSV: {p}")
    X = np.loadtxt(str(p), delimiter=",", skiprows=1, ndmin=2).astype(np.float32)
    if X.ndim != 2 or (num_features is not None and X.shape[1] != num_features):
        raise ValueError(f"Bad CSV shape in {p}: {X.shape}")
    if not np.isfinite(X).all():
        raise ValueError(f"Non-finite values in {p}")
    return X


def save_csv_columns(columns: Dict[str, Any], path: str | Path) -> None:
    """A header of the column names, then one row per index of the equal-
    length 1-D columns, each value as numpy's ``str`` of its own dtype."""
    p = Path(path)
    ensure_dir(p.parent)
    cols = [np.asarray(c).astype(str) for c in columns.values()]
    lines = [",".join(columns)] + [",".join(row) for row in zip(*cols)]
    p.write_text("\n".join(lines) + "\n", encoding="utf-8")


def load_csv_columns(path: str | Path) -> Dict[str, np.ndarray]:
    """A CSV of one header row and numeric rows as float64 columns by name."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"Missing CSV: {p}")
    with p.open("r", encoding="utf-8") as f:
        names = f.readline().strip().split(",")
    X = np.loadtxt(str(p), delimiter=",", skiprows=1, ndmin=2)
    if X.shape[1] != len(names):
        raise ValueError(f"Bad CSV shape in {p}: {X.shape} for {len(names)} columns")
    return {n: X[:, j] for j, n in enumerate(names)}


__all__ = ["ensure_dir", "save_json", "save_npy", "load_json",
           "load_csv_numeric", "save_csv_columns", "load_csv_columns"]
