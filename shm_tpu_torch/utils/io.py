"""JSON / npy / CSV artifact io (counterpart of ``shm_tpu/utils/io.py``).

numpy and the ``csv`` module only: the CSV reader is the ``np.loadtxt``
branch of the JAX package's ``load_csv_numeric``, with the same shape and
finiteness guards; the table writers print every value as pandas'
``to_csv`` does (the shortest text that reads back to the same float32 or
float64), so either package's tables load in the other; ``load_csv_table``
types a mixed table's columns as ``pandas.read_csv`` does.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Any, Dict, List, Sequence

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


def _text(column) -> np.ndarray:
    c = np.asarray(column)
    out = c.astype(str)
    if c.dtype.kind == "f":                      # pandas writes NaN as ""
        out[np.isnan(c)] = ""
    return out


def save_csv_columns(columns: Dict[str, Any], path: str | Path) -> None:
    """A header of the column names, then one row per index of the equal-
    length 1-D columns, each value as numpy's ``str`` of its own dtype (a
    NaN empty)."""
    p = Path(path)
    ensure_dir(p.parent)
    cols = [_text(c) for c in columns.values()]
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


def _column(values: List[str]) -> np.ndarray:
    """One text column typed as ``pandas.read_csv`` types it: int64 if every
    value is an integer, float64 if every value is a number or empty
    (NaN), else text."""
    try:
        return np.array([int(v) for v in values], np.int64)
    except ValueError:
        pass
    try:
        return np.array([float(v) if v != "" else np.nan for v in values],
                        np.float64)
    except ValueError:
        return np.array(values, dtype=np.str_)


def _cell(v) -> str:
    """A value as ``DataFrame.to_csv`` writes it: NaN and None empty, floats
    in their shortest round-trip text, the rest as ``str``."""
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    if isinstance(v, (np.integer, np.bool_)):
        return str(v.item())
    return str(v)


def load_csv_table(path: str | Path) -> Dict[str, np.ndarray]:
    """A CSV of one header row, as typed columns by name (see ``_column``):
    what ``pandas.read_csv`` gives, without pandas."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"Missing CSV: {p}")
    with p.open("r", encoding="utf-8", newline="") as f:
        rows = list(csv.reader(f))
    names, body = rows[0], rows[1:]
    if any(len(r) != len(names) for r in body):
        raise ValueError(f"Bad CSV row width in {p}")
    return {n: _column([r[j] for r in body]) for j, n in enumerate(names)}


def save_csv_records(rows: Sequence[Dict[str, Any]], path: str | Path,
                     names: Sequence[str] | None = None) -> None:
    """Row dicts as ``DataFrame(rows).to_csv(index=False)`` writes them: the
    columns in the order they first appear, a missing value empty."""
    if names is None:
        names = list(dict.fromkeys(k for r in rows for k in r))
    p = Path(path)
    ensure_dir(p.parent)
    with p.open("w", encoding="utf-8", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for r in rows:
            w.writerow([_cell(r.get(n)) for n in names])


__all__ = ["ensure_dir", "save_json", "save_npy", "load_json",
           "load_csv_numeric", "save_csv_columns", "load_csv_columns",
           "load_csv_table", "save_csv_records"]
