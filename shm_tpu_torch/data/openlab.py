"""openLAB (TU Dresden bridge) ingestion, cleaning and weak labels
(counterpart of ``shm_tpu/data/openlab.py``; numpy and the ``csv`` module,
no pandas).

- the catman ``MD_*.txt`` parser: cp1252, ``T0`` on header line 12, 36
  header lines, then a tab-separated decimal-comma table of the 18-column
  channel schema. ``import_catman_file`` keeps the rules of the JAX
  package's ``pd.read_csv(sep="\\t", decimal=",", header=0,
  on_bad_lines="skip")`` and ``pd.to_numeric(errors="coerce")``: a row with
  more fields than the header is dropped and one with fewer is padded with
  NaN (a first data row with one field more makes the first column the
  index, as pandas does), blank lines are skipped, ``"..."`` quotes a tab,
  pandas' NA tokens are NaN, and a column with one other non-numeric token
  stays text, which ``to_numeric`` then reads with a ``.`` decimal point
  (so its ``"1,5"`` values become NaN). A float is parsed correctly
  rounded, where pandas' parser may be one float64 ulp off; every channel
  the extraction reads is cast to float32, where the two agree.
- the provider-aligned cleaning: the removed mask is ``cummax(trigger)``
  over invalid samples and AND-rule jumps, the removed tail filled with the
  last valid value, then a centred zero-padded moving average;
- the provider's AND-rule raw outlier mask, windowing, the weak labels
  (SF > ST > Normal), and the silver-flag helpers.

The code after the parser is the JAX module's, line for line; ``extract_run``
returns its window table and diagnostics as ordered columns of numpy arrays
(``utils/io.py::save_csv_columns`` writes them as ``to_csv`` does).
"""

from __future__ import annotations

import csv
import datetime as _dt
import io
import os
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from shm_tpu_torch.config import OpenLabConfig

CATMAN_SKIPROWS = 36
T0_LINE_INDEX = 12
T0_PATTERN = re.compile(r"T0\s*=\s*(\d{2})\.(\d{2})\.(\d{4})\s+(\d{2}):(\d{2}):(\d{2})")
CATMAN_COLUMNS = [
    "Time_1", "DMS_1", "Time_2", "Force_N", "Force_A", "IWA", "Temp_Bridge",
    "Temp_Ambient", "Time_3", "LWA_1", "LWA_2", "LWA_3", "Time_4", "LWA_4",
    "LWA_5", "NMA_5", "F_total", "Comment",
]

LABEL_NORMAL = "Normal"
LABEL_SENSOR_FAULT = "Sensor Fault"
LABEL_STRUCT_FAULT = "Structural Fault"

# pandas' default NA tokens (read_csv's na_values)
NA_TOKENS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
])
_INF = r"[+-]?inf(?:inity)?"
# a number as read_csv(decimal=",") takes it, and as to_numeric takes text
_TABLE_NUMBER = re.compile(
    rf"\s*(?:[+-]?(?:\d+(?:,\d*)?|,\d+)(?:[eE][+-]?\d+)?|{_INF})\s*",
    re.ASCII | re.IGNORECASE)
_TEXT_NUMBER = re.compile(
    rf"\s*(?:[+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?|{_INF})\s*",
    re.ASCII | re.IGNORECASE)


class CatmanRun:
    """One parsed catman export: its 18 channel columns as numpy arrays by
    name (a numeric column float64, ``Time_1`` already through
    :func:`to_numeric`; a column with a non-numeric token an object array
    of its text, NaN for NA tokens), and ``t0``, the acquisition start
    (``Time_1`` counts seconds from it)."""

    def __init__(self, columns: Dict[str, np.ndarray], t0: _dt.datetime):
        self.columns = columns
        self.t0 = t0

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __len__(self) -> int:
        return len(self.columns["Time_1"])


def _split_lines(text: str, n_header: int) -> Tuple[List[str], str]:
    """Split raw file text into (first n_header lines, remainder text).

    The remainder keeps its own first line as the table's column row.
    Lines are delimited by ``\\n`` only (as pandas counts rows):
    ``str.splitlines`` would also break on \\v, \\f, \\x1c-\\x1e and a lone
    \\r, all possible inside a free-text Comment field, and shift the
    header/table boundary.
    """
    idx = 0
    for _ in range(n_header):
        j = text.find("\n", idx)
        if j < 0:
            return [ln.rstrip("\r") for ln in text.split("\n")], ""
        idx = j + 1
    header = [ln.rstrip("\r") for ln in text[:idx].split("\n")[:n_header]]
    return header, text[idx:]


def _blank(record: List[str]) -> bool:
    return not record or (len(record) == 1 and not record[0].strip())


def _table_records(table: str) -> Tuple[List[str], List[List[str]]]:
    """(column names, data rows) of a tab-separated table as ``read_csv``
    with ``header=0, on_bad_lines="skip"`` shapes it: ``\\n``, ``\\r\\n``
    and a lone ``\\r`` end a row outside quotes, blank rows are skipped, a
    longer row than the header is dropped, a shorter one padded with NA."""
    rows = [r for r in csv.reader(io.StringIO(table, newline=""),
                                  delimiter="\t", quotechar='"',
                                  doublequote=True, strict=False)
            if not _blank(r)]
    if not rows:
        return [], []
    names, body = rows[0], rows[1:]
    width = len(names)
    lead = 1 if body and len(body[0]) == width + 1 else 0   # implicit index
    out = []
    for r in body:
        if len(r) > width + lead:
            continue
        r = r[lead:]
        out.append(r + [""] * (width - len(r)))
    return names, out


def _table_column(tokens: Sequence[str]) -> np.ndarray:
    """A column's tokens as ``read_csv(decimal=",")`` types them: float64
    if every token is an NA token or a number, else the text (NA tokens as
    NaN) in an object array."""
    values = []
    for t in tokens:
        if t in NA_TOKENS:
            values.append(np.nan)
        elif _TABLE_NUMBER.fullmatch(t):
            values.append(float(t.replace(",", ".")))
        else:
            return np.array([np.nan if v in NA_TOKENS else v for v in tokens],
                            object)
    return np.array(values, np.float64)


def to_numeric(column: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(column, errors="coerce")`` as float64: a numeric
    column as it is; a text column read with a ``.`` decimal point, what
    does not read as a number NaN."""
    column = np.asarray(column)
    if column.dtype != object:
        return column.astype(np.float64)
    return np.array([float(v) if isinstance(v, str) and _TEXT_NUMBER.fullmatch(v)
                     else np.nan for v in column], np.float64)


def import_catman_file(file_path: str | os.PathLike) -> CatmanRun:
    """Parse an HBK catman ``MD_*.txt`` export (module docstring): the file
    is read once, header and table split from the same text, ``T0`` taken
    from the header's line 12. A header shorter than the format's, a
    missing ``T0`` or a table of another width raise ``ValueError``."""
    file_path = os.fspath(file_path)
    # newline="" keeps a lone \r inside a Comment field as it is (universal
    # newlines would make it a \n and shift the header/table boundary)
    with open(file_path, encoding="cp1252", newline="") as f:
        text = f.read()
    header, table = _split_lines(text, CATMAN_SKIPROWS)
    if len(header) <= T0_LINE_INDEX or not table:
        raise ValueError(f"{file_path!r}: not a catman export "
                         f"(header shorter than {CATMAN_SKIPROWS} lines)")
    m = T0_PATTERN.search(header[T0_LINE_INDEX])
    if m is None:
        raise ValueError(f"{file_path!r}: no 'T0 = dd.mm.yyyy HH:MM:SS' on "
                         f"header line {T0_LINE_INDEX}")
    day, month, year, hh, mm, ss = (int(g) for g in m.groups())
    t0 = _dt.datetime(year, month, day, hh, mm, ss)

    names, rows = _table_records(table)
    if len(names) != len(CATMAN_COLUMNS):
        raise ValueError(f"{file_path!r}: expected {len(CATMAN_COLUMNS)} "
                         f"channels, found {len(names)}")
    fields = list(zip(*rows)) if rows else [()] * len(names)
    columns = {c: _table_column(f) for c, f in zip(CATMAN_COLUMNS, fields)}
    columns["Time_1"] = to_numeric(columns["Time_1"])
    return CatmanRun(columns, t0)


def run_id_from_path(file_path: str | os.PathLike) -> str:
    return Path(file_path).stem


# ---------------------------------------------------------------------------
# cleaning
# ---------------------------------------------------------------------------


def moving_average(x: np.ndarray, w: int) -> np.ndarray:
    """Centered moving average with implicit zero padding (np.convolve 'same')."""
    if w is None or w <= 1:
        return x
    kern = np.ones(int(w)) / float(w)
    return np.convolve(x, kern, mode="same")


def clean_openlab_and_rule(
    x: np.ndarray, max_jump: float = 1.0, max_abs: float = 65.0, ma_window: int = 5
) -> Tuple[np.ndarray, np.ndarray]:
    """Provider-aligned AND-rule cleaning, vectorized: a sample is removed
    if invalid, if (|dx| > max_jump AND |x| > max_abs) against the previous
    sample, or if the previous sample was removed (the cascade, so the mask
    is a cummax). Removed samples take the last valid value; the result is
    smoothed by a centred moving average.

    Returns (cleaned float32, removed_mask float32).
    """
    x = np.asarray(x, dtype=float)
    n = x.size
    finite = np.isfinite(x)
    trigger = ~finite
    if n > 1:
        jmp = np.zeros(n, dtype=bool)
        dx = np.abs(np.diff(x))
        jmp[1:] = finite[1:] & finite[:-1] & (dx > float(max_jump)) \
            & (np.abs(x[1:]) > float(max_abs))
        trigger = trigger | jmp
    removed = np.maximum.accumulate(trigger)

    x2 = np.where(removed, np.nan, x)
    valid_idx = np.flatnonzero(~removed)
    if valid_idx.size:
        last = valid_idx[-1]
        xi = x2.copy()
        if last + 1 < n:
            xi[last + 1:] = x2[last]
    else:
        xi = x2
    xi = moving_average(xi, ma_window)
    return xi.astype(np.float32), removed.astype(np.float32)


def provider_raw_outlier_mask_and(
    u_raw: np.ndarray, diff_th: float = 1.0, abs_th: float = 65.0
) -> np.ndarray:
    """The provider's AND rule on the RAW displacement."""
    u = np.asarray(u_raw, dtype=np.float32)
    n = u.size
    m = ~np.isfinite(u)
    if n > 1:
        du = np.abs(np.diff(u))
        m[1:] |= (du >= float(diff_th)) & (np.abs(u[1:]) >= float(abs_th))
    return m.astype(np.float32)


# ---------------------------------------------------------------------------
# windowization (host; shapes are data-dependent)
# ---------------------------------------------------------------------------


def windowize_2d(A: np.ndarray, seq_len: int, stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """(N, K) -> (W, seq_len, K) windows + start indices, as one strided gather."""
    n = A.shape[0]
    if n < seq_len:
        return (np.empty((0, seq_len, A.shape[1]), np.float32),
                np.empty((0,), int))
    idx0 = np.arange(0, n - seq_len + 1, stride)
    X = A[idx0[:, None] + np.arange(seq_len)[None, :]]
    return X.astype(np.float32), idx0.astype(int)


def windowize_1d(x: np.ndarray, seq_len: int, stride: int) -> Tuple[np.ndarray, np.ndarray]:
    n = x.shape[0]
    if n < seq_len:
        return np.empty((0, seq_len), np.float32), np.empty((0,), int)
    idx0 = np.arange(0, n - seq_len + 1, stride)
    W = x[idx0[:, None] + np.arange(seq_len)[None, :]]
    return W.astype(np.float32), idx0.astype(int)


# ---------------------------------------------------------------------------
# weak-supervision silver rules, vectorized over window stacks: the metrics'
# semantics (finite-sample denominators, >= against >, the <5-finite stuck
# guard, the SF-any precedence) are the reference's rule specification
# ---------------------------------------------------------------------------


def _masked_rowvar(X: np.ndarray, ok: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (population) variance over finite entries + finite counts."""
    cnt = ok.sum(axis=1)
    denom = np.maximum(cnt, 1)
    mean = np.where(ok, X, 0.0).sum(axis=1) / denom
    var = np.where(ok, (X - mean[:, None]) ** 2, 0.0).sum(axis=1) / denom
    return var, cnt


def silver_flag_metrics_batch(
    U_raw: np.ndarray,
    U_clean: np.ndarray | None = None,
    F: np.ndarray | None = None,
    *,
    jump_th: float = 1.0,
    abs_th: float = 65.0,
    invalid_ratio_th: float = 0.05,
    var_eps: float = 1e-6,
    force_rng_min: float = 0.0,
    use_plain_stuck: bool = True,
) -> Dict[str, np.ndarray]:
    """All six silver-rule SF metrics for an (N, T) window stack at once,
    arrays of shape (N,). :func:`extract_run` does not use them: its labels
    follow their own rule set (windowed provider masks, envelope variance,
    the DMS load range)."""
    U = np.atleast_2d(np.asarray(U_raw, dtype=float))
    N, T = U.shape
    fin = np.isfinite(U)

    # invalid ratio over ALL samples (denominator T, not the finite count)
    inv_ratio = (~fin).mean(axis=1) if T else np.zeros(N)

    # jump ratio over finite-adjacent pairs (rows with no finite pair: 0)
    if T < 2:
        jr = np.zeros(N)
    else:
        pair_ok = fin[:, :-1] & fin[:, 1:]
        n_pairs = pair_ok.sum(axis=1)
        hits = (pair_ok & (np.abs(np.diff(U, axis=1)) >= float(jump_th))).sum(axis=1)
        jr = np.where(n_pairs > 0, hits / np.maximum(n_pairs, 1), 0.0)

    # range-violation ratio among finite samples
    n_fin = fin.sum(axis=1)
    rv_hits = (fin & (np.abs(np.where(fin, U, 0.0)) >= float(abs_th))).sum(axis=1)
    rr = np.where(n_fin > 0, rv_hits / np.maximum(n_fin, 1), 0.0)

    # stuck: variance of finite samples < eps, needing >= 5 finite
    Us = (np.atleast_2d(np.asarray(U_clean, dtype=float))
          if U_clean is not None else U)
    s_fin = np.isfinite(Us)
    var_u, cnt_u = _masked_rowvar(Us, s_fin)
    stuck = (cnt_u >= 5) & (var_u < float(var_eps))

    # force-aware stuck: flat displacement WHILE the load swings
    if F is not None and force_rng_min > 0.0:
        Fa = np.atleast_2d(np.asarray(F, dtype=float))
        f_fin = np.isfinite(Fa)
        f_cnt = f_fin.sum(axis=1)
        f_max = np.where(f_fin, Fa, -np.inf).max(axis=1)
        f_min = np.where(f_fin, Fa, np.inf).min(axis=1)
        stuck_fa = ((cnt_u >= 5) & (f_cnt >= 5) & (var_u < float(var_eps))
                    & (f_max - f_min > float(force_rng_min)))
    else:
        stuck_fa = np.zeros(N, dtype=bool)

    stuck_term = stuck_fa | (stuck if use_plain_stuck else False)
    sf_any = ((inv_ratio >= float(invalid_ratio_th)) | (jr > 0.0) | (rr > 0.0)
              | stuck_term)
    return {
        "invalid_ratio": inv_ratio.astype(float),
        "jump_ratio": jr.astype(float),
        "range_violation_ratio": rr.astype(float),
        "stuck": stuck.astype(int),
        "stuck_forceaware": stuck_fa.astype(int),
        "sf_any": sf_any.astype(int),
    }


def invalid_ratio_1d(x: np.ndarray) -> float:
    """Non-finite fraction."""
    x = np.asarray(x, dtype=float)
    return float(np.mean(~np.isfinite(x))) if x.size else 0.0


def jump_ratio_1d(x: np.ndarray, delta: float) -> float:
    """|dx| >= delta fraction among finite pairs."""
    x = np.asarray(x, dtype=float)
    ok = np.isfinite(x[:-1]) & np.isfinite(x[1:]) if x.size >= 2 else np.zeros(0, bool)
    if not ok.any():
        return 0.0
    return float(np.mean(np.abs(np.diff(x))[ok] >= float(delta)))


def range_violation_ratio_1d(x: np.ndarray, abs_th: float) -> float:
    """|x| >= abs_th fraction among finite samples."""
    x = np.asarray(x, dtype=float)
    ok = np.isfinite(x)
    if not ok.any():
        return 0.0
    return float(np.mean(np.abs(x[ok]) >= float(abs_th)))


def is_stuck_1d(x: np.ndarray, var_eps: float) -> bool:
    """Flatline: finite-sample variance < eps, >= 5 finite."""
    x = np.asarray(x, dtype=float)[None]
    var, cnt = _masked_rowvar(x, np.isfinite(x))
    return bool(cnt[0] >= 5 and var[0] < float(var_eps))


def is_stuck_force_aware(u: np.ndarray, f: np.ndarray, var_eps: float,
                         force_rng_min: float) -> bool:
    """Flat displacement under a swinging load."""
    u2 = np.asarray(u, dtype=float)[None]
    var, cnt = _masked_rowvar(u2, np.isfinite(u2))
    fv = np.asarray(f, dtype=float)
    fv = fv[np.isfinite(fv)]
    if cnt[0] < 5 or fv.size < 5:
        return False
    return bool(var[0] < float(var_eps)
                and (fv.max() - fv.min()) > float(force_rng_min))


def channel_inconsistency_score(U: np.ndarray, zthr: float = 4.0) -> float:
    """Fraction of time rows where any channel's robust z-score (median/MAD
    across channels) reaches ``zthr``. Rows with a non-finite channel are
    left out; needs >= 5 valid rows."""
    U = np.asarray(U, dtype=float)
    if U.ndim != 2 or U.shape[0] < 2 or U.shape[1] < 2:
        return 0.0
    ok = np.all(np.isfinite(U), axis=1)
    if np.sum(ok) < 5:
        return 0.0
    V = U[ok]
    med = np.median(V, axis=1, keepdims=True)
    mad = np.median(np.abs(V - med), axis=1, keepdims=True) + 1e-9
    z = np.abs((V - med) / (1.4826 * mad))
    return float(np.mean(np.any(z >= float(zthr), axis=1)))


def sensor_fault_silver_flags(
    u_raw: np.ndarray,
    u_clean: np.ndarray | None = None,
    f: np.ndarray | None = None,
    *,
    jump_th: float = 1.0,
    abs_th: float = 65.0,
    invalid_ratio_th: float = 0.05,
    var_eps: float = 1e-6,
    force_rng_min: float = 0.0,
    use_plain_stuck: bool = True,
) -> Dict:
    """Single-window silver-rule SF flags; a thin wrapper over
    :func:`silver_flag_metrics_batch`."""
    m = silver_flag_metrics_batch(
        np.asarray(u_raw, float)[None],
        U_clean=(np.asarray(u_clean, float)[None] if u_clean is not None else None),
        F=(np.asarray(f, float)[None] if f is not None else None),
        jump_th=jump_th, abs_th=abs_th, invalid_ratio_th=invalid_ratio_th,
        var_eps=var_eps, force_rng_min=force_rng_min,
        use_plain_stuck=use_plain_stuck)
    return {k: (float(v[0]) if v.dtype.kind == "f" else int(v[0]))
            for k, v in m.items()}


# ---------------------------------------------------------------------------
# window extraction + weak labeling
# ---------------------------------------------------------------------------


def extract_run(
    run: CatmanRun, run_id: str, cfg: OpenLabConfig,
    struct_clean_channels: Sequence[str] = ("LWA_3",),
):
    """Windows and weak labels of one parsed run.

    Returns ``(Xc, Xr, meta, diag)``: the clean and raw (W, seq_len, 4)
    float32 windows [DMS_1, LWA_2, LWA_3, LWA_4], the window table as
    ordered columns (``window_labels.csv``'s), and the run's diagnostics
    (one ``run_diagnostics.csv`` row); ``None`` if the run is shorter than
    a window.
    """
    def to_float(col):
        return to_numeric(run[col]).astype(np.float32)

    dms = to_float("DMS_1")
    raws = {c: to_float(c) for c in ("LWA_2", "LWA_3", "LWA_4")}
    for c, u in raws.items():
        u[u <= cfg.obstruction_sentinel] = np.nan

    outs = {c: provider_raw_outlier_mask_and(u, cfg.raw_diff_th_mm, cfg.raw_abs_th_mm)
            for c, u in raws.items()}
    invs = {c: (~np.isfinite(u)).astype(np.float32) for c, u in raws.items()}
    raw_out_mask = np.maximum.reduce(list(outs.values()))
    raw_inv_mask = np.maximum.reduce(list(invs.values()))

    cleans, removeds = {}, {}
    for c, u in raws.items():
        cleans[c], removeds[c] = clean_openlab_and_rule(
            u, cfg.clean_max_jump_mm, cfg.clean_max_abs_mm, cfg.moving_avg_window)
    removed_mask = np.maximum.reduce(list(removeds.values()))

    A_clean = np.stack([dms, cleans["LWA_2"], cleans["LWA_3"], cleans["LWA_4"]],
                       axis=1).astype(np.float32)
    A_raw = np.stack([dms, raws["LWA_2"], raws["LWA_3"], raws["LWA_4"]],
                     axis=1).astype(np.float32)

    keep = np.isfinite(dms)
    A_clean, A_raw = A_clean[keep], A_raw[keep]
    raw_out_mask, raw_inv_mask = raw_out_mask[keep], raw_inv_mask[keep]
    removed_mask = removed_mask[keep]

    Xc, idx0 = windowize_2d(A_clean, cfg.seq_len, cfg.stride)
    Xr, idx0r = windowize_2d(A_raw, cfg.seq_len, cfg.stride)
    if Xc.shape[0] == 0:
        return None
    if not np.array_equal(idx0, idx0r):
        raise RuntimeError(f"Run {run_id}: raw/clean window start mismatch.")

    outW, _ = windowize_1d(raw_out_mask, cfg.seq_len, cfg.stride)
    invW, _ = windowize_1d(raw_inv_mask, cfg.seq_len, cfg.stride)
    remW, _ = windowize_1d(removed_mask, cfg.seq_len, cfg.stride)
    raw_out_ratio = outW.mean(axis=1).astype(np.float32)
    raw_inv_ratio = invW.mean(axis=1).astype(np.float32)
    removed_ratio = remW.mean(axis=1).astype(np.float32)

    name_to_idx = {"LWA_2": 1, "LWA_3": 2, "LWA_4": 3}
    struct_idxs = [name_to_idx[c] for c in struct_clean_channels]
    U = np.stack([Xc[:, :, j] for j in struct_idxs], axis=2)

    with np.errstate(all="ignore"):
        u_min = np.nanmin(U, axis=(1, 2)).astype(np.float32)
        u_max = np.nanmax(U, axis=(1, 2)).astype(np.float32)
        all_nan_struct = (~np.isfinite(u_min)) | (~np.isfinite(u_max))
        dms_win = Xc[:, :, 0]
        dms_rng = (np.nanmax(dms_win, axis=1) - np.nanmin(dms_win, axis=1)).astype(np.float32)
        u_var = np.nanvar(U, axis=(1, 2)).astype(np.float32)

    flatline_loadaware = ((u_var < cfg.flat_var_eps)
                          & (dms_rng > cfg.force_range_for_flatline)).astype(int)

    sensor_fault = ((raw_inv_ratio >= float(cfg.raw_invalid_ratio_fault))
                    | (raw_out_ratio > 0.0)
                    | (removed_ratio > 0.0)
                    | (flatline_loadaware == 1)
                    | all_nan_struct)
    structural_fault = u_max > float(cfg.allow_max)

    label = np.full((len(u_max),), LABEL_NORMAL, dtype=object)
    label[structural_fault & (~sensor_fault)] = LABEL_STRUCT_FAULT
    label[sensor_fault] = LABEL_SENSOR_FAULT

    n = len(u_max)
    struct_names = ",".join(struct_clean_channels)
    meta = {
        "run_id": np.full(n, run_id, dtype=object),
        "win_start_idx": idx0.astype(int),
        "label": label,
        "u_min": u_min,
        "u_max": u_max,
        "dms_range": dms_rng,
        "raw_invalid_ratio": raw_inv_ratio,
        "raw_outlier_ratio": raw_out_ratio,
        "removed_ratio": removed_ratio,
        "flatline_loadaware": flatline_loadaware,
        "struct_channels_for_u_max": np.full(n, struct_names, dtype=object),
        "all_nan_struct": all_nan_struct.astype(int),
    }

    def pct_abs_gt(x, thr):
        m = np.isfinite(x)
        return float((np.abs(x[m]) > thr).mean()) if m.sum() else 0.0

    with np.errstate(all="ignore"):
        diag = {
            "run_id": run_id,
            "n_samples": int(A_raw.shape[0]),
            "u2_max_raw": float(np.nanmax(raws["LWA_2"])),
            "u3_max_raw": float(np.nanmax(raws["LWA_3"])),
            "u4_max_raw": float(np.nanmax(raws["LWA_4"])),
            "u2_pct_abs_gt65_raw": pct_abs_gt(raws["LWA_2"], 65.0),
            "u3_pct_abs_gt65_raw": pct_abs_gt(raws["LWA_3"], 65.0),
            "u4_pct_abs_gt65_raw": pct_abs_gt(raws["LWA_4"], 65.0),
            "struct_channels_for_u_max": struct_names,
        }
    return Xc, Xr, meta, diag


def extract_all(
    raw_dir: str, cfg: OpenLabConfig,
    struct_clean_channels: Sequence[str] = ("LWA_3",),
):
    """Parse every ``MD_*.txt`` in ``raw_dir`` (sorted) -> ``(X_clean,
    X_raw, meta, diag)``: the windows of every run, the window table's
    columns and the diagnostics' columns (one row a run)."""
    import glob as _glob

    paths = sorted(_glob.glob(os.path.join(raw_dir, "MD_*.txt")))
    if not paths:
        raise FileNotFoundError(f"No MD_*.txt found in RAW_DIR: {raw_dir}")
    Xc_all, Xr_all, metas, diags = [], [], [], []
    for p in paths:
        run_id = run_id_from_path(p)
        res = extract_run(import_catman_file(p), run_id, cfg, struct_clean_channels)
        if res is None:
            continue
        Xc, Xr, meta, diag = res
        Xc_all.append(Xc)
        Xr_all.append(Xr)
        metas.append(meta)
        diags.append(diag)
    if not Xc_all:
        raise RuntimeError("No windows extracted. Check RAW_DIR, SEQ_LEN, STRIDE.")
    meta = {k: np.concatenate([m[k] for m in metas]) for k in metas[0]}
    diag = {k: np.array([d[k] for d in diags],
                        dtype=object if isinstance(diags[0][k], str) else None)
            for k in diags[0]}
    return np.concatenate(Xc_all), np.concatenate(Xr_all), meta, diag


__all__ = [
    "CatmanRun",
    "import_catman_file",
    "to_numeric",
    "run_id_from_path",
    "moving_average",
    "clean_openlab_and_rule",
    "provider_raw_outlier_mask_and",
    "windowize_2d",
    "windowize_1d",
    "silver_flag_metrics_batch",
    "invalid_ratio_1d",
    "jump_ratio_1d",
    "range_violation_ratio_1d",
    "is_stuck_1d",
    "is_stuck_force_aware",
    "channel_inconsistency_score",
    "sensor_fault_silver_flags",
    "extract_run",
    "extract_all",
    "LABEL_NORMAL",
    "LABEL_SENSOR_FAULT",
    "LABEL_STRUCT_FAULT",
    "CATMAN_COLUMNS",
    "CATMAN_SKIPROWS",
    "T0_LINE_INDEX",
    "T0_PATTERN",
]
