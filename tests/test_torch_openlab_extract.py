"""The port's openLAB extraction (``shm_tpu_torch/data/openlab.py``, no
pandas) against the JAX package's ``shm_tpu/data/openlab.py`` on the CPU.

- The catman parser on files this test writes: LF and CRLF endings, a lone
  ``\\r`` inside a Comment (pandas ends the row there), a quoted tab, short
  and long rows, blank lines, NA tokens, one non-numeric token in a channel
  column (the column stays text and ``to_numeric`` reads its decimal-comma
  values as NaN), a first data row one field longer than the header (its
  first column the index), and the same error types for a short header, a
  missing ``T0`` and a table of another width. Every channel the extraction
  reads equals the JAX parser's after the cast to float32, bit for bit; the
  text columns are the same text; ``extract_run`` on each file gives the
  same windows, window table and diagnostics.
- Every cleaning, windowing and silver-flag helper against the JAX one on
  seeded signals with NaN, jumps and sentinels, bit for bit.
- ``extract_all`` on the committed windows written back as catman files
  (``chip_smoke.py::write_catman_runs``): equal to the JAX extraction on
  all 6,432 windows and every window-table column, and against the
  committed files X_raw 6,432 / 6,432 and labels 6,432 / 6,432 bit for bit,
  X_clean 6,425 / 6,432: the other 7 are exactly each run's last window,
  whose centred moving average is zero-padded at the written series' end.
"""

import datetime
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu_torch.config import OpenLabConfig
from shm_tpu_torch.data import openlab as po

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
OL = ROOT / "data" / "openlab"
USED = ("DMS_1", "LWA_2", "LWA_3", "LWA_4")


def jax_openlab():
    from shm_tpu.data import openlab as jo

    return jo


def jax_cfg():
    from shm_tpu.config import OpenLabConfig as JaxOpenLabConfig

    return JaxOpenLabConfig()


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

def _fmt(v) -> str:
    return str(v).replace(".", ",")


def _rows(n: int, seed: int):
    """``n`` rows of 18 fields: a seeded DMS ramp with noise, three LWA
    channels with a jump and sentinels, some values at full precision."""
    rng = np.random.default_rng(seed)
    dms = (np.linspace(0, 8, n) + rng.normal(0, 0.3, n)).astype(np.float32)
    lwa = rng.normal(0, 0.2, (n, 3)).astype(np.float32)
    lwa[n // 2:, 1] += np.float32(25.0)                  # a structural step
    lwa[rng.integers(0, n, 3), 2] = np.float32(-1e6)     # obstruction sentinels
    rows = []
    for i in range(n):
        full = i % 7 == 0                    # float64 repr of the float32 value
        f = (lambda v: _fmt(repr(float(v)))) if full else _fmt
        r = ["0"] * 18
        r[0] = _fmt(round(i * 0.02, 2))
        r[1] = f(dms[i])
        r[10], r[11], r[13] = f(lwa[i, 0]), f(lwa[i, 1]), f(lwa[i, 2])
        r[17] = ""
        rows.append(r)
    return rows


def _catman(rows, *, eol="\n", header_lines=36, t0="T0 = 06.05.2025 09:08:25",
            names=None) -> str:
    header = [f"catman line {i}" for i in range(header_lines)]
    if header_lines > 12:
        header[12] = t0
    names = names or po.CATMAN_COLUMNS
    lines = header + ["\t".join(names)] + ["\t".join(r) for r in rows]
    return eol.join(lines) + eol


def _case(name: str) -> str:
    rows = _rows(260, seed=len(name))
    if name == "crlf":
        return _catman(rows, eol="\r\n")
    if name == "lone_cr":
        rows[40][17] = "operator\rnote"               # pandas ends the row at \r
        text = _catman(rows)
        return text.replace("catman line 5", "catman\rline 5")
    if name == "quoted_tab":
        rows[10][17] = '"a\tb"'
        rows[11][17] = '"say ""hi"""'
        return _catman(rows)
    if name == "short_long":
        rows[20] = rows[20][:15]                       # padded with NaN
        rows[30] = rows[30] + ["1,0", "2,0"]           # dropped
        return _catman(rows)
    if name == "blank":
        text = _catman(rows)
        lines = text.split("\n")
        lines.insert(60, "")
        lines.insert(90, "   ")
        return "\n".join(lines) + "\n"
    if name == "na_tokens":
        rows[5][1] = "n/a"
        rows[6][11] = "NaN"
        rows[7][13] = ""
        rows[8][10] = "#N/A"
        rows[9][0] = "NULL"
        return _catman(rows)
    if name == "non_numeric":
        rows[50][11] = "x"                   # LWA_3 stays text
        rows[51][11] = "3"                   # an integer token reads as 3
        rows[52][11] = "2.5"                 # a '.' decimal reads as 2.5
        return _catman(rows)
    if name == "implicit_index":
        return _catman([["7"] + r for r in rows[:3]] + rows[3:])
    return _catman(rows)


CASES = ["plain", "crlf", "lone_cr", "quoted_tab", "short_long", "blank",
         "na_tokens", "non_numeric", "implicit_index"]


def _write(tmp_path, text: str, name: str = "MD_2025_05_06_09_08_25.txt") -> Path:
    p = tmp_path / name
    with open(p, "w", encoding="cp1252", newline="") as f:
        f.write(text)
    return p


def _same_column(got: np.ndarray, want) -> None:
    want = np.asarray(want)
    if want.dtype.kind in "fiu":
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))
    else:
        assert got.dtype == object
        g_na = np.array([isinstance(v, float) and np.isnan(v) for v in got])
        w_na = np.array([not isinstance(v, str) for v in want])
        np.testing.assert_array_equal(g_na, w_na)
        assert list(got[~g_na]) == list(want[~w_na])


@pytest.mark.parametrize("case", CASES)
def test_parser_matches_jax(case, tmp_path):
    import pandas as pd

    jo = jax_openlab()
    path = _write(tmp_path, _case(case))
    got, want = po.import_catman_file(path), jo.import_catman_file(path)
    assert len(got) == len(want)
    assert got.t0 == datetime.datetime(2025, 5, 6, 9, 8, 25)
    for c in po.CATMAN_COLUMNS:
        _same_column(got[c], want[c].to_numpy())
    for c in USED:                 # as extract_run reads them
        a = po.to_numeric(got[c]).astype(np.float32)
        b = pd.to_numeric(want[c], errors="coerce").to_numpy(dtype=np.float32)
        assert a.tobytes() == b.tobytes(), c
    ok = ~want["time"].isna().to_numpy()           # JAX: T0 + Time_1 seconds
    assert (want["time"][ok] == pd.Timestamp(got.t0)
            + pd.to_timedelta(got["Time_1"][ok], unit="s")).all()


def test_parser_special_cases_read_as_pandas_reads_them(tmp_path):
    """The counts behind the cases above, so a silent change in both
    parsers still shows."""
    read = lambda case: po.import_catman_file(_write(tmp_path, _case(case),
                                                     f"MD_{case}.txt"))
    assert len(read("plain")) == 260
    assert len(read("short_long")) == 259                   # one row dropped
    assert np.isnan(read("short_long")["F_total"][20])      # padded
    assert len(read("lone_cr")) == 261                      # a row split at \r
    assert read("lone_cr")["Time_1"].dtype == np.float64
    assert np.isnan(read("lone_cr")["Time_1"]).all()        # text column: NaN
    assert read("quoted_tab")["Comment"][10] == "a\tb"
    assert read("quoted_tab")["Comment"][11] == 'say "hi"'
    assert len(read("blank")) == 260
    lwa3 = read("non_numeric")["LWA_3"]
    assert lwa3.dtype == object
    num = po.to_numeric(lwa3)
    assert num[51] == 3.0 and num[52] == 2.5 and np.isnan(num).sum() == 258
    assert len(read("implicit_index")) == 260


@pytest.mark.parametrize("case", CASES)
def test_extract_run_matches_jax(case, tmp_path):
    jo = jax_openlab()
    path = _write(tmp_path, _case(case))
    from dataclasses import replace

    cfg = OpenLabConfig(seq_len=40, stride=10)
    jcfg = replace(jax_cfg(), seq_len=40, stride=10)
    got = po.extract_run(po.import_catman_file(path), "MD_x", cfg)
    want = jo.extract_run(jo.import_catman_file(path), "MD_x", jcfg)
    assert (got is None) == (want is None)
    Xc, Xr, meta, diag = got
    assert Xc.tobytes() == want[0].tobytes() and Xr.tobytes() == want[1].tobytes()
    assert list(meta) == list(want[2].columns)
    for k, v in meta.items():
        w = want[2][k].to_numpy()
        assert v.dtype == w.dtype, k
        assert np.array_equal(v, w, equal_nan=v.dtype.kind == "f"), k
    assert list(diag) == list(want[3])
    for k, v in diag.items():
        assert v == want[3][k] or (np.isnan(v) and np.isnan(want[3][k])), k


@pytest.mark.parametrize("mutate, err", [
    (lambda t: "\n".join(t.split("\n")[:20]) + "\n", "header shorter"),
    (lambda t: "\n".join(t.split("\n")[:36]) + "\n", "header shorter"),
    (lambda t: t.replace("T0 = 06.05.2025 09:08:25", "T0 = soon"), "T0"),
    (lambda t: t.replace("\tComment\n", "\n"), "expected 18"),
])
def test_parser_errors_match_jax(mutate, err, tmp_path):
    jo = jax_openlab()
    path = _write(tmp_path, mutate(_case("plain")))
    with pytest.raises(ValueError, match=err):
        po.import_catman_file(path)
    with pytest.raises(ValueError, match=err):
        jo.import_catman_file(path)


# ---------------------------------------------------------------------------
# cleaning, windowing, silver flags
# ---------------------------------------------------------------------------

def _signal(seed: int, n: int = 400) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 0.5, n) + np.where(np.arange(n) > n // 3, 70.0, 0.0))
    x[rng.integers(0, n, 5)] = np.nan
    x[rng.integers(0, n, 2)] = -1e6
    x[n // 2] += 3.0
    return x.astype(np.float32)


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and (a == b or (np.isnan(a) and np.isnan(b)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cleaning_and_windowing_match_jax(seed):
    jo = jax_openlab()
    x = _signal(seed)
    for w in (None, 1, 5, 9):
        _equal(po.moving_average(x.astype(float), w), jo.moving_average(x.astype(float), w))
    for kw in ({}, dict(max_jump=0.5, max_abs=10.0, ma_window=3),
               dict(max_jump=100.0, max_abs=1e9, ma_window=1)):
        _equal(po.clean_openlab_and_rule(x, **kw), jo.clean_openlab_and_rule(x, **kw))
    _equal(po.clean_openlab_and_rule(np.full(10, np.nan)),
           jo.clean_openlab_and_rule(np.full(10, np.nan)))
    for th in ((1.0, 65.0), (0.1, 0.5)):
        _equal(po.provider_raw_outlier_mask_and(x, *th),
               jo.provider_raw_outlier_mask_and(x, *th))
    A = np.stack([x, x * 2, -x], axis=1)
    for L, s in ((50, 10), (400, 20), (401, 1)):
        _equal(po.windowize_2d(A, L, s), jo.windowize_2d(A, L, s))
        _equal(po.windowize_1d(x, L, s), jo.windowize_1d(x, L, s))


@pytest.mark.parametrize("seed", [0, 1])
def test_silver_flags_match_jax(seed):
    jo = jax_openlab()
    rng = np.random.default_rng(seed)
    U = np.stack([_signal(seed + i, 120) for i in range(6)])
    U[1] = 0.25                                            # stuck
    U[2, :118] = np.nan                                    # < 5 finite
    F = rng.normal(0, 10, U.shape)
    Uc = U + rng.normal(0, 1e-4, U.shape)
    for kw in ({}, dict(force_rng_min=5.0), dict(force_rng_min=5.0, use_plain_stuck=False),
               dict(jump_th=0.2, abs_th=1.0, invalid_ratio_th=0.0, var_eps=1e-2)):
        _equal(po.silver_flag_metrics_batch(U, Uc, F, **kw),
               jo.silver_flag_metrics_batch(U, Uc, F, **kw))
        _equal(po.silver_flag_metrics_batch(U, **kw), jo.silver_flag_metrics_batch(U, **kw))
        for i in range(len(U)):
            _equal(po.sensor_fault_silver_flags(U[i], Uc[i], F[i], **kw),
                   jo.sensor_fault_silver_flags(U[i], Uc[i], F[i], **kw))
    for u, f in zip(U, F):
        _equal(po.invalid_ratio_1d(u), jo.invalid_ratio_1d(u))
        _equal(po.jump_ratio_1d(u, 0.5), jo.jump_ratio_1d(u, 0.5))
        _equal(po.range_violation_ratio_1d(u, 65.0), jo.range_violation_ratio_1d(u, 65.0))
        _equal(po.is_stuck_1d(u, 1e-6), jo.is_stuck_1d(u, 1e-6))
        _equal(po.is_stuck_force_aware(u, f, 1e-6, 5.0),
               jo.is_stuck_force_aware(u, f, 1e-6, 5.0))
    _equal(po.invalid_ratio_1d(np.zeros(0)), jo.invalid_ratio_1d(np.zeros(0)))
    _equal(po.jump_ratio_1d(np.zeros(1), 1.0), jo.jump_ratio_1d(np.zeros(1), 1.0))
    for M in (U[:3].T, U.T, np.zeros((1, 3)), rng.normal(0, 1, (50, 4))):
        _equal(po.channel_inconsistency_score(M), jo.channel_inconsistency_score(M))


# ---------------------------------------------------------------------------
# the committed windows, written back as catman files
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stitched(tmp_path_factory):
    sys.path.insert(0, str(ROOT))
    from chip_smoke import write_catman_runs

    raw = tmp_path_factory.mktemp("catman")
    write_catman_runs(OL, raw)
    return raw


@pytest.fixture(scope="module")
def extracted(stitched):
    return po.extract_all(str(stitched), OpenLabConfig())


def test_extract_all_matches_jax(stitched, extracted):
    jo = jax_openlab()
    Xc, Xr, meta, diag = extracted
    jXc, jXr, jmeta, jdiag = jo.extract_all(str(stitched), jax_cfg())
    assert Xc.shape == (6432, 200, 4) and Xc.dtype == np.float32
    assert Xc.tobytes() == jXc.tobytes() and Xr.tobytes() == jXr.tobytes()
    assert list(meta) == list(jmeta.columns)
    for k, v in meta.items():
        w = jmeta[k].to_numpy()
        assert v.dtype == w.dtype and np.array_equal(v, w), k
    assert list(diag) == list(jdiag.columns)
    for k, v in diag.items():
        assert np.array_equal(v, jdiag[k].to_numpy()), k


def test_extract_all_against_the_committed_windows(extracted):
    from shm_tpu_torch.utils.io import load_csv_table

    Xc, Xr, meta, _ = extracted
    cXc = np.load(OL / "extracted/X_clean.npy")
    cXr = np.load(OL / "extracted/X_raw.npy")
    committed = load_csv_table(OL / "extracted/window_labels.csv")
    same = lambda a, b: np.array([x.tobytes() == y.tobytes() for x, y in zip(a, b)])
    assert same(Xr, cXr).sum() == 6432
    assert (meta["label"].astype(str) == committed["label"]).sum() == 6432
    assert (meta["run_id"].astype(str) == committed["run_id"]).all()
    clean = same(Xc, cXc)
    assert clean.sum() == 6425
    run = committed["run_id"]
    last = np.flatnonzero(np.append(run[1:] != run[:-1], True))
    np.testing.assert_array_equal(np.flatnonzero(~clean), last)


def test_extract_all_needs_catman_files(tmp_path):
    with pytest.raises(FileNotFoundError, match="No MD_"):
        po.extract_all(str(tmp_path), OpenLabConfig())
