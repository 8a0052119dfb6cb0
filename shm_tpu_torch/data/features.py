"""Hand-crafted window features for the classical baselines (counterpart of
``shm_tpu/data/features.py``, numpy only, the same code).

Per channel 11 NaN-safe time-domain features and 8 frequency descriptors
(19 x 4 channels = 76). The time block is vectorized over every (window,
channel) row with nan-aware reductions. The frequency block compacts each
row's finite samples before the rFFT, as the reference does; rows are
bucketed by their finite count and each bucket goes through one rFFT of its
compacted length (DC removed, 85% rolloff by searchsorted, 5 equal bands in
bin units).

Labels of the feature path: Normal=0, Structural Fault=1, Sensor Fault=2
(not the 3-class pipeline's order [Normal, SF, ST]; both are kept).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

FEATURE_LABEL_MAP = {"Normal": 0, "Structural Fault": 1, "Sensor Fault": 2}

TIME_FEATURES = ["mean", "std", "var", "min", "max", "ptp", "rms", "crest",
                 "skew", "kurtosis", "snr_db"]
FREQ_FEATURES = ["fft_total_power", "fft_centroid", "fft_rolloff85",
                 "band1", "band2", "band3", "band4", "band5"]


def feature_names(channels: List[str], include_freq: bool = True) -> List[str]:
    names = []
    for ch in channels:
        for f in TIME_FEATURES:
            names.append(f"{ch}__{f}")
        if include_freq:
            for f in FREQ_FEATURES:
                names.append(f"{ch}__{f}")
    return names


def _time_features_batch(X: np.ndarray) -> np.ndarray:
    """(R, T) rows -> (R, 11) time-domain features, NaN-safe, vectorized."""
    X = X.astype(np.float64)
    R, T = X.shape
    ok = np.isfinite(X)
    cnt = ok.sum(axis=1)
    Xz = np.where(ok, X, 0.0)

    safe_cnt = np.maximum(cnt, 1)
    mu = Xz.sum(axis=1) / safe_cnt
    # population std over finite values
    var = (np.where(ok, (X - mu[:, None]) ** 2, 0.0).sum(axis=1)) / safe_cnt
    sd = np.sqrt(np.maximum(var, 0.0))

    mn = np.where(cnt > 0, np.min(np.where(ok, X, np.inf), axis=1), 0.0)
    mx = np.where(cnt > 0, np.max(np.where(ok, X, -np.inf), axis=1), 0.0)
    ptp = mx - mn
    ms = np.where(ok, X * X, 0.0).sum(axis=1) / safe_cnt
    rms = np.sqrt(np.maximum(ms, 0.0))

    mx_abs = np.where(cnt > 0, np.max(np.where(ok, np.abs(X), -np.inf), axis=1), 0.0)
    crest = np.where(rms >= 1e-12, mx_abs / np.where(rms >= 1e-12, rms, 1.0), 0.0)

    # skew/kurtosis: z clipped to +-50, need >=3 / >=4 finite samples and sd > eps
    z = np.where(ok, (X - mu[:, None]) / np.where(sd >= 1e-12, sd, 1.0)[:, None], 0.0)
    z = np.clip(z, -50.0, 50.0)
    skew = (z ** 3).sum(axis=1) / safe_cnt
    kurt = (z ** 4).sum(axis=1) / safe_cnt - 3.0
    skew = np.where((cnt >= 3) & (sd >= 1e-12), skew, 0.0)
    kurt = np.where((cnt >= 4) & (sd >= 1e-12), kurt, 0.0)

    # SNR proxy: 10*log10(mean(x^2) / mean((x-mu)^2)), >=5 samples
    p_noise = var
    snr = np.where(p_noise >= 1e-12,
                   10.0 * np.log10(np.where(ms >= 1e-12, ms, 1.0)
                                   / np.where(p_noise >= 1e-12, p_noise, 1.0)),
                   60.0)
    snr = np.where(ms >= 1e-12, snr, 0.0)
    snr = np.where(cnt >= 5, snr, 0.0)

    # zero-sample guards (reference returns 0.0 for empty/insufficient)
    mu = np.where(cnt > 0, mu, 0.0)
    sd = np.where(cnt > 0, sd, 0.0)
    var = np.where(cnt > 0, var, 0.0)
    rms = np.where(cnt > 0, rms, 0.0)

    return np.stack([mu, sd, var, mn, mx, ptp, rms, crest, skew, kurt, snr], axis=1)


def _bandpower_row(xv: np.ndarray, n_bands: int = 5) -> List[float]:
    """Frequency features of one compacted (finite-only) row; reference
    _bandpower_features (03_featurize_windows.py:162-204)."""
    if xv.size < 8:
        return [0.0, 0.0, 0.0] + [0.0] * n_bands
    xv = xv - np.mean(xv)
    T = xv.shape[0]
    P = (np.abs(np.fft.rfft(xv)) ** 2) / max(T, 1)
    if P.size > 0:
        P[0] = 0.0
    total = float(np.sum(P))
    if total <= 1e-18:
        return [total, 0.0, 0.0] + [0.0] * n_bands
    freqs = np.arange(P.size, dtype=np.float64)
    centroid = float(np.sum(freqs * P) / total)
    roll_idx = int(np.searchsorted(np.cumsum(P), 0.85 * total))
    rolloff = float(min(roll_idx, P.size - 1))
    edges = np.linspace(0, P.size, n_bands + 1).astype(int)
    bands = [float(np.sum(P[edges[i]:edges[i + 1]]) / total) for i in range(n_bands)]
    return [total, centroid, rolloff] + bands


def _bandpower_batch(V: np.ndarray, n_bands: int = 5) -> np.ndarray:
    """(k, L>=8) fully-finite compacted rows -> (k, 3+n_bands): the batched
    form of ``_bandpower_row``'s math. Bit-identical to the per-row path:
    every reduction (mean, power sums, cumsum, band sums) runs the same
    pairwise summation over the same contiguous row the 1-D version sees,
    and the rolloff's ``(csum < 0.85*total).sum()`` equals
    ``searchsorted(cumsum, 0.85*total)`` (side='left')."""
    L = V.shape[1]
    V = V - V.mean(axis=1, keepdims=True)
    P = (np.abs(np.fft.rfft(V, axis=1)) ** 2) / L
    P[:, 0] = 0.0
    total = P.sum(axis=1)
    nz = total > 1e-18
    freqs = np.arange(P.shape[1], dtype=np.float64)
    centroid = np.where(nz, (P * freqs).sum(axis=1) / np.where(nz, total, 1.0),
                        0.0)
    csum = np.cumsum(P, axis=1)
    thresh = 0.85 * total
    roll = (csum < thresh[:, None]).sum(axis=1)
    roll = np.minimum(roll, P.shape[1] - 1).astype(np.float64)
    roll = np.where(nz, roll, 0.0)
    edges = np.linspace(0, P.shape[1], n_bands + 1).astype(int)
    bands = np.stack([P[:, edges[i]:edges[i + 1]].sum(axis=1)
                      / np.where(nz, total, 1.0) for i in range(n_bands)],
                     axis=1)
    bands = np.where(nz[:, None], bands, 0.0)
    return np.column_stack([total, centroid, roll, bands])


def _freq_features_batch(X: np.ndarray, n_bands: int = 5) -> np.ndarray:
    """(R, T) rows -> (R, 8) frequency features, vectorized for every row
    class. Rows are bucketed by finite-sample count; each bucket's rows are
    compacted (finite samples first, in their order: a stable argsort of
    the finite mask, as the reference's ``x[finite]``) and go through one
    rFFT of that length, the math of ``_bandpower_row`` row for row. Rows
    with fewer than 8 finite samples stay all-zero."""
    X = X.astype(np.float64)
    R, T = X.shape
    out = np.zeros((R, 3 + n_bands))
    if R == 0:
        return out
    ok = np.isfinite(X)
    cnt = ok.sum(axis=1)
    for L in np.unique(cnt):
        if L < 8:
            continue                  # reference: < 8 finite samples -> zeros
        idx = np.flatnonzero(cnt == L)
        if L == T:                    # fully finite: no compaction needed
            comp = X[idx]
        else:
            # finite-first stable ordering compacts each row in place-order
            order = np.argsort(~ok[idx], axis=1, kind="stable")[:, :L]
            comp = np.take_along_axis(X[idx], order, axis=1)
        out[idx] = _bandpower_batch(np.ascontiguousarray(comp), n_bands)
    return out


def featurize_channel(x: np.ndarray, *, include_freq: bool = True) -> List[float]:
    """Single-channel featurizer, reference-identical (03_featurize_windows.py:210-245)."""
    t = _time_features_batch(x[None, :])[0]
    feats = [float(v) for v in t]
    if include_freq:
        ok = np.isfinite(x)
        feats += [float(v) for v in _bandpower_row(x[ok].astype(np.float64))]
    return feats


def featurize_windows(X: np.ndarray, *, include_freq: bool = True) -> np.ndarray:
    """(N, T, C) raw windows -> (N, C * n_feats) float32 feature matrix.

    Feature order matches the reference: per channel, 11 time-domain then 8
    frequency features, channels in input order.
    """
    N, T, C = X.shape
    per = len(TIME_FEATURES) + (len(FREQ_FEATURES) if include_freq else 0)
    out = np.zeros((N, C * per), np.float32)
    for c in range(C):
        rows = X[:, :, c]
        tf = _time_features_batch(rows)
        if include_freq:
            ff = _freq_features_batch(rows)
            block = np.column_stack([tf, ff])
        else:
            block = tf
        out[:, c * per:(c + 1) * per] = block.astype(np.float32)
    return out


__all__ = [
    "FEATURE_LABEL_MAP",
    "TIME_FEATURES",
    "FREQ_FEATURES",
    "feature_names",
    "featurize_channel",
    "featurize_windows",
]
