"""Anomaly-rate drift detection for a deployed scorer (counterpart of
``shm_tpu/monitor.py``; numpy only, so the port keeps its own copy).

The VAE gate's threshold is calibrated to a known healthy anomaly rate: the
4DOF stage sets it at the p99 of healthy-window MSE, so a healthy stream
gates about 1% of windows; the openLAB stage records the achieved FPR in the
manifest. A stream whose observed gate rate drifts away from that rate
points at sensor trouble, a changed environment or a stale
model/threshold. :class:`DriftMonitor` watches it on the host, on the gate
*decisions*:

- an exponentially-weighted moving average of the per-window anomaly rate,
  and
- a two-sided Bernoulli CUSUM against the expected rate: ``S+`` gathers
  evidence that the rate rose above ``expected + k``, ``S-`` that it fell
  below ``expected - k``, each clamped at zero and alerting at ``h``.

Both statistics keep exact per-window semantics but are computed in closed
form over each batch (prefix sums and running minima), so feeding a stream
in any chunking gives the same state as feeding it window by window, the
contract :class:`shm_tpu_torch.serve.StreamScorer` keeps for scoring.

``k`` is the per-window allowance (default ``expected_rate / 2``, fastest
to detect a doubling or halving); ``S`` and ``h`` count excess anomalous
windows beyond it. With the 4DOF calibration (1%, k = 0.5%) the default
``h = 8`` alerts after about 1,600 windows of a sustained doubling.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np


class DriftMonitor:
    """Sequential drift detector on the gate's anomaly decisions.

    Feed every scored batch's ``anomalous`` array to :meth:`update`; read
    :meth:`snapshot` (or the daemon's ``/metrics``) for the current state.
    Thread-safe: one instance is shared by all connection threads of the
    HTTP daemon (``shm_tpu_torch.serve_http``).

    Parameters
    ----------
    expected_rate:
        The calibrated healthy anomaly rate in (0, 1), e.g.
        ``1 - percentile/100`` from ``vae_threshold.json`` (4DOF), or the
        recorded ``normal_fpr_at_threshold`` (openLAB).
    ewma_alpha:
        Per-window EWMA smoothing in (0, 1); effective memory is ~1/alpha
        windows (default 0.005 -> ~200 windows).
    cusum_k:
        Per-window CUSUM allowance; default ``expected_rate / 2`` (fastest
        detection of a doubling/halving).
    cusum_h:
        Alert threshold for both CUSUM sides, in excess anomalous windows.
    """

    def __init__(self, expected_rate: float, *, ewma_alpha: float = 0.005,
                 cusum_k: Optional[float] = None, cusum_h: float = 8.0):
        if not 0.0 < expected_rate < 1.0:
            raise ValueError(f"expected_rate must be in (0, 1), "
                             f"got {expected_rate}")
        if not 0.0 < ewma_alpha < 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1), got {ewma_alpha}")
        k = expected_rate / 2.0 if cusum_k is None else float(cusum_k)
        if k < 0.0:
            raise ValueError(f"cusum_k must be >= 0, got {cusum_k}")
        if cusum_h <= 0.0:
            raise ValueError(f"cusum_h must be > 0, got {cusum_h}")
        self.expected_rate = float(expected_rate)
        self.ewma_alpha = float(ewma_alpha)
        self.cusum_k = k
        self.cusum_h = float(cusum_h)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Forget all stream state (e.g. after retraining/recalibration)."""
        with self._lock:
            self.windows = 0
            self.anomalous = 0
            self.ewma_rate = self.expected_rate
            self.s_high = 0.0
            self.s_low = 0.0
            self.alerts_high = 0          # upward crossings of h, cumulative
            self.alerts_low = 0

    # ------------------------------------------------------------------
    @staticmethod
    def _cusum_batch(s0: float, d: np.ndarray, h: float):
        """Exact batched S_t = max(0, S_{t-1} + d_t).

        The clamp-at-zero recurrence has the closed form (max-suffix-sum):
        ``S_t = max(S_0 + P_t, P_t - min_{1<=j<=t} P_j, 0)`` with prefix
        sums ``P``. Returns (final S, number of upward h-crossings) —
        identical to looping window-by-window, so chunking is invariant.
        """
        P = np.cumsum(d)
        S = np.maximum(np.maximum(s0 + P, P - np.minimum.accumulate(P)), 0.0)
        prev = np.concatenate(([s0], S[:-1]))
        crossings = int(((S > h) & (prev <= h)).sum())
        return float(S[-1]), crossings

    def update(self, anomalous) -> Dict[str, float]:
        """Fold one scored batch's per-window gate decisions (in stream
        order) into the monitor; returns :meth:`snapshot`."""
        x = np.asarray(anomalous, np.float64).ravel()
        if x.size and (x.min() < 0.0 or x.max() > 1.0):
            raise ValueError("anomalous must be boolean/0-1 per window")
        with self._lock:
            n = x.size
            if n:
                self.windows += n
                self.anomalous += int(x.sum())
                a = self.ewma_alpha
                # r_n = (1-a)^n r_0 + a * sum_i (1-a)^(n-1-i) x_i  — the
                # per-window EWMA recurrence, evaluated in one dot product
                w = (1.0 - a) ** np.arange(n - 1, -1, -1, dtype=np.float64)
                self.ewma_rate = ((1.0 - a) ** n * self.ewma_rate
                                  + a * float(w @ x))
                p0, k, h = self.expected_rate, self.cusum_k, self.cusum_h
                self.s_high, c_hi = self._cusum_batch(
                    self.s_high, x - (p0 + k), h)
                self.s_low, c_lo = self._cusum_batch(
                    self.s_low, (p0 - k) - x, h)
                self.alerts_high += c_hi
                self.alerts_low += c_lo
            return self._snapshot_locked()

    # ------------------------------------------------------------------
    def _snapshot_locked(self) -> Dict[str, float]:
        return {
            "expected_rate": self.expected_rate,
            "windows": self.windows,
            "anomalous": self.anomalous,
            "ewma_rate": self.ewma_rate,
            "cusum_high": self.s_high,
            "cusum_low": self.s_low,
            "cusum_h": self.cusum_h,
            "alert_high": self.s_high > self.cusum_h,
            "alert_low": self.s_low > self.cusum_h,
            "alerts_high_total": self.alerts_high,
            "alerts_low_total": self.alerts_low,
        }

    def snapshot(self) -> Dict[str, float]:
        """Current monitor state as a plain dict (JSON-ready)."""
        with self._lock:
            return self._snapshot_locked()


def expected_rate_from_threshold_meta(meta: dict) -> Optional[float]:
    """Pull the calibrated healthy anomaly rate out of a
    ``vae_threshold.json``-shaped dict.

    Prefers the *measured* healthy false-positive rate when the calibration
    recorded one (openLAB writes ``normal_fpr_at_threshold``), else the
    construction-time rate ``1 - percentile/100`` (4DOF p99 -> 0.01).
    Returns None if the dict records neither.
    """
    fpr = meta.get("normal_fpr_at_threshold")
    if fpr is not None and 0.0 < float(fpr) < 1.0:
        return float(fpr)
    pct = meta.get("percentile")
    if pct is not None and 0.0 < float(pct) < 100.0:
        return 1.0 - float(pct) / 100.0
    return None


__all__ = ["DriftMonitor", "expected_rate_from_threshold_meta"]
