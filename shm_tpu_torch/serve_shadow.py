"""Shadow (canary) scoring: validate a candidate model on live traffic
(counterpart of ``shm_tpu/serve_shadow.py``).

:class:`ShadowEngine` wraps a CANDIDATE scorer next to the daemon's primary.
Every served ``/score`` and ``/score_series`` request is scored again by the
candidate asynchronously: one worker thread owns all shadow device work, and
the request is answered from the primary before the shadow copy is queued.
The engine accumulates what an operator promotes or rejects the candidate
on:

- per-window gate agreement (same anomalous decision) and 3-class
  prediction agreement;
- the shadow's own anomaly rate and per-class prediction counts;
- ``|mse_shadow - mse_primary|``, sum and max.

Backpressure drops instead of blocking: the queue is bounded in windows
(``max_pending_windows``); when the candidate falls behind, or is still
warming, new work is dropped and counted, and live traffic never waits.
Admission never looks at a request's content, so the sample stays unbiased.

``shm_tpu_torch.serve_http --shadow ROOT`` exposes it as ``shm_shadow_*`` on
``/metrics`` (and a JSON snapshot); ``POST /shadow/reset`` (admin) zeroes
the comparison counters.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np

_CLASS_LABELS = ("Normal", "Sensor Fault", "Structural Fault")


def check_compatible(primary, candidate) -> None:
    """The candidate must serve the primary's request surface (same window
    length, feature width and request rank), or every submission would be
    garbage. Raises ``ValueError``; call before constructing the engine,
    which starts its worker thread."""
    for attr in ("seq_len", "num_features"):
        p, s = getattr(primary, attr), getattr(candidate, attr)
        if int(p) != int(s):
            raise ValueError(
                f"shadow scorer serves {attr}={int(s)} but the primary "
                f"serves {int(p)} — a shadow must score the SAME request "
                "surface to compare decisions on it")
    pr = int(getattr(primary, "request_rank", 3))
    sr = int(getattr(candidate, "request_rank", 3))
    if pr != sr:
        raise ValueError(f"shadow request rank {sr} != primary {pr}")


class ShadowEngine:
    """Asynchronous candidate scorer + agreement accumulator.

    Parameters
    ----------
    scorer:
        The candidate — any object with the scorer surface
        (``score(W) -> dict``, ``warmup()``, ``seq_len``, ``num_features``;
        ``score_series``/``warmup_series`` for series traffic).
    max_pending_windows:
        Queue bound in windows; submissions past it are dropped (counted),
        never blocked on.
    series_strides:
        Strides ``warm()`` warms the series path for (mirror the daemon's
        ``--series-strides``).
    """

    def __init__(self, scorer, *, max_pending_windows: int = 8192,
                 series_strides=(1,)):
        if max_pending_windows < 1:
            raise ValueError("max_pending_windows must be >= 1")
        self.scorer = scorer
        self.max_pending_windows = int(max_pending_windows)
        self.series_strides = tuple(int(s) for s in series_strides)
        self.warm_error: Optional[str] = None
        self._warmed = threading.Event()
        self._lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._pending = 0
        self._alive = True
        self.reset()
        self._worker = threading.Thread(target=self._run, name="shadow-scorer",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Zero the comparison counters (queue and warm state are kept) —
        e.g. after ``/reload`` swapped the primary mid-comparison."""
        with self._lock:
            self.windows = 0
            self.gate_agree = 0
            self.pred_agree = 0
            self.shadow_anomalous = 0
            self.shadow_pred_classes = [0, 0, 0]
            self.mse_absdiff_sum = 0.0
            self.mse_absdiff_max = 0.0
            self.requests_scored = 0
            self.dropped_requests = 0
            self.dropped_windows = 0
            self.errors = 0
            self.last_error: Optional[str] = None

    # ------------------------------------------------------------------
    def warm(self) -> None:
        """Warm the candidate's buckets (on the card: build its kernel and
        settle the allocator), then start draining. Called from the daemon's
        warmup thread after the primary warmed (readiness never waits on the
        candidate); submissions meanwhile queue up to the window bound and
        the overflow is dropped and counted. Never raises: a candidate whose
        warmup fails keeps the daemon healthy and shows up as
        ``warm_error`` and per-item errors instead."""
        try:
            self.scorer.warmup()
            if (getattr(self.scorer, "mesh", None) is None
                    and int(getattr(self.scorer, "request_rank", 3)) == 3
                    and hasattr(self.scorer, "warmup_series")):
                for s in sorted(set(self.series_strides)):
                    self.scorer.warmup_series(stride=s)
        except Exception as e:                 # noqa: BLE001 — surfaced below
            self.warm_error = str(e)
        finally:
            self._warmed.set()

    def mark_warmed(self) -> None:
        """Skip the warmup (the ``--no-warmup`` path): the first shadow
        items warm inline in the worker, off the request path."""
        self._warmed.set()

    # ------------------------------------------------------------------
    def _admit(self, n: int) -> bool:
        with self._lock:
            if not self._alive or n == 0:
                return False
            if self._pending + n > self.max_pending_windows:
                self.dropped_requests += 1
                self.dropped_windows += n
                return False
            self._pending += n
            return True

    def submit_windows(self, W: np.ndarray, primary_out: Dict) -> bool:
        """Enqueue one served window-stack request for shadow scoring.
        Non-blocking; returns False when dropped (queue full / closed)."""
        n = int(np.asarray(primary_out["mse"]).shape[0])
        if not self._admit(n):
            return False
        self._q.put(("windows", W, None, primary_out, n))
        return True

    def submit_series(self, x: np.ndarray, stride: int,
                      primary_out: Dict) -> bool:
        """Enqueue one served raw-series request for shadow scoring."""
        n = int(np.asarray(primary_out["mse"]).shape[0])
        if not self._admit(n):
            return False
        self._q.put(("series", x, int(stride), primary_out, n))
        return True

    # ------------------------------------------------------------------
    def _run(self) -> None:
        self._warmed.wait()
        while True:
            item = self._q.get()
            if item is None:
                return
            kind, data, stride, primary_out, n = item
            try:
                if kind == "series":
                    out = self.scorer.score_series(data, stride=stride)
                else:
                    out = self.scorer.score(data)
                self._accumulate(out, primary_out)
            except Exception as e:             # noqa: BLE001 — keep draining
                with self._lock:
                    self.errors += 1
                    self.last_error = str(e)
            finally:
                with self._lock:
                    self._pending -= n

    def _accumulate(self, out: Dict, ref: Dict) -> None:
        mse_s = np.asarray(out["mse"], np.float64)
        mse_p = np.asarray(ref["mse"], np.float64)
        anom_s = np.asarray(out["anomalous"]).astype(bool)
        anom_p = np.asarray(ref["anomalous"]).astype(bool)
        y_s = np.asarray(out["y_pred"]).astype(np.int64)
        y_p = np.asarray(ref["y_pred"]).astype(np.int64)
        if mse_s.shape != mse_p.shape:         # impossible after
            raise ValueError(                  # check_compatible; be loud
                f"shadow produced {mse_s.shape} windows for a "
                f"{mse_p.shape}-window request")
        d = np.abs(mse_s - mse_p)
        with self._lock:
            self.requests_scored += 1
            self.windows += int(mse_s.size)
            self.gate_agree += int((anom_s == anom_p).sum())
            self.pred_agree += int((y_s == y_p).sum())
            self.shadow_anomalous += int(anom_s.sum())
            for c in range(len(self.shadow_pred_classes)):
                self.shadow_pred_classes[c] += int((y_s == c).sum())
            self.mse_absdiff_sum += float(d.sum())
            if d.size:
                self.mse_absdiff_max = max(self.mse_absdiff_max,
                                           float(d.max()))

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict:
        """Comparison state as a JSON-ready dict (agreement rates included,
        ``None`` until the first compared window)."""
        with self._lock:
            w = self.windows
            return {
                "warmed": self._warmed.is_set(),
                "warm_error": self.warm_error,
                "windows": w,
                "gate_agreement": (self.gate_agree / w) if w else None,
                "pred_agreement": (self.pred_agree / w) if w else None,
                "gate_agree": self.gate_agree,
                "pred_agree": self.pred_agree,
                "shadow_anomalous": self.shadow_anomalous,
                "shadow_pred_class_counts": dict(
                    zip(_CLASS_LABELS, self.shadow_pred_classes)),
                "mse_absdiff_mean": (self.mse_absdiff_sum / w) if w else None,
                "mse_absdiff_max": self.mse_absdiff_max,
                "requests_scored": self.requests_scored,
                "dropped_requests": self.dropped_requests,
                "dropped_windows": self.dropped_windows,
                "errors": self.errors,
                "last_error": self.last_error,
                "pending_windows": self._pending,
            }

    def render_prometheus(self) -> str:
        with self._lock:
            lines = [
                "# HELP shm_shadow_warmed 1 once the shadow scorer's buckets "
                "warmed (it drains its queue only from then).",
                "# TYPE shm_shadow_warmed gauge",
                f"shm_shadow_warmed {int(self._warmed.is_set())}",
                "# HELP shm_shadow_windows_total Windows the shadow compared "
                "against the primary.",
                "# TYPE shm_shadow_windows_total counter",
                f"shm_shadow_windows_total {self.windows}",
                "# HELP shm_shadow_gate_agree_total Compared windows with the "
                "same gate (anomalous) decision.",
                "# TYPE shm_shadow_gate_agree_total counter",
                f"shm_shadow_gate_agree_total {self.gate_agree}",
                "# HELP shm_shadow_pred_agree_total Compared windows with the "
                "same 3-class prediction.",
                "# TYPE shm_shadow_pred_agree_total counter",
                f"shm_shadow_pred_agree_total {self.pred_agree}",
                "# HELP shm_shadow_anomalous_total Compared windows the "
                "SHADOW gate flagged anomalous.",
                "# TYPE shm_shadow_anomalous_total counter",
                f"shm_shadow_anomalous_total {self.shadow_anomalous}",
                "# HELP shm_shadow_pred_class_total Compared windows by "
                "shadow-predicted class.",
                "# TYPE shm_shadow_pred_class_total counter",
            ]
            for label, n in zip(_CLASS_LABELS, self.shadow_pred_classes):
                lines.append(
                    f'shm_shadow_pred_class_total{{label="{label}"}} {n}')
            lines += [
                "# HELP shm_shadow_mse_absdiff_sum Sum over compared windows "
                "of |mse_shadow - mse_primary| (divide by "
                "shm_shadow_windows_total for the mean).",
                "# TYPE shm_shadow_mse_absdiff_sum counter",
                f"shm_shadow_mse_absdiff_sum {self.mse_absdiff_sum:.6g}",
                "# HELP shm_shadow_mse_absdiff_max Max "
                "|mse_shadow - mse_primary| seen since reset.",
                "# TYPE shm_shadow_mse_absdiff_max gauge",
                f"shm_shadow_mse_absdiff_max {self.mse_absdiff_max:.6g}",
                "# HELP shm_shadow_dropped_windows_total Windows dropped "
                "instead of queued (shadow behind or still warming).",
                "# TYPE shm_shadow_dropped_windows_total counter",
                f"shm_shadow_dropped_windows_total {self.dropped_windows}",
                "# HELP shm_shadow_errors_total Shadow scoring failures "
                "(the daemon keeps serving; see /info for the last error).",
                "# TYPE shm_shadow_errors_total counter",
                f"shm_shadow_errors_total {self.errors}",
                "# HELP shm_shadow_pending_windows Windows queued for the "
                "shadow right now.",
                "# TYPE shm_shadow_pending_windows gauge",
                f"shm_shadow_pending_windows {self._pending}",
            ]
            return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------
    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting work and join the worker (drains what's queued)."""
        with self._lock:
            if not self._alive:
                return
            self._alive = False
        self._warmed.set()                     # unblock a never-warmed worker
        self._q.put(None)
        self._worker.join(timeout=timeout)


__all__ = ["ShadowEngine", "check_compatible"]
