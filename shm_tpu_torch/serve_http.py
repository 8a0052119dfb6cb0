"""HTTP scoring service around :class:`shm_tpu_torch.serve.HybridScorer` or
the openLAB scorer (counterpart of ``shm_tpu/serve_http.py``).

A dependency-free stdlib HTTP daemon that warms every bucket before it
accepts traffic (on the card: builds the family's gate kernel and settles
the allocator) and then serves scoring requests.

Endpoints:

- ``GET /healthz``: liveness and readiness; 503 while warming, 200 once
  warm, 500 if the warmup failed (a failed kernel build included: nothing
  falls back to the plain path or to the CPU).
- ``GET /info``: the scorer's configuration (buckets, seq_len, threshold,
  device).
- ``GET /metrics``: counters in Prometheus text format (or a JSON snapshot
  with ``Accept: application/json``): requests by path and status, latency
  histograms, windows scored, windows the gate flagged, per-class counts,
  and, when the calibrated healthy rate is known (threshold manifest or
  ``--expected-anomaly-rate``), the :class:`shm_tpu_torch.monitor
  .DriftMonitor` gauges (EWMA rate, two-sided CUSUM, alerts).
- ``POST /score``: an (N, T, D) float32 window stack; per-window gate MSE,
  anomaly decision, 3-class prediction, p(structural).
- ``POST /score_series``: a raw (T_total, D) float32 series; windows are cut
  on the device (``HybridScorer.score_series``). Optional ``X-Stride: k``
  (default 1); only the strides warmed at startup (``--series-strides``) are
  accepted, others get 422.
- ``--shmx PATH`` serves a standalone export (:mod:`shm_tpu_torch.export`,
  the plain path): ``/info`` reports ``exported: true``, and
  ``/recalibrate`` answers 501 (the threshold is part of the program).
- ``--devices N`` (N > 1) splits every request's buckets over the first N
  devices of ``--device``'s type (``parallel.make_mesh``; a CPU mesh of N
  shards with ``--device cpu``); ``/info`` reports ``mesh_devices: N``.
  Refused beside ``--shmx`` (an export is one device's program).
- Shadow mode (``--shadow ROOT`` or a ``.shmx``): a candidate scorer scores every served
  request again, asynchronously; responses always come from the primary,
  and the agreement accumulates as ``shm_shadow_*`` metrics
  (:class:`shm_tpu_torch.serve_shadow.ShadowEngine`). ``POST
  /shadow/reset`` (admin) zeroes them.
- Admin surface (``--admin``; with ``--admin-token TOKEN`` every admin
  request must carry a matching ``X-Admin-Token`` header, compared in
  constant time, else 401): ``POST /reload`` rebuilds the scorer from the
  same artifacts, warms it while the old one serves, then swaps (``GET
  /reload`` reports idle/loading/warming/done/failed and the generation);
  ``POST /drift/reset`` clears the drift monitor; ``POST /recalibrate``
  sets the gate threshold in place at the ``X-Percentile`` (default: the
  loaded calibration's) of the MSE of an operator-supplied healthy window
  stack, in memory only (``/reload`` restores the file's).

Request bodies, by Content-Type:

- ``application/octet-stream``: raw little-endian float32 with an
  ``X-Shape: N,T,D`` (``T_total,D`` for /score_series) header; the reply is
  JSON, or an npz with ``Accept: application/octet-stream``.
- ``application/json``: ``{"windows": [[[...]]]}`` (``{"series": [[...]]}``)
  nested lists; the reply is JSON.

Two service modes:

- Single-threaded (default): requests queue in the listener's backlog and
  run one at a time.
- ``--concurrent``: a thread per connection, with every ``/score`` request
  going through one :class:`shm_tpu_torch.serve_batch.DynamicBatcher`
  dispatcher thread that coalesces the requests arriving within
  ``--batch-window-ms`` into one bucket-padded call. Each request's mse and
  decisions are those of the single-threaded mode.

Threads and streams on the card: the request threads (``/score_series``,
``/recalibrate`` and, single-threaded, ``/score``), the batcher's dispatcher
and the shadow worker each launch their scorer's kernels on their own
current stream, which none of them sets: all launch on the device's default
stream, in the order they reach it.

Example::

    python -m shm_tpu_torch.serve_http --root data/4dof --port 8787 &
    curl -s -X POST localhost:8787/score \\
         -H 'Content-Type: application/octet-stream' -H 'X-Shape: 64,100,12' \\
         --data-binary @windows.f32 | jq .y_pred

``--device cpu`` serves the plain PyTorch path on the CPU. ``--openlab
ROOT`` serves :class:`shm_tpu_torch.serve_openlab.OpenLabScorer` instead:
``/score`` takes (N, T, C, 2) stacked [clean, raw] window pairs (the
``X-Shape: N,T,C,2`` header), and ``/score_series`` answers 422 (openLAB
cleaning is a per-run cascade of the extraction).
"""

from __future__ import annotations

import argparse
import hmac
import io
import json
import math
import os
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer, ThreadingHTTPServer
from typing import Optional

import numpy as np

MAX_BODY_BYTES = 1 << 30      # 1 GiB — a ~220k-window 4DOF request (4.8 KB each)

# Prometheus-conventional latency buckets (seconds)
_LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0)
_CLASS_LABELS = ("Normal", "Sensor Fault", "Structural Fault")


# The listen backlog. socketserver's default of 5 drops the connection
# request of a sixth client that connects while five wait to be accepted,
# and that client's TCP stack retries only after a second: in concurrent
# mode, 8 clients at once made the last request start about 1.0 s after
# the others (measured on an H100, PERF.md §5).
class _Server(HTTPServer):
    request_queue_size = socket.SOMAXCONN


class _ThreadingServer(ThreadingHTTPServer):
    request_queue_size = socket.SOMAXCONN


class ServerMetrics:
    """Thread-safe operational counters for the scoring daemon.

    One instance per server (shared by every connection thread in
    ``--concurrent`` mode); ``record()`` is called once per request after
    the response is written, so accounting never adds request latency.
    Renders as Prometheus text (``render_prometheus``) or a JSON snapshot
    (``snapshot``). A drifting ``windows_anomalous / windows_scored`` ratio
    is the live health signal of a monitoring deployment.
    """

    def __init__(self, expected_rate: Optional[float] = None) -> None:
        self._lock = threading.Lock()
        self.started = time.time()
        self.requests: dict = {}       # (path, code) -> count
        self.latency: dict = {}        # path -> {"buckets": [...], "sum", "count"}
        self.windows_scored = 0
        self.windows_anomalous = 0
        self.pred_classes = [0, 0, 0]
        # sequential drift detection on the gate rate (monitor.py);
        # only when the calibrated healthy rate is known — from the loaded
        # threshold manifest or the --expected-anomaly-rate flag
        self.drift = None
        if expected_rate is not None:
            from shm_tpu_torch.monitor import DriftMonitor

            self.drift = DriftMonitor(expected_rate)

    def record(self, path: str, code: int, seconds: float | None = None,
               out: dict | None = None) -> None:
        """Count one request; ``seconds``/``out`` only for scoring paths."""
        with self._lock:
            key = (path, int(code))
            self.requests[key] = self.requests.get(key, 0) + 1
            if seconds is not None:
                h = self.latency.setdefault(
                    path, {"buckets": [0] * (len(_LATENCY_BUCKETS) + 1),
                           "sum": 0.0, "count": 0})
                for i, le in enumerate(_LATENCY_BUCKETS):
                    if seconds <= le:
                        h["buckets"][i] += 1
                        break
                else:
                    h["buckets"][-1] += 1
                h["sum"] += seconds
                h["count"] += 1
            if out is not None:
                y = np.asarray(out["y_pred"])
                self.windows_scored += int(y.size)
                self.windows_anomalous += int(np.asarray(out["anomalous"]).sum())
                for c in range(len(self.pred_classes)):
                    self.pred_classes[c] += int((y == c).sum())
        if out is not None and self.drift is not None:
            # outside self._lock: DriftMonitor has its own
            self.drift.update(np.asarray(out["anomalous"]))

    def render_prometheus(self, ready: bool) -> str:
        with self._lock:
            lines = [
                "# HELP shm_ready 1 once every bucket is warmed.",
                "# TYPE shm_ready gauge",
                f"shm_ready {int(ready)}",
                "# HELP shm_uptime_seconds Daemon uptime.",
                "# TYPE shm_uptime_seconds gauge",
                f"shm_uptime_seconds {time.time() - self.started:.3f}",
                "# HELP shm_requests_total HTTP requests by path and status.",
                "# TYPE shm_requests_total counter",
            ]
            for (path, code), n in sorted(self.requests.items()):
                lines.append(
                    f'shm_requests_total{{path="{path}",code="{code}"}} {n}')
            lines += [
                "# HELP shm_windows_scored_total Windows scored by /score "
                "and /score_series.",
                "# TYPE shm_windows_scored_total counter",
                f"shm_windows_scored_total {self.windows_scored}",
                "# HELP shm_windows_anomalous_total Scored windows the VAE "
                "gate flagged anomalous.",
                "# TYPE shm_windows_anomalous_total counter",
                f"shm_windows_anomalous_total {self.windows_anomalous}",
                "# HELP shm_pred_class_total Scored windows by predicted "
                "class.",
                "# TYPE shm_pred_class_total counter",
            ]
            for label, n in zip(_CLASS_LABELS, self.pred_classes):
                lines.append(f'shm_pred_class_total{{label="{label}"}} {n}')
            if self.drift is not None:
                d = self.drift.snapshot()
                lines += [
                    "# HELP shm_drift_expected_rate Calibrated healthy "
                    "anomaly rate the monitor baselines against.",
                    "# TYPE shm_drift_expected_rate gauge",
                    f"shm_drift_expected_rate {d['expected_rate']:.6g}",
                    "# HELP shm_drift_ewma_rate EWMA of the per-window gate "
                    "anomaly rate (~200-window memory).",
                    "# TYPE shm_drift_ewma_rate gauge",
                    f"shm_drift_ewma_rate {d['ewma_rate']:.6g}",
                    "# HELP shm_drift_cusum Two-sided CUSUM statistic in "
                    "excess anomalous windows (alert above "
                    f"{d['cusum_h']:g}).",
                    "# TYPE shm_drift_cusum gauge",
                    f'shm_drift_cusum{{side="high"}} {d["cusum_high"]:.6g}',
                    f'shm_drift_cusum{{side="low"}} {d["cusum_low"]:.6g}',
                    "# HELP shm_drift_alert 1 while the CUSUM side is above "
                    "its alert threshold.",
                    "# TYPE shm_drift_alert gauge",
                    f'shm_drift_alert{{side="high"}} {int(d["alert_high"])}',
                    f'shm_drift_alert{{side="low"}} {int(d["alert_low"])}',
                    "# HELP shm_drift_alerts_total Upward alert-threshold "
                    "crossings since start.",
                    "# TYPE shm_drift_alerts_total counter",
                    f'shm_drift_alerts_total{{side="high"}} '
                    f'{d["alerts_high_total"]}',
                    f'shm_drift_alerts_total{{side="low"}} '
                    f'{d["alerts_low_total"]}',
                ]
            lines += [
                "# HELP shm_request_seconds Scoring request wall latency "
                "(body read through response write).",
                "# TYPE shm_request_seconds histogram",
            ]
            for path, h in sorted(self.latency.items()):
                cum = 0
                for le, n in zip(_LATENCY_BUCKETS, h["buckets"]):
                    cum += n
                    lines.append(f'shm_request_seconds_bucket'
                                 f'{{path="{path}",le="{le}"}} {cum}')
                cum += h["buckets"][-1]
                lines.append(f'shm_request_seconds_bucket'
                             f'{{path="{path}",le="+Inf"}} {cum}')
                lines.append(f'shm_request_seconds_sum{{path="{path}"}} '
                             f'{h["sum"]:.6f}')
                lines.append(f'shm_request_seconds_count{{path="{path}"}} '
                             f'{h["count"]}')
            return "\n".join(lines) + "\n"

    def snapshot(self, ready: bool) -> dict:
        with self._lock:
            return {
                "ready": bool(ready),
                "uptime_seconds": time.time() - self.started,
                "requests": {f"{p} {c}": n
                             for (p, c), n in sorted(self.requests.items())},
                "windows_scored": self.windows_scored,
                "windows_anomalous": self.windows_anomalous,
                "pred_class_counts": dict(zip(_CLASS_LABELS,
                                              self.pred_classes)),
                "latency_seconds": {p: {"count": h["count"],
                                        "sum": h["sum"]}
                                    for p, h in sorted(self.latency.items())},
                "drift": (None if self.drift is None
                          else self.drift.snapshot()),
            }


class _Handler(BaseHTTPRequestHandler):
    # class attributes injected by make_server()
    # (scorer, score_fn, batcher) — ONE attribute so /reload swaps the
    # whole serving engine atomically (a request unpacks it once and can
    # never mix the old scorer with the new batcher or vice versa);
    # score_fn None -> scorer.score
    engine = (None, None, None)
    series_lock = None          # serializes /score_series device dispatch
    metrics = None              # shared ServerMetrics (set by make_server)
    ready = False
    warm_error = None           # str once the warmup thread has failed
    quiet = True
    series_strides = frozenset({1})   # /score_series strides warmed at start
    # admin surface (POST /reload, /drift/reset) — opt-in via make_server
    admin = False
    admin_token = None          # shared secret; set -> X-Admin-Token required
    reload_fn = None            # zero-arg -> NEW scorer (enables /reload)
    reload_lock = None
    reload_state = None         # dict guarded by reload_lock
    explicit_rate = None        # --expected-anomaly-rate; survives reloads
    shadow = None               # ShadowEngine re-scoring served traffic
    batch_window_ms = 2.0       # rebuild batchers with the startup window
    warm_on_reload = True       # mirror the startup warmup policy
    protocol_version = "HTTP/1.1"
    # idle keep-alive timeout: in single-threaded mode, without it ONE client
    # holding a persistent connection open (e.g. a pooling HTTP library
    # between requests) would block every other request — including /healthz
    # — until it disconnects. On timeout the stdlib handler closes the
    # connection and serve_forever() returns to accept().
    timeout = 30

    # ------------------------------------------------------------------
    def log_message(self, fmt, *args):            # silence default stderr spam
        if not self.quiet:
            super().log_message(fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str = "application/json"):
        self._status = code          # read by the metrics wrapper afterwards
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode())

    def _err(self, code: int, msg: str) -> None:
        # error paths may not have consumed the request body; under
        # HTTP/1.1 keep-alive the leftover bytes would be parsed as the
        # NEXT request line, so close the connection on every error
        self.close_connection = True
        self._send_json(code, {"error": msg})

    # ------------------------------------------------------------------
    def do_GET(self):
        self._status = 0
        try:
            self._handle_get()
        finally:
            if self.metrics is not None:
                # bound label cardinality: arbitrary 404 paths all count
                # under "other" instead of minting a label value each
                p = (self.path if self.path in ("/healthz", "/info",
                                                "/metrics") else "other")
                self.metrics.record(p, self._status)

    def _handle_get(self):
        if self.path == "/healthz":
            if self.warm_error is not None:
                self._err(500, f"warmup failed: {self.warm_error}")
            elif self.ready:
                self._send_json(200, {"status": "ok", "warm": True})
            else:
                self._send_json(503, {"status": "warming"})
        elif self.path == "/info":
            s = self.engine[0]
            self._send_json(200, {
                "buckets": list(s.buckets()),
                "min_bucket": s.min_bucket,
                "max_batch": s.max_batch,
                "seq_len": s.seq_len,
                "num_features": int(s.num_features),
                "threshold": float(s.threshold),
                "use_fused_vae": bool(getattr(s, "use_fused_vae", False)),
                "exported": bool(getattr(s, "exported", False)),
                "mesh_devices": (None if getattr(s, "mesh", None) is None
                                 else int(s.mesh.size)),
                "device": str(getattr(s, "device", None)),
                "labels": {str(i): lbl for i, lbl in enumerate(_CLASS_LABELS)},
                "admin": bool(self.admin),
                "reload": self._reload_snapshot(),
                "shadow": (None if self.shadow is None
                           else self.shadow.snapshot()),
            })
        elif self.path == "/reload":
            if self._admin_ok():
                self._send_json(200, self._reload_snapshot())
        elif self.path == "/metrics":
            if self.metrics is None:     # handler built without make_server()
                self._err(404, "metrics not enabled")
            elif (self.headers.get("Accept") or "") == "application/json":
                snap = self.metrics.snapshot(ready=self.ready)
                snap["shadow"] = (None if self.shadow is None
                                  else self.shadow.snapshot())
                self._send_json(200, snap)
            else:
                text = self.metrics.render_prometheus(ready=self.ready)
                if self.shadow is not None:
                    text += self.shadow.render_prometheus()
                self._send(200, text.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
        else:
            self._err(404, f"unknown path {self.path!r}")

    # ------------------------------------------------------------------
    def _read_array(self, ndim: int, json_key: str,
                    shape_desc: str) -> Optional[np.ndarray]:
        """Read an ndim-dimensional float32 array from the request body
        (raw bytes + X-Shape header, or JSON under ``json_key``)."""
        try:
            n = int(self.headers.get("Content-Length", 0))
        except (TypeError, ValueError):
            self._err(400, "bad Content-Length header")
            return None
        if n <= 0:
            self._err(400, "empty body")
            return None
        if n > MAX_BODY_BYTES:
            self._err(413, f"body {n} bytes exceeds {MAX_BODY_BYTES}")
            return None
        # read into a writable buffer: the array made on it below is what
        # the scorer copies to the device, with no host copy before that
        body = bytearray(n)
        view, got = memoryview(body), 0
        while got < n:
            k = self.rfile.readinto(view[got:])
            if not k:
                break
            got += k
        if got < n:
            self._err(400, f"body ended after {got} of {n} bytes")
            return None
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()

        if ctype == "application/octet-stream":
            shape_hdr = self.headers.get("X-Shape", "")
            try:
                shape = tuple(int(x) for x in shape_hdr.split(","))
                if len(shape) != ndim or any(s < 0 for s in shape):
                    raise ValueError
            except ValueError:
                self._err(400, f"X-Shape header must be '{shape_desc}' "
                               "non-negative ints")
                return None
            # Python-int product: np.prod would wrap at 2**64, letting a
            # crafted huge shape pass the size check and crash reshape()
            expect = math.prod(shape) * 4
            if len(body) != expect:
                self._err(400, f"body is {len(body)} bytes; shape {shape} "
                               f"needs {expect}")
                return None
            return np.frombuffer(body, dtype="<f4").reshape(shape)

        if ctype == "application/json":
            try:
                A = np.asarray(json.loads(body)[json_key], np.float32)
            except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
                self._err(400, f"bad JSON body: {e}")
                return None
            if A.ndim != ndim:
                self._err(400, f"{json_key} must be ({shape_desc}); "
                               f"got shape {A.shape}")
                return None
            return A

        self._err(415, "Content-Type must be application/octet-stream "
                       "(with X-Shape) or application/json")
        return None

    def _respond_scores(self, out: dict, n: int) -> None:
        self._outcome = out          # read by the metrics wrapper afterwards
        if (self.headers.get("Accept") or "") == "application/octet-stream":
            buf = io.BytesIO()
            np.savez(buf, **{k: np.asarray(v) for k, v in out.items()})
            self._send(200, buf.getvalue(), "application/octet-stream")
        else:
            self._send_json(200, {
                "n": n,
                "mse": out["mse"].astype(float).tolist(),
                "anomalous": out["anomalous"].astype(bool).tolist(),
                "y_pred": out["y_pred"].astype(int).tolist(),
                "p_struct": out["p_struct"].astype(float).tolist(),
            })

    def do_POST(self):
        t0 = time.perf_counter()
        self._status = 0
        self._outcome = None             # scoring outputs on success
        try:
            self._handle_post()
        finally:
            if self.metrics is not None:
                p = (self.path if self.path in ("/score", "/score_series")
                     else "other")
                self.metrics.record(p, self._status,
                                    time.perf_counter() - t0, self._outcome)

    # ------------------------------------------------------------------
    # admin surface
    def _admin_ok(self) -> bool:
        """Gate for the admin surface: 403 when ``--admin`` is off; when an
        admin token is configured, 401 unless the request carries a matching
        ``X-Admin-Token`` header. The comparison is constant-time
        (``hmac.compare_digest``) so response timing leaks nothing about
        how much of a guessed token matched."""
        if not self.admin:
            self._err(403, "admin endpoints disabled (start the daemon "
                           "with --admin)")
            return False
        if self.admin_token is not None:
            got = self.headers.get("X-Admin-Token") or ""
            if not hmac.compare_digest(got.encode(), self.admin_token.encode()):
                self._err(401, "missing or wrong X-Admin-Token header "
                               "(this server was started with --admin-token)")
                return False
        return True

    def _drain_body(self) -> None:
        """Consume any request body the handler doesn't use (admin POSTs):
        under HTTP/1.1 keep-alive, unread body bytes would be parsed as the
        NEXT request line on this connection."""
        try:
            n = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            n = -1
        if n < 0 or n > MAX_BODY_BYTES:
            self.close_connection = True
            return
        while n > 0:
            chunk = self.rfile.read(min(n, 65536))
            if not chunk:
                break
            n -= len(chunk)

    def _reload_snapshot(self) -> Optional[dict]:
        if self.reload_state is None:
            return None
        with self.reload_lock:
            return dict(self.reload_state)

    def _handle_reload(self) -> None:
        """Hot artifact reload: rebuild the scorer from disk, warm it while
        the old engine keeps serving, then swap atomically, so live traffic
        never meets a cold scorer. 202, then poll GET /reload."""
        self._drain_body()
        if not self._admin_ok():
            return
        if self.reload_fn is None:
            self._err(501, "this server has no reload_fn (scorer was "
                           "hand-constructed; reload needs an artifact "
                           "loader to rebuild from)")
            return
        cls = type(self)
        srv = self.server           # so shutdown paths close the LIVE batcher
        with self.reload_lock:
            if self.reload_state["state"] in ("loading", "warming"):
                self._err(409, "a reload is already in progress")
                return
            self.reload_state.update(state="loading", error=None,
                                     generation=self.reload_state
                                     ["generation"] + 1)
            snap = dict(self.reload_state)

        def _worker():
            try:
                new = cls.reload_fn()
                with cls.reload_lock:
                    cls.reload_state["state"] = "warming"
                if cls.warm_on_reload:
                    new.warmup()
                    if getattr(new, "mesh", None) is None and hasattr(
                            new, "warmup_series"):
                        for s in sorted(cls.series_strides):
                            new.warmup_series(stride=s)
                old_scorer, _, old_batcher = cls.engine
                new_batcher = new_fn = None
                if old_batcher is not None:
                    from shm_tpu_torch.serve_batch import DynamicBatcher

                    new_batcher = DynamicBatcher(
                        new, max_delay_ms=cls.batch_window_ms)
                    new_fn = new_batcher.score
                cls.engine = (new, new_fn, new_batcher)   # the atomic swap
                srv.batcher = new_batcher
                # drift baselines against the NEW calibration (an explicit
                # --expected-anomaly-rate still wins); stale stream state
                # from the old model is dropped with it
                rate = (cls.explicit_rate if cls.explicit_rate is not None
                        else getattr(new, "expected_anomaly_rate", None))
                if rate is None:
                    cls.metrics.drift = None
                else:
                    from shm_tpu_torch.monitor import DriftMonitor

                    cls.metrics.drift = DriftMonitor(rate)
                if cls.shadow is not None:
                    # agreement-vs-swapped-primary is a new comparison; items
                    # already queued (bounded by the window cap) still carry
                    # old-primary outputs — a bounded, documented smear
                    cls.shadow.reset()
                # a warmed swap proves serving is healthy: recover from a
                # FAILED STARTUP warmup (warm_error had /score answering 500)
                cls.warm_error = None
                cls.ready = True
                with cls.reload_lock:
                    cls.reload_state["state"] = "done"
                if old_batcher is not None:
                    # grace: a request that unpacked the old engine just
                    # before the swap must still reach old_batcher.score()
                    # before close() starts refusing new work
                    time.sleep(2.0)
                    old_batcher.close()
                del old_scorer                 # free device buffers
            except Exception as e:             # old engine keeps serving
                with cls.reload_lock:
                    cls.reload_state.update(state="failed", error=str(e))

        threading.Thread(target=_worker, name="scorer-reload",
                         daemon=True).start()
        self._send_json(202, snap)

    def _handle_drift_reset(self) -> None:
        """Forget drift-monitor stream state (after recalibrating the
        threshold or re-baselining the expected rate)."""
        self._drain_body()
        if not self._admin_ok():
            return
        drift = None if self.metrics is None else self.metrics.drift
        if drift is None:
            self._err(409, "no drift monitor on this server (artifacts "
                           "record no calibrated rate and no "
                           "--expected-anomaly-rate was given)")
            return
        drift.reset()
        self._send_json(200, drift.snapshot())

    def _handle_shadow_reset(self) -> None:
        """Zero the shadow-comparison counters (e.g. after a /reload changed
        the primary, or to start a fresh observation window)."""
        self._drain_body()
        if not self._admin_ok():
            return
        if self.shadow is None:
            self._err(409, "no shadow scorer on this server (start the "
                           "daemon with --shadow)")
            return
        self.shadow.reset()
        self._send_json(200, self.shadow.snapshot())

    def _handle_recalibrate(self) -> None:
        """Live gate-threshold recalibration from windows the operator
        asserts are healthy, the answer to the drift monitor's low-side
        alert. The body is a /score-shaped window stack; the new threshold
        is the ``X-Percentile`` (default: the loaded calibration's, p99 for
        4DOF) of their MSE through the current model on the warmed buckets
        (:func:`shm_tpu_torch.calibrate.percentile_threshold`), set in
        place, with the drift monitor re-baselined to the new rate. In
        memory only: the artifacts on disk stay the durable calibration,
        and ``POST /reload`` (or a restart) restores them."""
        if not self._admin_ok():
            return
        if self.warm_error is not None:
            self._err(500, f"warmup failed: {self.warm_error}")
            return
        if not self.ready:
            self._err(503, "still warming up")
            return
        scorer = self.engine[0]
        if not hasattr(scorer, "set_threshold"):
            self._err(501, "this scorer's threshold is baked into its "
                           "program (exported .shmx) — recalibrate "
                           "offline and re-export")
            return
        pct_hdr = self.headers.get("X-Percentile")
        if pct_hdr is not None:
            try:
                pct = float(pct_hdr)
                if not 0.0 < pct < 100.0:
                    raise ValueError
            except (TypeError, ValueError):
                self._err(400, "X-Percentile must be a float in (0, 100)")
                return
        else:
            pct = getattr(scorer, "calibration_percentile", None)
            if pct is None:
                self._err(400, "the loaded artifacts record no calibration "
                               "percentile — pass an X-Percentile header")
                return
        rank = int(getattr(scorer, "request_rank", 3))
        T, D = scorer.seq_len, int(scorer.num_features)
        want = (T, D) + ((2,) if rank == 4 else ())
        W = self._read_array(rank, "windows",
                             "N,T,C,2" if rank == 4 else "N,T,D")
        if W is None:
            return
        if W.shape[0] < 50:
            # a percentile needs a sample (the JAX daemon's guard, after
            # the openLAB recipe's minimum of 50 validation normals)
            self._err(422, f"recalibration needs >= 50 healthy windows for "
                           f"a meaningful percentile; got {int(W.shape[0])}")
            return
        if any(g != e for g, e in zip(W.shape[1:], want)):
            self._err(422, f"scorer serves (N, {', '.join(map(str, want))}) "
                           f"requests; got {tuple(W.shape)}")
            return
        try:
            # one lock for handler-thread device dispatch (same policy as
            # /score_series): in --concurrent mode the batcher's dispatcher
            # owns /score traffic, and this call must not interleave with
            # another handler thread's dispatch
            with self.series_lock:
                out = scorer.score(W)
        except Exception as e:                    # pragma: no cover - defense
            self._err(500, f"scoring failed: {e}")
            return
        from shm_tpu_torch.calibrate import percentile_threshold, summarize_scores

        mse = np.asarray(out["mse"])
        old = float(scorer.threshold)
        new = percentile_threshold(mse, pct)
        scorer.set_threshold(new)
        scorer.calibration_percentile = float(pct)
        rate = 1.0 - pct / 100.0
        scorer.expected_anomaly_rate = rate
        cls = type(self)
        eff = (cls.explicit_rate if cls.explicit_rate is not None else rate)
        from shm_tpu_torch.monitor import DriftMonitor

        cls.metrics.drift = DriftMonitor(eff)     # fresh baseline
        if self.shadow is not None:
            self.shadow.reset()                   # primary decisions changed
        self._send_json(200, {
            "old_threshold": old,
            "threshold": float(new),
            "percentile": float(pct),
            "n_windows": int(W.shape[0]),
            "expected_anomaly_rate": rate,
            "score_summary": summarize_scores(mse),
            "persisted": False,
            "note": "in-memory only; POST /reload (or a restart) restores "
                    "the on-disk calibration",
        })

    def _handle_post(self):
        if self.path == "/reload":
            self._handle_reload()
            return
        if self.path == "/drift/reset":
            self._handle_drift_reset()
            return
        if self.path == "/shadow/reset":
            self._handle_shadow_reset()
            return
        if self.path == "/recalibrate":
            self._handle_recalibrate()
            return
        if self.path not in ("/score", "/score_series"):
            self._err(404, f"unknown path {self.path!r}")
            return
        if self.warm_error is not None:
            self._err(500, f"warmup failed: {self.warm_error}")
            return
        if not self.ready:
            self._err(503, "still warming up")
            return
        scorer, score_fn, _ = self.engine    # one read: reload-consistent
        T = scorer.seq_len
        D = int(scorer.num_features)
        rank = int(getattr(scorer, "request_rank", 3))

        if self.path == "/score_series":
            if not hasattr(scorer, "score_series") or rank == 4:
                self._err(422, "this scorer has no raw-series endpoint "
                               "(openLAB cleaning is a per-run cascade that "
                               "lives in extraction — POST extracted window "
                               "pairs to /score)")
                return
            x = self._read_array(2, "series", "T_total,D")
            if x is None:
                return
            if x.shape[1] != D:
                self._err(422, f"scorer serves D={D} features; "
                               f"got series shape {tuple(x.shape)}")
                return
            try:
                stride = int(self.headers.get("X-Stride", 1))
                if stride < 1:
                    raise ValueError
            except (TypeError, ValueError):
                self._err(400, "X-Stride header must be a positive int")
                return
            if stride not in self.series_strides:
                # every accepted stride was warmed at startup, so a request
                # never pays a first use in the request path
                self._err(422, f"stride {stride} not warmed; this server "
                               f"serves strides {sorted(self.series_strides)} "
                               "(--series-strides at startup)")
                return
            try:
                # one lock for all series dispatch: in concurrent mode many
                # connection threads exist, but their series calls run one
                # at a time
                with self.series_lock:
                    out = scorer.score_series(x, stride=stride)
            except Exception as e:                # pragma: no cover - defense
                self._err(500, f"scoring failed: {e}")
                return
            self._respond_scores(out, len(out["mse"]))
            if self.shadow is not None:           # after the response: the
                self.shadow.submit_series(x, stride, out)   # client never waits
            return

        # expected trailing dims, derived once from the scorer surface
        # (rank 3: (N, T, D) windows; rank 4: (N, T, C, 2) [clean, raw])
        want = (T, D) + ((2,) if rank == 4 else ())
        W = self._read_array(rank, "windows",
                             "N,T,C,2" if rank == 4 else "N,T,D")
        if W is None:
            return
        if W.shape[0] and any(
                e is not None and g != e for g, e in zip(W.shape[1:], want)):
            self._err(422, f"scorer serves (N, {', '.join(map(str, want))}) "
                           f"requests; got {tuple(W.shape)}")
            return
        try:
            out = (score_fn or scorer.score)(W)
        except Exception as e:                    # pragma: no cover - defense
            self._err(500, f"scoring failed: {e}")
            return
        self._respond_scores(out, int(W.shape[0]))
        if self.shadow is not None:               # non-blocking enqueue
            self.shadow.submit_windows(W, out)


def make_server(scorer, host: str = "127.0.0.1", port: int = 8787,
                warmup: bool = True, series_strides=(1,),
                concurrent: bool = False, batch_window_ms: float = 2.0,
                quiet: bool = True,
                expected_rate: Optional[float] = None,
                admin: bool = False, admin_token: Optional[str] = None,
                reload_fn=None,
                shadow_scorer=None,
                shadow_max_pending_windows: int = 8192) -> HTTPServer:
    """Build an HTTP server bound to ``scorer``; warm it in the background.

    ``shadow_scorer``: a candidate scorer (same seq_len, num_features and
    request rank, checked here) that scores every served request again,
    asynchronously, through :class:`shm_tpu_torch.serve_shadow
    .ShadowEngine`; its agreement rides ``/metrics`` as ``shm_shadow_*``.
    It warms after the primary (readiness never waits on it; traffic during
    its warmup is dropped from the comparison and counted). Exposed as
    ``srv.shadow``: call ``srv.shadow.close()`` after ``shutdown()``. A
    successful ``/reload`` (which swaps the primary only) resets the
    comparison counters.

    ``admin=True`` enables the mutating endpoints: ``POST /reload``
    (``reload_fn()`` builds a new scorer from disk, it is warmed while the
    old one serves, then the serving engine swaps; poll ``GET /reload``),
    ``/recalibrate``, ``/drift/reset`` and ``/shadow/reset``. With
    ``admin_token`` every admin endpoint requires a matching
    ``X-Admin-Token`` header (constant-time compare; 401 otherwise);
    without one, keep the bind address trusted.

    ``series_strides`` are the X-Stride values ``/score_series`` accepts;
    each is warmed at startup (``warmup_series``), so an accepted stride
    never pays a first use in the request path. With ``warmup=False`` the
    caller opts into first uses inline on every endpoint.

    ``concurrent=True`` switches to a thread per connection with all
    ``/score`` traffic coalesced by a :class:`~shm_tpu_torch.serve_batch
    .DynamicBatcher` (window ``batch_window_ms``), exposed as
    ``srv.batcher``: call ``srv.batcher.close()`` after ``shutdown()``.

    The socket binds at once: ``/healthz`` answers 503 (and ``/score``
    refuses) until the warmup thread has run every bucket (on the card the
    first one builds the gate kernel with nvcc), then both turn ready. Call
    ``shutdown()`` from another thread to stop. ``srv.warm_event`` fires
    when the warmup ends, also when it fails: then
    ``srv.RequestHandlerClass.warm_error`` holds the error, answered with
    500 on /healthz and /score.
    """
    batcher = None
    score_fn = None              # None -> handler falls back to scorer.score
    server_cls = _Server
    if concurrent:
        from shm_tpu_torch.serve_batch import DynamicBatcher

        batcher = DynamicBatcher(scorer, max_delay_ms=batch_window_ms)
        score_fn = batcher.score
        server_cls = _ThreadingServer
    shadow = None
    if shadow_scorer is not None:
        from shm_tpu_torch.serve_shadow import ShadowEngine, check_compatible

        check_compatible(scorer, shadow_scorer)   # before the worker spawns
        shadow = ShadowEngine(
            shadow_scorer, max_pending_windows=shadow_max_pending_windows,
            series_strides=series_strides)
    explicit_rate = expected_rate
    if expected_rate is None:
        # scorers loaded from_artifacts carry the calibrated healthy rate
        # from their threshold manifest; hand-constructed ones don't -> no
        # drift monitor unless the caller supplies a rate
        expected_rate = getattr(scorer, "expected_anomaly_rate", None)
    handler = type("BoundHandler", (_Handler,),
                   {"engine": (scorer, score_fn, batcher),
                    "ready": not warmup, "series_lock": threading.Lock(),
                    "metrics": ServerMetrics(expected_rate=expected_rate),
                    "warm_error": None, "quiet": quiet,
                    "series_strides": frozenset(int(s) for s in series_strides),
                    "admin": bool(admin),
                    "admin_token": (str(admin_token)
                                    if admin_token else None),
                    "reload_fn": reload_fn,
                    "reload_lock": threading.Lock(),
                    "reload_state": {"state": "idle", "generation": 0,
                                     "error": None},
                    "explicit_rate": explicit_rate,
                    "batch_window_ms": float(batch_window_ms),
                    "warm_on_reload": bool(warmup),
                    "shadow": shadow})
    srv = server_cls((host, port), handler)
    srv.batcher = batcher
    srv.shadow = shadow
    srv.metrics = handler.metrics
    srv.warm_event = threading.Event()
    if warmup:
        def _warm():
            try:
                scorer.warmup()
                if getattr(scorer, "mesh", None) is None:
                    for s in sorted(handler.series_strides):
                        scorer.warmup_series(stride=s)
                handler.ready = True
            except Exception as e:            # surface via /healthz, not just
                handler.warm_error = str(e)   # a stderr-only dead thread
            finally:
                srv.warm_event.set()          # waiters wake either way;
                                              # check handler.warm_error
            if shadow is not None:
                shadow.warm()                 # after readiness; never raises

        threading.Thread(target=_warm, name="scorer-warmup",
                         daemon=True).start()
    else:
        srv.warm_event.set()
        if shadow is not None:
            shadow.mark_warmed()              # caller opted into inline warmup
    return srv


def _parse_args(argv):
    """Parse and check every flag before any artifact or device work, so a
    mistyped flag fails at once. Returns ``(args, series_strides)``."""
    ap = argparse.ArgumentParser(
        prog="shm_tpu_torch.serve_http",
        description="HTTP scoring service over trained 4DOF artifacts "
                    "(PyTorch; on the CUDA card unless --device cpu)")
    ap.add_argument("--root", default="data/4dof",
                    help="artifact root (models/, processed/)")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the CUDA "
                         "card, which must be there; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--openlab", default=None, metavar="ROOT",
                    help="serve the openLAB (bridge) hybrid from this "
                         "artifact root instead of --root: /score takes "
                         "(N, T, C, 2) stacked [clean, raw] extracted "
                         "windows (CNN stage-2; the classical stage-2 modes "
                         "are library-level: they need per-request features)")
    ap.add_argument("--shmx", default=None, metavar="PATH",
                    help="serve a standalone .shmx export "
                         "(shm_tpu_torch.export) instead of --root: its "
                         "program, threshold and bucket policy come from the "
                         "artifact; /recalibrate is refused (the threshold "
                         "is part of the program)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--min-bucket", type=int, default=None,
                    help="smallest padded batch bucket (default 256; for "
                         "--shmx the artifact's recorded policy)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="largest device batch (default 8192; for --shmx "
                         "the artifact's recorded policy)")
    ap.add_argument("--devices", type=int, default=None,
                    help="shard each request over the first N local devices")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the bucket warmup (the first requests build "
                         "the kernel and allocate)")
    ap.add_argument("--series-strides", default="1",
                    help="comma-separated strides /score_series accepts "
                         "(each is warmed at startup; other strides get 422)")
    ap.add_argument("--concurrent", action="store_true",
                    help="thread-per-connection accept + dynamic batching: "
                         "/score requests arriving within the batch window "
                         "coalesce into one scoring call")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="max time a /score request waits for co-traveling "
                         "requests in --concurrent mode (default 2 ms)")
    ap.add_argument("--expected-anomaly-rate", type=float, default=None,
                    metavar="P", help="healthy gate anomaly rate the drift "
                    "monitor baselines against (default: from the loaded "
                    "threshold manifest)")
    ap.add_argument("--shadow", default=None, metavar="ROOT",
                    help="shadow (canary) scorer: an artifact root (or a "
                         ".shmx export) whose "
                         "model scores every served request again, "
                         "asynchronously; responses always come from the "
                         "primary, and the agreement accumulates as "
                         "shm_shadow_* on /metrics. Must serve the same "
                         "(T, D) request surface")
    ap.add_argument("--shadow-queue-windows", type=int, default=8192,
                    help="max windows queued for the shadow before new work "
                         "is dropped (never blocks live traffic; default "
                         "8192)")
    ap.add_argument("--admin", action="store_true",
                    help="enable the mutating admin endpoints: POST /reload "
                         "(warm-then-swap), /recalibrate, /drift/reset, "
                         "/shadow/reset. Pair with --admin-token unless the "
                         "bind address is trusted")
    ap.add_argument("--admin-token", default=None, metavar="TOKEN",
                    help="shared secret for the admin surface: every admin "
                         "request must carry a matching X-Admin-Token "
                         "header (constant-time compare; 401 otherwise). "
                         "Pass the value, or '@env' to read it from the "
                         "SHM_TPU_ADMIN_TOKEN environment variable")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.openlab is not None and args.shmx is not None:
        ap.error("--openlab and --shmx are mutually exclusive")
    if args.admin_token is not None:
        if not args.admin:
            ap.error("--admin-token requires --admin (the token guards the "
                     "admin surface; without --admin there is nothing to "
                     "guard)")
        if args.admin_token == "@env":
            args.admin_token = os.environ.get("SHM_TPU_ADMIN_TOKEN", "")
        if not args.admin_token:
            ap.error("--admin-token must be non-empty (with '@env', set the "
                     "SHM_TPU_ADMIN_TOKEN environment variable)")
    if args.shadow_queue_windows < 1:
        ap.error("--shadow-queue-windows must be >= 1")
    if (args.expected_anomaly_rate is not None
            and not 0.0 < args.expected_anomaly_rate < 1.0):
        ap.error("--expected-anomaly-rate must be in (0, 1)")
    if args.shmx is not None:
        if args.devices and args.devices > 1:
            ap.error("--devices does not apply to --shmx: exported programs "
                     "are single-device (shard upstream of the daemon)")
    else:
        # in-process scorers take concrete policy values; --shmx leaves
        # None so that the artifact's recorded min_bucket / max_batch apply
        if args.min_bucket is None:
            args.min_bucket = 256
        if args.max_batch is None:
            args.max_batch = 8192
    try:
        strides = tuple(int(s) for s in args.series_strides.split(",")
                        if s.strip())
        if any(s < 1 for s in strides):
            raise ValueError
    except ValueError:
        ap.error(f"--series-strides must be comma-separated positive ints "
                 f"(or '' to disable /score_series), got "
                 f"{args.series_strides!r}")
    return args, strides


def _load_scorer(args, root=None):
    """Build the scorer the parsed args describe from ``root`` (default
    ``--shmx``, ``--openlab`` or ``--root``): the slow step (artifact loads,
    device init). A ``.shmx`` export by suffix, else an openLAB root under
    ``--openlab``, a 4DOF root otherwise. Raises without a card unless
    ``--device cpu``."""
    kw = dict(device=args.device, min_bucket=args.min_bucket,
              max_batch=args.max_batch)
    if root is not None:            # a shadow: a concrete policy beside --shmx
        kw.update(min_bucket=args.min_bucket or 256,
                  max_batch=args.max_batch or 8192)
    elif args.shmx is not None:
        root = args.shmx
    elif args.devices and args.devices > 1:
        # the primary only: the shadow is one device's statistics sample
        from shm_tpu_torch.parallel import make_mesh

        kw["mesh"] = make_mesh(args.devices, device=args.device)
    if root is not None and str(root).endswith(".shmx"):
        from shm_tpu_torch.export import load_exported_scorer

        scorer = load_exported_scorer(root, **kw)
        print(f"[serve] loaded exported program {root} on {scorer.device}; "
              f"buckets={list(scorer.buckets())} T={scorer.seq_len}")
        return scorer
    if args.openlab is not None:
        from shm_tpu_torch.serve_openlab import OpenLabScorer

        root = args.openlab if root is None else root
        scorer = OpenLabScorer.from_artifacts(root, **kw)
        print(f"[serve] loaded openLAB artifacts from {root} on "
              f"{scorer.device}; buckets={list(scorer.buckets())} "
              f"T={scorer.seq_len} request=(N, {scorer.seq_len}, "
              f"{scorer.num_features}, 2)")
        return scorer
    from shm_tpu_torch.serve import HybridScorer

    root = args.root if root is None else root
    scorer = HybridScorer.from_artifacts(root, **kw)
    print(f"[serve] loaded artifacts from {root} on {scorer.device}; "
          f"buckets={list(scorer.buckets())} T={scorer.seq_len}")
    return scorer


def _load_shadow_scorer(args):
    """The candidate scorer of ``--shadow PATH`` (a ``.shmx`` export, or a
    root of the primary's stage), on the primary's device."""
    sc = _load_scorer(args, args.shadow)
    print(f"[serve] shadow candidate loaded from {args.shadow}; agreement "
          f"on /metrics (shm_shadow_*)")
    return sc


def main(argv=None) -> None:
    args, strides = _parse_args(argv)
    scorer = _load_scorer(args)
    shadow_scorer = (None if args.shadow is None
                     else _load_shadow_scorer(args))
    srv = make_server(scorer, args.host, args.port,
                      warmup=not args.no_warmup,
                      series_strides=strides, concurrent=args.concurrent,
                      batch_window_ms=args.batch_window_ms,
                      quiet=not args.verbose,
                      expected_rate=args.expected_anomaly_rate,
                      admin=args.admin, admin_token=args.admin_token,
                      reload_fn=(lambda: _load_scorer(args)),
                      shadow_scorer=shadow_scorer,
                      shadow_max_pending_windows=args.shadow_queue_windows)
    if srv.metrics.drift is not None:
        print(f"[serve] drift monitor on: expected anomaly rate "
              f"{srv.metrics.drift.expected_rate:.4g} (/metrics)")
    print(f"[serve] listening on http://{args.host}:{srv.server_address[1]} "
          f"(healthz 503 until every bucket is warm)")

    def _announce():
        srv.warm_event.wait()
        err = srv.RequestHandlerClass.warm_error
        if err is not None:
            print(f"[serve] WARMUP FAILED: {err} — healthz/score answer 500")
        else:
            print("[serve] warm: every bucket ran once; serving traffic")

    threading.Thread(target=_announce, daemon=True).start()
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("[serve] shutting down")
        srv.shutdown()
    finally:
        if srv.batcher is not None:
            srv.batcher.close()
        if srv.shadow is not None:
            srv.shadow.close()


__all__ = ["ServerMetrics", "make_server", "main"]


if __name__ == "__main__":
    main()
