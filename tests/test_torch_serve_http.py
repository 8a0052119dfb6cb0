"""The port's HTTP scoring service (``shm_tpu_torch/serve_http.py``): the
contracts of tests/test_serve_http.py over a real socket on 127.0.0.1 (both
encodings, malformed bodies, warmup, admin, metrics), with the port's
scorer on the CPU; one request sent to the JAX daemon and to the port's on
carried weights (mse within ``MSE_ATOL``, decisions exact); a scorer whose
warmup raises; and the flags the port refuses.
"""

import http.client
import io
import json
import threading
import time
import urllib.request
import urllib.error

import numpy as np
import pytest

from shm_tpu.serve_http import make_server as jax_make_server
from shm_tpu_torch.calibrate import percentile_threshold
from shm_tpu_torch.serve_http import MAX_BODY_BYTES, make_server
from torch_serve_models import (
    assert_close_outputs, err_code, jax_scorer, octet, port_scorer, req,
)


@pytest.fixture(scope="module")
def server():
    T, D = 20, 4
    scorer = port_scorer(seq_len=T)
    warmed = []
    real = scorer.warmup_series
    scorer.warmup_series = lambda stride=1, batch_sizes=None: (
        warmed.append(stride), real(stride, batch_sizes))
    srv = make_server(scorer, port=0,            # ephemeral port
                      series_strides=(1, 2))     # stride 2 used in tests
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    assert srv.warm_event.wait(timeout=300), "warmup never finished"
    scorer.warmed_strides = warmed
    yield base, scorer, T, D
    srv.shutdown()
    srv.server_close()


def _req(url, data=None, headers=None, method=None):
    r = urllib.request.Request(url, data=data, headers=headers or {},
                               method=method)
    with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read()


def test_healthz_503_during_warmup():
    """Liveness during warmup: the socket must answer (503) while buckets
    compile — on the real platform that window is minutes long."""
    class SlowScorer:
        def __init__(self):
            # instance-level: a class-level Event would stay set across
            # reruns of this test in one process
            self.gate = threading.Event()

        mean = np.zeros(4, np.float32)
        threshold = np.float32(1.0)
        min_bucket, max_batch, seq_len = 16, 32, 20
        use_fused_vae = False
        mesh = None

        def buckets(self):
            return [16, 32]

        def warmup(self):
            self.gate.wait(timeout=60)

        def warmup_series(self, stride=1, batch_sizes=None):
            pass                    # accepted strides are warmed at startup

    sc = SlowScorer()
    srv = make_server(sc, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/healthz")
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/score", data=b"x",
                 headers={"Content-Type": "application/json"}, method="POST")
        assert ei.value.code == 503
        sc.gate.set()
        assert srv.warm_event.wait(timeout=30)
        code, _, body = _req(base + "/healthz")
        assert code == 200 and json.loads(body)["warm"] is True
    finally:
        sc.gate.set()
        srv.shutdown()
        srv.server_close()


def test_healthz_and_info(server):
    base, scorer, T, D = server
    code, _, body = _req(base + "/healthz")
    assert code == 200 and json.loads(body)["warm"] is True
    code, _, body = _req(base + "/info")
    info = json.loads(body)
    assert info["seq_len"] == T and info["num_features"] == D
    assert info["buckets"] == list(scorer.buckets())


def test_score_octet_stream_matches_scorer(server):
    base, scorer, T, D = server
    W = np.random.default_rng(0).normal(size=(7, T, D)).astype(np.float32)
    code, _, body = _req(
        base + "/score", data=W.tobytes(),
        headers={"Content-Type": "application/octet-stream",
                 "X-Shape": f"7,{T},{D}"}, method="POST")
    assert code == 200
    got = json.loads(body)
    ref = scorer.score(W)
    assert got["n"] == 7
    np.testing.assert_allclose(got["mse"], ref["mse"], rtol=1e-5)
    assert got["y_pred"] == ref["y_pred"].astype(int).tolist()
    assert got["anomalous"] == ref["anomalous"].astype(bool).tolist()


def test_score_binary_response(server):
    base, scorer, T, D = server
    W = np.random.default_rng(1).normal(size=(3, T, D)).astype(np.float32)
    code, ctype, body = _req(
        base + "/score", data=W.tobytes(),
        headers={"Content-Type": "application/octet-stream",
                 "X-Shape": f"3,{T},{D}",
                 "Accept": "application/octet-stream"}, method="POST")
    assert code == 200 and ctype == "application/octet-stream"
    z = np.load(io.BytesIO(body))
    ref = scorer.score(W)
    np.testing.assert_allclose(z["mse"], ref["mse"], rtol=1e-6)
    np.testing.assert_array_equal(z["y_pred"], ref["y_pred"])


def test_score_series_endpoint_matches_scorer(server):
    base, scorer, T, D = server
    x = np.random.default_rng(3).normal(size=(T + 25, D)).astype(np.float32)
    code, _, body = _req(
        base + "/score_series", data=x.tobytes(),
        headers={"Content-Type": "application/octet-stream",
                 "X-Shape": f"{x.shape[0]},{D}", "X-Stride": "2"},
        method="POST")
    assert code == 200
    got = json.loads(body)
    ref = scorer.score_series(x, stride=2)
    assert got["n"] == len(ref["mse"]) == 25 // 2 + 1
    np.testing.assert_allclose(got["mse"], ref["mse"], rtol=1e-5)
    assert got["y_pred"] == ref["y_pred"].astype(int).tolist()
    # JSON body + default stride
    code, _, body = _req(
        base + "/score_series",
        data=json.dumps({"series": x.tolist()}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    assert json.loads(body)["n"] == 26
    # wrong feature count -> 422; bad stride -> 400; unwarmed stride -> 422
    # (an unwarmed stride would compile a fresh program per bucket inline
    # in the single-threaded request path — minutes on the real platform)
    for want_code, hdrs, data in (
        (422, {"Content-Type": "application/octet-stream",
               "X-Shape": f"{T},{D + 1}"},
         np.zeros((T, D + 1), np.float32).tobytes()),
        (400, {"Content-Type": "application/octet-stream",
               "X-Shape": f"{T},{D}", "X-Stride": "0"},
         np.zeros((T, D), np.float32).tobytes()),
        (422, {"Content-Type": "application/octet-stream",
               "X-Shape": f"{T},{D}", "X-Stride": "3"},
         np.zeros((T, D), np.float32).tobytes()),
    ):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/score_series", data=data, headers=hdrs, method="POST")
        assert ei.value.code == want_code, hdrs


def test_accepted_series_strides_are_warmed(server):
    """Every stride the server accepts was warmed at startup
    (``warmup_series``), so none pays a first use in the request path."""
    _, scorer, _, _ = server
    assert sorted(scorer.warmed_strides) == [1, 2]


def test_xshape_overflow_gets_400_not_dropped_connection(server):
    """A crafted X-Shape whose int64 product wraps to match the body length
    must get a clean 400, not an uncaught reshape ValueError that drops the
    connection without any HTTP response."""
    base, _, T, D = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        _req(base + "/score", data=b"\x00" * 16,
             headers={"Content-Type": "application/octet-stream",
                      "X-Shape": "4,4611686018427387905,1"}, method="POST")
    assert ei.value.code == 400


def test_score_json_body(server):
    base, scorer, T, D = server
    W = np.random.default_rng(2).normal(size=(2, T, D)).astype(np.float32)
    code, _, body = _req(
        base + "/score",
        data=json.dumps({"windows": W.tolist()}).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    assert code == 200
    got = json.loads(body)
    ref = scorer.score(W)
    np.testing.assert_allclose(got["mse"], ref["mse"], rtol=1e-5)


def test_warmup_failure_surfaces_on_healthz():
    """A warmup crash must flip healthz/score to 500 (not 503 forever)."""
    class BrokenScorer:
        mean = np.zeros(4, np.float32)
        threshold = np.float32(1.0)
        min_bucket, max_batch, seq_len = 16, 32, 20
        use_fused_vae = False
        mesh = None

        def buckets(self):
            return [16, 32]

        def warmup(self):
            raise RuntimeError("compile exploded")

    srv = make_server(BrokenScorer(), port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert srv.warm_event.wait(timeout=30)
        assert srv.RequestHandlerClass.warm_error == "compile exploded"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/healthz")
        assert ei.value.code == 500
        assert "compile exploded" in json.loads(ei.value.read())["error"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_error_responses_close_keepalive_connection(server):
    """Error paths may leave an unread body on the socket; under HTTP/1.1
    keep-alive those bytes would be parsed as the next request line, so every
    error must carry Connection: close."""
    import http.client

    base, scorer, T, D = server
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/score", body=b"[1,2,3]",
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 400                    # non-dict JSON -> clean 400
        assert (r.getheader("Connection") or "").lower() == "close"
        r.read()
    finally:
        conn.close()


@pytest.mark.parametrize("case", ["bad_shape_header", "short_body",
                                  "wrong_T", "bad_ctype", "bad_json",
                                  "json_not_dict", "not_found"])
def test_bad_requests(server, case):
    base, scorer, T, D = server
    try:
        if case == "bad_shape_header":
            _req(base + "/score", data=b"\0" * 16,
                 headers={"Content-Type": "application/octet-stream",
                          "X-Shape": "nope"}, method="POST")
        elif case == "short_body":
            _req(base + "/score", data=b"\0" * 16,
                 headers={"Content-Type": "application/octet-stream",
                          "X-Shape": f"7,{T},{D}"}, method="POST")
        elif case == "wrong_T":
            W = np.zeros((2, T + 1, D), np.float32)
            _req(base + "/score", data=W.tobytes(),
                 headers={"Content-Type": "application/octet-stream",
                          "X-Shape": f"2,{T + 1},{D}"}, method="POST")
        elif case == "bad_ctype":
            _req(base + "/score", data=b"x",
                 headers={"Content-Type": "text/plain"}, method="POST")
        elif case == "bad_json":
            _req(base + "/score", data=b"{not json",
                 headers={"Content-Type": "application/json"}, method="POST")
        elif case == "json_not_dict":
            _req(base + "/score", data=b"[1, 2, 3]",
                 headers={"Content-Type": "application/json"}, method="POST")
        elif case == "not_found":
            _req(base + "/nope")
    except urllib.error.HTTPError as e:
        assert 400 <= e.code < 500
        assert "error" in json.loads(e.read())
    else:
        pytest.fail("expected an HTTP error")


def test_metrics_endpoint(server):
    """/metrics: the domain counters (windows scored / anomalous / per-class)
    must track scoring traffic exactly, request counters must label by
    path+status with unknown paths folded into "other", and the Prometheus
    text rendering must be well-formed with monotone cumulative buckets."""
    import re

    base, scorer, T, D = server

    def snap():
        _, _, body = _req(base + "/metrics",
                          headers={"Accept": "application/json"})
        return json.loads(body)

    before = snap()
    W = np.random.default_rng(7).normal(size=(5, T, D)).astype(np.float32)
    ref = scorer.score(W)
    _req(base + "/score", data=W.tobytes(),
         headers={"Content-Type": "application/octet-stream",
                  "X-Shape": f"5,{T},{D}"}, method="POST")
    with pytest.raises(urllib.error.HTTPError):
        _req(base + "/score", data=b"x",
             headers={"Content-Type": "text/plain"}, method="POST")
    with pytest.raises(urllib.error.HTTPError):
        _req(base + "/bogus")
    after = snap()

    assert after["ready"] is True
    assert after["windows_scored"] - before["windows_scored"] == 5
    assert (after["windows_anomalous"] - before["windows_anomalous"]
            == int(ref["anomalous"].sum()))
    dclass = {k: after["pred_class_counts"][k] - before["pred_class_counts"][k]
              for k in after["pred_class_counts"]}
    y = np.asarray(ref["y_pred"])
    assert dclass == {"Normal": int((y == 0).sum()),
                      "Sensor Fault": int((y == 1).sum()),
                      "Structural Fault": int((y == 2).sum())}
    assert (after["requests"].get("/score 200", 0)
            - before["requests"].get("/score 200", 0)) == 1
    assert (after["requests"].get("/score 415", 0)
            - before["requests"].get("/score 415", 0)) == 1
    assert (after["requests"].get("other 404", 0)
            - before["requests"].get("other 404", 0)) == 1
    lat = after["latency_seconds"]["/score"]
    assert lat["count"] >= 1 and lat["sum"] > 0

    # Prometheus rendering: every non-comment line is `name{labels} value`,
    # the totals agree with the JSON snapshot, buckets are cumulative
    code, ctype, body = _req(base + "/metrics")
    assert code == 200 and ctype.startswith("text/plain")
    text = body.decode()
    line_re = re.compile(r'^[a-z_]+(\{[^}]*\})? -?[0-9.einf+]+$', re.I)
    for line in text.strip().split("\n"):
        if not line.startswith("#"):
            assert line_re.match(line), line
    assert f'shm_windows_scored_total {after["windows_scored"]}' in text
    cum = [int(m.group(1)) for m in re.finditer(
        r'shm_request_seconds_bucket\{path="/score",le="[^"]*"\} (\d+)', text)]
    assert cum and cum == sorted(cum)
    assert cum[-1] == lat["count"]        # +Inf bucket equals _count
    # the fixture scorer is hand-constructed (no threshold manifest), so
    # the drift monitor must be off, not defaulted to a made-up baseline
    assert after["drift"] is None
    assert "shm_drift_" not in text


def test_metrics_drift_monitor(server):
    """An explicit expected_rate turns the drift monitor on: the snapshot
    tracks scored traffic, a saturated gate raises the high-side alert, and
    the Prometheus rendering carries the drift gauges."""
    base, scorer, T, D = server
    srv = make_server(scorer, port=0, warmup=False,   # buckets already warm
                      expected_rate=0.01)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        b2 = f"http://127.0.0.1:{srv.server_address[1]}"
        W = np.random.default_rng(11).normal(
            size=(32, T, D)).astype(np.float32)
        ref = scorer.score(W)
        _req(b2 + "/score", data=W.tobytes(),
             headers={"Content-Type": "application/octet-stream",
                      "X-Shape": f"32,{T},{D}"}, method="POST")
        _, _, body = _req(b2 + "/metrics",
                          headers={"Accept": "application/json"})
        d = json.loads(body)["drift"]
        assert d["expected_rate"] == pytest.approx(0.01)
        assert d["windows"] == 32
        assert d["anomalous"] == int(ref["anomalous"].sum())
        # random-params scorer at threshold 1.0 gates every noise window ->
        # a saturated rate is exactly the drift the monitor must flag
        if d["anomalous"] == d["windows"]:
            assert d["alert_high"] and d["alerts_high_total"] >= 1
        _, _, text = _req(b2 + "/metrics")
        text = text.decode()
        assert "shm_drift_expected_rate 0.01" in text
        assert 'shm_drift_cusum{side="high"}' in text
        assert 'shm_drift_alert{side="low"} 0' in text
    finally:
        srv.shutdown()
        srv.server_close()


def test_parse_args_bucket_policy_and_early_validation():
    """The documented 256/8192 bucket defaults and --device; malformed flags
    fail at parse time, before any artifact or device work."""
    from shm_tpu_torch.serve_http import _parse_args

    args, strides = _parse_args([])
    assert (args.min_bucket, args.max_batch) == (256, 8192)
    assert args.device is None and strides == (1,)
    args, strides = _parse_args(["--device", "cpu", "--series-strides",
                                 "1,2", "--min-bucket", "64"])
    assert args.device == "cpu" and strides == (1, 2)
    assert args.min_bucket == 64
    for bad in (["--series-strides", "1,x"],
                ["--series-strides", "0"],
                ["--shadow-queue-windows", "0"],
                ["--expected-anomaly-rate", "1.5"]):
        with pytest.raises(SystemExit):
            _parse_args(bad)


@pytest.mark.parametrize("argv,item", [
    (["--openlab", "data/openlab", "--shmx", "gate.shmx"], "mutually exclusive"),
    (["--shmx", "gate.shmx", "--devices", "2"], "does not apply to --shmx"),
    (["--devices", "2"], None),
    (["--shadow", "gate.shmx", "--devices", "2"], None),
])
def test_parse_args_refuses_unported_paths(argv, item, capsys):
    """The JAX daemon's refusals, with its messages: ``--openlab`` beside
    ``--shmx``, and ``--devices`` beside ``--shmx`` (an export is one
    device's program); ``--devices 2`` is parsed, alone and beside a
    ``.shmx`` shadow (the shadow stays on one device;
    ``tests/test_torch_parallel_cli.py`` serves a mesh); --devices 1 is one
    device."""
    from shm_tpu_torch.serve_http import _parse_args

    if item is None:
        args, _ = _parse_args(argv)
        assert args.devices == 2
    else:
        with pytest.raises(SystemExit) as ei:
            _parse_args(argv)
        assert ei.value.code == 2
        assert item in capsys.readouterr().err
    args, _ = _parse_args(["--devices", "1"])
    assert args.devices == 1


def test_parse_args_admin_token(monkeypatch):
    """--admin-token validation: requires --admin, must be non-empty, and
    '@env' resolves through SHM_TPU_ADMIN_TOKEN (so the secret never rides
    the process command line)."""
    from shm_tpu_torch.serve_http import _parse_args

    args, _ = _parse_args(["--admin", "--admin-token", "s3cret"])
    assert args.admin_token == "s3cret"

    monkeypatch.setenv("SHM_TPU_ADMIN_TOKEN", "from-env")
    args, _ = _parse_args(["--admin", "--admin-token", "@env"])
    assert args.admin_token == "from-env"

    monkeypatch.delenv("SHM_TPU_ADMIN_TOKEN")
    for bad in (["--admin-token", "x"],                 # token without --admin
                ["--admin", "--admin-token", ""],       # empty token
                ["--admin", "--admin-token", "@env"]):  # env var unset
        with pytest.raises(SystemExit):
            _parse_args(bad)


# ----------------------------------------------------------------------
# admin surface: hot reload + drift reset


def _mini_scorer(T, D, threshold, rate=None):
    return port_scorer(threshold=threshold, rate=rate, seq_len=T)


def _wait_reload(base, want="done", tries=200):
    for _ in range(tries):
        _, _, body = _req(base + "/reload")
        state = json.loads(body)
        if state["state"] == want:
            return state
        time.sleep(0.05)
    raise AssertionError(f"reload never reached {want!r}: {state}")


def test_admin_endpoints_disabled_by_default(server):
    """Without admin=True the mutating endpoints must refuse (403), and the
    read side reports admin off."""
    base, _, _, _ = server
    _, _, body = _req(base + "/info")
    assert json.loads(body)["admin"] is False
    for path in ("/reload", "/drift/reset"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + path, data=b"", method="POST")
        assert ei.value.code == 403


def test_admin_token_guards_admin_surface():
    """make_server(admin_token=...): every admin endpoint (GET /reload and
    the mutating POSTs) answers 401 without — or with a wrong —
    X-Admin-Token header; the right token restores normal behavior; the
    scoring/observability surface never requires a token."""
    T, D = 20, 4
    sc = _mini_scorer(T, D, threshold=1e-6, rate=0.01)
    srv = make_server(sc, port=0, admin=True, admin_token="s3cret")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    assert srv.warm_event.wait(timeout=300)
    tok = {"X-Admin-Token": "s3cret"}
    try:
        # token absent / wrong -> 401 on every admin endpoint
        for path, method in (("/reload", "GET"), ("/reload", "POST"),
                             ("/drift/reset", "POST"),
                             ("/shadow/reset", "POST"),
                             ("/recalibrate", "POST")):
            data = b"" if method == "POST" else None
            for hdr in ({}, {"X-Admin-Token": "wrong"}):
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _req(base + path, data=data, headers=hdr, method=method)
                assert ei.value.code == 401, (path, method, hdr)

        # right token -> the admin surface behaves as without a token
        code, _, body = _req(base + "/reload", headers=tok)
        assert code == 200 and json.loads(body)["state"] == "idle"
        code, _, body = _req(base + "/drift/reset", data=b"", headers=tok,
                             method="POST")
        assert code == 200 and json.loads(body)["windows"] == 0
        with pytest.raises(urllib.error.HTTPError) as ei:   # past the gate:
            _req(base + "/reload", data=b"", headers=tok, method="POST")
        assert ei.value.code == 501                         # no reload_fn
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/shadow/reset", data=b"", headers=tok, method="POST")
        assert ei.value.code == 409                         # no shadow

        # non-admin surface never needs the token
        code, _, _ = _req(base + "/healthz")
        assert code == 200
        W = np.random.default_rng(2).normal(size=(4, T, D)).astype(np.float32)
        code, _, _ = _req(base + "/score", data=W.tobytes(),
                          headers={"Content-Type": "application/octet-stream",
                                   "X-Shape": f"4,{T},{D}"}, method="POST")
        assert code == 200
    finally:
        srv.shutdown()
        srv.server_close()


def test_admin_reload_hot_swap():
    """POST /reload rebuilds the scorer via reload_fn, warms it, and swaps
    atomically: decisions flip to the new threshold, /info reflects the new
    scorer, drift re-baselines against the new calibration, and the old
    engine served throughout (no 503s). A failing reload_fn leaves the old
    engine serving."""
    T, D = 20, 4
    old = _mini_scorer(T, D, threshold=1e-6)          # everything anomalous
    new_scorers = [_mini_scorer(T, D, threshold=1e9, rate=0.02)]

    calls = {"n": 0}

    def reload_fn():
        calls["n"] += 1
        if not new_scorers:
            raise RuntimeError("artifact dir vanished")
        return new_scorers.pop()

    srv = make_server(old, port=0, admin=True, reload_fn=reload_fn)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    assert srv.warm_event.wait(timeout=300)
    try:
        W = np.random.default_rng(0).normal(size=(8, T, D)).astype(np.float32)
        hdr = {"Content-Type": "application/octet-stream",
               "X-Shape": f"8,{T},{D}"}
        _, _, body = _req(base + "/score", data=W.tobytes(), headers=hdr,
                          method="POST")
        assert all(json.loads(body)["anomalous"])     # old threshold 1e-6
        assert json.loads(_req(base + "/metrics",
                               headers={"Accept": "application/json"}
                               )[2])["drift"] is None  # old scorer: no rate

        code, _, body = _req(base + "/reload", data=b"", method="POST")
        assert code == 202 and json.loads(body)["state"] == "loading"
        state = _wait_reload(base)
        assert state["generation"] == 1 and state["error"] is None
        assert calls["n"] == 1

        _, _, body = _req(base + "/score", data=W.tobytes(), headers=hdr,
                          method="POST")
        assert not any(json.loads(body)["anomalous"])  # new threshold 1e9
        _, _, body = _req(base + "/info")
        assert json.loads(body)["threshold"] == pytest.approx(1e9)
        d = json.loads(_req(base + "/metrics",
                            headers={"Accept": "application/json"})[2])["drift"]
        assert d is not None and d["expected_rate"] == pytest.approx(0.02)
        assert d["windows"] == 8   # fresh baseline: only post-reload traffic

        # second reload fails -> state failed, old (=swapped) engine serves on
        code, _, _ = _req(base + "/reload", data=b"", method="POST")
        assert code == 202
        state = _wait_reload(base, want="failed")
        assert "vanished" in state["error"] and state["generation"] == 2
        _, _, body = _req(base + "/score", data=W.tobytes(), headers=hdr,
                          method="POST")
        assert not any(json.loads(body)["anomalous"])
    finally:
        srv.shutdown()
        srv.server_close()


def test_admin_reload_501_without_reload_fn_and_drift_reset():
    """admin=True without a reload_fn -> /reload is 501; /drift/reset clears
    stream state (and is 409 when no monitor exists)."""
    T, D = 20, 4
    sc = _mini_scorer(T, D, threshold=1e-6, rate=0.01)
    srv = make_server(sc, port=0, admin=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    assert srv.warm_event.wait(timeout=300)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/reload", data=b"", method="POST")
        assert ei.value.code == 501

        W = np.random.default_rng(1).normal(size=(8, T, D)).astype(np.float32)
        _req(base + "/score", data=W.tobytes(),
             headers={"Content-Type": "application/octet-stream",
                      "X-Shape": f"8,{T},{D}"}, method="POST")
        # read drift over HTTP: metrics.record() runs after the /score
        # response is written, so a later request is ordered behind it —
        # a direct srv.metrics read here would race that finally-block
        d = json.loads(_req(base + "/metrics",
                            headers={"Accept": "application/json"})[2])["drift"]
        assert d["windows"] == 8
        code, _, body = _req(base + "/drift/reset", data=b"", method="POST")
        assert code == 200 and json.loads(body)["windows"] == 0
        d = json.loads(_req(base + "/metrics",
                            headers={"Accept": "application/json"})[2])["drift"]
        assert d["windows"] == 0
    finally:
        srv.shutdown()
        srv.server_close()

    plain = make_server(_mini_scorer(T, D, 1.0), port=0, admin=True)
    t = threading.Thread(target=plain.serve_forever, daemon=True)
    t.start()
    b2 = f"http://127.0.0.1:{plain.server_address[1]}"
    assert plain.warm_event.wait(timeout=300)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(b2 + "/drift/reset", data=b"", method="POST")
        assert ei.value.code == 409        # no calibrated rate -> no monitor
    finally:
        plain.shutdown()
        plain.server_close()


def test_admin_reload_concurrent_mode_swaps_batcher():
    """In --concurrent mode the reload must hand /score traffic to a NEW
    DynamicBatcher bound to the new scorer, update srv.batcher, and close
    the old batcher after the grace window."""
    T, D = 20, 4
    old = _mini_scorer(T, D, threshold=1e-6)
    new_scorers = [_mini_scorer(T, D, threshold=1e9)]
    srv = make_server(old, port=0, admin=True, concurrent=True,
                      reload_fn=lambda: new_scorers.pop())
    first_batcher = srv.batcher
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    assert srv.warm_event.wait(timeout=300)
    try:
        W = np.random.default_rng(2).normal(size=(4, T, D)).astype(np.float32)
        hdr = {"Content-Type": "application/octet-stream",
               "X-Shape": f"4,{T},{D}"}
        code, _, _ = _req(base + "/reload", data=b"", method="POST")
        assert code == 202
        _wait_reload(base)
        assert srv.batcher is not first_batcher and srv.batcher is not None
        _, _, body = _req(base + "/score", data=W.tobytes(), headers=hdr,
                          method="POST")
        assert not any(json.loads(body)["anomalous"])
        # the old batcher is closed after the 2 s grace window
        deadline = time.time() + 10
        while not first_batcher._closed and time.time() < deadline:
            time.sleep(0.2)
        assert first_batcher._closed
    finally:
        srv.shutdown()
        srv.server_close()
        if srv.batcher is not None:
            srv.batcher.close()


def test_admin_posts_drain_body_on_keepalive():
    """Admin POSTs with a body the handler ignores must drain it — leftover
    bytes would be parsed as the NEXT request line on a keep-alive
    connection."""
    import http.client

    T, D = 20, 4
    sc = _mini_scorer(T, D, threshold=1e-6, rate=0.01)
    srv = make_server(sc, port=0, admin=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    assert srv.warm_event.wait(timeout=300)
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=30)
    try:
        body = b'{"why": "recalibrated", "pad": "' + b"x" * 4096 + b'"}'
        conn.request("POST", "/drift/reset", body=body,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200
        assert json.loads(r.read())["windows"] == 0
        # SAME connection: a stale body would corrupt this request line
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["warm"] is True
    finally:
        conn.close()
        srv.shutdown()
        srv.server_close()


def test_admin_reload_recovers_from_failed_startup_warmup():
    """A scorer whose startup warmup failed leaves /healthz and /score at
    500 — a successful /reload (new scorer, warmed) must clear the error
    and bring the daemon to ready."""
    T, D = 20, 4

    class BrokenScorer:
        mean = np.zeros(D, np.float32)
        threshold = np.float32(1.0)
        min_bucket, max_batch, seq_len = 16, 32, T
        num_features = D
        use_fused_vae = False
        mesh = None

        def buckets(self):
            return [16, 32]

        def warmup(self):
            raise RuntimeError("compile exploded")

    good = [_mini_scorer(T, D, threshold=1e9)]
    srv = make_server(BrokenScorer(), port=0, admin=True,
                      reload_fn=lambda: good.pop())
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert srv.warm_event.wait(timeout=30)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/healthz")
        assert ei.value.code == 500

        code, _, _ = _req(base + "/reload", data=b"", method="POST")
        assert code == 202
        _wait_reload(base)
        code, _, body = _req(base + "/healthz")
        assert code == 200 and json.loads(body)["warm"] is True
        W = np.zeros((4, T, D), np.float32)
        code, _, body = _req(base + "/score", data=W.tobytes(),
                             headers={"Content-Type":
                                      "application/octet-stream",
                                      "X-Shape": f"4,{T},{D}"},
                             method="POST")
        assert code == 200 and not any(json.loads(body)["anomalous"])
    finally:
        srv.shutdown()
        srv.server_close()


# ----------------------------------------------------------------------
# admin surface: live threshold recalibration


def test_admin_recalibrate_swaps_threshold_live():
    """POST /recalibrate re-thresholds the gate from operator-supplied
    healthy windows at the requested percentile, swaps it in place (no
    recompiles — the threshold rides dispatch as an argument), re-baselines
    the drift monitor, and is in-memory only."""
    T, D = 20, 4
    sc = _mini_scorer(T, D, threshold=1e-6, rate=0.01)
    srv = make_server(sc, port=0, admin=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    assert srv.warm_event.wait(timeout=300)
    try:
        W = np.random.default_rng(3).normal(size=(64, T, D)).astype(np.float32)
        ref = sc.score(W)
        hdr = {"Content-Type": "application/octet-stream",
               "X-Shape": f"64,{T},{D}"}
        # hand-constructed scorer records no calibration percentile -> the
        # operator must say which percentile they want
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/recalibrate", data=W.tobytes(), headers=hdr,
                 method="POST")
        assert ei.value.code == 400
        assert "X-Percentile" in json.loads(ei.value.read())["error"]

        code, _, body = _req(base + "/recalibrate", data=W.tobytes(),
                             headers={**hdr, "X-Percentile": "90"},
                             method="POST")
        assert code == 200
        resp = json.loads(body)
        want_thr = float(np.percentile(ref["mse"], 90.0))
        assert percentile_threshold(ref["mse"], 90.0) == pytest.approx(
            want_thr, rel=1e-12)
        assert resp["old_threshold"] == pytest.approx(1e-6)
        assert resp["threshold"] == pytest.approx(want_thr, rel=1e-6)
        assert resp["n_windows"] == 64 and resp["persisted"] is False
        assert resp["expected_anomaly_rate"] == pytest.approx(0.1)
        assert resp["score_summary"]["n"] == 64.0

        # the swap is live: /info reports it and decisions follow it
        _, _, body = _req(base + "/info")
        assert json.loads(body)["threshold"] == pytest.approx(want_thr,
                                                              rel=1e-6)
        _, _, body = _req(base + "/score", data=W.tobytes(), headers=hdr,
                          method="POST")
        got = json.loads(body)
        want_anom = (np.asarray(ref["mse"]) > want_thr).tolist()
        assert got["anomalous"] == want_anom
        assert 0 < sum(got["anomalous"]) < 64      # ~10% by construction

        # drift re-baselined to the new calibration rate; only post-
        # recalibration traffic counted
        _, _, body = _req(base + "/metrics",
                          headers={"Accept": "application/json"})
        d = json.loads(body)["drift"]
        assert d["expected_rate"] == pytest.approx(0.1)
        assert d["windows"] == 64

        # guards: sample too small (422), bad percentile (400)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/recalibrate", data=W[:8].tobytes(),
                 headers={"Content-Type": "application/octet-stream",
                          "X-Shape": f"8,{T},{D}", "X-Percentile": "90"},
                 method="POST")
        assert ei.value.code == 422
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/recalibrate", data=W.tobytes(),
                 headers={**hdr, "X-Percentile": "150"}, method="POST")
        assert ei.value.code == 400
    finally:
        srv.shutdown()
        srv.server_close()


def test_recalibrate_refused_without_admin_and_for_baked_thresholds():
    """403 without --admin; 501 when the scorer has no set_threshold (the
    exported-.shmx case: the threshold is baked into the program)."""
    T, D = 20, 4
    srv = make_server(_mini_scorer(T, D, threshold=1.0), port=0, warmup=False)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/recalibrate", data=b"", method="POST")
        assert ei.value.code == 403
    finally:
        srv.shutdown()
        srv.server_close()

    class BakedScorer:                 # ExportedScorer-shaped: no set_threshold
        mean = np.zeros(D, np.float32)
        threshold = np.float32(1.0)
        min_bucket, max_batch, seq_len = 16, 32, T
        num_features = D
        use_fused_vae = False
        mesh = None
        exported = True

        def buckets(self):
            return [16, 32]

        def warmup(self):
            pass

        def warmup_series(self, stride=1, batch_sizes=None):
            pass

    srv2 = make_server(BakedScorer(), port=0, admin=True, warmup=False)
    t = threading.Thread(target=srv2.serve_forever, daemon=True)
    t.start()
    b2 = f"http://127.0.0.1:{srv2.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(b2 + "/recalibrate", data=b"", method="POST")
        assert ei.value.code == 501
    finally:
        srv2.shutdown()
        srv2.server_close()


# ----------------------------------------------------------------------
# the port against the JAX daemon; failures at startup


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def test_same_request_to_jax_and_port_daemons():
    """One /score (octet-stream, npz reply) and one /score_series (JSON) to
    each daemon on carried weights: mse within MSE_ATOL, decisions exact."""
    T, D = 20, 4
    W = np.random.default_rng(21).normal(size=(37, T, D)).astype(np.float32)
    x = np.random.default_rng(22).normal(size=(T + 30, D)).astype(np.float32)
    replies = []
    for make, sc in ((jax_make_server, jax_scorer(threshold=1.0)),
                     (make_server, port_scorer(threshold=1.0))):
        srv = make(sc, port=0, series_strides=(1, 3))
        base = _serve(srv)
        try:
            assert srv.warm_event.wait(timeout=300)
            _, ctype, body = req(base + "/score", data=W.tobytes(), headers=octet(
                W, Accept="application/octet-stream"), method="POST")
            assert ctype == "application/octet-stream"
            z = np.load(io.BytesIO(body))
            _, _, body = req(base + "/score_series", data=json.dumps(
                {"series": x.tolist()}).encode(), headers={
                "Content-Type": "application/json", "X-Stride": "3"},
                method="POST")
            replies.append(({k: z[k] for k in z.files}, json.loads(body)))
        finally:
            srv.shutdown()
            srv.server_close()
    (jw, js), (pw, ps) = replies
    assert_close_outputs(pw, jw)
    assert ps["n"] == js["n"] == 11
    assert_close_outputs({k: np.asarray(v) for k, v in ps.items() if k != "n"},
                         {k: np.asarray(v) for k, v in js.items() if k != "n"})


def test_warmup_failure_on_a_real_scorer_answers_500(monkeypatch):
    """A port scorer whose warmup raises (as a failed kernel build would on
    the card): /healthz and /score answer 500 with the error, and nothing
    is scored on another path."""
    sc = port_scorer()
    calls = []

    def broken(*a, **k):
        raise RuntimeError("nvcc failed for fused_vae.cu")

    monkeypatch.setattr(sc, "warmup", broken)
    monkeypatch.setattr(sc, "score", lambda W: calls.append(W))
    srv = make_server(sc, port=0)
    base = _serve(srv)
    try:
        assert srv.warm_event.wait(timeout=30)
        assert "nvcc failed" in srv.RequestHandlerClass.warm_error
        assert err_code(base + "/healthz") == 500
        W = np.zeros((4, 20, 4), np.float32)
        try:
            req(base + "/score", data=W.tobytes(), headers=octet(W),
                method="POST")
        except urllib.error.HTTPError as e:
            assert e.code == 500
            assert "nvcc failed" in json.loads(e.read())["error"]
        else:
            pytest.fail("/score answered after a failed warmup")
        assert calls == []
    finally:
        srv.shutdown()
        srv.server_close()


def test_body_over_the_limit_gets_413(server):
    base, _, T, D = server
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", "/score")
        conn.putheader("Content-Type", "application/octet-stream")
        conn.putheader("X-Shape", f"1,{T},{D}")
        conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
        conn.endheaders()
        r = conn.getresponse()
        assert r.status == 413 and "error" in json.loads(r.read())
    finally:
        conn.close()


def test_info_names_the_device(server):
    base, _, _, _ = server
    info = json.loads(req(base + "/info")[2])
    assert info["device"] == "cpu" and info["mesh_devices"] is None


def test_no_card_raises_at_startup(monkeypatch):
    """Without --device cpu the daemon serves on the card, and with no card
    it raises at startup instead of serving on the CPU."""
    import torch

    from shm_tpu_torch import serve_http

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_http.main(["--root", "data/4dof", "--port", "0"])


@pytest.mark.parametrize("concurrent", [False, True])
def test_listen_backlog_above_socketserver_default(concurrent):
    """The daemon listens with the system's largest backlog, not
    socketserver's 5: with 5, a sixth client connecting at once is retried
    by its TCP stack only after a second."""
    import socket

    srv = make_server(port_scorer(), port=0, warmup=False,
                      concurrent=concurrent)
    try:
        assert srv.request_queue_size == socket.SOMAXCONN > 5
    finally:
        srv.server_close()
        if srv.batcher is not None:
            srv.batcher.close()
