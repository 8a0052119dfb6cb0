"""The port's shadow (canary) scoring (``shm_tpu_torch/serve_shadow.py``):
the contracts of tests/test_serve_shadow.py, over the port's HTTP daemon
where they need one, and the agreement counters against the JAX
package's ShadowEngine on the same weights and requests (counts exact;
the shadow's mse against the primary's within ``MSE_ATOL``).
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from shm_tpu.serve_shadow import ShadowEngine as JaxShadowEngine
from shm_tpu_torch.serve_shadow import ShadowEngine, check_compatible
from torch_serve_models import MSE_ATOL, jax_scorer, port_scorer


class FakeScorer:
    """Deterministic scorer stub: mse = per-window mean + offset; gate at
    ``thr``; anomalous windows predict Structural (2), rest Normal (0)."""

    request_rank = 3
    mesh = None

    def __init__(self, thr=0.5, offset=0.0, seq_len=20, num_features=4,
                 fail=False):
        self.thr, self.offset = float(thr), float(offset)
        self.seq_len, self.num_features = seq_len, num_features
        self.fail = fail
        self.warmed = False
        self.warmed_strides = []

    def score(self, W):
        if self.fail:
            raise RuntimeError("shadow compute exploded")
        W = np.asarray(W, np.float32)
        mse = W.reshape(W.shape[0], -1).mean(axis=1) + self.offset
        anomalous = mse > self.thr
        return {"mse": mse.astype(np.float32),
                "anomalous": anomalous,
                "y_pred": np.where(anomalous, 2, 0).astype(np.int32),
                "p_struct": anomalous.astype(np.float32)}

    def score_series(self, x, stride=1):
        x = np.asarray(x, np.float32)
        T = self.seq_len
        n = (x.shape[0] - T) // stride + 1
        W = np.stack([x[i * stride:i * stride + T] for i in range(n)])
        return self.score(W)

    def warmup(self):
        self.warmed = True

    def warmup_series(self, stride=1, batch_sizes=None):
        self.warmed_strides.append(stride)


def _req(url, data=None, headers=None, method=None):
    r = urllib.request.Request(url, data=data, headers=headers or {},
                               method=method)
    with urllib.request.urlopen(r, timeout=30) as resp:
        return resp.status, resp.read()


def _wait(pred, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _drained(eng):
    return lambda: eng.snapshot()["pending_windows"] == 0


def test_check_compatible():
    p = FakeScorer()
    check_compatible(p, FakeScorer())                     # same surface: ok
    with pytest.raises(ValueError, match="seq_len"):
        check_compatible(p, FakeScorer(seq_len=21))
    with pytest.raises(ValueError, match="num_features"):
        check_compatible(p, FakeScorer(num_features=5))
    bad = FakeScorer()
    bad.request_rank = 4
    with pytest.raises(ValueError, match="rank"):
        check_compatible(p, bad)


def test_agreement_accounting_exact():
    """Gate/pred agreement, anomaly counts, and mse |diff| must match a
    hand computation on a known disagreement pattern."""
    rng = np.random.default_rng(0)
    W = rng.normal(size=(32, 20, 4)).astype(np.float32)
    primary = FakeScorer(thr=0.0)
    # constant mse offset: flips the gate exactly where the window mean sits
    # in (-0.125, 0], and |mse diff| is 0.125 on every window
    shadow = FakeScorer(thr=0.0, offset=0.125)
    eng = ShadowEngine(shadow)
    try:
        eng.warm()
        p_out = primary.score(W)
        s_out = shadow.score(W)
        assert eng.submit_windows(W, p_out)
        _wait(lambda: eng.snapshot()["windows"] == 32, msg="shadow drain")
        snap = eng.snapshot()
        agree = int((s_out["anomalous"] == p_out["anomalous"]).sum())
        assert snap["gate_agree"] == agree
        assert snap["pred_agree"] == int(
            (s_out["y_pred"] == p_out["y_pred"]).sum())
        assert snap["gate_agreement"] == pytest.approx(agree / 32)
        assert snap["shadow_anomalous"] == int(s_out["anomalous"].sum())
        assert snap["mse_absdiff_max"] == pytest.approx(0.125, rel=1e-5)
        assert snap["mse_absdiff_mean"] == pytest.approx(0.125, rel=1e-5)
        assert snap["requests_scored"] == 1 and snap["errors"] == 0
        assert snap["shadow_pred_class_counts"]["Structural Fault"] == int(
            (s_out["y_pred"] == 2).sum())
        # series submissions ride the same accounting
        x = rng.normal(size=(20 + 5, 4)).astype(np.float32)
        p_series = primary.score_series(x, stride=1)
        assert eng.submit_series(x, 1, p_series)
        _wait(lambda: eng.snapshot()["windows"] == 32 + 6, msg="series drain")
        eng.reset()
        assert eng.snapshot()["windows"] == 0
    finally:
        eng.close()


def test_backpressure_drops_instead_of_blocking():
    """An unwarmed (still-compiling) shadow must DROP past the window bound
    — live traffic never blocks on the candidate — then drain what it
    admitted once warm."""
    shadow = FakeScorer()
    eng = ShadowEngine(shadow, max_pending_windows=10)
    try:
        W = np.zeros((6, 20, 4), np.float32)
        out = shadow.score(W)
        assert eng.submit_windows(W, out)          # pending 6
        assert not eng.submit_windows(W, out)      # 12 > 10: dropped
        snap = eng.snapshot()
        assert snap["dropped_requests"] == 1
        assert snap["dropped_windows"] == 6
        assert snap["pending_windows"] == 6
        assert snap["windows"] == 0                # nothing scored yet
        eng.mark_warmed()
        _wait(lambda: eng.snapshot()["windows"] == 6, msg="post-warm drain")
    finally:
        eng.close()


def test_shadow_errors_counted_and_engine_keeps_draining():
    shadow = FakeScorer(fail=True)
    eng = ShadowEngine(shadow)
    try:
        eng.mark_warmed()
        W = np.zeros((4, 20, 4), np.float32)
        out = FakeScorer().score(W)
        eng.submit_windows(W, out)
        _wait(lambda: eng.snapshot()["errors"] == 1, msg="error accounting")
        snap = eng.snapshot()
        assert "exploded" in snap["last_error"]
        assert snap["pending_windows"] == 0 and snap["windows"] == 0
        shadow.fail = False                        # recovers per-item
        eng.submit_windows(W, out)
        _wait(lambda: eng.snapshot()["windows"] == 4, msg="recovery")
    finally:
        eng.close()


def test_warm_failure_recorded_never_raises():
    class BrokenWarm(FakeScorer):
        def warmup(self):
            raise RuntimeError("compile exploded")

    eng = ShadowEngine(BrokenWarm())
    try:
        eng.warm()                                 # must not raise
        snap = eng.snapshot()
        assert snap["warmed"] and "compile exploded" in snap["warm_error"]
    finally:
        eng.close()


def test_warm_compiles_series_strides():
    shadow = FakeScorer()
    eng = ShadowEngine(shadow, series_strides=(1, 2))
    try:
        eng.warm()
        assert shadow.warmed and sorted(shadow.warmed_strides) == [1, 2]
    finally:
        eng.close()


def test_close_rejects_new_work():
    eng = ShadowEngine(FakeScorer())
    eng.mark_warmed()
    eng.close()
    W = np.zeros((2, 20, 4), np.float32)
    assert not eng.submit_windows(W, FakeScorer().score(W))


# ----------------------------------------------------------------------
# HTTP integration: the daemon's --shadow surface


def _mini_scorer(T, D, threshold, rate=None):
    """The port's tiny scorer on the CPU (torch_serve_models.py)."""
    return port_scorer(threshold=threshold, rate=rate, seq_len=T)


@pytest.fixture(scope="module")
def shadow_server():
    """Primary gates everything (thr ~0), shadow gates nothing (thr huge) —
    maximal, exactly-predictable disagreement."""
    from shm_tpu_torch.serve_http import make_server

    T, D = 20, 4
    primary = _mini_scorer(T, D, threshold=1e-6)
    new_primaries = [_mini_scorer(T, D, threshold=1e-6)]
    shadow = _mini_scorer(T, D, threshold=1e9)
    srv = make_server(primary, port=0, admin=True,
                      reload_fn=lambda: new_primaries.pop(),
                      series_strides=(1,), shadow_scorer=shadow)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    assert srv.warm_event.wait(timeout=300)
    yield base, srv, primary, shadow, T, D
    srv.shutdown()
    srv.server_close()
    srv.shadow.close()


def test_http_shadow_compares_score_traffic(shadow_server):
    base, srv, primary, shadow, T, D = shadow_server
    W = np.random.default_rng(5).normal(size=(8, T, D)).astype(np.float32)
    code, body = _req(base + "/score", data=W.tobytes(),
                      headers={"Content-Type": "application/octet-stream",
                               "X-Shape": f"8,{T},{D}"}, method="POST")
    assert code == 200
    got = json.loads(body)
    assert all(got["anomalous"])                   # primary thr ~0
    _wait(lambda: srv.shadow.snapshot()["windows"] >= 8,
          msg="shadow HTTP drain")
    _wait(_drained(srv.shadow), msg="shadow queue drain")
    snap = srv.shadow.snapshot()
    n0 = snap["windows"]
    assert snap["gate_agree"] == 0                 # shadow thr huge
    assert snap["pred_agree"] == 0                 # 0 vs argmax+1
    assert snap["shadow_anomalous"] == 0
    # same params, same mse — only the threshold differs
    assert snap["mse_absdiff_max"] == pytest.approx(0.0, abs=1e-6)

    # series traffic rides the same comparison
    x = np.random.default_rng(6).normal(size=(T + 3, D)).astype(np.float32)
    code, body = _req(base + "/score_series", data=x.tobytes(),
                      headers={"Content-Type": "application/octet-stream",
                               "X-Shape": f"{T + 3},{D}"}, method="POST")
    assert code == 200 and json.loads(body)["n"] == 4
    _wait(lambda: srv.shadow.snapshot()["windows"] == n0 + 4,
          msg="series shadow drain")

    # surfaced on /info, /metrics (JSON + Prometheus)
    _, body = _req(base + "/info")
    assert json.loads(body)["shadow"]["windows"] == n0 + 4
    _, body = _req(base + "/metrics",
                   headers={"Accept": "application/json"})
    m = json.loads(body)["shadow"]
    assert m["windows"] == n0 + 4 and m["gate_agreement"] == 0.0
    _, body = _req(base + "/metrics")
    text = body.decode()
    assert f"shm_shadow_windows_total {n0 + 4}" in text
    assert "shm_shadow_gate_agree_total 0" in text
    assert "shm_shadow_warmed 1" in text

    # admin reset zeroes the comparison
    code, body = _req(base + "/shadow/reset", data=b"", method="POST")
    assert code == 200 and json.loads(body)["windows"] == 0


def test_http_reload_resets_shadow_comparison(shadow_server):
    base, srv, primary, shadow, T, D = shadow_server
    W = np.random.default_rng(7).normal(size=(4, T, D)).astype(np.float32)
    _req(base + "/score", data=W.tobytes(),
         headers={"Content-Type": "application/octet-stream",
                  "X-Shape": f"4,{T},{D}"}, method="POST")
    # wait on compared WINDOWS, not on queue drain: the handler enqueues the
    # shadow comparison AFTER writing the response (the client never waits),
    # so right after _req returns the queue can still be empty-because-
    # not-yet-submitted — a drained check races (observed flaky under suite
    # load, round 3)
    _wait(lambda: srv.shadow.snapshot()["windows"] >= 4,
          msg="pre-reload shadow compare")
    code, _ = _req(base + "/reload", data=b"", method="POST")
    assert code == 202
    for _ in range(200):
        _, body = _req(base + "/reload")
        if json.loads(body)["state"] == "done":
            break
        time.sleep(0.05)
    else:
        raise AssertionError("reload never finished")
    assert srv.shadow.snapshot()["windows"] == 0   # fresh comparison


def test_make_server_rejects_incompatible_shadow():
    from shm_tpu_torch.serve_http import make_server

    primary = _mini_scorer(20, 4, threshold=1.0)
    mismatched = _mini_scorer(24, 4, threshold=1.0)
    with pytest.raises(ValueError, match="seq_len"):
        make_server(primary, port=0, shadow_scorer=mismatched)


def test_shadow_reset_409_without_shadow():
    from shm_tpu_torch.serve_http import make_server

    srv = make_server(_mini_scorer(20, 4, threshold=1.0), port=0, admin=True,
                      warmup=False)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/shadow/reset", data=b"", method="POST")
        assert ei.value.code == 409
    finally:
        srv.shutdown()
        srv.server_close()


def test_shadow_reset_403_without_admin():
    from shm_tpu_torch.serve_http import make_server

    primary = _mini_scorer(20, 4, threshold=1.0)
    srv = make_server(primary, port=0, warmup=False,
                      shadow_scorer=_mini_scorer(20, 4, threshold=2.0))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _req(base + "/shadow/reset", data=b"", method="POST")
        assert ei.value.code == 403
    finally:
        srv.shutdown()
        srv.server_close()
        srv.shadow.close()


def test_agreement_counters_equal_jax_engine():
    """Primary and candidate differ only in their thresholds (the candidate
    gates ~half the windows), through both packages' engines on the same
    carried weights and requests: every counter equal."""
    rng = np.random.default_rng(12)
    reqs = [rng.normal(size=(n, 20, 4)).astype(np.float32)
            for n in (8, 33, 3)]
    series = rng.normal(size=(45, 4)).astype(np.float32)
    counters = ("windows", "gate_agree", "pred_agree", "shadow_anomalous",
                "shadow_pred_class_counts", "requests_scored",
                "dropped_windows", "errors")
    snaps = []
    for make in (jax_scorer, port_scorer):
        primary, cand = make(threshold=1e-6), make(threshold=1.0)
        eng = (JaxShadowEngine if make is jax_scorer else ShadowEngine)(
            cand, series_strides=(2,))
        try:
            eng.warm()
            for W in reqs:
                assert eng.submit_windows(W, primary.score(W))
            assert eng.submit_series(series, 2,
                                     primary.score_series(series, stride=2))
            _wait(lambda: eng.snapshot()["requests_scored"] == 4,
                  msg="shadow drain")
            snaps.append(eng.snapshot())
        finally:
            eng.close()
    want, got = snaps
    assert {k: got[k] for k in counters} == {k: want[k] for k in counters}
    assert 0 < got["gate_agree"] < got["windows"] == 8 + 33 + 3 + 13
    assert abs(got["mse_absdiff_max"] - want["mse_absdiff_max"]) <= MSE_ATOL
