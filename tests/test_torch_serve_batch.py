"""The port's DynamicBatcher (``shm_tpu_torch/serve_batch.py``): the contracts
of tests/test_serve_batch.py, and the port's batched outputs against the
JAX package's batcher on the same weights and requests.

The batcher composes on top of ``HybridScorer.score``, so each request's
outputs must be exactly those of scoring it alone (the scorer is per-window
deterministic and pads and trims per bucket). Against the JAX batcher: mse
within ``MSE_ATOL``, p_struct within ``P_ATOL``, decisions exact
(torch_serve_models.py).
"""

import threading
import time

import numpy as np
import pytest

from shm_tpu.serve_batch import DynamicBatcher as JaxDynamicBatcher
from shm_tpu_torch.serve_batch import DynamicBatcher
from torch_serve_models import (
    KEYS, D, T, assert_close_outputs, jax_scorer, port_scorer,
)


class FakeScorer:
    """Numpy stand-in with the scorer surface the batcher uses; per-window
    deterministic like the real pipeline, plus a dispatch counter."""

    def __init__(self, T=10, D=3, max_batch=64):
        self.mean = np.zeros(D, np.float32)
        self.num_features = D
        self.seq_len = T
        self.max_batch = max_batch
        self.calls = 0
        self.call_sizes = []

    def score(self, W):
        W = np.asarray(W, np.float32)
        self.calls += 1
        self.call_sizes.append(W.shape[0])
        mse = W.mean(axis=(1, 2))
        return {
            "mse": mse,
            "anomalous": (mse > 0).astype(np.float32),
            "y_pred": np.arange(len(mse), dtype=np.float32),
            "p_struct": mse * 2,
        }


def _windows(n, T=10, D=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, T, D)).astype(np.float32)


def test_single_request_matches_direct():
    sc = FakeScorer()
    b = DynamicBatcher(sc, max_delay_ms=1.0)
    try:
        W = _windows(5)
        got = b.score(W)
        ref = FakeScorer().score(W)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    finally:
        b.close()


def test_concurrent_requests_coalesce_and_split_correctly():
    """Requests arriving within the window must share device dispatches, and
    each caller must get exactly its own slice."""
    sc = FakeScorer()
    b = DynamicBatcher(sc, max_delay_ms=200.0)     # wide window: force coalesce
    results, errs = {}, {}
    barrier = threading.Barrier(8)                 # simultaneous arrival: the
    try:                                           # coalescing must not depend
        def call(i):                               # on thread-start skew
            try:
                barrier.wait(timeout=30)
                results[i] = b.score(_windows(4, seed=i))
            except Exception as e:                 # surface the cause, not a
                errs[i] = repr(e)                  # bare count-mismatch assert

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
        assert len(results) == 8
        # per-request correctness: mse is per-window mean, independent of
        # co-travelers
        for i, out in results.items():
            np.testing.assert_allclose(
                out["mse"], _windows(4, seed=i).mean(axis=(1, 2)), rtol=1e-6)
            assert out["mse"].shape == (4,)
        # 8 requests, 200 ms window, 32 < max_batch windows: must coalesce
        # into FEWER dispatches than requests
        assert sc.calls < 8, f"no coalescing happened ({sc.calls} dispatches)"
    finally:
        b.close()


def test_validation_fails_alone_on_request_thread():
    """A malformed request must raise to ITS caller without entering a
    batch (where it would take co-traveling requests down)."""
    sc = FakeScorer(T=10, D=3)
    b = DynamicBatcher(sc, max_delay_ms=1.0)
    try:
        with pytest.raises(ValueError, match="D=3"):
            b.score(_windows(4, D=5))
        with pytest.raises(ValueError, match="T=10"):
            b.score(_windows(4, T=7))
        with pytest.raises(ValueError, match="rank-3"):
            b.score(np.zeros((4, 10), np.float32))
        assert sc.calls == 0
        # a good request still works afterwards
        assert b.score(_windows(2))["mse"].shape == (2,)
    finally:
        b.close()


def test_empty_request_shortcuts():
    sc = FakeScorer()
    b = DynamicBatcher(sc, max_delay_ms=1.0)
    try:
        out = b.score(np.zeros((0, 10, 3), np.float32))
        assert all(v.shape == (0,) for v in out.values())
        assert sc.calls == 0
    finally:
        b.close()


def test_scoring_failure_fans_out_to_all_requests():
    class BrokenScorer(FakeScorer):
        def score(self, W):
            raise RuntimeError("device fell over")

    b = DynamicBatcher(BrokenScorer(), max_delay_ms=50.0)
    errs = {}
    try:
        def call(i):
            try:
                b.score(_windows(2, seed=i))
            except RuntimeError as e:
                errs[i] = str(e)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert len(errs) == 3 and all("device fell over" in v
                                      for v in errs.values())
    finally:
        b.close()


def test_close_rejects_new_requests():
    sc = FakeScorer()
    b = DynamicBatcher(sc, max_delay_ms=1.0)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.score(_windows(2))


def test_close_race_never_strands_a_request():
    """A request racing close() must either complete or get the 'closed'
    RuntimeError — never block forever (regression: a check-then-enqueue
    race could land a request BEHIND the close sentinel, whose Future was
    then never resolved)."""
    sc = FakeScorer()
    b = DynamicBatcher(sc, max_delay_ms=0.0)   # tightest dispatch loop
    done = []
    errs = []

    def client(i):
        W = _windows(1, seed=i)
        try:
            while True:                        # hammer until close lands
                out = b.score(W)
                assert out["mse"].shape == (1,)
        except RuntimeError as e:
            assert "closed" in str(e)
            done.append(i)
        except Exception as e:                  # pragma: no cover - diagnosis
            errs.append(e)

    # daemon=True: if the race ever regresses, the blocked thread must fail
    # the is_alive assert below — not hang the interpreter at suite exit
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.05)                           # let the hammering overlap
    b.close()
    for t in threads:
        t.join(timeout=10.0)
    assert not errs
    assert not any(t.is_alive() for t in threads), \
        "a request thread is still blocked on its Future after close()"
    assert len(done) == 8


def test_real_scorer_equivalence():
    """Batched outputs equal the port's HybridScorer.score exactly."""
    scorer = port_scorer(min_bucket=16, max_batch=32)
    b = DynamicBatcher(scorer, max_delay_ms=1.0)
    try:
        W = _windows(9, T=T, D=D)
        got, ref = b.score(W), scorer.score(W)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
    finally:
        b.close()


def _concurrent(batcher, reqs):
    """Score every request from its own thread, all released at once."""
    results, errs = {}, {}
    barrier = threading.Barrier(len(reqs))

    def call(i):
        try:
            barrier.wait(timeout=30)
            results[i] = batcher.score(reqs[i])
        except Exception as e:
            errs[i] = repr(e)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    return results


def test_coalesced_requests_match_jax_batcher():
    """Six concurrent requests through each package's batcher on the same
    weights: every request's outputs agree, and each equals the port's
    scorer on that request alone, bit for bit."""
    reqs = [_windows(5 + i, T=T, D=D, seed=i) for i in range(6)]
    scorer = port_scorer(min_bucket=16, max_batch=64)
    port = DynamicBatcher(scorer, max_delay_ms=200.0)
    jax_ = JaxDynamicBatcher(jax_scorer(min_bucket=16, max_batch=64),
                             max_delay_ms=200.0)
    try:
        got, want = _concurrent(port, reqs), _concurrent(jax_, reqs)
    finally:
        port.close()
        jax_.close()
    for i, W in enumerate(reqs):
        assert_close_outputs(got[i], want[i])
        alone = scorer.score(W)
        for k in KEYS:
            np.testing.assert_array_equal(got[i][k], alone[k], err_msg=k)


def test_http_concurrent_mode_end_to_end():
    """make_server(concurrent=True): parallel POSTs all succeed and match
    direct scoring; the batcher coalesces across connections."""
    import json
    import urllib.request

    from shm_tpu_torch.serve_http import make_server

    sc = FakeScorer(T=10, D=3, max_batch=64)
    sc.buckets = lambda: [16, 32]
    sc.warmup = lambda: None
    sc.warmup_series = lambda stride=1, batch_sizes=None: None
    sc.min_bucket, sc.mesh = 16, None
    sc.use_fused_vae = False
    sc.threshold = np.float32(1.0)
    srv = make_server(sc, port=0, concurrent=True, batch_window_ms=100.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    assert srv.warm_event.wait(timeout=60)
    results, errs = {}, {}
    barrier = threading.Barrier(6)
    try:
        def post(i):
            try:
                W = _windows(4, seed=i)
                r = urllib.request.Request(
                    base + "/score", data=W.tobytes(),
                    headers={"Content-Type": "application/octet-stream",
                             "X-Shape": "4,10,3"}, method="POST")
                barrier.wait(timeout=30)
                with urllib.request.urlopen(r, timeout=60) as resp:
                    results[i] = json.loads(resp.read())
            except Exception as e:
                errs[i] = repr(e)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=90)
        assert not errs, errs
        assert len(results) == 6
        for i, out in results.items():
            np.testing.assert_allclose(
                out["mse"], _windows(4, seed=i).mean(axis=(1, 2)), rtol=1e-5)
        assert sc.calls < 6, f"no cross-connection coalescing ({sc.calls})"
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
