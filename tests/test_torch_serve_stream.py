"""The port's StreamScorer, warmup_series and the scorer's manifest fields,
against the JAX package's ``shm_tpu/serve.py`` (tests/test_serve.py's
contracts).

Streaming in chunks rides other buckets than scoring the whole series. On
the CPU the plain path sums in float32 with batch-dependent blocking, so the
port's stream is held to its own ``score_series`` within 1e-6 absolute on
mse and p_struct (tests/test_serve.py's bound), decisions exact; against the
JAX stream on the same weights within ``MSE_ATOL`` / ``P_ATOL``
(torch_serve_models.py), decisions, window_start and drift snapshots exact.
"""

import warnings
from pathlib import Path

import numpy as np
import pytest

from shm_tpu.monitor import DriftMonitor as JaxDriftMonitor
from shm_tpu.serve import HybridScorer as JaxHybridScorer
from shm_tpu.serve import StreamScorer as JaxStreamScorer
from shm_tpu_torch.monitor import DriftMonitor
from shm_tpu_torch.serve import HybridScorer, StreamScorer
from torch_serve_models import (
    KEYS, D, T, assert_close_outputs, jax_scorer, port_scorer,
)

ROOT = Path(__file__).resolve().parents[1]
CHUNKINGS = [
    (1, (7, 1, 30, 4, 58)),        # ragged chunking, total 100 samples
    (3, (25, 25, 25, 25)),
    # stride > seq_len: a chunk boundary can land inside a gap whose samples
    # have not arrived yet
    (30, (21, 25, 40, 14)),
    (23, (20, 3, 77)),
]


def _series(n: int, seed: int = 7) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _stream(stream, x, chunks):
    outs, i = [], 0
    for c in chunks:
        outs.append(stream.push(x[i:i + c]))
        i += c
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


@pytest.fixture(scope="module")
def scorer():
    return port_scorer(min_bucket=16, max_batch=64)


@pytest.mark.parametrize("stride,chunks", CHUNKINGS)
def test_stream_scorer_matches_score_series(scorer, stride, chunks):
    x = _series(sum(chunks))
    ref = scorer.score_series(x, stride=stride)
    stream = StreamScorer(scorer, stride=stride)
    got = _stream(stream, x, chunks)
    n_ref = len(ref["mse"])
    assert len(got["mse"]) == n_ref
    np.testing.assert_array_equal(got["window_start"], stride * np.arange(n_ref))
    assert_close_outputs(got, ref, mse_atol=1e-6, p_atol=1e-6)
    assert stream.buffered_samples < T
    assert stream.window_start == stride * n_ref


@pytest.mark.parametrize("stride,chunks", CHUNKINGS)
def test_stream_matches_jax_stream(scorer, stride, chunks):
    """The same series, chunking and weights through the JAX StreamScorer:
    outputs, window_start and the drift monitor's snapshot."""
    x = _series(sum(chunks), seed=11)
    js = jax_scorer(min_bucket=16, max_batch=64)
    js.expected_anomaly_rate = 0.2
    scorer.expected_anomaly_rate = 0.2
    try:
        port, jax_ = StreamScorer(scorer, stride=stride), JaxStreamScorer(
            js, stride=stride)
        got, want = _stream(port, x, chunks), _stream(jax_, x, chunks)
    finally:
        scorer.expected_anomaly_rate = None
    assert_close_outputs(got, want)
    np.testing.assert_array_equal(got["window_start"], want["window_start"])
    assert port.monitor.snapshot() == jax_.monitor.snapshot()
    assert port.buffered_samples == jax_.buffered_samples


def test_stream_scorer_edges(scorer):
    stream = StreamScorer(scorer, stride=2)
    out = stream.push(np.zeros((T - 1, D), np.float32))
    assert out["mse"].shape == (0,) and out["window_start"].shape == (0,)
    assert stream.buffered_samples == T - 1
    out = stream.push(np.zeros((0, D), np.float32))
    assert out["mse"].shape == (0,)
    out = stream.push(np.zeros((1, D), np.float32))
    assert out["mse"].shape == (1,)
    np.testing.assert_array_equal(out["window_start"], [0])
    with pytest.raises(ValueError, match="samples"):
        stream.push(np.zeros((5, D - 1), np.float32))
    with pytest.raises(ValueError, match="stride"):
        StreamScorer(scorer, stride=0)
    with pytest.raises(ValueError, match="seq_len"):
        StreamScorer(port_scorer(seq_len=None))
    stream.reset()
    assert stream.buffered_samples == 0 and stream.window_start == 0
    out = stream.push(np.zeros((T, D), np.float32))
    np.testing.assert_array_equal(out["window_start"], [0])


def test_stream_scorer_drift_monitor(scorer):
    """monitor='auto' attaches a DriftMonitor only with a calibrated rate;
    push() folds decisions in stream order, equal to the whole decision
    stream at once; reset() keeps drift history."""
    assert StreamScorer(scorer).monitor is None
    scorer.expected_anomaly_rate = 0.01
    try:
        stream = StreamScorer(scorer, stride=3)
    finally:
        scorer.expected_anomaly_rate = None
    assert isinstance(stream.monitor, DriftMonitor)
    x = _series(400, seed=9)
    decisions = [stream.push(x[lo:lo + 90])["anomalous"]
                 for lo in range(0, 400, 90)]
    whole = JaxDriftMonitor(0.01)
    whole.update(np.concatenate(decisions))
    got, ref = stream.monitor.snapshot(), whole.snapshot()
    for k in ("windows", "anomalous", "ewma_rate", "cusum_high",
              "cusum_low", "alerts_high_total", "alerts_low_total"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k
    before = stream.monitor.snapshot()
    stream.reset()
    assert stream.monitor.snapshot() == before
    shared = DriftMonitor(0.2)
    assert StreamScorer(scorer, monitor=shared).monitor is shared
    assert StreamScorer(scorer, monitor=None).monitor is None
    with pytest.raises(ValueError, match="monitor"):
        StreamScorer(scorer, monitor="yes")


def test_from_artifacts_manifest_fields():
    """``from_artifacts("data/4dof", device="cpu")`` reads the JAX scorer's
    calibrated rate and percentile from the threshold manifest."""
    port = HybridScorer.from_artifacts(ROOT / "data" / "4dof", device="cpu")
    jax_ = JaxHybridScorer.from_artifacts(ROOT / "data" / "4dof",
                                          use_fused_vae=False)
    assert port.expected_anomaly_rate == jax_.expected_anomaly_rate
    assert port.calibration_percentile == jax_.calibration_percentile == 99.0
    assert port.expected_anomaly_rate == pytest.approx(0.01)
    assert port.mesh is None and jax_.mesh is None
    assert HybridScorer.expected_anomaly_rate is None    # hand-built default


def test_warmup_series_runs_each_bucket(scorer, monkeypatch):
    """warmup_series runs score_series once per bucket at that stride, each
    a zero series of exactly the bucket's windows."""
    seen = []
    real = scorer.score_series

    def spy(x, stride=1):
        out = real(x, stride=stride)
        seen.append((len(out["mse"]), stride))
        return out

    monkeypatch.setattr(scorer, "score_series", spy)
    scorer.warmup_series(stride=3)
    assert seen == [(b, 3) for b in scorer.buckets()]
    seen.clear()
    scorer.warmup_series(stride=2, batch_sizes=[16])
    assert seen == [(16, 2)]
    with pytest.raises(ValueError, match="seq_len"):
        port_scorer(seq_len=None).warmup_series()


def test_warmup_num_features(scorer, monkeypatch):
    shapes = []
    real = scorer._dispatch
    monkeypatch.setattr(scorer, "_dispatch",
                        lambda Wb: shapes.append(tuple(Wb.shape)) or real(Wb))
    scorer.warmup(batch_sizes=[16], num_features=D)
    assert shapes == [(16, T, D)]


def test_read_only_request_buffer(scorer):
    """A request array on a read-only buffer (np.frombuffer of a body) is
    scored without a warning and gives the writable array's outputs."""
    W = np.random.default_rng(3).normal(size=(5, T, D)).astype(np.float32)
    ro = np.frombuffer(W.tobytes(), dtype="<f4").reshape(W.shape)
    x = np.frombuffer(W[0].tobytes(), dtype="<f4").reshape(T, D)
    assert not ro.flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got, series = scorer.score(ro), scorer.score_series(x)
    want = scorer.score(W)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k])
    assert len(series["mse"]) == 1
