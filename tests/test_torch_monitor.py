"""The port's DriftMonitor against the JAX package's (``shm_tpu/monitor.py``)
on seeded anomaly streams, and the cases of tests/test_monitor.py on the
port.

Both are the same numpy arithmetic, so for one chunking the snapshots must
be equal, not merely close; across chunkings the closed forms agree within
1e-9 relative (sums in other orders), as tests/test_monitor.py holds.
"""

from pathlib import Path

import numpy as np
import pytest

from shm_tpu import monitor as jax_monitor
from shm_tpu_torch.monitor import DriftMonitor, expected_rate_from_threshold_meta
from shm_tpu_torch.utils.io import load_json

ROOT = Path(__file__).resolve().parents[1]
ROOTS = ("data/4dof", "data/4dof_mingru", "data/4dof_attention")


def _stream(seed: int, n: int = 3000, rate: float = 0.02) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = (rng.random(n) < rate).astype(np.float64)
    s[n // 3: n // 3 + 300] = rng.random(300) < 0.3      # a burst
    return s


def _feed(mon, stream, chunk):
    for i in range(0, stream.size, chunk or stream.size):
        mon.update(stream[i:i + (chunk or stream.size)])
    return mon.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("chunk", [None, 7, 1], ids=["whole", "by7", "by1"])
def test_snapshots_equal_jax(seed, chunk):
    """Whole, in chunks of 7 and one window at a time: the port's snapshot
    equals the JAX monitor's for the same chunking."""
    stream = _stream(seed)
    kw = dict(ewma_alpha=0.01, cusum_h=4.0)
    got = _feed(DriftMonitor(0.02, **kw), stream, chunk)
    want = _feed(jax_monitor.DriftMonitor(0.02, **kw), stream, chunk)
    assert got == want
    assert got["alerts_high_total"] >= 1          # the burst is seen


def test_snapshots_chunking_invariant_against_jax_whole():
    stream = _stream(3)
    want = _feed(jax_monitor.DriftMonitor(0.01), stream, None)
    for chunk in (7, 1):
        got = _feed(DriftMonitor(0.01), stream, chunk)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k


@pytest.mark.parametrize("root", ROOTS)
def test_expected_rate_from_committed_manifests(root):
    meta = load_json(ROOT / root / "processed" / "vae_threshold.json")
    got = expected_rate_from_threshold_meta(meta)
    assert got == jax_monitor.expected_rate_from_threshold_meta(meta)
    assert got == pytest.approx(0.01)


# ----------------------------------------------------------------------
# the cases of tests/test_monitor.py, on the port


def _loop_reference(stream, p0, a, k, h):
    ewma, s_hi, s_lo, n_hi, n_lo = p0, 0.0, 0.0, 0, 0
    for x in stream:
        ewma = (1 - a) * ewma + a * x
        prev_hi, prev_lo = s_hi, s_lo
        s_hi = max(0.0, s_hi + (x - (p0 + k)))
        s_lo = max(0.0, s_lo + ((p0 - k) - x))
        n_hi += (s_hi > h) and (prev_hi <= h)
        n_lo += (s_lo > h) and (prev_lo <= h)
    return ewma, s_hi, s_lo, n_hi, n_lo


def test_batched_update_matches_per_window_loop():
    rng = np.random.default_rng(0)
    stream = (rng.random(5000) < 0.05).astype(np.float64)
    stream[2000:2400] = 1.0
    p0, a, k, h = 0.05, 0.01, 0.025, 4.0
    mon = DriftMonitor(p0, ewma_alpha=a, cusum_k=k, cusum_h=h)
    mon.update(stream)
    ewma, s_hi, s_lo, n_hi, n_lo = _loop_reference(stream, p0, a, k, h)
    s = mon.snapshot()
    assert s["ewma_rate"] == pytest.approx(ewma, rel=1e-9)
    assert s["cusum_high"] == pytest.approx(s_hi, abs=1e-9)
    assert s["cusum_low"] == pytest.approx(s_lo, abs=1e-9)
    assert s["alerts_high_total"] == n_hi and s["alerts_low_total"] == n_lo


def test_healthy_stream_stays_quiet():
    rng = np.random.default_rng(2)
    mon = DriftMonitor(0.01)
    for _ in range(20):
        mon.update(rng.random(1000) < 0.01)
    s = mon.snapshot()
    assert s["alerts_high_total"] == 0 and s["alerts_low_total"] == 0
    assert 0.0 <= s["ewma_rate"] <= 0.05


def test_sustained_doubling_alerts_high():
    rng = np.random.default_rng(3)
    mon = DriftMonitor(0.01)
    mon.update(rng.random(2000) < 0.01)
    assert not mon.snapshot()["alert_high"]
    fired_at = None
    for i in range(8):
        s = mon.update(rng.random(1000) < 0.02)
        if s["alert_high"] and fired_at is None:
            fired_at = (i + 1) * 1000
    assert fired_at is not None and fired_at <= 6000
    assert mon.snapshot()["alerts_low_total"] == 0


def test_gate_dropout_alerts_low():
    rng = np.random.default_rng(4)
    mon = DriftMonitor(0.05)
    mon.update(rng.random(1000) < 0.05)
    mon.update(np.zeros(2000))
    s = mon.snapshot()
    assert s["alert_low"] and s["alerts_low_total"] >= 1
    assert s["alerts_high_total"] == 0


def test_reset_restores_baseline():
    mon = DriftMonitor(0.01)
    mon.update(np.ones(500))
    assert mon.snapshot()["alert_high"]
    mon.reset()
    s = mon.snapshot()
    assert s["windows"] == 0 and s["cusum_high"] == 0.0
    assert s["ewma_rate"] == 0.01 and not s["alert_high"]


@pytest.mark.parametrize("kwargs", [
    dict(expected_rate=0.0), dict(expected_rate=1.0),
    dict(expected_rate=0.01, ewma_alpha=0.0),
    dict(expected_rate=0.01, ewma_alpha=1.0),
    dict(expected_rate=0.01, cusum_k=-0.1),
    dict(expected_rate=0.01, cusum_h=0.0),
])
def test_invalid_configs_raise(kwargs):
    with pytest.raises(ValueError):
        DriftMonitor(**kwargs)


def test_update_rejects_non_binary():
    mon = DriftMonitor(0.01)
    with pytest.raises(ValueError):
        mon.update(np.array([0.0, 2.0]))
    mon.update(np.zeros((0,)))
    assert mon.snapshot()["windows"] == 0


def test_expected_rate_from_threshold_meta():
    assert expected_rate_from_threshold_meta(
        {"percentile": 95.0, "normal_fpr_at_threshold": 0.0508}
    ) == pytest.approx(0.0508)
    assert expected_rate_from_threshold_meta(
        {"percentile": 99.0}) == pytest.approx(0.01)
    assert expected_rate_from_threshold_meta(
        {"percentile": 95.0, "normal_fpr_at_threshold": 0.0}
    ) == pytest.approx(0.05)
    assert expected_rate_from_threshold_meta({"threshold": 1.0}) is None
