"""The port's timing and trace hooks (``shm_tpu_torch/utils/profiling.py``)
against the JAX package's ``shm_tpu/utils/profiling.py``, on the CPU:
``throughput`` gives the same dict, ``Timer`` accumulates named spans and
syncs the value set inside a span, ``timed`` prints, and ``trace`` writes a
Chrome trace of ``torch.profiler`` into the directory it is given (or
``$SHM_TPU_TRACE_DIR``) and does nothing without one.
"""

import json
import time

import numpy as np
import pytest
import torch

from shm_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)


@pytest.mark.parametrize("n, seconds, unit", [
    (5440, 0.068, "windows"), (1, 2.5, "steps"), (0, 1.0, "windows"),
    (100, 0.0, "windows"), (7, -1.0, "rows"),
])
def test_throughput_matches_jax(n, seconds, unit):
    from shm_tpu.utils.profiling import throughput as jax_throughput

    assert prof.throughput(n, seconds, unit) == jax_throughput(n, seconds, unit)


def test_timer_accumulates_spans_and_syncs_the_result():
    t = prof.Timer()
    for _ in range(3):
        with t.span("gate") as s:
            s.result = torch.ones(4) * 2
            time.sleep(0.01)
    with t.span("cnn"):
        pass
    rep = t.report()
    assert set(rep) == {"gate", "cnn"}
    assert rep["gate"]["calls"] == 3 and rep["cnn"]["calls"] == 1
    assert rep["gate"]["seconds"] >= 0.03
    assert rep["gate"]["mean_ms"] == pytest.approx(1e3 * rep["gate"]["seconds"] / 3)
    with pytest.raises(RuntimeError):        # a span closes on an exception
        with t.span("gate"):
            raise RuntimeError("boom")
    assert t.counts["gate"] == 4


def test_timer_report_has_the_jax_keys():
    from shm_tpu.utils.profiling import Timer as JaxTimer

    a, b = prof.Timer(), JaxTimer()
    for t in (a, b):
        with t.span("x"):
            pass
    assert a.report().keys() == b.report().keys()
    assert a.report()["x"].keys() == b.report()["x"].keys()


@pytest.mark.parametrize("value", [
    torch.arange(6.0).reshape(2, 3), (torch.zeros(0), torch.ones(2)),
    {"mse": torch.ones(3)}, [np.zeros(2), torch.ones(1)], None, torch.zeros(0),
])
def test_sync_takes_tensors_and_their_containers(value):
    prof.sync(value)


def test_timed_prints_the_span(capsys):
    with prof.timed("gate") as t:
        t.result = torch.ones(3)
    assert capsys.readouterr().out.startswith("[time] gate: ")


def test_trace_writes_a_chrome_trace_into_the_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("SHM_TPU_TRACE_DIR", raising=False)
    with prof.trace(str(tmp_path / "tr")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path is not None and path.parent == tmp_path / "tr"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with prof.trace(str(tmp_path / "tr")) as second:
        pass
    assert second != path and second.is_file()


def test_trace_reads_the_environment_and_is_a_no_op_without_it(tmp_path,
                                                               monkeypatch):
    monkeypatch.delenv("SHM_TPU_TRACE_DIR", raising=False)
    with prof.trace() as path:
        torch.ones(2) + 1
    assert path is None
    monkeypatch.chdir(tmp_path)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("SHM_TPU_TRACE_DIR", str(tmp_path / "env"))
    with prof.trace() as path:
        torch.ones(2) + 1
    assert path.parent == tmp_path / "env" and path.is_file()
