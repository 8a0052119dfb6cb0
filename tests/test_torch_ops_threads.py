"""The kernel loader and the launch counters under several host threads.

The HTTP daemon launches kernels from its request threads, its batcher's
dispatcher and its shadow worker at once, so the first use of a library
from two threads must build and load it once, and no launch may be lost
from a counter. ``build`` is replaced here, so nothing compiles.
"""

import threading
import time
from pathlib import Path

import pytest

from shm_tpu_torch.ops import _build, fused_attention_gate, fused_mingru_gate
from shm_tpu_torch.ops import fused_vae_gate
from shm_tpu_torch.ops._build import count_launch, load_library

THREADS = 16


def _together(fn, n=THREADS):
    """Run ``fn(i)`` on ``n`` threads released at once; their results."""
    out, errs = [None] * n, []
    barrier = threading.Barrier(n)

    def run(i):
        try:
            barrier.wait(timeout=30)
            out[i] = fn(i)
        except BaseException as e:                  # noqa: BLE001 - reported
            errs.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    return out


class _FakeLib:
    def __init__(self, path):
        self.path = path
        self.shm_cuda_error_string = lambda err: b""


def test_load_library_builds_and_loads_once(monkeypatch):
    builds, loads = [], []

    def fake_build(names):
        builds.append(list(names))
        time.sleep(0.2)                 # a build takes a while: others wait
        return {n: (Path(f"/nonexistent/{n}.so"), 0.2, "") for n in names}

    def fake_cdll(path):
        loads.append(path)
        return _FakeLib(path)

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_LOADED", {})
    libs = _together(lambda i: load_library("kernel_a" if i % 2 else "kernel_b"))
    assert sorted(map(tuple, builds)) == [("kernel_a",), ("kernel_b",)]
    assert sorted(loads) == ["/nonexistent/kernel_a.so",
                             "/nonexistent/kernel_b.so"]
    assert len({id(lib) for lib in libs}) == 2
    assert all(lib is libs[1] for lib in libs[1::2])
    # a later call loads nothing new
    assert load_library("kernel_a") is libs[1] and len(loads) == 2


def test_failed_build_is_not_cached(monkeypatch):
    """A build that raises leaves nothing loaded: the next call builds
    again (and raises again), never hands out a half-made library."""
    calls = []

    def failing(names):
        calls.append(names)
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "build", failing)
    monkeypatch.setattr(_build, "_LOADED", {})
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            load_library("kernel_c")
    assert len(calls) == 2 and _build._LOADED == {}


@pytest.mark.parametrize("gate", [fused_vae_gate, fused_mingru_gate,
                                  fused_attention_gate],
                         ids=lambda g: g.__name__)
def test_launch_counters_lose_nothing(gate, monkeypatch):
    monkeypatch.setattr(gate, "launches", 0)
    per_thread = 2000

    def bump(_):
        for _ in range(per_thread):
            count_launch(gate)

    _together(bump)
    assert gate.launches == THREADS * per_thread


def test_count_launch_other_counters(monkeypatch):
    from shm_tpu_torch.ops import lstm2_enc_last

    monkeypatch.setattr(lstm2_enc_last, "fwd_launches", 5)
    count_launch(lstm2_enc_last, "fwd_launches")
    assert lstm2_enc_last.fwd_launches == 6
