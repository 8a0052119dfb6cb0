"""Timing and trace hooks (counterpart of ``shm_tpu/utils/profiling.py``).

- ``Timer`` / ``timed``: wall-clock spans; set ``.result`` on the yielded
  holder to have the device work behind it finish before the clock stops.
- ``throughput``: windows/s accounting.
- ``trace``: a ``torch.profiler`` span that writes a Chrome trace
  (``trace_<n>.json``) into the given directory or ``$SHM_TPU_TRACE_DIR``;
  with neither it does nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional

import torch

_TRACE_SEQ = itertools.count()


def _first_tensor(x):
    """The first tensor in ``x`` (a tensor, or a tuple, list or dict of
    them, nested; a named tuple counts as a tuple), else None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Wait for the work behind ``x``: the tensor's CUDA device is
    synchronised; on the CPU one element is read back."""
    t = _first_tensor(x)
    if t is None:
        return
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    elif t.numel():
        t.reshape(-1)[0].item()


class _SyncHolder:
    """Set ``.result`` inside a ``span``/``timed`` block to have it synced
    before the elapsed time is recorded."""

    result = None


@dataclass
class Timer:
    """Accumulating wall-clock timer with named spans."""

    spans: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        """``with t.span("gate") as s: s.result = fn(x)``: ``s.result`` is
        synced before the clock stops, so device work launched inside the
        block is inside the span."""
        h = _SyncHolder()
        t0 = time.perf_counter()
        try:
            yield h
        finally:
            if h.result is not None:
                sync(h.result)
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {k: {"seconds": v, "calls": self.counts[k],
                    "mean_ms": 1e3 * v / max(self.counts[k], 1)}
                for k, v in self.spans.items()}


@contextlib.contextmanager
def timed(name: str = ""):
    """One-shot timer that prints: ``with timed("gate") as t: t.result =
    fn(x)``, ``t.result`` synced before the time prints."""
    h = _SyncHolder()
    t0 = time.perf_counter()
    try:
        yield h
    finally:
        if h.result is not None:
            sync(h.result)
        dt = time.perf_counter() - t0
        print(f"[time] {name}: {dt * 1e3:.1f} ms")


def throughput(n_items: int, seconds: float, unit: str = "windows") -> Dict[str, float]:
    return {"n": n_items, "seconds": seconds,
            f"{unit}_per_sec": n_items / seconds if seconds > 0 else float("inf")}


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None):
    """A ``torch.profiler`` span (CPU activity, and CUDA where the card is
    there) whose Chrome trace is written to ``trace_dir`` (else
    ``$SHM_TPU_TRACE_DIR``) as ``trace_<pid>_<n>.json`` when it closes;
    with no directory it does nothing. Yields the trace file's path, or
    None."""
    trace_dir = trace_dir or os.environ.get("SHM_TPU_TRACE_DIR")
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{next(_TRACE_SEQ)}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))


__all__ = ["Timer", "timed", "throughput", "trace", "sync"]
