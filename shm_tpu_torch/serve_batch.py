"""Cross-request dynamic batching for the scoring service (counterpart of
``shm_tpu/serve_batch.py``).

:class:`DynamicBatcher` coalesces requests that arrive within a short window
(default 2 ms) into one bucket-padded scoring call and splits the outputs
back per request, so k small concurrent requests cost about one dispatch.

- It composes on top of :meth:`shm_tpu_torch.serve.HybridScorer.score`, so
  each request's mse and decisions are those of scoring it alone, bit for
  bit: the gate kernels compute each window on its own, and ``score()``
  pads and trims per bucket (on the CPU every output is equal, pinned in
  tests/test_torch_serve_batch.py; on the card ``p_struct`` may move in
  its last bits, since cuDNN picks the CNN's algorithm per batch shape).
- One dispatcher thread owns all device work: request threads only enqueue
  and wait on a Future, so the launches of /score traffic stay in one
  order whatever the number of HTTP threads.
- Validation runs on the request thread, so a malformed request fails
  alone and never takes a coalesced batch down with it.
- A scoring failure is handed to every request of its batch.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np

_EMPTY_KEYS = ("mse", "anomalous", "y_pred", "p_struct")


class DynamicBatcher:
    """Coalesce concurrent ``score`` calls into shared device dispatches.

    ``max_delay_ms`` bounds the extra latency any request can pay waiting
    for co-travelers (it only waits while the coalesced batch is below
    ``max_windows``, default the scorer's ``max_batch``).
    """

    def __init__(self, scorer, max_delay_ms: float = 2.0,
                 max_windows: Optional[int] = None):
        if max_delay_ms < 0:
            raise ValueError(f"max_delay_ms must be >= 0, got {max_delay_ms}")
        self.scorer = scorer
        self.max_delay = float(max_delay_ms) / 1e3
        self.max_windows = int(max_windows or scorer.max_batch)
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._closed = False
        # makes "closed-check + enqueue" atomic against "set-closed +
        # sentinel": without it a request could land BEHIND the close
        # sentinel and block forever on its never-completed Future
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="batch-dispatcher")
        self._thread.start()

    # ------------------------------------------------------------------
    def score(self, W: np.ndarray) -> Dict[str, np.ndarray]:
        """Blocking scorer-compatible entry point for request threads."""
        W = np.asarray(W, np.float32)
        # validate HERE (request thread): a malformed request must fail
        # alone, never inside a coalesced batch where it would take
        # innocent co-traveling requests down with it
        rank = int(getattr(self.scorer, "request_rank", 3))
        if W.ndim != rank:
            raise ValueError(f"expected a rank-{rank} batch-leading window "
                             f"stack, got {W.shape}")
        D = int(self.scorer.num_features)
        T = self.scorer.seq_len
        if W.shape[0]:
            if T is not None and W.shape[1] != T:
                raise ValueError(f"scorer serves T={T}, got {W.shape[1]}")
            if W.shape[2] != D:
                raise ValueError(f"scorer serves D={D}, got {W.shape[2]}")
            if rank == 4 and W.shape[3] != 2:
                raise ValueError("stacked [clean, raw] requests need a "
                                 f"trailing pair axis of 2, got {W.shape[3]}")
        if W.shape[0] == 0:
            return {k: np.zeros((0,), np.float32) for k in _EMPTY_KEYS}
        f: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put((W, f))
        return f.result()

    def close(self, timeout: float = 10.0) -> None:
        """Stop the dispatcher; pending requests still complete first
        (the lock guarantees every accepted request precedes the sentinel)."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(None)
        self._thread.join(timeout=timeout)

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            total = item[0].shape[0]
            deadline = time.perf_counter() + self.max_delay
            while total < self.max_windows:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:          # close() sentinel mid-coalesce:
                    self._q.put(None)    # serve this batch, exit next turn
                    break
                batch.append(nxt)
                total += nxt[0].shape[0]
            try:
                out = self.scorer.score(np.concatenate([w for w, _ in batch]))
            except Exception as e:
                for _, f in batch:
                    f.set_exception(e)
                continue
            i = 0
            for w, f in batch:
                n = w.shape[0]
                f.set_result({k: v[i:i + n] for k, v in out.items()})
                i += n


__all__ = ["DynamicBatcher"]
