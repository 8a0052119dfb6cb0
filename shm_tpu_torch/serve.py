"""Serving surface for the hybrid pipeline (counterpart of ``shm_tpu/serve.py``).

:class:`HybridScorer` loads the artifacts once, keeps the models on one
device and scores requests of any size in full ``max_batch`` batches plus one
power-of-two bucket, so the kernel only ever sees a handful of batch shapes::

    scorer = HybridScorer.from_artifacts("data/4dof")      # on cuda
    scorer.warmup()
    out = scorer.score(windows)          # dict of numpy arrays
    out["y_pred"]                        # 0=Normal, 1=Sensor, 2=Structural

:class:`StreamScorer` scores a continuous sensor stream window by window as
its samples arrive, with the outputs of ``score_series`` on the whole
series, however the stream is chunked.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from shm_tpu_torch.data.windows import make_windows
from shm_tpu_torch.device import set_full_f32_precision
from shm_tpu_torch.pipeline import _KEYS, concat_hybrid_outputs, make_hybrid_fn


def bucket_size(n: int, min_bucket: int, max_batch: int) -> int:
    """Smallest shape in the ``min_bucket * 2^k`` (capped at ``max_batch``)
    bucket series that fits ``n`` windows."""
    b = min_bucket
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


def bucket_series(min_bucket: int, max_batch: int) -> Sequence[int]:
    """Every padded batch shape the ``min_bucket * 2^k`` policy can dispatch."""
    out, b = [], min_bucket
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU float32 tensor of ``a``, sharing its memory where it can; a
    read-only array (``np.frombuffer`` of a request body) is copied once,
    since a tensor may not share read-only memory."""
    a = np.ascontiguousarray(a, np.float32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


def score_bucketed(fn, W: np.ndarray, min_bucket: int, max_batch: int,
                   ndim: int = 3) -> Dict[str, np.ndarray]:
    """Run ``fn(Wb) -> HybridOutputs`` (``Wb`` a CPU float32 tensor) over a
    batch-leading window stack in full ``max_batch`` batches plus one padded
    power-of-two bucket, trimming pad rows from the host outputs."""
    W = np.asarray(W, np.float32)
    if W.ndim != ndim:
        raise ValueError(f"expected a rank-{ndim} batch-leading window "
                         f"stack, got {W.shape}")
    N = W.shape[0]
    if N == 0:
        return {k: np.zeros((0,), np.float32) for k in _KEYS}
    outs, i = [], 0
    while i < N:
        n = min(max_batch, N - i)
        b = bucket_size(n, min_bucket, max_batch)
        Wb = W[i:i + n]
        if b != n:
            Wb = np.concatenate(
                [Wb, np.zeros((b - n,) + W.shape[1:], np.float32)])
        outs.append((fn(host_tensor(Wb)), n))
        i += n
    return concat_hybrid_outputs(outs)


def mesh_scorer_device(mesh, device, min_bucket: int = 0,
                       max_batch: int = 0) -> torch.device:
    """A scorer's device (:func:`shm_tpu_torch.parallel.mesh.mesh_device`);
    with a mesh, the buckets given must be multiples of its size."""
    from shm_tpu_torch.parallel.mesh import mesh_device

    if mesh is not None and (min_bucket % mesh.size or max_batch % mesh.size):
        raise ValueError(
            f"min_bucket/max_batch must be multiples of the mesh size "
            f"({mesh.size}); got {min_bucket}/{max_batch}")
    return mesh_device(mesh, device)


class HybridScorer:
    """Artifact-loaded, bucket-batched scorer for the hybrid pipeline.

    ``device``: ``None`` means the CUDA card (raises without one); tests pass
    ``"cpu"``. ``use_fused_vae``: ``None`` asks
    :func:`shm_tpu_torch.ops.auto_fused_gate`: on CUDA the fused kernel of
    the VAE's cell, which raises for a cell or a shape it does not take; on
    the CPU the plain modules.

    ``mesh``: a :class:`shm_tpu_torch.parallel.Mesh` (one process) splits
    every bucket over its devices, each scoring its shard with its own
    replica of the models (``parallel.make_dp_hybrid_shardmap``: on the card
    the gate kernel once a shard); ``min_bucket`` and ``max_batch`` must be
    multiples of its size. The scorer's ``device`` is then the mesh's first.

    The scorer may be called from several host threads at once (the HTTP
    daemon's handlers, its batcher and its shadow worker): every call
    launches on the calling thread's current stream, which is the device's
    default stream unless the caller set another, so the launches of all
    threads run in their order on one stream.
    """

    # the calibrated healthy anomaly rate and the percentile the threshold
    # was fit at, from the threshold manifest (set by from_artifacts; None
    # for a hand-built scorer): the HTTP daemon's drift monitor baselines
    # against the rate, and POST /recalibrate defaults to the percentile
    expected_anomaly_rate: Optional[float] = None
    calibration_percentile: Optional[float] = None

    def __init__(self, vae, cnn, mean, std, threshold: float, *,
                 use_fused_vae: Optional[bool] = None,
                 min_bucket: int = 256, max_batch: int = 8192,
                 seq_len: Optional[int] = None, device=None, mesh=None):
        if min_bucket < 1 or max_batch < min_bucket:
            raise ValueError("need 1 <= min_bucket <= max_batch")
        self.device = mesh_scorer_device(mesh, device, min_bucket, max_batch)
        if self.device.type == "cuda":
            set_full_f32_precision()
        if use_fused_vae is None:
            from shm_tpu_torch.ops import auto_fused_gate

            use_fused_vae = auto_fused_gate(self.device)
        self.use_fused_vae = bool(use_fused_vae)
        self.mesh = mesh
        self.vae = vae.to(self.device).eval()
        self.cnn = cnn.to(self.device).eval()
        if mesh is None:
            self._fn = make_hybrid_fn(self.vae, self.cnn,
                                      use_fused_vae=self.use_fused_vae)
        else:
            from shm_tpu_torch.parallel.mesh import make_dp_hybrid_shardmap

            self._fn = make_dp_hybrid_shardmap(
                self.vae, self.cnn, mesh, use_fused_vae=self.use_fused_vae)
        as_dev = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                           device=self.device)
        self.mean = as_dev(mean)
        self.std = as_dev(std)
        self.threshold = as_dev(float(threshold))
        self.min_bucket = int(min_bucket)
        self.max_batch = int(max_batch)
        self.seq_len = int(seq_len) if seq_len is not None else None

    @property
    def num_features(self) -> int:
        return int(self.mean.shape[-1])

    @classmethod
    def from_artifacts(cls, root: str | Path, cfg=None, *, device=None,
                       **kw) -> "HybridScorer":
        """Load the 4DOF artifact layout (``models/*.msgpack``,
        ``processed/normal_stats.npz``, ``processed/vae_threshold.json``);
        the VAE's cell family comes from
        ``processed/stage1_vae_train_meta.json``."""
        from shm_tpu_torch.cli.stage4dof import Paths, _load_stats, _load_vae
        from shm_tpu_torch.config import Stage4DofConfig
        from shm_tpu_torch.convert import cnn4dof_from_flax
        from shm_tpu_torch.monitor import expected_rate_from_threshold_meta
        from shm_tpu_torch.utils.checkpoint import load_checkpoint
        from shm_tpu_torch.utils.io import load_json

        device = mesh_scorer_device(kw.get("mesh"), device)
        cfg = cfg or Stage4DofConfig()
        paths = Paths(str(root))
        mean, std = _load_stats(paths)
        vae = _load_vae(paths, cfg)
        cnn = cnn4dof_from_flax(load_checkpoint(paths.models / "cnn.msgpack"),
                                cfg.cnn.num_classes, cfg.seq_len,
                                cfg.num_features)
        thr_meta = load_json(paths.processed / "vae_threshold.json")
        kw.setdefault("seq_len", cfg.seq_len)
        scorer = cls(vae, cnn, mean, std, float(thr_meta["threshold"]),
                     device=device, **kw)
        scorer.expected_anomaly_rate = expected_rate_from_threshold_meta(
            thr_meta)
        pct = thr_meta.get("percentile")
        scorer.calibration_percentile = None if pct is None else float(pct)
        return scorer

    def set_threshold(self, threshold: float) -> None:
        """Swap the gate threshold in place (live recalibration)."""
        self.threshold = torch.tensor(float(threshold), dtype=torch.float32,
                                      device=self.device)

    def buckets(self) -> Sequence[int]:
        """Every padded batch shape this scorer can dispatch."""
        return bucket_series(self.min_bucket, self.max_batch)

    def _dispatch(self, Wb: torch.Tensor):
        return self._fn(Wb.to(self.device, non_blocking=True), self.mean,
                        self.std, self.threshold)

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None,
               seq_len: Optional[int] = None,
               num_features: Optional[int] = None) -> None:
        """Run every bucket shape once before traffic (builds the kernel on
        first use and lets the allocator settle)."""
        D = num_features or self.num_features
        T = seq_len or self.seq_len
        if T is None:
            raise ValueError("warmup() needs the serving window length: "
                             "construct the scorer with seq_len=, use "
                             "from_artifacts(), or pass seq_len= here")
        for b in (batch_sizes or self.buckets()):
            out = self._dispatch(torch.zeros(b, T, D))
            out.mse.cpu()                    # wait for the device

    def warmup_series(self, stride: int = 1,
                      batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Run :meth:`score_series`'s path once for every bucket at
        ``stride`` (a zero series of exactly that many windows), so a first
        request at that stride builds no kernel and allocates no new
        device memory. A mesh scorer has no series path to warm
        (:meth:`score_series` windows on the host and calls :meth:`score`):
        it raises; call :meth:`warmup`."""
        if self.mesh is not None:
            raise ValueError(
                "mesh scorers window on the host and dispatch through the "
                "windows path (score_series goes through score()); there is "
                "no series path to warm: call warmup() instead")
        if self.seq_len is None:
            raise ValueError("series scoring needs seq_len (see warmup())")
        for b in (batch_sizes or self.buckets()):
            self.score_series(np.zeros(((b - 1) * stride + self.seq_len,
                                        self.num_features), np.float32),
                              stride=stride)

    def score(self, W: np.ndarray) -> Dict[str, np.ndarray]:
        """Score an (N, T, D) raw window stack; numpy arrays
        ``mse/anomalous/y_pred/p_struct`` of length N."""
        return score_bucketed(self._dispatch, W, self.min_bucket,
                              self.max_batch)

    def score_series(self, x: np.ndarray, stride: int = 1) -> Dict[str, np.ndarray]:
        """Score every sliding window of a raw (T_total, D) series; the same
        outputs as ``score(make_windows(x))``, window for window. Windows are
        cut on the device from the uploaded series; with a mesh they are cut
        on the host and scored by :meth:`score`."""
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"expected a (T_total, D) series, got {x.shape}")
        if self.seq_len is None:
            raise ValueError("series scoring needs seq_len: construct with "
                             "seq_len= or use from_artifacts()")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        T = self.seq_len
        n = (x.shape[0] - T) // stride + 1 if x.shape[0] >= T else 0
        if n <= 0:
            return {k: np.zeros((0,), np.float32) for k in _KEYS}
        if self.mesh is not None:
            return self.score(make_windows(host_tensor(x), T, stride).numpy())
        xs = host_tensor(x).to(self.device)
        outs, i = [], 0
        while i < n:
            m = min(self.max_batch, n - i)
            b = bucket_size(m, self.min_bucket, self.max_batch)
            seg = xs[i * stride: i * stride + (m - 1) * stride + T]
            Wb = make_windows(seg, T, stride)
            if b != m:
                Wb = torch.cat([Wb, Wb.new_zeros((b - m,) + Wb.shape[1:])])
            outs.append((self._dispatch(Wb.contiguous()), m))
            i += m
        return concat_hybrid_outputs(outs)


class StreamScorer:
    """Stateful incremental scoring of a continuous sensor stream.

    ``push(samples)`` buffers on the host, scores every newly complete
    sliding window through the wrapped scorer's ``score_series`` (windows
    cut on the device, the warmed bucket set) and keeps only the tail of
    samples the next window still needs, so memory stays O(seq_len)
    whatever the stream's length. Outputs carry ``window_start``, the global
    sample index each window begins at. Feeding a series chunk by chunk
    gives the outputs of ``score_series`` on the whole series, however the
    stream is chunked: on the card mse and the decisions bit for bit, and
    ``p_struct`` within the last bits that cuDNN's choice of convolution
    algorithm per batch shape moves (the chunks ride other buckets).

    ``monitor``: drift detection on the stream's gate decisions
    (:class:`shm_tpu_torch.monitor.DriftMonitor`). ``"auto"`` attaches one
    when the scorer knows its calibrated healthy anomaly rate (set by
    ``from_artifacts``); pass a ``DriftMonitor`` to share or tune one, or
    ``None`` for none. Each ``push`` folds its windows in stream order, and
    the monitor's batch update is chunking-invariant too. ``reset()`` keeps
    the monitor: drift history follows the model and threshold, not one
    stream (call ``monitor.reset()`` after recalibrating).
    """

    def __init__(self, scorer: HybridScorer, stride: int = 1,
                 monitor="auto"):
        if scorer.seq_len is None:
            raise ValueError("streaming needs seq_len: construct the scorer "
                             "with seq_len= or use from_artifacts()")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if isinstance(monitor, str):
            if monitor != "auto":
                raise ValueError(f"monitor must be 'auto', None, or a "
                                 f"DriftMonitor, got {monitor!r}")
            rate = getattr(scorer, "expected_anomaly_rate", None)
            if rate is not None:
                from shm_tpu_torch.monitor import DriftMonitor

                monitor = DriftMonitor(rate)
            else:
                monitor = None
        self.monitor = monitor
        self.scorer = scorer
        self.stride = int(stride)
        self._D = int(scorer.num_features)
        # invariant: the NEXT unscored window starts ``_skip`` samples past
        # _buf[0] (``_skip`` > 0 only with stride > seq_len, where the gap
        # samples between windows may not have arrived yet)
        self._buf = np.zeros((0, self._D), np.float32)
        self._next_start = 0          # global index of that window start
        self._skip = 0                # gap samples still to drop on arrival

    @property
    def buffered_samples(self) -> int:
        return int(self._buf.shape[0])

    @property
    def window_start(self) -> int:
        """Global sample index at which the next unscored window starts."""
        return self._next_start

    def push(self, x: np.ndarray) -> Dict[str, np.ndarray]:
        """Feed ``(n, D)`` new samples; score every window they complete.

        Returns the usual output arrays plus ``window_start``; all arrays
        are empty until a window completes.
        """
        x = np.asarray(x, np.float32)
        if x.ndim != 2 or x.shape[1] != self._D:
            raise ValueError(f"expected (n, {self._D}) samples, "
                             f"got {x.shape}")
        if self._skip and x.shape[0]:
            # stride > seq_len: the previous push consumed gap samples that
            # had not arrived yet; drop them as they come in
            d = min(self._skip, x.shape[0])
            x = x[d:]
            self._skip -= d
        self._buf = np.concatenate([self._buf, x]) if x.shape[0] else self._buf
        T, s = self.scorer.seq_len, self.stride
        L = self._buf.shape[0]
        n = (L - T) // s + 1 if L >= T and not self._skip else 0
        starts = self._next_start + s * np.arange(n)
        if n == 0:
            out = {k: np.zeros((0,), np.float32) for k in _KEYS}
        else:
            out = self.scorer.score_series(self._buf[: (n - 1) * s + T],
                                           stride=s)
            consumed = n * s              # can exceed L when stride > seq_len
            drop = min(consumed, L)
            self._buf = self._buf[drop:]
            self._skip = consumed - drop
            self._next_start += consumed
        out["window_start"] = starts
        if self.monitor is not None and out["anomalous"].size:
            self.monitor.update(out["anomalous"])
        return out

    def reset(self) -> None:
        """Drop buffered samples and restart stream indexing at 0."""
        self._buf = np.zeros((0, self._D), np.float32)
        self._next_start = 0
        self._skip = 0


__all__ = ["HybridScorer", "StreamScorer", "bucket_size", "bucket_series",
           "host_tensor", "mesh_scorer_device", "score_bucketed"]
