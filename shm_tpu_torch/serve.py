"""Serving surface for the hybrid pipeline (counterpart of ``shm_tpu/serve.py``).

:class:`HybridScorer` loads the artifacts once, keeps the models on one
device and scores requests of any size in full ``max_batch`` batches plus one
power-of-two bucket, so the kernel only ever sees a handful of batch shapes::

    scorer = HybridScorer.from_artifacts("data/4dof")      # on cuda
    scorer.warmup()
    out = scorer.score(windows)          # dict of numpy arrays
    out["y_pred"]                        # 0=Normal, 1=Sensor, 2=Structural
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from shm_tpu_torch.data.windows import make_windows
from shm_tpu_torch.device import resolve_device, set_full_f32_precision
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
        outs.append((fn(torch.from_numpy(np.ascontiguousarray(Wb))), n))
        i += n
    return concat_hybrid_outputs(outs)


class HybridScorer:
    """Artifact-loaded, bucket-batched scorer for the hybrid pipeline.

    ``device``: ``None`` means the CUDA card (raises without one); tests pass
    ``"cpu"``. ``use_fused_vae``: ``None`` asks
    :func:`shm_tpu_torch.ops.auto_fused_gate`: on CUDA the fused kernel of
    the VAE's cell, which raises for a cell or a shape it does not take; on
    the CPU the plain modules.
    """

    def __init__(self, vae, cnn, mean, std, threshold: float, *,
                 use_fused_vae: Optional[bool] = None,
                 min_bucket: int = 256, max_batch: int = 8192,
                 seq_len: Optional[int] = None, device=None):
        if min_bucket < 1 or max_batch < min_bucket:
            raise ValueError("need 1 <= min_bucket <= max_batch")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_full_f32_precision()
        if use_fused_vae is None:
            from shm_tpu_torch.ops import auto_fused_gate

            use_fused_vae = auto_fused_gate(self.device)
        self.use_fused_vae = bool(use_fused_vae)
        self.vae = vae.to(self.device).eval()
        self.cnn = cnn.to(self.device).eval()
        self._fn = make_hybrid_fn(self.vae, self.cnn,
                                  use_fused_vae=self.use_fused_vae)
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
        from shm_tpu_torch.utils.checkpoint import load_checkpoint
        from shm_tpu_torch.utils.io import load_json

        device = resolve_device(device)
        cfg = cfg or Stage4DofConfig()
        paths = Paths(str(root))
        mean, std = _load_stats(paths)
        vae = _load_vae(paths, cfg)
        cnn = cnn4dof_from_flax(load_checkpoint(paths.models / "cnn.msgpack"),
                                cfg.cnn.num_classes, cfg.seq_len,
                                cfg.num_features)
        thr_meta = load_json(paths.processed / "vae_threshold.json")
        kw.setdefault("seq_len", cfg.seq_len)
        return cls(vae, cnn, mean, std, float(thr_meta["threshold"]),
                   device=device, **kw)

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
               seq_len: Optional[int] = None) -> None:
        """Run every bucket shape once before traffic (builds the kernel on
        first use and lets the allocator settle)."""
        T = seq_len or self.seq_len
        if T is None:
            raise ValueError("warmup() needs the serving window length: "
                             "construct the scorer with seq_len=, use "
                             "from_artifacts(), or pass seq_len= here")
        for b in (batch_sizes or self.buckets()):
            out = self._dispatch(torch.zeros(b, T, self.num_features))
            out.mse.cpu()                    # wait for the device

    def score(self, W: np.ndarray) -> Dict[str, np.ndarray]:
        """Score an (N, T, D) raw window stack; numpy arrays
        ``mse/anomalous/y_pred/p_struct`` of length N."""
        return score_bucketed(self._dispatch, W, self.min_bucket,
                              self.max_batch)

    def score_series(self, x: np.ndarray, stride: int = 1) -> Dict[str, np.ndarray]:
        """Score every sliding window of a raw (T_total, D) series; the same
        outputs as ``score(make_windows(x))``, window for window. Windows are
        cut on the device from the uploaded series."""
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
        xs = torch.from_numpy(x).to(self.device)
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


__all__ = ["HybridScorer", "bucket_size", "bucket_series", "score_bucketed"]
