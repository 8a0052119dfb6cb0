"""Serving of the openLAB (bridge) hybrid (counterpart of
``shm_tpu/serve_openlab.py``).

:class:`OpenLabScorer` loads the bridge stage's artifacts once and scores
extracted window pairs in the bucket batches of
:func:`shm_tpu_torch.serve.score_bucketed`, with the semantics of the
``test-hybrid`` command:

- **Gate**: the clean windows' gate channels (``manifest["channels_idx"]``)
  standardized and clipped on the device (non-finite values to 0), one
  reconstruction MSE per window, anomalous where ``mse > threshold``
  (strict). On the card the pass is the gate-only mode of the fused kernel
  of the VAE's cell (``fused_gate_for``, ``with_residual=False``: the CNN
  reads raw windows, not residuals); on the CPU the plain model.
- **Stage 2** on the anomalous windows: the openLAB CNN on the raw
  windows, standardized and clipped (``p_st >= cnn_threshold`` is
  structural, else sensor), or one of the five classical models on the
  caller's 76 features, scored on the device from its export file
  (``models/ml.py``).

The request is ONE (N, seq_len, channels, 2) float32 tensor, the clean
windows at ``[..., 0]`` and the raw ones at ``[..., 1]`` (cleaning is a
per-run cascade, so it belongs to extraction, not to the scorer);
``score_pair(Xc, Xr)`` takes the two stacks apart, and the classical modes
take the feature matrix as ``features=``::

    scorer = OpenLabScorer.from_artifacts("data/openlab")      # on cuda
    out = scorer.score_pair(Xc[idx], Xr[idx])
    rf = OpenLabScorer.from_artifacts("data/openlab", stage2="rf")
    out = rf.score_pair(Xc[idx], Xr[idx], features=X_feat[idx])

Labels: 0 = Normal, 1 = Sensor Fault, 2 = Structural Fault.
``export_program`` gives the CNN mode's plain path as a module for
:mod:`shm_tpu_torch.export`. ``mesh=`` splits every bucket over the devices
of a :class:`shm_tpu_torch.parallel.Mesh`, each shard scored by its own
replica of the models (on the card the gate kernel once a shard).
"""

from __future__ import annotations

import copy
import functools
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from shm_tpu_torch.device import set_full_f32_precision
from shm_tpu_torch.pipeline import HybridOutputs
from shm_tpu_torch.serve import (bucket_series, mesh_scorer_device,
                                 score_bucketed)

#: the classical stage-2 models scorable on the device
ML_STAGE2 = ("cart", "rf", "gb", "hgb", "svm_rbf")


def stack_pair(Xc: np.ndarray, Xr: np.ndarray) -> np.ndarray:
    """The (N, T, C, 2) request tensor of clean and raw window stacks; a
    shape mismatch raises."""
    Xc = np.asarray(Xc, np.float32)
    Xr = np.asarray(Xr, np.float32)
    if Xc.shape != Xr.shape:
        raise ValueError(f"clean/raw shapes differ: {Xc.shape} vs {Xr.shape}")
    return np.stack([Xc, Xr], axis=-1)


def standardize_clip_device(X: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor,
                            clip_z: float) -> torch.Tensor:
    """``cli/openlab.py::standardize_clip`` on the device: (X - mu) / sd,
    clipped to +-clip_z, non-finite values to 0 (the same float32 operations,
    so the same bits)."""
    Z = torch.clamp((X - mu) / sd, -clip_z, clip_z)
    return torch.nan_to_num(Z, nan=0.0, posinf=0.0, neginf=0.0)


def gate_inputs(X: torch.Tensor, ch: torch.Tensor, gate_mu: torch.Tensor,
                gate_sd: torch.Tensor, clip_z: float) -> torch.Tensor:
    """The gate's input of an (N, T, C, 2) request: the clean windows' gate
    channels ``ch``, standardized and clipped, contiguous."""
    return standardize_clip_device(X[..., 0].index_select(2, ch), gate_mu,
                                   gate_sd, clip_z).contiguous()


def cnn_stage2(X: torch.Tensor, mse: torch.Tensor, threshold: float, cnn,
               cnn_mu: torch.Tensor, cnn_sd: torch.Tensor, clip_z: float,
               stage2_threshold: float) -> HybridOutputs:
    """The outputs of an (N, T, C, 2) request given its gate MSE: anomalous
    where ``mse > threshold`` (strict); the CNN on the raw windows,
    standardized and clipped, structural (2) where ``p_st >=
    stage2_threshold``, else sensor (1), on the anomalous windows."""
    anom = mse > threshold
    Za = standardize_clip_device(X[..., 1], cnn_mu, cnn_sd, clip_z)
    logits = cnn(Za[..., None])
    p_st = torch.softmax(logits, dim=1)[:, 1]
    one = torch.ones_like(anom, dtype=torch.int32)
    y3 = torch.where(anom, torch.where(p_st >= stage2_threshold, one * 2, one),
                     0 * one)
    return HybridOutputs(mse=mse, anomalous=anom, y_pred=y3,
                         p_struct=torch.where(anom, p_st, torch.zeros_like(p_st)),
                         logits=logits)


class _OpenLabProgram(torch.nn.Module):
    """The CNN-mode openLAB hybrid on the plain path, every weight,
    statistic and threshold held by the module: ``forward(X)`` of an
    (N, T, C, 2) request returns ``(mse, anomalous, y_pred, p_struct,
    logits)``."""

    def __init__(self, scorer: "OpenLabScorer"):
        super().__init__()
        cpu = lambda m: copy.deepcopy(m).cpu().eval().requires_grad_(False)
        self.vae, self.cnn = cpu(scorer.vae), cpu(scorer.cnn)
        for name in ("gate_mu", "gate_sd", "cnn_mu", "cnn_sd"):
            self.register_buffer(name, getattr(scorer, name).cpu().clone())
        self.register_buffer("ch", scorer._ch.cpu().clone())
        self.clip_z = scorer.clip_z
        self.threshold = scorer.threshold
        self.stage2_threshold = scorer.stage2_threshold

    def forward(self, X: torch.Tensor):
        Zg = gate_inputs(X, self.ch, self.gate_mu, self.gate_sd, self.clip_z)
        recon, _, _ = self.vae(Zg)
        mse = ((Zg - recon) ** 2).mean(dim=(1, 2))
        return tuple(cnn_stage2(X, mse, self.threshold, self.cnn, self.cnn_mu,
                                self.cnn_sd, self.clip_z, self.stage2_threshold))


class OpenLabScorer:
    """Load-once, bucket-batched scorer of the openLAB hybrid.

    ``stage2="cnn"`` (the default) runs the gate and the CNN in one pass per
    bucket; a name of :data:`ML_STAGE2` runs the gate there and the
    classical model on the anomalous windows' features (``ml_predict``:
    features (n, 76) -> p(ST) float64). ``device``: ``None`` is the CUDA
    card (raises without one); tests pass ``"cpu"``. ``use_fused_gate``:
    ``None`` asks :func:`shm_tpu_torch.ops.auto_fused_gate` (the fused
    kernel on CUDA, which raises for a cell or shape it does not take; the
    plain model on the CPU). ``mesh``: a
    :class:`shm_tpu_torch.parallel.Mesh` (one process, buckets multiples of
    its size) over whose devices every bucket is split
    (``parallel.make_dp_hybrid_fn``); ``device`` is then its first.
    """

    # the calibrated healthy anomaly rate (the threshold manifest's measured
    # FPR) and the percentile the threshold was fit at, set by
    # from_artifacts; the daemon's drift monitor and /recalibrate read them
    expected_anomaly_rate: Optional[float] = None
    calibration_percentile: Optional[float] = None
    #: the rank of a request: the daemon takes (N, T, C, 2) bodies
    request_rank = 4

    def __init__(self, vae, gate_mu, gate_sd, ch_idx, clip_z: float,
                 vae_threshold: float, *, stage2: str = "cnn", cnn=None,
                 cnn_mu=None, cnn_sd=None,
                 stage2_threshold: Optional[float] = None, ml_predict=None,
                 min_bucket: int = 256, max_batch: int = 8192,
                 seq_len: Optional[int] = None,
                 num_channels: Optional[int] = None,
                 use_fused_gate: Optional[bool] = None, mesh=None,
                 device=None):
        if min_bucket < 1 or max_batch < min_bucket:
            raise ValueError("need 1 <= min_bucket <= max_batch")
        if stage2 != "cnn" and stage2 not in ML_STAGE2:
            raise ValueError(f"unknown stage2 {stage2!r}; "
                             f"expected 'cnn' or one of {ML_STAGE2}")
        if stage2 == "cnn" and cnn is None:
            raise ValueError("stage2='cnn' needs cnn")
        if stage2 != "cnn" and ml_predict is None:
            raise ValueError(f"stage2={stage2!r} needs ml_predict "
                             "(use from_artifacts)")
        if stage2_threshold is None:
            raise ValueError("stage2_threshold is required (cnn_best_threshold"
                             ".npy / <ml>_threshold.npy)")
        self.device = mesh_scorer_device(mesh, device, min_bucket, max_batch)
        self.mesh = mesh
        if self.device.type == "cuda":
            set_full_f32_precision()
        if use_fused_gate is None:
            from shm_tpu_torch.ops import auto_fused_gate

            use_fused_gate = auto_fused_gate(self.device)
        self.use_fused_gate = bool(use_fused_gate)
        self.use_fused_vae = self.use_fused_gate
        self.stage2 = stage2
        self.vae = vae.to(self.device).eval()
        if self.use_fused_gate:
            from shm_tpu_torch.ops import fused_gate_for

            weights_fn, self._gate = fused_gate_for(self.vae)
            self._gate_weights = weights_fn(self.vae)
        self.cnn = None if cnn is None else cnn.to(self.device).eval()
        as_dev = lambda a: (None if a is None else torch.as_tensor(
            np.asarray(a, np.float32), device=self.device))
        self.gate_mu, self.gate_sd = as_dev(gate_mu), as_dev(gate_sd)
        self.cnn_mu, self.cnn_sd = as_dev(cnn_mu), as_dev(cnn_sd)
        self.ch_idx = tuple(int(i) for i in ch_idx)
        self._ch = torch.as_tensor(self.ch_idx, device=self.device)
        self.clip_z = float(clip_z)
        self.threshold = float(vae_threshold)
        self.stage2_threshold = float(stage2_threshold)
        self._ml_predict = ml_predict
        self.min_bucket = int(min_bucket)
        self.max_batch = int(max_batch)
        self.seq_len = int(seq_len) if seq_len is not None else None
        self.num_channels = (int(num_channels) if num_channels is not None
                             else None)
        self._mesh_fn = None
        if mesh is not None:
            from shm_tpu_torch.parallel.mesh import (make_dp_hybrid_fn,
                                                     replicas_of)

            vaes = replicas_of(self.vae, mesh)
            cnns = (replicas_of(self.cnn, mesh) if self.cnn is not None
                    else [None] * len(vaes))
            reps = [self] + [self._replica(*r) for r in
                             zip(mesh.devices[1:], vaes[1:], cnns[1:])]
            self._mesh_fn = make_dp_hybrid_fn(
                [functools.partial(self._dispatch_on, s=s) for s in reps],
                mesh)

    def _replica(self, device, vae, cnn) -> SimpleNamespace:
        """What a dispatch on ``device`` reads (the attributes of
        :meth:`_dispatch_on`'s ``s``): the replicas ``vae`` / ``cnn`` there
        (``parallel.replicas_of``) and a copy of the statistics."""
        s = SimpleNamespace(device=device, vae=vae, cnn=cnn)
        for name in ("gate_mu", "gate_sd", "cnn_mu", "cnn_sd", "_ch"):
            t = getattr(self, name)
            setattr(s, name, None if t is None else t.to(device, copy=True))
        if self.use_fused_gate:
            from shm_tpu_torch.ops import fused_gate_for

            weights_fn, _ = fused_gate_for(vae)
            s._gate_weights = weights_fn(vae)
        return s

    @property
    def num_features(self) -> int:
        """Channel count C of the (N, T, C, 2) request tensor."""
        if self.num_channels is None:
            raise ValueError("scorer was built without num_channels")
        return self.num_channels

    def _gate_mse(self, Zg: torch.Tensor, s) -> torch.Tensor:
        if self.use_fused_gate:
            mse, _ = self._gate(s._gate_weights, Zg,
                                num_layers=s.vae.num_layers,
                                use_layernorm=s.vae.use_layernorm,
                                with_residual=False)
            return mse
        recon, _, _ = s.vae(Zg)
        return ((Zg - recon) ** 2).mean(dim=(1, 2))

    def _dispatch(self, Xb: torch.Tensor) -> HybridOutputs:
        if self._mesh_fn is not None:
            return self._mesh_fn(Xb)
        return self._dispatch_on(Xb, self)

    @torch.inference_mode()
    def _dispatch_on(self, Xb: torch.Tensor, s) -> HybridOutputs:
        """One bucket (or one mesh shard) scored with the models and
        statistics of ``s`` (the scorer itself, or a :meth:`_replica`) on
        its device."""
        X = Xb.to(s.device, non_blocking=True)
        mse = self._gate_mse(gate_inputs(X, s._ch, s.gate_mu, s.gate_sd,
                                         self.clip_z), s)
        if self.stage2 != "cnn":
            b = X.shape[0]
            zeros = torch.zeros(b, device=s.device)
            return HybridOutputs(
                mse=mse, anomalous=mse > self.threshold,
                y_pred=torch.zeros(b, dtype=torch.int32, device=s.device),
                p_struct=zeros, logits=torch.zeros(b, 2, device=s.device))
        return cnn_stage2(X, mse, self.threshold, s.cnn, s.cnn_mu,
                          s.cnn_sd, self.clip_z, self.stage2_threshold)

    # ------------------------------------------------------------------
    @classmethod
    def from_artifacts(cls, root: str | Path, cfg=None, *,
                       stage2: str = "cnn", host_ml: bool = False,
                       device=None, **kw) -> "OpenLabScorer":
        """Load the artifact layout ``cli/openlab`` writes
        (``output/VAE_Training``, ``.../CNN_Training``, ``.../ML_Baselines``);
        the VAE's cell comes from its manifest.

        A classical ``stage2`` reads ``<name>.export.npz`` and scores on the
        device (a missing or stale export raises); ``host_ml=True`` loads
        the joblib and calls sklearn's own ``predict_proba`` (needs sklearn
        and joblib)."""
        from shm_tpu_torch.cli.openlab import (Paths, _load_openlab_cnn,
                                               _load_openlab_vae)
        from shm_tpu_torch.config import OpenLabConfig
        from shm_tpu_torch.models.ml import ml_predictor
        from shm_tpu_torch.monitor import expected_rate_from_threshold_meta
        from shm_tpu_torch.utils.io import load_json

        if stage2 != "cnn" and stage2 not in ML_STAGE2:
            raise ValueError(f"unknown stage2 {stage2!r}; "
                             f"expected 'cnn' or one of {ML_STAGE2}")
        device = mesh_scorer_device(kw.get("mesh"), device)
        cfg = cfg or OpenLabConfig()
        paths = Paths(str(root))
        vae, mu, sd, manifest = _load_openlab_vae(paths, cfg)
        thr_meta = load_json(paths.vae_val_dir / "artifacts"
                             / "vae_threshold.json")
        common = dict(ch_idx=manifest["channels_idx"],
                      clip_z=cfg.standardize_clip,
                      vae_threshold=float(thr_meta["threshold"]),
                      seq_len=cfg.seq_len, num_channels=cfg.cnn.num_features,
                      device=device)
        common.update(kw)
        if stage2 == "cnn":
            cnn, cmu, csd = _load_openlab_cnn(paths, cfg)
            thr2 = float(np.load(paths.cnn_val_dir / "artifacts"
                                 / "cnn_best_threshold.npy").ravel()[0])
            scorer = cls(vae, mu, sd, stage2="cnn", cnn=cnn, cnn_mu=cmu,
                         cnn_sd=csd, stage2_threshold=thr2, **common)
        else:
            art = paths.ml_dir / "artifacts"
            thr2 = float(np.load(art / f"{stage2}_threshold.npy").ravel()[0])
            ml_predict = ml_predictor(art / f"{stage2}.joblib", host_ml, device)
            scorer = cls(vae, mu, sd, stage2=stage2, ml_predict=ml_predict,
                         stage2_threshold=thr2, **common)
        scorer.expected_anomaly_rate = expected_rate_from_threshold_meta(
            thr_meta)
        pct = thr_meta.get("percentile")
        scorer.calibration_percentile = None if pct is None else float(pct)
        return scorer

    def set_threshold(self, threshold: float) -> None:
        """Swap the gate threshold in place (live recalibration)."""
        self.threshold = float(threshold)

    def buckets(self) -> Sequence[int]:
        return bucket_series(self.min_bucket, self.max_batch)

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Run every bucket shape once before traffic (builds the kernel on
        first use and lets the allocator settle)."""
        if self.seq_len is None or self.num_channels is None:
            raise ValueError("warmup() needs seq_len and num_channels "
                             "(from_artifacts sets both)")
        for b in (batch_sizes or self.buckets()):
            out = self._dispatch(torch.zeros(b, self.seq_len,
                                             self.num_channels, 2))
            out.mse.cpu()                    # wait for the device

    def warmup_series(self, stride: int = 1, batch_sizes=None) -> None:
        """The openLAB scorer has no raw-series endpoint (cleaning is a
        per-run cascade of the extraction); kept for the daemon's surface."""
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")

    # ------------------------------------------------------------------
    def score(self, X: np.ndarray,
              features: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Score an (N, seq_len, channels, 2) stack of [clean, raw] windows;
        numpy arrays ``mse/anomalous/y_pred/p_struct`` of length N. The
        classical modes need ``features`` (N, 76), row for row."""
        X = np.asarray(X, np.float32)
        if X.ndim != 4 or X.shape[-1] != 2:
            raise ValueError("expected (N, seq_len, channels, 2) stacked "
                             f"[clean, raw] windows, got {X.shape}")
        if self.stage2 != "cnn":
            if features is None:
                raise ValueError(f"stage2={self.stage2!r} needs features=")
            features = np.asarray(features, np.float32)
            if features.shape[0] != X.shape[0]:
                raise ValueError(f"features rows {features.shape[0]} != "
                                 f"windows {X.shape[0]}")
        out = score_bucketed(self._dispatch, X, self.min_bucket,
                             self.max_batch, ndim=4)
        if self.stage2 == "cnn" or X.shape[0] == 0:
            return out
        # the classical model scores only the gated windows: their count is
        # data-dependent, and the model is cheap
        anom = out["anomalous"].astype(bool)
        y3 = np.zeros(X.shape[0], np.int32)
        p = np.zeros(X.shape[0], np.float64)
        if anom.any():
            p_st = self._ml_predict(features[anom])
            y3[anom] = np.where(p_st >= self.stage2_threshold, 2, 1)
            p[anom] = p_st
        out["y_pred"] = y3
        out["p_struct"] = p.astype(np.float32)
        return out

    def score_pair(self, Xc: np.ndarray, Xr: np.ndarray,
                   features: Optional[np.ndarray] = None
                   ) -> Dict[str, np.ndarray]:
        """Score clean and raw window stacks given apart (``X_clean.npy`` /
        ``X_raw.npy``'s layout)."""
        return self.score(stack_pair(Xc, Xr), features=features)

    def export_program(self) -> torch.nn.Module:
        """A module ``f(X) -> (mse, anomalous, y_pred, p_struct, logits)``
        on the CPU holding every weight, statistic and threshold: the
        :mod:`shm_tpu_torch.export` entry point (CNN stage 2 only: the
        classical modes need the caller's features). It runs the plain
        gate whatever ``use_fused_gate`` says: the exported program is the
        plain path (``export.py``'s docstring)."""
        if self.stage2 != "cnn":
            raise ValueError(
                f"only stage2='cnn' exports (got {self.stage2!r}); a classical "
                "stage 2 needs the caller's features at request time")
        return _OpenLabProgram(self)


__all__ = ["OpenLabScorer", "ML_STAGE2", "stack_pair",
           "standardize_clip_device", "gate_inputs", "cnn_stage2"]
