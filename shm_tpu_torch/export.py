"""The ``.shmx`` artifact: a trained scorer as one standalone file
(counterpart of ``shm_tpu/export.py``).

The whole deterministic hybrid program (normalization, VAE gate, CNN
attribution, thresholds, the trained weights held in the program) is
exported with :func:`torch.export.export` and written with
:func:`torch.export.save` beside a JSON manifest in one zip. The file
reloads and scores with torch and this loader alone: no model classes, no
msgpack, statistics or threshold files.

- **Symbolic batch.** The program is exported once with a symbolic batch
  dimension (at least 2: a size of 0 or 1 would be specialised), so one
  artifact serves every padded bucket; :class:`ExportedScorer` pads a
  one-window call to two and keeps the scorers' bucket policy
  (:func:`shm_tpu_torch.serve.score_bucketed`).
- **The plain path, by design.** The program is the plain PyTorch path,
  not the gate kernel, as the JAX artifact is the portable XLA lowering,
  not the Pallas kernel: a hand-written kernel is a build of this
  repository's sources for one card, which the artifact does not carry.
  The in-process scorers (:class:`shm_tpu_torch.serve.HybridScorer`,
  :class:`shm_tpu_torch.serve_openlab.OpenLabScorer`) keep the kernel.
  There is no ``--platforms`` and no ``--conv-impl``: those are choices of
  XLA's lowering.
- **The device at load.** The program is traced on the CPU, so its graph
  names the CPU (tensor-metadata checks, the attention positions'
  ``arange``); :func:`load_exported_scorer` moves it to the requested
  device (the CUDA card by default) with
  ``torch.export.passes.move_to_device_pass``, and on the card sets float32
  matmuls and convolutions to full float32 (no TF32).

Example::

    scorer = HybridScorer.from_artifacts("data/4dof")
    save_exported_scorer(scorer, "gate4dof.shmx")
    s = load_exported_scorer("gate4dof.shmx")        # on the card
    out = s.score(windows)               # the dict HybridScorer.score gives

CLI::

    python -m shm_tpu_torch.export --root data/4dof --out gate4dof.shmx
    python -m shm_tpu_torch.export --openlab data/openlab --out bridge.shmx
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import zipfile
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from shm_tpu_torch.device import resolve_device, set_full_f32_precision
from shm_tpu_torch.pipeline import (
    _KEYS, HybridOutputs, hybrid_outputs, make_vae_pass,
)
from shm_tpu_torch.serve import bucket_series, score_bucketed

FORMAT_VERSION = 1
_PROGRAM_ENTRY = "program.torch_export"
_JAX_PROGRAM_ENTRY = "program.jax_export"
_MANIFEST_ENTRY = "manifest.json"
_OUTPUT_KEYS = ("mse", "anomalous", "y_pred", "p_struct", "logits")
# the smallest batch the program takes (torch.export specialises 0 and 1)
_MIN_BATCH = 2


class _HybridProgram(torch.nn.Module):
    """A :class:`HybridScorer`'s hybrid on the plain path, on the CPU:
    ``forward(W)`` of raw (N, T, D) windows returns ``(mse, anomalous,
    y_pred, p_struct, logits)``."""

    def __init__(self, scorer):
        super().__init__()
        cpu = lambda m: copy.deepcopy(m).cpu().eval().requires_grad_(False)
        self.vae, self.cnn = cpu(scorer.vae), cpu(scorer.cnn)
        for name in ("mean", "std", "threshold"):
            self.register_buffer(name, getattr(scorer, name).detach().cpu().clone())
        self._vae_pass = make_vae_pass(self.vae)

    def forward(self, W: torch.Tensor):
        return tuple(hybrid_outputs(self._vae_pass, self.cnn, W, self.mean,
                                    self.std, self.threshold))


def _program(scorer):
    """(the module to export, the request shape after the batch)."""
    if getattr(scorer, "mesh", None) is not None:
        raise ValueError(
            "mesh scorers are bound to this process's devices; export a "
            "single-device scorer")
    if scorer.seq_len is None:
        raise ValueError(
            "export needs the serving window length: construct the scorer "
            "with seq_len= or use from_artifacts()")
    T, D = int(scorer.seq_len), int(scorer.num_features)
    if int(getattr(scorer, "request_rank", 3)) == 4:
        return scorer.export_program(), (T, D, 2)      # OpenLabScorer, CNN
    return _HybridProgram(scorer), (T, D)


def export_scorer(scorer) -> bytes:
    """``scorer``'s deterministic hybrid as :func:`torch.export.save`
    bytes: a :class:`shm_tpu_torch.serve.HybridScorer` (rank-3 ``(batch,
    seq_len, num_features)`` requests) or a CNN-mode
    :class:`shm_tpu_torch.serve_openlab.OpenLabScorer` (rank-4 ``(batch,
    seq_len, channels, 2)`` [clean, raw] requests). The program takes one
    float32 tensor with a symbolic batch of at least 2 and returns the
    plain tuple ``(mse, anomalous, y_pred, p_struct, logits)``."""
    module, shape = _program(scorer)
    example = torch.zeros((_MIN_BATCH + 1,) + shape)
    batch = torch.export.Dim("b", min=_MIN_BATCH)
    with torch.no_grad():
        ep = torch.export.export(module, (example,),
                                 dynamic_shapes=({0: batch},), strict=False)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def save_exported_scorer(scorer, path: str | Path, *,
                         extra_manifest: Optional[Dict] = None) -> Path:
    """Export ``scorer`` (HybridScorer or CNN-mode OpenLabScorer) and write
    the ``.shmx`` artifact (a zip: the program and a JSON manifest).
    Returns the written path."""
    blob = export_scorer(scorer)
    vae = scorer.vae
    rank = int(getattr(scorer, "request_rank", 3))
    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "devices": ["cpu"],
        "pipeline": "openlab" if rank == 4 else "4dof",
        "request_rank": rank,
        "seq_len": int(scorer.seq_len),
        "num_features": int(scorer.num_features),
        "threshold": float(scorer.threshold),
        "cell": getattr(vae, "cell", "lstm"),
        "num_layers": int(vae.num_layers),
        "min_bucket": int(scorer.min_bucket),
        "max_batch": int(scorer.max_batch),
        "outputs": list(_OUTPUT_KEYS),
        "calling_convention":
            ("call(X: float32[batch, seq_len, channels, 2]) -> "
             "(mse, anomalous, y_pred, p_struct, logits)" if rank == 4 else
             "call(W: float32[batch, seq_len, num_features]) -> "
             "(mse, anomalous, y_pred, p_struct, logits)"),
    }
    if rank == 4:
        manifest["stage2_threshold"] = float(scorer.stage2_threshold)
    if getattr(scorer, "expected_anomaly_rate", None) is not None:
        # a daemon serving the artifact baselines its drift monitor on it
        manifest["expected_anomaly_rate"] = float(scorer.expected_anomaly_rate)
    if extra_manifest:
        manifest.update(extra_manifest)
    path = Path(path)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_MANIFEST_ENTRY, json.dumps(manifest, indent=2))
        zf.writestr(_PROGRAM_ENTRY, blob)
    path.write_bytes(buf.getvalue())
    return path


class ExportedScorer:
    """Bucket-batched scorer over a loaded ``.shmx`` program.

    The request surface of :class:`shm_tpu_torch.serve.HybridScorer`
    (``score`` and ``score_series`` give the same dicts of numpy arrays,
    requests ride the same ``min_bucket * 2^k`` padded shapes, ``warmup()``
    runs them once) from the artifact alone, so
    :mod:`shm_tpu_torch.serve_http` serves it (``--shmx``). The threshold
    is part of the program: there is no ``set_threshold``, and the daemon
    refuses ``/recalibrate``.
    """

    # the daemon's surface: one device, the plain path (module docstring)
    mesh = None
    use_fused_vae = False
    exported = True

    def __init__(self, program: torch.export.ExportedProgram, manifest: Dict, *,
                 device=None, min_bucket: Optional[int] = None,
                 max_batch: Optional[int] = None):
        self.device = resolve_device(device)
        if self.device.type != "cpu":
            from torch.export.passes import move_to_device_pass

            program = move_to_device_pass(program, self.device)
        if self.device.type == "cuda":
            set_full_f32_precision()
        self._program = program
        self._fn = program.module()
        self.manifest = dict(manifest)
        self.seq_len = int(manifest["seq_len"])
        self.num_features = int(manifest["num_features"])
        self.threshold = float(manifest["threshold"])
        self.request_rank = int(manifest.get("request_rank", 3))
        rate = manifest.get("expected_anomaly_rate")
        self.expected_anomaly_rate = None if rate is None else float(rate)
        # `is not None`: a caller's invalid 0 must meet the range check
        self.min_bucket = int(manifest["min_bucket"] if min_bucket is None
                              else min_bucket)
        self.max_batch = int(manifest["max_batch"] if max_batch is None
                             else max_batch)
        if self.min_bucket < 1 or self.max_batch < self.min_bucket:
            raise ValueError("need 1 <= min_bucket <= max_batch")

    # ------------------------------------------------------------------
    def call(self, W) -> HybridOutputs:
        """One run of the program on an (N, ...) request stack (a tensor or
        an array), outputs on the scorer's device; a stack of fewer than
        two windows is padded to two and trimmed back."""
        if not isinstance(W, torch.Tensor):
            W = torch.from_numpy(np.ascontiguousarray(W, np.float32))
        W = W.to(self.device, torch.float32)
        n = W.shape[0]
        if n < _MIN_BATCH:
            W = torch.cat([W, W.new_zeros((_MIN_BATCH - n,) + W.shape[1:])])
        with torch.no_grad():
            out = self._fn(W.contiguous())
        return HybridOutputs(*(o[:n] for o in out))

    def buckets(self) -> Sequence[int]:
        return bucket_series(self.min_bucket, self.max_batch)

    def _request_shape(self, b: int):
        base = (b, self.seq_len, self.num_features)
        return base + (2,) if self.request_rank == 4 else base

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Run every bucket shape once before serving traffic."""
        for b in (batch_sizes or self.buckets()):
            self.call(torch.zeros(self._request_shape(b))).mse.cpu()

    def score(self, W: np.ndarray) -> Dict[str, np.ndarray]:
        """Score a request stack: (N, T, D) windows for a 4DOF artifact,
        (N, T, C, 2) stacked [clean, raw] pairs for an openLAB one; the
        outputs and padded shapes of the in-process scorers."""
        return score_bucketed(self.call, W, self.min_bucket, self.max_batch,
                              ndim=self.request_rank)

    def score_pair(self, Xc: np.ndarray, Xr: np.ndarray) -> Dict[str, np.ndarray]:
        """openLAB artifacts only: score clean and raw stacks given apart."""
        if self.request_rank != 4:
            raise ValueError("score_pair is for openLAB-pipeline artifacts; "
                             "this artifact takes (N, T, D) windows")
        from shm_tpu_torch.serve_openlab import stack_pair

        return self.score(stack_pair(Xc, Xr))

    def warmup_series(self, stride: int = 1,
                      batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Nothing beyond :meth:`warmup`: :meth:`score_series` cuts its
        windows on the host and runs them through the window buckets. Kept
        so the daemon's stride policy holds for ``--shmx`` scorers too."""
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")

    def score_series(self, x: np.ndarray, stride: int = 1) -> Dict[str, np.ndarray]:
        """Score every sliding window of a raw (T_total, D) series: the
        outputs of ``HybridScorer.score_series``, the windows cut on the
        host (the program starts at the window stack)."""
        from shm_tpu_torch.data.windows import make_windows_np

        if self.request_rank == 4:
            raise ValueError(
                "openLAB-pipeline artifacts have no raw-series path "
                "(cleaning is a per-run cascade owned by extraction); "
                "score extracted [clean, raw] window pairs instead")
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"expected a (T_total, D) series, got {x.shape}")
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        if x.shape[0] < self.seq_len:
            return {k: np.zeros((0,), np.float32) for k in _KEYS}
        return self.score(make_windows_np(x, self.seq_len, stride))


def load_exported_scorer(path: str | Path, *, device=None, **kw) -> ExportedScorer:
    """Load a ``.shmx`` artifact written by :func:`save_exported_scorer`
    onto ``device`` (``None``: the CUDA card; ``"cpu"`` for the CPU). A JAX
    artifact and a newer format raise ``ValueError``."""
    with zipfile.ZipFile(Path(path)) as zf:
        names = set(zf.namelist())
        if _JAX_PROGRAM_ENTRY in names and _PROGRAM_ENTRY not in names:
            raise ValueError(
                f"{path}: a JAX export ({_JAX_PROGRAM_ENTRY}, written by "
                "shm_tpu.export); load it with shm_tpu.export, or export the "
                "artifacts again with python -m shm_tpu_torch.export")
        manifest = json.loads(zf.read(_MANIFEST_ENTRY))
        if manifest.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"artifact format {manifest.get('format_version')} is newer "
                f"than this loader ({FORMAT_VERSION})")
        program = torch.export.load(io.BytesIO(zf.read(_PROGRAM_ENTRY)))
    return ExportedScorer(program, manifest, device=device, **kw)


# ---------------------------------------------------------------------------
def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m shm_tpu_torch.export",
        description="Export trained artifacts to a standalone .shmx scoring "
                    "program (torch.export, the plain path, weights inside).")
    p.add_argument("--root", default=None,
                   help="4DOF-layout artifact root (shm_tpu_torch.cli.stage4dof)")
    p.add_argument("--openlab", default=None, metavar="ROOT",
                   help="openLAB artifact root instead of --root (exports "
                        "the CNN-stage-2 bridge pipeline; rank-4 "
                        "[clean, raw] requests)")
    p.add_argument("--out", required=True, help="output .shmx path")
    args = p.parse_args(argv)
    if (args.root is None) == (args.openlab is None):
        p.error("exactly one of --root / --openlab is required")

    # the plain path is traced on the CPU: load there, with no kernel
    if args.openlab is not None:
        from shm_tpu_torch.serve_openlab import OpenLabScorer

        scorer = OpenLabScorer.from_artifacts(args.openlab, device="cpu")
    else:
        from shm_tpu_torch.serve import HybridScorer

        scorer = HybridScorer.from_artifacts(args.root, device="cpu")
    out = save_exported_scorer(scorer, args.out)
    size_kb = out.stat().st_size / 1024
    print(f"[export] wrote {out} ({size_kb:.0f} KB, T={scorer.seq_len}, "
          f"torch {torch.__version__})")


if __name__ == "__main__":
    main()


__all__ = ["export_scorer", "save_exported_scorer", "load_exported_scorer",
           "ExportedScorer", "FORMAT_VERSION"]
