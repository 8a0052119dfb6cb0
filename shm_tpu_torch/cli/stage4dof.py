"""4DOF artifact loaders (counterpart of the loaders in ``shm_tpu/cli/stage4dof.py``).

Only what scoring needs: the artifact ``Paths``, the normalization stats, the
trained VAE, and the per-run time-fraction windows. The training and data
generation subcommands come with later slices.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from shm_tpu_torch.config import Stage4DofConfig, replace
from shm_tpu_torch.convert import vae_from_flax
from shm_tpu_torch.data.windows import make_windows_np, slice_frac
from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.utils.checkpoint import load_checkpoint
from shm_tpu_torch.utils.io import load_csv_numeric, load_json

# run_splits.json lists CSVs relative to the repository root
REPO_ROOT = Path(__file__).resolve().parents[2]


class Paths:
    def __init__(self, root: str):
        self.root = Path(root)
        self.raw_normal = self.root / "raw" / "normal"
        self.raw_sensor = self.root / "raw" / "faults" / "sensor_fault"
        self.raw_struct = self.root / "raw" / "faults" / "structural_fault"
        self.processed = self.root / "processed"
        self.models = self.root / "models"
        self.figures = self.root / "figures"

    @property
    def run_splits(self) -> Path:
        return self.processed / "run_splits.json"


def resolve_run_path(p: str) -> Path:
    """A path from ``run_splits.json``: absolute as given, else repo-relative."""
    path = Path(p)
    return path if path.is_absolute() else REPO_ROOT / path


def build_fraction_windows(files: List[str], frac,
                           cfg: Stage4DofConfig) -> np.ndarray:
    """Per-run time-fraction slice BEFORE windowing, windows of every run
    concatenated -> float32 (N, seq_len, num_features)."""
    out = []
    for fp in files:
        X = load_csv_numeric(resolve_run_path(fp), cfg.num_features)
        W = make_windows_np(slice_frac(X, frac), cfg.seq_len, cfg.stride)
        if W.shape[0]:
            out.append(W)
    if not out:
        return np.zeros((0, cfg.seq_len, cfg.num_features), np.float32)
    return np.concatenate(out).astype(np.float32)


def _load_vae(paths: Paths, cfg: Stage4DofConfig) -> TemporalVAE:
    """The trained VAE on the CPU. The cell family comes from the training
    meta manifest; only the LSTM cell is ported so far."""
    meta_path = paths.processed / "stage1_vae_train_meta.json"
    vcfg = cfg.vae
    if meta_path.exists():
        cell = load_json(meta_path).get("cell", "lstm")
        if cell != vcfg.cell:
            vcfg = replace(vcfg, cell=cell)
    if vcfg.cell != "lstm":
        raise NotImplementedError(
            f"{paths.root}: VAE cell {vcfg.cell!r} is not ported yet "
            f"(LSTM cell only)")
    tree = load_checkpoint(paths.models / "temporal_vae.msgpack")
    return vae_from_flax(tree["params"], vcfg)


def _load_stats(paths: Paths) -> Tuple[np.ndarray, np.ndarray]:
    d = np.load(paths.processed / "normal_stats.npz")
    mean = d["mean"].astype(np.float32)
    std = d["std"].astype(np.float32)
    std[std == 0] = 1e-6
    return mean, std


__all__ = ["Paths", "build_fraction_windows", "resolve_run_path",
           "_load_vae", "_load_stats"]
