"""4DOF stage CLI (counterpart of ``shm_tpu/cli/stage4dof.py``).

    python -m shm_tpu_torch.cli.stage4dof train-vae --root data/4dof

Ported so far: the artifact loaders scoring needs (``Paths``, the
normalization stats, the trained VAE, the per-run time-fraction windows) and
the ``train-vae`` subcommand, which writes the same artifacts under ``--root``
as the JAX CLI: ``processed/{vae_mean,vae_std}.npy``,
``processed/normal_stats.npz``, ``models/temporal_vae.msgpack`` (flax layout,
read by both packages) and ``processed/stage1_vae_train_meta.json``. The
loss-curve plot and the other subcommands (data generation, splits, threshold,
CNN training, test pipeline) are not ported yet.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from shm_tpu_torch.config import Stage4DofConfig, replace
from shm_tpu_torch.convert import vae_from_flax, vae_to_flax
from shm_tpu_torch.data.windows import (
    compute_mean_std_from_windows, make_windows_np, normalize_windows,
    slice_frac,
)
from shm_tpu_torch.device import resolve_device
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config
from shm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from shm_tpu_torch.utils.io import (
    load_csv_numeric, load_json, save_json, save_npy,
)

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


def build_fraction_windows_multi(files: List[str], fracs,
                                 cfg: Stage4DofConfig) -> List[np.ndarray]:
    """Per-run time-fraction slices BEFORE windowing, for SEVERAL fractions
    with one CSV parse per run; the windows of every run concatenated ->
    one float32 (N, seq_len, num_features) stack per fraction."""
    outs: List[List[np.ndarray]] = [[] for _ in fracs]
    for fp in files:
        X = load_csv_numeric(resolve_run_path(fp), cfg.num_features)
        for out, frac in zip(outs, fracs):
            W = make_windows_np(slice_frac(X, frac), cfg.seq_len, cfg.stride)
            if W.shape[0]:
                out.append(W)
    return [np.concatenate(o).astype(np.float32) if o else
            np.zeros((0, cfg.seq_len, cfg.num_features), np.float32)
            for o in outs]


def build_fraction_windows(files: List[str], frac,
                           cfg: Stage4DofConfig) -> np.ndarray:
    """Single-fraction wrapper over :func:`build_fraction_windows_multi`."""
    return build_fraction_windows_multi(files, (frac,), cfg)[0]


def cmd_train_vae(paths: Paths, cfg: Stage4DofConfig,
                  epochs: Optional[int] = None, seed: Optional[int] = None,
                  kernel: Optional[bool] = None, device=None):
    """Train the gate VAE on the normal runs' train fraction (statistics from
    that fraction only), select on the validation fraction, write the
    artifacts. Returns the :class:`VAETrainResult`."""
    from shm_tpu_torch.train import train_vae

    device = resolve_device(device)
    normal_files = load_json(paths.run_splits)["normal"]["files"]
    Wtr, Wva = build_fraction_windows_multi(
        normal_files, (cfg.train_frac, cfg.val_frac), cfg)
    print(f"[INFO] normal windows train/val = {Wtr.shape[0]}/{Wva.shape[0]}")
    if not Wtr.shape[0] or not Wva.shape[0]:
        raise RuntimeError("No normal train/val windows under "
                           f"{paths.root}: generate runs and splits first.")

    Wtr_t = torch.from_numpy(Wtr).to(device)
    mean, std = compute_mean_std_from_windows(Wtr_t)
    mean_np, std_np = mean.cpu().numpy(), std.cpu().numpy()
    save_npy(mean_np, paths.processed / "vae_mean.npy")
    save_npy(std_np, paths.processed / "vae_std.npy")
    np.savez(paths.processed / "normal_stats.npz", mean=mean_np, std=std_np)

    Ztr = normalize_windows(Wtr_t, mean, std)
    Zva = normalize_windows(torch.from_numpy(Wva).to(device), mean, std)

    tcfg = cfg.vae_train if epochs is None else replace(cfg.vae_train, epochs=epochs)
    if seed is not None:
        tcfg = replace(tcfg, seed=seed)
    vae = vae_from_config(cfg.vae)
    res = train_vae(vae, Ztr, Zva, tcfg, log_every=1, use_kernel=kernel,
                    device=device)

    save_checkpoint({"params": vae_to_flax(res.params)},
                    paths.models / "temporal_vae.msgpack")
    meta = {
        "seed": tcfg.seed, "window_len": cfg.seq_len, "stride": cfg.stride,
        "train_frac": list(cfg.train_frac), "val_frac": list(cfg.val_frac),
        "epochs": tcfg.epochs, "batch_size": tcfg.batch_size,
        "latent_dim": cfg.vae.latent_dim, "hidden_dim": cfg.vae.hidden_dim,
        "num_layers": cfg.vae.num_layers, "dropout": cfg.vae.dropout,
        "cell": cfg.vae.cell,
        "kl_warmup_ratio": tcfg.kl_warmup_ratio,
        "best_val_total": res.best_val, "best_epoch": res.best_epoch,
        "train_seconds": res.seconds,
        "protocol": "fraction slicing before windowing; stats from normal/train "
                    "fraction only; VAE trained on normal/train fraction only.",
    }
    save_json(meta, paths.processed / "stage1_vae_train_meta.json")
    print(f"[OK] saved: models/temporal_vae.msgpack (best epoch {res.best_epoch}, "
          f"val {res.best_val:.6f}, {res.seconds:.1f}s)")
    return res


def _load_vae(paths: Paths, cfg: Stage4DofConfig) -> TemporalVAE:
    """The trained VAE on the CPU. The trainer records the cell family in its
    meta manifest, so scoring needs no ``--cell``; a checkpoint of another
    family than the manifest names raises ``ValueError`` and never loads."""
    meta_path = paths.processed / "stage1_vae_train_meta.json"
    vcfg = cfg.vae
    if meta_path.exists():
        cell = load_json(meta_path).get("cell", "lstm")
        if cell != vcfg.cell:
            vcfg = replace(vcfg, cell=cell)
    tree = load_checkpoint(paths.models / "temporal_vae.msgpack")
    try:
        return vae_from_flax(tree["params"], vcfg)
    except ValueError as e:
        raise ValueError(f"{paths.models / 'temporal_vae.msgpack'}: {e} "
                         f"(cell from {meta_path.name} or the config)") from e


def _load_stats(paths: Paths) -> Tuple[np.ndarray, np.ndarray]:
    d = np.load(paths.processed / "normal_stats.npz")
    mean = d["mean"].astype(np.float32)
    std = d["std"].astype(np.float32)
    std[std == 0] = 1e-6
    return mean, std


_COMMANDS = ("gen-normal", "gen-faults", "make-splits", "train-vae",
             "threshold", "train-cnn", "test-pipeline", "all")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="4DOF stage pipeline (PyTorch port)")
    ap.add_argument("command", choices=_COMMANDS)
    ap.add_argument("--root", default="data/4dof")
    ap.add_argument("--epochs", type=int, default=None,
                    help="train-vae: override the number of epochs")
    ap.add_argument("--seed", type=int, default=None,
                    help="train-vae: override the training seed")
    ap.add_argument("--kernel", dest="kernel", action="store_true", default=None,
                    help="train-vae: force the hand-written LSTM training "
                         "kernels (default: auto, on for CUDA)")
    ap.add_argument("--no-kernel", dest="kernel", action="store_false",
                    help="train-vae: force the plain autograd path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu to "
                         "run the plain path on the CPU)")
    args = ap.parse_args(argv)
    if args.command != "train-vae":
        raise NotImplementedError(
            f"{args.command!r} is not ported yet (train-vae only)")
    cmd_train_vae(Paths(args.root), Stage4DofConfig(), args.epochs,
                  seed=args.seed, kernel=args.kernel, device=args.device)


__all__ = ["Paths", "build_fraction_windows", "build_fraction_windows_multi",
           "resolve_run_path", "cmd_train_vae", "main", "_load_vae",
           "_load_stats"]


if __name__ == "__main__":
    main()
