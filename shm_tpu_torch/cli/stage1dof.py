"""1-DOF stage CLI (counterpart of ``shm_tpu/cli/stage1dof.py``).

    python -m shm_tpu_torch.cli.stage1dof gen-seen      --root data/1dof
    python -m shm_tpu_torch.cli.stage1dof gen-unseen    --root data/1dof
    python -m shm_tpu_torch.cli.stage1dof train-vae     --root data/1dof
    python -m shm_tpu_torch.cli.stage1dof test-seen     --root data/1dof
    python -m shm_tpu_torch.cli.stage1dof test-unseen   --root data/1dof
    python -m shm_tpu_torch.cli.stage1dof compare-rmse  --root data/1dof
    python -m shm_tpu_torch.cli.stage1dof all           --root data/1dof

Each command runs on the CUDA card unless given ``--device cpu``, and writes
the same artifacts under ``--root`` as the JAX CLI, with the same columns in
the same order, each value as pandas writes it:

- ``gen-seen``: ``raw/1dof_seen_variants.csv``, the free vibration of the
  oscillator (Newmark on the device) and its drifted, amplitude-scaled and
  time-stretched variants, 3,001 rows of ``time`` and 12 channels;
- ``gen-unseen``: ``raw/1dof_unseen_variants.csv``, four analytic
  displacements and their velocities and accelerations by differences;
- ``train-vae``: ``processed/{split.json, vae_mean.npy, vae_std.npy}`` (the
  statistics of the seen series' first half), ``models/temporal_vae.msgpack``
  (flax layout, read by both packages: the LAST epoch's parameters, as the
  reference keeps them) and ``tables/training/training_losses.csv``. An LSTM
  trains on the card through the hand-written training kernels; ``--cell
  min_gru`` / ``attention`` train on plain autograd, the cell recorded in
  ``split.json``;
- ``test-seen`` / ``test-unseen``: the seen series' second half, or the whole
  unseen series, standardized, windowed, reconstructed in one forward of the
  VAE (z = mu; the cell read from ``split.json``, ``lstm`` where it names
  none), overlap-averaged back into a series:
  ``tables/reconstruction_{seen,unseen}/{reconstruction_series,segment_rmse}.csv``;
- ``compare-rmse``: ``figures/rmse_comparison/rmse_summary_stats.csv`` (mean,
  median, std with ddof 1, min and max of each set's segment RMSE);

and their figures, which ``--no-plots`` turns off (no table depends on them);
``all`` runs the six in that order.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from shm_tpu_torch.config import Stage1DofConfig, replace
from shm_tpu_torch.convert import vae_from_flax, vae_to_flax
from shm_tpu_torch.data.windows import (
    compute_standardizer, destandardize, make_windows, segment_rmse,
    standardize, stitch_windows,
)
from shm_tpu_torch.device import command_device
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config
from shm_tpu_torch.sim.signals import SEEN_COLUMNS, UNSEEN_COLUMNS
from shm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from shm_tpu_torch.utils.io import (
    load_csv_columns, load_json, save_csv_columns, save_json, save_npy,
)

VARIANT_NAMES_SEEN = ["Original", "Drifted", "Upscaled Amplitude", "Low-Frequency"]
VARIANT_NAMES_UNSEEN = ["Sinusoid", "Envelope", "Triangle", "Square"]
# variant k is channels [k, 4+k, 8+k] (x / v / a interleaved by variant)
VARIANT_COLS = [[0, 4, 8], [1, 5, 9], [2, 6, 10], [3, 7, 11]]
COMMANDS = ("gen-seen", "gen-unseen", "train-vae", "test-seen", "test-unseen",
            "compare-rmse")


class Paths:
    def __init__(self, root: str):
        self.root = Path(root)
        self.raw = self.root / "raw"
        self.processed = self.root / "processed"
        self.models = self.root / "models"
        self.figures = self.root / "figures"
        self.tables = self.root / "tables"


def build_variant_window_labels(windows: np.ndarray) -> np.ndarray:
    """Each window's variant: the argmax over variants of its energy on the
    variant's three channels."""
    if windows.shape[2] < 12:
        raise ValueError(f"Expected >= 12 channels, got {windows.shape[2]}")
    E = np.stack([(windows[:, :, c] ** 2).sum(axis=(1, 2)) for c in VARIANT_COLS],
                 axis=1)
    return np.argmax(E, axis=1).astype(np.int64)


def _load_series(path: Path):
    """(time as float64, the channels as float32 (T, F), their names)."""
    cols = load_csv_columns(path)
    names = [c for c in cols if c != "time"]
    return (cols["time"], np.stack([cols[c] for c in names], 1).astype(np.float32),
            names)


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

def _write_variants(paths: Paths, name: str, t: torch.Tensor,
                    variants: Dict[str, torch.Tensor], columns: Sequence[str],
                    plot: bool, kind: str) -> None:
    cols = {"time": t.cpu().numpy()}
    cols.update((c, variants[c].cpu().numpy()) for c in columns)
    save_csv_columns(cols, paths.raw / name)
    print(f"[OK] wrote raw/{name} ({len(cols['time'])} rows, {len(columns)} channels)")
    if plot:
        from shm_tpu_torch.report import plot_stacked_channels

        for qty in ("x", "v", "a"):
            plot_stacked_channels(cols["time"], {c: cols[c] for c in columns
                                                 if c.startswith(qty)},
                                  paths.figures / "variants",
                                  f"{kind}_variants_{qty}_stacked")


def cmd_gen_seen(paths: Paths, cfg: Stage1DofConfig, plot: bool = True,
                 device=None) -> None:
    """The oscillator's free vibration and its seen variants on ``device``."""
    from shm_tpu_torch.sim import make_clean_variants, simulate_free_vibration_sdof

    device = command_device(device)
    t, x, v, a = simulate_free_vibration_sdof(cfg.sdof, device=device)
    var = make_clean_variants(t, x, v, a, cfg.drift_rate, cfg.amp_scale,
                              cfg.lowfreq_factor)
    _write_variants(paths, "1dof_seen_variants.csv", t, var, SEEN_COLUMNS,
                    plot, "seen")


def cmd_gen_unseen(paths: Paths, cfg: Stage1DofConfig, plot: bool = True,
                   device=None) -> None:
    """The unseen analytic variants on ``device``, on the oscillator's float32
    time grid."""
    from shm_tpu_torch.sim import make_unseen_variants

    device = command_device(device)
    p = cfg.sdof
    t = torch.from_numpy(np.arange(0.0, p.t_total + p.dt, p.dt,
                                   dtype=np.float32)).to(device)
    var = make_unseen_variants(t, cfg.unseen_amplitude, cfg.unseen_base_freq_hz)
    _write_variants(paths, "1dof_unseen_variants.csv", t, var, UNSEEN_COLUMNS,
                    plot, "unseen")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_windows(paths: Paths, cfg: Stage1DofConfig, device):
    """(windows of the standardized first ``train_frac`` of the seen series
    on ``device``, the series' length, the split index, mean, std)."""
    _, data, _ = _load_series(paths.raw / "1dof_seen_variants.csv")
    T = data.shape[0]
    split = int(cfg.train_frac * T)
    x = torch.from_numpy(data[:split]).to(device)
    mean, std = compute_standardizer(x)
    W = make_windows(standardize(x, mean, std), cfg.seq_len, cfg.stride)
    return W.contiguous(), T, split, mean, std


def cmd_train_vae(paths: Paths, cfg: Stage1DofConfig,
                  epochs: Optional[int] = None, plot: bool = True, device=None,
                  devices: Optional[int] = None):
    """Train the VAE on the windows of the seen series' first half, with the
    first tenth of them as the validation set of the history, and save the
    last epoch's parameters. ``devices`` > 1 trains data-parallel
    (``parallel.make_mesh_opt``) on the plain autograd path. Returns the
    :class:`VAETrainResult`."""
    from shm_tpu_torch.parallel import make_mesh_opt
    from shm_tpu_torch.train import train_vae

    device = command_device(device)
    W, T, split, mean, std = train_windows(paths, cfg, device)
    save_json({"T": int(T), "split_index": int(split),
               "train_frac": float(cfg.train_frac), "cell": cfg.vae.cell},
              paths.processed / "split.json")
    save_npy(mean.cpu().numpy(), paths.processed / "vae_mean.npy")
    save_npy(std.cpu().numpy(), paths.processed / "vae_std.npy")
    print(f"[INFO] train windows: {tuple(W.shape)}")

    tcfg = cfg.train if epochs is None else replace(cfg.train, epochs=epochs)
    model = vae_from_config(cfg.vae)
    mesh = make_mesh_opt(devices, device=device)
    if mesh is not None:
        print(f"[INFO] data-parallel training over {mesh.size} devices")
    res = train_vae(model, W, W[: max(len(W) // 10, 1)], tcfg, log_every=10,
                    use_kernel=None, device=device, mesh=mesh)
    save_checkpoint({"params": vae_to_flax(res.last_params)},
                    paths.models / "temporal_vae.msgpack")
    h = res.history
    save_csv_columns({"epoch": h["epoch"], "loss_total": h["train_total"],
                      "loss_recon": h["train_recon"], "loss_kl": h["train_kl"],
                      "kl_weight": h["kl_w"]},
                     paths.tables / "training" / "training_losses.csv")
    print(f"[OK] saved model + training_losses.csv ({res.seconds:.1f}s)")

    if plot:
        from shm_tpu_torch.report import plot_latent_pca, plot_loss_curves

        plot_loss_curves(h, paths.figures / "training", "training_curves",
                         keys=(("train_total", "Total"), ("train_recon", "Reconstruction"),
                               ("train_kl", "KL")))
        plot_latent_pca(_encode_mu(model, W), build_variant_window_labels(W.cpu().numpy()),
                        VARIANT_NAMES_SEEN, paths.figures / "training",
                        "latent_pca_by_variant")
    return res


@torch.no_grad()
def _encode_mu(model: TemporalVAE, W: torch.Tensor, batch: int = 2048) -> np.ndarray:
    model.eval()
    return torch.cat([model.encode(w)[0] for w in W.split(batch)]).cpu().numpy()


def _load_model(paths: Paths, cfg: Stage1DofConfig) -> TemporalVAE:
    """The trained VAE on the CPU, of the cell ``split.json`` names (``lstm``
    where it names none, as the committed file does)."""
    split_meta = paths.processed / "split.json"
    vcfg = cfg.vae
    if split_meta.exists():
        cell = load_json(split_meta).get("cell", "lstm")
        if cell != vcfg.cell:
            vcfg = replace(vcfg, cell=cell)
    tree = load_checkpoint(paths.models / "temporal_vae.msgpack")
    return vae_from_flax(tree["params"], vcfg)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _eval_series(paths: Paths, cfg: Stage1DofConfig, csv_name: str, tag: str,
                 use_split: bool, label_names, plot: bool, device=None) -> np.ndarray:
    """Windows -> one forward of the VAE (z = mu) -> overlap-average ->
    destandardize -> segment RMSE, on ``device``; ``use_split`` takes the
    series from the split index on (``test-seen``), else all of it. Writes
    the two tables; returns the segment RMSEs."""
    device = command_device(device)
    time_s, data, cols = _load_series(paths.raw / csv_name)
    if use_split:
        start = int(cfg.train_frac * data.shape[0])
        time_s, data = time_s[start:], data[start:]

    mean = torch.from_numpy(np.load(paths.processed / "vae_mean.npy")).to(device)
    std = torch.from_numpy(np.load(paths.processed / "vae_std.npy")).to(device)
    x = torch.from_numpy(data).to(device)
    Z = standardize(x, mean, std)
    W = make_windows(Z, cfg.seq_len, cfg.stride).contiguous()

    model = _load_model(paths, cfg).to(device).eval()
    with torch.no_grad():
        recon, mu, _ = model(W)                      # one forward of every window
    recon_series = destandardize(stitch_windows(recon, Z.shape[0], cfg.stride),
                                 mean, std)
    rmses = segment_rmse(x, recon_series, cfg.segment_len).cpu().numpy()
    recon_np = recon_series.cpu().numpy()

    out_tab = paths.tables / f"reconstruction_{tag}"
    table = {"time": time_s}
    for j, c in enumerate(cols):
        table[c] = data[:, j]
        table[c + "_recon"] = recon_np[:, j]
    save_csv_columns(table, out_tab / "reconstruction_series.csv")
    save_csv_columns({"segment_index": np.arange(len(rmses)), "rmse": rmses},
                     out_tab / "segment_rmse.csv")
    print(f"[OK] {tag}: {W.shape[0]} windows, {len(rmses)} segments, "
          f"mean RMSE {rmses.mean():.6f}")

    if plot:
        from shm_tpu_torch.report import (
            plot_latent_pca, plot_reconstruction_overlay, plot_segment_rmse,
        )

        out_fig = paths.figures / f"reconstruction_{tag}"
        x_cols = [c for c in cols if c.startswith("x_")]
        plot_reconstruction_overlay(time_s, {c: table[c] for c in x_cols},
                                    {c: table[c + "_recon"] for c in x_cols},
                                    out_fig, "x_measured_vs_reconstructed_stacked")
        plot_segment_rmse({tag: rmses}, out_fig, "segment_rmse_curve")
        plot_latent_pca(mu.cpu().numpy(), build_variant_window_labels(W.cpu().numpy()),
                        label_names, out_fig, "latent_pca_by_type")
    return rmses


def cmd_test_seen(paths: Paths, cfg: Stage1DofConfig, plot: bool = True,
                  device=None) -> np.ndarray:
    return _eval_series(paths, cfg, "1dof_seen_variants.csv", "seen", True,
                        VARIANT_NAMES_SEEN, plot, device)


def cmd_test_unseen(paths: Paths, cfg: Stage1DofConfig, plot: bool = True,
                    device=None) -> np.ndarray:
    return _eval_series(paths, cfg, "1dof_unseen_variants.csv", "unseen", False,
                        VARIANT_NAMES_UNSEEN, plot, device)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def cmd_compare_rmse(paths: Paths, cfg: Stage1DofConfig, plot: bool = True) -> Dict:
    """Each set's segment-RMSE summary into ``rmse_summary_stats.csv``
    (returned as ``{stat: [seen, unseen]}``), on the host in float64."""
    sets = {name: load_csv_columns(paths.tables / f"reconstruction_{tag}"
                                   / "segment_rmse.csv")["rmse"]
            for name, tag in (("Seen", "seen"), ("Unseen", "unseen"))}
    r = list(sets.values())
    summary = {
        "Set": list(sets),
        "Mean": [x.mean() for x in r],
        "Median": [np.median(x) for x in r],
        "Std": [x.std(ddof=1) for x in r],
        "Min": [x.min() for x in r],
        "Max": [x.max() for x in r],
    }
    out_dir = paths.figures / "rmse_comparison"
    save_csv_columns(summary, out_dir / "rmse_summary_stats.csv")
    for i, name in enumerate(sets):
        print(f"{name:>6}: " + ", ".join(f"{k} {v[i]:.6g}" for k, v in summary.items()
                                         if k != "Set"))
    if plot:
        from shm_tpu_torch.report import plot_rmse_box, plot_segment_rmse

        plot_segment_rmse(sets, out_dir, "rmse_line_seen_vs_unseen")
        plot_rmse_box(sets, out_dir, "rmse_boxplot_seen_vs_unseen")
    return summary


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="1-DOF stage pipeline (PyTorch port)")
    ap.add_argument("command", choices=COMMANDS + ("all",))
    ap.add_argument("--root", default="data/1dof")
    ap.add_argument("--epochs", type=int, default=None,
                    help="train-vae: override the number of epochs")
    ap.add_argument("--no-plots", action="store_true",
                    help="draw no figures (no table depends on them)")
    ap.add_argument("--cell", choices=["lstm", "min_gru", "attention"],
                    default="lstm",
                    help="train-vae: the VAE family (recorded in split.json; "
                         "the eval commands read it there). min_gru and "
                         "attention are opt-in presets, not the "
                         "reference-parity model, and train on the plain "
                         "autograd path")
    ap.add_argument("--devices", type=int, default=None,
                    help="train-vae: data-parallel training over the first N "
                         "devices (a CPU mesh of N shards with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu to "
                         "run the plain path on the CPU)")
    args = ap.parse_args(argv)

    cfg = Stage1DofConfig()
    if args.cell != "lstm":
        cfg = replace(cfg, vae=replace(cfg.vae, cell=args.cell))
    paths, plot, dev = Paths(args.root), not args.no_plots, args.device
    steps = {
        "gen-seen": lambda: cmd_gen_seen(paths, cfg, plot, device=dev),
        "gen-unseen": lambda: cmd_gen_unseen(paths, cfg, plot, device=dev),
        "train-vae": lambda: cmd_train_vae(paths, cfg, args.epochs, plot,
                                           device=dev, devices=args.devices),
        "test-seen": lambda: cmd_test_seen(paths, cfg, plot, device=dev),
        "test-unseen": lambda: cmd_test_unseen(paths, cfg, plot, device=dev),
        "compare-rmse": lambda: cmd_compare_rmse(paths, cfg, plot),
    }
    if args.command == "all":
        for name in COMMANDS:
            print(f"\n===== {name} =====")
            steps[name]()
    else:
        steps[args.command]()


__all__ = ["Paths", "COMMANDS", "VARIANT_NAMES_SEEN", "VARIANT_NAMES_UNSEEN",
           "VARIANT_COLS", "build_variant_window_labels", "train_windows",
           "cmd_gen_seen", "cmd_gen_unseen", "cmd_train_vae", "cmd_test_seen",
           "cmd_test_unseen", "cmd_compare_rmse", "main", "_encode_mu",
           "_load_model", "_eval_series"]


if __name__ == "__main__":
    main()
