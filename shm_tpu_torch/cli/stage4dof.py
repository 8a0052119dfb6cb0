"""4DOF stage CLI (counterpart of ``shm_tpu/cli/stage4dof.py``).

    python -m shm_tpu_torch.cli.stage4dof gen-normal    --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof gen-faults    --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof make-splits   --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof train-vae     --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof threshold     --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof train-cnn     --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof test-pipeline --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof all           --root data/4dof

Each command runs on the CUDA card unless given ``--device cpu``, and writes
the same artifacts under ``--root`` as the JAX CLI:

- ``gen-normal``: ``raw/normal/normal_seed{2025..2034}.csv``, the healthy
  runs (per-run mass and stiffness jitter and damping ratio from
  ``default_rng(base_seed)``, forces from numpy's seeded global RNG, all
  runs integrated at once on the device);
- ``gen-faults``: ``raw/faults/structural_fault/stiff_red_*pct/*.csv`` (the
  nominal system with scaled stiffness, 10-40 %, or with
  ``--legacy-faults`` the committed tree's 8-40 %) and
  ``raw/faults/sensor_fault/{noise_x4,spikes_x1,drift_x2,bias_x3}/*.csv``
  (the nominal run with one DOF's channels corrupted, keys
  ``fold_in(PRNGKey(42), i)`` as ``jax.random`` draws them);
- ``make-splits``: ``processed/run_splits.json``, every run's windows in
  contiguous 40/30/30 blocks, the runs named by their paths under
  ``--root`` as given (see :func:`resolve_run_path`);
- ``train-vae``: ``processed/{vae_mean,vae_std}.npy``,
  ``processed/normal_stats.npz``, ``models/temporal_vae.msgpack`` (flax
  layout, read by both packages), ``processed/stage1_vae_train_meta.json``;
- ``threshold``: ``processed/vae_threshold.json`` (the p99 of the healthy
  validation windows' MSE, and each group's score summary);
- ``train-cnn``: ``models/cnn.msgpack`` (flax layout) and
  ``processed/stage2_cnn_train_meta.json``;
- ``test-pipeline``: ``figures/pipeline_metrics.json``,
  ``figures/vae_gate_binary_metrics.json``,
  ``figures/hybrid_struct_vs_rest_metrics.json`` and
  ``figures/pipeline_classification_report.txt``;

and their figures, which ``--no-plots`` turns off (no JSON depends on them);
``all`` runs the seven in that order. The CSVs are the JAX CLI's: header
``x1..x4,v1..v4,a1..a4``, ``%.10g``. ``--cell`` picks the VAE family that
``train-vae`` trains (recorded in its meta; the later commands read it
there). On the card every VAE pass of ``threshold``, ``train-cnn`` and
``test-pipeline`` runs the fused kernel of the root's cell: the gate-only
mode for ``threshold``, the residual mode for ``train-cnn``'s inputs and
``test-pipeline``; a preset the kernel does not take raises.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from shm_tpu_torch.calibrate import percentile_threshold, summarize_scores
from shm_tpu_torch.config import Stage4DofConfig, replace
from shm_tpu_torch.convert import (
    cnn4dof_from_flax, cnn4dof_to_flax, vae_from_flax, vae_to_flax,
)
from shm_tpu_torch.data.windows import (
    compute_mean_std_from_windows, make_windows_np, normalize_windows,
    slice_frac,
)
from shm_tpu_torch.device import command_device
from shm_tpu_torch.evals import (
    accuracy, auc, average_precision_score, binary_prf,
    classification_report_dict, confusion_matrix, precision_recall_curve,
    precision_recall_fscore, roc_curve,
)
from shm_tpu_torch.models.cnn import CNN4DOF
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config
from shm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from shm_tpu_torch.utils.io import (
    ensure_dir, load_csv_numeric, load_json, save_json, save_npy,
)

CLASS_NAMES = ["Normal", "Sensor Fault", "Structural Fault"]

# the committed run_splits.json files list CSVs relative to the repository root
REPO_ROOT = Path(__file__).resolve().parents[2]
COLUMNS = ([f"x{j}" for j in range(1, 5)] + [f"v{j}" for j in range(1, 5)]
           + [f"a{j}" for j in range(1, 5)])


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
    """A run's path from ``run_splits.json``. ``make-splits`` writes them
    under ``--root`` as given, as the JAX command does: absolute for an
    absolute root, else relative to the working directory it ran in. An
    absolute path is taken as it is; a relative one relative to the working
    directory where the file is there (as the JAX readers take it), else to
    the repository root, which the committed roots' paths name. So a
    relative ``--root`` is found from the directory ``make-splits`` ran in
    and, if that was the repository root, from any directory."""
    path = Path(p)
    if path.is_absolute() or path.exists():
        return path
    return REPO_ROOT / path


def _write_run_csv(arr: np.ndarray, path: Path) -> None:
    ensure_dir(path.parent)
    np.savetxt(path, arr, delimiter=",", header=",".join(COLUMNS),
               comments="", fmt="%.10g")


# ---------------------------------------------------------------------------
# data generation
# ---------------------------------------------------------------------------

def _stiffness_label(scale: float) -> str:
    return f"stiff_red_{int(round((1.0 - scale) * 100))}pct"


def cmd_gen_normal(paths: Paths, cfg: Stage4DofConfig, plot: bool = True,
                   device=None) -> None:
    """The ``n_normal_runs`` healthy runs, seeds ``base_seed + i``: mass and
    stiffness jittered by U(jitter_lo, jitter_hi) and the damping ratio
    U(zeta_lo, zeta_hi), drawn from ``default_rng(base_seed)`` (mass, then
    stiffness, then zeta); each run's force from
    ``smoothed_gaussian_force_np`` seeded with its seed; all runs integrated
    in one batch on ``device``. Writes ``raw/normal/normal_seed{s}.csv``."""
    from shm_tpu_torch.sim import simulate_runs, smoothed_gaussian_force_np

    device = command_device(device)
    R, nd = cfg.n_normal_runs, cfg.system.num_dofs
    seeds = [cfg.base_seed + i for i in range(R)]
    rng = np.random.default_rng(cfg.base_seed)
    mass = np.array(cfg.system.mass) * rng.uniform(cfg.jitter_lo, cfg.jitter_hi, (R, nd))
    stiff = np.array(cfg.system.stiffness) * rng.uniform(cfg.jitter_lo, cfg.jitter_hi, (R, nd))
    zeta = rng.uniform(cfg.zeta_lo, cfg.zeta_hi, R)
    forces = np.stack([
        smoothed_gaussian_force_np(cfg.system.t_total, cfg.system.dt, nd,
                                   cfg.normal_force_rms, s) for s in seeds])
    t0 = time.perf_counter()
    runs = simulate_runs(mass, stiff, zeta, forces, cfg.system,
                         device=device).cpu().numpy()
    print(f"[sim] {R} normal runs in {time.perf_counter() - t0:.2f}s "
          f"(batched Newmark steps on {device})")
    for s, run in zip(seeds, runs):
        _write_run_csv(run, paths.raw_normal / f"normal_seed{s}.csv")
        print(f"[OK] normal run saved: raw/normal/normal_seed{s}.csv")
    if plot:
        from shm_tpu_torch.report import plot_stacked_channels

        t = np.arange(runs.shape[1]) * cfg.system.dt
        plot_stacked_channels(
            t, {f"x{j + 1} [m]": runs[0][:, j] for j in range(nd)},
            paths.figures, f"normal_run_seed{seeds[0]}_displacement_stacked")


def _remove_other_regime(paths: Paths, cfg: Stage4DofConfig,
                         labels: List[str]) -> None:
    """A root generated again under the other regime would mix the two in
    ``make-splits``: remove the structural case directories of the other
    KNOWN regime, and keep (with a warning) any other ``stiff_red_*``
    directory, which may be a user's own case."""
    import shutil

    if not paths.raw_struct.exists():
        return
    f = cfg.faults
    known = {_stiffness_label(s) for s in
             tuple(f.stiffness_scales) + tuple(f.legacy_stiffness_scales)}
    for d in sorted(paths.raw_struct.iterdir()):
        if not (d.is_dir() and d.name.startswith("stiff_red_")
                and d.name not in labels):
            continue
        if d.name in known:
            shutil.rmtree(d)
            print(f"[OK] removed stale structural case from the other "
                  f"regime: {d.name}")
        else:
            print(f"[WARN] unrecognized structural case dir kept: "
                  f"{d.name} (not in either known regime; remove it "
                  f"manually if it should not feed make-splits)")


def cmd_gen_faults(paths: Paths, cfg: Stage4DofConfig, plot: bool = True,
                   legacy: bool = False, device=None) -> None:
    """The fault runs, all from the nominal system and one force
    (``force_rms``, ``force_seed``): structural faults simulated again with
    the stiffness scaled by each of ``stiffness_scales`` (with ``legacy``,
    ``legacy_stiffness_scales``), in one batch with the nominal run; sensor
    faults the nominal run with the x, v, a channels of one DOF corrupted
    (``SENSOR_FAULT_CASES``, key ``fold_in(PRNGKey(force_seed), i)`` for
    case i), on ``device``. Writes the CSVs."""
    from shm_tpu_torch.sim import (
        SENSOR_FAULT_CASES, inject_sensor_fault_triplet, prng, simulate_runs,
        smoothed_gaussian_force_np,
    )

    device = command_device(device)
    f, nd = cfg.faults, cfg.system.num_dofs
    force = smoothed_gaussian_force_np(cfg.system.t_total, cfg.system.dt, nd,
                                       f.force_rms, f.force_seed)
    base_m = np.array(cfg.system.mass)
    base_k = np.array(cfg.system.stiffness)
    scales = np.array((1.0,) + tuple(f.legacy_stiffness_scales if legacy
                                     else f.stiffness_scales))
    S = len(scales)
    t0 = time.perf_counter()
    runs_d = simulate_runs(
        np.tile(base_m, (S, 1)), base_k[None] * scales[:, None],
        np.full(S, cfg.system.damping_ratio), np.tile(force[None], (S, 1, 1)),
        cfg.system, device=device)
    nominal_d = runs_d[0]
    runs = runs_d.cpu().numpy()
    print(f"[sim] nominal + {S - 1} structural runs in "
          f"{time.perf_counter() - t0:.2f}s (batched Newmark steps on {device})")

    labels = [_stiffness_label(s) for s in scales[1:]]
    _remove_other_regime(paths, cfg, labels)
    for label, run in zip(labels, runs[1:]):
        _write_run_csv(run, paths.raw_struct / label / f"{label}.csv")
        print(f"[OK] structural fault saved: {label}")

    key = prng.PRNGKey(f.force_seed)
    rel = {"noise": f.noise_rel_mag, "spikes": f.spikes_rel_mag,
           "drift": f.drift_rel_mag, "bias": f.bias_rel_mag}
    sensor = {}
    for i, (name, kind, dof, _) in enumerate(SENSOR_FAULT_CASES):
        run = inject_sensor_fault_triplet(
            prng.fold_in(key, i), nominal_d, kind, dof, rel[kind],
            num_dofs=nd, spikes_freq=f.spikes_freq).cpu().numpy()
        _write_run_csv(run, paths.raw_sensor / name / f"{name}.csv")
        sensor[name] = run
        print(f"[OK] sensor fault saved: {name} (target=x{dof})")

    if plot:
        from shm_tpu_torch.report import plot_reconstruction_overlay

        nominal = runs[0]
        t = np.arange(nominal.shape[0]) * cfg.system.dt
        disp = lambda r: {f"x{j + 1} [m]": r[:, j] for j in range(nd)}
        for label, run in zip(labels, runs[1:]):
            plot_reconstruction_overlay(
                t, disp(nominal), disp(run),
                paths.figures / "faults" / "structural_fault" / label,
                f"{label}_normal_vs_structural_fault_displacement_stacked",
                labels=("Normal", "Structural fault"))
        for name, run in sensor.items():
            plot_reconstruction_overlay(
                t, disp(nominal), disp(run),
                paths.figures / "faults" / "sensor_fault" / name,
                f"{name}_normal_vs_sensor_fault_displacement_stacked",
                labels=("Normal", "Sensor fault"))


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------

def _count_rows_csv(path: Path) -> int:
    with open(path, "r", encoding="utf-8", errors="ignore") as fh:
        return max(sum(1 for _ in fh) - 1, 0)


def _scan(dirpath: Path) -> List[Tuple[str, int]]:
    return [(p.as_posix(), _count_rows_csv(p)) for p in sorted(dirpath.rglob("*.csv"))]


def cmd_make_splits(paths: Paths, cfg: Stage4DofConfig) -> Dict:
    """``processed/run_splits.json`` of every CSV under ``raw/`` (returned).
    Every ``stiff_red_*`` directory there is a structural run, whatever its
    name: ``gen-faults`` warns of one it does not know."""
    from shm_tpu_torch.data.splits import make_run_splits_json

    doc = make_run_splits_json(
        _scan(paths.raw_normal), _scan(paths.raw_sensor), _scan(paths.raw_struct),
        seq_len=cfg.seq_len, stride=cfg.stride)
    save_json(doc, paths.run_splits)
    print(f"[OK] wrote: {paths.run_splits}")
    print(f"[OK] totals: {doc['totals']}")
    return doc


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
                  kernel: Optional[bool] = None, device=None,
                  plot: bool = True, devices: Optional[int] = None):
    """Train the gate VAE on the normal runs' train fraction (statistics from
    that fraction only), select on the validation fraction, write the
    artifacts (and, with ``plot``, the loss curves). The family is
    ``cfg.vae.cell``, written into the meta; an LSTM trains on the card
    through the training kernels (``kernel``), the other cells on the plain
    autograd path. ``devices`` > 1 trains data-parallel over that many
    devices of ``device``'s type (``parallel.make_mesh_opt``), on the plain
    path. Returns the :class:`VAETrainResult`."""
    from shm_tpu_torch.parallel import make_mesh_opt
    from shm_tpu_torch.train import train_vae

    device = command_device(device)
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
    mesh = make_mesh_opt(devices, device=device)
    if mesh is not None:
        print(f"[INFO] data-parallel training over {mesh.size} devices")
    res = train_vae(vae, Ztr, Zva, tcfg, log_every=1, use_kernel=kernel,
                    device=device, mesh=mesh)

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
    if plot:
        from shm_tpu_torch.report import plot_loss_curves

        plot_loss_curves(res.history, paths.figures, "vae_training_curves")
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


# ---------------------------------------------------------------------------
# threshold
# ---------------------------------------------------------------------------

def cmd_threshold(paths: Paths, cfg: Stage4DofConfig, sample: bool = False,
                  plot: bool = True, device=None) -> Dict:
    """The gate threshold: the ``cfg.threshold_percentile`` percentile of the
    healthy validation windows' reconstruction MSE, with each group's score
    summary, into ``processed/vae_threshold.json`` (returned).

    The three groups are scored in one pass: on the card through the
    gate-only mode of the fused kernel of the VAE's cell. ``sample=True``
    scores sampled reconstructions instead, noise from a ``torch.Generator``
    seeded 0 on the device (the plain model: the kernel is deterministic).
    """
    from shm_tpu_torch.ops import auto_fused_gate
    from shm_tpu_torch.train import reconstruction_mse

    device = command_device(device)
    splits = load_json(paths.run_splits)
    mean, std = _load_stats(paths)
    vae = _load_vae(paths, cfg)

    frac = cfg.val_frac
    Wn, Ws, Wst = (build_fraction_windows(
        splits.get(g, {}).get("files", []), frac, cfg)
        for g in ("normal", "sensor_fault", "structural_fault"))
    if Wn.shape[0] == 0:
        raise RuntimeError("No normal windows for threshold fit.")

    Wall = np.concatenate([Wn, Ws, Wst])
    Zall = normalize_windows(torch.from_numpy(Wall).to(device),
                             torch.from_numpy(mean).to(device),
                             torch.from_numpy(std).to(device))
    gen = torch.Generator(device=device).manual_seed(0)
    s_all = reconstruction_mse(vae, Zall, sample=sample, generator=gen,
                               fused=auto_fused_gate(vae, device), device=device)
    n, n_s = Wn.shape[0], Ws.shape[0]
    s_n, s_s, s_st = s_all[:n], s_all[n:n + n_s], s_all[n + n_s:]
    thr = percentile_threshold(s_n, cfg.threshold_percentile)

    out = {
        "threshold": thr,
        "percentile": cfg.threshold_percentile,
        "window_len": cfg.seq_len,
        "stride": cfg.stride,
        "fit_data": f"normal fraction {tuple(frac)} only",
        "score_def": "full_window_mse_mean_over_time_and_features",
        "healthy_frac": list(frac),
        "n_val_windows_normal": int(s_n.size),
        "n_val_windows_sensor": int(s_s.size),
        "n_val_windows_structural": int(s_st.size),
        "seed": cfg.vae_train.seed,
        "stochastic_eval": bool(sample),
        "score_summary": {
            "normal_val": summarize_scores(s_n),
            "sensor_val": summarize_scores(s_s),
            "structural_val": summarize_scores(s_st),
        },
    }
    save_json(out, paths.processed / "vae_threshold.json")

    if plot:
        from shm_tpu_torch.report import plot_pr_curve, plot_roc, plot_score_hist

        groups = {"Normal": s_n, "Sensor Fault": s_s, "Structural Fault": s_st}
        plot_score_hist(groups, thr, paths.figures, "vae_scores_hist_linear")
        plot_score_hist(groups, thr, paths.figures, "vae_scores_hist_logx",
                        log_x=True)
        if s_s.size + s_st.size:
            y = np.r_[np.zeros_like(s_n), np.ones(s_s.size + s_st.size)]
            fpr, tpr, _ = roc_curve(y, s_all)
            plot_roc({"VAE gate": (fpr, tpr, auc(fpr, tpr))}, paths.figures,
                     "vae_gate_roc_curve")
            prec, rec, _ = precision_recall_curve(y, s_all)
            plot_pr_curve(prec, rec, average_precision_score(y, s_all),
                          paths.figures, "vae_gate_pr_curve",
                          "VAE Gate (Normal vs Fault)")
    print(f"[OK] Threshold saved: {thr:.6f} (p{cfg.threshold_percentile:g} of "
          f"{s_n.size} healthy-val windows)")
    return out


# ---------------------------------------------------------------------------
# CNN training
# ---------------------------------------------------------------------------

def build_split_windows(group: Dict, split: str, cfg: Stage4DofConfig) -> np.ndarray:
    """The windows of one split, by ``run_splits.json``'s window indices."""
    out = []
    for fp in group["files"]:
        idx = group["window_indices"][fp][split]
        if not idx:
            continue
        X = load_csv_numeric(resolve_run_path(fp), cfg.num_features)
        out.append(make_windows_np(X, cfg.seq_len, cfg.stride)[np.asarray(idx)])
    if not out:
        return np.zeros((0, cfg.seq_len, cfg.num_features), np.float32)
    return np.concatenate(out).astype(np.float32)


@torch.no_grad()
def _cnn_inputs(vae: TemporalVAE, Z: torch.Tensor,
                batch: int = 4096) -> torch.Tensor:
    """2-channel [Z, residual^2] NHWC inputs from one pass of the frozen VAE
    (posterior mean), in batches, on ``Z``'s device: on the card the
    residual mode of the fused kernel of the VAE's cell, on the CPU the
    plain model."""
    from shm_tpu_torch.ops import auto_fused_gate
    from shm_tpu_torch.pipeline import make_vae_pass

    vae.to(Z.device).eval()
    vae_pass = make_vae_pass(vae, use_fused_vae=auto_fused_gate(vae, Z.device))
    outs = [vae_pass(zb)[1] for zb in Z.split(batch)]
    return torch.cat(outs) if outs else Z.new_zeros(tuple(Z.shape) + (2,))


def cnn_train_sets(paths: Paths, cfg: Stage4DofConfig, device) -> Dict:
    """The CNN's train and val sets, ``{split: (inputs, labels)}``: the fault
    runs' windows of the split (sensor 0, structural 1) in the JAX CLI's
    fixed shuffle, through :func:`_cnn_inputs` on ``device``."""
    splits = load_json(paths.run_splits)
    mean, std = (torch.from_numpy(a).to(device) for a in _load_stats(paths))
    vae = _load_vae(paths, cfg)
    sets = {}
    for split in ("train", "val"):
        Ws = build_split_windows(splits["sensor_fault"], split, cfg)
        Wt = build_split_windows(splits["structural_fault"], split, cfg)
        Z = normalize_windows(torch.from_numpy(np.concatenate([Ws, Wt])).to(device),
                              mean, std)
        y = np.r_[np.zeros(len(Ws), np.int64), np.ones(len(Wt), np.int64)]
        perm = np.random.RandomState(cfg.cnn_train.seed).permutation(len(y))
        sets[split] = (_cnn_inputs(vae, Z[torch.from_numpy(perm).to(device)]),
                       y[perm])
        print(f"[INFO] {split}: sensor={len(Ws)} structural={len(Wt)}")
    return sets


def cmd_train_cnn(paths: Paths, cfg: Stage4DofConfig,
                  epochs: Optional[int] = None, seed: Optional[int] = None,
                  plot: bool = True, device=None,
                  devices: Optional[int] = None):
    """Train the attribution CNN (sensor 0 / structural 1) on the fault
    runs' train windows, select on their val windows, with the frozen VAE's
    residual as the second channel; write ``models/cnn.msgpack`` and the
    meta. ``devices`` > 1 trains data-parallel (BatchNorm over the whole
    batch). Returns the :class:`CNNTrainResult`."""
    from shm_tpu_torch.parallel import make_mesh_opt
    from shm_tpu_torch.train import train_cnn

    device = command_device(device)
    sets = cnn_train_sets(paths, cfg, device)

    tcfg = cfg.cnn_train if epochs is None else replace(cfg.cnn_train, epochs=epochs)
    if seed is not None:
        tcfg = replace(tcfg, seed=seed)
    cnn = CNN4DOF(num_classes=cfg.cnn.num_classes, seq_len=cfg.seq_len,
                  num_features=cfg.num_features, dropout=cfg.cnn.dropout)
    mesh = make_mesh_opt(devices, device=device)
    if mesh is not None:
        print(f"[INFO] data-parallel training over {mesh.size} devices")
    res = train_cnn(cnn, *sets["train"], *sets["val"], tcfg, log_every=1,
                    device=device, mesh=mesh)

    save_checkpoint(cnn4dof_to_flax(res.variables, cfg.seq_len, cfg.num_features),
                    paths.models / "cnn.msgpack")
    meta = {
        "seed": tcfg.seed, "epochs": tcfg.epochs, "batch_size": tcfg.batch_size,
        "lr": tcfg.lr, "weight_decay": tcfg.weight_decay,
        "early_stop_patience": tcfg.early_stop_patience,
        "best_val_ce": res.best_val, "best_epoch": res.best_epoch,
        "stopped_epoch": res.stopped_epoch, "train_seconds": res.seconds,
        "input_def": "stack([Z, (Z - Z_hat)^2], channel-last), frozen best-val VAE",
        "labels": {"sensor_fault": 0, "structural_fault": 1},
    }
    save_json(meta, paths.processed / "stage2_cnn_train_meta.json")
    if plot:
        from shm_tpu_torch.report import plot_loss_curves

        plot_loss_curves(res.history, paths.figures, "cnn_training_curves",
                         keys=(("train_loss", "Train"), ("val_loss", "Val")))
    print(f"[OK] saved: models/cnn.msgpack (best epoch {res.best_epoch}, "
          f"val CE {res.best_val:.6f}, {res.seconds:.1f}s)")
    return res


# ---------------------------------------------------------------------------
# full pipeline test
# ---------------------------------------------------------------------------

def _load_cnn(paths: Paths, cfg: Stage4DofConfig) -> CNN4DOF:
    return cnn4dof_from_flax(load_checkpoint(paths.models / "cnn.msgpack"),
                             cfg.cnn.num_classes, cfg.seq_len, cfg.num_features)


def cmd_test_pipeline(paths: Paths, cfg: Stage4DofConfig, plot: bool = True,
                      device=None) -> Dict:
    """The hybrid (gate, then attribution) on every run's test fraction
    against the ground truth: the 3-class confusion matrix and report, the
    gate's binary metrics (normal vs fault) and the hybrid's
    structural-vs-rest metrics, into ``figures/`` (the metrics dict is
    returned). On the card the VAE pass is the fused kernel of the root's
    cell."""
    from shm_tpu_torch.ops import auto_fused_gate
    from shm_tpu_torch.pipeline import make_hybrid_fn, run_hybrid_batched

    device = command_device(device)
    splits = load_json(paths.run_splits)
    mean, std = (torch.from_numpy(a).to(device) for a in _load_stats(paths))
    vae = _load_vae(paths, cfg).to(device)
    cnn = _load_cnn(paths, cfg).to(device)
    thr = load_json(paths.processed / "vae_threshold.json")["threshold"]
    hybrid = make_hybrid_fn(vae, cnn, use_fused_vae=auto_fused_gate(vae, device))

    groups = [("normal", 0, "normal/test"), ("sensor_fault", 1, "sensor/test"),
              ("structural_fault", 2, "struct/test")]
    group_W, group_meta = [], []
    for gname, gt, tag in groups:
        W = build_fraction_windows(splits[gname]["files"], cfg.test_frac, cfg)
        if W.shape[0] == 0:
            print(f"[WARN] {tag}: no test windows")
            continue
        group_W.append(W)
        group_meta.append((gt, tag, W.shape[0]))
    if not group_W:
        raise RuntimeError("No test windows in any group.")
    n_windows = sum(n for _, _, n in group_meta)

    t0 = time.perf_counter()
    out = run_hybrid_batched(hybrid, np.concatenate(group_W), mean, std,
                             torch.tensor(thr, dtype=torch.float32, device=device))
    infer_seconds = time.perf_counter() - t0

    y_true = np.concatenate([np.full(n, gt, np.int64) for gt, _, n in group_meta])
    y_pred = out["y_pred"].astype(np.int64)
    gate_scores = out["mse"]
    gate_labels = (y_true != 0).astype(np.int64)
    hyb_scores = out["p_struct"]
    hyb_labels = (y_true == 2).astype(np.int64)

    gate_stats: Dict[str, Dict[str, float]] = {}
    ofs = 0
    for gt, tag, n in group_meta:
        anom = int(out["anomalous"][ofs:ofs + n].sum())
        ofs += n
        gate_stats[tag] = {"anom": float(anom), "total": float(n),
                           "anom_rate": float(anom / n)}
        print(f"[gate] {tag}: anom_rate={anom / n:.3f} (anom={anom}/{n})")

    acc = accuracy(y_true, y_pred)
    cm = confusion_matrix(y_true, y_pred, 3)
    print(f"[RESULT] 3-class window accuracy: {acc:.4f}")
    print("[CM] rows=GT (Normal, Sensor Fault, Structural Fault); cols=Pred")
    print(cm)
    prf = precision_recall_fscore(y_true, y_pred, 3)
    for i, name in enumerate(CLASS_NAMES):
        print(f"  - {name:18s}: P={prf['precision'][i]:.4f} | "
              f"R={prf['recall'][i]:.4f} | F1={prf['fscore'][i]:.4f} | "
              f"N={int(prf['support'][i])}")
    print(f"[PRF] Macro avg        : P={prf['macro'][0]:.4f} | "
          f"R={prf['macro'][1]:.4f} | F1={prf['macro'][2]:.4f}")

    report = classification_report_dict(y_true, y_pred, CLASS_NAMES)
    ensure_dir(paths.figures)
    (paths.figures / "pipeline_classification_report.txt").write_text(
        "\n".join(f"{k}: {v}" for k, v in report.items()), encoding="utf-8")

    two_classes = lambda labels: np.unique(labels).size == 2
    gate_metrics: Dict[str, float] = {}
    if two_classes(gate_labels):
        gate_metrics["average_precision"] = average_precision_score(
            gate_labels, gate_scores)
        gate_metrics.update(binary_prf(gate_labels,
                                       (gate_scores > thr).astype(np.int64)))
    hybrid_metrics: Dict[str, float] = {}
    if two_classes(hyb_labels):
        hybrid_metrics["average_precision"] = average_precision_score(
            hyb_labels, hyb_scores)
        hybrid_metrics.update(binary_prf(hyb_labels,
                                         (hyb_scores >= 0.5).astype(np.int64)))
    roc_both: Dict[str, float] = {}
    if two_classes(gate_labels) and two_classes(hyb_labels):
        gf, gtp, _ = roc_curve(gate_labels, gate_scores)
        hf, htp, _ = roc_curve(hyb_labels, hyb_scores)
        roc_both = {"gate_auroc": auc(gf, gtp), "hybrid_auroc": auc(hf, htp)}

    if plot:
        from shm_tpu_torch.report import plot_cm_row_norm, plot_pr_curve, plot_roc

        plot_cm_row_norm(cm, CLASS_NAMES, paths.figures,
                         "pipeline_confusion_matrix_row_normalized")
        if gate_metrics:
            gprec, grec, _ = precision_recall_curve(gate_labels, gate_scores)
            plot_pr_curve(gprec, grec, gate_metrics["average_precision"],
                          paths.figures, "vae_gate_pr_curve",
                          "VAE Gate (Normal vs Fault)")
        if hybrid_metrics:
            hprec, hrec, _ = precision_recall_curve(hyb_labels, hyb_scores)
            plot_pr_curve(hprec, hrec, hybrid_metrics["average_precision"],
                          paths.figures, "hybrid_struct_vs_rest_pr_curve",
                          "Hybrid (Structural vs Rest)")
        if roc_both:
            plot_roc({"VAE gate": (gf, gtp, roc_both["gate_auroc"]),
                      "Hybrid struct-vs-rest": (hf, htp, roc_both["hybrid_auroc"])},
                     paths.figures, "roc_gate_vs_hybrid")

    metrics = {
        "accuracy": acc,
        "confusion_matrix_counts": cm.tolist(),
        "gate": {
            "threshold_mse": float(thr),
            "score_def": "full_window_mse_mean_over_time_and_features",
            "frac_range": list(cfg.test_frac),
            "gate_stats": gate_stats,
            **roc_both,
            **gate_metrics,
        },
        "hybrid_struct_vs_rest": {
            "definition": "Structural Fault (positive) vs {Normal, Sensor Fault}",
            "score": "p_struct (CNN softmax on anomalies; 0 otherwise)",
            **hybrid_metrics,
        },
        "window_len": cfg.seq_len,
        "stride": cfg.stride,
        "seed": cfg.vae_train.seed,
        "throughput": {
            "n_windows": int(n_windows),
            "seconds": infer_seconds,
            "windows_per_sec": n_windows / infer_seconds if infer_seconds else None,
        },
    }
    save_json(metrics, paths.figures / "pipeline_metrics.json")
    save_json(metrics["gate"], paths.figures / "vae_gate_binary_metrics.json")
    save_json(metrics["hybrid_struct_vs_rest"],
              paths.figures / "hybrid_struct_vs_rest_metrics.json")
    print(f"[OK] wrote: figures/pipeline_metrics.json ({n_windows} windows in "
          f"{infer_seconds:.2f}s = {n_windows / infer_seconds:,.0f} win/s)")
    return metrics



_COMMANDS = ("gen-normal", "gen-faults", "make-splits", "train-vae",
             "threshold", "train-cnn", "test-pipeline", "all")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="4DOF stage pipeline (PyTorch port)")
    ap.add_argument("command", choices=_COMMANDS)
    ap.add_argument("--root", default="data/4dof")
    ap.add_argument("--epochs", type=int, default=None,
                    help="train-vae / train-cnn: override the number of epochs")
    ap.add_argument("--seed", type=int, default=None,
                    help="train-vae / train-cnn: override the training seed")
    ap.add_argument("--no-plots", action="store_true",
                    help="draw no figures (no JSON artifact depends on them)")
    ap.add_argument("--sample", action="store_true",
                    help="threshold: score sampled reconstructions (noise "
                         "from a generator seeded 0) instead of the "
                         "posterior mean")
    ap.add_argument("--kernel", dest="kernel", action="store_true", default=None,
                    help="train-vae: force the hand-written LSTM training "
                         "kernels (default: auto, on for an LSTM on CUDA)")
    ap.add_argument("--no-kernel", dest="kernel", action="store_false",
                    help="train-vae: force the plain autograd path")
    ap.add_argument("--devices", type=int, default=None,
                    help="train-vae / train-cnn: data-parallel training over "
                         "the first N devices (a CPU mesh of N shards with "
                         "--device cpu); the batch is split, the gradients "
                         "summed, the trajectory one device's up to the "
                         "order of float sums; train-vae then runs the plain "
                         "autograd path")
    ap.add_argument("--cell", choices=["lstm", "min_gru", "attention"],
                    default="lstm",
                    help="train-vae: the VAE family (recorded in its meta; "
                         "threshold, train-cnn and test-pipeline read it "
                         "there). min_gru and attention are opt-in presets, "
                         "not the reference-parity model, and train on the "
                         "plain autograd path")
    ap.add_argument("--legacy-faults", action="store_true",
                    help="gen-faults: the committed tree's structural regime "
                         "(stiff_red_{8,9,18,19,30,40}pct) instead of 10-40%%")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu to "
                         "run the plain path on the CPU)")
    args = ap.parse_args(argv)
    paths, cfg, plot = Paths(args.root), Stage4DofConfig(), not args.no_plots
    if args.cell != "lstm":
        cfg = replace(cfg, vae=replace(cfg.vae, cell=args.cell))
    dev = args.device
    steps = {
        "gen-normal": lambda: cmd_gen_normal(paths, cfg, plot, device=dev),
        "gen-faults": lambda: cmd_gen_faults(paths, cfg, plot,
                                             legacy=args.legacy_faults,
                                             device=dev),
        "make-splits": lambda: cmd_make_splits(paths, cfg),
        "train-vae": lambda: cmd_train_vae(paths, cfg, args.epochs,
                                           seed=args.seed, kernel=args.kernel,
                                           device=dev, plot=plot,
                                           devices=args.devices),
        "threshold": lambda: cmd_threshold(paths, cfg, args.sample, plot=plot,
                                           device=dev),
        "train-cnn": lambda: cmd_train_cnn(paths, cfg, args.epochs,
                                           seed=args.seed, plot=plot, device=dev,
                                           devices=args.devices),
        "test-pipeline": lambda: cmd_test_pipeline(paths, cfg, plot=plot,
                                                   device=dev),
    }
    if args.command == "all":
        for name in _COMMANDS[:-1]:
            print(f"\n===== {name} =====")
            steps[name]()
    else:
        steps[args.command]()


__all__ = ["Paths", "build_fraction_windows", "build_fraction_windows_multi",
           "build_split_windows", "cnn_train_sets", "resolve_run_path",
           "cmd_gen_normal", "cmd_gen_faults", "cmd_make_splits", "cmd_train_vae",
           "cmd_threshold", "cmd_train_cnn", "cmd_test_pipeline", "main",
           "_load_vae", "_load_stats", "_load_cnn", "_cnn_inputs"]


if __name__ == "__main__":
    main()
