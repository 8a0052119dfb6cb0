"""4DOF stage CLI (counterpart of ``shm_tpu/cli/stage4dof.py``).

    python -m shm_tpu_torch.cli.stage4dof train-vae     --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof threshold     --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof train-cnn     --root data/4dof
    python -m shm_tpu_torch.cli.stage4dof test-pipeline --root data/4dof

Each command runs on the CUDA card unless given ``--device cpu``, and writes
the same artifacts under ``--root`` as the JAX CLI:

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

and their figures, which ``--no-plots`` turns off (no JSON depends on them).
On the card every VAE pass runs the fused kernel of the root's cell: the
gate-only mode for ``threshold``, the residual mode for ``train-cnn``'s
inputs and ``test-pipeline``; a preset the kernel does not take raises. Not
ported yet: data generation and splits (``gen-normal``, ``gen-faults``,
``make-splits``) and ``all``.
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
from shm_tpu_torch.device import resolve_device, set_full_f32_precision
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
                  kernel: Optional[bool] = None, device=None,
                  plot: bool = True):
    """Train the gate VAE on the normal runs' train fraction (statistics from
    that fraction only), select on the validation fraction, write the
    artifacts (and, with ``plot``, the loss curves). Returns the
    :class:`VAETrainResult`."""
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


def _device(device) -> torch.device:
    """The command's device; float32 matmuls and convolutions stay full
    float32 on the card (no TF32)."""
    device = resolve_device(device)
    if device.type == "cuda":
        set_full_f32_precision()
    return device


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

    device = _device(device)
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
                               fused=auto_fused_gate(device), device=device)
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
    vae_pass = make_vae_pass(vae, use_fused_vae=auto_fused_gate(Z.device))
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
                  plot: bool = True, device=None):
    """Train the attribution CNN (sensor 0 / structural 1) on the fault
    runs' train windows, select on their val windows, with the frozen VAE's
    residual as the second channel; write ``models/cnn.msgpack`` and the
    meta. Returns the :class:`CNNTrainResult`."""
    from shm_tpu_torch.train import train_cnn

    device = _device(device)
    sets = cnn_train_sets(paths, cfg, device)

    tcfg = cfg.cnn_train if epochs is None else replace(cfg.cnn_train, epochs=epochs)
    if seed is not None:
        tcfg = replace(tcfg, seed=seed)
    cnn = CNN4DOF(num_classes=cfg.cnn.num_classes, seq_len=cfg.seq_len,
                  num_features=cfg.num_features, dropout=cfg.cnn.dropout)
    res = train_cnn(cnn, *sets["train"], *sets["val"], tcfg, log_every=1,
                    device=device)

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

    device = _device(device)
    splits = load_json(paths.run_splits)
    mean, std = (torch.from_numpy(a).to(device) for a in _load_stats(paths))
    vae = _load_vae(paths, cfg).to(device)
    cnn = _load_cnn(paths, cfg).to(device)
    thr = load_json(paths.processed / "vae_threshold.json")["threshold"]
    hybrid = make_hybrid_fn(vae, cnn, use_fused_vae=auto_fused_gate(device))

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
                         "kernels (default: auto, on for CUDA)")
    ap.add_argument("--no-kernel", dest="kernel", action="store_false",
                    help="train-vae: force the plain autograd path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu to "
                         "run the plain path on the CPU)")
    args = ap.parse_args(argv)
    paths, cfg, plot = Paths(args.root), Stage4DofConfig(), not args.no_plots
    if args.command == "train-vae":
        cmd_train_vae(paths, cfg, args.epochs, seed=args.seed,
                      kernel=args.kernel, device=args.device, plot=plot)
    elif args.command == "threshold":
        cmd_threshold(paths, cfg, args.sample, plot=plot, device=args.device)
    elif args.command == "train-cnn":
        cmd_train_cnn(paths, cfg, args.epochs, seed=args.seed, plot=plot,
                      device=args.device)
    elif args.command == "test-pipeline":
        cmd_test_pipeline(paths, cfg, plot=plot, device=args.device)
    else:
        raise NotImplementedError(
            f"{args.command!r} is not ported yet (train-vae, threshold, "
            "train-cnn and test-pipeline are)")


__all__ = ["Paths", "build_fraction_windows", "build_fraction_windows_multi",
           "build_split_windows", "cnn_train_sets", "resolve_run_path", "cmd_train_vae",
           "cmd_threshold", "cmd_train_cnn", "cmd_test_pipeline", "main",
           "_load_vae", "_load_stats", "_load_cnn", "_cnn_inputs"]


if __name__ == "__main__":
    main()
