"""openLAB (TU Dresden bridge) stage CLI (counterpart of
``shm_tpu/cli/openlab.py``).

    python -m shm_tpu_torch.cli.openlab make-splits  --root data/openlab
    python -m shm_tpu_torch.cli.openlab featurize    --root data/openlab
    python -m shm_tpu_torch.cli.openlab train-vae    --root data/openlab
    python -m shm_tpu_torch.cli.openlab validate-vae --root data/openlab
    python -m shm_tpu_torch.cli.openlab train-cnn    --root data/openlab
    python -m shm_tpu_torch.cli.openlab validate-cnn --root data/openlab [--split val|test]
    python -m shm_tpu_torch.cli.openlab train-ml     --root data/openlab
    python -m shm_tpu_torch.cli.openlab validate-ml  --root data/openlab
    python -m shm_tpu_torch.cli.openlab test-hybrid  --root data/openlab [--host-ml]
    python -m shm_tpu_torch.cli.openlab plots        --root data/openlab

Each command reads and writes the JAX CLI's artifacts under ``--root``:
``extracted/{X_clean.npy,X_raw.npy,window_labels.csv,run_split.json}``,
``features/{X_feat.npy,y.npy,meta_used.csv,feat_names.json}``,
``output/<Experiment>/...`` (the same JSON keys; the CSVs as pandas writes
them, without pandas). Every command runs on the CUDA card unless given
``--device cpu``. On the card:

- ``validate-vae`` and ``test-hybrid`` score the gate through the gate-only
  mode of the fused kernel of the VAE's cell (one launch each; the cell
  comes from the VAE manifest);
- ``train-vae`` trains the 1-layer VAE on the plain autograd path, as the
  JAX command trains it on XLA (the LSTM training kernels take 2-layer
  stacks);
- the CNN runs cuDNN's convolutions with TF32 off;
- ``validate-ml`` and ``test-hybrid`` score the five classical models from
  their export files (``<name>.export.npz``, ``models/ml.py``), which need
  neither sklearn nor joblib; ``--host-ml`` calls sklearn's own
  ``predict_proba`` instead. ``train-ml`` needs sklearn and joblib and
  writes each export beside its joblib.

Not ported: ``extract`` and ``all``, which parse the raw catman exports
(``MD_*.txt``, not in the repository; ROADMAP.md Queue 1 item 7b), and
``--devices`` (item 9). ``--no-plots`` draws no figure (no JSON depends on
one); ``--seed`` overrides the seed of ``train-vae`` / ``train-cnn``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from shm_tpu_torch.calibrate import percentile_threshold, tune_threshold_st_first
from shm_tpu_torch.config import OpenLabConfig, default_openlab_raw_dir, replace
from shm_tpu_torch.convert import (
    cnn_openlab_from_flax, cnn_openlab_to_flax, vae_from_flax, vae_to_flax,
)
from shm_tpu_torch.data.features import (
    FEATURE_LABEL_MAP, feature_names, featurize_windows,
)
from shm_tpu_torch.device import command_device
from shm_tpu_torch.evals import (
    accuracy, binary_prf, confusion_matrix, roc_auc_score,
)
from shm_tpu_torch.models.cnn import CNNOpenLab
from shm_tpu_torch.models.ml import ml_predictor
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config
from shm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from shm_tpu_torch.utils.io import (
    ensure_dir, load_csv_table, load_json, save_csv_columns, save_csv_records,
    save_json, save_npy,
)

LABEL_NORMAL = "Normal"
LABEL_SENSOR_FAULT = "Sensor Fault"
LABEL_STRUCT_FAULT = "Structural Fault"
LABELS_3 = [LABEL_NORMAL, LABEL_SENSOR_FAULT, LABEL_STRUCT_FAULT]
CHANNELS_IDX = [1, 2, 3]   # LWA_2/3/4; the DMS channel is not gated
NOT_PORTED = "ROADMAP.md Queue 1 item 7b: the catman parser, cleaning and labels"


class Paths:
    def __init__(self, root: str, raw_dir: str = ""):
        self.root = Path(root)
        self.raw_dir = raw_dir
        self.extracted = self.root / "extracted"
        self.features = self.root / "features"
        self.output = self.root / "output"
        self.vae_dir = self.output / "VAE_Training"
        self.vae_val_dir = self.output / "VAE_Validation_and_Thresholding"
        self.cnn_dir = self.output / "CNN_Training"
        self.cnn_val_dir = self.output / "CNN_Validation"
        self.ml_dir = self.output / "ML_Baselines"
        self.hybrid_dir = self.output / "Hybrid_Pipeline"


def standardize_clip(X: np.ndarray, mu: np.ndarray, sd: np.ndarray,
                     clip_z: float) -> np.ndarray:
    """(X - mu) / sd, clipped to +-clip_z, non-finite values to 0."""
    Xn = (X - mu[None, None, :]) / sd[None, None, :]
    Xn = np.clip(Xn, -clip_z, clip_z)
    return np.nan_to_num(Xn, nan=0.0, posinf=0.0, neginf=0.0).astype(np.float32)


def _load_extracted(paths: Paths):
    """(X_clean, X_raw, the window table's columns)."""
    Xc = np.load(paths.extracted / "X_clean.npy").astype(np.float32)
    Xr = np.load(paths.extracted / "X_raw.npy").astype(np.float32)
    meta = load_csv_table(paths.extracted / "window_labels.csv")
    n = len(meta["label"])
    if n != Xc.shape[0] or n != Xr.shape[0]:
        raise ValueError("Meta rows must match window tensors.")
    return Xc, Xr, meta


def _in_runs(meta: Dict[str, np.ndarray], runs) -> np.ndarray:
    return np.isin(meta["run_id"].astype(str), list(map(str, runs)))


def _labels(meta: Dict[str, np.ndarray]) -> np.ndarray:
    return meta["label"].astype(str)


# ---------------------------------------------------------------------------
# splits and features
# ---------------------------------------------------------------------------

def cmd_make_splits(paths: Paths, cfg: OpenLabConfig,
                    min_normal_windows: int = 200) -> Dict:
    """``extracted/run_split.json``: the runs split train/val/test
    (``data/splits.py::run_based_split``), with each split's normal windows
    counted; too few normals raise."""
    from shm_tpu_torch.data.splits import run_based_split

    _, _, meta = _load_extracted(paths)
    runs = list(dict.fromkeys(meta["run_id"].astype(str).tolist()))
    split = run_based_split(runs, seed=cfg.seed, train_frac=cfg.train_frac,
                            val_frac=cfg.val_frac)
    normal = _labels(meta) == LABEL_NORMAL
    nN = {k: int((_in_runs(meta, v) & normal).sum()) for k, v in split.items()}
    if nN["train"] < min_normal_windows or nN["val"] < max(50, min_normal_windows // 4):
        raise RuntimeError(
            f"Insufficient Normal windows: train={nN['train']}, val={nN['val']}. "
            "Fix: change TRAIN_FRAC/VAL_FRAC or reduce min_normal_windows.")
    out = {
        "seed": cfg.seed,
        "fractions": {"train_frac": cfg.train_frac, "val_frac": cfg.val_frac,
                      "test_frac": cfg.test_frac},
        "train_runs": split["train"],
        "val_runs": split["val"],
        "test_runs": split["test"],
        "counts": {
            "n_runs": len(runs),
            "n_train_runs": len(split["train"]),
            "n_val_runs": len(split["val"]),
            "n_test_runs": len(split["test"]),
            "n_normal_train": nN["train"],
            "n_normal_val": nN["val"],
            "n_normal_test": nN["test"],
        },
    }
    save_json(out, paths.extracted / "run_split.json")
    print(f"[OK] run_split.json: {out['counts']}")
    return out


def cmd_featurize(paths: Paths, cfg: OpenLabConfig, include_freq: bool = True,
                  drop_sensor_fault: bool = False) -> None:
    """``features/``: the 76 features of every raw window (``X_feat.npy``),
    the feature path's labels (``y.npy``), the window table of the rows
    kept (``meta_used.csv``) and the feature names."""
    _, Xr, meta = _load_extracted(paths)
    if drop_sensor_fault:
        keep = _labels(meta) != LABEL_SENSOR_FAULT
        Xr, meta = Xr[keep], {k: v[keep] for k, v in meta.items()}
    t0 = time.perf_counter()
    X_feat = featurize_windows(Xr, include_freq=include_freq)
    y = np.array([FEATURE_LABEL_MAP[l] for l in _labels(meta)], np.int64)
    ensure_dir(paths.features)
    save_npy(X_feat, paths.features / "X_feat.npy")
    save_npy(y, paths.features / "y.npy")
    save_csv_columns(meta, paths.features / "meta_used.csv")
    chans = ["DMS_1", "LWA_2", "LWA_3", "LWA_4"]
    save_json({"feat_names": feature_names(chans, include_freq),
               "label_map": FEATURE_LABEL_MAP},
              paths.features / "feat_names.json")
    print(f"[OK] X_feat: {X_feat.shape} in {time.perf_counter() - t0:.2f}s")


# ---------------------------------------------------------------------------
# the VAE gate
# ---------------------------------------------------------------------------

def cmd_train_vae(paths: Paths, cfg: OpenLabConfig, epochs: Optional[int] = None,
                  seed: Optional[int] = None, device=None, plot: bool = True):
    """Train the gate VAE on the training runs' normal windows (gate
    channels, standardized by their own nan-aware statistics, clipped) and
    save the LAST parameters, as the reference does (it has no validation
    split). The curves' second series is the first tenth of the training
    set itself, so its keys are ``train_subset_*``. Plain autograd on every
    device (the JAX command trains on XLA). Returns the result."""
    from shm_tpu_torch.train import train_vae

    device = command_device(device)
    Xc, _, meta = _load_extracted(paths)
    split = load_json(paths.extracted / "run_split.json")
    mask = _in_runs(meta, split["train_runs"]) & (_labels(meta) == LABEL_NORMAL)
    Xtr = Xc[mask][:, :, CHANNELS_IDX]
    if Xtr.shape[0] < 200:
        raise ValueError(f"Too few TRAIN normal windows: {Xtr.shape[0]}.")

    mu = np.nanmean(Xtr, axis=(0, 1)).astype(np.float32)
    sd = np.nanstd(Xtr, axis=(0, 1)).astype(np.float32)
    sd = np.where(sd < 1e-12, 1.0, sd).astype(np.float32)
    art = ensure_dir(paths.vae_dir / "artifacts")
    save_npy(mu, art / "vae_clean_mean.npy")
    save_npy(sd, art / "vae_clean_std.npy")

    Z = standardize_clip(Xtr, mu, sd, cfg.standardize_clip)
    tcfg = cfg.vae_train if epochs is None else replace(cfg.vae_train, epochs=epochs)
    if seed is not None:
        tcfg = replace(tcfg, seed=seed)
    model = vae_from_config(cfg.vae)
    res = train_vae(model, Z, Z[: max(len(Z) // 10, 1)], tcfg, log_every=10,
                    use_kernel=False, device=device)
    for k in ("total", "recon", "kl"):
        res.history[f"train_subset_{k}"] = res.history.pop(f"val_{k}")
    save_checkpoint({"params": vae_to_flax(res.last_params)},
                    art / "vae_exceedance_clean.msgpack")

    manifest = {
        "seed": cfg.seed,
        "seq_len": cfg.seq_len,
        "channels_idx": CHANNELS_IDX,
        "normalization": {"clip_z": cfg.standardize_clip,
                          "mean_path": str(art / "vae_clean_mean.npy"),
                          "std_path": str(art / "vae_clean_std.npy")},
        "model": {"input_dim": len(CHANNELS_IDX), "latent_dim": cfg.vae.latent_dim,
                  "hidden_dim": cfg.vae.hidden_dim, "num_layers": cfg.vae.num_layers,
                  "dropout": cfg.vae.dropout, "cell": cfg.vae.cell},
        "optimizer": {"name": "Adam", "lr": tcfg.lr,
                      "weight_decay": tcfg.weight_decay,
                      "max_grad_norm": tcfg.grad_clip},
        "train": {"batch_size": tcfg.batch_size, "epochs": tcfg.epochs,
                  "train_normals": int(Z.shape[0]), "label_normal": LABEL_NORMAL,
                  "train_seconds": res.seconds},
    }
    save_json(manifest, art / "vae_clean_manifest.json")
    if plot:
        from shm_tpu_torch.report import plot_loss_curves

        plot_loss_curves(res.history, paths.vae_dir / "plots", "vae_train_loss",
                         keys=(("train_total", "Train"),
                               ("train_subset_total", "Train subset (first 10%)")))
    print(f"[OK] VAE trained on {Z.shape[0]} normals ({res.seconds:.1f}s); "
          f"manifest + checkpoint under {art}")
    return res


def _load_openlab_vae(paths: Paths, cfg: OpenLabConfig
                      ) -> Tuple[TemporalVAE, np.ndarray, np.ndarray, Dict]:
    """(the trained VAE on the CPU, mean, std, manifest); the cell family
    and widths come from the manifest."""
    art = paths.vae_dir / "artifacts"
    manifest = load_json(art / "vae_clean_manifest.json")
    mc = manifest["model"]
    vcfg = replace(cfg.vae, input_dim=mc["input_dim"], latent_dim=mc["latent_dim"],
                   hidden_dim=mc["hidden_dim"], num_layers=mc["num_layers"],
                   dropout=mc["dropout"], cell=mc.get("cell", "lstm"))
    ckpt = art / "vae_exceedance_clean.msgpack"
    try:
        vae = vae_from_flax(load_checkpoint(ckpt)["params"], vcfg)
    except ValueError as e:
        raise ValueError(f"{ckpt}: {e} (cell from the manifest)") from e
    mu = np.load(art / "vae_clean_mean.npy").astype(np.float32)
    sd = np.load(art / "vae_clean_std.npy").astype(np.float32)
    return vae, mu, sd, manifest


def _gate_mse(vae: TemporalVAE, Z: np.ndarray, device) -> np.ndarray:
    """Per-window reconstruction MSE: on the card one launch of the
    gate-only mode of the cell's fused kernel, on the CPU the plain model."""
    from shm_tpu_torch.train import reconstruction_mse

    return reconstruction_mse(vae, Z, batch_size=2048, fused="auto",
                              device=device)


def cmd_validate_vae(paths: Paths, cfg: OpenLabConfig, device=None,
                     plot: bool = True) -> Dict:
    """The gate threshold: the ``threshold_percentile`` percentile of the
    validation runs' normal windows' MSE, with each class's rate above it,
    into ``vae_threshold.json`` (returned)."""
    device = command_device(device)
    Xc, _, meta = _load_extracted(paths)
    split = load_json(paths.extracted / "run_split.json")
    vae, mu, sd, manifest = _load_openlab_vae(paths, cfg)
    ch_idx = list(map(int, manifest["channels_idx"]))

    val_runs = set(map(str, split["val_runs"]))
    vmask = _in_runs(meta, val_runs)
    Xv = standardize_clip(Xc[vmask][:, :, ch_idx], mu, sd, cfg.standardize_clip)
    labels = _labels(meta)[vmask]

    mse = _gate_mse(vae, Xv, device)
    mseN = mse[labels == LABEL_NORMAL]
    mseE = mse[labels == LABEL_STRUCT_FAULT]
    mseSF = mse[labels == LABEL_SENSOR_FAULT]
    if mseN.size < 50:
        raise RuntimeError(f"Too few VAL normals: {mseN.size}")

    thr = percentile_threshold(mseN, cfg.threshold_percentile)
    result = {
        "threshold": thr,
        "threshold_source": f"P{cfg.threshold_percentile:g} of VAL normals",
        "percentile": cfg.threshold_percentile,
        "val_runs": sorted(val_runs),
        "n_val_windows": int(mse.size),
        "n_val_normal": int(mseN.size),
        "n_val_struct": int(mseE.size),
        "n_val_sensor": int(mseSF.size),
        "normal_fpr_at_threshold": float((mseN > thr).mean()),
        "struct_tpr_at_threshold": float((mseE > thr).mean()) if mseE.size else None,
        "sensor_rate_above_threshold": float((mseSF > thr).mean()) if mseSF.size else None,
    }
    art = ensure_dir(paths.vae_val_dir / "artifacts")
    save_json(result, art / "vae_threshold.json")
    if plot:
        from shm_tpu_torch.report import plot_score_hist

        plot_score_hist({"Normal": mseN, "Structural Fault": mseE,
                         "Sensor Fault": mseSF}, thr, paths.vae_val_dir / "plots",
                        "vae_val_mse_histogram")
    print(f"[OK] threshold={thr:.6f} | normal FPR={result['normal_fpr_at_threshold']:.4f} "
          f"| struct TPR={result['struct_tpr_at_threshold']}")
    return result


# ---------------------------------------------------------------------------
# the CNN
# ---------------------------------------------------------------------------

def _sf_st_split_data(Xr, meta, split, split_name: str):
    """The raw windows of a split's sensor and structural faults, with
    SF = 0, ST = 1."""
    lab = _labels(meta)
    keep = (_in_runs(meta, split[f"{split_name}_runs"])
            & np.isin(lab, [LABEL_SENSOR_FAULT, LABEL_STRUCT_FAULT]))
    return Xr[keep], (lab[keep] == LABEL_STRUCT_FAULT).astype(np.int32)


def _tune_st_first(cfg: OpenLabConfig, p_st: np.ndarray, y: np.ndarray) -> Dict:
    """The stage's one ST-first threshold policy (grid and precision floor
    from ``cfg``), shared by the CNN and every classical model."""
    return tune_threshold_st_first(
        p_st, y, p_min_st=cfg.st_precision_floor, beta_for_f2_st=2.0,
        grid_points=cfg.threshold_grid_points,
        grid_lo=cfg.threshold_grid_lo, grid_hi=cfg.threshold_grid_hi)


def cmd_train_cnn(paths: Paths, cfg: OpenLabConfig, epochs: Optional[int] = None,
                  quality: bool = False, n_seeds: int = 3,
                  seed: Optional[int] = None, device=None, plot: bool = True):
    """Train the SF-vs-ST CNN on the training runs' fault windows: focal
    loss with inverse-frequency alpha, weighted sampling, AdamW at batch
    128, the epoch chosen by the tuned VAL ST-F2. ``quality``: ``n_seeds``
    seeds with patience 40, the best kept. Returns the result."""
    from shm_tpu_torch.train import train_cnn
    from shm_tpu_torch.train.cnn import predict_probs

    device = command_device(device)
    _, Xr, meta = _load_extracted(paths)
    split = load_json(paths.extracted / "run_split.json")
    Xtr, ytr = _sf_st_split_data(Xr, meta, split, "train")
    Xva, yva = _sf_st_split_data(Xr, meta, split, "val")
    print(f"Train windows: {len(ytr)} (SF={(ytr == 0).sum()}, ST={(ytr == 1).sum()})")
    print(f"Val windows  : {len(yva)} (SF={(yva == 0).sum()}, ST={(yva == 1).sum()})")

    # PLAIN (not nan-aware) statistics over the raw windows, as the
    # reference computes them: a channel with any NaN gets NaN statistics,
    # and standardize_clip then zeroes it everywhere, in training and in
    # serving (the committed data loses LWA_4 so)
    mu = Xtr.mean(axis=(0, 1)).astype(np.float32)
    sd = Xtr.std(axis=(0, 1)).astype(np.float32)
    sd = np.where(sd < 1e-8, 1.0, sd).astype(np.float32)
    dead = np.isnan(mu) | np.isnan(sd)
    if dead.any():
        print(f"[WARN] NaN raw-window stats zero out channel(s) "
              f"{np.where(dead)[0].tolist()} for CNN training AND serving "
              "(as the reference: plain statistics over NaN-bearing raw "
              "windows).")
    art = ensure_dir(paths.cnn_dir / "artifacts")
    save_npy(np.stack([mu, sd]), art / "cnn_raw_mu_sd.npy")

    Xtr_s = standardize_clip(Xtr, mu, sd, cfg.standardize_clip)[..., None]
    Xva_s = standardize_clip(Xva, mu, sd, cfg.standardize_clip)[..., None]

    n_sf, n_st = max(1, int((ytr == 0).sum())), max(1, int((ytr == 1).sum()))
    alpha = np.array([1.0 / n_sf, 1.0 / n_st], np.float32)
    alpha = alpha / alpha.mean()
    weights = np.where(ytr == 0, alpha[0], alpha[1])

    def st_f2_metric(probs: np.ndarray, y_true: np.ndarray) -> float:
        return _tune_st_first(cfg, probs[:, 1], y_true)["f2_st"]

    tcfg = cfg.cnn_train if epochs is None else replace(cfg.cnn_train, epochs=epochs)
    tcfg = replace(tcfg, batch_size=128)
    if seed is not None:
        tcfg = replace(tcfg, seed=seed)
    fit = dict(loss="focal", focal_gamma=cfg.focal_gamma, class_alpha=alpha,
               sample_weights=weights, val_metric_fn=st_f2_metric, device=device)
    if quality:
        tcfg = replace(tcfg, early_stop_patience=40)
        results = []
        for s in range(n_seeds):
            r = train_cnn(CNNOpenLab(dropout=cfg.cnn.dropout), Xtr_s, ytr, Xva_s,
                          yva, replace(tcfg, seed=tcfg.seed + s), log_every=0, **fit)
            print(f"[quality] seed {tcfg.seed + s}: ST-F2={r.best_metric:.4f} "
                  f"@ epoch {r.best_epoch} (stopped {r.stopped_epoch})")
            results.append(r)
        res = max(results, key=lambda r: r.best_metric)
        res.seconds = sum(r.seconds for r in results)
    else:
        res = train_cnn(CNNOpenLab(dropout=cfg.cnn.dropout), Xtr_s, ytr, Xva_s,
                        yva, tcfg, log_every=1, **fit)

    save_checkpoint(cnn_openlab_to_flax(res.variables),
                    art / "cnn_model_openlab.msgpack")
    best = CNNOpenLab(dropout=cfg.cnn.dropout)
    best.load_state_dict(res.variables)
    probs = predict_probs(best, Xva_s, device=device)
    tuned = _tune_st_first(cfg, probs[:, 1], yva)
    info = {
        "best_epoch": res.best_epoch, "stopped_epoch": res.stopped_epoch,
        "best_st_f2": res.best_metric, "val": tuned,
        "train_seconds": res.seconds,
        "settings": {"P_MIN_ST": cfg.st_precision_floor, "BETA_FOR_F2_ST": 2.0,
                     "CLIP_Z": cfg.standardize_clip,
                     "THRESH_GRID": cfg.threshold_grid_points,
                     "quality_mode": quality,
                     "n_seeds": n_seeds if quality else 1},
        "alpha": alpha.tolist(),
    }
    save_json(info, art / "cnn_training_info.json")
    if plot:
        from shm_tpu_torch.report import plot_loss_curves

        plot_loss_curves(res.history, paths.cnn_dir / "plots", "cnn_train_val_loss",
                         keys=(("train_loss", "train"), ("val_loss", "val")))
    print(f"[OK] CNN best ST-F2={res.best_metric:.4f} @ epoch {res.best_epoch} "
          f"({res.seconds:.1f}s); tuned t={tuned['t']:.3f}")
    return res


def _load_openlab_cnn(paths: Paths, cfg: OpenLabConfig):
    """(the trained CNN on the CPU, its raw-window mean, std)."""
    art = paths.cnn_dir / "artifacts"
    cnn = cnn_openlab_from_flax(load_checkpoint(art / "cnn_model_openlab.msgpack"),
                                cfg.cnn.num_classes, cfg.cnn.dropout)
    mu_sd = np.load(art / "cnn_raw_mu_sd.npy").astype(np.float32)
    return cnn, mu_sd[0], mu_sd[1]


def _cnn_p_st(cnn, X: np.ndarray, mu, sd, cfg: OpenLabConfig, device) -> np.ndarray:
    """p(ST) of raw windows, standardized and clipped, as float64."""
    from shm_tpu_torch.train.cnn import predict_probs

    Xs = standardize_clip(X, mu, sd, cfg.standardize_clip)[..., None]
    return predict_probs(cnn, Xs, device=device)[:, 1].astype(np.float64)


def cmd_validate_cnn(paths: Paths, cfg: OpenLabConfig, split_name: str = "val",
                     device=None, plot: bool = True) -> Dict:
    """The CNN on a split's fault windows: on ``val`` the ST-first threshold
    is tuned and saved, on ``test`` the saved one is applied; the summary
    (returned) into ``cnn_<split>_summary.json``."""
    device = command_device(device)
    _, Xr, meta = _load_extracted(paths)
    split = load_json(paths.extracted / "run_split.json")
    cnn, mu, sd = _load_openlab_cnn(paths, cfg)
    art = ensure_dir(paths.cnn_val_dir / "artifacts")

    X, y = _sf_st_split_data(Xr, meta, split, split_name)
    p_st = _cnn_p_st(cnn, X, mu, sd, cfg, device).astype(np.float32)
    if split_name == "val":
        tuned = _tune_st_first(cfg, p_st, y)
        thr = tuned["t"]
        save_npy(np.array([thr], np.float32), art / "cnn_best_threshold.npy")
        extra = {"tuning": tuned}
    else:
        thr = float(np.load(art / "cnn_best_threshold.npy").ravel()[0])
        extra = {"frozen_threshold": thr}

    yhat = (p_st >= thr).astype(np.int64)
    cm = confusion_matrix(y, yhat, 2)
    summary = {
        "split": split_name, "threshold": float(thr),
        "accuracy": accuracy(y, yhat),
        "st": binary_prf(y, yhat),
        "auroc_st": roc_auc_score(y, p_st) if len(np.unique(y)) == 2 else None,
        "confusion_matrix": cm.tolist(),
        "n": int(len(y)), **extra,
    }
    save_json(summary, art / f"cnn_{split_name}_summary.json")
    if plot:
        from shm_tpu_torch.report import plot_cm_row_norm, plot_score_hist

        plot_cm_row_norm(cm, ["SF", "ST"], paths.cnn_val_dir / "plots",
                         f"cnn_{split_name}_cm")
        plot_score_hist({"SF": p_st[y == 0], "ST": p_st[y == 1]}, thr,
                        paths.cnn_val_dir / "plots", f"cnn_{split_name}_pst_hist",
                        xlabel="p(ST)")
    print(f"[OK] CNN {split_name}: acc={summary['accuracy']:.4f} "
          f"ST-F1={summary['st']['f1']:.4f} t={thr:.3f}")
    print(np.array(cm))
    return summary


# ---------------------------------------------------------------------------
# the classical baselines
# ---------------------------------------------------------------------------

def _ml_data(paths: Paths):
    """(features of the fault windows, SF 0 / ST 1, masks by split) from
    ``features/`` and the split."""
    X_feat = np.load(paths.features / "X_feat.npy").astype(np.float32)
    meta = load_csv_table(paths.features / "meta_used.csv")
    split = load_json(paths.extracted / "run_split.json")
    lab = _labels(meta)
    keep = np.isin(lab, [LABEL_SENSOR_FAULT, LABEL_STRUCT_FAULT])
    y = (lab[keep] == LABEL_STRUCT_FAULT).astype(np.int64)
    run_ids = meta["run_id"].astype(str)[keep]
    masks = {s: np.isin(run_ids, list(map(str, split[f"{s}_runs"])))
             for s in ("train", "val", "test")}
    return X_feat[keep], y, masks


def cmd_train_ml(paths: Paths, cfg: OpenLabConfig,
                 svm_probability: str = "calibrated") -> List[Dict]:
    """Fit the five baselines on the training runs' fault features (on the
    host: sklearn and joblib), tune each one's ST-first threshold on val,
    write ``<name>.joblib``, ``<name>.export.npz`` and the threshold; a
    model that fails is recorded and skipped. Returns the summary rows."""
    import joblib

    from shm_tpu_torch.models.ml import build_ml_models, get_prob_st, write_export

    X, y, masks = _ml_data(paths)
    Xtr, ytr = X[masks["train"]], y[masks["train"]]
    Xva, yva = X[masks["val"]], y[masks["val"]]
    print(f"Train SF/ST: {len(ytr)} (SF={(ytr == 0).sum()}, ST={(ytr == 1).sum()})")
    if len(ytr) < 10 or len(np.unique(ytr)) < 2:
        raise RuntimeError("Training set too small or missing a class.")

    art = ensure_dir(paths.ml_dir / "artifacts")
    summary: List[Dict] = []
    for name, model in build_ml_models(cfg.seed, svm_probability).items():
        t0 = time.perf_counter()
        try:
            model.fit(Xtr, ytr)
            p_va = get_prob_st(model, Xva)
            tuned = _tune_st_first(cfg, p_va, yva)
            joblib.dump(model, art / f"{name}.joblib")
            write_export(art / f"{name}.joblib", model)
            save_npy(np.array([tuned["t"]], np.float32), art / f"{name}_threshold.npy")
            row = {"name": name, "status": "ok", "seconds": time.perf_counter() - t0,
                   **{k: tuned[k] for k in ("t", "prec_st", "rec_st", "f2_st",
                                            "macro_f1", "used_fallback")}}
            print(f"[OK] {name}: t={tuned['t']:.3f} recST={tuned['rec_st']:.3f} "
                  f"f2ST={tuned['f2_st']:.3f} ({row['seconds']:.1f}s)")
        except Exception as e:     # one model's failure does not stop the rest
            row = {"name": name, "status": "failed", "error": str(e)}
            print(f"[FAIL] {name}: {e}")
        summary.append(row)
    save_json({"models": summary, "seed": cfg.seed}, art / "ml_training_info.json")
    save_csv_records(summary, art / "ml_val_summary.csv")
    save_json(summary, art / "ml_val_summary.json")
    return summary


def cmd_validate_ml(paths: Paths, cfg: OpenLabConfig, split_name: str = "val",
                    host_ml: bool = False, device=None,
                    plot: bool = True) -> Dict[str, Dict]:
    """Every baseline on a split's fault features, scored from its export
    on the device (``host_ml``: sklearn's ``predict_proba``); on ``val`` the
    thresholds are tuned and saved, on another split the saved ones
    applied. Into ``validation_<split>/ml_<split>_summary.json``."""
    device = command_device(device)
    X, y, masks = _ml_data(paths)
    Xe, ye = X[masks[split_name]], y[masks[split_name]]
    art = paths.ml_dir / "artifacts"
    out = ensure_dir(paths.ml_dir / f"validation_{split_name}")
    results: Dict[str, Dict] = {}
    for mp in sorted(Path(art).glob("*.joblib")):
        name = mp.stem
        p_st = ml_predictor(mp, host_ml, device)(Xe)
        if split_name == "val":
            thr = _tune_st_first(cfg, p_st, ye)["t"]
            save_npy(np.array([thr], np.float32), art / f"{name}_threshold.npy")
        else:
            thr = float(np.load(art / f"{name}_threshold.npy").ravel()[0])
        yhat = (p_st >= thr).astype(np.int64)
        cm = confusion_matrix(ye, yhat, 2)
        results[name] = {
            "threshold": float(thr),
            "accuracy": accuracy(ye, yhat),
            "st": binary_prf(ye, yhat),
            "auroc_st": roc_auc_score(ye, p_st) if len(np.unique(ye)) == 2 else None,
            "confusion_matrix": cm.tolist(),
        }
        if plot:
            from shm_tpu_torch.report import plot_cm_row_norm, plot_score_hist

            plot_cm_row_norm(cm, ["SF", "ST"], out, f"{name}_cm")
            plot_score_hist({"SF": p_st[ye == 0], "ST": p_st[ye == 1]}, thr, out,
                            f"{name}_pst_hist", xlabel="p(ST)")
        print(f"[OK] {name} {split_name}: acc={results[name]['accuracy']:.4f} "
              f"ST-F1={results[name]['st']['f1']:.4f}")
    save_json(results, out / f"ml_{split_name}_summary.json")
    return results


# ---------------------------------------------------------------------------
# the hybrid comparison and its figures
# ---------------------------------------------------------------------------

STAGE2_MODELS: List[Tuple[str, Optional[str]]] = [
    ("cnn", None), ("ml", "cart"), ("ml", "rf"), ("ml", "gb"), ("ml", "hgb"),
    ("ml", "svm_rbf"),
]


def cmd_test_hybrid(paths: Paths, cfg: OpenLabConfig, split_name: str = "test",
                    host_ml: bool = False, device=None) -> Tuple[Dict, Dict]:
    """The gate on a split's clean windows, then each stage-2 model (the CNN
    on the anomalous raw windows, each baseline on their features) against
    the 3-class truth: ``comparison_summary.json``, ``stage2_metrics.npy``
    and ``cm3_all.npz``. On the card the gate is one launch of the cell's
    fused kernel. Returns the summary and the per-window outputs (``mse``,
    ``anomalous``, and by model name ``y_pred`` 0/1/2 and ``p_st`` on the
    anomalous windows)."""
    device = command_device(device)
    Xc, Xr, meta = _load_extracted(paths)
    split = load_json(paths.extracted / "run_split.json")
    runs = set(map(str, split[f"{split_name}_runs"]))
    emask = _in_runs(meta, runs)
    Xce, Xre = Xc[emask], Xr[emask]
    y_true = _labels(meta)[emask]

    X_feat_all = np.load(paths.features / "X_feat.npy").astype(np.float32)
    if len(X_feat_all) != len(emask):
        # a featurize run that dropped the sensor-fault windows wrote fewer
        # rows than the window set; the full-set mask would pick wrong rows
        raise RuntimeError(
            f"features/X_feat.npy has {len(X_feat_all)} rows but the "
            f"extracted window set has {len(emask)}; it was probably written "
            "by `featurize` with drop_sensor_fault=True — the hybrid "
            "comparison scores every anomalous window, so re-run featurize "
            "without dropping sensor-fault windows")
    X_feat = X_feat_all[emask]

    vae, mu, sd, manifest = _load_openlab_vae(paths, cfg)
    ch_idx = list(map(int, manifest["channels_idx"]))
    vae_thr = float(load_json(paths.vae_val_dir / "artifacts"
                              / "vae_threshold.json")["threshold"])
    Xg = standardize_clip(Xce[:, :, ch_idx], mu, sd, cfg.standardize_clip)
    t0 = time.perf_counter()
    mse = _gate_mse(vae, Xg, device)
    anomaly_mask = mse > vae_thr
    gate_seconds = time.perf_counter() - t0
    print(f"[gate] anomaly_rate={anomaly_mask.mean():.4f} "
          f"({int(anomaly_mask.sum())}/{len(mse)}) in {gate_seconds:.2f}s")

    cnn, cmu, csd = _load_openlab_cnn(paths, cfg)
    cnn_thr = float(np.load(paths.cnn_val_dir / "artifacts"
                            / "cnn_best_threshold.npy").ravel()[0])

    reports = ensure_dir(paths.hybrid_dir / "reports")
    cms: Dict[str, np.ndarray] = {}
    summary = {"split": split_name, "runs": sorted(runs), "vae_threshold": vae_thr,
               "anomaly_rate": float(anomaly_mask.mean()),
               "labels_order": LABELS_3, "models": []}
    bar_metrics: Dict[str, Dict[str, float]] = {}
    per_window = {"mse": mse, "anomalous": anomaly_mask, "y_pred": {},
                  "p_st": {}}
    lbl_to_i = {l: i for i, l in enumerate(LABELS_3)}
    yt_i = np.array([lbl_to_i[v] for v in y_true], np.int64)

    for mode, ml_name in STAGE2_MODELS:
        name = "CNN" if mode == "cnn" else ml_name.upper()
        y_pred = np.full(len(y_true), LABEL_NORMAL, dtype=object)
        prob_st = None
        if anomaly_mask.any():
            if mode == "cnn":
                prob_st = _cnn_p_st(cnn, Xre[anomaly_mask], cmu, csd, cfg, device)
                thr2 = cnn_thr
            else:
                art = paths.ml_dir / "artifacts"
                prob_st = ml_predictor(art / f"{ml_name}.joblib", host_ml,
                                       device)(X_feat[anomaly_mask])
                thr2 = float(np.load(art / f"{ml_name}_threshold.npy").ravel()[0])
            pred_bin = (prob_st >= thr2).astype(np.int64)
            y_pred[anomaly_mask] = np.where(pred_bin == 0, LABEL_SENSOR_FAULT,
                                            LABEL_STRUCT_FAULT)
        yp_i = np.array([lbl_to_i[v] for v in y_pred], np.int64)
        per_window["y_pred"][name], per_window["p_st"][name] = yp_i, prob_st
        cm3 = confusion_matrix(yt_i, yp_i, 3)
        cms[f"VAE + {name}"] = cm3

        # stage-2 metrics on the routed anomalies whose truth is SF or ST
        met = {k: None for k in ("accuracy", "precision_ST", "recall_ST",
                                 "f1_ST", "auroc_ST")}
        if anomaly_mask.any() and prob_st is not None:
            yt_a = y_true[anomaly_mask]
            keep = np.isin(yt_a, [LABEL_SENSOR_FAULT, LABEL_STRUCT_FAULT])
            if keep.any():
                yb = (yt_a[keep] == LABEL_STRUCT_FAULT).astype(int)
                pb = (y_pred[anomaly_mask][keep] == LABEL_STRUCT_FAULT).astype(int)
                prf = binary_prf(yb, pb)
                met = {
                    "accuracy": accuracy(yb, pb),
                    "precision_ST": prf["precision"],
                    "recall_ST": prf["recall"],
                    "f1_ST": prf["f1"],
                    "auroc_ST": (roc_auc_score(yb, prob_st[keep])
                                 if len(np.unique(yb)) == 2 else None),
                }
        summary["models"].append({
            "name": name,
            "stage2_metrics_on_routed_anomalies": met,
            "confusion_matrix_counts_3class": cm3.tolist(),
        })
        bar_metrics[name] = {k.replace("_ST", ""): (v if v is not None else 0.0)
                             for k, v in met.items()}
        print(f"[{name}] 3-class acc={accuracy(yt_i, yp_i):.4f} stage2={met}")

    save_json(summary, reports / "comparison_summary.json")
    np.save(reports / "stage2_metrics.npy",
            np.array([bar_metrics], dtype=object), allow_pickle=True)
    np.savez(reports / "cm3_all.npz", **cms)
    print(f"[OK] wrote {reports / 'comparison_summary.json'}")
    return summary, per_window


def cmd_plots(paths: Paths, cfg: OpenLabConfig) -> None:
    """The hybrid comparison's figures: the confusion-matrix grid and the
    stage-2 metric bars, from ``test-hybrid``'s reports."""
    from shm_tpu_torch.report import plot_cm_grid, plot_metrics_bar

    reports = paths.hybrid_dir / "reports"
    summary = load_json(reports / "comparison_summary.json")
    with np.load(reports / "cm3_all.npz") as z:
        cms = {k: z[k] for k in z.files}
    out = paths.hybrid_dir / "plots"
    plot_cm_grid(cms, ["Normal", "SF", "ST"], out, "hybrid_cm_grid")
    metrics = {m["name"]: {
        "Accuracy": m["stage2_metrics_on_routed_anomalies"]["accuracy"] or 0.0,
        "Precision": m["stage2_metrics_on_routed_anomalies"]["precision_ST"] or 0.0,
        "Recall": m["stage2_metrics_on_routed_anomalies"]["recall_ST"] or 0.0,
        "F1": m["stage2_metrics_on_routed_anomalies"]["f1_ST"] or 0.0,
        "AUROC": m["stage2_metrics_on_routed_anomalies"]["auroc_ST"] or 0.0,
    } for m in summary["models"]}
    plot_metrics_bar(metrics, out, "hybrid_stage2_metrics_bar",
                     ["Accuracy", "Precision", "Recall", "F1", "AUROC"])
    print(f"[OK] wrote hybrid plots under {out}")


def cmd_not_ported(name: str) -> None:
    raise NotImplementedError(f"`{name}` is not ported ({NOT_PORTED}); run it "
                              "with shm_tpu.cli.openlab")


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------

_COMMANDS = ("extract", "make-splits", "featurize", "train-vae", "validate-vae",
             "train-cnn", "validate-cnn", "train-ml", "validate-ml",
             "test-hybrid", "plots", "all")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="shm_tpu_torch.cli.openlab",
                                 description="openLAB stage (PyTorch port)")
    ap.add_argument("command", choices=_COMMANDS)
    ap.add_argument("--root", default="data/openlab")
    ap.add_argument("--raw-dir", default=None,
                    help="the raw MD_*.txt exports (read by extract, which is "
                         "not ported)")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None,
                    help="train-vae / train-cnn: override the training seed")
    ap.add_argument("--split", default=None, choices=[None, "val", "test"])
    ap.add_argument("--host-ml", action="store_true",
                    help="validate-ml / test-hybrid: sklearn's own "
                         "predict_proba on the host (needs sklearn and "
                         "joblib) instead of the export files on the device")
    ap.add_argument("--quality", action="store_true",
                    help="train-cnn: several seeds with patience 40, the "
                         "best VAL ST-F2 model kept")
    ap.add_argument("--seeds", type=int, default=3,
                    help="number of seeds for --quality (default 3)")
    ap.add_argument("--svm-probability", default="calibrated",
                    choices=["svc", "calibrated"],
                    help="train-ml SVM probability path: 'calibrated' "
                         "(default) = CalibratedClassifierCV(SVC(), "
                         "ensemble=False); 'svc' = the reference's "
                         "SVC(probability=True)")
    ap.add_argument("--devices", type=int, default=None,
                    help="not ported for N > 1 (one card)")
    ap.add_argument("--cell", choices=["lstm", "min_gru", "attention"],
                    default="lstm",
                    help="train-vae: the VAE family (recorded in the "
                         "manifest; the later commands read it there). "
                         "min_gru and attention are opt-in presets, not the "
                         "reference-parity model")
    ap.add_argument("--no-plots", action="store_true",
                    help="draw no figures (no JSON artifact depends on them)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu to "
                         "run the plain path on the CPU)")
    args = ap.parse_args(argv)
    if args.devices is not None and args.devices > 1:
        ap.error("--devices is not ported (ROADMAP.md Queue 1 item 9): the "
                 "port trains on one card")

    cfg = OpenLabConfig()
    if args.cell != "lstm":
        cfg = replace(cfg, vae=replace(cfg.vae, cell=args.cell))
    paths = Paths(args.root, args.raw_dir or default_openlab_raw_dir())
    dev, plot = args.device, not args.no_plots
    steps = {
        "extract": lambda: cmd_not_ported("extract"),
        "make-splits": lambda: cmd_make_splits(paths, cfg),
        "featurize": lambda: cmd_featurize(paths, cfg),
        "train-vae": lambda: cmd_train_vae(paths, cfg, args.epochs,
                                           seed=args.seed, device=dev, plot=plot),
        "validate-vae": lambda: cmd_validate_vae(paths, cfg, device=dev, plot=plot),
        "train-cnn": lambda: cmd_train_cnn(paths, cfg, args.epochs,
                                           quality=args.quality,
                                           n_seeds=args.seeds, seed=args.seed,
                                           device=dev, plot=plot),
        "validate-cnn": lambda: cmd_validate_cnn(paths, cfg, args.split or "val",
                                                 device=dev, plot=plot),
        "train-ml": lambda: cmd_train_ml(paths, cfg, args.svm_probability),
        "validate-ml": lambda: cmd_validate_ml(paths, cfg, args.split or "val",
                                               host_ml=args.host_ml,
                                               device=dev, plot=plot),
        "test-hybrid": lambda: cmd_test_hybrid(paths, cfg, args.split or "test",
                                               host_ml=args.host_ml, device=dev),
        "plots": lambda: cmd_plots(paths, cfg) if plot else None,
        "all": lambda: cmd_not_ported("all"),
    }
    steps[args.command]()


__all__ = ["Paths", "standardize_clip", "cmd_make_splits", "cmd_featurize",
           "cmd_train_vae", "cmd_validate_vae", "cmd_train_cnn",
           "cmd_validate_cnn", "cmd_train_ml", "cmd_validate_ml",
           "cmd_test_hybrid", "cmd_plots", "main", "_load_openlab_vae",
           "_load_openlab_cnn", "CHANNELS_IDX", "LABELS_3"]


if __name__ == "__main__":
    main()
