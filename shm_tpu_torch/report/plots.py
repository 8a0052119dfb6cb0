"""The 1DOF and 4DOF commands' figures (counterpart of
``shm_tpu/report/plots.py``): transparent pdf/png/svg triple-save, no-grid
bordered axes.

matplotlib is imported when a figure is drawn, never when this module is
imported: a CUDA host may lack it, and no JSON artifact of a command
depends on a figure (the commands take ``--no-plots``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from shm_tpu_torch.utils.io import ensure_dir


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def configure_axis(ax, xlabel: str = "", ylabel: str = "", fontsize: int = 16) -> None:
    if xlabel:
        ax.set_xlabel(xlabel, fontsize=fontsize)
    if ylabel:
        ax.set_ylabel(ylabel, fontsize=fontsize)
    ax.tick_params(axis="both", which="major", labelsize=13)
    ax.grid(False)
    for spine in ax.spines.values():
        spine.set_visible(True)
        spine.set_linewidth(1.2)
    ax.set_facecolor("none")


def save_figure(fig, out_dir: str | Path, file_stem: str) -> None:
    """Transparent pdf/png/svg triple-save."""
    out = ensure_dir(out_dir)
    fig.savefig(out / f"{file_stem}.pdf", format="pdf", bbox_inches="tight",
                transparent=True)
    fig.savefig(out / f"{file_stem}.png", format="png", bbox_inches="tight",
                transparent=True, dpi=300)
    fig.savefig(out / f"{file_stem}.svg", format="svg", bbox_inches="tight",
                transparent=True)


def _finish(plt, fig, out_dir, file_stem: str) -> None:
    fig.tight_layout()
    save_figure(fig, out_dir, file_stem)
    plt.close(fig)


def plot_loss_curves(hist: Dict[str, list], out_dir, file_stem: str = "training_curves",
                     keys=(("train_total", "Train"), ("val_total", "Val"))) -> None:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8.5, 4.8))
    for key, label in keys:
        if key in hist and hist[key]:
            ax.plot(hist["epoch"], hist[key], linewidth=1.5, label=label)
    configure_axis(ax, "Epoch", "Loss")
    ax.legend(frameon=False, fontsize=12)
    _finish(plt, fig, out_dir, file_stem)


def plot_stacked_channels(t: np.ndarray, channels: Dict[str, np.ndarray], out_dir,
                          file_stem: str, ylabel: str = "") -> None:
    """Stacked per-channel panels (the displacement figure of ``gen-normal``)."""
    plt = _pyplot()
    n = len(channels)
    fig, axes = plt.subplots(n, 1, figsize=(9, 1.9 * n), sharex=True)
    axes = np.atleast_1d(axes)
    for ax, (name, y) in zip(axes, channels.items()):
        ax.plot(t, y, linewidth=1.0)
        configure_axis(ax, "", name)
    axes[-1].set_xlabel("Time [s]", fontsize=16)
    if ylabel:
        fig.supylabel(ylabel, fontsize=16)
    _finish(plt, fig, out_dir, file_stem)


def plot_reconstruction_overlay(t: np.ndarray, measured: Dict[str, np.ndarray],
                                recon: Dict[str, np.ndarray], out_dir,
                                file_stem: str, labels=("Measured", "Reconstructed")
                                ) -> None:
    """Two series overlaid in stacked panels (the normal-against-fault
    figures of ``gen-faults``)."""
    plt = _pyplot()
    n = len(measured)
    fig, axes = plt.subplots(n, 1, figsize=(9, 1.9 * n), sharex=True)
    axes = np.atleast_1d(axes)
    for ax, name in zip(axes, measured):
        ax.plot(t, measured[name], linewidth=1.0, label=labels[0])
        ax.plot(t, recon[name], linewidth=1.0, linestyle="--", label=labels[1])
        configure_axis(ax, "", name)
    axes[-1].set_xlabel("Time [s]", fontsize=16)
    axes[0].legend(frameon=False, fontsize=11, ncol=2)
    _finish(plt, fig, out_dir, file_stem)


def plot_cm_row_norm(cm: np.ndarray, labels: Sequence[str], out_dir, file_stem: str,
                     cmap: str = "Blues", title: str = "") -> None:
    """Row-normalized confusion matrix with count and share annotations."""
    plt = _pyplot()
    cm = np.asarray(cm, np.float64)
    row = cm.sum(axis=1, keepdims=True)
    norm = np.divide(cm, np.where(row > 0, row, 1.0))
    fig, ax = plt.subplots(figsize=(6.4, 5.4))
    im = ax.imshow(norm, cmap=cmap, vmin=0, vmax=1)
    ax.set_xticks(range(len(labels)), labels, fontsize=12)
    ax.set_yticks(range(len(labels)), labels, fontsize=12)
    ax.set_xlabel("Predicted", fontsize=14)
    ax.set_ylabel("True", fontsize=14)
    if title:
        ax.set_title(title, fontsize=14)
    for i in range(len(labels)):
        for j in range(len(labels)):
            color = "white" if norm[i, j] > 0.5 else "black"
            ax.text(j, i, f"{int(cm[i, j])}\n{norm[i, j]:.2f}",
                    ha="center", va="center", fontsize=11, color=color)
    fig.colorbar(im, ax=ax, fraction=0.046)
    _finish(plt, fig, out_dir, file_stem)


def plot_roc(curves: Dict[str, tuple], out_dir, file_stem: str) -> None:
    """One or more ``name: (fpr, tpr, auc)`` curves on a shared axis."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6.4, 5.4))
    for name, (fpr, tpr, a) in curves.items():
        ax.plot(fpr, tpr, linewidth=1.8, label=f"{name} (AUC={a:.3f})")
    ax.plot([0, 1], [0, 1], linestyle=":", color="0.5", linewidth=1.0)
    configure_axis(ax, "False positive rate", "True positive rate", 14)
    ax.legend(frameon=False, fontsize=11, loc="lower right")
    _finish(plt, fig, out_dir, file_stem)


def plot_pr_curve(prec: np.ndarray, rec: np.ndarray, ap: float, out_dir,
                  file_stem: str, label: str = "") -> None:
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6.4, 5.4))
    ax.plot(rec, prec, linewidth=1.8,
            label=f"{label} (AP={ap:.3f})" if label else f"AP={ap:.3f}")
    configure_axis(ax, "Recall", "Precision", 14)
    ax.set_ylim(0, 1.02)
    ax.legend(frameon=False, fontsize=11, loc="lower left")
    _finish(plt, fig, out_dir, file_stem)


def plot_score_hist(groups: Dict[str, np.ndarray], threshold: Optional[float],
                    out_dir, file_stem: str, log_x: bool = False,
                    xlabel: str = "Reconstruction MSE") -> None:
    """Per-class score histograms with the threshold as a dashed line."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8.8, 6.2))
    nonempty = [v for v in groups.values() if v.size]
    all_scores = np.concatenate(nonempty) if nonempty else np.array([1.0])
    if log_x:
        lo = max(all_scores.min(), 1e-8)
        bins = np.logspace(np.log10(lo), np.log10(all_scores.max() + 1e-8), 60)
        ax.set_xscale("log")
    else:
        bins = 60
    for name, s in groups.items():
        if s.size:
            ax.hist(s, bins=bins, alpha=0.55, label=name)
    if threshold is not None:
        ax.axvline(threshold, color="k", linestyle="--", linewidth=1.5,
                   label=f"threshold={threshold:.4g}")
    configure_axis(ax, xlabel, "Count", 14)
    ax.legend(frameon=False, fontsize=11)
    _finish(plt, fig, out_dir, file_stem)


def plot_latent_pca(mu: np.ndarray, labels: np.ndarray, label_names: Sequence[str],
                    out_dir, file_stem: str) -> None:
    """The latent means' first two principal components (an SVD of the
    centred means, in float64), coloured by window label."""
    plt = _pyplot()
    X = np.asarray(mu, np.float64)
    Xc = X - X.mean(axis=0)
    _, _, Vt = np.linalg.svd(Xc, full_matrices=False)
    P = Xc @ Vt[:2].T
    fig, ax = plt.subplots(figsize=(6.8, 5.6))
    for i, name in enumerate(label_names):
        m = labels == i
        if m.any():
            ax.scatter(P[m, 0], P[m, 1], s=9, alpha=0.65, label=name)
    configure_axis(ax, "PC 1", "PC 2", 14)
    ax.legend(frameon=False, fontsize=11)
    _finish(plt, fig, out_dir, file_stem)


def plot_segment_rmse(curves: Dict[str, np.ndarray], out_dir, file_stem: str) -> None:
    """Segment RMSE against segment index, one line per named curve (the
    second and later dashed); a legend when there is more than one."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 8))
    for k, (name, r) in enumerate(curves.items()):
        ax.plot(np.arange(len(r)), r, linewidth=1.5, label=name,
                linestyle="--" if k else "-")
    configure_axis(ax, "Segment index", "RMSE")
    if len(curves) > 1:
        ax.legend(frameon=False, fontsize=14)
    _finish(plt, fig, out_dir, file_stem)


def plot_rmse_box(groups: Dict[str, np.ndarray], out_dir, file_stem: str) -> None:
    """Box plot of each group's segment RMSE, outliers hidden."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 8))
    ax.boxplot(list(groups.values()), tick_labels=list(groups), patch_artist=True,
               showfliers=False, widths=0.55)
    configure_axis(ax, "", "RMSE")
    _finish(plt, fig, out_dir, file_stem)


__all__ = ["configure_axis", "save_figure", "plot_loss_curves",
           "plot_stacked_channels", "plot_reconstruction_overlay",
           "plot_cm_row_norm", "plot_roc", "plot_pr_curve", "plot_score_hist",
           "plot_latent_pca", "plot_segment_rmse", "plot_rmse_box"]
