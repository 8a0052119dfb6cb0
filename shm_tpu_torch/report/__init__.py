"""Figures of the 1DOF, 4DOF and openLAB commands (counterpart of ``shm_tpu/report``)."""

from shm_tpu_torch.report.plots import (
    configure_axis,
    plot_cm_grid,
    plot_cm_row_norm,
    plot_latent_pca,
    plot_loss_curves,
    plot_metrics_bar,
    plot_pr_curve,
    plot_reconstruction_overlay,
    plot_rmse_box,
    plot_roc,
    plot_score_hist,
    plot_segment_rmse,
    plot_stacked_channels,
    save_figure,
)

__all__ = [
    "configure_axis",
    "save_figure",
    "plot_loss_curves",
    "plot_stacked_channels",
    "plot_reconstruction_overlay",
    "plot_cm_row_norm",
    "plot_roc",
    "plot_pr_curve",
    "plot_score_hist",
    "plot_latent_pca",
    "plot_segment_rmse",
    "plot_rmse_box",
    "plot_cm_grid",
    "plot_metrics_bar",
]
