"""Temporary openLAB roots for the CLI tests of the port and the JAX
package (``tests/test_torch_cli_openlab*.py``).

``small_root`` writes every ``step``-th window of the committed
``data/openlab`` (its clean and raw windows, its rows of
``window_labels.csv``, ``features/`` and ``run_split.json``) with the
committed trained artifacts (the VAE, its threshold, the CNN, its
threshold and the five baselines with their exports), so that every
command runs on a quarter of the windows in the committed root's layout.

``catman_runs`` writes the committed windows back as catman exports
(``chip_smoke.py::write_catman_runs``), whole or each run's first
``SHORT_WINDOWS`` windows (enough for every class in the training split);
``ALL_FILES`` is what the JAX CLI's ``all`` writes under its root, figures
aside (read off a run of it on those short runs).

``one_thread_pools`` runs a block with this process's OpenMP and BLAS pools
at one thread. ``train-ml`` fits sklearn's ``HistGradientBoostingClassifier``,
whose OpenMP threads meet at a barrier many times a tree; beside the other
workers of a parallel test run they spin there for the core that one of
them waits on (a file that takes ~25 s alone took 662 s of its worker
among six). The fits do not depend on the pool's size.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OPENLAB = ROOT / "data" / "openlab"
SHORT_WINDOWS = 300
ALL_FILES = tuple(
    "extracted/" + f for f in ("X_clean.npy", "X_raw.npy", "run_diagnostics.csv",
                               "run_split.json", "window_labels.csv")) + tuple(
    "features/" + f for f in ("X_feat.npy", "feat_names.json", "meta_used.csv",
                              "y.npy")) + tuple(
    "output/" + f for f in (
        "CNN_Training/artifacts/cnn_model_openlab.msgpack",
        "CNN_Training/artifacts/cnn_raw_mu_sd.npy",
        "CNN_Training/artifacts/cnn_training_info.json",
        "CNN_Validation/artifacts/cnn_best_threshold.npy",
        "CNN_Validation/artifacts/cnn_val_summary.json",
        "Hybrid_Pipeline/reports/cm3_all.npz",
        "Hybrid_Pipeline/reports/comparison_summary.json",
        "Hybrid_Pipeline/reports/stage2_metrics.npy",
        *[f"ML_Baselines/artifacts/{m}{e}" for m in ("cart", "gb", "hgb", "rf", "svm_rbf")
          for e in (".joblib", "_threshold.npy")],
        "ML_Baselines/artifacts/ml_training_info.json",
        "ML_Baselines/artifacts/ml_val_summary.csv",
        "ML_Baselines/artifacts/ml_val_summary.json",
        "ML_Baselines/validation_val/ml_val_summary.json",
        "VAE_Training/artifacts/vae_clean_manifest.json",
        "VAE_Training/artifacts/vae_clean_mean.npy",
        "VAE_Training/artifacts/vae_clean_std.npy",
        "VAE_Training/artifacts/vae_exceedance_clean.msgpack",
        "VAE_Validation_and_Thresholding/artifacts/vae_threshold.json"))
OUTPUTS = ("VAE_Training/artifacts", "VAE_Validation_and_Thresholding/artifacts",
           "CNN_Training/artifacts", "CNN_Validation/artifacts",
           "ML_Baselines/artifacts")


def _rows(path: Path, keep: np.ndarray) -> str:
    lines = path.read_text().splitlines()
    return "\n".join([lines[0]] + [lines[1 + i] for i in keep]) + "\n"


def small_root(dest: Path, step: int = 4, src: Path = OPENLAB,
               outputs=OUTPUTS) -> Path:
    """A root at ``dest`` with every ``step``-th committed window and
    ``src``'s trained artifacts (the subdirectories of ``output/`` named)."""
    n = np.load(OPENLAB / "extracted/X_clean.npy", mmap_mode="r").shape[0]
    keep = np.arange(0, n, step)
    for sub in ("extracted", "features"):
        (dest / sub).mkdir(parents=True, exist_ok=True)
    for name in ("X_clean", "X_raw"):
        X = np.load(OPENLAB / f"extracted/{name}.npy", mmap_mode="r")
        np.save(dest / f"extracted/{name}.npy", np.ascontiguousarray(X[keep]))
    (dest / "extracted/window_labels.csv").write_text(
        _rows(OPENLAB / "extracted/window_labels.csv", keep))
    shutil.copy(OPENLAB / "extracted/run_split.json", dest / "extracted")
    for name in ("X_feat", "y"):
        np.save(dest / f"features/{name}.npy",
                np.load(OPENLAB / f"features/{name}.npy")[keep])
    (dest / "features/meta_used.csv").write_text(
        _rows(OPENLAB / "features/meta_used.csv", keep))
    shutil.copy(OPENLAB / "features/feat_names.json", dest / "features")
    for sub in outputs:
        shutil.copytree(src / "output" / sub, dest / "output" / sub)
    return dest


def catman_runs(dest: Path, windows=None) -> Path:
    """The committed windows as catman ``MD_*.txt`` files under ``dest``
    (each run's first ``windows`` windows, or all)."""
    import sys

    sys.path.insert(0, str(ROOT))
    from chip_smoke import write_catman_runs

    write_catman_runs(OPENLAB, dest, windows)
    return dest


def one_thread_pools():
    """A context in which the OpenMP and BLAS thread pools of this process
    (sklearn's, numpy's, torch's) run one thread."""
    from threadpoolctl import threadpool_limits

    return threadpool_limits(limits=1)


def files_under(root: Path) -> set:
    """Every file under ``root``, relative, figures aside."""
    return {p.relative_to(root).as_posix() for p in root.rglob("*")
            if p.is_file() and p.suffix not in (".png", ".pdf", ".svg")}


def silence_jax_plots(monkeypatch) -> None:
    """The JAX CLI draws its figures whatever it is asked; the tests skip
    them."""
    import shm_tpu.report as jax_report

    for name in jax_report.__all__:
        if name.startswith("plot_"):
            monkeypatch.setattr(jax_report, name, lambda *a, **k: None)
