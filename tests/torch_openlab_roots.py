"""Temporary openLAB roots for the CLI tests of the port and the JAX
package (``tests/test_torch_cli_openlab*.py``).

``small_root`` writes every ``step``-th window of the committed
``data/openlab`` (its clean and raw windows, its rows of
``window_labels.csv``, ``features/`` and ``run_split.json``) with the
committed trained artifacts (the VAE, its threshold, the CNN, its
threshold and the five baselines with their exports), so that every
command runs on a quarter of the windows in the committed root's layout.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OPENLAB = ROOT / "data" / "openlab"
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


def silence_jax_plots(monkeypatch) -> None:
    """The JAX CLI draws its figures whatever it is asked; the tests skip
    them."""
    import shm_tpu.report as jax_report

    for name in jax_report.__all__:
        if name.startswith("plot_"):
            monkeypatch.setattr(jax_report, name, lambda *a, **k: None)
