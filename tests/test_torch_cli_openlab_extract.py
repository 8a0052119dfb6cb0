"""The port's ``extract`` and ``all`` (``shm_tpu_torch/cli/openlab.py``)
against the JAX CLI's, on the CPU, on the committed windows written back as
catman exports (``tests/torch_openlab_roots.py::catman_runs``).

- ``extract`` on all seven runs: ``X_clean.npy``, ``X_raw.npy``,
  ``window_labels.csv`` and ``run_diagnostics.csv`` byte for byte the JAX
  command's (the CSVs are pandas' ``to_csv`` text, written without pandas).
- ``all --epochs 1 --no-plots`` on each run's first 300 windows: every file
  the JAX ``all`` writes (``ALL_FILES``; ``tests/test_torch_cli_openlab_all.py``
  holds the JAX command to that list) and the baselines' export files;
  ``extracted/``, ``run_split.json`` and ``features/`` byte for byte what the
  JAX ``extract``, ``make-splits`` and ``featurize`` write from the same
  files. The later steps are the commands the other
  ``tests/test_torch_cli_openlab*.py`` files hold against JAX.
"""

import shutil

import numpy as np
import pytest
import torch

from shm_tpu_torch.cli import openlab as ol
from torch_openlab_roots import ALL_FILES, SHORT_WINDOWS, catman_runs, files_under

torch.set_num_threads(1)
EXTRACTED = ("X_clean.npy", "X_raw.npy", "window_labels.csv", "run_diagnostics.csv")
FEATURES = ("X_feat.npy", "y.npy", "meta_used.csv", "feat_names.json")


def jax_cli():
    from shm_tpu.cli import openlab as jol

    return jol


def jax_steps(root, raw, steps) -> None:
    from shm_tpu.config import OpenLabConfig

    jol = jax_cli()
    paths, cfg = jol.Paths(str(root), str(raw)), OpenLabConfig()
    for step in steps:
        getattr(jol, "cmd_" + step.replace("-", "_"))(paths, cfg)


def test_extract_matches_jax_byte_for_byte(tmp_path):
    raw = catman_runs(tmp_path / "raw")
    ol.main(["extract", "--root", str(tmp_path / "port"), "--raw-dir", str(raw),
             "--device", "cpu"])
    jax_steps(tmp_path / "jax", raw, ["extract"])
    for name in EXTRACTED:
        got = (tmp_path / "port/extracted" / name).read_bytes()
        assert got == (tmp_path / "jax/extracted" / name).read_bytes(), name
    Xc = np.load(tmp_path / "port/extracted/X_clean.npy")
    assert Xc.shape == (6432, 200, 4) and Xc.dtype == np.float32


@pytest.fixture(scope="module")
def all_root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("all")
    raw = catman_runs(tmp / "raw", SHORT_WINDOWS)
    ol.main(["all", "--root", str(tmp / "port"), "--raw-dir", str(raw),
             "--epochs", "1", "--no-plots", "--device", "cpu"])
    return tmp


def test_all_writes_every_file_of_the_jax_command(all_root):
    exports = {f"output/ML_Baselines/artifacts/{m}.export.npz"
               for m in ("cart", "gb", "hgb", "rf", "svm_rbf")}
    assert files_under(all_root / "port") == set(ALL_FILES) | exports
    assert not list((all_root / "port").rglob("*.png"))       # --no-plots


def test_all_extracts_splits_and_featurizes_as_jax(all_root):
    jax_steps(all_root / "jax", all_root / "raw",
              ["extract", "make-splits", "featurize"])
    for rel in ([f"extracted/{n}" for n in EXTRACTED + ("run_split.json",)]
                + [f"features/{n}" for n in FEATURES]):
        assert (all_root / "port" / rel).read_bytes() == \
            (all_root / "jax" / rel).read_bytes(), rel
    n = np.load(all_root / "port/extracted/X_raw.npy", mmap_mode="r").shape[0]
    assert n == 7 * SHORT_WINDOWS
    summary = ol.load_json(all_root / "port/output/Hybrid_Pipeline/reports/"
                           "comparison_summary.json")
    assert [m["name"] for m in summary["models"]] == [
        "CNN", "CART", "RF", "GB", "HGB", "SVM_RBF"]


def test_all_stops_at_the_first_failing_step(tmp_path):
    """``all`` runs the steps in order: with no catman export it stops at
    ``extract`` and writes nothing."""
    with pytest.raises(FileNotFoundError, match="No MD_"):
        ol.main(["all", "--root", str(tmp_path / "r"), "--raw-dir", str(tmp_path),
                 "--no-plots", "--device", "cpu"])
    assert not (tmp_path / "r").exists()
    shutil.rmtree(tmp_path, ignore_errors=True)
