"""Shared helpers of the tests that run the port's 4DOF commands and the JAX
package's on temporary copies of the committed artifact roots
(``tests/test_torch_cli_threshold*.py``, ``tests/test_torch_cli_test_pipeline*.py``).

A temporary root is ``chip_smoke.chain_root``'s: a copy of the root's
``processed/`` and ``models/``, whose runs are named under ``data/4dof/raw``
(the other roots' raw runs are uncommitted copies of it). The JAX commands
read those repo-relative paths from the working directory, so they run from
the repository root, and their figures are turned off (the JAX CLI draws
them unconditionally; no JSON depends on them).

Each command runs once per root in a module-scoped fixture. Both sides
score in float32 on the CPU, so the port is held to the JAX package's output
within 1e-5 relative, and to the committed files (made by the TPU's bf16
gate) within ``THRESHOLD_RTOL_4DOF`` for the threshold and the family's
``cm_limit`` windows for the confusion matrix.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from chip_smoke import FAMILIES, chain_root, check_pipeline
from shm_tpu.cli import stage4dof as jax_cli
from shm_tpu_torch.cli import stage4dof as cli
from test_calibrate_dtype import THRESHOLD_RTOL_4DOF

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-5                   # port against the JAX package, both float32 CPU
OUTPUTS = {
    "threshold": ("processed/vae_threshold.json",),
    "test-pipeline": ("figures/pipeline_metrics.json",
                      "figures/vae_gate_binary_metrics.json",
                      "figures/hybrid_struct_vs_rest_metrics.json",
                      "figures/pipeline_classification_report.txt"),
}

# pytest-xdist runs several test files at once on the same cores
torch.set_num_threads(1)


def run_both(tmp_path_factory, cell: str, command: str):
    """Run ``command`` through the port (``--device cpu --no-plots``) and the
    JAX CLI, each on its own temporary root; returns (port root, JAX root,
    committed root)."""
    port = chain_root(tmp_path_factory.mktemp(f"port_{cell}"), cell)
    jax = chain_root(tmp_path_factory.mktemp(f"jax_{cell}"), cell)
    cli.main([command, "--root", str(port), "--device", "cpu", "--no-plots"])
    import shm_tpu.report as jax_report

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ROOT)
        for name in jax_report.__all__:
            if name.startswith("plot_"):
                mp.setattr(jax_report, name, lambda *a, **k: None)
        jax_cli.main([command, "--root", str(jax)])
    for rel in OUTPUTS[command]:
        assert (port / rel).is_file() and (jax / rel).is_file(), rel
    return port, jax, ROOT / FAMILIES[cell]["root"]


def load(root: Path, rel: str):
    return json.loads((root / rel).read_text())


def close(a: float, b: float, rel: float = REL) -> bool:
    return abs(a - b) <= rel * abs(b)


# --- threshold ---------------------------------------------------------------

COUNTS = ("n_val_windows_normal", "n_val_windows_sensor",
          "n_val_windows_structural")


def check_threshold_against_jax(port: Path, jax: Path) -> None:
    """Every key of vae_threshold.json: counts and labels exact, the
    threshold and every score summary within 1e-5 relative."""
    got, want = (load(r, "processed/vae_threshold.json") for r in (port, jax))
    assert got.keys() == want.keys()
    for k in want:
        if k == "threshold":
            assert close(got[k], want[k]), (got[k], want[k])
        elif k == "score_summary":
            assert got[k].keys() == want[k].keys()
            for group, summ in want[k].items():
                assert got[k][group].keys() == summ.keys()
                assert got[k][group]["n"] == summ["n"]
                for stat, v in summ.items():
                    assert close(got[k][group][stat], v), (group, stat)
        else:
            assert got[k] == want[k], k


def check_threshold_against_committed(port: Path, committed: Path) -> None:
    got, want = (load(r, "processed/vae_threshold.json") for r in (port, committed))
    assert close(got["threshold"], want["threshold"], THRESHOLD_RTOL_4DOF)
    assert [got[k] for k in COUNTS] == [want[k] for k in COUNTS] == [2010, 804, 804]
    assert got["stochastic_eval"] is False


# --- test-pipeline -----------------------------------------------------------

GATE_FLOATS = ("gate_auroc", "average_precision", "precision", "recall", "f1")
HYBRID_FLOATS = ("average_precision", "precision", "recall", "f1")


def check_pipeline_against_jax(port: Path, jax: Path) -> None:
    """The whole pipeline_metrics.json: counts, confusion matrix and
    gate_stats exact (both float32, the same label on every window), AP,
    AUROC and the binary metrics within 1e-5 relative; the two split files
    are the metrics' sections; the classification report is the same text."""
    got, want = (load(r, "figures/pipeline_metrics.json") for r in (port, jax))
    assert got.keys() == want.keys()
    assert got["confusion_matrix_counts"] == want["confusion_matrix_counts"]
    assert got["accuracy"] == want["accuracy"]
    assert got["gate"]["gate_stats"] == want["gate"]["gate_stats"]
    assert got["gate"].keys() == want["gate"].keys()
    assert got["hybrid_struct_vs_rest"].keys() == want["hybrid_struct_vs_rest"].keys()
    for k in GATE_FLOATS:
        assert close(got["gate"][k], want["gate"][k]), k
    assert close(got["gate"]["hybrid_auroc"], want["gate"]["hybrid_auroc"])
    for k in HYBRID_FLOATS:
        assert close(got["hybrid_struct_vs_rest"][k],
                     want["hybrid_struct_vs_rest"][k]), k
    for k in ("threshold_mse", "score_def", "frac_range"):
        assert got["gate"][k] == want["gate"][k], k
    for k in ("window_len", "stride", "seed"):
        assert got[k] == want[k], k
    assert got["throughput"]["n_windows"] == want["throughput"]["n_windows"] == 3636
    assert load(port, "figures/vae_gate_binary_metrics.json") == got["gate"]
    assert (load(port, "figures/hybrid_struct_vs_rest_metrics.json")
            == got["hybrid_struct_vs_rest"])
    rep = "figures/pipeline_classification_report.txt"
    assert (port / rep).read_text() == (jax / rep).read_text()


def check_pipeline_against_committed(port: Path, committed: Path, cell: str) -> None:
    """``chip_smoke.check_pipeline``'s checks: gate_stats exact, each class's
    window count, the confusion matrix within the family's ``cm_limit``
    windows, AP and AUROC within its ``PIPELINE_ATOL`` (1e-4)."""
    check_pipeline(cell, port, committed, "test-pipeline")
