"""The port's openLAB commands on the other VAE families, on the CPU.

- ``test-hybrid`` of ``data/openlab_attention`` (its ``extracted/`` and
  ``features/`` are ``data/openlab``'s, copied into a temporary root): the
  six committed confusion matrices and the anomaly rate exactly, each AUROC
  within 4e-4 of the committed file (the JAX package's CPU run reads
  2.04e-4 for SVM_RBF; ``tests/openlab_readings.py attention``).
- ``train-vae --cell min_gru`` (one epoch, small root): the manifest names
  the cell, ``validate-vae`` reads it there, and the JAX package loads the
  checkpoint as a minGRU VAE to the same reconstruction (atol 2e-6).
"""

import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from shm_tpu_torch.cli import openlab as ol
from shm_tpu_torch.config import OpenLabConfig
from torch_openlab_roots import OPENLAB, small_root

torch.set_num_threads(1)
ATTENTION = Path(__file__).resolve().parents[1] / "data" / "openlab_attention"
REPORTS = "output/Hybrid_Pipeline/reports"


def test_attention_root_reproduces_its_committed_reports(tmp_path):
    root = tmp_path / "root"
    for sub in ("extracted", "features"):
        shutil.copytree(OPENLAB / sub, root / sub)
    shutil.copytree(ATTENTION / "output", root / "output")
    summary, per = ol.cmd_test_hybrid(ol.Paths(str(root)), OpenLabConfig(),
                                      device="cpu")
    with np.load(root / REPORTS / "cm3_all.npz") as got, \
            np.load(ATTENTION / REPORTS / "cm3_all.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert np.array_equal(got[k], want[k]), k
    committed = json.loads((ATTENTION / REPORTS / "comparison_summary.json").read_text())
    assert summary["anomaly_rate"] == committed["anomaly_rate"]
    for m, n in zip(summary["models"], committed["models"]):
        a = m["stage2_metrics_on_routed_anomalies"]["auroc_ST"]
        b = n["stage2_metrics_on_routed_anomalies"]["auroc_ST"]
        assert abs(a - b) <= 4e-4, m["name"]
    assert per["anomalous"].sum() == round(summary["anomaly_rate"] * len(per["mse"]))


def test_min_gru_cell_is_recorded_and_read_back(tmp_path):
    from shm_tpu.cli import openlab as jol
    from shm_tpu.config import OpenLabConfig as JaxOpenLabConfig

    root = small_root(tmp_path / "root", step=4, outputs=())
    ol.main(["train-vae", "--root", str(root), "--cell", "min_gru", "--epochs",
             "1", "--device", "cpu", "--no-plots"])
    man = json.loads((root / "output/VAE_Training/artifacts"
                      / "vae_clean_manifest.json").read_text())
    assert man["model"]["cell"] == "min_gru"
    got = ol.cmd_validate_vae(ol.Paths(str(root)), OpenLabConfig(),
                              device="cpu", plot=False)
    assert np.isfinite(got["threshold"]) and got["n_val_normal"] == 64
    vae, _, _, _ = ol._load_openlab_vae(ol.Paths(str(root)), OpenLabConfig())
    assert vae.cell == "min_gru"
    jm, jp, _, _, _ = jol._load_openlab_vae(jol.Paths(str(root), ""),
                                           JaxOpenLabConfig())
    assert jm.cell == "min_gru"
    x = np.random.default_rng(0).normal(size=(3, 200, 3)).astype(np.float32)
    recon_j, _, _ = jm.apply({"params": jp}, jnp.asarray(x))
    with torch.no_grad():
        recon, _, _ = vae(torch.from_numpy(x))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=2e-6)
