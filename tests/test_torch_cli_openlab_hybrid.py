"""The port's ``test-hybrid`` against the JAX package's and against the
committed reports, on the CPU.

- On the small root of ``tests/torch_openlab_roots.py`` (every 4th
  committed window): the port (the export files on the device path) and
  the JAX CLI (its on-device tree and SVM exports) write the same six
  3-class confusion matrices and anomaly rate, each stage-2 metric within
  1e-6 and each AUROC within 2e-5 (the SVM's float32 kernel sums); with
  ``--host-ml`` the port's baselines are sklearn's own.
- On a copy of the committed ``data/openlab``: the port's CPU run writes
  the six committed matrices (``cm3_all.npz``,
  ``comparison_summary.json``) and the anomaly rate exactly, each AUROC
  within 2e-4 (the committed file came from a TPU; the JAX package's CPU
  run reads 1.47e-4 at most), and a ``stage2_metrics.npy`` of the same
  metrics.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from shm_tpu_torch.cli import openlab as ol
from torch_openlab_roots import OPENLAB, silence_jax_plots, small_root

torch.set_num_threads(1)
REPORTS = "output/Hybrid_Pipeline/reports"


def _reports(root):
    with np.load(root / REPORTS / "cm3_all.npz") as z:
        cms = {k: z[k] for k in z.files}
    return cms, json.loads((root / REPORTS / "comparison_summary.json").read_text())


def _same_summaries(a, b, atol, auroc_atol):
    assert a.keys() == b.keys()
    for k in ("split", "runs", "vae_threshold", "anomaly_rate", "labels_order"):
        assert a[k] == b[k], k
    for m, n in zip(a["models"], b["models"]):
        assert m["name"] == n["name"]
        assert m["confusion_matrix_counts_3class"] == n["confusion_matrix_counts_3class"]
        x = m["stage2_metrics_on_routed_anomalies"]
        y = n["stage2_metrics_on_routed_anomalies"]
        assert x.keys() == y.keys()
        for k in x:
            assert x[k] == pytest.approx(y[k], abs=auroc_atol if k == "auroc_ST"
                                         else atol), (m["name"], k)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    import functools

    from shm_tpu.cli import openlab as jol
    from shm_tpu.config import OpenLabConfig

    base = tmp_path_factory.mktemp("openlab_hybrid")
    port, host, jax_root = (small_root(base / n) for n in ("port", "host", "jax"))
    with pytest.MonkeyPatch.context() as mp:
        silence_jax_plots(mp)
        mp.setattr(jol, "predict_probs",
                   functools.partial(jol.predict_probs, batch_size=512))
        jol.cmd_test_hybrid(jol.Paths(str(jax_root), ""), OpenLabConfig())
    ol.main(["test-hybrid", "--root", str(port), "--device", "cpu"])
    ol.main(["test-hybrid", "--root", str(host), "--device", "cpu", "--host-ml"])
    return port, host, jax_root


def test_small_root_against_the_jax_cli(small):
    port, _, jax_root = small
    cms, summ = _reports(port)
    jcms, jsumm = _reports(jax_root)
    assert sorted(cms) == sorted(jcms) and len(cms) == 6
    for k in jcms:
        assert np.array_equal(cms[k], jcms[k]), k
    _same_summaries(summ, jsumm, atol=1e-6, auroc_atol=2e-5)
    assert 0.2 < summ["anomaly_rate"] < 0.7


def test_host_ml_is_sklearn(small):
    """``--host-ml``: the same routing through sklearn's predict_proba; the
    CNN's row is the default run's."""
    port, host, _ = small
    cms, summ = _reports(port)
    hcms, hsumm = _reports(host)
    assert np.array_equal(cms["VAE + CNN"], hcms["VAE + CNN"])
    assert summ["models"][0] == hsumm["models"][0]
    for k in hcms:
        assert hcms[k].sum() == cms[k].sum()


def test_committed_reports_reproduced(tmp_path):
    root = tmp_path / "openlab"
    shutil.copytree(OPENLAB, root, symlinks=True)
    ol.main(["test-hybrid", "--root", str(root), "--device", "cpu"])
    cms, summ = _reports(root)
    want_cms, want = _reports(OPENLAB)
    for k in want_cms:
        assert np.array_equal(cms[k], want_cms[k]), k
    _same_summaries(summ, want, atol=1e-12, auroc_atol=2e-4)
    bars = np.load(root / REPORTS / "stage2_metrics.npy", allow_pickle=True)[0]
    assert list(bars) == [m["name"] for m in summ["models"]]
    assert bars["CNN"]["auroc"] == summ["models"][0][
        "stage2_metrics_on_routed_anomalies"]["auroc_ST"]
