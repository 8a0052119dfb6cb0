"""The port's ``.shmx`` export (``shm_tpu_torch/export.py``) of committed
trained roots on the CPU, as the JAX package's
``tests/test_export.py::test_export_{mingru,attention}_trained_artifacts``:
the ``min_gru`` and ``attention`` 4DOF roots (the cell read from the root's
training meta), and the openLAB CNN mode against ``OpenLabScorer`` of the
committed ``data/openlab`` models at 24 steps a window (the program's size
grows with the gate's unrolled steps and its semantics do not depend on
them; ``chip_smoke.py`` phase 15 exports the full 200 on the card, and the
LSTM ``data/4dof`` root). The exported program is the plain path the
in-process scorer runs on the CPU: every output bit for bit.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu_torch.export import export_scorer, load_exported_scorer, save_exported_scorer
from shm_tpu_torch.serve import HybridScorer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
OL = ROOT / "data" / "openlab"
KEYS = ("mse", "anomalous", "y_pred", "p_struct")


def same(got: dict, ref: dict) -> None:
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("root, cell", [("data/4dof_mingru", "min_gru"),
                                        ("data/4dof_attention", "attention")])
def test_export_trained_artifacts(root, cell, tmp_path):
    scorer = HybridScorer.from_artifacts(ROOT / root, device="cpu",
                                         min_bucket=4, max_batch=8)
    assert scorer.vae.cell == cell
    loaded = load_exported_scorer(save_exported_scorer(scorer, tmp_path / "a.shmx"),
                                  device="cpu")
    assert loaded.manifest["cell"] == cell
    assert loaded.manifest["expected_anomaly_rate"] == scorer.expected_anomaly_rate
    # windows at the root's own statistics, a few of them scaled past the gate
    z = np.random.default_rng(len(cell)).normal(size=(13, 100, 12))
    z[:4] *= 8.0
    W = (scorer.mean.numpy() + scorer.std.numpy() * 0.3 * z).astype(np.float32)
    got = loaded.score(W)
    same(got, scorer.score(W))
    assert 0 < got["anomalous"].sum() < 13


def test_openlab_cnn_mode_export_matches_the_scorer(tmp_path):
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    sc = OpenLabScorer.from_artifacts(OL, device="cpu", seq_len=24,
                                      min_bucket=32, max_batch=64)
    path = save_exported_scorer(sc, tmp_path / "bridge.shmx")
    ex = load_exported_scorer(path, device="cpu")
    m = ex.manifest
    assert m["pipeline"] == "openlab" and m["request_rank"] == 4
    assert m["stage2_threshold"] == sc.stage2_threshold
    assert m["expected_anomaly_rate"] == sc.expected_anomaly_rate
    assert m["threshold"] == sc.threshold and m["num_layers"] == 1
    idx = np.linspace(0, 6431, 100).astype(int)
    Xc = np.load(OL / "extracted/X_clean.npy", mmap_mode="r")[idx, :24]
    Xr = np.load(OL / "extracted/X_raw.npy", mmap_mode="r")[idx, :24]
    got, ref = ex.score_pair(Xc, Xr), sc.score_pair(Xc, Xr)
    same(got, ref)
    assert set(np.unique(got["y_pred"])) == {0, 1, 2}
    with pytest.raises(ValueError, match="raw-series"):
        ex.score_series(np.zeros((50, 4), np.float32))
    rf = OpenLabScorer.from_artifacts(OL, stage2="rf", device="cpu", seq_len=24)
    with pytest.raises(ValueError, match="only stage2='cnn'"):
        export_scorer(rf)


def test_cli_writes_an_artifact(tmp_path, capsys):
    """``python -m shm_tpu_torch.export``: one of --root / --openlab, the
    artifact of the root's plain path."""
    from shm_tpu_torch import export as ex

    out = tmp_path / "gate.shmx"
    ex.main(["--root", str(ROOT / "data/4dof_attention"), "--out", str(out)])
    assert "[export] wrote" in capsys.readouterr().out
    m = load_exported_scorer(out, device="cpu").manifest
    assert m["cell"] == "attention" and m["pipeline"] == "4dof"
    for argv in ([], ["--root", "a", "--openlab", "b"]):
        with pytest.raises(SystemExit):
            ex.main(argv + ["--out", str(out)])
