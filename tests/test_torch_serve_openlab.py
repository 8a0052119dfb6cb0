"""The port's ``OpenLabScorer`` (``shm_tpu_torch/serve_openlab.py``) against
the JAX package's ``shm_tpu.serve_openlab.OpenLabScorer`` on committed
``data/openlab`` windows, on the CPU.

256 test-run windows, on both sides of the gate, in one bucket: for
``stage2`` = ``cnn``, ``rf`` and ``svm_rbf`` the gate decisions and
``y_pred`` are equal, mse within 5e-6 relative (float32 LSTM passes summed
in another order; measured 3.3e-6) and ``p_struct`` within 1e-5. Then, as
``tests/test_serve_openlab.py`` does for the JAX scorer: the stacked and the
pair forms, bucketing invariance, every classical mode against sklearn's
own routing (``host_ml``), validation errors, warmup, and the paths not
ported.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu_torch.serve_openlab import ML_STAGE2, OpenLabScorer

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
OL = ROOT / "data" / "openlab"


@pytest.fixture(scope="module")
def subset():
    """256 windows of the test runs, evenly spread (both sides of the gate)."""
    import json

    from shm_tpu_torch.utils.io import load_csv_table

    meta = load_csv_table(OL / "extracted/window_labels.csv")
    runs = json.loads((OL / "extracted/run_split.json").read_text())["test_runs"]
    test = np.flatnonzero(np.isin(meta["run_id"], runs))
    idx = test[np.linspace(0, len(test) - 1, 256).astype(int)]
    Xc = np.load(OL / "extracted/X_clean.npy", mmap_mode="r")[idx]
    Xr = np.load(OL / "extracted/X_raw.npy", mmap_mode="r")[idx]
    Xf = np.load(OL / "features/X_feat.npy")[idx]
    return (np.ascontiguousarray(Xc, np.float32),
            np.ascontiguousarray(Xr, np.float32), Xf.astype(np.float32))


@pytest.fixture(scope="module")
def scorer():
    return OpenLabScorer.from_artifacts(OL, device="cpu", min_bucket=64,
                                        max_batch=256)


@pytest.mark.parametrize("stage2", ["cnn", "rf", "svm_rbf"])
def test_matches_the_jax_scorer(stage2, subset):
    from shm_tpu.serve_openlab import OpenLabScorer as JaxScorer

    Xc, Xr, Xf = subset
    feats = None if stage2 == "cnn" else Xf
    got = OpenLabScorer.from_artifacts(OL, stage2=stage2, device="cpu",
                                       min_bucket=256, max_batch=256
                                       ).score_pair(Xc, Xr, features=feats)
    want = JaxScorer.from_artifacts(OL, stage2=stage2, min_bucket=256,
                                    max_batch=256).score_pair(Xc, Xr, features=feats)
    anom = np.asarray(want["anomalous"]).astype(bool)
    assert 20 < anom.sum() < 236, "the subset must sit on both sides of the gate"
    np.testing.assert_array_equal(got["anomalous"].astype(bool), anom)
    np.testing.assert_array_equal(got["y_pred"], np.asarray(want["y_pred"]))
    np.testing.assert_allclose(got["mse"], np.asarray(want["mse"]), rtol=5e-6)
    np.testing.assert_allclose(got["p_struct"], np.asarray(want["p_struct"]),
                               rtol=0, atol=1e-5)
    assert set(np.unique(got["y_pred"][anom])) == {1, 2}
    assert (got["y_pred"][~anom] == 0).all() and (got["p_struct"][~anom] == 0).all()


def test_stacked_and_pair_agree(scorer, subset):
    Xc, Xr, _ = subset
    a = scorer.score(np.stack([Xc, Xr], axis=-1))
    b = scorer.score_pair(Xc, Xr)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_bucketing_invariance(scorer, subset):
    """The buckets a request is cut into change no output."""
    Xc, Xr, _ = subset
    whole = scorer.score_pair(Xc[:100], Xr[:100])      # one padded 128 bucket
    part = OpenLabScorer.from_artifacts(OL, device="cpu", min_bucket=8,
                                        max_batch=32)
    split = part.score_pair(Xc[:100], Xr[:100])        # 32 + 32 + 32 + 4 -> 8
    for k in ("mse", "anomalous", "y_pred"):
        np.testing.assert_array_equal(split[k], whole[k])
    np.testing.assert_allclose(split["p_struct"], whole["p_struct"], atol=1e-6)


@pytest.mark.parametrize("stage2", ML_STAGE2)
def test_ml_stage2_matches_sklearn_routing(stage2, subset):
    """Each classical mode from its export file against the same scorer with
    sklearn's own predict_proba (``host_ml``): the same routing."""
    Xc, Xr, Xf = subset
    dev = OpenLabScorer.from_artifacts(OL, stage2=stage2, device="cpu",
                                       min_bucket=256, max_batch=256)
    host = OpenLabScorer.from_artifacts(OL, stage2=stage2, host_ml=True,
                                        device="cpu", min_bucket=256,
                                        max_batch=256)
    a = dev.score_pair(Xc, Xr, features=Xf)
    b = host.score_pair(Xc, Xr, features=Xf)
    np.testing.assert_array_equal(a["anomalous"], b["anomalous"])
    np.testing.assert_array_equal(a["y_pred"], b["y_pred"])
    np.testing.assert_allclose(a["p_struct"], b["p_struct"], rtol=0, atol=2e-5)


def test_validation_errors_and_paths_not_ported(scorer, subset):
    Xc, Xr, Xf = subset
    with pytest.raises(ValueError, match="stacked"):
        scorer.score(Xc)                        # rank 3, no pair axis
    with pytest.raises(ValueError, match="clean/raw"):
        scorer.score_pair(Xc, Xr[:-1])
    ml = OpenLabScorer.from_artifacts(OL, stage2="hgb", device="cpu",
                                      min_bucket=64, max_batch=256)
    with pytest.raises(ValueError, match="features"):
        ml.score_pair(Xc, Xr)
    with pytest.raises(ValueError, match="rows"):
        ml.score_pair(Xc, Xr, features=Xf[:-1])
    with pytest.raises(ValueError, match="unknown stage2"):
        OpenLabScorer.from_artifacts(OL, stage2="nope", device="cpu")
    out = scorer.score(np.zeros((0, 200, 4, 2), np.float32))
    assert out["mse"].shape == (0,)
    with pytest.raises(NotImplementedError, match="item 8"):
        scorer.export_program()
    with pytest.raises(NotImplementedError, match="item 9"):
        OpenLabScorer.from_artifacts(OL, device="cpu", mesh=object())


def test_warmup_buckets_and_manifest_fields(scorer):
    assert list(scorer.buckets()) == [64, 128, 256]
    assert scorer.request_rank == 4 and scorer.num_features == 4
    assert scorer.seq_len == 200 and scorer.ch_idx == (1, 2, 3)
    assert scorer.use_fused_gate is False            # the plain gate on the CPU
    assert scorer.expected_anomaly_rate == pytest.approx(0.05078125)
    assert scorer.calibration_percentile == 95.0
    scorer.warmup([64])
    scorer.warmup_series(stride=2)
    with pytest.raises(ValueError):
        scorer.warmup_series(stride=0)
    old = scorer.threshold
    scorer.set_threshold(1e9)
    try:
        out = scorer.score(np.ones((3, 200, 4, 2), np.float32))
        assert not out["anomalous"].any() and (out["y_pred"] == 0).all()
    finally:
        scorer.set_threshold(old)


def test_the_attention_root_routes_to_its_cell():
    """``data/openlab_attention``'s manifest names the attention cell: the
    scorer builds that VAE, and on the card would launch row 7."""
    sc = OpenLabScorer.from_artifacts(ROOT / "data/openlab_attention",
                                      device="cpu", min_bucket=8, max_batch=8)
    assert sc.vae.cell == "attention" and sc.vae.num_layers == 1
    Xc = np.load(OL / "extracted/X_clean.npy", mmap_mode="r")[:8]
    Xr = np.load(OL / "extracted/X_raw.npy", mmap_mode="r")[:8]
    out = sc.score_pair(np.asarray(Xc), np.asarray(Xr))
    assert np.isfinite(out["mse"]).all()
