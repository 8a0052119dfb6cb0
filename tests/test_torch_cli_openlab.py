"""The port's openLAB commands (``shm_tpu_torch/cli/openlab.py``) against the
JAX package's on the same small root, on the CPU: every 4th committed
window with the committed trained artifacts (``tests/torch_openlab_roots.py``).

- ``make-splits`` writes the same ``run_split.json``; ``featurize`` the same
  ``X_feat.npy`` and ``y.npy`` bit for bit, ``meta_used.csv`` byte for byte
  (pandas' text, without pandas) and ``feat_names.json``;
- ``validate-vae``: the same JSON, the threshold within 1e-6 relative (both
  float32 plain passes; measured 0) and the window counts exact;
- ``validate-cnn`` on ``val`` and ``test``: the same JSON, matrices and
  tuned thresholds exact, AUROC within 1e-6;
- ``plots`` draws both figures; ``extract``, ``all`` and ``--devices 2`` are
  refused, naming the ROADMAP item.
"""

import json

import numpy as np
import pytest
import torch

from shm_tpu_torch.cli import openlab as ol
from torch_openlab_roots import OPENLAB, silence_jax_plots, small_root

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same small root twice, then each package's commands on its own."""
    from shm_tpu.cli import openlab as jol

    base = tmp_path_factory.mktemp("openlab_cli")
    port = small_root(base / "port")
    jax_root = small_root(base / "jax")
    with pytest.MonkeyPatch.context() as mp:
        silence_jax_plots(mp)
        # the per-window CNN in batches of 512, not 4,096 (no output changes)
        import functools

        mp.setattr(jol, "predict_probs",
                   functools.partial(jol.predict_probs, batch_size=512))
        from shm_tpu.config import OpenLabConfig

        jp = jol.Paths(str(jax_root), "")
        jol.cmd_make_splits(jp, OpenLabConfig())
        jol.cmd_featurize(jp, OpenLabConfig())
        jol.cmd_validate_vae(jp, OpenLabConfig())
        jol.cmd_validate_cnn(jp, OpenLabConfig(), "val")
        jol.cmd_validate_cnn(jp, OpenLabConfig(), "test")
    for cmd in (["make-splits"], ["featurize"], ["validate-vae"],
                ["validate-cnn"], ["validate-cnn", "--split", "test"]):
        ol.main(cmd + ["--root", str(port), "--device", "cpu", "--no-plots"])
    return port, jax_root


def _json(root, rel):
    return json.loads((root / rel).read_text())


def test_make_splits_and_featurize(roots):
    port, jax_root = roots
    got = _json(port, "extracted/run_split.json")
    assert got == _json(jax_root, "extracted/run_split.json")
    committed = _json(OPENLAB, "extracted/run_split.json")
    for k in ("train_runs", "val_runs", "test_runs", "seed", "fractions"):
        assert got[k] == committed[k], k
    for name in ("X_feat", "y"):
        a = np.load(port / f"features/{name}.npy")
        b = np.load(jax_root / f"features/{name}.npy")
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert ((port / "features/meta_used.csv").read_bytes()
            == (jax_root / "features/meta_used.csv").read_bytes())
    assert _json(port, "features/feat_names.json") == _json(
        jax_root, "features/feat_names.json")


def test_make_splits_reproduces_the_committed_split(tmp_path):
    (tmp_path / "extracted").mkdir()
    for name in ("X_clean.npy", "X_raw.npy", "window_labels.csv"):
        (tmp_path / "extracted" / name).symlink_to(OPENLAB / "extracted" / name)
    ol.main(["make-splits", "--root", str(tmp_path), "--device", "cpu"])
    assert _json(tmp_path, "extracted/run_split.json") == _json(
        OPENLAB, "extracted/run_split.json")


def test_validate_vae(roots):
    port, jax_root = roots
    rel = "output/VAE_Validation_and_Thresholding/artifacts/vae_threshold.json"
    a, b = _json(port, rel), _json(jax_root, rel)
    assert a.keys() == b.keys()
    assert a["threshold"] == pytest.approx(b["threshold"], rel=1e-6)
    for k in a:
        if k != "threshold":
            assert a[k] == b[k], k
    assert a["n_val_normal"] >= 50


@pytest.mark.parametrize("split", ["val", "test"])
def test_validate_cnn(roots, split):
    port, jax_root = roots
    rel = f"output/CNN_Validation/artifacts/cnn_{split}_summary.json"
    a, b = _json(port, rel), _json(jax_root, rel)
    assert a.keys() == b.keys()
    assert a["confusion_matrix"] == b["confusion_matrix"]
    assert a["threshold"] == b["threshold"] and a["n"] == b["n"]
    assert a["auroc_st"] == pytest.approx(b["auroc_st"], abs=1e-6)
    assert a["st"] == pytest.approx(b["st"])
    if split == "val":
        assert a["tuning"] == pytest.approx(b["tuning"])
        t = np.load(port / "output/CNN_Validation/artifacts/cnn_best_threshold.npy")
        assert t.dtype == np.float32 and t[0] == np.float32(a["threshold"])


def test_plots_draw_both_figures(roots, tmp_path):
    pytest.importorskip("matplotlib")
    import shutil

    rep = OPENLAB / "output/Hybrid_Pipeline/reports"
    shutil.copytree(rep, tmp_path / "output/Hybrid_Pipeline/reports")
    ol.main(["plots", "--root", str(tmp_path), "--device", "cpu"])
    out = tmp_path / "output/Hybrid_Pipeline/plots"
    for stem in ("hybrid_cm_grid", "hybrid_stage2_metrics_bar"):
        for ext in ("pdf", "png", "svg"):
            assert (out / f"{stem}.{ext}").stat().st_size > 0


@pytest.mark.parametrize("argv", [["extract"], ["all"]])
def test_extract_and_all_are_not_ported(argv, tmp_path):
    with pytest.raises(NotImplementedError, match="item 7b"):
        ol.main(argv + ["--root", str(tmp_path), "--device", "cpu"])


def test_devices_refused(tmp_path, capsys):
    with pytest.raises(SystemExit):
        ol.main(["make-splits", "--devices", "2", "--root", str(tmp_path)])
    assert "item 9" in capsys.readouterr().err
