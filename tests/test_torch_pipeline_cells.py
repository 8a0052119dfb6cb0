"""The port's HybridScorer on the committed minGRU and attention artifacts
against the JAX package's ``make_hybrid_fn`` (plain XLA path, float32 models).

912 real 4DOF test windows, 304 per group, spread over each group's test
fraction, go through both. Gate decisions and predictions must agree on
every window; mse within rtol 1e-4 (float32 on both sides, summed in other
orders through four temporal stacks), p_struct within atol 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.cli.stage4dof import Paths as JaxPaths
from shm_tpu.cli.stage4dof import _load_vae as jax_load_vae
from shm_tpu.config import Stage4DofConfig as JaxStage4DofConfig
from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.pipeline import make_hybrid_fn as jax_make_hybrid_fn
from shm_tpu.utils.checkpoint import load_params
from shm_tpu_torch.cli.stage4dof import (
    Paths, _load_stats, _load_vae, build_fraction_windows,
)
from shm_tpu_torch.config import Stage4DofConfig
from shm_tpu_torch.serve import HybridScorer
from shm_tpu_torch.utils.io import load_json

ROOT = Path(__file__).resolve().parents[1]
ROOTS = {"min_gru": ROOT / "data" / "4dof_mingru",
         "attention": ROOT / "data" / "4dof_attention"}
GROUPS = ("normal", "sensor_fault", "structural_fault")
PER_GROUP = 304
MSE_RTOL, P_ATOL = 1e-4, 1e-4

torch.set_num_threads(1)      # see tests/test_torch_vae_gate.py


@pytest.fixture(scope="module")
def windows():
    """The windows of ``data/4dof``'s raw runs: the other roots' splits name
    a byte-identical copy of them that is not committed."""
    cfg = Stage4DofConfig()
    splits = load_json(Paths(str(ROOT / "data" / "4dof")).run_splits)
    Ws, ys = [], []
    for g, name in enumerate(GROUPS):
        W = build_fraction_windows(splits[name]["files"], cfg.test_frac, cfg)
        idx = np.linspace(0, len(W) - 1, PER_GROUP).astype(int)
        Ws.append(W[idx])
        ys.append(np.full(PER_GROUP, g))
    return np.concatenate(Ws), np.concatenate(ys)


def _jax_hybrid(art):
    """``W -> outputs``: the JAX package's hybrid on the root's committed
    artifacts, float32 VAE and CNN, plain XLA path, in batches of 304."""
    cfg = JaxStage4DofConfig()
    paths = JaxPaths(str(art))
    vae, vae_params = jax_load_vae(paths, cfg)
    cnn = JaxCNN4DOF(conv_impl="im2col")
    template = cnn.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((2, cfg.seq_len, cfg.num_features, 2)))
    cnn_vars = load_params(template, paths.models / "cnn.msgpack")
    mean, std = _load_stats(Paths(str(art)))
    thr = load_json(art / "processed" / "vae_threshold.json")["threshold"]
    fn = jax_make_hybrid_fn(vae, cnn, use_fused_vae=False)

    def run(W):
        outs = []
        for i in range(0, len(W), 304):
            o = fn(vae_params, cnn_vars, jnp.asarray(W[i:i + 304]),
                   jnp.asarray(mean), jnp.asarray(std), jnp.float32(thr))
            outs.append({k: np.asarray(getattr(o, k))
                         for k in ("mse", "anomalous", "y_pred", "p_struct")})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    return vae.cell, run


@pytest.fixture(scope="module", params=list(ROOTS))
def family(request, windows):
    """(cell, artifact root, the JAX package's outputs on the windows)."""
    cell = request.param
    jax_cell, run = _jax_hybrid(ROOTS[cell])
    assert jax_cell == cell
    return cell, ROOTS[cell], run(windows[0])


@pytest.mark.parametrize("use_fused_vae", [False, True],
                         ids=["modules", "gate_plain_version"])
def test_scorer_matches_jax_hybrid(windows, family, use_fused_vae):
    W, y = windows
    cell, art, ref = family
    s = HybridScorer.from_artifacts(art, device="cpu", min_bucket=128,
                                    max_batch=128, use_fused_vae=use_fused_vae)
    assert s.vae.cell == cell and s.device.type == "cpu"
    assert s.use_fused_vae is use_fused_vae
    out = s.score(W)
    assert len(W) >= 900 and set(np.unique(y)) == {0, 1, 2}
    assert all(len(v) == len(W) for v in out.values())
    assert (out["anomalous"] == ref["anomalous"]).all()
    assert (out["y_pred"] == ref["y_pred"]).all()
    np.testing.assert_allclose(out["mse"], ref["mse"], rtol=MSE_RTOL)
    np.testing.assert_allclose(out["p_struct"], ref["p_struct"], atol=P_ATOL)
    # the trained gate separates the groups on these windows
    assert not out["anomalous"][y == 0].any() and out["anomalous"][y > 0].all()


def test_scorer_defaults_on_cpu(family):
    cell, art, _ = family
    s = HybridScorer.from_artifacts(art, device="cpu")
    assert s.use_fused_vae is False and s.vae.cell == cell
    meta = load_json(art / "processed" / "stage1_vae_train_meta.json")
    assert meta["cell"] == cell


def test_load_vae_reads_the_cell_from_the_manifest(family):
    cell, art, _ = family
    vae = _load_vae(Paths(str(art)), Stage4DofConfig())    # config says "lstm"
    assert vae.cell == cell and not vae.training
    assert (vae.hidden_dim, vae.latent_dim, vae.num_layers) == (128, 16, 2)
    names = set(vae.state_dict())
    if cell == "min_gru":
        assert "encoder_lstm.layers.1.weight_ih" in names
        assert not any("weight_hh" in n for n in names)
    else:
        assert "decoder_lstm.layers.1.query.weight" in names
        assert vae.encoder_lstm.num_heads == 4


@pytest.mark.parametrize("cell, want", [
    ("min_gru", [[2020, 0, 0], [0, 795, 13], [0, 9, 799]]),
    ("attention", [[2020, 0, 0], [0, 798, 10], [0, 9, 799]]),
])
def test_full_test_split_reproduces_the_committed_metrics(cell, want):
    """All 3,636 committed test windows: the port's float32 path and the JAX
    package's float32 path give the same label on every window, and both
    reproduce the root's ``pipeline_metrics.json`` exactly, gate counts and
    confusion matrix (so a run on the card may move no window either)."""
    from shm_tpu_torch.evals import confusion_matrix

    art = ROOTS[cell]
    cfg = Stage4DofConfig()
    splits = load_json(Paths(str(ROOT / "data" / "4dof")).run_splits)
    groups = [build_fraction_windows(splits[g]["files"], cfg.test_frac, cfg)
              for g in GROUPS]
    W = np.concatenate(groups)
    y = np.concatenate([np.full(len(g), i) for i, g in enumerate(groups)])
    ref = load_json(art / "figures" / "pipeline_metrics.json")
    assert ref["confusion_matrix_counts"] == want

    s = HybridScorer.from_artifacts(art, device="cpu", min_bucket=512,
                                    max_batch=512, use_fused_vae=True)
    out = s.score(W)
    jout = _jax_hybrid(art)[1](W)
    assert (out["y_pred"] == jout["y_pred"]).all()
    assert (out["anomalous"] == jout["anomalous"]).all()
    for g, tag in enumerate(("normal/test", "sensor/test", "struct/test")):
        assert out["anomalous"][y == g].sum() == ref["gate"]["gate_stats"][tag]["anom"]
    assert confusion_matrix(y, out["y_pred"], 3).tolist() == want
    assert confusion_matrix(y, jout["y_pred"], 3).tolist() == want
