"""The port's HybridScorer on the committed 4DOF artifacts against the JAX
package's ``make_hybrid_fn`` (plain XLA path, float32 models).

192 real test windows, 64 per group, go through both. Gate decisions and
predictions must agree on every window; mse within rtol 1e-5 and p_struct
within atol 1e-5 (float32 on both sides, summed in different orders over a
200-step recurrence).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.cli.stage4dof import Paths as JaxPaths
from shm_tpu.cli.stage4dof import _load_vae as jax_load_vae
from shm_tpu.cli.stage4dof import build_fraction_windows as jax_build_fraction_windows
from shm_tpu.config import Stage4DofConfig as JaxStage4DofConfig
from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.pipeline import make_hybrid_fn as jax_make_hybrid_fn
from shm_tpu.utils.checkpoint import load_params
from shm_tpu_torch.cli.stage4dof import Paths, _load_stats, build_fraction_windows
from shm_tpu_torch.config import Stage4DofConfig
from shm_tpu_torch.evals import accuracy, confusion_matrix
from shm_tpu_torch.pipeline import make_hybrid_fn, run_hybrid_batched
from shm_tpu_torch.serve import HybridScorer, bucket_series, bucket_size
from shm_tpu_torch.utils.io import load_json

ROOT = Path(__file__).resolve().parents[1]
ART = ROOT / "data" / "4dof"
GROUPS = ("normal", "sensor_fault", "structural_fault")
PER_GROUP = 64

# pytest-xdist runs several test files at once on the same cores; torch's
# default of one thread per core makes those workers spin against each other.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def windows():
    """64 test windows per group, spread over each group's test fraction."""
    cfg = Stage4DofConfig()
    splits = load_json(Paths(str(ART)).run_splits)
    Ws, ys = [], []
    for g, name in enumerate(GROUPS):
        W = build_fraction_windows(splits[name]["files"], cfg.test_frac, cfg)
        idx = np.linspace(0, len(W) - 1, PER_GROUP).astype(int)
        Ws.append(W[idx])
        ys.append(np.full(PER_GROUP, g))
    return np.concatenate(Ws), np.concatenate(ys)


@pytest.fixture(scope="module")
def scorer():
    return HybridScorer.from_artifacts(ART, device="cpu", min_bucket=64,
                                       max_batch=128)


@pytest.fixture(scope="module")
def jax_model():
    """``W -> outputs``: the JAX package's hybrid on the committed artifacts,
    float32 VAE and CNN, plain XLA path."""
    cfg = JaxStage4DofConfig()
    paths = JaxPaths(str(ART))
    vae, vae_params = jax_load_vae(paths, cfg)
    cnn = JaxCNN4DOF(conv_impl="im2col")
    template = cnn.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((2, cfg.seq_len, cfg.num_features, 2)))
    cnn_vars = load_params(template, paths.models / "cnn.msgpack")
    mean, std = _load_stats(Paths(str(ART)))
    thr = load_json(ART / "processed" / "vae_threshold.json")["threshold"]
    fn = jax_make_hybrid_fn(vae, cnn, use_fused_vae=False)

    def run(W):
        out = fn(vae_params, cnn_vars, jnp.asarray(W), jnp.asarray(mean),
                 jnp.asarray(std), jnp.float32(thr))
        return {k: np.asarray(getattr(out, k)) for k in
                ("mse", "anomalous", "y_pred", "p_struct", "logits")}

    return run


@pytest.fixture(scope="module")
def jax_out(windows, jax_model):
    return jax_model(windows[0])


def _check_against_jax(out, ref):
    assert (out["anomalous"] == ref["anomalous"]).all()
    assert (out["y_pred"] == ref["y_pred"]).all()
    np.testing.assert_allclose(out["mse"], ref["mse"], rtol=1e-5)
    np.testing.assert_allclose(out["p_struct"], ref["p_struct"], atol=1e-5)


@pytest.mark.parametrize("use_fused_vae", [False, True],
                         ids=["modules", "gate_plain_version"])
def test_scorer_matches_jax_hybrid(windows, jax_out, use_fused_vae):
    W, y = windows
    s = HybridScorer.from_artifacts(ART, device="cpu", min_bucket=64,
                                    max_batch=128, use_fused_vae=use_fused_vae)
    assert s.use_fused_vae is use_fused_vae and s.device.type == "cpu"
    out = s.score(W)
    assert set(out) == {"mse", "anomalous", "y_pred", "p_struct"}
    assert all(len(v) == len(W) for v in out.values())
    _check_against_jax(out, jax_out)
    # the trained gate separates the groups on these windows
    assert not out["anomalous"][y == 0].any() and out["anomalous"][y > 0].all()


def test_scorer_defaults_on_cpu(scorer):
    assert scorer.use_fused_vae is False          # the kernel is for CUDA
    assert scorer.seq_len == 100 and scorer.num_features == 12
    assert abs(float(scorer.threshold) - 1.3861113786697388) < 1e-6


def test_run_hybrid_batched_matches_jax(windows, jax_out, scorer):
    W, _ = windows
    fn = make_hybrid_fn(scorer.vae, scorer.cnn, use_fused_vae=True)
    out = run_hybrid_batched(fn, W, scorer.mean, scorer.std, scorer.threshold,
                             batch_size=100)       # ragged last batch
    _check_against_jax(out, jax_out)


def test_metrics_on_jax_outputs(windows, jax_out):
    _, y = windows
    cm = confusion_matrix(y, jax_out["y_pred"], 3)
    assert cm.sum() == len(y) and (cm.sum(1) == PER_GROUP).all()
    assert accuracy(y, jax_out["y_pred"]) == pytest.approx(np.trace(cm) / cm.sum())


def test_score_series_matches_score(scorer):
    rng = np.random.default_rng(0)
    x = (scorer.mean.numpy() + scorer.std.numpy()
         * rng.normal(size=(100 + 69, 12))).astype(np.float32)
    from shm_tpu_torch.data.windows import make_windows_np

    W = make_windows_np(x, 100, 2)
    a, b = scorer.score_series(x, stride=2), scorer.score(W)
    assert len(a["mse"]) == len(W) == 35
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_gate_is_strict_and_threshold_swappable(scorer, windows):
    W, _ = windows
    out = scorer.score(W[:4])
    old = float(scorer.threshold)
    try:
        scorer.set_threshold(float(out["mse"][0]))
        again = scorer.score(W[:4])
        assert not again["anomalous"][0]              # mse == threshold -> normal
        assert again["y_pred"][0] == 0 and again["p_struct"][0] == 0.0
    finally:
        scorer.set_threshold(old)


def test_empty_and_bad_requests(scorer):
    out = scorer.score(np.zeros((0, 100, 12), np.float32))
    assert all(v.shape == (0,) for v in out.values())
    assert scorer.score_series(np.zeros((50, 12), np.float32))["mse"].shape == (0,)
    with pytest.raises(ValueError):
        scorer.score(np.zeros((3, 100), np.float32))
    with pytest.raises(ValueError):
        scorer.score_series(np.zeros((200, 12), np.float32), stride=0)


def test_nonfinite_windows_stay_finite(scorer, windows):
    W = windows[0][:3].copy()
    W[0, 5, 2] = np.nan
    W[1, :, 0] = np.inf
    out = scorer.score(W)
    assert np.isfinite(out["mse"]).all() and np.isfinite(out["p_struct"]).all()


def test_warmup_runs_every_bucket(scorer):
    assert list(scorer.buckets()) == [64, 128]
    scorer.warmup(batch_sizes=[2])


@pytest.mark.parametrize("n, want", [(1, 64), (64, 64), (65, 128), (128, 128),
                                     (500, 128)])
def test_bucket_size(n, want):
    assert bucket_size(n, 64, 128) == want


def test_bucket_series():
    assert list(bucket_series(256, 8192)) == [256, 512, 1024, 2048, 4096, 8192]
    assert list(bucket_series(100, 300)) == [100, 200, 300]


def test_fraction_windows_match_jax():
    cfg = Stage4DofConfig()
    splits = load_json(Paths(str(ART)).run_splits)
    files = splits["sensor_fault"]["files"][:1]
    got = build_fraction_windows(files, cfg.test_frac, cfg)
    want = jax_build_fraction_windows([str(ROOT / f) for f in files],
                                      cfg.test_frac, JaxStage4DofConfig())
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_full_test_split_matches_jax_float32(jax_model):
    """All 3,636 committed test windows: the port's float32 path and the JAX
    package's float32 path give the same label on every window, and both
    move exactly 2 windows of ``pipeline_metrics.json``'s confusion matrix
    (the file was made at another matmul precision); the gate matches it."""
    cfg = Stage4DofConfig()
    splits = load_json(Paths(str(ART)).run_splits)
    groups = [build_fraction_windows(splits[g]["files"], cfg.test_frac, cfg)
              for g in GROUPS]
    W = np.concatenate(groups)
    y = np.concatenate([np.full(len(g), i) for i, g in enumerate(groups)])
    ref = load_json(ART / "figures" / "pipeline_metrics.json")

    s = HybridScorer.from_artifacts(ART, device="cpu", min_bucket=4096,
                                    max_batch=4096, use_fused_vae=True)
    out = s.score(W)
    jout = jax_model(W)
    assert (out["y_pred"] == jout["y_pred"]).all()
    assert (out["anomalous"] == jout["anomalous"]).all()
    for g, tag in enumerate(("normal/test", "sensor/test", "struct/test")):
        assert out["anomalous"][y == g].sum() == ref["gate"]["gate_stats"][tag]["anom"]
    cm = confusion_matrix(y, out["y_pred"], 3)
    assert cm.tolist() == [[2020, 0, 0], [0, 796, 12], [0, 11, 797]]
    assert np.abs(cm - np.asarray(ref["confusion_matrix_counts"])).sum() // 2 == 2


def test_load_stats_floors_zero_std(tmp_path):
    (tmp_path / "processed").mkdir()
    np.savez(tmp_path / "processed" / "normal_stats.npz",
             mean=np.arange(3, dtype=np.float64), std=np.array([1.0, 0.0, 2.0]))
    mean, std = _load_stats(Paths(str(tmp_path)))
    assert mean.dtype == std.dtype == np.float32
    np.testing.assert_array_equal(std, np.array([1.0, 1e-6, 2.0], np.float32))


@pytest.mark.parametrize("cell", ["min_gru", "attention"])
def test_load_vae_refuses_unported_cells(tmp_path, cell):
    """Every cell family is ported now; what is refused is a checkpoint of
    another family than the root's manifest names: it raises and never
    loads."""
    import shutil

    from shm_tpu_torch.cli.stage4dof import _load_vae

    for sub in ("models", "processed"):
        shutil.copytree(ART / sub, tmp_path / sub)
    (tmp_path / "processed" / "stage1_vae_train_meta.json").write_text(
        '{"cell": "%s"}' % cell)
    with pytest.raises(ValueError, match=f"holds a 'lstm' VAE, not the {cell!r}"):
        _load_vae(Paths(str(tmp_path)), Stage4DofConfig())
    # and the other way round: the family's checkpoint under an LSTM manifest
    other = ROOT / "data" / ("4dof_mingru" if cell == "min_gru" else "4dof_attention")
    shutil.copy(other / "models" / "temporal_vae.msgpack", tmp_path / "models")
    (tmp_path / "processed" / "stage1_vae_train_meta.json").write_text(
        '{"cell": "lstm"}')
    with pytest.raises(ValueError, match=f"holds a {cell!r} VAE, not the 'lstm'"):
        _load_vae(Paths(str(tmp_path)), Stage4DofConfig())
    with pytest.raises(ValueError, match="temporal_vae.msgpack"):
        HybridScorer.from_artifacts(tmp_path, device="cpu")


@pytest.mark.parametrize("cell, H, L, device, takes", [
    ("lstm", 128, 2, "cuda", True), ("lstm", 128, 1, "cuda", True),
    ("lstm", 128, 3, "cuda", False), ("lstm", 128, 2, "cpu", True),
    ("min_gru", 128, 2, "cuda", True), ("min_gru", 64, 1, "cuda:0", True),
    ("min_gru", 32, 3, "cuda", True), ("min_gru", 128, 2, "cpu", True),
    ("attention", 128, 2, "cuda", True), ("attention", 32, 1, "cuda", True),
    ("attention", 256, 2, "cuda", False), ("attention", 48, 1, "cuda", False),
    ("attention", 128, 2, "cpu", True), ("gru", 128, 2, "cuda", False),
])
def test_auto_fused_gate_policy(cell, H, L, device, takes):
    """The default turns the fused gate on, on CUDA, for the models the JAX
    package's rule sends to its kernels (and a minGRU of 3 or 4 layers), and
    off on the CPU; here that is every model whose kernel takes it. A cell
    or a preset the cell's kernel does not take is refused with
    ``ValueError`` by the look-up or by the checks the wrapper makes before
    a launch."""
    from types import SimpleNamespace

    from shm_tpu_torch import ops
    from shm_tpu_torch.models import TemporalVAE

    on_card = device.startswith("cuda")
    spec = SimpleNamespace(cell=cell, hidden_dim=H, num_layers=L)
    assert ops.auto_fused_gate(spec, device) is (on_card and takes)
    assert ops.auto_fused_gate(spec, torch.device(device)) is (on_card and takes)

    if cell not in ops.FUSED_GATES:
        with pytest.raises(ValueError, match=f"no fused kernel for cell={cell!r}"):
            ops.fused_gate_for(SimpleNamespace(cell=cell))
        return
    Z = torch.zeros(2, 6, 5)
    try:
        model = TemporalVAE(5, 4, H, L, cell=cell)
        weights_fn, gate = ops.fused_gate_for(model)
        module = __import__(gate.__module__, fromlist=["_check"])
        module._check(weights_fn(model), Z, L, True)
        refused = False
    except ValueError:
        refused = True
    assert refused is (not takes)


def test_fused_flag_with_an_unknown_cell_raises(scorer):
    from types import SimpleNamespace

    from shm_tpu_torch.ops import FUSED_GATES, fused_gate_for

    with pytest.raises(ValueError, match="no fused kernel for cell='gru'"):
        make_hybrid_fn(SimpleNamespace(cell="gru"), scorer.cnn, use_fused_vae=True)
    make_hybrid_fn(SimpleNamespace(cell="gru"), scorer.cnn)    # plain path: no lookup
    assert set(FUSED_GATES) == {"lstm", "min_gru", "attention"}
    for cell, (weights_fn, gate, reference) in FUSED_GATES.items():
        assert fused_gate_for(SimpleNamespace(cell=cell)) == (weights_fn, gate)
        assert gate.launches >= 0 and reference.__name__ == gate.__name__ + "_reference"


def test_load_vae_reads_the_lstm_artifact():
    from shm_tpu_torch.cli.stage4dof import _load_vae

    vae = _load_vae(Paths(str(ART)), Stage4DofConfig())
    assert (vae.hidden_dim, vae.latent_dim, vae.num_layers) == (128, 16, 2)
    assert vae.layer_norm is not None and not vae.training


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    """With no ``device=`` the entry points run on CUDA; without a card they
    raise instead of dropping to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridScorer.from_artifacts(ART)
    from shm_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
