"""The port's bf16 ``HybridScorer`` against the JAX package's bf16 scorer on
committed windows, on the CPU.

``HybridScorer.from_artifacts(root, fused_dtype=bf16, cnn_dtype=bf16,
device="cpu", use_fused_vae=True)`` runs the gate's plain version in its
bf16 mode and CNN4DOF in bf16. The JAX side is what the JAX
``HybridScorer`` runs on its chip, composed here from its parts: the gate
kernel at ``dtype=bf16`` with the io it serves (interpret mode,
``emulate=True``; ``make_hybrid_fn``'s interpret path drops the attention
gate's bf16 io), the residual cast to float32, and ``CNN4DOF(dtype=bf16)``.
The windows are the 120 of ``tests/test_serve.py``'s bf16 test (the first
40 test windows of the first run of each group). Gate decisions and
``y_pred`` must be equal, ``p_struct`` within 2e-2 (the JAX package's own
bar between its precisions), mse within the bars of
``tests/test_torch_gate_bf16.py``. A mesh scorer passes both precisions
to every shard; the plain path ignores ``fused_dtype``.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.cli.stage4dof import Paths as JaxPaths
from shm_tpu.cli.stage4dof import _load_vae as jax_load_vae
from shm_tpu.config import Stage4DofConfig as JaxConfig
from shm_tpu.data.windows import normalize_windows as jax_normalize
from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.ops import (fused_attention_gate, fused_mingru_gate,
                         fused_vae_gate)
from shm_tpu.utils.checkpoint import load_params
from shm_tpu_torch.cli.stage4dof import Paths, _load_stats, build_fraction_windows
from shm_tpu_torch.config import Stage4DofConfig
from shm_tpu_torch.serve import HybridScorer
from shm_tpu_torch.utils.io import load_json

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {  # cell: (root, JAX gate, bf16 io, mse (max, mean) bar)
    "lstm": ("data/4dof", fused_vae_gate, False, (1e-4, 1e-4)),
    "min_gru": ("data/4dof_mingru", fused_mingru_gate, False, (1e-4, 1e-4)),
    "attention": ("data/4dof_attention", fused_attention_gate, True,
                  (1e-3, 1e-4)),
}
P_ATOL = 2e-2
BF16 = dict(fused_dtype=torch.bfloat16, cnn_dtype=torch.bfloat16,
            device="cpu", use_fused_vae=True, min_bucket=128, max_batch=128)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def windows():
    cfg = Stage4DofConfig()
    splits = load_json(Paths(str(ROOT / "data" / "4dof")).run_splits)
    return np.concatenate([
        build_fraction_windows(splits[g]["files"][:1], cfg.test_frac, cfg)[:40]
        for g in ("normal", "sensor_fault", "structural_fault")]
    ).astype(np.float32)


def jax_bf16_hybrid(cell: str, W: np.ndarray) -> dict:
    """The JAX package's bf16 scoring of ``W`` on the family's root."""
    rel, gate, io_bf16, _ = FAMILIES[cell]
    root = ROOT / rel
    cfg = JaxConfig()
    vae, params = jax_load_vae(JaxPaths(str(root)), cfg)
    cnn = JaxCNN4DOF(dtype=jnp.bfloat16, conv_impl="im2col")
    template = cnn.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((2, cfg.seq_len, cfg.num_features, 2)))
    cnn_vars = load_params(template, root / "models" / "cnn.msgpack")
    mean, std = _load_stats(Paths(str(root)))
    thr = load_json(root / "processed" / "vae_threshold.json")["threshold"]
    Z = jax_normalize(jnp.asarray(W), jnp.asarray(mean), jnp.asarray(std))
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm,
              dtype=jnp.bfloat16, interpret=True, emulate=True,
              io_dtype=jnp.bfloat16 if io_bf16 else None)
    if cell == "attention":
        kw["batch_tile"] = 16
    mse, resid = gate(params, Z, **kw)
    logits = cnn.apply(cnn_vars, jnp.stack([Z, resid.astype(Z.dtype)], -1),
                       train=False)
    anom = np.asarray(mse > jnp.float32(thr))
    probs = np.asarray(jax.nn.softmax(logits, axis=1))
    cls = np.asarray(jnp.argmax(logits, axis=1))
    return {"mse": np.asarray(mse), "anomalous": anom,
            "y_pred": np.where(anom, cls + 1, 0),
            "p_struct": np.where(anom, probs[:, 1], 0.0)}


@pytest.mark.parametrize("cell", list(FAMILIES))
def test_bf16_scorer_matches_the_jax_bf16_scorer(cell, windows):
    sc = HybridScorer.from_artifacts(ROOT / FAMILIES[cell][0], **BF16)
    assert sc.vae.cell == cell and sc.cnn.dtype == torch.bfloat16
    got = sc.score(windows)
    want = jax_bf16_hybrid(cell, windows)
    np.testing.assert_array_equal(got["anomalous"], want["anomalous"])
    np.testing.assert_array_equal(got["y_pred"], want["y_pred"])
    np.testing.assert_allclose(got["p_struct"], want["p_struct"], rtol=0,
                               atol=P_ATOL)
    rel = np.abs(got["mse"].astype(np.float64) - want["mse"]) / want["mse"]
    bar_max, bar_mean = FAMILIES[cell][3]
    assert rel.max() <= bar_max and rel.mean() <= bar_mean
    assert set(np.unique(got["y_pred"])) == {0, 1, 2}


def test_mesh_passes_both_precisions_to_every_shard(windows):
    """Two CPU shards score as the scorer without a mesh in bf16, and away
    from the float32 scorer: both options reach every shard."""
    from shm_tpu_torch.parallel import make_mesh

    root = ROOT / "data" / "4dof"
    one = HybridScorer.from_artifacts(root, **BF16).score(windows)
    mesh = HybridScorer.from_artifacts(
        root, **dict(BF16, device=None), mesh=make_mesh(2, device="cpu"))
    assert mesh.cnn.dtype == torch.bfloat16 and mesh.fused_dtype == torch.bfloat16
    got = mesh.score(windows)
    f32 = HybridScorer.from_artifacts(root, device="cpu", use_fused_vae=True,
                                      min_bucket=128, max_batch=128
                                      ).score(windows)
    for k in ("anomalous", "y_pred"):
        np.testing.assert_array_equal(got[k], one[k])
    np.testing.assert_allclose(got["mse"], one["mse"], rtol=1e-5)
    np.testing.assert_allclose(got["p_struct"], one["p_struct"], atol=1e-5)
    assert np.abs(got["mse"] / f32["mse"] - 1).max() > 1e-4
    assert np.abs(got["p_struct"] - f32["p_struct"]).max() > 1e-5


def test_plain_path_ignores_fused_dtype(windows):
    root = ROOT / "data" / "4dof"
    a = HybridScorer.from_artifacts(root, device="cpu", use_fused_vae=False,
                                    fused_dtype=torch.bfloat16,
                                    min_bucket=128, max_batch=128).score(windows)
    b = HybridScorer.from_artifacts(root, device="cpu", use_fused_vae=False,
                                    min_bucket=128, max_batch=128).score(windows)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
