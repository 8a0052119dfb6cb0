"""``OpenLabScorer(gate_io_dtype=bf16)`` against the JAX package's scorer in
the same mode, and the ``.shmx`` export of a scorer with a bf16 CNN, on the
CPU.

openLAB: 128 committed test-run windows, evenly spread (both sides of the
gate). The JAX scorer runs its gate kernel in interpret mode with
``gate_interpret=True, gate_io_dtype=bf16`` (bf16 products, ``emulate``,
a bf16 window tile: what it runs on its chip); the port's runs the gate's
plain version in bf16 with a bf16 window tile. Gate decisions and
``y_pred`` equal, ``p_struct`` within 2e-2, mse within 1e-3 relative and
1e-5 on average (measured 3.95e-4 on one window, 3.3e-6 on average; the
bf16 window tile moves the mse from float32's by 0.42% on average).

Export: the JAX package's ``export_scorer`` traces the scorer's
``cnn_model`` as it is, so a scorer built with ``cnn_dtype=bf16`` exports
a bf16 CNN (beside the plain float32 VAE path). The port's export does the
same: the program's logits are the bf16 CNN's, not the float32 one's.
"""

import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu_torch.serve_openlab import OpenLabScorer

ROOT = Path(__file__).resolve().parents[1]
OL = ROOT / "data" / "openlab"
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs():
    from shm_tpu_torch.utils.io import load_csv_table

    meta = load_csv_table(OL / "extracted/window_labels.csv")
    runs = json.loads((OL / "extracted/run_split.json").read_text())["test_runs"]
    test = np.flatnonzero(np.isin(meta["run_id"], runs))
    idx = test[np.linspace(0, len(test) - 1, 128).astype(int)]
    Xc = np.load(OL / "extracted/X_clean.npy", mmap_mode="r")[idx]
    Xr = np.load(OL / "extracted/X_raw.npy", mmap_mode="r")[idx]
    return (np.ascontiguousarray(Xc, np.float32),
            np.ascontiguousarray(Xr, np.float32))


def test_openlab_bf16_gate_matches_the_jax_scorer(pairs):
    from shm_tpu.serve_openlab import OpenLabScorer as JaxScorer

    Xc, Xr = pairs
    kw = dict(min_bucket=128, max_batch=128)
    got = OpenLabScorer.from_artifacts(
        OL, device="cpu", use_fused_gate=True, gate_io_dtype=torch.bfloat16,
        **kw).score_pair(Xc, Xr)
    want = JaxScorer.from_artifacts(
        OL, use_fused_gate=True, gate_interpret=True,
        gate_io_dtype=jnp.bfloat16, **kw).score_pair(Xc, Xr)
    anom = np.asarray(want["anomalous"]).astype(bool)
    assert 10 < anom.sum() < 118, "the windows must sit on both sides of the gate"
    np.testing.assert_array_equal(got["anomalous"].astype(bool), anom)
    np.testing.assert_array_equal(got["y_pred"], np.asarray(want["y_pred"]))
    np.testing.assert_allclose(got["p_struct"], np.asarray(want["p_struct"]),
                               rtol=0, atol=2e-2)
    rel = np.abs(got["mse"].astype(np.float64) / np.asarray(want["mse"]) - 1)
    assert rel.max() <= 1e-3 and rel.mean() <= 1e-5, (rel.max(), rel.mean())
    f32 = OpenLabScorer.from_artifacts(OL, device="cpu", use_fused_gate=True,
                                       **kw).score_pair(Xc, Xr)
    assert np.abs(got["mse"] / f32["mse"] - 1).mean() > 1e-3   # bf16 ran


def test_openlab_gate_io_dtype_is_checked():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        OpenLabScorer.from_artifacts(OL, device="cpu",
                                     gate_io_dtype=torch.float16)


def test_export_carries_the_bf16_cnn():
    from torch_serve_models import T, port_scorer, windows

    from shm_tpu_torch.export import export_scorer
    from shm_tpu_torch.models.cnn import CNN4DOF

    sc = port_scorer(threshold=0.5)
    bf = CNN4DOF(2, T, 4, dtype=torch.bfloat16)
    bf.load_state_dict(sc.cnn.state_dict())
    sc.cnn = bf.eval()
    W = torch.from_numpy(windows(8, seed=3))
    ep = torch.export.load(io.BytesIO(export_scorer(sc)))
    logits = ep.module()(W)[4]
    with torch.no_grad():
        from shm_tpu_torch.data.windows import normalize_windows
        from shm_tpu_torch.models.cnn import stack_vae_residual_nhwc

        Z = normalize_windows(W, sc.mean, sc.std)
        recon, _, _ = sc.vae(Z)
        xin = stack_vae_residual_nhwc(Z, recon)
        want, f32 = sc.cnn(xin), CNN4DOF(2, T, 4).eval()
        f32.load_state_dict(sc.cnn.state_dict())
        f32 = f32(xin)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert not np.allclose(logits.numpy(), f32.numpy(), rtol=1e-6, atol=1e-6)
