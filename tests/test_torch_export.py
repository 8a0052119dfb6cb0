"""The port's ``.shmx`` export (``shm_tpu_torch/export.py``) on the CPU: the
cases of the JAX package's ``tests/test_export.py`` (round trip, symbolic
batch, manifest and buckets, the shared bucket policy, refusals, a newer
format, ``score_series``, the daemon over an exported scorer; the two other
families' committed roots and the openLAB CNN mode are in
``tests/test_torch_export_cells.py``), and

- the port's artifact against the JAX package's
  ``save_exported_scorer(platforms=("cpu",))`` of the same weights on the
  same windows: mse within 2e-6 (``tests/test_ops.py``'s float32 bound),
  gates and ``y_pred`` equal;
- a JAX artifact is refused by name.

The exported program is the plain path the in-process scorer runs on the
CPU, so its outputs are the scorer's bit for bit.
"""

import json
import threading
import zipfile

import numpy as np
import pytest
import torch

from shm_tpu_torch.export import (
    FORMAT_VERSION, export_scorer, load_exported_scorer,
    save_exported_scorer,
)
from shm_tpu_torch.serve import bucket_size
from torch_serve_models import (
    KEYS, MSE_ATOL, T, D, jax_scorer, octet, port_scorer, req, windows,
)

torch.set_num_threads(1)


def same(got: dict, ref: dict) -> None:
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def scorer():
    return port_scorer(min_bucket=8, max_batch=32)


@pytest.fixture(scope="module")
def artifact(scorer, tmp_path_factory):
    path = tmp_path_factory.mktemp("export") / "gate.shmx"
    save_exported_scorer(scorer, path, extra_manifest={"note": "test"})
    return path


@pytest.fixture(scope="module")
def loaded(artifact):
    return load_exported_scorer(artifact, device="cpu")


def test_roundtrip_score_matches_in_process(scorer, loaded):
    """The loaded program against the in-process scorer across a request
    of a full 32-batch and a padded bucket for the remainder of 45."""
    W = windows(45, seed=1)
    out = loaded.score(W)
    same(out, scorer.score(W))
    assert out["anomalous"].any() and not out["anomalous"].all()


def test_shape_polymorphic_batch(scorer, loaded):
    """One program serves every batch size, in the bucket series or not;
    a single window is padded to the program's smallest batch."""
    W = windows(7, seed=2)
    out = loaded.call(W)
    ref = scorer.score(W)
    np.testing.assert_array_equal(out.mse.numpy(), ref["mse"])
    assert tuple(out.logits.shape) == (7, 2)
    one = loaded.call(W[:1])
    assert one.mse.shape == (1,) and one.mse[0] == out.mse[0]


def test_manifest_and_buckets(scorer, loaded, artifact):
    m = loaded.manifest
    assert m["format_version"] == FORMAT_VERSION
    assert m["seq_len"] == T and m["num_features"] == D
    assert m["cell"] == "lstm" and m["num_layers"] == 2
    assert m["pipeline"] == "4dof" and m["request_rank"] == 3
    assert m["devices"] == ["cpu"] and m["torch_version"] == torch.__version__
    assert m["threshold"] == float(scorer.threshold)
    assert m["note"] == "test"
    assert "jax_version" not in m and "platforms" not in m
    assert list(loaded.buckets()) == [8, 16, 32]
    assert loaded.exported and loaded.mesh is None and not loaded.use_fused_vae
    assert not hasattr(loaded, "set_threshold")
    loaded.warmup([8])
    assert loaded.score(np.zeros((0, T, D), np.float32))["mse"].shape == (0,)
    other = load_exported_scorer(artifact, device="cpu", min_bucket=16,
                                 max_batch=16)
    assert list(other.buckets()) == [16]
    with pytest.raises(ValueError, match="min_bucket"):
        load_exported_scorer(artifact, device="cpu", min_bucket=0)


def test_bucket_size_policy_shared():
    """The port's bucket policy is the JAX package's (same series, caps)."""
    from shm_tpu.serve import bucket_size as jax_bucket_size

    for n in (1, 8, 9, 16, 31, 32, 33, 1000):
        assert bucket_size(n, 8, 32) == jax_bucket_size(n, 8, 32)


def test_export_rejects_mesh_and_missing_seq_len(scorer):
    with pytest.raises(ValueError, match="seq_len"):
        export_scorer(port_scorer(seq_len=None))
    meshed = port_scorer()
    meshed.mesh = object()
    with pytest.raises(ValueError, match="mesh"):
        export_scorer(meshed)


def test_loader_rejects_newer_format_and_jax_artifacts(scorer, artifact, tmp_path):
    newer = tmp_path / "future.shmx"
    with zipfile.ZipFile(artifact) as zin, zipfile.ZipFile(newer, "w") as zout:
        m = json.loads(zin.read("manifest.json"))
        m["format_version"] = FORMAT_VERSION + 1
        zout.writestr("manifest.json", json.dumps(m))
        zout.writestr("program.torch_export", zin.read("program.torch_export"))
    with pytest.raises(ValueError, match="newer"):
        load_exported_scorer(newer, device="cpu")
    from shm_tpu.export import save_exported_scorer as jax_save

    jax_art = jax_save(jax_scorer(min_bucket=8, max_batch=32), tmp_path / "jax.shmx",
                       platforms=("cpu",))
    with pytest.raises(ValueError, match="program.jax_export"):
        load_exported_scorer(jax_art, device="cpu")


def test_score_series_matches_in_process(scorer, loaded):
    """The host windowing of the loaded scorer against the in-process
    scorer's device windowing, at strides 1 and 3 and a too-short series."""
    x = np.random.default_rng(3).normal(size=(83, D)).astype(np.float32)
    for stride in (1, 3):
        same(loaded.score_series(x, stride=stride), scorer.score_series(x, stride=stride))
    assert loaded.score_series(x[:5])["mse"].shape == (0,)
    with pytest.raises(ValueError, match="stride"):
        loaded.score_series(x, stride=0)
    with pytest.raises(ValueError, match="score_pair"):
        loaded.score_pair(x[None], x[None])
    loaded.warmup_series(2)


def test_http_daemon_serves_exported_artifact(scorer, loaded):
    """make_server over an ExportedScorer: /info says exported, /score and
    /score_series answer as the in-process scorer."""
    from shm_tpu_torch.serve_http import make_server

    srv = make_server(loaded, port=0, series_strides=(1,))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert srv.warm_event.wait(timeout=120)
        assert srv.RequestHandlerClass.warm_error is None
        info = json.loads(req(base + "/info")[2])
        assert info["exported"] is True and info["use_fused_vae"] is False
        assert info["seq_len"] == T and info["num_features"] == D
        W = windows(11, seed=4)
        out = json.loads(req(base + "/score", data=W.tobytes(), headers=octet(W))[2])
        ref = scorer.score(W)
        np.testing.assert_array_equal(np.float32(out["mse"]), ref["mse"])
        assert out["y_pred"] == [int(v) for v in ref["y_pred"]]
        x = np.random.default_rng(5).normal(size=(40, D)).astype(np.float32)
        out = json.loads(req(base + "/score_series", data=x.tobytes(),
                             headers=octet(x))[2])
        ref = scorer.score_series(x)
        assert out["n"] == len(ref["mse"])
        np.testing.assert_array_equal(np.float32(out["mse"]), ref["mse"])
    finally:
        srv.shutdown()
        srv.server_close()


def test_port_artifact_matches_the_jax_artifact(loaded, tmp_path):
    """Both packages' artifacts of the same weights on the same windows."""
    from shm_tpu.export import load_exported_scorer as jax_load
    from shm_tpu.export import save_exported_scorer as jax_save

    path = jax_save(jax_scorer(min_bucket=8, max_batch=32), tmp_path / "jax.shmx",
                    platforms=("cpu",))
    W = windows(45, seed=6)
    got, want = loaded.score(W), jax_load(path).score(W)
    np.testing.assert_allclose(got["mse"], np.asarray(want["mse"]), rtol=0,
                               atol=MSE_ATOL)
    for k in ("anomalous", "y_pred"):
        np.testing.assert_array_equal(got[k].astype(np.int64),
                                      np.asarray(want[k]).astype(np.int64), err_msg=k)
    assert 0 < got["anomalous"].sum() < 45


def test_loading_defaults_to_the_card(artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported_scorer(artifact)
