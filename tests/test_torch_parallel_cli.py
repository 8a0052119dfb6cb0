"""Every ``--devices`` flag of the port on the CPU (``--device cpu
--devices 2``: a CPU mesh of 2 shards), against the same command without
the flag.

``train-vae`` of ``stage4dof``, ``stage1dof`` and ``openlab`` on small
roots: the histories within rtol 1e-5 and the written parameters within
atol 1e-6 (the bounds of ``tests/test_torch_parallel_train.py``), the JAX
CLI's ``[INFO] data-parallel training over 2 devices`` line printed; and
the daemon's ``--devices 2`` for ``--root`` and ``--openlab``: ``/info``
reports ``mesh_devices: 2`` and ``/score`` is the single scorer's (mse
within 1e-6, decisions equal).
"""

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu_torch.cli import openlab as ol
from shm_tpu_torch.cli import stage1dof as cli1
from shm_tpu_torch.cli import stage4dof as cli4
from shm_tpu_torch.config import (Stage1DofConfig, Stage4DofConfig,
                                  TrainConfig, VAEConfig, replace)
from shm_tpu_torch.serve_http import _load_scorer, _parse_args, make_server
from shm_tpu_torch.utils.checkpoint import load_checkpoint
from torch_openlab_roots import small_root
from torch_serve_models import octet, req

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
INFO = "[INFO] data-parallel training over 2 devices"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _same_checkpoint(a: Path, b: Path) -> None:
    la, lb = dict(_leaves(load_checkpoint(a))), dict(_leaves(load_checkpoint(b)))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_allclose(la[k], lb[k], atol=1e-6, err_msg=k)


def _same_history(got, ref, keys=("train_total", "val_total")):
    for k in keys:
        np.testing.assert_allclose(got.history[k], ref.history[k], rtol=1e-5)


def test_stage4dof_train_vae_devices(tmp_path, capsys):
    cfg = replace(Stage4DofConfig(), stride=4,
                  vae=VAEConfig(input_dim=12, latent_dim=4, hidden_dim=8,
                                num_layers=2, dropout=0.3, use_layernorm=True),
                  vae_train=TrainConfig(epochs=2, batch_size=64, seed=7))
    splits = json.loads((ROOT / "data/4dof/processed/run_splits.json").read_text())
    splits["normal"]["files"] = splits["normal"]["files"][:2]
    res = {}
    for devices in (None, 2):
        root = tmp_path / f"r{devices}"
        (root / "processed").mkdir(parents=True)
        (root / "processed/run_splits.json").write_text(json.dumps(splits))
        res[devices] = cli4.cmd_train_vae(cli4.Paths(str(root)), cfg,
                                          device="cpu", plot=False,
                                          devices=devices)
        assert (INFO in capsys.readouterr().out) == (devices == 2)
    _same_history(res[2], res[None])
    _same_checkpoint(tmp_path / "r2/models/temporal_vae.msgpack",
                     tmp_path / "rNone/models/temporal_vae.msgpack")
    with pytest.raises(ValueError, match="mesh"):
        cli4.cmd_train_vae(cli4.Paths(str(tmp_path / "r2")), cfg, device="cpu",
                           plot=False, devices=2, kernel=True)


def test_stage1dof_train_vae_devices(tmp_path, capsys):
    cfg = Stage1DofConfig()
    cfg = replace(cfg, vae=replace(cfg.vae, hidden_dim=8),
                  train=replace(cfg.train, epochs=1))
    res = {}
    for devices in (None, 2):
        root = tmp_path / f"r{devices}"
        shutil.copytree(ROOT / "data/1dof/raw", root / "raw")
        res[devices] = cli1.cmd_train_vae(cli1.Paths(str(root)), cfg,
                                          plot=False, device="cpu",
                                          devices=devices)
        assert (INFO in capsys.readouterr().out) == (devices == 2)
    _same_history(res[2], res[None])
    _same_checkpoint(tmp_path / "r2/models/temporal_vae.msgpack",
                     tmp_path / "rNone/models/temporal_vae.msgpack")


def test_openlab_train_vae_devices(tmp_path, capsys):
    art = "output/VAE_Training/artifacts/vae_exceedance_clean.msgpack"
    for devices in (None, 2):
        root = small_root(tmp_path / f"r{devices}", step=4, outputs=())
        argv = ["train-vae", "--root", str(root), "--epochs", "1",
                "--device", "cpu", "--no-plots"]
        ol.main(argv + ([] if devices is None else ["--devices", "2"]))
        assert (INFO in capsys.readouterr().out) == (devices == 2)
    _same_checkpoint(tmp_path / "r2" / art, tmp_path / "rNone" / art)


def test_devices_flags_parse(monkeypatch):
    """``--devices`` reaches each CLI's training commands."""
    for mod in (cli4, cli1, ol):
        seen = {}
        monkeypatch.setattr(mod, "cmd_train_vae",
                            lambda *a, **kw: seen.update(kw))
        mod.main(["train-vae", "--devices", "3", "--device", "cpu"])
        assert seen["devices"] == 3
    for mod in (cli4, ol):
        seen = {}
        monkeypatch.setattr(mod, "cmd_train_cnn",
                            lambda *a, **kw: seen.update(kw))
        mod.main(["train-cnn", "--devices", "3", "--device", "cpu"])
        assert seen["devices"] == 3


def _serve(argv):
    args, strides = _parse_args(argv)
    scorer = _load_scorer(args)
    srv = make_server(scorer, port=0, series_strides=strides)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    assert srv.warm_event.wait(timeout=300), "warmup never finished"
    assert srv.RequestHandlerClass.warm_error is None
    return srv, scorer, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _same(out, ref):
    for k in ("anomalous", "y_pred"):
        np.testing.assert_array_equal(np.asarray(out[k]).astype(np.int64),
                                      np.asarray(ref[k]).astype(np.int64))
    for k in ("mse", "p_struct"):
        np.testing.assert_allclose(np.asarray(out[k], np.float32), ref[k],
                                   atol=1e-6)


@pytest.mark.parametrize("stage", ["4dof", "openlab"])
def test_daemon_devices(stage):
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    common = ["--device", "cpu", "--min-bucket", "16", "--max-batch", "32"]
    if stage == "4dof":
        argv = ["--root", str(ROOT / "data/4dof")] + common
        single = HybridScorer.from_artifacts(ROOT / "data/4dof", device="cpu",
                                             min_bucket=16, max_batch=32)
        W = np.random.default_rng(0).normal(size=(40, 100, 12)).astype(
            np.float32)
    else:
        argv = ["--openlab", str(ROOT / "data/openlab"), "--series-strides",
                ""] + common
        single = OpenLabScorer.from_artifacts(ROOT / "data/openlab",
                                              device="cpu", min_bucket=16,
                                              max_batch=32)
        idx = np.linspace(0, 6431, 40).astype(int)
        X = [np.load(ROOT / f"data/openlab/extracted/{n}.npy",
                     mmap_mode="r")[idx] for n in ("X_clean", "X_raw")]
        W = np.stack(X, axis=-1).astype(np.float32)
    srv, scorer, base = _serve(argv + ["--devices", "2"])
    try:
        assert scorer.mesh.size == 2
        info = json.loads(req(base + "/info")[2])
        assert info["mesh_devices"] == 2
        _, _, body = req(base + "/score", data=W.tobytes(), headers=octet(W))
        _same(json.loads(body), single.score(W))
    finally:
        _stop(srv)
    srv, _, base = _serve(argv)
    try:
        assert json.loads(req(base + "/info")[2])["mesh_devices"] is None
    finally:
        _stop(srv)
