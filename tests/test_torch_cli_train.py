"""The port's ``train-vae`` command on a tiny temporary root, on the CPU.

The checkpoint it writes must be read by the JAX package
(``shm_tpu.utils.checkpoint.load_params``) and reproduce the port's
reconstruction through the JAX model: atol 2e-6, the tolerance of
``tests/test_ops.py`` for two float32 evaluations of the same VAE.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu.utils.checkpoint import load_params
from shm_tpu_torch.cli import stage4dof as cli
from shm_tpu_torch.config import Stage4DofConfig, TrainConfig, VAEConfig, replace
from shm_tpu_torch.convert import vae_from_flax, vae_state_dict, vae_to_flax
from shm_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
VCFG = VAEConfig(input_dim=12, latent_dim=4, hidden_dim=8, num_layers=2,
                 dropout=0.3, use_layernorm=True)
CFG = replace(Stage4DofConfig(), vae=VCFG, stride=4,
              vae_train=TrainConfig(epochs=2, batch_size=64, seed=7))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train-vae on two committed normal runs (stride 4: 152 train windows)."""
    root = tmp_path_factory.mktemp("root4dof")
    splits = json.loads((ROOT / "data/4dof/processed/run_splits.json").read_text())
    splits["normal"]["files"] = splits["normal"]["files"][:2]
    (root / "processed").mkdir()
    (root / "processed" / "run_splits.json").write_text(json.dumps(splits))
    paths = cli.Paths(str(root))
    res = cli.cmd_train_vae(paths, CFG, device="cpu")
    return paths, res


def test_train_vae_writes_every_artifact(trained):
    paths, res = trained
    for rel in ("processed/vae_mean.npy", "processed/vae_std.npy",
                "processed/normal_stats.npz", "models/temporal_vae.msgpack",
                "processed/stage1_vae_train_meta.json"):
        assert (paths.root / rel).exists(), rel
    assert res.history["epoch"] == [1, 2]


def test_meta_manifest_has_the_jax_cli_keys(trained):
    paths, res = trained
    meta = json.loads((paths.processed / "stage1_vae_train_meta.json").read_text())
    assert set(meta) == {
        "seed", "window_len", "stride", "train_frac", "val_frac", "epochs",
        "batch_size", "latent_dim", "hidden_dim", "num_layers", "dropout",
        "cell", "kl_warmup_ratio", "best_val_total", "best_epoch",
        "train_seconds", "protocol"}
    assert meta["seed"] == 7 and meta["epochs"] == 2 and meta["cell"] == "lstm"
    assert meta["best_epoch"] == res.best_epoch
    assert meta["best_val_total"] == res.best_val


def test_stats_come_from_the_train_fraction_only(trained):
    paths, _ = trained
    files = json.loads(paths.run_splits.read_text())["normal"]["files"]
    Wtr, Wva = cli.build_fraction_windows_multi(
        files, (CFG.train_frac, CFG.val_frac), CFG)
    assert Wtr.shape == (152, 100, 12) and Wva.shape == (102, 100, 12)
    assert np.array_equal(Wtr, cli.build_fraction_windows(files, CFG.train_frac, CFG))
    flat = Wtr.reshape(-1, 12).astype(np.float64)
    mean, std = cli._load_stats(paths)
    np.testing.assert_allclose(mean, flat.mean(axis=0), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(std, flat.std(axis=0), rtol=1e-4)
    assert np.array_equal(np.load(paths.processed / "vae_mean.npy"), mean)
    assert np.array_equal(np.load(paths.processed / "vae_std.npy"), std)


def test_checkpoint_is_restored_by_the_jax_package(trained):
    paths, res = trained
    jcfg = JaxVAEConfig(input_dim=12, latent_dim=4, hidden_dim=8, num_layers=2,
                        dropout=0.3, use_layernorm=True)
    jm = jax_vae_from_config(jcfg)
    x = np.random.default_rng(0).normal(size=(5, 100, 12)).astype(np.float32)
    template = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 100, 12)))
    restored = load_params({"params": template["params"]},
                           paths.models / "temporal_vae.msgpack")
    recon_j, mu_j, _ = jm.apply({"params": restored["params"]}, jnp.asarray(x))

    vae = cli._load_vae(paths, CFG)                  # the port's own reader
    assert all(torch.equal(v, res.params[k]) for k, v in vae.state_dict().items())
    with torch.no_grad():
        recon, mu, _ = vae(torch.from_numpy(x))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=2e-6)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=2e-6)


def test_vae_to_flax_inverts_vae_from_flax_on_the_committed_checkpoint():
    tree = load_checkpoint(ROOT / "data/4dof/models/temporal_vae.msgpack")["params"]
    cfg = Stage4DofConfig().vae
    back = vae_to_flax(vae_from_flax(tree, cfg))

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert b[k].dtype == np.float32 and b[k].flags["C_CONTIGUOUS"]
                assert np.array_equal(np.asarray(a[k]), b[k]), k

    same(tree, back)
    sd = vae_state_dict(tree, cfg.num_layers, cfg.use_layernorm)
    assert "encoder_lstm.layers.0.bias_ih" in sd and "encoder_lstm.layers.0.bias_hh" in sd
    assert not any(k.endswith(".bias") and "lstm" in k for k in sd)


def test_main_parses_train_vae_and_refuses_unported_commands(trained, monkeypatch):
    seen = {}
    monkeypatch.setattr(cli, "cmd_train_vae",
                        lambda paths, cfg, epochs, **kw: seen.update(
                            root=str(paths.root), epochs=epochs, **kw))
    cli.main(["train-vae", "--root", "somewhere", "--epochs", "3", "--seed", "9",
              "--no-kernel", "--device", "cpu", "--no-plots", "--devices", "2"])
    assert seen == {"root": "somewhere", "epochs": 3, "seed": 9,
                    "kernel": False, "device": "cpu", "plot": False,
                    "devices": 2}
    cli.main(["train-vae", "--kernel"])
    assert seen["kernel"] is True and seen["device"] is None and seen["root"] == "data/4dof"
    assert seen["plot"] is True and seen["devices"] is None
    # every command of the JAX CLI is ported: none is refused
    ran = []
    monkeypatch.setattr(cli, "cmd_gen_normal",
                        lambda paths, cfg, plot, **kw: ran.append((plot, kw)))
    cli.main(["gen-normal", "--no-plots"])
    assert ran == [(False, {"device": None})]
