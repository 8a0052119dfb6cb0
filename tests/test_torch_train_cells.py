"""Training of the ``min_gru`` and ``attention`` VAE cells (CPU, plain
autograd) against the JAX package.

The two frameworks' random streams differ, so the trajectories run with the
dropout off and the same numpy-made parameters, batches and eps on both
sides: the JAX side through ``model.apply(..., method=encode/decode)`` with
``deterministic=True``, ``vae_loss`` and the optax chain. Tolerances are
stated where they are used.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shm_tpu.cli.stage4dof import Paths as JaxPaths
from shm_tpu.cli.stage4dof import _load_vae as jax_load_vae
from shm_tpu.config import Stage4DofConfig as JaxStage4DofConfig
from shm_tpu.config import TrainConfig as JaxTrainConfig
from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.config import replace as jax_replace
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu.models.vae import vae_loss as jax_vae_loss
from shm_tpu.train.vae import make_optimizer as jax_make_optimizer
from shm_tpu_torch.cli import stage4dof as cli
from shm_tpu_torch.config import Stage4DofConfig, TrainConfig, VAEConfig, replace
from shm_tpu_torch.convert import (
    random_flax_vae_params, vae_from_flax, vae_state_dict, vae_to_flax,
)
from shm_tpu_torch.models.vae import vae_from_config
from shm_tpu_torch.train import make_optimizer, train_vae
from shm_tpu_torch.train.vae import batch_loss, draw_batch_noise

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
T, D = 10, 6
CELLS = {
    "min_gru": VAEConfig(input_dim=D, latent_dim=4, hidden_dim=8, num_layers=2,
                         dropout=0.3, use_layernorm=True, cell="min_gru"),
    # two heads of 32, the preset's head size
    "attention": VAEConfig(input_dim=D, latent_dim=4, hidden_dim=64,
                           num_layers=2, dropout=0.3, use_layernorm=True,
                           cell="attention"),
}


def _jax_cfg(cfg: VAEConfig) -> JaxVAEConfig:
    return JaxVAEConfig(input_dim=cfg.input_dim, latent_dim=cfg.latent_dim,
                        hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers,
                        dropout=cfg.dropout, use_layernorm=cfg.use_layernorm,
                        cell=cfg.cell)


@pytest.mark.parametrize("cell", list(CELLS))
def test_five_step_trajectory_matches_jax(cell):
    """Five optimizer steps from one numpy parameter tree, batch order and
    eps, dropout off, through JAX (encode / decode with deterministic=True,
    vae_loss with a padded batch's mask, the optax chain) and through the
    port's ``batch_loss`` and optimizer. Every parameter after five steps
    within atol 1e-5 (the LSTM's, tests/test_torch_train_vae.py) plus 1% of
    its own movement: the gradients agree to ~1e-5 of their scale in
    float32 with other summation orders, but Adam moves an element by about
    lr a step whatever its gradient's size, so an element whose gradient is
    near zero (the key biases', which the softmax ignores: rounding of
    ~1e-10 beside the weight decay's pull) moves by slightly different
    amounts in the two frameworks; a wrong gradient would move parameters by
    a different amount of the order of their movement. min_gru reads
    ~1e-7, attention 1.3e-5 at most (0.13% of that element's movement)."""
    cfg = CELLS[cell]
    rng = np.random.default_rng(21)
    bs, N, steps = 16, 40, 5
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(N, T, D)).astype(np.float32)
    order = [rng.permutation(N)[:bs] for _ in range(steps)]
    eps = rng.normal(size=(steps, bs, cfg.latent_dim)).astype(np.float32)
    bmask = np.ones(bs, np.float32)
    bmask[-3:] = 0.0
    kl_w = 0.25
    tkw = dict(lr=1e-3, weight_decay=1e-5, grad_clip=2.0)

    jm = jax_vae_from_config(_jax_cfg(cfg))
    tx = jax_make_optimizer(JaxTrainConfig(**tkw))
    pj = jax.tree.map(jnp.asarray, params)
    state = tx.init(pj)

    def loss_fn(p, xb, e):
        mu, logvar = jm.apply({"params": p}, xb, True, method=jm.encode)
        z = mu + e * jnp.exp(0.5 * logvar)
        recon = jm.apply({"params": p}, z, T, True, method=jm.decode)
        return jax_vae_loss(recon, xb, mu, logvar, kl_w, mask=jnp.asarray(bmask))[0]

    grad_fn = jax.jit(jax.grad(loss_fn))
    vae = vae_from_flax(params, cfg).eval()          # eval: dropout off
    opt = make_optimizer(vae.parameters(), TrainConfig(**tkw))
    t = torch.from_numpy
    for s in range(steps):
        xb = Z[order[s]]
        grads = grad_fn(pj, jnp.asarray(xb), jnp.asarray(eps[s]))
        updates, state = tx.update(grads, state, pj)
        pj = optax.apply_updates(pj, updates)

        opt.zero_grad()
        total, _, _ = batch_loss(vae, t(xb), t(bmask), t(eps[s]), None, None,
                                 kl_w, use_kernel=False)
        total.backward()
        opt.step()

    got = vae_state_dict(vae_to_flax(vae), 2, True, cell)
    ref = vae_state_dict(jax.tree.map(np.asarray, pj), 2, True, cell)
    start = vae_state_dict(params, 2, True, cell)
    moved = 0.0
    for k in ref:
        step = (ref[k] - start[k]).abs()
        excess = (got[k] - ref[k]).abs() - (1e-5 + 0.01 * step)
        assert float(excess.max()) <= 0, (k, float((got[k] - ref[k]).abs().max()))
        moved = max(moved, float(step.max()))
    assert moved > 1e-3                               # the steps did move them


def test_min_gru_all_ones_masks_equal_dropout_off():
    """Explicit masks of ones in training mode give the loss and gradients
    of the model with dropout off, bit for bit (multiplying by 1 is exact)."""
    cfg = CELLS["min_gru"]
    rng = np.random.default_rng(3)
    params = random_flax_vae_params(rng, cfg)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    x, eps = t(rng.normal(size=(8, T, D))), t(rng.normal(size=(8, 4)))
    ones = [torch.ones(T, cfg.hidden_dim, 8)]

    def loss_and_grads(model, masks):
        total, _, _ = batch_loss(model, x, None, eps, masks, masks, 0.5,
                                 use_kernel=False)
        total.backward()
        return total.detach(), [p.grad.clone() for p in model.parameters()]

    a = loss_and_grads(vae_from_flax(params, cfg).train(), ones)
    b = loss_and_grads(vae_from_flax(params, cfg).eval(), None)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(g, h) for g, h in zip(a[1], b[1]))


def test_noise_draws_by_cell():
    """min_gru draws eps then a [T, H, bs] mask per layer gap of each
    stack; attention draws eps only here, its stacks draw in the forward."""
    g = torch.Generator().manual_seed(0)
    m = vae_from_config(CELLS["min_gru"])
    eps, de, dd = draw_batch_noise(m, 8, T, g, "cpu")
    assert eps.shape == (8, 4) and len(de) == len(dd) == 1
    assert de[0].shape == (T, 8, 8)
    assert set(torch.unique(de[0]).tolist()) <= {0.0, (torch.tensor(1.0) / 0.7).item()}
    a = vae_from_config(CELLS["attention"])
    eps, de, dd = draw_batch_noise(a, 8, T, g, "cpu")
    assert eps.shape == (8, 4) and de is None and dd is None


@pytest.mark.parametrize("cell", list(CELLS))
def test_use_kernel_true_raises(cell):
    rng = np.random.default_rng(4)
    Z = rng.normal(size=(20, T, D)).astype(np.float32)
    for device in ("cpu", "cuda"):
        from shm_tpu_torch.train.vae import _resolve_use_kernel

        model = vae_from_config(CELLS[cell])
        with pytest.raises(ValueError, match=f"cell={cell!r}"):
            _resolve_use_kernel(model, True, torch.device(device))
        assert _resolve_use_kernel(model, None, torch.device(device)) is False
    with pytest.raises(ValueError, match=f"cell={cell!r}"):
        train_vae(vae_from_config(CELLS[cell]), Z, Z[:8],
                  TrainConfig(epochs=1, batch_size=8), use_kernel=True,
                  device="cpu")


def _tiny_data(seed, N=40, Nva=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, T, D)).astype(np.float32),
            rng.normal(size=(Nva, T, D)).astype(np.float32))


@pytest.mark.parametrize("cell", list(CELLS))
def test_seed_determinism(cell):
    Ztr, Zva = _tiny_data(5)
    run = lambda seed: train_vae(vae_from_config(CELLS[cell]), Ztr, Zva,
                                 TrainConfig(epochs=2, batch_size=16, seed=seed),
                                 device="cpu")
    a, b, c = run(3), run(3), run(4)
    assert a.history == b.history
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert a.history["train_total"] != c.history["train_total"]
    assert all(np.isfinite(v).all() for v in a.history.values())


def test_attention_resume_stays_on_the_trajectory(tmp_path, capsys):
    """An attention run stopped after its epoch-2 checkpoint and resumed
    gives the uninterrupted run's history and parameters bit for bit: the
    stacks' dropout draws come from the checkpointed generator."""
    from shm_tpu_torch.train import checkpoint as ckpt_mod

    cfg = CELLS["attention"]
    Ztr, Zva = _tiny_data(6)
    tcfg = TrainConfig(epochs=4, batch_size=16, seed=2)
    straight = train_vae(vae_from_config(cfg), Ztr, Zva, tcfg, device="cpu")

    class Stop(Exception):
        pass

    real = ckpt_mod.save_train_ckpt

    def save_then_stop(path, arrays, meta):
        real(path, arrays, meta)
        if meta["epoch"] == 2:
            raise Stop

    ck = str(tmp_path / "ck")
    ckpt_mod.save_train_ckpt = save_then_stop
    try:
        with pytest.raises(Stop):
            train_vae(vae_from_config(cfg), Ztr, Zva, tcfg, device="cpu",
                      checkpoint_dir=ck, checkpoint_every=2)
    finally:
        ckpt_mod.save_train_ckpt = real
    resumed = train_vae(vae_from_config(cfg), Ztr, Zva, tcfg, device="cpu",
                        checkpoint_dir=ck, checkpoint_every=2)
    assert "[resume] restored epoch 2" in capsys.readouterr().out
    assert resumed.history == straight.history
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
        assert torch.equal(resumed.last_params[k], straight.last_params[k]), k


@pytest.mark.parametrize("cell", list(CELLS))
def test_train_vae_command_meta_is_read_back_by_jax(cell, tmp_path, monkeypatch):
    """``train-vae --cell`` on two committed normal runs (stride 4, 152
    train windows, one epoch) with the config cut small: the meta names the
    cell, and the JAX ``_load_vae`` restores the checkpoint as that family,
    reproducing the port's reconstruction (atol 2e-6, two float32
    evaluations of one model)."""
    vcfg = replace(CELLS[cell], input_dim=12, cell="lstm")
    small = replace(Stage4DofConfig(), vae=vcfg, stride=4,
                    vae_train=TrainConfig(epochs=1, batch_size=64, seed=7))
    monkeypatch.setattr(cli, "Stage4DofConfig", lambda: small)
    splits = json.loads((ROOT / "data/4dof/processed/run_splits.json").read_text())
    splits["normal"]["files"] = splits["normal"]["files"][:2]
    (tmp_path / "processed").mkdir()
    (tmp_path / "processed" / "run_splits.json").write_text(json.dumps(splits))
    cli.main(["train-vae", "--root", str(tmp_path), "--cell", cell,
              "--device", "cpu", "--no-plots"])

    meta = json.loads((tmp_path / "processed" / "stage1_vae_train_meta.json")
                      .read_text())
    assert meta["cell"] == cell and meta["epochs"] == 1
    jcfg = jax_replace(JaxStage4DofConfig(), vae=jax_replace(
        _jax_cfg(vcfg), cell="lstm"))
    jm, jp = jax_load_vae(JaxPaths(str(tmp_path)), jcfg)
    assert jm.cell == cell

    x = np.random.default_rng(0).normal(size=(3, 100, 12)).astype(np.float32)
    recon_j, _, _ = jm.apply({"params": jp}, jnp.asarray(x))
    vae = cli._load_vae(cli.Paths(str(tmp_path)), small)
    assert vae.cell == cell
    with torch.no_grad():
        recon, _, _ = vae(torch.from_numpy(x))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=2e-6)
