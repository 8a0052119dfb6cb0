"""The port's VAE trainer (CPU, plain path) against the JAX package.

The two frameworks' random streams differ by nature, so every comparison
feeds both sides the same numpy-made parameters, batch order, eps and dropout
masks. Tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shm_tpu.config import TrainConfig as JaxTrainConfig
from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.data import compute_mean_std_from_windows as jax_mean_std
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu.models.vae import vae_loss as jax_vae_loss
from shm_tpu.ops.lstm_train import vae_train_forward as jax_vae_train_forward
from shm_tpu.train.vae import kl_anneal_sigmoid as jax_kl_anneal
from shm_tpu.train.vae import make_optimizer as jax_make_optimizer
from shm_tpu.train.vae import reconstruction_mse as jax_reconstruction_mse
from shm_tpu_torch.config import TrainConfig, VAEConfig
from shm_tpu_torch.convert import (
    random_flax_vae_params, vae_from_flax, vae_state_dict, vae_to_flax,
)
from shm_tpu_torch.data import compute_mean_std_from_windows
from shm_tpu_torch.models.vae import vae_from_config, vae_loss
from shm_tpu_torch.train import (
    kl_anneal_sigmoid, make_optimizer, reconstruction_mse, train_vae,
)
from shm_tpu_torch.train.vae import _batch_plan, batch_loss

# pytest-xdist runs several test files at once on the same cores; torch's
# default of one thread per core makes those workers spin against each other.
torch.set_num_threads(1)

CFG = VAEConfig(input_dim=6, latent_dim=4, hidden_dim=8, num_layers=2,
                dropout=0.3, use_layernorm=True)
T = 10


@pytest.mark.parametrize("n_epochs", [1, 3, 10, 50, 100])
@pytest.mark.parametrize("ratio", [0.0, 0.3, 1.0])
def test_kl_anneal_sigmoid_equals_jax(n_epochs, ratio):
    for e in range(1, n_epochs + 1):
        assert kl_anneal_sigmoid(e, n_epochs, ratio) == jax_kl_anneal(e, n_epochs, ratio)


@pytest.mark.parametrize("kind", ["coupled", "decoupled", "no_decay", "no_clip"])
def test_make_optimizer_matches_optax(kind):
    """Three steps on synthetic gradients, the first large enough for the clip
    to bite. atol 1e-7 plus one float32 ulp (rtol 2e-7): both sides are
    float32 Adam; they differ in where the bias corrections and the clip
    scale round."""
    kw = dict(lr=1e-3, weight_decay=0.0 if kind == "no_decay" else 1e-2,
              grad_clip=0.0 if kind == "no_clip" else 2.0,
              decoupled_wd=kind == "decoupled")
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (3.0, 0.05, 1.0)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values())) for gs in grads]
    assert norms[0] > 2.0 > norms[1]                  # clip bites, then not

    tx = jax_make_optimizer(JaxTrainConfig(**kw))
    pj = jax.tree.map(jnp.asarray, p0)
    state = tx.init(pj)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = make_optimizer(params.values(), TrainConfig(**kw))
    for gs in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, gs), state, pj)
        pj = optax.apply_updates(pj, updates)
        opt.zero_grad()
        for k, p in params.items():
            p.grad = torch.from_numpy(gs[k].copy())
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(pj[k]), atol=1e-7, rtol=2e-7)


def test_clip_scales_to_the_norm_and_leaves_small_gradients_alone():
    p = torch.nn.Parameter(torch.zeros(4))
    opt = make_optimizer([p], TrainConfig(grad_clip=2.0, weight_decay=0.0))
    opt.opt.step = lambda: None                       # look at the clip alone
    p.grad = torch.full((4,), 3.0)                    # norm 6 -> scaled to 2
    opt.step()
    np.testing.assert_allclose(float(torch.linalg.vector_norm(p.grad)), 2.0,
                               rtol=1e-7)
    small = torch.tensor([0.3, -0.2, 0.1, 0.0])       # norm < 2: untouched
    p.grad = small.clone()
    opt.step()
    assert torch.equal(p.grad, small)


@pytest.mark.parametrize("masked", [False, True])
def test_vae_loss_matches_jax(masked):
    rng = np.random.default_rng(5)
    a = lambda *s: rng.normal(size=s).astype(np.float32)
    recon, x, mu, logvar = a(9, T, 6), a(9, T, 6), a(9, 4), a(9, 4) * 0.3
    mask = (np.arange(9) < 6).astype(np.float32) if masked else None
    ref = jax_vae_loss(*map(jnp.asarray, (recon, x, mu, logvar)), 0.4,
                       mask=None if mask is None else jnp.asarray(mask))
    got = vae_loss(*map(torch.from_numpy, (recon, x, mu, logvar)), 0.4,
                   mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose([float(g) for g in got],
                               [float(r) for r in ref], rtol=2e-6)


def test_padded_batch_loss_equals_unpadded():
    rng = np.random.default_rng(6)
    vae = vae_from_flax(random_flax_vae_params(rng, CFG), CFG)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    n, bs = 5, 8
    x = t(rng.normal(size=(bs, T, 6)))
    eps = t(rng.normal(size=(bs, 4)))
    dm = [t((rng.random((T, 8, bs)) > 0.3) / 0.7)]
    bmask = t(np.arange(bs) < n)
    padded = batch_loss(vae, x, bmask, eps, dm, dm, 0.5, use_kernel=False)
    cut = batch_loss(vae, x[:n], None, eps[:n], [dm[0][:, :, :n]],
                     [dm[0][:, :, :n]], 0.5, use_kernel=False)
    np.testing.assert_allclose([float(v.detach()) for v in padded],
                               [float(v.detach()) for v in cut], rtol=1e-6)


def test_five_step_trajectory_matches_jax():
    """A tiny VAE, batch order, eps and masks from numpy, driven for five
    optimizer steps through JAX (Pallas ops in interpret mode + vae_loss +
    the optax chain) and through the port's step. atol 1e-5 on every
    parameter after five steps: each step's gradients agree to ~1e-6 of
    their scale (float32, other summation order, the sigmoid's other form),
    and Adam's normalisation can turn a tiny gradient difference into a
    difference of up to lr=1e-3 times its relative size in one update."""
    rng = np.random.default_rng(11)
    bs, N, steps = 16, 40, 5
    params = random_flax_vae_params(rng, CFG)
    Z = rng.normal(size=(N, T, 6)).astype(np.float32)
    order = [rng.permutation(N)[:bs] for _ in range(steps)]
    eps = rng.normal(size=(steps, bs, 4)).astype(np.float32)
    masks = ((rng.random((steps, 2, T, 8, bs)) > 0.3) / 0.7).astype(np.float32)
    bmask = np.ones(bs, np.float32)
    bmask[-3:] = 0.0
    kl_w = 0.25
    tkw = dict(lr=1e-3, weight_decay=1e-5, grad_clip=2.0)

    tx = jax_make_optimizer(JaxTrainConfig(**tkw))
    pj = jax.tree.map(jnp.asarray, params)
    state = tx.init(pj)

    def loss_fn(p, xb, e, me, md):
        recon, mu, logvar = jax_vae_train_forward(
            p, xb, e, me, md, use_layernorm=True, batch_tile=bs,
            dtype=jnp.float32, interpret=True)
        return jax_vae_loss(recon, xb, mu, logvar, kl_w, mask=jnp.asarray(bmask))[0]

    vae = vae_from_flax(params, CFG).train()
    opt = make_optimizer(vae.parameters(), TrainConfig(**tkw))
    t = torch.from_numpy
    for s in range(steps):
        xb = Z[order[s]]
        grads = jax.grad(loss_fn)(pj, jnp.asarray(xb), jnp.asarray(eps[s]),
                                  jnp.asarray(masks[s, 0]), jnp.asarray(masks[s, 1]))
        updates, state = tx.update(grads, state, pj)
        pj = optax.apply_updates(pj, updates)

        opt.zero_grad()
        total, _, _ = batch_loss(vae, t(xb), t(bmask), t(eps[s]),
                                 [t(masks[s, 0])], [t(masks[s, 1])], kl_w,
                                 use_kernel=True)
        total.backward()
        opt.step()

    got = vae_state_dict(vae_to_flax(vae), 2, True)
    ref = vae_state_dict(jax.tree.map(np.asarray, pj), 2, True)
    moved = 0.0
    start = vae_state_dict(params, 2, True)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)
        moved = max(moved, float((ref[k] - start[k]).abs().max()))
    assert moved > 1e-3                               # the steps did move them


def _tiny_data(seed=0, N=40, Nva=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, T, 6)).astype(np.float32),
            rng.normal(size=(Nva, T, 6)).astype(np.float32))


def test_train_vae_history_and_best_val_selection():
    Ztr, Zva = _tiny_data()
    cfg = TrainConfig(epochs=4, batch_size=16, seed=3)
    model = vae_from_config(CFG)
    res = train_vae(model, Ztr, Zva, cfg, device="cpu")
    assert set(res.history) == {"epoch", "kl_w", "train_total", "train_recon",
                                "train_kl", "val_total", "val_recon", "val_kl"}
    assert res.history["epoch"] == [1, 2, 3, 4]
    assert all(len(v) == 4 and np.isfinite(v).all() for v in res.history.values())
    np.testing.assert_allclose(
        res.history["kl_w"],
        [np.float32(kl_anneal_sigmoid(e, 4, 0.3)) for e in range(1, 5)])
    best = int(np.argmin(res.history["val_total"]))
    assert res.best_epoch == best + 1
    assert res.best_val == res.history["val_total"][best]
    assert not model.training
    last = model.state_dict()
    assert all(torch.equal(res.last_params[k], last[k]) for k in last)
    if res.best_epoch != 4:
        assert any(not torch.equal(res.params[k], last[k]) for k in last)
    assert _batch_plan(40, 16) == (3, 8)


def test_train_vae_is_seed_deterministic_and_seed_sensitive():
    Ztr, Zva = _tiny_data(1)
    run = lambda seed: train_vae(vae_from_config(CFG), Ztr, Zva,
                                 TrainConfig(epochs=2, batch_size=16, seed=seed),
                                 device="cpu")
    a, b, c = run(5), run(5), run(6)
    assert a.history == b.history
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert a.history["train_total"] != c.history["train_total"]


def test_train_vae_ops_path_equals_model_path_on_cpu():
    """``use_kernel=True`` on CPU tensors runs the ops' plain versions: the
    same arithmetic in another layout, so the histories agree to float32
    rounding (rtol 1e-4 after two epochs of Adam steps)."""
    Ztr, Zva = _tiny_data(2)
    cfg = TrainConfig(epochs=2, batch_size=16, seed=9)
    a = train_vae(vae_from_config(CFG), Ztr, Zva, cfg, device="cpu", use_kernel=True)
    b = train_vae(vae_from_config(CFG), Ztr, Zva, cfg, device="cpu", use_kernel=False)
    for k in ("train_total", "val_total", "train_kl"):
        np.testing.assert_allclose(a.history[k], b.history[k], rtol=1e-4)


def test_train_vae_init_params_and_val_sample_off():
    Ztr, Zva = _tiny_data(3)
    cfg = TrainConfig(epochs=1, batch_size=16, seed=1)
    init = vae_from_flax(random_flax_vae_params(np.random.default_rng(0), CFG),
                         CFG).state_dict()
    init = {k: v.clone() for k, v in init.items()}
    a = train_vae(vae_from_config(CFG), Ztr, Zva, cfg, init_params=init,
                  val_sample=False, device="cpu")
    b = train_vae(vae_from_config(CFG), Ztr, Zva, cfg, init_params=init,
                  val_sample=True, device="cpu")
    assert a.history["train_total"] == b.history["train_total"]
    assert a.history["val_total"] != b.history["val_total"]


def test_use_kernel_needs_two_layers():
    cfg1 = VAEConfig(input_dim=6, latent_dim=4, hidden_dim=8, num_layers=1)
    Ztr, Zva = _tiny_data(4)
    with pytest.raises(ValueError, match="2-layer"):
        train_vae(vae_from_config(cfg1), Ztr, Zva, TrainConfig(epochs=1, batch_size=16),
                  use_kernel=True, device="cpu")
    res = train_vae(vae_from_config(cfg1), Ztr, Zva,
                    TrainConfig(epochs=1, batch_size=16), device="cpu")
    assert np.isfinite(res.history["train_total"]).all()


@pytest.mark.parametrize("layers,use_kernel,device,want", [
    (2, None, "cuda", True), (2, None, "cpu", False), (2, False, "cuda", False),
    (1, None, "cpu", False), (1, False, "cuda", False),
    (1, None, "cuda", ValueError), (1, True, "cuda", ValueError),
])
def test_use_kernel_default_never_gives_way_on_the_card(layers, use_kernel,
                                                        device, want):
    """On CUDA the default is the kernels, and a depth they do not take
    raises: only an explicit ``use_kernel=False`` selects the plain path."""
    from shm_tpu_torch.train.vae import _resolve_use_kernel

    model = vae_from_config(VAEConfig(input_dim=6, latent_dim=4, hidden_dim=8,
                                      num_layers=layers))
    if want is ValueError:
        with pytest.raises(ValueError, match="2-layer"):
            _resolve_use_kernel(model, use_kernel, torch.device(device))
    else:
        assert _resolve_use_kernel(model, use_kernel, torch.device(device)) is want


def test_train_vae_without_a_card_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    Ztr, Zva = _tiny_data(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_vae(vae_from_config(CFG), Ztr, Zva, TrainConfig(epochs=1))


def test_checkpoint_resume_continues_the_same_trajectory(tmp_path, capsys):
    Ztr, Zva = _tiny_data(6)
    cfg4 = TrainConfig(epochs=4, batch_size=16, seed=2)
    straight = train_vae(vae_from_config(CFG), Ztr, Zva, cfg4, device="cpu")

    ck = str(tmp_path / "ck")
    # an interrupted run: same 4-epoch schedule, stopped after epoch 2
    first = train_vae(vae_from_config(CFG), Ztr, Zva, cfg4, device="cpu",
                      checkpoint_dir=ck, checkpoint_every=2)
    assert first.history == straight.history          # checkpointing is inert
    # rewind to the epoch-2 checkpoint by retraining 2 epochs of the schedule
    import shutil
    shutil.rmtree(ck)
    half = _train_epochs(Ztr, Zva, cfg4, ck, stop_after=2)
    assert half["epoch"] == [1, 2]
    assert (tmp_path / "ck" / "vae_train_state.pt").exists()
    assert (tmp_path / "ck" / "vae_train_state.meta.json").exists()
    resumed = train_vae(vae_from_config(CFG), Ztr, Zva, cfg4, device="cpu",
                        checkpoint_dir=ck, checkpoint_every=2)
    assert "[resume] restored epoch 2" in capsys.readouterr().out
    assert resumed.history == straight.history
    assert resumed.best_epoch == straight.best_epoch
    assert resumed.best_val == straight.best_val
    for k in straight.params:
        assert torch.equal(resumed.params[k], straight.params[k]), k
        assert torch.equal(resumed.last_params[k], straight.last_params[k]), k


def _train_epochs(Ztr, Zva, cfg, ck, stop_after):
    """Run the ``cfg.epochs`` schedule but stop after ``stop_after`` epochs,
    as an interruption would: the checkpoint of that epoch stays on disk."""
    import json
    from pathlib import Path

    from shm_tpu_torch.train import checkpoint as ckpt_mod

    class Stop(Exception):
        pass

    real = ckpt_mod.save_train_ckpt

    def save_then_stop(path, arrays, meta):
        real(path, arrays, meta)
        if meta["epoch"] == stop_after:
            raise Stop

    ckpt_mod.save_train_ckpt = save_then_stop
    try:
        with pytest.raises(Stop):
            train_vae(vae_from_config(CFG), Ztr, Zva, cfg, device="cpu",
                      checkpoint_dir=ck, checkpoint_every=stop_after)
    finally:
        ckpt_mod.save_train_ckpt = real
    meta = json.loads((Path(ck) / "vae_train_state.meta.json").read_text())
    assert meta["init_consumed"] is True
    return meta["history"]


def test_resume_refuses_other_init_params_presence(tmp_path):
    Ztr, Zva = _tiny_data(7)
    cfg = TrainConfig(epochs=2, batch_size=16)
    ck = str(tmp_path / "ck")
    train_vae(vae_from_config(CFG), Ztr, Zva, cfg, device="cpu",
              checkpoint_dir=ck, checkpoint_every=1)
    init = vae_from_config(CFG).state_dict()
    with pytest.raises(ValueError, match="init_params-presence"):
        train_vae(vae_from_config(CFG), Ztr, Zva, cfg, device="cpu",
                  init_params=init, checkpoint_dir=ck, checkpoint_every=1)


@pytest.mark.parametrize("N", [0, 5, 37])
def test_reconstruction_mse_matches_jax(N):
    rng = np.random.default_rng(8)
    params = random_flax_vae_params(rng, CFG)
    Z = rng.normal(size=(N, T, 6)).astype(np.float32)
    jm = jax_vae_from_config(JaxVAEConfig(input_dim=6, latent_dim=4, hidden_dim=8,
                                          num_layers=2, dropout=0.3))
    ref = jax_reconstruction_mse(jm, params, jnp.asarray(Z), batch_size=16,
                                 fused=False)
    vae = vae_from_flax(params, CFG)
    got = reconstruction_mse(vae, Z, batch_size=16, device="cpu")
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    # on CPU tensors fused=True runs the gate kernel's plain version
    fused = reconstruction_mse(vae, Z, fused=True, device="cpu")
    np.testing.assert_allclose(fused, ref, rtol=1e-5)


def test_reconstruction_mse_sampled_uses_the_generator():
    rng = np.random.default_rng(9)
    vae = vae_from_flax(random_flax_vae_params(rng, CFG), CFG)
    Z = rng.normal(size=(20, T, 6)).astype(np.float32)
    g = lambda: torch.Generator().manual_seed(4)
    a = reconstruction_mse(vae, Z, sample=True, generator=g(), device="cpu")
    b = reconstruction_mse(vae, Z, sample=True, generator=g(), device="cpu")
    det = reconstruction_mse(vae, Z, device="cpu")
    assert np.array_equal(a, b) and not np.allclose(a, det)


def test_compute_mean_std_from_windows_matches_jax():
    rng = np.random.default_rng(10)
    W = (rng.normal(size=(30, T, 6)) * [1, 2, 3, 4, 5, 0] + 7).astype(np.float32)
    mean, std = compute_mean_std_from_windows(torch.from_numpy(W))
    jmean, jstd = jax_mean_std(jnp.asarray(W))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-6)
    assert float(std[5]) == np.float32(1e-6)          # std == 0 -> 1e-6
    # population std, not torch's unbiased default
    np.testing.assert_allclose(std[:5].numpy(), W.reshape(-1, 6).std(axis=0)[:5],
                               rtol=1e-5)
