"""The port's openLAB ``train-vae`` against the JAX package, on the CPU.

The two frameworks' random streams differ, so the trajectory carries the
draws across: the 1-layer openLAB VAE (D=3, H=64, Z=8, LayerNorm; windows
cut to 40 steps), five optimizer steps from one numpy parameter tree, batch
order and eps (a 1-layer stack has no dropout mask), through JAX and
through the port's ``batch_loss`` on the plain path; every parameter within
atol 1e-5 plus 1% of its movement (the tolerance of
``tests/test_torch_train_cells.py``).

The command on a small root (``tests/torch_openlab_roots.py``), cut to one
epoch: the manifest's keys are the JAX command's, and ``shm_tpu`` loads the
port's checkpoint to the same model (atol 2e-6).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shm_tpu.config import OpenLabConfig as JaxOpenLabConfig
from shm_tpu.config import TrainConfig as JaxTrainConfig
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu.models.vae import vae_loss as jax_vae_loss
from shm_tpu.train.vae import make_optimizer as jax_make_optimizer
from shm_tpu_torch.cli import openlab as ol
from shm_tpu_torch.config import OpenLabConfig, TrainConfig
from shm_tpu_torch.convert import (
    random_flax_vae_params, vae_from_flax, vae_state_dict, vae_to_flax,
)
from shm_tpu_torch.train.vae import batch_loss, make_optimizer
from torch_openlab_roots import small_root

torch.set_num_threads(1)
VCFG = OpenLabConfig().vae


def test_vae_five_step_trajectory_matches_jax():
    from shm_tpu.config import VAEConfig as JaxVAEConfig

    T, bs, N, steps = 40, 16, 40, 5
    rng = np.random.default_rng(31)
    params = random_flax_vae_params(rng, VCFG)
    Z = rng.normal(size=(N, T, VCFG.input_dim)).astype(np.float32)
    order = [rng.permutation(N)[:bs] for _ in range(steps)]
    eps = rng.normal(size=(steps, bs, VCFG.latent_dim)).astype(np.float32)
    bmask = np.ones(bs, np.float32)
    bmask[-3:] = 0.0
    kl_w = 0.25
    t = OpenLabConfig().vae_train
    tkw = dict(lr=t.lr, weight_decay=t.weight_decay, grad_clip=t.grad_clip)

    jm = jax_vae_from_config(JaxVAEConfig(**{
        k: getattr(VCFG, k) for k in ("input_dim", "latent_dim", "hidden_dim",
                                      "num_layers", "dropout", "use_layernorm",
                                      "cell")}))
    tx = jax_make_optimizer(JaxTrainConfig(**tkw))
    pj = jax.tree.map(jnp.asarray, params)
    state = tx.init(pj)

    def loss_fn(p, xb, e):
        mu, logvar = jm.apply({"params": p}, xb, True, method=jm.encode)
        z = mu + e * jnp.exp(0.5 * logvar)
        recon = jm.apply({"params": p}, z, T, True, method=jm.decode)
        return jax_vae_loss(recon, xb, mu, logvar, kl_w, mask=jnp.asarray(bmask))[0]

    grad_fn = jax.jit(jax.grad(loss_fn))
    vae = vae_from_flax(params, VCFG).train()        # 1 layer: no mask to draw
    opt = make_optimizer(vae.parameters(), TrainConfig(**tkw))
    tt = torch.from_numpy
    for s in range(steps):
        xb = Z[order[s]]
        updates, state = tx.update(grad_fn(pj, jnp.asarray(xb),
                                           jnp.asarray(eps[s])), state, pj)
        pj = optax.apply_updates(pj, updates)
        opt.zero_grad()
        total, _, _ = batch_loss(vae, tt(xb), tt(bmask), tt(eps[s]), None, None,
                                 kl_w, use_kernel=False)
        total.backward()
        opt.step()

    got = vae_state_dict(vae_to_flax(vae), 1, True)
    ref = vae_state_dict(jax.tree.map(np.asarray, pj), 1, True)
    start = vae_state_dict(params, 1, True)
    moved = 0.0
    for k in ref:
        step = (ref[k] - start[k]).abs()
        excess = (got[k] - ref[k]).abs() - (1e-5 + 0.01 * step)
        assert float(excess.max()) <= 0, (k, float((got[k] - ref[k]).abs().max()))
        moved = max(moved, float(step.max()))
    assert moved > 1e-3


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = small_root(tmp_path_factory.mktemp("openlab_train") / "root",
                      step=4, outputs=())
    ol.main(["train-vae", "--root", str(root), "--epochs", "1", "--device",
             "cpu", "--no-plots"])
    return root


def test_train_vae_command_read_back_by_jax(trained):
    from shm_tpu.cli import openlab as jol


    art = trained / "output/VAE_Training/artifacts"
    man = json.loads((art / "vae_clean_manifest.json").read_text())
    committed = json.loads((ol.Paths("data/openlab").vae_dir / "artifacts"
                            / "vae_clean_manifest.json").read_text())
    # the committed manifest predates the "cell" key the JAX command writes
    assert man.keys() == committed.keys()
    for k in ("normalization", "optimizer", "train"):
        assert man[k].keys() == committed[k].keys(), k
    assert man["model"] == {**committed["model"], "cell": "lstm"}
    assert man["train"]["epochs"] == 1 and man["train"]["train_normals"] == 251
    jm, jp, mu, sd, _ = jol._load_openlab_vae(jol.Paths(str(trained), ""),
                                             JaxOpenLabConfig())
    vae, mu2, sd2, _ = ol._load_openlab_vae(ol.Paths(str(trained)), OpenLabConfig())
    assert np.array_equal(mu, mu2) and np.array_equal(sd, sd2)
    x = np.random.default_rng(0).normal(size=(3, 200, 3)).astype(np.float32)
    recon_j, _, _ = jm.apply({"params": jp}, jnp.asarray(x))
    with torch.no_grad():
        recon, _, _ = vae(torch.from_numpy(x))
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=2e-6)
