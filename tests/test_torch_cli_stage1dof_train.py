"""The port's 1-DOF ``train-vae`` (``shm_tpu_torch/cli/stage1dof.py``) of
the LSTM on the CPU against the JAX package: one epoch, its checkpoint
restored by the JAX command's ``_load_model`` and evaluated by the JAX
``test-seen`` (``tests/torch_stage1dof_train.py``; the other two cells:
``tests/test_torch_cli_stage1dof_train_cells.py``); and a 5-step
trajectory of the 1-DOF recipe (the no-LayerNorm preset, batch 64 with a
ragged batch, no clip, no decay) fed the same noise on both sides.
Tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import STAGE1_TABLES
from shm_tpu.models.vae import vae_loss as jax_vae_loss
from shm_tpu.ops.lstm_train import vae_train_forward as jax_vae_train_forward
from shm_tpu.train.vae import make_optimizer as jax_make_optimizer
from shm_tpu_torch.config import Stage1DofConfig
from shm_tpu_torch.convert import (
    random_flax_vae_params, vae_from_flax, vae_state_dict, vae_to_flax,
)
from shm_tpu_torch.train import make_optimizer
from shm_tpu_torch.train.vae import batch_loss
from torch_stage1dof_train import (
    check_jax_load_model, check_test_seen_tables, check_train_vae_artifacts,
    train_and_test_seen,
)

torch.set_num_threads(1)

CELLS = ["lstm"]


@pytest.fixture(scope="module", params=CELLS)
def trained(request, tmp_path_factory):
    return train_and_test_seen(tmp_path_factory, request.param)


def test_train_vae_artifacts(trained):
    cell, root, _ = trained
    check_train_vae_artifacts(cell, root)


def test_jax_load_model_restores_the_port_checkpoint(trained):
    cell, root, _ = trained
    check_jax_load_model(cell, root)


@pytest.mark.parametrize("rel", STAGE1_TABLES[:2])
def test_jax_test_seen_gives_the_port_s_tables(trained, rel):
    _, root, jax_root = trained
    check_test_seen_tables(root, jax_root, rel)


def test_five_step_trajectory_at_the_1dof_preset():
    """The 1-DOF preset (D=12, H=32, Z=5, T=80, two layers, no LayerNorm)
    and recipe (batch 64, lr 1e-3, no weight decay, no clip) for five
    optimizer steps from one numpy parameter tree, batch order, eps and
    dropout masks (keep 0.8); the fourth batch ragged (13 of 64 valid, the
    recipe's last batch). JAX: its training forward (the jnp reference of
    the Pallas scans), vae_loss with the batch mask, the optax chain; the
    port: batch_loss through the training ops' path (their plain versions
    on the CPU) and ClippedAdam. Every parameter within 1e-5 after five
    steps, the bound of tests/test_torch_train_vae.py's trajectory."""
    cfg = Stage1DofConfig()
    v, tc = cfg.vae, cfg.train
    T, D, H, Z, bs, steps = cfg.seq_len, v.input_dim, v.hidden_dim, v.latent_dim, \
        tc.batch_size, 5
    rng = np.random.default_rng(17)
    params = random_flax_vae_params(rng, v)
    assert "layer_norm" not in params
    Zw = rng.normal(size=(200, T, D)).astype(np.float32)
    order = [rng.permutation(200)[:bs] for _ in range(steps)]
    eps = rng.normal(size=(steps, bs, Z)).astype(np.float32)
    keep = 1.0 - v.dropout
    masks = ((rng.random((steps, 2, T, H, bs)) < keep) / keep).astype(np.float32)
    bmasks = np.ones((steps, bs), np.float32)
    bmasks[3, 13:] = 0.0
    kl_w = 0.25

    tx = jax_make_optimizer(tc)
    assert tc.grad_clip == 0.0 and tc.weight_decay == 0.0
    pj = jax.tree.map(jnp.asarray, params)
    state = tx.init(pj)

    def loss_fn(p, xb, e, me, md, bm):
        recon, mu, logvar = jax_vae_train_forward(
            p, xb, e, me, md, use_layernorm=False, use_pallas=False)
        return jax_vae_loss(recon, xb, mu, logvar, kl_w, mask=bm)[0]

    grad_fn = jax.jit(jax.grad(loss_fn))
    vae = vae_from_flax(params, v).train()
    opt = make_optimizer(vae.parameters(), tc)
    t = torch.from_numpy
    for s in range(steps):
        xb = Zw[order[s]]
        grads = grad_fn(pj, jnp.asarray(xb), jnp.asarray(eps[s]), jnp.asarray(masks[s, 0]),
                        jnp.asarray(masks[s, 1]), jnp.asarray(bmasks[s]))
        updates, state = tx.update(grads, state, pj)
        pj = optax.apply_updates(pj, updates)

        opt.zero_grad()
        total, _, _ = batch_loss(vae, t(xb), t(bmasks[s]), t(eps[s]), [t(masks[s, 0])],
                                 [t(masks[s, 1])], kl_w, use_kernel=True)
        total.backward()
        opt.step()

    got = vae_state_dict(vae_to_flax(vae), 2, False)
    ref = vae_state_dict(jax.tree.map(np.asarray, pj), 2, False)
    start = vae_state_dict(params, 2, False)
    moved = 0.0
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), atol=1e-5, rtol=0,
                                   err_msg=k)
        moved = max(moved, float((ref[k] - start[k]).abs().max()))
    assert moved > 1e-3                               # the steps did move them
