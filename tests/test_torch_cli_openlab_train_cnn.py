"""The port's openLAB ``train-cnn`` against the JAX package, on the CPU.

The two frameworks' random streams differ, so the trajectory carries the
draws across: ``CNNOpenLab`` with the openLAB recipe (focal loss,
inverse-frequency alpha, weighted draws, AdamW, clip 2.0), five steps of one
epoch against ``shm_tpu.train.cnn.train_cnn``, flax's init, JAX's weighted
draws and its dropout masks carried across; the mean loss within 1e-4
relative (float32 GroupNorm sums in another order), parameters within atol
2e-6 but for at most 4 entries or 0.1% of a tensor (entries whose gradient
is rounding noise, which Adam moves by up to lr a step: 61 of b3_conv's
122,880, 15 of b4_conv's 294,912 here), and within ``steps * lr``
everywhere (the 4DOF CNN's rule, ``tests/test_torch_cnn_train.py``, scaled
to these wider convolutions); eval-mode logits within 1e-4.

The command on a small root (``tests/torch_openlab_roots.py``), cut to one
epoch: ``cnn_training_info.json``'s keys are the JAX command's, it warns of
the channel its plain statistics zero (LWA_4), and ``shm_tpu`` loads the
port's checkpoint to the same model (atol 1e-5).
"""

import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.config import OpenLabConfig as JaxOpenLabConfig
from shm_tpu.config import TrainConfig as JaxTrainConfig
from shm_tpu.models import CNNOpenLab as JaxCNNOpenLab
from shm_tpu.train.cnn import train_cnn as jax_train_cnn
from shm_tpu_torch.cli import openlab as ol
from shm_tpu_torch.config import OpenLabConfig, TrainConfig
from shm_tpu_torch.convert import cnn_openlab_state_dict, cnn_openlab_to_flax
from shm_tpu_torch.models.cnn import CNNOpenLab
from shm_tpu_torch.train.cnn import batch_loss as cnn_batch_loss
from shm_tpu_torch.train.cnn import weighted_focal_loss
from shm_tpu_torch.train.vae import make_optimizer
from torch_openlab_roots import small_root

torch.set_num_threads(1)


def _jax_dropout_masks(jmodel, variables, xb, key):
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            masks.append(np.asarray(next_fun(jnp.ones_like(args[0]), *args[1:],
                                             **kwargs)) != 0)
            return args[0]
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        jmodel.apply(variables, jnp.asarray(xb), train=True, rngs={"dropout": key})
    return masks[0]


def test_cnn_five_step_trajectory_matches_jax():
    rng = np.random.default_rng(3)
    N, bs, steps = 36, 8, 5
    Xtr = rng.normal(size=(N, 200, 4, 1)).astype(np.float32)
    ytr = rng.integers(0, 2, N).astype(np.int32)
    Xva = rng.normal(size=(10, 200, 4, 1)).astype(np.float32)
    yva = rng.integers(0, 2, 10).astype(np.int32)
    alpha = np.array([0.4, 1.6], np.float32)
    w = np.where(ytr == 0, alpha[0], alpha[1])
    c = OpenLabConfig().cnn_train
    common = dict(epochs=1, batch_size=bs, seed=5, early_stop_patience=0,
                  lr=c.lr, weight_decay=c.weight_decay, grad_clip=c.grad_clip,
                  decoupled_wd=True)
    jmodel = JaxCNNOpenLab()
    jres = jax_train_cnn(jmodel, Xtr, ytr, Xva, yva, JaxTrainConfig(**common),
                         loss="focal", focal_gamma=2.0, class_alpha=alpha,
                         sample_weights=w, fused_epoch=False)

    root = jax.random.PRNGKey(5)
    k_init, root = jax.random.split(root)
    init = jax.tree.map(np.asarray, jmodel.init({"params": k_init},
                                                jnp.asarray(Xtr[:2]), train=False))
    _, ke = jax.random.split(root)
    kperm, kbatch = jax.random.split(ke)
    p = jnp.asarray(np.asarray(w / w.sum(), np.float32))
    idx = np.asarray(jax.random.choice(kperm, N, (N,), replace=True, p=p))
    pad = steps * bs - N
    idx = np.r_[idx, np.zeros(pad, idx.dtype)].reshape(steps, bs)
    bmask = np.r_[np.ones(N), np.zeros(pad)].astype(np.float32).reshape(steps, bs)
    bkeys = jax.random.split(kbatch, steps)

    model = CNNOpenLab()
    model.load_state_dict(cnn_openlab_state_dict(init))
    cfg = TrainConfig(**common)
    opt = make_optimizer(model.parameters(), cfg)
    a = torch.from_numpy(alpha)
    loss_fn = lambda out, y: weighted_focal_loss(out, y, a, 2.0)
    t = torch.from_numpy
    total, count = 0.0, 0.0
    for b in range(steps):
        model.train()
        mask = _jax_dropout_masks(jmodel, cnn_openlab_to_flax(model),
                                  Xtr[idx[b]], bkeys[b])
        opt.zero_grad()
        l = cnn_batch_loss(model, t(Xtr[idx[b]]), t(ytr[idx[b]]).long(),
                           t(bmask[b]), t(mask), loss_fn)
        l.backward()
        opt.step()
        total += float(l.detach()) * bmask[b].sum()
        count += bmask[b].sum()
    # the mean focal loss of 5 float32 steps (GroupNorm sums in another order)
    np.testing.assert_allclose(total / count, jres.history["train_loss"][0],
                               rtol=1e-4)
    got = cnn_openlab_to_flax(model)["params"]
    want = jax.tree.map(np.asarray, jres.variables)["params"]
    moved = 0.0
    for layer, leaves in want.items():
        for name, ref in leaves.items():
            diff = np.abs(got[layer][name] - ref)
            # entries whose gradient is rounding noise: Adam's normalisation
            # moves them by up to lr a step, in either framework's direction
            assert (diff > 2e-6).sum() <= max(4, 1e-3 * diff.size), f"{layer}.{name}"
            assert diff.max() <= steps * cfg.lr, f"{layer}.{name}"
            moved = max(moved, float(np.abs(ref - init["params"][layer][name]).max()))
    assert moved > cfg.lr
    # the two trained models compute the same function
    jeval = jmodel.apply(jres.variables, jnp.asarray(Xva), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(t(Xva)).numpy(), np.asarray(jeval),
                                   atol=1e-4)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = small_root(tmp_path_factory.mktemp("openlab_train") / "root",
                      step=4, outputs=())
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ol.main(["train-cnn", "--root", str(root), "--epochs", "1", "--device",
                 "cpu", "--no-plots"])
    return root, out.getvalue()


def test_train_cnn_command_read_back_by_jax(trained):
    from shm_tpu.cli import openlab as jol
    from shm_tpu.train.cnn import predict_probs as jax_predict_probs

    trained, log = trained
    assert "[WARN] NaN raw-window stats zero out channel(s) [3]" in log
    art = trained / "output/CNN_Training/artifacts"
    info = json.loads((art / "cnn_training_info.json").read_text())
    committed = json.loads((ol.Paths("data/openlab").cnn_dir / "artifacts"
                            / "cnn_training_info.json").read_text())
    assert info.keys() == committed.keys()
    assert info["val"].keys() == committed["val"].keys()
    assert info["settings"] == committed["settings"]
    mu_sd = np.load(art / "cnn_raw_mu_sd.npy")
    assert mu_sd.shape == (2, 4) and np.isnan(mu_sd[:, 3]).all()   # LWA_4
    jm, jv, jmu, jsd = jol._load_openlab_cnn(jol.Paths(str(trained), ""),
                                             JaxOpenLabConfig(), conv_impl="im2col")
    cnn, mu, sd = ol._load_openlab_cnn(ol.Paths(str(trained)), OpenLabConfig())
    x = np.random.default_rng(1).normal(size=(5, 200, 4, 1)).astype(np.float32)
    with torch.no_grad():
        got = torch.softmax(cnn(torch.from_numpy(x)), -1).numpy()
    np.testing.assert_allclose(got, jax_predict_probs(jm, jv, x, batch_size=8),
                               atol=1e-5)
