"""The port's data-parallel training (``train_vae(mesh=)``,
``train_cnn(mesh=)``, ``parallel.make_dp_*_train_step``) on the CPU.

A mesh run is the same math as one device: the same generator, each
minibatch split into shards that sum their losses and gradients. It is held
to one device at the bounds of the JAX package's own mesh tests
(``tests/test_parallel.py::TestMeshTraining``), with the port's CPU mesh of
8 shards in place of the JAX tests' 8 virtual devices: histories rtol 1e-5,
the best epoch equal, parameters atol 1e-6; the CNN one full-batch step's
loss rtol 1e-5 and BatchNorm statistics rtol 1e-4 / atol 1e-6, and two
epochs' losses rtol 1e-2 (the JAX test's words: reduction-order noise
crosses ReLU / max-pool / BatchNorm decision boundaries and compounds).

The explicit steps (``make_dp_cnn_train_step``, ``make_dp_vae_train_step``)
are held to the JAX package's on its 8 virtual CPU devices
(``tests/conftest.py``), on the same weights carried over by
``shm_tpu_torch/convert.py``, for one step under plain SGD (whose update
is the averaged gradient itself, so a wrong sum or shard count shows) and
under the trainers' Adam chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from shm_tpu.config import TrainConfig as JaxTrainConfig
from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu.parallel import make_dp_cnn_train_step as jax_dp_cnn_step
from shm_tpu.parallel import make_dp_vae_train_step as jax_dp_vae_step
from shm_tpu.parallel import make_mesh as jax_make_mesh
from shm_tpu.parallel import replicate as jax_replicate
from shm_tpu.parallel import shard_batch as jax_shard_batch
from shm_tpu.train.vae import make_optimizer as jax_make_optimizer
from shm_tpu_torch.config import TrainConfig, VAEConfig
from shm_tpu_torch.convert import (
    cnn4dof_from_flax, cnn4dof_to_flax, vae_from_flax, vae_to_flax,
)
from shm_tpu_torch.models.cnn import CNN4DOF, CNNOpenLab
from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.parallel import (
    Mesh, make_dp_cnn_train_step, make_dp_vae_train_step, make_mesh,
    shard_batch,
)
from shm_tpu_torch.train.cnn import train_cnn
from shm_tpu_torch.train.vae import make_optimizer, train_vae

torch.set_num_threads(1)

CPU8 = make_mesh(8, device="cpu")
VAE_CFG = TrainConfig(epochs=3, batch_size=16, lr=1e-3, weight_decay=1e-5,
                      grad_clip=2.0, seed=0)


def _vae_data(seed=42):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(48, 16, 4)).astype(np.float32),
            rng.normal(size=(24, 16, 4)).astype(np.float32))


def _vae(cell="lstm"):
    return TemporalVAE(4, 3, 32 if cell == "attention" else 8, 2, True, 0.2,
                       cell)


def _same_run(got, ref, params_atol=1e-6, skip=()):
    np.testing.assert_allclose(got.history["train_total"],
                               ref.history["train_total"], rtol=1e-5)
    np.testing.assert_allclose(got.history["val_total"],
                               ref.history["val_total"], rtol=1e-5)
    assert got.best_epoch == ref.best_epoch
    for k in ref.params:
        if not any(s in k for s in skip):
            np.testing.assert_allclose(got.params[k].numpy(),
                                       ref.params[k].numpy(),
                                       atol=params_atol, err_msg=k)


@pytest.mark.parametrize("cell,mesh", [
    ("lstm", CPU8),
    ("lstm", make_mesh(3, device="cpu")),    # 16 rows as 6 / 5 / 5
    ("min_gru", CPU8),
])
def test_train_vae_mesh_matches_single_device(cell, mesh):
    Ztr, Zva = _vae_data()
    ref = train_vae(_vae(cell), Ztr, Zva, VAE_CFG, device="cpu")
    got = train_vae(_vae(cell), Ztr, Zva, VAE_CFG, device="cpu", mesh=mesh)
    _same_run(got, ref)


def test_train_vae_mesh_attention():
    """The attention cell's masks are drawn ahead of the forward in its
    order (one [1, 1, T, T] weight mask a block for every shard, the
    residual masks sliced): a mesh of one shard is one device bit for bit.
    Over 8 shards the key projections' biases are left out of the
    parameter check: softmax is blind to them, so their gradient is 0 in
    exact arithmetic and float noise that Adam scales to whole steps."""
    Ztr, Zva = _vae_data()
    ref = train_vae(_vae("attention"), Ztr, Zva, VAE_CFG, device="cpu")
    one = train_vae(_vae("attention"), Ztr, Zva, VAE_CFG, device="cpu",
                    mesh=make_mesh(1, device="cpu"))
    assert one.history == ref.history
    for k in ref.params:
        assert torch.equal(one.params[k], ref.params[k]), k
    got = train_vae(_vae("attention"), Ztr, Zva, VAE_CFG, device="cpu",
                    mesh=CPU8)
    _same_run(got, ref, skip=("key.bias",))


def test_train_vae_mesh_rejects_the_kernel():
    Ztr, Zva = _vae_data()
    with pytest.raises(ValueError, match="mesh"):
        train_vae(_vae(), Ztr, Zva, TrainConfig(epochs=1, batch_size=16),
                  device="cpu", mesh=CPU8, use_kernel=True)
    with pytest.raises(ValueError, match="one process"):
        train_vae(_vae(), Ztr, Zva, TrainConfig(epochs=1, batch_size=16),
                  mesh=Mesh((torch.device("cpu"),), num_processes=2))
    with pytest.raises(ValueError, match="mesh's device type"):
        train_vae(_vae(), Ztr, Zva, TrainConfig(epochs=1, batch_size=16),
                  device="cuda", mesh=CPU8)


def test_train_vae_mesh_checkpoint_resumes(tmp_path, monkeypatch, capsys):
    """A mesh run stopped after epoch 2 resumes on the same trajectory,
    with the mesh bit for bit, without it within the mesh bounds."""
    from shm_tpu_torch.train import checkpoint as ckpt_mod

    Ztr, Zva = _vae_data(3)
    cfg = TrainConfig(epochs=4, batch_size=16, seed=2)
    straight = train_vae(_vae(), Ztr, Zva, cfg, device="cpu", mesh=CPU8)
    real = ckpt_mod.save_train_ckpt

    class Stop(Exception):
        pass

    def save_then_stop(path, arrays, meta):
        real(path, arrays, meta)
        if meta["epoch"] == 2:
            raise Stop

    for mesh in (CPU8, None):
        ck = str(tmp_path / f"ck{mesh is None}")
        monkeypatch.setattr(ckpt_mod, "save_train_ckpt", save_then_stop)
        with pytest.raises(Stop):
            train_vae(_vae(), Ztr, Zva, cfg, device="cpu", mesh=CPU8,
                      checkpoint_dir=ck, checkpoint_every=2)
        monkeypatch.setattr(ckpt_mod, "save_train_ckpt", real)
        resumed = train_vae(_vae(), Ztr, Zva, cfg, device="cpu", mesh=mesh,
                            checkpoint_dir=ck, checkpoint_every=2)
        assert "[resume] restored epoch 2" in capsys.readouterr().out
        if mesh is None:
            _same_run(resumed, straight)
        else:
            assert resumed.history == straight.history
            for k in straight.params:
                assert torch.equal(resumed.params[k], straight.params[k]), k


def _cnn_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(48, 100, 12, 2)).astype(np.float32) * 0.3
    y = rng.integers(0, 2, 48).astype(np.int32)
    X[y == 1, :, :, 1] += 1.5
    return X, y, X[:16].copy(), y[:16].copy()


def test_train_cnn_mesh_matches_single_device():
    X, y, Xva, yva = _cnn_data()
    one = TrainConfig(epochs=1, batch_size=48, lr=1e-3, weight_decay=5e-5,
                      grad_clip=0.0, seed=1)
    r1 = train_cnn(CNN4DOF(dropout=0.5), X, y, Xva, yva, one, device="cpu")
    g1 = train_cnn(CNN4DOF(dropout=0.5), X, y, Xva, yva, one, device="cpu",
                   mesh=CPU8)
    np.testing.assert_allclose(g1.history["train_loss"],
                               r1.history["train_loss"], rtol=1e-5)
    # the running statistics of ONE update over the whole batch
    for k in r1.variables:
        if "running" in k:
            np.testing.assert_allclose(g1.variables[k].numpy(),
                                       r1.variables[k].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    assert int(g1.variables["bn1.num_batches_tracked"]) == 1
    cfg = TrainConfig(epochs=2, batch_size=16, lr=1e-3, weight_decay=5e-5,
                      grad_clip=0.0, seed=1)
    ref = train_cnn(CNN4DOF(dropout=0.5), X, y, Xva, yva, cfg, device="cpu")
    got = train_cnn(CNN4DOF(dropout=0.5), X, y, Xva, yva, cfg, device="cpu",
                    mesh=CPU8)
    for k in ("train_loss", "val_loss"):
        np.testing.assert_allclose(got.history[k], ref.history[k], rtol=1e-2)


def test_train_cnn_openlab_mesh_one_step():
    """GroupNorm is per window: one step of the openLAB CNN's focal recipe
    (weighted sampling, the ST-F2 metric) over 8 shards is one device's."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(32, 200, 4, 1)).astype(np.float32)
    y = rng.integers(0, 2, 32)
    cfg = TrainConfig(epochs=1, batch_size=32, lr=1e-3, seed=3,
                      decoupled_wd=True, weight_decay=1e-4)
    kw = dict(loss="focal", class_alpha=np.array([0.8, 1.2], np.float32),
              sample_weights=np.where(y == 0, 0.8, 1.2),
              val_metric_fn=lambda p, t: float((p.argmax(1) == t).mean()),
              device="cpu")
    ref = train_cnn(CNNOpenLab(), X, y, X[:8], y[:8], cfg, **kw)
    got = train_cnn(CNNOpenLab(), X, y, X[:8], y[:8], cfg, mesh=CPU8, **kw)
    np.testing.assert_allclose(got.history["train_loss"],
                               ref.history["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got.history["val_loss"],
                               ref.history["val_loss"], rtol=1e-5)
    assert got.history["val_metric"] == ref.history["val_metric"]


def test_dp_cnn_train_step_runs_and_improves():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 100, 12, 2)).astype(np.float32) * 0.3
    y = rng.integers(0, 2, 64)
    X[y == 1, :, :, 1] += 2.0
    cnn = CNN4DOF()
    cnn.init_parameters(torch.Generator().manual_seed(0))
    tx = make_optimizer(cnn.parameters(), TrainConfig(lr=1e-3, weight_decay=0.0,
                                                      grad_clip=0.0))
    step = make_dp_cnn_train_step(cnn, tx, CPU8)
    Xd, yd = shard_batch(X, CPU8), shard_batch(y, CPU8)
    losses = [float(step(Xd, yd, seed=i)) for i in range(8)]
    assert losses[-1] < losses[0]
    # the running statistics are the mean of the shards' updates: after one
    # step from (0, 1) they sit strictly between the shards' extremes
    assert torch.all(cnn.bn1.running_var != 1.0)


def test_dp_vae_train_step_matches_a_two_shard_split():
    """The explicit step over 8 shards and over 2: each shard's noise
    comes from (seed, its global index), so the losses differ; a mesh of
    one device holding two shards gives one process of two shards' loss
    (the 2-process run of ``tests/test_torch_distributed.py``)."""
    W = np.random.default_rng(0).standard_normal((16, 10, 4)).astype(np.float32)

    def run(mesh):
        vae = TemporalVAE(4, 3, 8, 2, use_layernorm=True, dropout=0.0)
        vae.init_parameters(torch.Generator().manual_seed(1))
        tx = make_optimizer(vae.parameters(),
                            TrainConfig(lr=1e-3, weight_decay=1e-5,
                                        grad_clip=2.0))
        step = make_dp_vae_train_step(vae, tx, mesh)
        return [float(step(shard_batch(W, mesh), seed=2, kl_w=0.5))
                for _ in range(3)]

    two = run(make_mesh(2, device="cpu"))
    assert two == run(Mesh((torch.device("cpu"),) * 2))
    assert two[-1] < two[0]
    assert run(CPU8) != two


OPT_KW = dict(lr=1e-3, weight_decay=1e-5, grad_clip=2.0)
SGD_LR = 0.1


# the parameters after one step: atol 1e-6 under SGD (the JAX mesh tests'
# bound); 1e-5 under Adam (``test_torch_train_vae.py``'s bound for the same
# chain: its normalisation turns a gradient's float noise into up to lr=1e-3
# times the noise's relative size, 1.5e-6 read on one conv2 weight)
PARAM_ATOL = {"sgd": 1e-6, "adam": 1e-5}


def _optimizers(opt, params):
    """(optax transform, torch optimizer over ``params``) of one kind:
    ``"sgd"`` (lr 0.1) or ``"adam"`` (the trainers' clipped Adam chain)."""
    if opt == "sgd":
        return optax.sgd(SGD_LR), torch.optim.SGD(params, lr=SGD_LR)
    return (jax_make_optimizer(JaxTrainConfig(**OPT_KW)),
            make_optimizer(params, TrainConfig(**OPT_KW)))


def _assert_trees_close(got, ref, start, atol, skip=()):
    """Every leaf of the flax tree ``got`` within ``atol`` of ``ref``'s,
    and the step moved the parameters by more than that."""
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    g, r, s0 = flat(got), flat(ref), flat(start)
    assert g.keys() == r.keys()
    moved = 0.0
    for k in r:
        if not any(n in k for n in skip):
            np.testing.assert_allclose(g[k], r[k], atol=atol, rtol=0,
                                       err_msg=k)
        moved = max(moved, float(np.abs(r[k] - s0[k]).max()))
    assert moved > 100 * atol


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dp_cnn_train_step_matches_jax(opt):
    """One step of ``make_dp_cnn_train_step`` over 8 shards of 8 windows
    against the JAX step, dropout 0 so that no noise enters: the loss
    within rtol 1e-5, the parameters within ``PARAM_ATOL`` and the running
    statistics (the mean of the shards' updates) within rtol 1e-4 / atol
    1e-6, the bounds of the JAX mesh tests. Under Adam the convolutions'
    biases are left out of the parameter check: the BatchNorm after each
    subtracts them, so their gradient is 0 in exact arithmetic and float
    noise that Adam's first step scales to a whole step of lr."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 100, 12, 2)).astype(np.float32) * 0.3
    y = rng.integers(0, 2, 64).astype(np.int32)
    X[y == 1, :, :, 1] += 2.0
    jcnn = JaxCNN4DOF(dropout=0.0)
    variables = jax.tree.map(np.asarray, jcnn.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(X[:2]), train=False))
    cnn = cnn4dof_from_flax(variables)
    cnn.dropout = 0.0
    jtx, tx = _optimizers(opt, cnn.parameters())

    jmesh = jax_make_mesh(8)
    jstep = jax_dp_cnn_step(jcnn, jtx, jmesh)
    jp, jbst, _, jl = jstep(
        jax_replicate(variables["params"], jmesh),
        jax_replicate(variables["batch_stats"], jmesh),
        jax_replicate(jtx.init(variables["params"]), jmesh),
        jax_shard_batch(X, jmesh), jax_shard_batch(y, jmesh),
        jax.random.PRNGKey(0))
    loss = make_dp_cnn_train_step(cnn, tx, CPU8)(
        shard_batch(X, CPU8), shard_batch(y, CPU8), seed=0)

    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got = cnn4dof_to_flax(cnn)
    _assert_trees_close(got["params"], jax.device_get(jp),
                        variables["params"], atol=PARAM_ATOL[opt],
                        skip=("conv1']['bias", "conv2']['bias")
                        if opt == "adam" else ())
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(got["batch_stats"][bn][k],
                                       np.asarray(jbst[bn][k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{bn}.{k}")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_dp_vae_train_step_matches_jax(opt):
    """One step of ``make_dp_vae_train_step`` over 8 shards of 8 windows
    against the JAX step: the loss within rtol 1e-5, the parameters within
    ``PARAM_ATOL``. Each package draws the reparameterisation noise from
    its own generator, so ``fc_logvar`` is set to weight 0 and bias -60:
    the noise enters z as ``eps * exp(-30)`` (~1e-13), below float32's
    resolution of mu, and both steps are deterministic; dropout is 0."""
    rng = np.random.default_rng(1)
    W = rng.standard_normal((64, 10, 4)).astype(np.float32)
    jvae = jax_vae_from_config(JaxVAEConfig(4, 3, 8, 2, 0.0,
                                            use_layernorm=True))
    params = jax.tree.map(np.asarray, jvae.init(
        {"params": jax.random.PRNGKey(1)}, jnp.asarray(W[:2]))["params"])
    params = dict(params, fc_logvar={
        "kernel": np.zeros_like(params["fc_logvar"]["kernel"]),
        "bias": np.full_like(params["fc_logvar"]["bias"], -60.0)})
    vae = vae_from_flax(params, VAEConfig(input_dim=4, latent_dim=3,
                                          hidden_dim=8, num_layers=2,
                                          dropout=0.0, use_layernorm=True))
    jtx, tx = _optimizers(opt, vae.parameters())

    jmesh = jax_make_mesh(8)
    jp, _, jl = jax_dp_vae_step(jvae, jtx, jmesh)(
        jax_replicate(params, jmesh), jax_replicate(jtx.init(params), jmesh),
        jax_shard_batch(W, jmesh), jax.random.PRNGKey(2), jnp.float32(0.5))
    loss = make_dp_vae_train_step(vae, tx, CPU8)(shard_batch(W, CPU8),
                                                 seed=2, kl_w=0.5)

    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_trees_close(vae_to_flax(vae), jax.device_get(jp), params,
                        atol=PARAM_ATOL[opt])
