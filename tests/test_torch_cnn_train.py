"""The port's CNN4DOF training (``shm_tpu_torch.train.cnn``, the training
mode of ``models/cnn.py``, ``convert.cnn4dof_to_flax`` and the ``train-cnn``
command) against the JAX package, on the CPU.

- The training-mode forward and BatchNorm's running statistics against
  flax's, the dropout mask carried across: logits within atol 1e-4
  (``tests/test_torch_cnn.py``'s float32 tolerance), running statistics
  within rtol 1e-6, which the unbiased variance misses by ~1e-5.
- Five optimizer steps, one epoch with a padded last batch, against
  ``shm_tpu.train.cnn.train_cnn``: flax's initial variables, JAX's batch
  order and its dropout masks carried across. After the five steps the
  parameters agree within atol 2e-6, BatchNorm's running variances within
  rtol 1e-5 and the two models' training-mode logits within atol 1e-4 (the
  float32 forward tolerance above); but for at most 4 entries of a tensor
  whose data gradient and weight decay cancel (2 of fc1's 307,200 here),
  which Adam's normalisation parts by up to lr a step.
- The two conv biases are not compared with flax's: their exact gradient is
  0 (BatchNorm subtracts the batch mean right after them), so their values
  are rounding noise that Adam turns into steps of up to lr, and BatchNorm's
  running means average that noise in. Instead, at every step, each conv
  bias's gradient stays at rounding level (at most 2e-5 of its weight's
  largest gradient; measured at most 3.4e-6) and each running mean and
  variance is the flax update of that step's batch statistics (pad rows
  included), computed apart from the conv output within rtol 1e-6; after
  the steps the eval-mode logits (running statistics, as ``test-pipeline``
  uses them) agree with flax's within atol 5e-3 (measured 1.3e-3 and
  2.1e-3, the conv-bias noise).
"""

import json
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.config import TrainConfig as JaxTrainConfig
from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.train.cnn import train_cnn as jax_train_cnn
from shm_tpu.train.cnn import weighted_focal_loss as jax_focal
from shm_tpu.utils.checkpoint import load_params
from shm_tpu_torch.cli import stage4dof as cli
from shm_tpu_torch.config import Stage4DofConfig, TrainConfig, replace
from shm_tpu_torch.convert import (
    cnn4dof_from_flax, cnn4dof_state_dict, cnn4dof_to_flax,
)
from shm_tpu_torch.models.cnn import CNN4DOF
from shm_tpu_torch.train.cnn import (
    batch_loss, cross_entropy_loss, epoch_order, predict_probs, train_cnn,
    weighted_focal_loss,
)
from shm_tpu_torch.train.vae import make_optimizer
from shm_tpu_torch.utils.checkpoint import load_checkpoint

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
X_SHAPE = (100, 12, 2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_dropout_masks(jmodel, variables, xbs, keys):
    """fc1's dropout keep masks that flax draws for each (batch, key): the
    Dropout call is run on ones (the rng it takes is the same whatever its
    input) and what survives is kept."""
    masks = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            masks.append(np.asarray(out) != 0)
            return args[0]
        return next_fun(*args, **kwargs)

    for xb, k in zip(xbs, keys):
        with fnn.intercept_methods(interceptor):
            jmodel.apply(variables, jnp.asarray(xb), train=True,
                         rngs={"dropout": k}, mutable=["batch_stats"])
    return masks


def _random_variables(seed):
    """flax CNN4DOF variables with BatchNorm scale, bias and running
    statistics drawn away from (1, 0, 0, 1)."""
    rng = np.random.default_rng(seed)
    jmodel = JaxCNN4DOF()
    v = _np_tree(jmodel.init({"params": jax.random.PRNGKey(seed)},
                             jnp.zeros((2,) + X_SHAPE)))
    for bn in ("bn1", "bn2"):
        c = v["params"][bn]["scale"].shape
        v["params"][bn]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        v["params"][bn]["bias"] = rng.uniform(-0.3, 0.3, c).astype(np.float32)
        v["batch_stats"][bn]["mean"] = rng.uniform(-0.5, 0.5, c).astype(np.float32)
        v["batch_stats"][bn]["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return jmodel, v


@pytest.mark.parametrize("seed", [0, 1])
def test_training_forward_and_running_stats_match_flax(seed):
    jmodel, v = _random_variables(seed)
    x = np.random.default_rng(10 + seed).normal(size=(16,) + X_SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(100 + seed)
    [mask] = _jax_dropout_masks(jmodel, v, [x], [key])
    out_j, mut = jmodel.apply(v, jnp.asarray(x), train=True,
                              rngs={"dropout": key}, mutable=["batch_stats"])
    assert 0.3 < mask.mean() < 0.7 and mask.shape == (16, 128)

    cnn = cnn4dof_from_flax(v).train()
    out = cnn(torch.from_numpy(x), dropout_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=1e-4)
    got = cnn4dof_to_flax(cnn)["batch_stats"]
    want = _np_tree(mut["batch_stats"])
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var"):
            np.testing.assert_allclose(got[bn][k], want[bn][k], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{bn}.{k}")
        assert not np.allclose(got[bn]["var"], v["batch_stats"][bn]["var"])

    # the tolerance tells the biased running variance from torch's own
    # (unbiased) update, which is what nn.BatchNorm2d would have done
    ref = cnn4dof_from_flax(v).train()
    for bn in (ref.bn1, ref.bn2):
        bn.forward = torch.nn.BatchNorm2d.forward.__get__(bn)
    ref(torch.from_numpy(x), dropout_mask=torch.from_numpy(mask))
    unbiased = ref.bn1.running_var.numpy()
    assert not np.allclose(unbiased, want["bn1"]["var"], rtol=1e-6, atol=1e-7)
    # eval mode is the inference model: running statistics, no dropout
    cnn.eval()
    with torch.no_grad():
        e1 = cnn(torch.from_numpy(x), dropout_mask=torch.zeros(16, 128, dtype=torch.bool))
        e2 = cnn(torch.from_numpy(x))
    assert torch.equal(e1, e2)


def _trajectory_case(kind):
    """(flax model, jax config, port config, train kwargs) of a 5-step case:
    36 windows in batches of 8 (4 full, the last padded with 4 rows)."""
    if kind == "ce":
        kw = dict(lr=1e-4, weight_decay=5e-5, grad_clip=0.0)
        train_kw = {}
    else:
        rng = np.random.default_rng(7)
        kw = dict(lr=3e-4, weight_decay=1e-4, grad_clip=2.0, decoupled_wd=True)
        train_kw = dict(loss="focal", focal_gamma=2.0,
                        class_alpha=np.array([0.3, 0.7], np.float32),
                        sample_weights=rng.uniform(0.2, 1.0, 36))
    common = dict(epochs=1, batch_size=8, seed=5, early_stop_patience=0, **kw)
    return JaxTrainConfig(**common), TrainConfig(**common), train_kw


@pytest.mark.parametrize("kind", ["ce", "focal_weighted"])
def test_five_step_trajectory_matches_jax(kind):
    jcfg, cfg, train_kw = _trajectory_case(kind)
    rng = np.random.default_rng(3)
    N, bs, steps = 36, 8, 5
    Xtr = rng.normal(size=(N,) + X_SHAPE).astype(np.float32)
    ytr = rng.integers(0, 2, N).astype(np.int32)
    Xva = rng.normal(size=(10,) + X_SHAPE).astype(np.float32)
    yva = rng.integers(0, 2, 10).astype(np.int32)

    jmodel = JaxCNN4DOF()
    jres = jax_train_cnn(jmodel, Xtr, ytr, Xva, yva, jcfg, fused_epoch=False,
                         **train_kw)

    # what jax_train_cnn drew: its init, its epoch key, the batch order
    # (epoch_prologue) and each batch's dropout key
    root = jax.random.PRNGKey(jcfg.seed)
    k_init, root = jax.random.split(root)
    init = _np_tree(jmodel.init({"params": k_init}, jnp.asarray(Xtr[:2]),
                                train=False))
    _, ke = jax.random.split(root)
    kperm, kbatch = jax.random.split(ke)
    pad = steps * bs - N
    if "sample_weights" in train_kw:
        w = train_kw["sample_weights"]
        p = jnp.asarray(np.asarray(w / w.sum(), np.float32))
        idx = np.asarray(jax.random.choice(kperm, N, (N,), replace=True, p=p))
        idx = np.r_[idx, np.zeros(pad, idx.dtype)]
    else:
        perm = np.asarray(jax.random.permutation(kperm, N))
        idx = np.r_[perm, perm[:pad]]
    idx = idx.reshape(steps, bs)
    bmask = np.r_[np.ones(N), np.zeros(pad)].astype(np.float32).reshape(steps, bs)
    bkeys = jax.random.split(kbatch, steps)

    model = CNN4DOF()
    model.load_state_dict(cnn4dof_state_dict(init))
    opt = make_optimizer(model.parameters(), cfg)
    if kind == "ce":
        loss_fn = cross_entropy_loss
    else:
        alpha = torch.from_numpy(train_kw["class_alpha"])
        loss_fn = lambda out, y: weighted_focal_loss(out, y, alpha, 2.0)
    # each step's mask is drawn on the parameters of that step's start
    t = torch.from_numpy
    conv_out = {}
    for c in ("conv1", "conv2"):
        getattr(model, c).register_forward_hook(
            lambda m, i, o, c=c: conv_out.__setitem__(c, o.detach().double()))
    total, count = 0.0, 0.0
    for b in range(steps):
        model.train()
        v_now = {"params": cnn4dof_to_flax(model)["params"],
                 "batch_stats": cnn4dof_to_flax(model)["batch_stats"]}
        [mask] = _jax_dropout_masks(jmodel, v_now, [Xtr[idx[b]]], [bkeys[b]])
        before = {bn: (getattr(model, bn).running_mean.double(),
                       getattr(model, bn).running_var.double())
                  for bn in ("bn1", "bn2")}
        opt.zero_grad()
        l = batch_loss(model, t(Xtr[idx[b]]), t(ytr[idx[b]]).long(),
                       t(bmask[b]), t(mask), loss_fn)
        l.backward()
        for c, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            conv = getattr(model, c)
            assert conv.bias.grad.abs().max() <= 2e-5 * conv.weight.grad.abs().max()
            o = conv_out[c]
            var, mean = torch.var_mean(o, dim=(0, 2, 3), correction=0)
            (rm, rv), norm = before[bn], getattr(model, bn)
            torch.testing.assert_close(norm.running_mean.double(),
                                       0.9 * rm + 0.1 * mean, rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(norm.running_var.double(),
                                       0.9 * rv + 0.1 * var, rtol=1e-6, atol=1e-7)
        opt.step()
        total += float(l.detach()) * bmask[b].sum()
        count += bmask[b].sum()

    assert jres.history["epoch"] == [1] and jres.best_epoch == 1
    np.testing.assert_allclose(total / count, jres.history["train_loss"][0],
                               rtol=1e-5)
    got = cnn4dof_to_flax(model)
    want = _np_tree(jres.variables)
    moved = 0.0
    for layer, leaves in want["params"].items():
        for name, ref in leaves.items():
            diff = np.abs(got["params"][layer][name] - ref)
            if not (layer.startswith("conv") and name == "bias"):
                # a handful of entries whose data gradient and weight decay
                # cancel to rounding noise: Adam's normalisation parts them
                # by up to lr a step
                assert (diff > 2e-6).sum() <= 4, f"{layer}.{name}"
                assert diff.max() <= steps * cfg.lr, f"{layer}.{name}"
            moved = max(moved, float(np.abs(ref - init["params"][layer][name]).max()))
    for bn, stats in want["batch_stats"].items():
        np.testing.assert_allclose(got["batch_stats"][bn]["var"], stats["var"],
                                   rtol=1e-5, atol=1e-6, err_msg=f"{bn}.var")
    # eval mode, as test-pipeline runs the CNN: the running statistics, and
    # in them the conv biases' noise
    jeval = jmodel.apply(jres.variables, jnp.asarray(Xva), train=False)
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(t(Xva)).numpy(), np.asarray(jeval),
                                   atol=5e-3)
    # the two trained models compute the same function (training mode:
    # batch statistics, in which the conv biases cancel; one dropout mask)
    key = jax.random.PRNGKey(77)
    [mask] = _jax_dropout_masks(jmodel, jres.variables, [Xva], [key])
    jlogits, _ = jmodel.apply(jres.variables, jnp.asarray(Xva), train=True,
                              rngs={"dropout": key}, mutable=["batch_stats"])
    with torch.no_grad():
        logits = model.train()(t(Xva), dropout_mask=t(mask)).numpy()
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-4)
    assert moved > cfg.lr                        # the steps did move them


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_losses_match_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(scale=3.0, size=(64, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 64)
    alpha = np.array([0.25, 0.75], np.float32)
    got = weighted_focal_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                              torch.from_numpy(alpha), 2.0)
    want = jax_focal(jnp.asarray(logits), jnp.asarray(labels, jnp.int32),
                     jnp.asarray(alpha), 2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    ce = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    one = weighted_focal_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                              torch.ones(2), 0.0)
    np.testing.assert_allclose(ce.numpy(), one.numpy(), rtol=1e-6)


def test_weighted_epoch_draws_n_windows_by_weight():
    """N draws with replacement a epoch, in proportion to the weights (each
    window's count over 400 epochs within 5 standard deviations), the pad
    rows window 0."""
    N, bs, epochs = 36, 8, 400
    w = torch.from_numpy(np.linspace(1.0, 8.0, N))
    w = (w / w.sum()).float()
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(N)
    for _ in range(epochs):
        idx = epoch_order(gen, N, bs, w)
        assert idx.shape == (5, bs) and (idx.flatten()[N:] == 0).all()
        counts += np.bincount(idx.flatten()[:N].numpy(), minlength=N)
    expect = epochs * N * w.numpy()
    assert np.all(np.abs(counts - expect) <= 5 * np.sqrt(expect))
    perm = epoch_order(torch.Generator().manual_seed(1), N, bs).flatten()
    assert sorted(perm[:N].tolist()) == list(range(N))
    assert perm[N:].tolist() == perm[:4].tolist()


def _tiny(seed=0, N=44, Nva=20):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N + Nva,) + X_SHAPE).astype(np.float32)
    y = rng.integers(0, 2, N + Nva)
    X[y == 1, ..., 1] += 0.5                     # a signal to learn
    return X[:N], y[:N], X[N:], y[N:]


def _scripted_metric(values):
    calls = iter(values)
    return lambda probs, y: next(calls)


def test_early_stop_and_best_epoch_restore_match_the_jax_rule():
    """A validation metric scripted to peak at epoch 2: patience 3 stops at
    epoch 5 in both packages; the port returns epoch 2's variables (those a
    2-epoch run from the same seed ends with)."""
    Xtr, ytr, Xva, yva = _tiny()
    metric = [0.5, 0.7, 0.6, 0.65, 0.4, 0.9]
    cfg = TrainConfig(epochs=6, batch_size=16, lr=1e-3, seed=2,
                      early_stop_patience=3)
    res = train_cnn(CNN4DOF(), Xtr, ytr, Xva, yva, cfg,
                    val_metric_fn=_scripted_metric(metric), device="cpu")
    jres = jax_train_cnn(JaxCNN4DOF(), Xtr, ytr, Xva, yva,
                         JaxTrainConfig(epochs=6, batch_size=16, lr=1e-3, seed=2,
                                        early_stop_patience=3),
                         val_metric_fn=_scripted_metric(metric), fused_epoch=False)
    assert (res.best_epoch, res.stopped_epoch) == (jres.best_epoch,
                                                   jres.stopped_epoch) == (2, 5)
    assert res.history["epoch"] == jres.history["epoch"] == [1, 2, 3, 4, 5]
    assert res.history["val_metric"] == metric[:5] and res.best_metric == 0.7
    assert res.best_val == res.history["val_loss"][1]

    two = CNN4DOF()
    train_cnn(two, Xtr, ytr, Xva, yva, replace(cfg, epochs=2), device="cpu")
    for k, v in two.state_dict().items():
        assert torch.equal(res.variables[k], v), k


def test_selection_by_validation_loss_and_no_stop_without_patience():
    Xtr, ytr, Xva, yva = _tiny(1)
    cfg = TrainConfig(epochs=4, batch_size=16, lr=1e-3, seed=0)
    res = train_cnn(CNN4DOF(), Xtr, ytr, Xva, yva, cfg, device="cpu")
    best = int(np.argmin(res.history["val_loss"]))
    assert res.best_epoch == best + 1 and res.stopped_epoch == 4
    assert res.best_val == res.history["val_loss"][best]
    assert res.history["val_metric"] == [None] * 4
    assert all(np.isfinite(res.history[k]).all() for k in ("train_loss", "val_loss"))


def test_checkpoint_resume_continues_the_same_trajectory(tmp_path):
    Xtr, ytr, Xva, yva = _tiny(2)
    cfg = TrainConfig(epochs=4, batch_size=16, lr=1e-3, seed=9,
                      early_stop_patience=5)
    kw = dict(loss="focal", class_alpha=np.array([0.4, 0.6]),
              sample_weights=np.linspace(1, 2, len(ytr)), device="cpu")
    straight = CNN4DOF()
    ref = train_cnn(straight, Xtr, ytr, Xva, yva, cfg, **kw)

    first = train_cnn(CNN4DOF(), Xtr, ytr, Xva, yva, replace(cfg, epochs=2),
                      checkpoint_dir=str(tmp_path), checkpoint_every=2, **kw)
    assert first.history["epoch"] == [1, 2]
    resumed_model = CNN4DOF()
    resumed = train_cnn(resumed_model, Xtr, ytr, Xva, yva, cfg,
                        checkpoint_dir=str(tmp_path), checkpoint_every=2, **kw)
    assert resumed.history == ref.history
    assert (resumed.best_epoch, resumed.best_val) == (ref.best_epoch, ref.best_val)
    for k, v in straight.state_dict().items():
        assert torch.equal(resumed_model.state_dict()[k], v), k
        assert torch.equal(resumed.variables[k], ref.variables[k]), k
    with pytest.raises(ValueError, match="init_params-presence"):
        train_cnn(CNN4DOF(), Xtr, ytr, Xva, yva, cfg,
                  init_params=straight.state_dict(),
                  checkpoint_dir=str(tmp_path), checkpoint_every=2, **kw)


def test_init_parameters_draw_as_flax_does():
    """Xavier-uniform kernels (bound sqrt(6 / (fan_in + fan_out)), in HWIO
    and OIHW alike), zero biases, BatchNorm at (1, 0, 0, 1); reproducible
    from the generator's seed."""
    a, b = CNN4DOF(), CNN4DOF()
    a.init_parameters(torch.Generator().manual_seed(4))
    b.init_parameters(torch.Generator().manual_seed(4))
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    tree = cnn4dof_to_flax(a)
    for layer, (fan_in, fan_out) in {"conv1": (18, 144), "conv2": (144, 288),
                                     "fc1": (2400, 128), "fc2": (128, 2)}.items():
        k = tree["params"][layer]["kernel"]
        bound = np.sqrt(6.0 / (fan_in + fan_out))
        assert np.abs(k).max() <= bound and np.abs(k).max() > 0.9 * bound
        assert not tree["params"][layer]["bias"].any()
    for bn in ("bn1", "bn2"):
        assert (tree["params"][bn]["scale"] == 1).all()
        assert not tree["params"][bn]["bias"].any()
        assert not tree["batch_stats"][bn]["mean"].any()
        assert (tree["batch_stats"][bn]["var"] == 1).all()


@pytest.mark.parametrize("root", ["4dof", "4dof_mingru", "4dof_attention",
                                  "4dof_legacy", "4dof_legacy_attention"])
def test_cnn4dof_to_flax_inverts_cnn4dof_from_flax(root):
    tree = load_checkpoint(ROOT / "data" / root / "models" / "cnn.msgpack")
    back = cnn4dof_to_flax(cnn4dof_from_flax(tree))

    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert b[k].dtype == np.float32 and b[k].flags["C_CONTIGUOUS"]
                assert b[k].shape == a[k].shape and np.array_equal(a[k], b[k]), k

    same(tree, back)


def test_predict_probs_matches_flax_on_the_committed_cnn():
    path = ROOT / "data/4dof/models/cnn.msgpack"
    jmodel = JaxCNN4DOF()
    template = jmodel.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((2,) + X_SHAPE))
    jvars = load_params(template, path)
    x = np.random.default_rng(5).normal(size=(50,) + X_SHAPE).astype(np.float32)
    want = np.asarray(jax.nn.softmax(jmodel.apply(jvars, jnp.asarray(x)), axis=-1))
    got = predict_probs(cnn4dof_from_flax(load_checkpoint(path)), x,
                        batch_size=16, device="cpu")
    assert got.shape == (50, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert predict_probs(CNN4DOF(), x[:0], device="cpu").shape == (0, 2)


# --- the train-cnn command -----------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train-cnn for 2 epochs on a copy of data/4dof cut to one sensor and
    one structural run and 60 windows of each of their splits."""
    root = tmp_path_factory.mktemp("cnn_root")
    for sub in ("processed", "models"):
        src = ROOT / "data/4dof" / sub
        (root / sub).mkdir()
        for f in src.iterdir():
            (root / sub / f.name).write_bytes(f.read_bytes())
    splits = json.loads((root / "processed/run_splits.json").read_text())
    for g in ("sensor_fault", "structural_fault"):
        splits[g]["files"] = splits[g]["files"][:1]
        wi = splits[g]["window_indices"][splits[g]["files"][0]]
        for split in ("train", "val"):
            wi[split] = wi[split][:60]
    (root / "processed/run_splits.json").write_text(json.dumps(splits))
    paths = cli.Paths(str(root))
    cfg = replace(Stage4DofConfig(), cnn_train=replace(
        Stage4DofConfig().cnn_train, batch_size=50))
    res = cli.cmd_train_cnn(paths, cfg, epochs=2, seed=3, plot=False,
                            device="cpu")
    return paths, cfg, res


def test_train_cnn_writes_the_jax_clis_meta(trained):
    paths, cfg, res = trained
    meta = json.loads((paths.processed / "stage2_cnn_train_meta.json").read_text())
    committed = json.loads(
        (ROOT / "data/4dof/processed/stage2_cnn_train_meta.json").read_text())
    assert meta.keys() == committed.keys()
    assert (meta["seed"], meta["epochs"], meta["batch_size"]) == (3, 2, 50)
    assert (meta["lr"], meta["weight_decay"], meta["early_stop_patience"]) == (
        1e-4, 5e-5, 15)
    assert meta["best_epoch"] == res.best_epoch and meta["best_val_ce"] == res.best_val
    assert meta["labels"] == committed["labels"]
    assert res.history["epoch"] == [1, 2]
    assert all(np.isfinite(res.history[k]).all() for k in ("train_loss", "val_loss"))


def test_train_cnn_inputs_are_z_and_the_squared_residual(trained):
    paths, cfg, _ = trained
    splits = json.loads(paths.run_splits.read_text())
    W = cli.build_split_windows(splits["sensor_fault"], "train", cfg)
    assert W.shape == (60, 100, 12)
    mean, std = (torch.from_numpy(a) for a in cli._load_stats(paths))
    Z = (torch.from_numpy(W) - mean) / std
    X = cli._cnn_inputs(cli._load_vae(paths, cfg), Z)
    with torch.no_grad():
        recon, _, _ = cli._load_vae(paths, cfg)(Z)
    assert X.shape == (60, 100, 12, 2)
    assert torch.equal(X[..., 0], Z) and torch.equal(X[..., 1], (Z - recon) ** 2)


def test_train_cnn_checkpoint_is_restored_by_the_jax_package(trained):
    paths, _, res = trained
    cnn = cli._load_cnn(paths, Stage4DofConfig())      # the port's own reader
    for k, v in cnn.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(v, res.variables[k]), k

    jmodel = JaxCNN4DOF()
    template = jmodel.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((2,) + X_SHAPE))
    jvars = load_params(template, paths.models / "cnn.msgpack")
    x = np.random.default_rng(6).normal(size=(24,) + X_SHAPE).astype(np.float32)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = cnn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
