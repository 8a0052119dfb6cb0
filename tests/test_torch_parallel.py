"""The port's data-parallel scoring (``shm_tpu_torch/parallel/mesh.py``)
against the JAX package's, on the CPU.

The JAX tests run their meshes over 8 virtual CPU devices
(``tests/conftest.py``); the port's counterpart is ``make_mesh(8,
device="cpu")``, 8 shards on the CPU. ``make_dp_hybrid_shardmap`` runs each
VAE family's fused gate once a shard (the plain version on a CPU tensor)
against the JAX ``make_dp_hybrid_shardmap`` with its Pallas kernels in
interpret mode, as ``tests/test_parallel.py`` runs them, on the same
weights carried over by ``shm_tpu_torch/convert.py``: mse within atol 2e-5
(the JAX test's bound), predictions equal. The mesh scorers
(``HybridScorer``, ``OpenLabScorer``) against the port without a mesh:
the same per-window arithmetic on each shard, so mse within 1e-6 and the
decisions equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu.parallel import make_dp_hybrid_shardmap as jax_dp_hybrid
from shm_tpu.parallel import make_mesh as jax_make_mesh
from shm_tpu_torch import ops
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import cnn4dof_from_flax, vae_from_flax
from shm_tpu_torch.parallel import (
    Mesh, make_dp_hybrid_shardmap, make_mesh, make_mesh_opt, replicate,
    shard_batch,
)
from shm_tpu_torch.parallel.mesh import shard_slices
from torch_serve_models import KEYS, T, port_scorer, windows

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MESH_MSE_ATOL = 1e-6
CELLS = {  # cell: (hidden_dim, num_layers), widths the JAX kernels take
    "lstm": (16, 2),
    "min_gru": (16, 2),
    "attention": (32, 1),
}


def _models(cell):
    H, L = CELLS[cell]
    jcfg = JaxVAEConfig(12, 4, H, L, 0.0, use_layernorm=True, cell=cell)
    vae, cnn = jax_vae_from_config(jcfg), JaxCNN4DOF()
    key = jax.random.PRNGKey(0)
    W = np.array(jax.random.normal(key, (64, 100, 12)))
    vp = vae.init({"params": key}, jnp.asarray(W[:2]))["params"]
    cv = cnn.init({"params": key}, jnp.zeros((2, 100, 12, 2)))
    pcfg = VAEConfig(input_dim=12, latent_dim=4, hidden_dim=H, num_layers=L,
                     dropout=0.0, use_layernorm=True, cell=cell)
    return (vae, cnn, vp, cv), (vae_from_flax(vp, pcfg),
                                cnn4dof_from_flax(cv, 2, 100, 12)), W


@pytest.mark.parametrize("cell", list(CELLS))
def test_shardmap_hybrid_matches_jax(cell, monkeypatch):
    (vae, cnn, vp, cv), (pvae, pcnn), W = _models(cell)
    mean, std, thr = np.zeros(12, np.float32), np.ones(12, np.float32), 0.5
    ref = jax_dp_hybrid(vae, cnn, jax_make_mesh(8), use_fused_vae=True,
                        fused_dtype=jnp.float32, fused_interpret=True)(
        vp, cv, jnp.asarray(W), jnp.asarray(mean), jnp.asarray(std),
        jnp.float32(thr))

    calls = []
    weights_fn, gate, plain = ops.FUSED_GATES[cell]

    def counted(weights, Z, **kw):
        calls.append(Z.shape[0])
        return gate(weights, Z, **kw)

    monkeypatch.setitem(ops.FUSED_GATES, cell, (weights_fn, counted, plain))
    mesh = make_mesh(8, device="cpu")
    fn = make_dp_hybrid_shardmap(pvae, pcnn, mesh, use_fused_vae=True)
    tt = torch.from_numpy
    got = fn(tt(W), tt(mean), tt(std), torch.tensor(thr))
    assert calls == [8] * 8                  # the gate once a shard
    np.testing.assert_allclose(got.mse.numpy(), np.asarray(ref.mse), atol=2e-5)
    np.testing.assert_array_equal(got.y_pred.numpy(), np.asarray(ref.y_pred))

    # against the port on one device: the same arithmetic window by window
    from shm_tpu_torch.pipeline import make_hybrid_fn

    one = make_hybrid_fn(pvae, pcnn, use_fused_vae=True)(
        tt(W), tt(mean), tt(std), torch.tensor(thr))
    np.testing.assert_allclose(got.mse.numpy(), one.mse.numpy(),
                               atol=MESH_MSE_ATOL)
    np.testing.assert_array_equal(got.y_pred.numpy(), one.y_pred.numpy())
    np.testing.assert_array_equal(got.anomalous.numpy(), one.anomalous.numpy())


def test_make_mesh_rejects_overrequest(monkeypatch):
    """More devices than exist raise, on the card as in JAX; the CPU mesh
    has as many shards as asked."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="available") as ei:
        make_mesh(2, device="cuda")
    assert "only 1 cuda device" in str(ei.value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh(device="cuda")
    assert mesh.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.size == 2 and mesh.axis == "data"
    with pytest.raises(ValueError, match="available"):
        make_mesh(3, device="cuda")
    with pytest.raises(ValueError, match="at least one"):
        make_mesh(0, device="cpu")
    assert make_mesh(device="cpu").size == 1
    assert make_mesh(3, device="cpu").devices == (torch.device("cpu"),) * 3


def test_make_mesh_opt():
    assert make_mesh_opt(None) is None and make_mesh_opt(1) is None
    assert make_mesh_opt(0) is None
    assert make_mesh_opt(4, device="cpu").size == 4


def test_replicate_and_shard_batch():
    mesh = Mesh((torch.device("cpu"),) * 3)
    lin = torch.nn.Linear(2, 2)
    reps = replicate(lin, mesh)
    assert len(reps) == 3 and all(r is not lin for r in reps)
    with torch.no_grad():
        reps[0].weight.add_(1.0)
    assert torch.equal(reps[1].weight, lin.weight)      # independent copies
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3]}
    rt = replicate(tree, mesh)
    assert rt[2]["b"][1] == 3 and torch.equal(rt[1]["a"], tree["a"])
    assert rt[1]["a"].data_ptr() != tree["a"].data_ptr()
    x = torch.arange(10)
    parts = shard_batch(x, mesh)
    assert [p.tolist() for p in parts] == [[0, 1, 2, 3], [4, 5, 6], [7, 8, 9]]
    assert [sl.stop - sl.start for sl in shard_slices(9, 3)] == [3, 3, 3]
    assert len(shard_batch(np.zeros((5, 2), np.float32), mesh)) == 3


def _same(got, ref, atol=MESH_MSE_ATOL):
    for k in ("anomalous", "y_pred"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["mse"], ref["mse"], atol=atol)
    np.testing.assert_allclose(got["p_struct"], ref["p_struct"], atol=atol)


def test_hybrid_scorer_mesh_matches_single():
    """Requests over several buckets (16 and 32, over 8 shards) and a
    series under the mesh give the single scorer's outputs."""
    mesh = make_mesh(8, device="cpu")
    single = port_scorer(threshold=0.9)
    sharded = port_scorer(threshold=0.9, mesh=mesh)
    assert sharded.mesh is mesh and sharded.device == torch.device("cpu")
    for n in (5, 16, 50):
        W = windows(n, seed=n)
        _same(sharded.score(W), single.score(W))
    x = np.random.default_rng(1).normal(size=(T + 40, 4)).astype(np.float32)
    for stride in (1, 3):
        _same(sharded.score_series(x, stride), single.score_series(x, stride))
    sharded.warmup()
    with pytest.raises(ValueError, match="no series path"):
        sharded.warmup_series()
    sharded.set_threshold(0.1)
    single.set_threshold(0.1)
    _same(sharded.score(windows(20)), single.score(windows(20)))


def test_mesh_buckets_must_be_multiples():
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="multiples of the mesh size"):
        port_scorer(mesh=mesh, min_bucket=12, max_batch=48)
    with pytest.raises(ValueError, match="multiples of the mesh size"):
        port_scorer(mesh=mesh, min_bucket=16, max_batch=36)
    with pytest.raises(ValueError, match="one process"):
        port_scorer(mesh=Mesh((torch.device("cpu"),) * 2, num_processes=2))
    from shm_tpu_torch.serve import mesh_scorer_device

    with pytest.raises(ValueError, match="mesh's device type"):
        mesh_scorer_device(mesh, "cuda", 16, 32)
    assert mesh_scorer_device(mesh, "cpu", 16, 32) == torch.device("cpu")


def test_export_and_shadow_read_a_mesh_scorer():
    """``export`` refuses a mesh scorer; a shadow engine over one warms its
    buckets and skips the series warmup a mesh scorer does not have."""
    from shm_tpu_torch.export import _program
    from shm_tpu_torch.serve_shadow import ShadowEngine

    sc = port_scorer(mesh=make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="mesh"):
        _program(sc)
    eng = ShadowEngine(sc, series_strides=(1,))
    try:
        eng.warm()
        assert eng.warm_error is None
    finally:
        eng.close()


@pytest.fixture(scope="module")
def openlab_windows():
    Xc = np.load(ROOT / "data/openlab/extracted/X_clean.npy", mmap_mode="r")
    Xr = np.load(ROOT / "data/openlab/extracted/X_raw.npy", mmap_mode="r")
    idx = np.linspace(0, Xc.shape[0] - 1, 40).astype(int)
    return np.ascontiguousarray(Xc[idx]), np.ascontiguousarray(Xr[idx])


def test_openlab_scorer_mesh_matches_single(openlab_windows):
    from shm_tpu_torch.serve_openlab import OpenLabScorer

    Xc, Xr = openlab_windows
    kw = dict(device="cpu", min_bucket=16, max_batch=32)
    single = OpenLabScorer.from_artifacts(ROOT / "data/openlab", **kw)
    sharded = OpenLabScorer.from_artifacts(ROOT / "data/openlab",
                                           mesh=make_mesh(4, device="cpu"), **kw)
    _same(sharded.score_pair(Xc, Xr), single.score_pair(Xc, Xr))
    sharded.set_threshold(0.5 * single.threshold)
    single.set_threshold(0.5 * single.threshold)
    got = sharded.score_pair(Xc, Xr)
    _same(got, single.score_pair(Xc, Xr))
    assert got["anomalous"].any()
    with pytest.raises(ValueError, match="multiples of the mesh size"):
        OpenLabScorer.from_artifacts(ROOT / "data/openlab", device="cpu",
                                     min_bucket=6, max_batch=32,
                                     mesh=make_mesh(4, device="cpu"))


@pytest.mark.parametrize("module", ["parallel", "parallel.distributed"])
def test_api_names_match_the_jax_package(module):
    import importlib

    jax_mod = importlib.import_module(f"shm_tpu.{module}")
    port_mod = importlib.import_module(f"shm_tpu_torch.{module}")
    assert set(jax_mod.__all__) <= set(port_mod.__all__)
    for name in jax_mod.__all__:
        assert callable(getattr(port_mod, name)), name
