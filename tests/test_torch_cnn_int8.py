"""The port's int8 attribution CNN (``shm_tpu_torch/models/cnn_int8.py``)
against the JAX package's (``shm_tpu/models/cnn_int8.py``).

Weights are the JAX module's variables (made as ``tests/test_cnn_int8.py``
makes them, with BatchNorm statistics moved away from their start so the
folding does something) handed to both sides; the port's ``CNN4DOF``
carries them through ``convert.cnn4dof_from_flax``. The folding must agree
within float32 rounding (the two sides' rsqrt may differ in the last bit),
the int8 codes and scales exactly, the int32 sums exactly those of numpy in
int64, the logits closely (an activation code may round the other way
after a float32 difference); extreme inputs must stay finite; on committed
``data/4dof`` windows through the committed CNN the int8 network must agree
with the folded float one on at least 99.9% of the 3-class predictions,
the JAX package's bar.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.models import CNN4DOF as JaxCNN4DOF
from shm_tpu.models import cnn_int8 as jax_int8
from shm_tpu_torch.convert import cnn4dof_from_flax, cnn4dof_to_flax
from shm_tpu_torch.models import cnn_int8

ROOT = Path(__file__).resolve().parents[1]
T, D = 20, 8
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def variables_and_data():
    model = JaxCNN4DOF(dropout=0.0)
    rng = np.random.default_rng(0)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((2, T, D, 2)))
    bs = jax.tree.map(np.asarray, variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    for bn in ("bn1", "bn2"):
        bs[bn]["mean"] = rng.normal(0, 0.5, bs[bn]["mean"].shape).astype("f")
        bs[bn]["var"] = rng.uniform(0.5, 2.0, bs[bn]["var"].shape).astype("f")
        params[bn]["scale"] = rng.uniform(
            0.5, 1.5, params[bn]["scale"].shape).astype("f")
        params[bn]["bias"] = rng.normal(
            0, 0.3, params[bn]["bias"].shape).astype("f")
    params["fc2"]["kernel"] = params["fc2"]["kernel"] * 20.0
    variables = {"params": params, "batch_stats": bs}
    Z = rng.normal(size=(256, T, D)).astype(np.float32)
    resid = (rng.normal(size=(256, T, D)).astype(np.float32) ** 2
             * rng.lognormal(0, 1.5, (256, 1, 1)).astype(np.float32))
    return model, variables, np.stack([Z, resid], axis=-1)


def _jax_vars(variables):
    return jax.tree.map(jnp.asarray, variables)


def test_folding_matches_jax_within_float32_rounding(variables_and_data):
    _, variables, X = variables_and_data
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
        p, bs = variables["params"], variables["batch_stats"]
        kj, bj = jax_int8._fold_bn(jnp.asarray(p[conv]["kernel"]),
                                   jnp.asarray(p[conv]["bias"]),
                                   _jax_vars(p[bn]), _jax_vars(bs[bn]))
        kp, bp = cnn_int8._fold_bn(p[conv]["kernel"], p[conv]["bias"],
                                   p[bn], bs[bn])
        np.testing.assert_allclose(kp.numpy(), np.asarray(kj), rtol=2 ** -22)
        np.testing.assert_allclose(bp.numpy(), np.asarray(bj), rtol=2 ** -22,
                                   atol=1e-7)
    got = cnn_int8.cnn4dof_folded_apply(variables, torch.from_numpy(X))
    want = jax_int8.cnn4dof_folded_apply(_jax_vars(variables), jnp.asarray(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("source", ["flax", "port_module"])
def test_codes_and_scales_equal_jax(variables_and_data, source):
    """The same codes and scales from the flax variables and from the
    port's CNN4DOF carrying them (through ``cnn4dof_to_flax``)."""
    _, variables, _ = variables_and_data
    qj = jax_int8.quantize_cnn4dof(_jax_vars(variables), dtype=jnp.float32)
    src = (variables if source == "flax" else
           cnn4dof_from_flax(variables, 2, T, D))
    qp = cnn_int8.quantize_cnn4dof(src, dtype=torch.float32, seq_len=T,
                                   num_features=D)
    for name in ("w2", "wf1", "wf2"):
        got, want = getattr(qp, name), np.asarray(getattr(qj, name))
        assert got.dtype == torch.int8 and want.dtype == np.int8
        np.testing.assert_array_equal(got.numpy(), want)
    for name in ("s2", "sf1", "sf2", "b1", "b2", "bf1", "bf2", "k1"):
        np.testing.assert_allclose(getattr(qp, name).numpy(),
                                   np.asarray(getattr(qj, name)),
                                   rtol=2 ** -22, atol=1e-7)
    assert qp.k1.shape == (18, 16) and qp.w2.shape == (144, 32)
    assert qp.wf1.shape == (8 * (T // 4) * (D // 4) * 4, 128)


def test_int32_sums_are_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(-127, 128, (5, 7, 2400)).astype(np.int8)
    w = rng.integers(-127, 128, (2400, 10)).astype(np.int8)
    a[0, 0] = 127
    w[:, 0] = 127                                   # the largest sum there is
    got = cnn_int8._mm_i8(torch.from_numpy(a), torch.from_numpy(w))
    want = a.astype(np.int64) @ w.astype(np.int64)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert int(got[0, 0, 0]) == 127 * 127 * 2400


def test_rounding_is_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, a = cnn_int8._q_sample(x)
    qj, aj = jax_int8._q_sample(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    assert float(a[0]) == float(aj[0]) == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_logits_match_jax(variables_and_data, dtype):
    _, variables, X = variables_and_data
    qj = jax_int8.quantize_cnn4dof(_jax_vars(variables),
                                   dtype=getattr(jnp, dtype))
    qp = cnn_int8.quantize_cnn4dof(variables, dtype=getattr(torch, dtype))
    got = cnn_int8.cnn4dof_int8_apply(qp, torch.from_numpy(X)).numpy()
    want = np.asarray(jax_int8.cnn4dof_int8_apply(qj, jnp.asarray(X)))
    assert got.dtype == np.float32 and got.shape == (len(X), 2)
    spread = want.std()
    err = np.abs(got - want)
    # most windows agree to float32 rounding; a window where one activation
    # code rounds the other way moves by about one code's worth
    assert np.median(err) < 1e-5 * spread + 1e-6
    assert err.max() < 0.05 * spread
    assert (got.argmax(1) == want.argmax(1)).mean() >= 0.99


def test_int8_saturates_without_blowup(variables_and_data):
    _, variables, X = variables_and_data
    q = cnn_int8.quantize_cnn4dof(variables, dtype=torch.float32)
    Xe = X.copy()
    Xe[:8, :, :, 1] *= 1e6
    Xe[8:16] = 0.0
    out = cnn_int8.cnn4dof_int8_apply(q, torch.from_numpy(Xe))
    assert torch.isfinite(out).all()
    want = np.asarray(jax_int8.cnn4dof_int8_apply(
        jax_int8.quantize_cnn4dof(_jax_vars(variables), dtype=jnp.float32),
        jnp.asarray(Xe)))
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(out.numpy().argmax(1)[:16],
                                  want.argmax(1)[:16])


def test_committed_cnn_agrees_with_its_folded_network():
    """The committed ``data/4dof`` CNN on 600 committed test windows (with
    the float32 gate's residuals): the int8 network's 3-class predictions
    agree with the folded float network's on at least 99.9% of them, the
    JAX package's bar, and its logits with the JAX int8 network's."""
    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.tools.workload import load_trained_workload

    wl = load_trained_workload(ROOT / "data" / "4dof")
    idx = np.linspace(0, len(wl.W) - 1, 600).astype(int)
    Z = normalize_windows(torch.from_numpy(wl.W[idx]), torch.as_tensor(wl.mean),
                          torch.as_tensor(wl.std))
    with torch.no_grad():
        recon, _, _ = wl.vae(Z)
    mse = ((Z - recon) ** 2).mean(dim=(1, 2))
    xin = torch.stack([Z, (Z - recon) ** 2], dim=-1)
    q = cnn_int8.quantize_cnn4dof(wl.cnn, dtype=torch.bfloat16)
    got = cnn_int8.cnn4dof_int8_apply(q, xin)
    ref = cnn_int8.cnn4dof_folded_apply(wl.cnn, xin)
    with torch.no_grad():
        np.testing.assert_allclose(ref.numpy(), wl.cnn(xin).numpy(),
                                   rtol=1e-4, atol=1e-4)
    anom = (mse > wl.threshold).numpy()
    y3 = lambda logits: np.where(anom, logits.argmax(1) + 1, 0)
    agree = (y3(got.numpy()) == y3(ref.numpy())).mean()
    assert agree >= 0.999, agree
    assert (y3(ref.numpy()) == wl.y[idx]).mean() > 0.95
    qj = jax_int8.quantize_cnn4dof(
        _jax_vars(cnn4dof_to_flax(wl.cnn)), dtype=jnp.bfloat16)
    want = np.asarray(jax_int8.cnn4dof_int8_apply(qj, jnp.asarray(xin.numpy())))
    assert (got.numpy().argmax(1) == want.argmax(1)).mean() >= 0.999
