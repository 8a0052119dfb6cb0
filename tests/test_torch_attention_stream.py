"""The attention gate's two softmax forms (``stream=``) in the port's plain
version on the CPU, against the JAX kernel.

The JAX side is ``shm_tpu/ops/fused_attention.py::fused_attention_gate`` in
interpret mode, as ``tests/test_fused_attention.py`` runs it. Inputs come
from a numpy seed, JAX weights go through ``convert.py``. Bars:

- float32: mse atol 2e-6 and residual atol 1e-5 against the JAX kernel's
  streaming form, and the port's two forms within rtol 1e-6, atol 1e-7 of
  each other, as ``tests/test_fused_attention.py:115-130`` holds the JAX
  kernel's own two forms;
- bf16 (``dtype=bf16``, float32 and bf16 io) on 48 of the committed openLAB
  attention root's test windows: every gate decision equal to the JAX
  streaming form's (``emulate=True``), and the port's streaming form closer
  to it in mean relative mse than the port's packed form is (the two forms
  round the probabilities at other points, so the wrong form shows in the
  mean).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.ops import fused_attention_gate as jax_gate
from shm_tpu.ops.fused_attention import auto_stream as jax_auto_stream
from shm_tpu.ops.fused_vae import _round_up
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import (
    attention_params_to_kernel_weights, fused_attention_gate,
    fused_attention_gate_reference,
)
from shm_tpu_torch.ops import fused_attention as fa
from test_torch_openlab_gate_tf32 import OL_ATTENTION, windows

MSE_ATOL, RESID_ATOL = 2e-6, 1e-5
FORMS_RTOL, FORMS_ATOL = 1e-6, 1e-7
torch.set_num_threads(1)

CASES = {  # name: (N, T, D, Z, H, L, layernorm), each past 128 keys
    # JAX's own multi-block case (tests/test_fused_attention.py:115-135)
    "openlab_T200_H64_L1": (6, 200, 3, 8, 64, 1, True),
    # the 4DOF widths past the resident body's longest window at H=128
    "T150_H128_L2": (3, 150, 12, 16, 128, 2, True),
}


def _case(name):
    N, T, D, Zd, H, L, ln = CASES[name]
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell="attention")
    rng = np.random.default_rng(sum(map(ord, name)))
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(N, T, D)).astype(np.float32)
    w = attention_params_to_kernel_weights(vae_from_flax(params, cfg))
    return params, w, Z, dict(num_layers=L, use_layernorm=ln)


@pytest.mark.parametrize("name", list(CASES))
def test_streaming_form_matches_jax(name):
    params, w, Z, kw = _case(name)
    mse_j, resid_j = jax_gate(params, jnp.asarray(Z), dtype=jnp.float32,
                              interpret=True, batch_tile=3, stream=True, **kw)
    before = fused_attention_gate.launches
    mse, resid = fused_attention_gate(w, torch.from_numpy(Z), stream=True, **kw)
    assert fused_attention_gate.launches == before     # the CPU never launches
    assert mse.shape == (Z.shape[0],) and resid.shape == Z.shape
    np.testing.assert_allclose(mse.numpy(), np.asarray(mse_j), atol=MSE_ATOL)
    np.testing.assert_allclose(resid.numpy(), np.asarray(resid_j),
                               atol=RESID_ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_the_two_forms_agree_in_float32(name):
    _, w, Z, kw = _case(name)
    Zt = torch.from_numpy(Z)
    mse_s, resid_s = fused_attention_gate_reference(w, Zt, stream=True, **kw)
    mse_p, resid_p = fused_attention_gate_reference(w, Zt, stream=False, **kw)
    torch.testing.assert_close(mse_s, mse_p, rtol=FORMS_RTOL, atol=FORMS_ATOL)
    torch.testing.assert_close(resid_s, resid_p, rtol=1e-5, atol=RESID_ATOL)


@pytest.mark.parametrize("T", [100, 128, 129, 200])
def test_stream_none_selects_as_jax_auto_stream(T):
    """``stream=None`` takes the form JAX's ``auto_stream`` takes for the
    padded window: streaming from 129 steps on."""
    assert fa.auto_stream(T) == jax_auto_stream(_round_up(T, 128))
    assert fa.softmax_form(None, T) == jax_auto_stream(_round_up(T, 128))
    _, w, _, kw = _case("openlab_T200_H64_L1")
    Z = torch.from_numpy(np.random.default_rng(T).normal(
        size=(2, T, 3)).astype(np.float32))
    auto = fused_attention_gate(w, Z, **kw)
    chosen = fused_attention_gate(w, Z, stream=fa.auto_stream(T), **kw)
    assert all(torch.equal(a, b) for a, b in zip(auto, chosen))


@pytest.mark.parametrize("stream, form", [(True, True), (False, False),
                                          (None, True)])
def test_stream_is_passed_to_the_plain_version(monkeypatch, stream, form):
    """The wrapper hands ``stream`` on to the plain version, which runs the
    form asked for in every block (T=200: ``None`` means streaming)."""
    seen = []
    real = fa.attend

    def spy(q, k, v, streaming, rnd):
        seen.append(streaming)
        return real(q, k, v, streaming, rnd)

    monkeypatch.setattr(fa, "attend", spy)
    _, w, Z, kw = _case("openlab_T200_H64_L1")
    fused_attention_gate(w, torch.from_numpy(Z[:2]), stream=stream, **kw)
    assert seen == [form] * 2          # one encoder and one decoder block


@pytest.mark.parametrize("bad", ["auto", 1, 0.0])
def test_an_unknown_stream_value_raises(bad):
    _, w, Z, kw = _case("openlab_T200_H64_L1")
    Zt = torch.from_numpy(Z[:2])
    with pytest.raises(ValueError, match="stream must be None, True or False"):
        fused_attention_gate(w, Zt, stream=bad, **kw)
    # the CUDA path checks it before anything reaches the card
    with pytest.raises(ValueError, match="stream must be None, True or False"):
        fa._launch(w, Zt, kw["num_layers"], kw["use_layernorm"], True,
                   torch.float32, None, bad)


def test_the_streaming_form_walks_keys_in_blocks_of_128():
    """The key blocks' edges set where the running max rescales: at T=200
    the plain streaming form is the online softmax over keys [0, 128) and
    [128, 200), and one block of all 200 keys is the packed form but for
    the place of the division."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 200, 32, generator=g) * 3 for _ in range(3))
    ident = lambda t: t
    got = fa.attend(q, k, v, True, ident)
    s = [q @ k[..., a:b, :].transpose(-1, -2) for a, b in ((0, 128), (128, 200))]
    m0 = s[0].amax(-1, keepdim=True)
    m1 = torch.maximum(m0, s[1].amax(-1, keepdim=True))
    p0, p1 = torch.exp(s[0] - m0), torch.exp(s[1] - m1)
    a1 = torch.exp(m0 - m1)
    l = p0.sum(-1, keepdim=True) * a1 + p1.sum(-1, keepdim=True)
    o = (p0 @ v[..., :128, :]) * a1 + p1 @ v[..., 128:, :]
    torch.testing.assert_close(got, o / l, rtol=0, atol=0)
    packed = fa.attend(q, k, v, False, ident)
    torch.testing.assert_close(got, packed, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def openlab_bf16():
    """48 test windows of data/openlab_attention spread over the 2,042, the
    committed threshold, and for each io: the JAX streaming form's bf16 mse
    and the port's streaming and packed forms'."""
    from shm_tpu_torch.convert import vae_to_flax

    vae, Z, thr = windows("test", 48, OL_ATTENTION)
    params = vae_to_flax(vae)
    w = attention_params_to_kernel_weights(vae, torch.bfloat16)
    kw = dict(num_layers=1, use_layernorm=True, with_residual=False)
    out = {}
    for io in (None, torch.bfloat16):
        jio = jnp.bfloat16 if io is not None else jnp.float32
        mse_j, _ = jax_gate(params, jnp.asarray(Z.numpy()), dtype=jnp.bfloat16,
                            io_dtype=jio, emulate=True, interpret=True,
                            batch_tile=8, stream=True, **kw)
        port = {form: fused_attention_gate(w, Z, dtype=torch.bfloat16,
                                           io_dtype=io, stream=s, **kw)[0]
                for form, s in (("stream", None), ("packed", False))}
        out[io] = (np.asarray(mse_j, np.float64), port)
    return out, float(thr)


def _mean_rel(a, b):
    return float(np.mean(np.abs(a.numpy().astype(np.float64) - b) / np.abs(b)))


@pytest.mark.parametrize("io", [None, torch.bfloat16], ids=["f32_io", "bf16_io"])
def test_bf16_streaming_form_lands_on_jax(openlab_bf16, io):
    out, thr = openlab_bf16
    mse_j, port = out[io]
    assert 0 < int((mse_j > thr).sum()) < len(mse_j)    # both sides of the gate
    np.testing.assert_array_equal(port["stream"].numpy() > thr, mse_j > thr)
    near, far = _mean_rel(port["stream"], mse_j), _mean_rel(port["packed"], mse_j)
    assert near < far, (near, far)
