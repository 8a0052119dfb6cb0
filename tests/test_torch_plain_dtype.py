"""The plain modules' ``dtype`` (flax's compute precision; parameters stay
float32) against the JAX package's modules at ``dtype=bf16``, on the CPU.

bf16 is not held bit for bit to JAX: the two round where they each write a
bf16 operation, and over a recurrence a rounding that lands on the other
side compounds. The rule separates a bf16 computation from a float32 one:
the port's bf16 output sits nearer JAX's bf16 output than JAX's float32
output does (mean |difference| of the reconstructions, or of the logits),
and within twice the reading of ``tests/plain_dtype_readings.py port``
(JAX jitted with XLA's excess precision off, as there; torch at one
thread), on every 227th of the
3,636 committed 4DOF test windows (16) through each committed root, and on
8 of the openLAB test split's fault windows for ``CNNOpenLab``:

========== ============================ ====================================
family     port bf16 - JAX bf16          JAX float32 - JAX bf16
           (max / mean abs)              (max / mean abs)
========== ============================ ====================================
lstm       0 / 0 (bit for bit)           1.0179e-02 / 1.3505e-03
min_gru    0 / 0 (bit for bit)           3.5225e-02 / 2.3790e-03
attention  7.8125e-03 / 1.0237e-03       1.1139e-02 / 1.6095e-03
cnn logits 4.8828e-04 / 3.0518e-05       1.0032e-02 / 4.1718e-03
========== ============================ ====================================

A zero reading makes the bar bit for bit. At 32 windows the LSTM's reading
was 3.9062e-03 / 1.2299e-05 (two windows' recurrences round apart at some
step) and the attention stack's 8.5449e-03 / 9.1270e-04 (JAX op by op).

Besides: the gate decisions (``reconstruction_mse(fused=False) >
threshold``) and the CNN's labels at its threshold equal JAX bf16's;
``vae_from_config(dtype=)``; ``make_hybrid_fn(use_fused_vae=True,
fused_dtype=None)`` on a bf16 VAE gives the bits of ``fused_dtype=bf16``;
one plain-path training step of a bf16 ``TemporalVAE`` at a tiny shape
against JAX's loss (nearer JAX bf16 than JAX float32 is); float16 raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import plain_dtype_readings as R
from shm_tpu.models.vae import TemporalVAE as JaxVAE
from shm_tpu.models.vae import vae_from_config as jax_vae_from_config
from shm_tpu.models.vae import vae_loss as jax_vae_loss
from shm_tpu_torch.config import TrainConfig, VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.models import (
    CNN4DOF, AttentionStack, CNNOpenLab, LSTMLayer, LSTMStack, MinGRULayer,
    MinGRUStack, TemporalVAE, TransformerBlock, vae_from_config,
)
from shm_tpu_torch.train.vae import batch_loss, make_optimizer, reconstruction_mse

torch.set_num_threads(1)
BF16 = torch.bfloat16
# port bf16 against JAX bf16 on the test's windows (max, mean abs)
READINGS = {"lstm": (0.0, 0.0), "min_gru": (0.0, 0.0),
            "attention": (7.8125e-03, 1.0237e-03)}
CNN_READING = (4.8828e-04, 3.0518e-05)


@pytest.fixture(scope="module")
def windows():
    return R.all_vae_windows()


@pytest.mark.parametrize("cell", list(R.ROOTS))
def test_bf16_vae_sits_nearer_jax_bf16_than_jax_float32(cell, windows):
    Z, thr = R.vae_windows(cell, windows)
    vae, params = R.jax_vae(cell)
    jb = R.jax_recon(vae, params, Z, jnp.bfloat16)
    jf = R.jax_recon(vae, params, Z, jnp.float32)
    port = R.port_vae(cell, BF16)
    pb = R.port_recon(port, Z)
    assert pb.dtype == np.float32
    dp, df = np.abs(pb - jb), np.abs(jf - jb)
    assert dp.mean() < df.mean()
    bar_max, bar_mean = (2 * r for r in READINGS[cell])
    assert dp.max() <= bar_max and dp.mean() <= bar_mean, (dp.max(), dp.mean())
    mse = reconstruction_mse(port, Z, fused=False, device="cpu",
                             batch_size=len(Z))
    np.testing.assert_allclose(mse, R.mse(Z, pb), rtol=1e-6)
    np.testing.assert_array_equal(mse > thr, R.mse(Z, jb) > thr)
    assert all(p.dtype == torch.float32 for p in port.parameters())


def test_bf16_cnn_openlab_sits_nearer_jax_bf16_than_jax_float32():
    X, thr = R.cnn_windows()
    jb = R.jax_cnn_logits(X, jnp.bfloat16)
    jf = R.jax_cnn_logits(X, jnp.float32)
    cnn = R.port_cnn(BF16)
    pb = R.port_cnn_logits(cnn, X)
    assert pb.dtype == np.float32
    dp, df = np.abs(pb - jb), np.abs(jf - jb)
    assert dp.mean() < df.mean()
    assert dp.max() <= 2 * CNN_READING[0] and dp.mean() <= 2 * CNN_READING[1]
    np.testing.assert_array_equal(R.p_st(pb) >= thr, R.p_st(jb) >= thr)
    assert all(p.dtype == torch.float32 for p in cnn.parameters())
    with pytest.raises(ValueError, match="inference model"):
        cnn.train()(torch.from_numpy(X[:2]))


@pytest.mark.parametrize("cell", list(R.ROOTS))
def test_vae_from_config_takes_the_dtype(cell):
    cfg = VAEConfig(input_dim=3, latent_dim=2, hidden_dim=32, num_layers=2,
                    cell=cell)
    assert jax_vae_from_config(cfg, jnp.bfloat16).dtype == jnp.bfloat16
    vae = vae_from_config(cfg, BF16)
    assert vae.dtype == BF16
    assert vae.encoder_lstm.dtype == vae.decoder_lstm.dtype == BF16
    assert all(p.dtype == torch.float32 for p in vae.parameters())
    assert vae_from_config(cfg).dtype == torch.float32


@pytest.mark.parametrize("cell", list(R.ROOTS))
def test_fused_dtype_none_follows_the_vae(cell, windows):
    """``make_hybrid_fn(use_fused_vae=True, fused_dtype=None)`` on a bf16
    VAE runs the gate at bf16 (its plain version on the CPU honours the
    type): the bits of ``fused_dtype=bf16``, not those of float32; on a
    float32 VAE those of the default."""
    from shm_tpu_torch.cli.stage4dof import Paths, _load_stats
    from shm_tpu_torch.convert import cnn4dof_from_flax
    from shm_tpu_torch.pipeline import make_hybrid_fn
    from shm_tpu_torch.utils.checkpoint import load_checkpoint

    root = R.ROOT / R.ROOTS[cell]
    cnn = cnn4dof_from_flax(load_checkpoint(root / "models" / "cnn.msgpack"))
    mean, std = (torch.as_tensor(a) for a in _load_stats(Paths(str(root))))
    W, thr = torch.from_numpy(windows[::455][:8]), torch.tensor(0.5)
    run = lambda vae, **kw: make_hybrid_fn(vae, cnn, use_fused_vae=True, **kw)(
        W, mean, std, thr)
    bf16 = R.port_vae(cell, BF16)
    a, b = run(bf16, fused_dtype=None), run(bf16, fused_dtype=BF16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    f32 = R.port_vae(cell)
    c, d = run(f32, fused_dtype=None), run(f32)
    assert all(torch.equal(x, y) for x, y in zip(c, d))
    assert not torch.equal(a.mse, c.mse)


@pytest.mark.parametrize("cell", list(R.ROOTS))
def test_one_bf16_training_step_against_jax_loss(cell):
    """A bf16 ``TemporalVAE`` (D=3, Z=2, H=8, L=2, T=6, 8 windows, z = mu,
    no dropout) on the plain training path: its loss nearer JAX bf16's than
    JAX float32's is, finite float32 gradients, and one optimizer step moves
    the float32 parameters."""
    cfg = VAEConfig(input_dim=3, latent_dim=2, hidden_dim=8, num_layers=2,
                    dropout=0.0, cell=cell)
    rng = np.random.default_rng(7)
    params = random_flax_vae_params(rng, cfg)
    x = rng.normal(size=(8, 6, 3)).astype(np.float32)
    kl_w = 0.5

    def jax_loss(dtype):
        m = JaxVAE(input_dim=3, latent_dim=2, hidden_dim=8, num_layers=2,
                   dropout=0.0, dtype=dtype, cell=cell)

        def loss(p, xb):
            recon, mu, logvar = m.apply({"params": p}, xb)
            return jax_vae_loss(recon, xb, mu, logvar, kl_w)[0]

        return float(R.jit_rounding(loss, params, jnp.asarray(x)))

    jb, jf = jax_loss(jnp.bfloat16), jax_loss(jnp.float32)
    model = vae_from_flax(params, cfg, dtype=BF16).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model.parameters(), TrainConfig())
    opt.zero_grad()
    total, _, _ = batch_loss(model, torch.from_numpy(x), None, None, None,
                             None, kl_w, use_kernel=False)
    assert total.dtype == torch.float32
    assert abs(total.item() - jb) < abs(jf - jb), (total.item(), jb, jf)
    total.backward()
    opt.step()
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters())
    after = model.state_dict()
    assert all(after[k].dtype == torch.float32 for k in after)
    assert any(not torch.equal(after[k], before[k]) for k in after)


@pytest.mark.parametrize("make", [
    lambda dt: LSTMLayer(3, 8, dt), lambda dt: LSTMStack(3, 8, 2, dtype=dt),
    lambda dt: MinGRULayer(3, 8, dtype=dt),
    lambda dt: MinGRUStack(3, 8, 2, dtype=dt),
    lambda dt: TransformerBlock(32, 1, dtype=dt),
    lambda dt: AttentionStack(3, 32, dtype=dt),
    lambda dt: TemporalVAE(3, 2, 8, dtype=dt),
    lambda dt: CNNOpenLab(dtype=dt), lambda dt: CNN4DOF(dtype=dt),
])
def test_another_dtype_raises(make):
    with pytest.raises(ValueError, match="computes in float32 or bfloat16"):
        make(torch.float16)
    assert make(BF16).dtype == BF16
