"""The port's LSTM training ops (plain versions on the CPU) against the JAX package.

Inputs, weights, noise and dropout masks are made with numpy from a seed and
handed to both sides. The JAX side is the Pallas custom-VJP pair run in
interpret mode in float32 with ``batch_tile=16``, as ``tests/test_lstm_train.py``
runs it. Forward values are held to atol 2e-6 and gradients to
atol 1e-5 * max(1, max|ref|): both sides compute in float32; they differ in
summation order and in the sigmoid's form (the Pallas kernel evaluates it
through tanh).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.models.vae import vae_loss as jax_vae_loss
from shm_tpu.ops.lstm_train import (
    lstm2_dec_head as jax_dec_head, lstm2_enc_last as jax_enc_last,
    vae_train_forward as jax_vae_train_forward,
)
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax, vae_to_flax
from shm_tpu_torch.models.vae import vae_loss
from shm_tpu_torch.ops import (
    lstm2_dec_head, lstm2_dec_head_reference, lstm2_enc_last,
    lstm2_scan_reference, vae_train_forward,
)

# pytest-xdist runs several test files at once on the same cores; torch's
# default of one thread per core makes those workers spin against each other.
torch.set_num_threads(1)

FWD_ATOL = 2e-6
ENC_NAMES = ["xs", "w0i", "w0h", "b0", "w1i", "w1h", "b1"]
DEC_NAMES = ["dec_in", "w0i", "w0h", "b0", "w1i", "w1h", "b1", "out_w", "out_b"]


def _grad_close(got, ref, name):
    ref = np.asarray(ref)
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=atol, rtol=0,
                               err_msg=name)


@pytest.fixture(scope="module")
def scan_setup():
    """The shapes of ``tests/test_lstm_train.py::scan_setup``."""
    rng = np.random.default_rng(0)
    T, Din, B, H = 12, 6, 32, 8
    xs = rng.normal(size=(T, Din, B)).astype(np.float32)
    dm = ((rng.random((T, H, B)) > 0.3) / 0.7).astype(np.float32)
    w = lambda *shape: (rng.normal(size=shape) * 0.3).astype(np.float32)
    ws = [w(4 * H, Din), w(4 * H, H), w(4 * H, 1),
          w(4 * H, H), w(4 * H, H), w(4 * H, 1)]
    head = [w(5, H), w(5, 1)]
    din = rng.normal(size=(Din, B)).astype(np.float32)
    R_enc = rng.normal(size=(H, B)).astype(np.float32)
    R_dec = rng.normal(size=(T, 5, B)).astype(np.float32)
    return xs, dm, ws, din, head, R_enc, R_dec


def _leaves(arrays):
    return [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]


def test_enc_forward_matches_jax(scan_setup):
    xs, dm, ws, *_ = scan_setup
    ref = jax_enc_last(jnp.asarray(xs), jnp.asarray(dm), *map(jnp.asarray, ws),
                       16, jnp.float32, True)
    t = lambda a: torch.from_numpy(a)
    out = lstm2_enc_last(t(xs), t(dm), *map(t, ws))
    assert out.shape == (8, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL)
    hs = lstm2_scan_reference(t(xs), t(dm), *map(t, ws))
    assert hs.shape == (12, 8, 32) and torch.equal(hs[-1], out)


@pytest.mark.parametrize("idx", range(len(ENC_NAMES)), ids=ENC_NAMES)
def test_enc_gradient_matches_jax(scan_setup, idx):
    xs, dm, ws, _, _, R, _ = scan_setup

    def loss(args):
        return jnp.sum(jax_enc_last(args[0], jnp.asarray(dm), *args[1:], 16,
                                    jnp.float32, True) * R)

    ref = jax.grad(loss)([jnp.asarray(xs)] + [jnp.asarray(w) for w in ws])
    leaves = _leaves([xs] + ws)
    out = lstm2_enc_last(leaves[0], torch.from_numpy(dm), *leaves[1:])
    got = torch.autograd.grad((out * torch.from_numpy(R)).sum(), leaves)
    _grad_close(got[idx], ref[idx], ENC_NAMES[idx])


def test_dec_forward_matches_jax(scan_setup):
    _, dm, ws, din, head, _, _ = scan_setup
    T = dm.shape[0]
    ref = jax_dec_head(jnp.asarray(din), jnp.asarray(dm),
                       *map(jnp.asarray, ws + head), T, 16, jnp.float32, True)
    t = lambda a: torch.from_numpy(a)
    out = lstm2_dec_head(t(din), t(dm), *map(t, ws + head), T=T)
    assert out.shape == (T, 5, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL)
    again = lstm2_dec_head_reference(t(din), t(dm), *map(t, ws + head), T)
    assert torch.equal(again, out)


@pytest.mark.parametrize("idx", range(len(DEC_NAMES)), ids=DEC_NAMES)
def test_dec_gradient_matches_jax(scan_setup, idx):
    _, dm, ws, din, head, _, R = scan_setup
    T = dm.shape[0]

    def loss(args):
        return jnp.sum(jax_dec_head(args[0], jnp.asarray(dm), *args[1:], T, 16,
                                    jnp.float32, True) * R)

    ref = jax.grad(loss)([jnp.asarray(a) for a in [din] + ws + head])
    leaves = _leaves([din] + ws + head)
    out = lstm2_dec_head(leaves[0], torch.from_numpy(dm), *leaves[1:], T=T)
    got = torch.autograd.grad((out * torch.from_numpy(R)).sum(), leaves)
    _grad_close(got[idx], ref[idx], DEC_NAMES[idx])


def test_mask_gets_no_gradient_and_none_is_a_unit_mask(scan_setup):
    xs, dm, ws, *_ = scan_setup
    t = lambda a: torch.from_numpy(a)
    mask = t(dm).clone().requires_grad_(True)
    w = _leaves(ws)
    out = lstm2_enc_last(t(xs), mask, *w)
    out.sum().backward()
    assert mask.grad is None and all(p.grad is not None for p in w)
    ones = torch.ones_like(t(dm))
    assert torch.equal(lstm2_enc_last(t(xs), None, *map(t, ws)),
                       lstm2_enc_last(t(xs), ones, *map(t, ws)))


# --- the whole training forward ---------------------------------------------

CFG = VAEConfig(input_dim=6, latent_dim=4, hidden_dim=8, num_layers=2,
                dropout=0.3, use_layernorm=True)
B, T, KL_W = 16, 10, 0.37


@pytest.fixture(scope="module")
def vae_setup():
    rng = np.random.default_rng(7)
    params = random_flax_vae_params(rng, CFG)
    Z = rng.normal(size=(B, T, CFG.input_dim)).astype(np.float32)
    eps = rng.normal(size=(B, CFG.latent_dim)).astype(np.float32)
    mask = lambda: ((rng.random((T, CFG.hidden_dim, B)) > 0.3) / 0.7
                    ).astype(np.float32)
    bmask = (np.arange(B) < 13).astype(np.float32)      # a padded batch
    return params, Z, eps, mask(), mask(), bmask


def _torch_loss_grads(params, Z, eps, dm_e, dm_d, bmask, use_kernel):
    vae = vae_from_flax(params, CFG).train()
    t = torch.from_numpy
    recon, mu, logvar = vae_train_forward(vae, t(Z), t(eps), t(dm_e), t(dm_d),
                                          use_kernel=use_kernel)
    total, r, kl = vae_loss(recon, t(Z), mu, logvar, KL_W, mask=t(bmask))
    total.backward()
    grads = {n: p.grad.clone() for n, p in vae.named_parameters()}
    return vae, tuple(float(v.detach()) for v in (total, r, kl)), grads


@pytest.fixture(scope="module")
def jax_loss_grads(vae_setup):
    params, Z, eps, dm_e, dm_d, bmask = vae_setup

    def loss_fn(p):
        recon, mu, logvar = jax_vae_train_forward(
            p, jnp.asarray(Z), jnp.asarray(eps), jnp.asarray(dm_e),
            jnp.asarray(dm_d), use_layernorm=True, batch_tile=16,
            dtype=jnp.float32, interpret=True)
        total, r, kl = jax_vae_loss(recon, jnp.asarray(Z), mu, logvar, KL_W,
                                    mask=jnp.asarray(bmask))
        return total, (r, kl)

    (total, (r, kl)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return (float(total), float(r), float(kl)), jax.tree.map(np.asarray, grads)


def test_vae_train_forward_loss_matches_jax(vae_setup, jax_loss_grads):
    _, losses, _ = _torch_loss_grads(*vae_setup, use_kernel=None)
    np.testing.assert_allclose(losses, jax_loss_grads[0], atol=2e-6)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


GRAD_KEYS = sorted(k for k, _ in _flat(random_flax_vae_params(
    np.random.default_rng(0), CFG)))


@pytest.mark.parametrize("key", GRAD_KEYS)
def test_vae_train_forward_gradient_matches_jax(vae_setup, jax_loss_grads, key):
    vae, _, grads = _torch_loss_grads(*vae_setup, use_kernel=None)
    # the port's gradients, laid out as the flax tree
    got = dict(_flat(vae_to_flax({n: g for n, g in grads.items()})))
    ref = dict(_flat(jax_loss_grads[1]))
    assert got.keys() == ref.keys()
    _grad_close(torch.from_numpy(got[key]), ref[key], key)


def test_bias_ih_and_bias_hh_are_separate_with_equal_gradients(vae_setup):
    vae, _, grads = _torch_loss_grads(*vae_setup, use_kernel=None)
    names = [n for n, _ in vae.named_parameters()]
    for stack in ("encoder_lstm", "decoder_lstm"):
        for l in range(2):
            bi, bh = (f"{stack}.layers.{l}.bias_ih", f"{stack}.layers.{l}.bias_hh")
            assert bi in names and bh in names
            assert torch.equal(grads[bi], grads[bh])
            assert float(grads[bi].abs().max()) > 0


@pytest.mark.parametrize("use_kernel", [None, False], ids=["ops", "plain"])
def test_vae_train_forward_matches_model_autograd(vae_setup, use_kernel):
    """Against the port's own ``TemporalVAE`` forward under autograd, same
    eps and masks: float32 on both sides, another order of the same sums."""
    params, Z, eps, dm_e, dm_d, bmask = vae_setup
    _, losses, grads = _torch_loss_grads(*vae_setup, use_kernel=use_kernel)
    vae = vae_from_flax(params, CFG).train()
    t = torch.from_numpy
    bt = lambda m: t(m).permute(2, 0, 1)
    recon, mu, logvar = vae(t(Z), sample=True, eps=t(eps),
                            dropout_masks=(bt(dm_e), bt(dm_d)))
    total, r, kl = vae_loss(recon, t(Z), mu, logvar, KL_W, mask=t(bmask))
    total.backward()
    np.testing.assert_allclose(losses, (float(total), float(r), float(kl)),
                               atol=2e-6)
    for n, p in vae.named_parameters():
        _grad_close(grads[n], p.grad.numpy(), n)


def test_one_layer_model_raises(vae_setup):
    _, Z, eps, *_ = vae_setup
    cfg = VAEConfig(input_dim=6, latent_dim=4, hidden_dim=8, num_layers=1)
    vae = vae_from_flax(random_flax_vae_params(np.random.default_rng(1), cfg), cfg)
    with pytest.raises(ValueError, match="2-layer"):
        vae_train_forward(vae, torch.from_numpy(Z), torch.from_numpy(eps),
                          None, None)


def test_cpu_tensors_launch_no_kernel(scan_setup):
    xs, dm, ws, *_ = scan_setup
    t = lambda a: torch.from_numpy(a)
    before = (lstm2_enc_last.fwd_launches, lstm2_enc_last.bwd_launches)
    lstm2_enc_last(t(xs), t(dm), *map(t, ws))
    assert (lstm2_enc_last.fwd_launches, lstm2_enc_last.bwd_launches) == before


# --- the plain modules' training-mode behaviour -------------------------------

def test_lstm_stack_dropout_is_training_only_inverted_and_seeded():
    from shm_tpu_torch.models.lstm import LSTMStack

    torch.manual_seed(0)
    stack = LSTMStack(6, 8, num_layers=2, dropout=0.5)
    x = torch.randn(4, 7, 6)
    stack.eval()
    det, _ = stack(x)
    assert torch.equal(det, stack(x)[0])
    ones = torch.ones(4, 7, 8)
    assert torch.allclose(stack(x, dropout_masks=ones)[0], det)
    stack.train()
    g = lambda: torch.Generator().manual_seed(3)
    a, b = stack(x, generator=g())[0], stack(x, generator=g())[0]
    assert torch.equal(a, b) and not torch.allclose(a, det)
    # an explicit mask wins over the mode; a zero mask cuts layer 1's input
    zero = stack(x, dropout_masks=torch.zeros(4, 7, 8))[0]
    stack.eval()
    assert torch.equal(zero, stack(x, dropout_masks=[torch.zeros(4, 7, 8)])[0])
    with pytest.raises(ValueError, match="dropout masks"):
        stack(x, dropout_masks=[ones, ones])
    single = LSTMStack(6, 8, num_layers=1, dropout=0.5).train()
    assert torch.equal(single(x)[0], single(x)[0])     # no gap, no dropout


def test_vae_forward_sampling_and_fresh_init():
    vae = vae_from_flax(random_flax_vae_params(np.random.default_rng(2), CFG), CFG)
    x = torch.randn(5, T, 6, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        recon, mu, logvar = vae(x)
        eps = torch.zeros(5, 4)
        assert torch.equal(vae(x, sample=True, eps=eps)[0], recon)   # z = mu
        g = lambda: torch.Generator().manual_seed(8)
        a = vae(x, sample=True, generator=g())[0]
        assert torch.equal(a, vae(x, sample=True, generator=g())[0])
        assert not torch.allclose(a, recon)
    before = {k: v.clone() for k, v in vae.state_dict().items()}
    vae.init_parameters(torch.Generator().manual_seed(5))
    after = vae.state_dict()
    bound = 1.0 / np.sqrt(CFG.hidden_dim)
    for k, v in after.items():
        if "layer_norm" in k:
            continue
        assert not torch.equal(v, before[k]), k
        fan = bound if "lstm" in k or k.startswith(("fc_mu", "fc_logvar", "output_layer")) \
            else 1.0 / np.sqrt(CFG.latent_dim)
        assert float(v.abs().max()) <= fan + 1e-7, k
    assert torch.equal(after["layer_norm.weight"], torch.ones(8))
    vae2 = vae_from_flax(random_flax_vae_params(np.random.default_rng(2), CFG), CFG)
    vae2.init_parameters(torch.Generator().manual_seed(5))
    assert all(torch.equal(v, vae2.state_dict()[k]) for k, v in after.items())
