"""The bf16 mode of the port's LSTM training ops and trainer against the JAX
package at ``dtype=bf16``.

The port's side runs on CPU tensors: ``lstm2_enc_last`` / ``lstm2_dec_head`` /
``vae_train_forward`` with ``dtype=torch.bfloat16`` run the plain bf16
versions (products of bf16-rounded operands summed in float32) and, for the
backward, the explicit reverse scan and gradient pass. The JAX side is the
Pallas custom-VJP pair in interpret mode at ``dtype=jnp.bfloat16`` with
``batch_tile=16``, the shapes of ``tests/test_torch_lstm_train.py``, and the
same numpy-made inputs, noise and masks.

Both sides round the same operands, and a product of two bf16 values is
exact in float32, so they differ in the order of their float32 sums only;
where such a difference flips a bf16 rounding, the recurrence carries it
on. Each output is held on (max |diff| / max |ref|, mean |diff| / mean |ref|)
to twice the reading taken on these inputs (running this file as a script
prints the readings: ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_lstm_train_bf16.py``):

- the ops' forwards and gradients, worst over the outputs: (4.80e-5,
  6.91e-6) (the encoder's xs and w0i gradients, layer 0 at the end of the
  chain of roundings; every decoder output at most 1.9e-7 / 1.9e-7), bars
  ``OPS_TOL``;
- ``vae_train_forward``'s loss (the first step below): 7.8e-7 relative, bar
  ``LOSS_RTOL``; its gradients, worst over the parameters: (2.17e-7,
  1.77e-7), bars ``VAE_TOL``;
- five optimizer steps: the largest parameter difference 2.25e-6, bar
  ``TRAJ_ATOL``.

The float32 gap (the port's float32 ops against its bf16 ones on the same
inputs) is 1.0e-3 to 5.6e-3 in the mean on every output that passes through
a product, so a float32 path fails the mean bar
(``test_bf16_is_told_from_float32``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.config import TrainConfig as JaxTrainConfig
from shm_tpu.models.vae import vae_loss as jax_vae_loss
from shm_tpu.ops.lstm_train import (
    lstm2_dec_head as jax_dec_head, lstm2_enc_last as jax_enc_last,
    vae_train_forward as jax_vae_train_forward,
)
from shm_tpu.train.vae import make_optimizer as jax_make_optimizer
from shm_tpu_torch.config import TrainConfig, VAEConfig
from shm_tpu_torch.convert import (
    random_flax_vae_params, vae_from_flax, vae_state_dict, vae_to_flax,
)
from shm_tpu_torch.models.vae import vae_from_config, vae_loss
from shm_tpu_torch.ops import (
    lstm2_dec_head, lstm2_dec_head_reference, lstm2_enc_last,
    lstm2_scan_reference, lstm2_scan_stash_reference, vae_train_forward,
)
from shm_tpu_torch.ops.lstm_train import (
    dec_backward_reference, enc_backward_reference,
)
from shm_tpu_torch.train import make_optimizer, train_vae
from shm_tpu_torch.train.vae import batch_loss

torch.set_num_threads(1)

BF16 = torch.bfloat16
OPS_TOL = (9.7e-5, 1.4e-5)
LOSS_RTOL = 1.6e-6
VAE_TOL = (4.4e-7, 3.6e-7)
TRAJ_ATOL = 4.5e-6
ENC_NAMES = ("xs", "w0i", "w0h", "b0", "w1i", "w1h", "b1")
DEC_NAMES = ("dec_in", "w0i", "w0h", "b0", "w1i", "w1h", "b1", "out_w", "out_b")


def rel(got, ref):
    """(max |got - ref| / max |ref|, mean |got - ref| / mean |ref|)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d, r = np.abs(got - ref), np.abs(ref)
    return float(d.max() / r.max()), float(d.mean() / r.mean())


def _within(got, ref, tol, what):
    mx, mean = rel(got, ref)
    assert mx <= tol[0] and mean <= tol[1], (
        f"{what}: max_rel {mx:.3e} (bar {tol[0]:g}), mean_rel {mean:.3e} "
        f"(bar {tol[1]:g})")


# --- the two ops ---------------------------------------------------------------

@functools.cache
def _scan_inputs():
    """The inputs of ``tests/test_torch_lstm_train.py::scan_setup``."""
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
    return dict(enc=([xs] + ws, R_enc), dec=([din] + ws + head, R_dec), dm=dm,
                T=T)


@functools.cache
def _jax_ops(stack: str):
    """(output, gradients) of the JAX op of ``stack`` at dtype=bf16."""
    c = _scan_inputs()
    args, R = c[stack]
    dm = jnp.asarray(c["dm"])
    if stack == "enc":
        fn = lambda a: jax_enc_last(a[0], dm, *a[1:], 16, jnp.bfloat16, True)
    else:
        fn = lambda a: jax_dec_head(a[0], dm, *a[1:], c["T"], 16, jnp.bfloat16,
                                    True)
    a = [jnp.asarray(x) for x in args]
    grads = jax.grad(lambda a: jnp.sum(fn(a) * R))(a)
    return np.asarray(fn(a)), [np.asarray(g) for g in grads]


@functools.cache
def _port_ops(stack: str, dtype=BF16):
    """(output, gradients) of the port's op of ``stack`` on CPU tensors;
    ``dtype="default"`` passes none."""
    c = _scan_inputs()
    args, R = c[stack]
    dm = torch.from_numpy(c["dm"])
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True) for x in args]
    kw = {} if dtype == "default" else {"dtype": dtype}
    if stack == "enc":
        out = lstm2_enc_last(leaves[0], dm, *leaves[1:], **kw)
    else:
        out = lstm2_dec_head(leaves[0], dm, *leaves[1:], T=c["T"], **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(R)).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("stack", ["enc", "dec"])
def test_forward_matches_jax_bf16(stack):
    got, ref = _port_ops(stack)[0], _jax_ops(stack)[0]
    assert got.shape == ref.shape
    _within(got, ref, OPS_TOL, f"{stack} forward")


@pytest.mark.parametrize("stack, idx", [("enc", i) for i in range(7)]
                         + [("dec", i) for i in range(9)],
                         ids=[f"enc-{n}" for n in ENC_NAMES]
                         + [f"dec-{n}" for n in DEC_NAMES])
def test_gradient_matches_jax_bf16(stack, idx):
    got, ref = _port_ops(stack)[1][idx], _jax_ops(stack)[1][idx]
    assert got.shape == ref.shape
    _within(got, ref, OPS_TOL, f"{stack} gradient {idx}")


@pytest.mark.parametrize("stack", ["enc", "dec"])
def test_bf16_is_told_from_float32(stack):
    """The port's float32 op against the JAX bf16 op fails the mean bar on
    the forward and on every gradient that passes through a product (all
    but the output bias's, a sum of d recon)."""
    f32, ref = _port_ops(stack, torch.float32), _jax_ops(stack)
    outs = [(f32[0], ref[0])] + list(zip(f32[1], ref[1]))
    if stack == "dec":
        outs = outs[:-1]
    for i, (got, want) in enumerate(outs):
        assert rel(got, want)[1] > 10 * OPS_TOL[1], i


def test_float32_is_unchanged_by_the_dtype_argument():
    """``dtype=torch.float32`` (the default) runs the float32 plain versions
    under autograd, as before bf16 came: the same bits as calling them."""
    c = _scan_inputs()
    t = torch.from_numpy
    (xs, *ws), _ = c["enc"]
    (din, *dw), _ = c["dec"]
    dm, T = t(c["dm"]), c["T"]
    ref = lstm2_scan_reference(t(xs), dm, *map(t, ws))
    assert torch.equal(lstm2_enc_last(t(xs), dm, *map(t, ws),
                                      dtype=torch.float32), ref[-1])
    assert torch.equal(lstm2_scan_reference(t(xs), dm, *map(t, ws),
                                            dtype=torch.float32), ref)
    rec = lstm2_dec_head_reference(t(din), dm, *map(t, dw), T)
    assert torch.equal(lstm2_dec_head(t(din), dm, *map(t, dw), T=T,
                                      dtype=torch.float32), rec)
    for stack in ("enc", "dec"):
        a, b = _port_ops(stack, torch.float32), _port_ops(stack, "default")
        assert np.array_equal(a[0], b[0])
        assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    stash = lstm2_scan_stash_reference(t(xs), dm, *map(t, ws))
    again = lstm2_scan_stash_reference(t(xs), dm, *map(t, ws), dtype=torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(stash, again))


@pytest.mark.parametrize("stack", ["enc", "dec"])
def test_plain_backward_is_autograd_in_float32(stack):
    """``enc_backward_reference`` / ``dec_backward_reference``, the explicit
    reverse scan and gradient pass of the bf16 mode, give autograd's
    gradients of the plain float32 forward (another order of the same
    float32 sums: within 2e-6 of each gradient's largest entry)."""
    c = _scan_inputs()
    (x, *w), R = c[stack]
    dm, T = torch.from_numpy(c["dm"]), c["T"]
    t = torch.from_numpy
    if stack == "enc":
        _, stash, gates, fin = lstm2_scan_stash_reference(t(x), dm, *map(t, w))
        got = enc_backward_reference((t(x), dm, tuple(map(t, w)), stash, gates,
                                      fin), t(R))
    else:
        _, stash, gates, fin = lstm2_scan_stash_reference(t(x), dm, *map(t, w[:6]),
                                                          T=T)
        got = dec_backward_reference((t(x), dm, tuple(map(t, w)), stash, gates,
                                      fin, T, w[6].shape[0]), t(R))
    want = _port_ops(stack, "default")[1]
    for i, (g, ref) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=2e-6 * np.abs(ref).max(), err_msg=str(i))


def test_autograd_of_the_rounded_forward_is_not_the_bf16_backward():
    """Autograd through the plain bf16 forward rounds the gradient where
    the forward rounds its operands, which the JAX kernels' backward does
    not: its gradients lie farther from JAX's than the op's bf16 backward,
    by more than the bar."""
    c = _scan_inputs()
    (xs, *ws), R = c["enc"]
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in [xs] + ws]
    out = lstm2_scan_reference(leaves[0], torch.from_numpy(c["dm"]), *leaves[1:],
                               dtype=BF16)[-1]
    grads = torch.autograd.grad((out * torch.from_numpy(R)).sum(), leaves)
    ref = _jax_ops("enc")[1]
    worst = max(rel(g.numpy(), r)[1] for g, r in zip(grads, ref))
    assert worst > 10 * OPS_TOL[1]


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, jnp.bfloat16])
def test_other_types_are_refused(dtype):
    c = _scan_inputs()
    t = torch.from_numpy
    (xs, *ws), _ = c["enc"]
    (din, *dw), _ = c["dec"]
    dm = t(c["dm"])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lstm2_enc_last(t(xs), dm, *map(t, ws), dtype=dtype)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lstm2_dec_head(t(din), dm, *map(t, dw), T=c["T"], dtype=dtype)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lstm2_scan_reference(t(xs), dm, *map(t, ws), dtype=dtype)
    vae = vae_from_config(CFG)
    Z = torch.zeros(4, T, CFG.input_dim)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        vae_train_forward(vae, Z, None, None, None, dtype=dtype)
    with pytest.raises(ValueError, match="kernel_dtype"):
        train_vae(vae, Z, Z, TrainConfig(epochs=1, batch_size=4), device="cpu",
                  use_kernel=True, kernel_dtype=dtype)


def test_cpu_tensors_launch_no_kernel_in_bf16():
    before = [getattr(op, a) for op in (lstm2_enc_last, lstm2_dec_head)
              for a in ("fwd_launches", "bwd_launches", "bf16_fwd_launches",
                        "bf16_bwd_launches")]
    _port_ops.cache_clear()
    for stack in ("enc", "dec"):
        _port_ops(stack)
    after = [getattr(op, a) for op in (lstm2_enc_last, lstm2_dec_head)
             for a in ("fwd_launches", "bwd_launches", "bf16_fwd_launches",
                       "bf16_bwd_launches")]
    assert after == before


# --- the VAE's training forward and five optimizer steps ------------------------

CFG = VAEConfig(input_dim=6, latent_dim=4, hidden_dim=8, num_layers=2,
                dropout=0.3, use_layernorm=True)
T, KL_W, STEPS = 10, 0.25, 5
TKW = dict(lr=1e-3, weight_decay=1e-5, grad_clip=2.0)


@functools.cache
def _steps_inputs():
    """``tests/test_torch_train_vae.py``'s five-step trajectory: parameters,
    windows, batch order, eps, masks and a padded batch mask, from numpy."""
    rng = np.random.default_rng(11)
    bs, N = 16, 40
    params = random_flax_vae_params(rng, CFG)
    Z = rng.normal(size=(N, T, 6)).astype(np.float32)
    order = [rng.permutation(N)[:bs] for _ in range(STEPS)]
    eps = rng.normal(size=(STEPS, bs, 4)).astype(np.float32)
    masks = ((rng.random((STEPS, 2, T, 8, bs)) > 0.3) / 0.7).astype(np.float32)
    bmask = np.ones(bs, np.float32)
    bmask[-3:] = 0.0
    batches = [(Z[order[s]], eps[s], masks[s, 0], masks[s, 1]) for s in range(STEPS)]
    return params, batches, bmask


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@functools.cache
def _jax_steps():
    """The JAX side, Pallas ops in interpret mode at bf16 under the optax
    chain: (loss, r, kl) and the gradients of the first step, and the
    parameters after the last."""
    import optax

    params, batches, bmask = _steps_inputs()

    def loss_fn(p, xb, e, me, md):
        recon, mu, logvar = jax_vae_train_forward(
            p, xb, e, me, md, use_layernorm=True, batch_tile=16,
            dtype=jnp.bfloat16, interpret=True)
        total, r, kl = jax_vae_loss(recon, xb, mu, logvar, KL_W,
                                    mask=jnp.asarray(bmask))
        return total, (r, kl)

    tx = jax_make_optimizer(JaxTrainConfig(**TKW))
    pj = jax.tree.map(jnp.asarray, params)
    state = tx.init(pj)
    first = None
    for batch in batches:
        (total, (r, kl)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            pj, *map(jnp.asarray, batch))
        if first is None:
            first = ((float(total), float(r), float(kl)),
                     dict(_flat(jax.tree.map(np.asarray, grads))))
        updates, state = tx.update(grads, state, pj)
        pj = optax.apply_updates(pj, updates)
    return first, vae_state_dict(jax.tree.map(np.asarray, pj), 2, True)


@functools.cache
def _port_first_step(dtype=BF16, use_kernel=None):
    """The port's (loss, r, kl) and gradients of the first step through
    ``vae_train_forward`` at ``dtype``."""
    params, batches, bmask = _steps_inputs()
    t = torch.from_numpy
    xb, eps, dm_e, dm_d = map(t, batches[0])
    vae = vae_from_flax(params, CFG).train()
    recon, mu, logvar = vae_train_forward(vae, xb, eps, dm_e, dm_d,
                                          use_kernel=use_kernel, dtype=dtype)
    total, r, kl = vae_loss(recon, xb, mu, logvar, KL_W, mask=t(bmask))
    total.backward()
    grads = dict(_flat(vae_to_flax({n: p.grad for n, p in vae.named_parameters()})))
    return tuple(float(v.detach()) for v in (total, r, kl)), grads


@functools.cache
def _port_steps():
    """The port's parameters after the five steps (ops' plain versions at
    bf16 through ``batch_loss``, the port's optimizer)."""
    params, batches, bmask = _steps_inputs()
    t = torch.from_numpy
    vae = vae_from_flax(params, CFG).train()
    opt = make_optimizer(vae.parameters(), TrainConfig(**TKW))
    for xb, eps, dm_e, dm_d in batches:
        opt.zero_grad()
        total, _, _ = batch_loss(vae, t(xb), t(bmask), t(eps), [t(dm_e)],
                                 [t(dm_d)], KL_W, use_kernel=True,
                                 kernel_dtype=BF16)
        total.backward()
        opt.step()
    return vae_state_dict(vae_to_flax(vae), 2, True)


GRAD_KEYS = sorted(k for k, _ in _flat(random_flax_vae_params(
    np.random.default_rng(0), CFG)))


def test_vae_train_forward_bf16_loss_matches_jax():
    np.testing.assert_allclose(_port_first_step()[0], _jax_steps()[0][0],
                               rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("key", GRAD_KEYS)
def test_vae_train_forward_bf16_gradient_matches_jax(key):
    got, ref = _port_first_step()[1], _jax_steps()[0][1]
    assert got.keys() == ref.keys()
    _within(got[key], ref[key], VAE_TOL, key)


def test_vae_train_forward_plain_path_ignores_dtype():
    """``use_kernel=False`` is float32 whatever ``dtype`` says, as the JAX
    function's ``use_pallas=False``; the ops' bf16 loss differs."""
    plain32 = _port_first_step(torch.float32, False)
    plain16 = _port_first_step(BF16, False)
    assert plain16[0] == plain32[0]
    assert all(np.array_equal(plain16[1][k], plain32[1][k]) for k in GRAD_KEYS)
    assert _port_first_step()[0][0] != _port_first_step(torch.float32)[0][0]


def test_five_step_bf16_trajectory_matches_jax():
    """Five steps, same batches, eps and masks: every parameter within
    ``TRAJ_ATOL`` of JAX's, and the steps moved them."""
    got, ref = _port_steps(), _jax_steps()[1]
    start = vae_state_dict(_steps_inputs()[0], 2, True)
    moved = 0.0
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   atol=TRAJ_ATOL, rtol=0, err_msg=k)
        moved = max(moved, float((ref[k] - start[k]).abs().max()))
    assert moved > 1e-3


def _tiny_data(seed=0, N=40, Nva=24):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, T, 6)).astype(np.float32),
            rng.normal(size=(Nva, T, 6)).astype(np.float32))


def test_train_vae_runs_training_in_bf16_and_validation_in_float32(monkeypatch):
    """Every training batch reaches ``vae_train_forward`` at bf16 (with
    autograd on), every validation batch at float32 (under no_grad)."""
    import shm_tpu_torch.ops.lstm_train as ops

    seen = []
    real = ops.vae_train_forward

    def spy(*args, dtype=torch.float32, **kw):
        seen.append((torch.is_grad_enabled(), dtype))
        return real(*args, dtype=dtype, **kw)

    monkeypatch.setattr(ops, "vae_train_forward", spy)
    Ztr, Zva = _tiny_data()
    train_vae(vae_from_config(CFG), Ztr, Zva, TrainConfig(epochs=2, batch_size=16),
              device="cpu", use_kernel=True, kernel_dtype=BF16)
    train_batches, val_batches = 2 * 3, 2 * 2
    assert seen.count((True, BF16)) == train_batches
    assert seen.count((False, torch.float32)) == val_batches
    assert len(seen) == train_batches + val_batches


def test_train_vae_bf16_repeats_and_the_plain_path_ignores_it():
    Ztr, Zva = _tiny_data()
    cfg = TrainConfig(epochs=2, batch_size=16, seed=5)
    run = lambda **kw: train_vae(vae_from_config(CFG), Ztr, Zva, cfg,
                                 device="cpu", **kw).history
    a = run(use_kernel=True, kernel_dtype=BF16)
    assert a == run(use_kernel=True, kernel_dtype=BF16)
    assert all(np.isfinite(v).all() for v in a.values())
    assert a["train_total"] != run(use_kernel=True)["train_total"]
    assert run(use_kernel=False, kernel_dtype=BF16) == run(use_kernel=False)


def readings() -> None:
    """The readings the bars above rest on."""
    worst = (0.0, 0.0)
    for stack, names in (("enc", ("h_last",) + ENC_NAMES),
                         ("dec", ("recon",) + DEC_NAMES)):
        got, ref = _port_ops(stack), _jax_ops(stack)
        gap = _port_ops(stack, torch.float32)
        for n, g, r, f in zip(names, [got[0]] + got[1], [ref[0]] + ref[1],
                              [gap[0]] + gap[1]):
            a, b = rel(g, r), rel(f, g)
            worst = tuple(map(max, worst, a))
            print(f"OPS {stack} {n}: {a[0]:.3e} {a[1]:.3e} | float32 gap "
                  f"{b[0]:.3e} {b[1]:.3e}")
    print(f"OPS worst {worst[0]:.3e} {worst[1]:.3e}")
    (pl, pg), (jl, jg) = _port_first_step(), _jax_steps()[0]
    print("VAE loss rel", [abs(a - b) / abs(b) for a, b in zip(pl, jl)])
    worst = (0.0, 0.0)
    for k in GRAD_KEYS:
        a = rel(pg[k], jg[k])
        worst = tuple(map(max, worst, a))
        print(f"VAE {k}: {a[0]:.3e} {a[1]:.3e}")
    print(f"VAE worst {worst[0]:.3e} {worst[1]:.3e}")
    got, ref = _port_steps(), _jax_steps()[1]
    print("TRAJ max |diff|", max(float((got[k] - ref[k]).abs().max()) for k in ref))


if __name__ == "__main__":
    readings()
