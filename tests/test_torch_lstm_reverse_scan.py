"""The plain reverse scan of the LSTM training ops against autograd and the JAX package.

``lstm2_scan_stash_reference`` runs the forward and keeps what the forward
kernels keep for the backward (stash, gate stash, final state);
``lstm2_reverse_scan_reference`` runs the recurrence the backward kernels run
from it, to the gate gradients dg0, dg1 [T, 4H, B]. Contracted with the stash
and the inputs by ``torch.einsum``, as the kernels' gradient pass contracts
them, they must give every weight gradient and dx / d dec_in of (a) autograd
through ``lstm2_scan_reference`` / ``lstm2_dec_head_reference`` and (b)
``jax.grad`` through the Pallas custom-VJP pair in interpret mode at
``tests/test_lstm_train.py``'s shapes. Tolerance as in
``tests/test_torch_lstm_train.py``: atol 1e-5 * max(1, max|ref|), float32 on
both sides, summed in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.ops.lstm_train import (
    lstm2_dec_head as jax_dec_head, lstm2_enc_last as jax_enc_last,
)
from shm_tpu_torch.ops import (
    lstm2_dec_head_reference, lstm2_reverse_scan_reference,
    lstm2_scan_reference, lstm2_scan_stash_reference,
)
from shm_tpu_torch.ops.lstm_train import dec_backward_cuda, enc_backward_cuda

torch.set_num_threads(1)

ENC_NAMES = ["xs", "w0i", "w0h", "b0", "w1i", "w1h", "b1"]
DEC_NAMES = ["dec_in", "w0i", "w0h", "b0", "w1i", "w1h", "b1", "out_w", "out_b"]
E = torch.einsum


def _grad_close(got, ref, name):
    ref = np.asarray(ref)
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(got), ref, atol=atol, rtol=0, err_msg=name)


def _setup(seed, T, Din, B, H, drop=0.3):
    """Inputs in the ops' layouts, as ``tests/test_lstm_train.py`` makes them."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(T, Din, B)).astype(np.float32)
    dm = (((rng.random((T, H, B)) > drop) / (1 - drop)).astype(np.float32)
          if drop else None)
    w = lambda *shape: (rng.normal(size=shape) * 0.3).astype(np.float32)
    ws = [w(4 * H, Din), w(4 * H, H), w(4 * H, 1),
          w(4 * H, H), w(4 * H, H), w(4 * H, 1)]
    head = [w(5, H), w(5, 1)]
    din = rng.normal(size=(Din, B)).astype(np.float32)
    R_enc = rng.normal(size=(H, B)).astype(np.float32)
    R_dec = rng.normal(size=(T, 5, B)).astype(np.float32)
    return dict(xs=xs, dm=dm, ws=ws, head=head, din=din, R_enc=R_enc, R_dec=R_dec)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def enc_grads_from_scan(c):
    """(dxs, dw0i, dw0h, db0, dw1i, dw1h, db1) of sum(h_last * R_enc) from the
    plain reverse scan and its contractions."""
    xs, dm, ws = _t(c["xs"]), _t(c["dm"]), [_t(a) for a in c["ws"]]
    H = ws[1].shape[1]
    _, stash, gates, fin = lstm2_scan_stash_reference(xs, dm, *ws)
    dg0, dg1 = lstm2_reverse_scan_reference(stash, gates, fin, dm, ws[1], ws[3],
                                            ws[4], d_hlast=_t(c["R_enc"]))
    h0_after = torch.cat([stash[1:, :H], fin[None, :H]])
    h0d = h0_after if dm is None else h0_after * dm
    return [E("rd,trb->tdb", ws[0], dg0), E("trb,tdb->rd", dg0, xs),
            E("trb,thb->rh", dg0, stash[:, :H]), dg0.sum((0, 2))[:, None],
            E("trb,thb->rh", dg1, h0d), E("trb,thb->rh", dg1, stash[:, 2 * H:3 * H]),
            dg1.sum((0, 2))[:, None]]


def dec_grads_from_scan(c):
    """(d dec_in, dw0i, dw0h, db0, dw1i, dw1h, db1, d out_w, d out_b) of
    sum(recon * R_dec) from the plain reverse scan and its contractions."""
    din, dm, ws = _t(c["din"]), _t(c["dm"]), [_t(a) for a in c["ws"]]
    out_w, dr = _t(c["head"][0]), _t(c["R_dec"])
    T, H = dr.shape[0], ws[1].shape[1]
    _, stash, gates, fin = lstm2_scan_stash_reference(din, dm, *ws, T=T)
    dg0, dg1 = lstm2_reverse_scan_reference(
        stash, gates, fin, dm, ws[1], ws[3], ws[4],
        d_hseq=E("dh,tdb->thb", out_w, dr))
    h0_after = torch.cat([stash[1:, :H], fin[None, :H]])
    h0d = h0_after if dm is None else h0_after * dm
    h1_after = torch.cat([stash[1:, 2 * H:3 * H], fin[None, 2 * H:3 * H]])
    sum0 = dg0.sum(0)                     # layer 0's input is constant over T
    return [ws[0].t() @ sum0, E("rb,kb->rk", sum0, din),
            E("trb,thb->rh", dg0, stash[:, :H]), dg0.sum((0, 2))[:, None],
            E("trb,thb->rh", dg1, h0d), E("trb,thb->rh", dg1, stash[:, 2 * H:3 * H]),
            dg1.sum((0, 2))[:, None], E("tdb,thb->dh", dr, h1_after),
            dr.sum((0, 2))[:, None]]


def enc_grads_autograd(c):
    leaves = [_t(a).requires_grad_(True) for a in [c["xs"]] + c["ws"]]
    out = lstm2_scan_reference(leaves[0], _t(c["dm"]), *leaves[1:])[-1]
    return torch.autograd.grad((out * _t(c["R_enc"])).sum(), leaves)


def dec_grads_autograd(c):
    leaves = [_t(a).requires_grad_(True) for a in [c["din"]] + c["ws"] + c["head"]]
    T = c["R_dec"].shape[0]
    out = lstm2_dec_head_reference(leaves[0], _t(c["dm"]), *leaves[1:], T)
    return torch.autograd.grad((out * _t(c["R_dec"])).sum(), leaves)


@pytest.fixture(scope="module")
def scan_setup():
    """The shapes of ``tests/test_lstm_train.py::scan_setup``."""
    return _setup(0, T=12, Din=6, B=32, H=8)


@pytest.fixture(scope="module")
def enc_refs(scan_setup):
    c = scan_setup

    def loss(args):
        return jnp.sum(jax_enc_last(args[0], jnp.asarray(c["dm"]), *args[1:], 16,
                                    jnp.float32, True) * c["R_enc"])

    jax_g = jax.grad(loss)([jnp.asarray(a) for a in [c["xs"]] + c["ws"]])
    return dict(scan=enc_grads_from_scan(c), autograd=enc_grads_autograd(c),
                jax=[np.asarray(g) for g in jax_g])


@pytest.fixture(scope="module")
def dec_refs(scan_setup):
    c = scan_setup
    T = c["R_dec"].shape[0]

    def loss(args):
        return jnp.sum(jax_dec_head(args[0], jnp.asarray(c["dm"]), *args[1:], T, 16,
                                    jnp.float32, True) * c["R_dec"])

    jax_g = jax.grad(loss)([jnp.asarray(a) for a in [c["din"]] + c["ws"] + c["head"]])
    return dict(scan=dec_grads_from_scan(c), autograd=dec_grads_autograd(c),
                jax=[np.asarray(g) for g in jax_g])


@pytest.mark.parametrize("against", ["autograd", "jax"])
@pytest.mark.parametrize("idx", range(len(ENC_NAMES)), ids=ENC_NAMES)
def test_encoder_reverse_scan_gives_every_gradient(enc_refs, idx, against):
    ref = enc_refs[against][idx]
    ref = ref.numpy() if isinstance(ref, torch.Tensor) else ref
    assert enc_refs["scan"][idx].shape == ref.shape
    _grad_close(enc_refs["scan"][idx], ref, ENC_NAMES[idx])


@pytest.mark.parametrize("against", ["autograd", "jax"])
@pytest.mark.parametrize("idx", range(len(DEC_NAMES)), ids=DEC_NAMES)
def test_decoder_reverse_scan_gives_every_gradient(dec_refs, idx, against):
    ref = dec_refs[against][idx]
    ref = ref.numpy() if isinstance(ref, torch.Tensor) else ref
    assert dec_refs["scan"][idx].shape == ref.shape
    _grad_close(dec_refs["scan"][idx], ref, DEC_NAMES[idx])


@pytest.mark.parametrize("case", ["ragged", "unit_mask"])
@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_reverse_scan_on_a_ragged_batch_and_a_unit_mask(stack, case):
    """A batch that is no multiple of the kernels' tiles (13 windows, H=16),
    and dm=None, against autograd of the plain scans."""
    c = (_setup(5, T=9, Din=4, B=13, H=16) if case == "ragged"
         else _setup(6, T=7, Din=5, B=8, H=8, drop=0.0))
    assert (c["dm"] is None) == (case == "unit_mask")
    got, want, names = ((enc_grads_from_scan(c), enc_grads_autograd(c), ENC_NAMES)
                        if stack == "encoder" else
                        (dec_grads_from_scan(c), dec_grads_autograd(c), DEC_NAMES))
    for g, w, n in zip(got, want, names):
        _grad_close(g, w.numpy(), n)


def test_stash_reference_is_the_plain_forward(scan_setup):
    """Its outputs are the plain scans' bit for bit; the stash holds the
    pre-step states, the gate stash the activations that give them."""
    c = scan_setup
    xs, dm, ws = _t(c["xs"]), _t(c["dm"]), [_t(a) for a in c["ws"]]
    T, _, B = xs.shape
    H = ws[1].shape[1]
    h1s, stash, gates, fin = lstm2_scan_stash_reference(xs, dm, *ws)
    assert stash.shape == (T, 4 * H, B) and gates.shape == (T, 2, 4 * H, B)
    assert torch.equal(h1s, lstm2_scan_reference(xs, dm, *ws))
    assert torch.equal(stash[0], torch.zeros(4 * H, B))
    after = torch.cat([stash[1:], fin[None]])
    for layer in range(2):
        i, f, g, o = gates[:, layer].chunk(4, dim=1)
        c_prev, c_aft = stash[:, (2 * layer + 1) * H:(2 * layer + 2) * H], \
            after[:, (2 * layer + 1) * H:(2 * layer + 2) * H]
        torch.testing.assert_close(f * c_prev + i * g, c_aft, atol=0, rtol=0)
        torch.testing.assert_close(o * torch.tanh(c_aft),
                                   after[:, 2 * layer * H:(2 * layer + 1) * H],
                                   atol=0, rtol=0)
        assert float(i.min()) > 0 and float(g.abs().max()) < 1
    head = [_t(a) for a in c["head"]]
    din = _t(c["din"])
    h1d = lstm2_scan_stash_reference(din, dm, *ws, T=T)[0]
    assert torch.equal(head[0] @ h1d + head[1],
                       lstm2_dec_head_reference(din, dm, *ws, *head, T))


def test_reverse_scan_seeds_are_additive(scan_setup):
    """The recurrence is linear in its seeds: the encoder's d_hlast is the
    decoder's d_hseq with only its last step set."""
    c = scan_setup
    xs, dm, ws = _t(c["xs"]), _t(c["dm"]), [_t(a) for a in c["ws"]]
    _, stash, gates, fin = lstm2_scan_stash_reference(xs, dm, *ws)
    R = _t(c["R_enc"])
    seq = torch.zeros(stash.shape[0], *R.shape)
    seq[-1] = R
    a = lstm2_reverse_scan_reference(stash, gates, fin, dm, ws[1], ws[3], ws[4], d_hlast=R)
    b = lstm2_reverse_scan_reference(stash, gates, fin, dm, ws[1], ws[3], ws[4], d_hseq=seq)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_backward_wrappers_refuse_a_gate_stash_of_another_shape(stack):
    """The shape check comes before any kernel is built or launched."""
    T, D, H, B = 4, 3, 32, 5
    z = lambda *s: torch.zeros(*s)
    stash, gates, fin = z(T, 4 * H, B), z(T, 4 * H, B), z(4 * H, B)
    with pytest.raises(ValueError, match="gates must have shape"):
        if stack == "encoder":
            enc_backward_cuda((z(T, D, B), None, [], stash, gates, fin), z(H, B))
        else:
            dec_backward_cuda((z(H, B), None, [], stash, gates, fin, T, D), z(T, D, B))
