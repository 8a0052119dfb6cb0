"""Tests of the port's CUDA kernels; they need the card and skip without one.

Run them on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it also runs where only PyTorch is installed.
Kernel against plain version: both float32 on the card, summed in other
orders through a 2*L*T-step recurrence (or, for the attention gate, through
four transformer blocks), so within atol 1e-4 + rtol 1e-4.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import (
    fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
)

ROOT_DIR = Path(__file__).resolve().parents[1]

CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual)
    "4dof_ragged": (77, 100, 12, 16, 128, 2, True, True),
    "openlab_L1_H64": (40, 200, 3, 8, 64, 1, True, True),
    "1dof_H32_noln": (33, 80, 12, 5, 32, 2, False, True),
    "gate_only": (50, 30, 12, 16, 128, 2, True, False),
    # ragged against 32 and 64 windows a block: 1 and 33 windows in the last
    "4dof_N97": (97, 100, 12, 16, 128, 2, True, True),
    # widths padded to an instance (LayerNorm over the model's own), D and Z
    # past 16 and 32 (the output head's slots past the registers')
    "H48_D64_Z64": (40, 60, 64, 64, 48, 2, True, True),
    "H96_D20_Z128_noln": (33, 40, 20, 128, 96, 2, False, True),
    "H128_D128_Z128_L1": (20, 30, 128, 128, 128, 1, True, True),
}

# the gate kernels' shared shapes (the LSTM kernel is also held at CASES)
GATE_CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual)
    "4dof_ragged": (77, 100, 12, 16, 128, 2, True, True),
    "openlab_L1_H64_T200": (40, 200, 3, 8, 64, 1, True, True),
    "1dof_H32_noln": (33, 80, 12, 5, 32, 2, False, True),
    "gate_only": (50, 30, 12, 16, 128, 2, True, False),
    "one_window": (1, 17, 12, 16, 64, 2, True, True),
    # ragged row tiles of the attention kernel's tensor-core products (T not
    # a multiple of 16), the longest window it takes at H=128, H=64 with L=1
    "T7_H32": (21, 7, 12, 5, 32, 2, True, True),
    "T130_H32": (17, 130, 5, 4, 32, 2, True, True),
    "T136_H128": (19, 136, 12, 16, 128, 2, True, True),
    "H64_L1": (23, 100, 12, 16, 64, 1, True, True),
    # latents past 32, to 128 (every cell)
    "Z64_H64_L1": (23, 100, 12, 64, 64, 1, True, True),
    "Z128_H128": (17, 50, 12, 128, 128, 2, True, True),
}


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from shm_tpu_torch.device import set_full_f32_precision

    set_full_f32_precision()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES) + [n for n in GATE_CASES if n not in CASES])
def test_fused_vae_kernel_matches_plain_version(cuda_device, name):
    N, T, D, Zd, H, L, ln, wr = {**GATE_CASES, **CASES}[name]
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln)
    rng = np.random.default_rng(len(name))
    vae = vae_from_flax(random_flax_vae_params(rng, cfg), cfg).to(cuda_device)
    w = vae_params_to_kernel_weights(vae)
    Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32))
    Z = Z.to(cuda_device)
    before = fused_vae_gate.launches
    mse, resid = fused_vae_gate(w, Z, num_layers=L, use_layernorm=ln,
                                with_residual=wr)
    torch.cuda.synchronize()
    assert fused_vae_gate.launches == before + 1
    mse_p, resid_p = fused_vae_gate_reference(w, Z, num_layers=L,
                                              use_layernorm=ln,
                                              with_residual=wr)
    torch.testing.assert_close(mse, mse_p, atol=1e-4, rtol=1e-4)
    if wr:
        torch.testing.assert_close(resid, resid_p, atol=1e-4, rtol=1e-4)
    else:
        assert resid is None


@pytest.mark.cuda
def test_fused_vae_kernel_refuses_bad_input(cuda_device):
    """Past the kernel's reach (H > 128; any H <= 128 runs padded) a call
    raises, and the caller never gives way to the plain model."""
    cfg = VAEConfig(input_dim=12, latent_dim=4, hidden_dim=160, num_layers=1)
    vae = vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg),
                        cfg).to(cuda_device)
    w = vae_params_to_kernel_weights(vae)
    with pytest.raises(ValueError, match="unsupported shape"):
        fused_vae_gate(w, torch.zeros(2, 5, 12, device=cuda_device),
                       num_layers=1, use_layernorm=True)
    # the caller does not give way to the plain model either
    from shm_tpu_torch.train import reconstruction_mse

    with pytest.raises(ValueError, match="unsupported shape"):
        reconstruction_mse(vae, np.zeros((2, 5, 12), np.float32))


# --- the LSTM training kernels (ops/lstm_train.py) ---------------------------
# Kernel against plain version under autograd, both float32 on the card. The
# backward sums T*B terms per weight-gradient entry in another order than
# autograd does, so gradients are held to atol 2e-4 * max|plain| (+ rtol 1e-4).

LSTM_CASES = {  # name: (T, D, H, B, dropout)
    "4dof_small_T": (20, 12, 128, 64, 0.3),
    "ragged_batch": (15, 12, 64, 37, 0.3),
    "1dof_H32": (80, 12, 32, 64, 0.2),
    "unit_mask": (10, 6, 32, 8, 0.0),
    "batch_1024_H128": (12, 12, 128, 1024, 0.3),
    "one_window_H128": (9, 12, 128, 1, 0.3),
    "ragged_H32": (11, 12, 32, 21, 0.3),
    # a width padded to the H=64 instance around the autograd.Function
    "H48": (20, 12, 48, 64, 0.3),
}


def _lstm_inputs(name, device):
    T, D, H, B, drop = LSTM_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    u = lambda *s: t(rng.uniform(-1, 1, size=s) / np.sqrt(H))
    ws = [u(4 * H, D), u(4 * H, H), u(4 * H, 1), u(4 * H, H), u(4 * H, H),
          u(4 * H, 1)]
    dm = (t((rng.random((T, H, B)) > drop) / (1.0 - drop)) if drop else None)
    return (T, D, H, B), rng, t, u, ws, dm


def _assert_grads_close(got, want, names):
    for n, g, w in zip(names, got, want):
        atol = 2e-4 * max(float(w.abs().max()), 1e-6)
        torch.testing.assert_close(g, w, atol=atol, rtol=1e-4, msg=lambda m: f"{n}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LSTM_CASES))
def test_lstm2_enc_last_kernel_matches_plain_version(cuda_device, name):
    from shm_tpu_torch.ops import lstm2_enc_last, lstm2_scan_reference

    (T, D, H, B), rng, t, u, ws, dm = _lstm_inputs(name, cuda_device)
    xs = t(rng.normal(size=(T, D, B)))
    R = t(rng.normal(size=(H, B)))
    leaves = [a.clone().requires_grad_(True) for a in [xs] + ws]
    f0, b0 = lstm2_enc_last.fwd_launches, lstm2_enc_last.bwd_launches
    out = lstm2_enc_last(leaves[0], dm, *leaves[1:])
    got = torch.autograd.grad((out * R).sum(), leaves)
    torch.cuda.synchronize()
    assert (lstm2_enc_last.fwd_launches, lstm2_enc_last.bwd_launches) == (f0 + 1, b0 + 1)
    ref_leaves = [a.clone().requires_grad_(True) for a in [xs] + ws]
    ref = lstm2_scan_reference(ref_leaves[0], dm, *ref_leaves[1:])[-1]
    want = torch.autograd.grad((ref * R).sum(), ref_leaves)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    _assert_grads_close(got, want, ["dx", "w0i", "w0h", "b0", "w1i", "w1h", "b1"])
    with torch.no_grad():                       # no stash, same result
        torch.testing.assert_close(lstm2_enc_last(xs, dm, *ws), out, atol=0, rtol=0)
        # the trainer's validation mode: no stash and a null mask
        torch.testing.assert_close(
            lstm2_enc_last(xs, None, *ws),
            lstm2_scan_reference(xs, None, *ws)[-1], atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LSTM_CASES))
def test_lstm2_dec_head_kernel_matches_plain_version(cuda_device, name):
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_dec_head_reference

    (T, D, H, B), rng, t, u, ws, dm = _lstm_inputs(name, cuda_device)
    ws[0] = u(4 * H, H)                         # decoder input is H wide
    head = [u(D, H), u(D, 1)]
    din = t(rng.normal(size=(H, B)))
    R = t(rng.normal(size=(T, D, B)))
    leaves = [a.clone().requires_grad_(True) for a in [din] + ws + head]
    f0, b0 = lstm2_dec_head.fwd_launches, lstm2_dec_head.bwd_launches
    out = lstm2_dec_head(leaves[0], dm, *leaves[1:], T=T)
    got = torch.autograd.grad((out * R).sum(), leaves)
    torch.cuda.synchronize()
    assert (lstm2_dec_head.fwd_launches, lstm2_dec_head.bwd_launches) == (f0 + 1, b0 + 1)
    ref_leaves = [a.clone().requires_grad_(True) for a in [din] + ws + head]
    ref = lstm2_dec_head_reference(ref_leaves[0], dm, *ref_leaves[1:], T)
    want = torch.autograd.grad((ref * R).sum(), ref_leaves)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    _assert_grads_close(got, want, ["ddin", "w0i", "w0h", "b0", "w1i", "w1h",
                                    "b1", "out_w", "out_b"])
    with torch.no_grad():                       # no stash, same result
        torch.testing.assert_close(lstm2_dec_head(din, dm, *ws, *head, T=T),
                                   out, atol=0, rtol=0)
        # the trainer's validation mode: no stash and a null mask
        torch.testing.assert_close(
            lstm2_dec_head(din, None, *ws, *head, T=T),
            lstm2_dec_head_reference(din, None, *ws, *head, T),
            atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_lstm_backward_is_reproducible_bit_for_bit(cuda_device):
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last

    for name in ("ragged_batch", "batch_1024_H128"):
        (T, D, H, B), rng, t, u, ws, dm = _lstm_inputs(name, cuda_device)
        xs = t(rng.normal(size=(T, D, B)))
        din = t(rng.normal(size=(H, B)))
        dec_w = [u(4 * H, H)] + ws[1:] + [u(D, H), u(D, 1)]
        runs = []
        for _ in range(2):
            enc, dec = ([a.clone().requires_grad_(True) for a in w]
                        for w in (ws, [din] + dec_w))
            runs.append(torch.autograd.grad(lstm2_enc_last(xs, dm, *enc).sum(), enc)
                        + torch.autograd.grad(
                            lstm2_dec_head(dec[0], dm, *dec[1:], T=T).sum(), dec))
        for a, b in zip(*runs):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_lstm_kernels_refuse_bad_input(cuda_device):
    """Past the kernels' reach (H > 128; any H <= 128 runs padded) the op
    raises before a launch."""
    from shm_tpu_torch.ops import lstm2_enc_last

    H = 160
    z = lambda *s: torch.zeros(*s, device=cuda_device)
    with pytest.raises(ValueError, match="unsupported hidden size"):
        lstm2_enc_last(z(3, 4, 2), None, z(4 * H, 4), z(4 * H, H), z(4 * H, 1),
                       z(4 * H, H), z(4 * H, H), z(4 * H, 1))


@pytest.mark.cuda
def test_lstm_backward_refuses_a_gate_stash_of_another_shape(cuda_device):
    from shm_tpu_torch.ops.lstm_train import (
        dec_backward_cuda, dec_forward_cuda, enc_backward_cuda, enc_forward_cuda,
    )

    (T, D, H, B), rng, t, u, ws, dm = _lstm_inputs("ragged_batch", cuda_device)
    _, saved = enc_forward_cuda(t(rng.normal(size=(T, D, B))), dm, *ws)
    bad = list(saved)
    bad[4] = saved[4][:, :1]                    # one layer's gates only
    with pytest.raises(ValueError, match="gates must have shape"):
        enc_backward_cuda(tuple(bad), torch.zeros(H, B, device=cuda_device))
    dec_w = [u(4 * H, H)] + ws[1:] + [u(D, H), u(D, 1)]
    _, saved = dec_forward_cuda(t(rng.normal(size=(H, B))), dm, *dec_w, T=T)
    bad = list(saved)
    bad[4] = saved[4][:-1]                      # one step short
    with pytest.raises(ValueError, match="gates must have shape"):
        dec_backward_cuda(tuple(bad), torch.zeros(T, D, B, device=cuda_device))


def _assert_forward_outputs(runs, want, keep):
    """Two runs of a forward wrapper, (output, saved) each, against the plain
    (output, stash, gates, fin); the second run equal to the first bit for bit."""
    (out, saved), (again, saved2) = runs
    close = lambda a, b, n: torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5,
                                                       msg=lambda m: f"{n}: {m}")
    close(out, want[0], "output")
    close(saved[5], want[3], "final state")
    if keep:
        close(saved[3], want[1], "stash")
        close(saved[4], want[2], "gate stash")
    else:
        assert saved[3] is None and saved[4] is None
    for a, b in zip((out,) + saved[3:6], (again,) + saved2[3:6]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LSTM_CASES))
def test_lstm_forwards_write_what_the_plain_forward_keeps(cuda_device, name):
    """Both forward kernels, with and without a stash: the output (h_last,
    recon), the final state, the stash and the gate stash against
    ``lstm2_scan_stash_reference``; two runs give the same bits."""
    from shm_tpu_torch.ops import lstm2_scan_stash_reference
    from shm_tpu_torch.ops._gate import instance_width
    from shm_tpu_torch.ops.lstm_train import (
        dec_forward_cuda, enc_forward_cuda, pad_hidden,
    )

    (T, D, H, B), rng, t, u, ws, dm = _lstm_inputs(name, cuda_device)
    xs = t(rng.normal(size=(T, D, B)))
    din = t(rng.normal(size=(H, B)))
    dec_w = [u(4 * H, H)] + ws[1:] + [u(D, H), u(D, 1)]
    Hp = instance_width(H)
    if Hp != H:     # the kernels' width: both sides on the padded inputs
        _, *dec_w = pad_hidden(H, Hp, dm, *dec_w)
        dm, *ws = pad_hidden(H, Hp, dm, *ws)
    with torch.no_grad():
        h1s, stash, gates, fin = lstm2_scan_stash_reference(xs, dm, *ws)
        enc_want = (h1s[-1], stash, gates, fin)
        h1s, stash, gates, fin = lstm2_scan_stash_reference(din, dm, *dec_w[:6], T=T)
        dec_want = (dec_w[6] @ h1s + dec_w[7], stash, gates, fin)
        for keep in (True, False):
            runs = [enc_forward_cuda(xs, dm, *ws, keep_stash=keep) for _ in range(2)]
            torch.cuda.synchronize()
            _assert_forward_outputs(runs, enc_want, keep)
            runs = [dec_forward_cuda(din, dm, *dec_w, T=T, keep_stash=keep)
                    for _ in range(2)]
            torch.cuda.synchronize()
            _assert_forward_outputs(runs, dec_want, keep)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 64, 128])
def test_lstm_scans_place_clusters_on_the_card(cuda_device, H):
    from shm_tpu_torch.ops.lstm_train import bwd_scan_info, fwd_scan_info

    for dec in (False, True):
        for info in (fwd_scan_info(H, dec), bwd_scan_info(H, dec)):
            assert info["max_active_clusters"] >= 1
            assert info["threads"] == H // 8 * 20
            assert 0 < info["shared_bytes"] <= 232448


# --- the minGRU and attention gates (ops/fused_mingru.py, ops/fused_attention.py)



def _gate(cell):
    from shm_tpu_torch.ops import FUSED_GATES

    return FUSED_GATES[cell]


def _gate_case(cell, case, device, seed):
    N, T, D, Zd, H, L, ln, wr = case
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell=cell)
    rng = np.random.default_rng(seed)
    vae = vae_from_flax(random_flax_vae_params(rng, cfg), cfg).to(device)
    Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32))
    return vae, Z.to(device), dict(num_layers=L, use_layernorm=ln,
                                   with_residual=wr)


# minGRU-only cases: three and four layers (the attention kernel takes 1 or
# 2), and T not a multiple of the steps of the minGRU kernel's tiles
MINGRU_CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual)
    "mingru_L3": (45, 40, 4, 5, 32, 3, True, True),
    "mingru_T61_L1_H128": (45, 61, 12, 16, 128, 1, True, True),
    "mingru_T61_L4_H128": (37, 61, 12, 16, 128, 4, True, True),
    "mingru_T61_L4_H64": (33, 61, 3, 8, 64, 4, False, True),
    "mingru_T5_L4_H32": (50, 5, 12, 5, 32, 4, True, True),
    "mingru_T61_L2_H32_gate_only": (20, 61, 12, 16, 32, 2, True, False),
    # padded widths, D and Z to 128, the largest block (L=4, H=128, D=Z=128)
    "mingru_H48_D64_Z64": (40, 60, 64, 64, 48, 2, True, True),
    "mingru_H96_D20_Z128_L3": (33, 40, 20, 128, 96, 3, False, True),
    "mingru_L4_H128_D128_Z128": (20, 30, 128, 128, 128, 4, True, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GATE_CASES) + list(MINGRU_CASES))
@pytest.mark.parametrize("cell", ["min_gru", "attention"])
def test_fused_cell_gate_kernel_matches_plain_version(cuda_device, cell, name):
    if name in MINGRU_CASES:
        if cell != "min_gru":
            pytest.skip("a minGRU-only case")
        case = MINGRU_CASES[name]
    else:
        case = GATE_CASES[name]
    weights_fn, gate, reference = _gate(cell)
    vae, Z, kw = _gate_case(cell, case, cuda_device, len(name))
    w = weights_fn(vae)
    before = gate.launches
    mse, resid = gate(w, Z, **kw)
    torch.cuda.synchronize()
    assert gate.launches == before + 1
    mse_p, resid_p = reference(w, Z, **kw)
    assert mse.shape == (Z.shape[0],) and bool(torch.isfinite(mse).all())
    torch.testing.assert_close(mse, mse_p, atol=1e-4, rtol=1e-4)
    if kw["with_residual"]:
        torch.testing.assert_close(resid, resid_p, atol=1e-4, rtol=1e-4)
    else:
        assert resid is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["1dof_H32_noln", "4dof_ragged"])
@pytest.mark.parametrize("cell", ["lstm", "min_gru", "attention"])
def test_fused_cell_gate_kernel_is_reproducible_and_takes_no_windows(cuda_device, cell, name):
    weights_fn, gate, _ = _gate(cell)
    vae, Z, kw = _gate_case(cell, GATE_CASES[name], cuda_device, 3)
    w = weights_fn(vae)
    a, b = gate(w, Z, **kw), gate(w, Z, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])   # no atomics
    before = gate.launches
    mse, resid = gate(w, Z[:0], **kw)
    assert mse.shape == (0,) and resid.shape == (0,) + Z.shape[1:]
    assert gate.launches == before                               # no launch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["min_gru", "attention"])
def test_fused_cell_gate_kernel_refuses_bad_input(cuda_device, cell):
    from shm_tpu_torch.train import reconstruction_mse

    weights_fn, gate, _ = _gate(cell)
    vae, Z, kw = _gate_case(cell, GATE_CASES["1dof_H32_noln"], cuda_device, 4)
    w = weights_fn(vae)
    before = gate.launches
    with pytest.raises(ValueError, match="contiguous torch.float32"):
        gate(w, Z.transpose(0, 1), **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16 products"):
        gate(w, Z.double(), **kw)
    with pytest.raises(ValueError, match="must be contiguous float32 on"):
        gate({k: v.cpu() for k, v in w.items()}, Z, **kw)
    assert gate.launches == before
    # the caller launches the cell's gate-only kernel and nothing else
    mse = reconstruction_mse(vae, Z.cpu().numpy())
    assert gate.launches == before + 1
    ref = reconstruction_mse(vae, Z.cpu().numpy(), fused=False)
    assert gate.launches == before + 1
    np.testing.assert_allclose(mse, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_fused_attention_kernel_refuses_a_window_too_long_for_a_block(cuda_device):
    """The resident body refuses a window too long for a block's shared
    memory (T=400 at H=128); the wrapper runs it in the long body, which
    agrees with the plain version."""
    from shm_tpu_torch.ops import (
        attention_params_to_kernel_weights, fused_attention_gate,
        fused_attention_gate_reference,
    )
    from shm_tpu_torch.ops.fused_attention import _launch

    vae, Z, kw = _gate_case("attention", (2, 400, 12, 16, 128, 2, True, True),
                            cuda_device, 5)
    w = attention_params_to_kernel_weights(vae)
    before = fused_attention_gate.launches
    with pytest.raises(ValueError, match="resident body does not take"):
        _launch(w, Z, dtype=torch.float32, io_dtype=None, body="resident", **kw)
    assert fused_attention_gate.launches == before
    long_before = fused_attention_gate.long_launches
    mse, resid = fused_attention_gate(w, Z, **kw)
    torch.cuda.synchronize()
    assert fused_attention_gate.launches == before + 1
    assert fused_attention_gate.long_launches == long_before + 1
    mse_p, resid_p = fused_attention_gate_reference(w, Z, **kw)
    torch.testing.assert_close(mse, mse_p, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(resid, resid_p, atol=1e-4, rtol=1e-4)


# windows past each width's resident limit, and the openLAB shape in the
# long body; both softmax forms
LONG_CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual)
    "T137_H128_L2": (5, 137, 12, 16, 128, 2, True, True),
    "T209_H64_L1": (7, 209, 3, 8, 64, 1, True, True),
    "T269_H32_noln_gate_only": (6, 269, 12, 5, 32, 2, False, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [True, False])
@pytest.mark.parametrize("name", list(LONG_CASES))
def test_fused_attention_long_body_matches_plain_version(cuda_device, name, stream):
    from shm_tpu_torch.ops.fused_attention import plan

    weights_fn, gate, reference = _gate("attention")
    vae, Z, kw = _gate_case("attention", LONG_CASES[name], cuda_device, len(name))
    assert plan(Z.shape[1], vae.hidden_dim).body == "long"
    w = weights_fn(vae)
    before = (gate.launches, gate.long_launches, gate.stream_launches)
    mse, resid = gate(w, Z, stream=stream, **kw)
    torch.cuda.synchronize()
    assert (gate.launches, gate.long_launches, gate.stream_launches) == (
        before[0] + 1, before[1] + 1, before[2] + int(stream))
    mse_p, resid_p = reference(w, Z, stream=stream, **kw)
    torch.testing.assert_close(mse, mse_p, atol=1e-4, rtol=1e-4)
    if kw["with_residual"]:
        torch.testing.assert_close(resid, resid_p, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T, H, L", [(100, 128, 2), (200, 64, 1)])
def test_fused_attention_streaming_form_is_the_same_in_both_bodies(cuda_device, T, H, L, dtype):
    """At a window the resident body takes, the long body's streaming form
    gives its bits in float32: each row-local step and each softmax row and
    P.V element sums in the same order in both. In bf16 the resident body
    runs its scores and P.V on the tensor cores, the long body on the FMA
    pipes, so the two are held to each other within the bf16 bars."""
    from shm_tpu_torch.ops.fused_attention import _launch

    weights_fn, gate, _ = _gate("attention")
    vae, Z, kw = _gate_case("attention", (9, T, 5, 8, H, L, True, True),
                            cuda_device, T)
    w = weights_fn(vae, dtype)
    kw = dict(kw, stream=True, dtype=dtype, io_dtype=None)
    a = _launch(w, Z, body="resident", **kw)
    b = _launch(w, Z, body="long", **kw)
    if dtype == torch.float32:
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    else:
        _close_bf16("attention", b[0], a[0])


@pytest.mark.cuda
@pytest.mark.parametrize("T, H", [(100, 128), (200, 64), (80, 32), (130, 32), (1, 32)])
def test_fused_attention_wrapper_counts_the_kernels_shared_memory(cuda_device, T, H):
    """The bytes the wrapper holds against the card's limit are those the
    built source computes for its own launch."""
    from shm_tpu_torch.ops import fused_attention

    assert (fused_attention._library().shm_fused_attention_smem_bytes(T, H)
            == fused_attention.shared_memory_bytes(T, H))


@pytest.mark.cuda
@pytest.mark.parametrize("T, H", [(137, 128), (512, 128), (209, 64), (269, 32)])
def test_fused_attention_long_body_bytes_are_the_wrappers(cuda_device, T, H):
    """The shared and device-memory bytes the wrapper plans for the long
    body are those the built source computes for its launch."""
    from shm_tpu_torch.ops import fused_attention

    lib = fused_attention._library()
    got = fused_attention.plan(T, H)
    assert got.body == "long"
    assert lib.shm_fused_attention_long_smem_bytes(H) == got.shared_bytes
    assert lib.shm_fused_attention_slot_floats(T, H) == got.slot_floats
    info = fused_attention.kernel_info(T, H)
    assert info["shared_bytes"] == got.shared_bytes and info["blocks_per_sm"] >= 1


# Row 7's bf16 resident body (every product on mma.sync m16n8k16 bf16,
# the scores and P.V too) against its plain bf16 version: phase 17's four
# cases (phase 2's shapes) and widths with M other than 4H, both softmax
# forms, float32 and bf16 io, through chip_smoke.py's bf16_kernel_vs_plain
# (BF16_GATE_TOL, each mean bar below the case's float32 gap); two launches
# bit for bit; the launch counted in bf16_launches and not in long_launches.
BF16_TC_CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual, mlp_ratio)
    "4dof_N1000": (1000, 100, 12, 16, 128, 2, True, True, 4),
    "openlab_L1_H64_T200": (300, 200, 3, 8, 64, 1, True, True, 4),
    "1dof_H32_noln": (300, 80, 12, 5, 32, 2, False, True, 4),
    "4dof_gate_only": (333, 100, 12, 16, 128, 2, True, False, 4),
    "H128_M256": (300, 100, 12, 16, 128, 2, True, True, 2),
    "H128_M768_T137": (300, 137, 12, 16, 128, 2, True, True, 6),
    "H64_M128": (300, 100, 3, 8, 64, 1, True, True, 2),
    "H32_M256_T269": (200, 269, 12, 5, 32, 2, True, True, 8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("io", ["f32", "bf16"])
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("name", list(BF16_TC_CASES))
def test_fused_attention_bf16_body_matches_plain_version(cuda_device, name, stream, io):
    from chip_smoke import bf16_kernel_vs_plain
    from shm_tpu_torch.ops.fused_attention import plan

    N, T, D, Zd, H, L, ln, wr, r = BF16_TC_CASES[name]
    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell="attention")
    rng = np.random.default_rng(len(name) + 7 * r)
    vae = vae_from_flax(random_flax_vae_params(rng, cfg, mlp_ratio=r), cfg)
    weights_fn, gate, _ = _gate("attention")
    w = weights_fn(vae.to(cuda_device), torch.bfloat16)
    Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).to(cuda_device)
    assert plan(T, H, torch.bfloat16).body == "resident"
    kw = dict(num_layers=L, use_layernorm=ln, with_residual=wr, stream=stream,
              mlp_ratio=r)
    iot = torch.bfloat16 if io == "bf16" else None
    before = (gate.bf16_launches, gate.long_launches)
    bf16_kernel_vs_plain(f"{name} stream={stream} io={io}", "attention", w, Z,
                         kw, iot)
    assert (gate.bf16_launches, gate.long_launches) == (before[0] + 1, before[1])
    a = gate(w, Z, dtype=torch.bfloat16, io_dtype=iot, **kw)
    b = gate(w, Z, dtype=torch.bfloat16, io_dtype=iot, **kw)
    assert torch.equal(a[0], b[0]) and (not wr or torch.equal(a[1], b[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("T, H", [(100, 128), (136, 128), (137, 128), (208, 128),
                                  (200, 64), (328, 64), (80, 32), (269, 32),
                                  (464, 32), (1, 32)])
def test_fused_attention_bf16_body_bytes_are_the_wrappers(cuda_device, T, H):
    """The bf16 resident body's shared memory as the built source counts it
    for its launch is the wrapper's mirror; the body fits the card there
    (one block of 512 threads an SM, no more spill than BF16_SPILL_GUARD), and
    the next step past each width's longest window takes the long body."""
    from shm_tpu_torch.ops import fused_attention as fa

    nbytes = fa.shared_memory_bytes(T, H, torch.bfloat16)
    assert fa._library().shm_fused_attention_smem_bytes_bf16(T, H) == nbytes
    assert fa.plan(T, H, torch.bfloat16) == ("resident", nbytes, 0)
    info = fa.kernel_info(T, H, dtype=torch.bfloat16)
    assert info["shared_bytes"] == nbytes and info["threads"] == 512
    assert info["blocks_per_sm"] >= 1
    assert info["registers"] <= 128 and info["spill_bytes"] <= BF16_SPILL_GUARD
    if (T, H) in ((208, 128), (328, 64), (464, 32)):
        assert fa.plan(T + 1, H, torch.bfloat16).body == "long"


# bytes of local memory (spills) a thread the bf16 resident body may use:
# ptxas reported 280-304 B for the versions measured at 128 registers a
# thread (PERF.md §6)
BF16_SPILL_GUARD = 320


# bytes of local memory (spills) a thread the attention kernel may use:
# ptxas reported 128-232 B for the versions measured (PERF.md §6)
SPILL_GUARD = 256


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 64, 128])
def test_fused_attention_packing_rounds_as_the_kernel(cuda_device, H):
    """The wrapper's TF32 split of the weights (plain PyTorch) equals the
    kernel's own cvt.rna.tf32.f32, bit for bit, big and small parts."""
    from shm_tpu_torch.ops.fused_attention import (
        tf32_round_on_card, unpack_fragments,
    )

    vae, _, _ = _gate_case("attention", (1, 8, 12, 16, H, 2, True, True),
                           cuda_device, H)
    w = _gate("attention")[0](vae)
    for k in [k for k in w if k.endswith("_frag")]:
        src = w[k[:-len("_frag")]]
        big, small = unpack_fragments(w[k])
        assert torch.equal(big, tf32_round_on_card(src))
        assert torch.equal(small, tf32_round_on_card((src - big).contiguous()))
    # the kernel splits its activations with integer operations: the same
    # bits as cvt.rna.tf32.f32 on wide-ranging values and on planted ties
    rng = np.random.default_rng(H)
    x = rng.normal(size=100_000) * np.exp(rng.uniform(-30, 30, size=100_000))
    ties = (rng.integers(0, 2 ** 31, size=1000) & ~0x1FFF | 0x1000).astype(np.uint32)
    x = torch.cat([torch.from_numpy(x.astype(np.float32)),
                   torch.from_numpy(ties.view(np.float32)).nan_to_num(0.0)]).to(cuda_device)
    assert torch.equal(tf32_round_on_card(x, exact=False), tf32_round_on_card(x))


@pytest.mark.cuda
@pytest.mark.parametrize("T, H", [(100, 128), (136, 128), (208, 64), (268, 32)])
def test_fused_attention_kernel_fits_the_card(cuda_device, T, H):
    """One block of 512 threads an SM at every width's longest window, its
    shared memory as the wrapper counts it. At 128 registers a thread the
    kernel spills a little outside its k loops (chip_smoke.py prints how
    much); SPILL_GUARD catches a change that spills far more."""
    from shm_tpu_torch.ops.fused_attention import kernel_info, shared_memory_bytes

    info = kernel_info(T, H)
    assert info["threads"] == 512 and info["blocks_per_sm"] >= 1
    assert info["shared_bytes"] == shared_memory_bytes(T, H)
    assert info["registers"] <= 128 and info["spill_bytes"] <= SPILL_GUARD


# bytes of local memory (spills) a thread the LSTM gate kernel may use:
# kernel_info reads 0 B at H=32 and 64 and 40 B at H=128 on an NVIDIA H100
# (PERF.md §6)
LSTM_SPILL_GUARD = 64


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 64, 128])
def test_fused_vae_kernel_fits_the_card(cuda_device, H):
    """At every width the shipping instance fits one block an SM at least,
    with 4H threads and a register file's share, and spills at most
    LSTM_SPILL_GUARD bytes."""
    from shm_tpu_torch.ops.fused_vae import kernel_info

    info = kernel_info(100, H, 2)
    assert info["threads"] == 4 * H and info["blocks_per_sm"] >= 1
    assert info["windows_per_block"] in (32, 64)
    assert 0 < info["shared_bytes"] <= 232448
    assert info["registers"] * info["threads"] <= 65536
    assert info["spill_bytes"] <= LSTM_SPILL_GUARD


# --- the minGRU gate's tensor-core body (ops/fused_mingru.py) --------------

# bytes of local memory (spills) a thread the minGRU gate kernel may use:
# kernel_info reads 0 B at H=32 and 64 and 32 B at H=128 on an NVIDIA H100
# (PERF.md §6)
MINGRU_SPILL_GUARD = 64


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 64, 128])
@pytest.mark.parametrize("L", [1, 2, 4])
def test_fused_mingru_kernel_fits_the_card(cuda_device, H, L):
    """At every width and depth the shipping instance fits one block an SM
    at least, with 4H threads and a register file's share, and spills at
    most MINGRU_SPILL_GUARD bytes."""
    from shm_tpu_torch.ops.fused_mingru import kernel_info

    info = kernel_info(100, H, L)
    assert info["threads"] == 4 * H and info["blocks_per_sm"] >= 1
    assert info["windows_per_block"] in (16, 32) and info["steps_per_tile"] in (1, 2, 4)
    assert 0 < info["shared_bytes"] <= 232448
    assert info["registers"] * info["threads"] <= 65536
    assert info["spill_bytes"] <= MINGRU_SPILL_GUARD


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 64, 128])
def test_gate_kernels_keep_their_bytes_and_fit_at_the_widest_inputs(cuda_device, H):
    """Every D <= 16 and Z <= 32 takes the bytes the fixed tiles had (the 4DOF
    preset's); at D = Z = 128 (minGRU at 4 layers) a block still fits the
    card's shared memory."""
    from shm_tpu_torch.ops import fused_mingru, fused_vae

    for mod, L in ((fused_vae, 2), (fused_mingru, 4)):
        base = mod.kernel_info(100, H, L)
        assert mod.kernel_info(100, H, L, D=16, Z=32) == base
        assert mod.kernel_info(100, H, L, D=3, Z=5) == base
        wide = mod.kernel_info(100, H, L, D=128, Z=128)
        assert base["shared_bytes"] < wide["shared_bytes"] <= 232448
        assert wide["blocks_per_sm"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("tc, mt", [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2)])
def test_fused_mingru_variant_tiles_match_plain_version(cuda_device, tc, mt):
    """Each tile of the variant entry (TC steps, MT m-tiles) against the
    plain version, T=61 cut by every TC; the shipping tile is the shipping
    kernel bit for bit."""
    from shm_tpu_torch.ops.fused_mingru import gate_variant, kernel_info

    weights_fn, gate, reference = _gate("min_gru")
    vae, Z, kw = _gate_case("min_gru", (77, 61, 12, 16, 128, 2, True, False),
                            cuda_device, 10 * tc + mt)
    w = weights_fn(vae)
    before, ship_before = gate_variant.launches, gate.launches
    mse = gate_variant(w, Z, num_layers=2, use_layernorm=True, tc=tc, mt=mt)
    torch.cuda.synchronize()
    assert gate_variant.launches == before + 1 and gate.launches == ship_before
    torch.testing.assert_close(mse, reference(w, Z, **kw)[0], atol=1e-4, rtol=1e-4)
    info = kernel_info(61, 128, 2)
    if (tc, mt) == (info["steps_per_tile"], info["windows_per_block"] // 16):
        assert torch.equal(mse, gate(w, Z, **kw)[0])


@pytest.fixture(scope="module")
def mingru_root_windows():
    """The minGRU root's kernel weights and the 3,636 committed 4DOF test
    windows normalized by its statistics, on the card, and their gate-only
    mse through the plain version."""
    from pathlib import Path

    from shm_tpu_torch.cli.stage4dof import Paths, build_fraction_windows
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.device import set_full_f32_precision
    from shm_tpu_torch.ops import fused_mingru_gate_reference, mingru_params_to_kernel_weights
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.utils.io import load_json

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    set_full_f32_precision()
    root = Path(__file__).resolve().parents[1] / "data"
    cfg = Stage4DofConfig()
    scorer = HybridScorer.from_artifacts(root / "4dof_mingru")
    splits = load_json(Paths(str(root / "4dof")).run_splits)
    W = np.concatenate([build_fraction_windows(splits[g]["files"], cfg.test_frac, cfg)
                        for g in ("normal", "sensor_fault", "structural_fault")])
    Z = normalize_windows(torch.from_numpy(W).cuda(), scorer.mean,
                          scorer.std).contiguous()
    w = mingru_params_to_kernel_weights(scorer.vae)
    kw = dict(num_layers=scorer.vae.num_layers,
              use_layernorm=scorer.vae.use_layernorm)
    return w, Z, kw, fused_mingru_gate_reference(w, Z, with_residual=False, **kw)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("tc_sum", ["split", "chain", "one_term"])
def test_fused_mingru_variant_sums_on_the_roots_windows(cuda_device, mingru_root_windows, tc_sum):
    """The variant entry's three sums on the minGRU root's real windows: each
    within the card's kernel tolerance of the plain version; the shipped sum
    within MINGRU_MSE_RTOL (relative mse) and the one-term sum, a planted
    fault, past it."""
    from chip_smoke import MINGRU_MSE_RTOL
    from shm_tpu_torch.ops.fused_mingru import gate_variant

    w, Z, kw, plain = mingru_root_windows
    mse = gate_variant(w, Z, tc_sum=tc_sum, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(mse, plain, atol=1e-4, rtol=1e-4)
    rel = float(((mse - plain).abs() / plain.abs()).max())
    if tc_sum == "one_term":
        assert rel > MINGRU_MSE_RTOL
    elif tc_sum == "split":
        assert rel <= MINGRU_MSE_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("cell, H, L", [("lstm", 128, 3), ("attention", 64, 3),
                                        ("attention", 256, 1), ("attention", 48, 1)])
def test_default_scorer_routes_a_preset_the_jax_rule_sends_to_xla(cuda_device, cell, H, L):
    """On the card the default follows the JAX package's rule: a preset it
    computes on XLA (any cell at 3 layers, attention at H not a multiple of
    32 or past 128) runs the plain modules, launches no gate kernel, and
    gives what the plain path gives; so does ``reconstruction_mse``."""
    from shm_tpu_torch.models import CNN4DOF, TemporalVAE
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.train import reconstruction_mse

    torch.manual_seed(0)
    vae, cnn = TemporalVAE(12, 16, H, L, cell=cell), CNN4DOF(2, 100, 12)
    W = np.random.default_rng(0).normal(size=(8, 100, 12)).astype(np.float32)
    gates = [_gate(c)[1] for c in ("lstm", "min_gru", "attention")]
    before = [(g.launches, g.bf16_launches) for g in gates]
    make = lambda fused: HybridScorer(vae, cnn, np.zeros(12), np.ones(12), 0.5,
                                      use_fused_vae=fused, min_bucket=8,
                                      max_batch=8)
    scorer = make(None)
    assert not scorer.use_fused_vae
    got, want = scorer.score(W), make(False).score(W)
    for k in ("mse", "anomalous", "y_pred"):
        np.testing.assert_array_equal(got[k], want[k])
    # cuDNN picks the CNN's algorithm per call (phase 11's bound)
    np.testing.assert_allclose(got["p_struct"], want["p_struct"], atol=1e-6)
    np.testing.assert_array_equal(reconstruction_mse(vae, W),
                                  reconstruction_mse(vae, W, fused=False))
    assert [(g.launches, g.bf16_launches) for g in gates] == before


@pytest.mark.cuda
def test_default_scorer_raises_past_the_ports_bound(cuda_device):
    """An LSTM of H=160 is inside the JAX kernel's reach, so the rule sends
    it to the port's kernel, which refuses it: the scorer raises and never
    runs the plain modules."""
    from shm_tpu_torch.models import CNN4DOF, TemporalVAE
    from shm_tpu_torch.serve import HybridScorer

    gate = _gate("lstm")[1]
    before = gate.launches
    with pytest.raises(ValueError, match="unsupported shape.*H=160"):
        scorer = HybridScorer(TemporalVAE(12, 16, 160, 2), CNN4DOF(2, 100, 12),
                              np.zeros(12), np.ones(12), 0.5, min_bucket=8,
                              max_batch=8)
        assert scorer.use_fused_vae
        scorer.score(np.zeros((8, 100, 12), np.float32))
    assert gate.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("root, kernel", [("4dof_mingru", "fused_mingru_gate"),
                                          ("4dof_attention", "fused_attention_gate")])
def test_scorer_launches_the_kernel_of_the_roots_cell(cuda_device, root, kernel):
    from pathlib import Path

    from shm_tpu_torch import ops
    from shm_tpu_torch.serve import HybridScorer

    art = Path(__file__).resolve().parents[1] / "data" / root
    scorer = HybridScorer.from_artifacts(art, min_bucket=64, max_batch=64)
    assert scorer.device.type == "cuda" and scorer.use_fused_vae
    gate = getattr(ops, kernel)
    before, lstm_before = gate.launches, ops.fused_vae_gate.launches
    rng = np.random.default_rng(0)
    W = (scorer.mean.cpu().numpy() + scorer.std.cpu().numpy()
         * rng.normal(size=(70, 100, 12))).astype(np.float32)
    out = scorer.score(W)
    assert gate.launches == before + 2            # 70 windows = 64 + 6 -> 2 buckets
    assert ops.fused_vae_gate.launches == lstm_before
    plain = HybridScorer.from_artifacts(art, min_bucket=64, max_batch=64,
                                        use_fused_vae=False).score(W)
    assert (out["anomalous"] == plain["anomalous"]).all()
    np.testing.assert_allclose(out["mse"], plain["mse"], rtol=1e-3)


# --- the three probe kernels (shm_tpu_torch/tools/probe_*.py)
#
# Kernel against plain version in the same numerics on the card. Float32
# paths (matmul_loop vpu, f32, bf16x3; the LSTM probe's float32 and
# bf16-weight variants) within atol/rtol 1e-4, as above. The bf16 paths
# store bf16 values whose last bit can flip when the two sum in another
# order; the recurrence carries a flip (one bf16 ulp, 2^-8) forward through
# a few elements, while a kernel with other numerics moves every element. So
# they are held on (max |diff| / max |plain|, mean |diff| / mean |plain|),
# the tolerances of chip_smoke.py's phase 9 (PROBE_TOL), which shows that
# each fails the planted faults.

GATE_TOL, GATE_ACT_BF16_TOL = (1e-4, 2e-6), (1e-4, 5e-6)
MATMUL_BF16_TOL, BF16X3_F32_TOL = (1e-2, 1e-3), (3e-4, 1e-4)


def _close_rel(got, want, tol):
    d, w = (got - want).abs().double(), want.abs().double()
    max_rel, mean_rel = float(d.max() / w.max()), float(d.mean() / w.mean())
    assert max_rel <= tol[0] and mean_rel <= tol[1], (max_rel, mean_rel, tol)


@pytest.mark.cuda
# 21 tiles: the TPU probe's, one wave of blocks; 34: more than one wave
@pytest.mark.parametrize("tiles, T", [(1, 100), (2, 7), (21, 100), (34, 100)])
@pytest.mark.parametrize("mode", ["vpu", "f32", "bf16", "bf16x3"])
def test_probe_matmul_loop_kernel_matches_plain_version(cuda_device, mode, tiles, T):
    from shm_tpu_torch.tools.probe_f32_cliff import (
        make_inputs, matmul_loop, matmul_loop_reference,
    )

    w, x = make_inputs(tiles, seed=tiles, device=cuda_device)
    before = matmul_loop.launches
    out = matmul_loop(w, x, mode, T=T)
    torch.cuda.synchronize()
    assert matmul_loop.launches == before + 1
    ref = matmul_loop_reference(w, x, mode, T=T)
    assert out.shape == (128, tiles * 256) and bool(torch.isfinite(out).all())
    if mode == "bf16":
        _close_rel(out, ref, MATMUL_BF16_TOL)
    else:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    if mode == "bf16x3":              # about float32 accuracy
        _close_rel(out, matmul_loop_reference(w, x, "f32", T=T), BF16X3_F32_TOL)


@pytest.mark.cuda
def test_probe_matmul_loop_split_sum_drifts_no_farther_than_chained(cuda_device):
    """bf16 on the card case's inputs (34 tiles, seed 34, T=100): the
    shipped sum (each k-step pair from zero, added to nearest) and the
    chained one (``tc="chain"``, the body before) each launch once; against
    float64 sums the split sum's mean relative error and its elements more
    than one bf16 ulp off are no more than the chained sum's, as the CPU
    model of the tensor cores' sums reads them
    (tests/test_torch_probe_bf16_sums.py)."""
    from chip_smoke import over_one_bf16_ulp
    from shm_tpu_torch.tools.probe_f32_cliff import (
        make_inputs, matmul_loop, matmul_loop_reference,
    )

    w, x = make_inputs(34, seed=34, device=cuda_device)
    f64 = matmul_loop_reference(w, x, "bf16", sum_dtype=torch.float64)
    before = matmul_loop.launches
    out = {tc: matmul_loop(w, x, "bf16", tc=tc) for tc in ("split", "chain")}
    torch.cuda.synchronize()
    assert matmul_loop.launches == before + 2
    assert not torch.equal(out["split"], out["chain"])
    mean = {tc: float((o - f64).abs().double().mean() / f64.abs().double().mean())
            for tc, o in out.items()}
    over = {tc: over_one_bf16_ulp(o, f64) for tc, o in out.items()}
    assert mean["split"] <= mean["chain"] and over["split"] <= over["chain"], (mean, over)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["vpu", "f32", "bf16", "bf16x3"])
def test_probe_matmul_loop_grid_is_the_python_mirror(cuda_device, mode):
    from shm_tpu_torch.tools.probe_f32_cliff import MODES, _library, matmul_loop_blocks

    lib, m = _library(), MODES.index(mode)
    for ncols in (256, 512, 21 * 256, 25 * 256, 34 * 256):
        assert lib.shm_probe_matmul_loop_blocks(ncols, m) == \
            matmul_loop_blocks(ncols, mode)
    assert lib.shm_probe_matmul_loop_blocks(200, m) == -1
    assert lib.shm_probe_matmul_loop_blocks(256, 4) == -1


def _probe_vae(cell, N, T, device, seed):
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=128, num_layers=2,
                    use_layernorm=True, cell=cell)
    rng = np.random.default_rng(seed)
    vae = vae_from_flax(random_flax_vae_params(rng, cfg), cfg).to(device)
    Z = torch.from_numpy(rng.normal(size=(N, T, 12)).astype(np.float32))
    return vae, Z.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["A_plain_knobs", "B_sig_via_tanh",
                                     "C_interleave2", "E_tanh_plus_il2",
                                     "F_tanh_bf16_act", "bf16_act_only",
                                     "W_bf16_weights", "G_f32_interleave2",
                                     "A_f32_fma", "T_tensor_cores",
                                     "TC_chained_sum", "T1_one_term"])
def test_probe_lstm_gate_kernel_matches_plain_version(cuda_device, variant):
    from shm_tpu_torch.ops import vae_params_to_kernel_weights
    from shm_tpu_torch.tools.probe_vpu_bound import (
        A_F32, PORT_VARIANTS, VARIANTS, gate_variant, gate_variant_reference,
    )

    kw = {**VARIANTS, **PORT_VARIANTS, "A_f32_fma": A_F32}.get(
        variant, dict(act_bf16=True) if variant == "bf16_act_only" else {})
    vae, Z = _probe_vae("lstm", 77, 40, cuda_device, len(variant))
    w = vae_params_to_kernel_weights(vae)
    before = gate_variant.launches
    mse = gate_variant(w, Z, **kw)
    torch.cuda.synchronize()
    assert gate_variant.launches == before + 1
    assert mse.shape == (77,) and bool(torch.isfinite(mse).all())
    ref = gate_variant_reference(w, Z, **kw)
    if kw.get("bf16", "all") == "all":
        _close_rel(mse, ref, GATE_ACT_BF16_TOL if kw.get("act_bf16") else GATE_TOL)
    else:                             # float32 operands
        torch.testing.assert_close(mse, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_probe_lstm_gate_float32_instance_is_the_shipping_kernel(cuda_device):
    """Variant T (the tensor-core body at float32 and the model's eps) is
    the shipping kernel bit for bit; the FMA instance A is held to the plain
    version in test_probe_lstm_gate_kernel_matches_plain_version."""
    from shm_tpu_torch.ops import fused_vae_gate, vae_params_to_kernel_weights
    from shm_tpu_torch.tools.probe_vpu_bound import (
        MODEL_LN_EPS, SHIP_TC, gate_variant,
    )

    vae, Z = _probe_vae("lstm", 77, 40, cuda_device, 3)
    w = vae_params_to_kernel_weights(vae)
    ship = fused_vae_gate(w, Z, num_layers=2, use_layernorm=True,
                          with_residual=False)[0]
    assert torch.equal(gate_variant(w, Z, bf16="none", ln_eps=MODEL_LN_EPS,
                                    tc=SHIP_TC), ship)


@pytest.mark.cuda
@pytest.mark.parametrize("loop_T", [None, 1, 5])
def test_probe_mingru_gate_kernel_matches_plain_version(cuda_device, loop_T):
    from shm_tpu_torch.ops import mingru_params_to_kernel_weights
    from shm_tpu_torch.tools.probe_mingru_recur import (
        make_gate, mingru_gate_reference,
    )

    vae, Z = _probe_vae("min_gru", 77, 30, cuda_device, 5)
    w = mingru_params_to_kernel_weights(vae)
    before = make_gate.launches
    mse = make_gate(loop_T)(w, Z)
    torch.cuda.synchronize()
    assert make_gate.launches == before + 1
    assert mse.shape == (77,) and bool(torch.isfinite(mse).all())
    _close_rel(mse, mingru_gate_reference(w, Z, loop_T), GATE_TOL)


# bytes of local memory (spills) a thread the minGRU probe kernel may use
PROBE_SPILL_GUARD = 64


@pytest.mark.cuda
def test_probe_mingru_gate_kernel_fits_the_card(cuda_device):
    """The tensor-core body fits one block of 512 threads (32 windows) an
    SM at least, in a register file's share, with its two 40 KiB stage
    buffers, and spills at most PROBE_SPILL_GUARD bytes."""
    from shm_tpu_torch.tools.probe_mingru_recur import kernel_info

    info = kernel_info()
    assert info["threads"] == 512 and info["windows_per_block"] == 32
    assert info["blocks_per_sm"] >= 1 and info["shared_bytes"] == 81920
    assert info["registers"] * info["threads"] <= 65536
    assert info["spill_bytes"] <= PROBE_SPILL_GUARD


@pytest.mark.cuda
def test_probe_kernels_refuse_bad_input(cuda_device):
    from shm_tpu_torch.ops import (
        mingru_params_to_kernel_weights, vae_params_to_kernel_weights,
    )
    from shm_tpu_torch.tools.probe_f32_cliff import make_inputs, matmul_loop
    from shm_tpu_torch.tools.probe_mingru_recur import make_gate
    from shm_tpu_torch.tools.probe_vpu_bound import gate_variant

    w, x = make_inputs(1, device=cuda_device)
    with pytest.raises(ValueError, match="x must be"):
        matmul_loop(w, x[:, :200].contiguous(), "f32")
    with pytest.raises(ValueError, match="mode must be"):
        matmul_loop(w, x, "tf32")
    cfg = VAEConfig(input_dim=12, latent_dim=4, hidden_dim=64, num_layers=2)
    vae = vae_from_flax(random_flax_vae_params(np.random.default_rng(0), cfg),
                        cfg).to(cuda_device)
    Z = torch.zeros(3, 10, 12, device=cuda_device)
    with pytest.raises(ValueError, match="unsupported shape"):
        gate_variant(vae_params_to_kernel_weights(vae), Z)
    vae, Z = _probe_vae("lstm", 3, 10, cuda_device, 0)
    with pytest.raises(ValueError, match="interleave"):
        gate_variant(vae_params_to_kernel_weights(vae), Z, interleave=3)
    with pytest.raises(ValueError, match="take bf16='all'"):
        gate_variant(vae_params_to_kernel_weights(vae), Z, bf16="none",
                     sig_via_tanh=True)
    vae, Z = _probe_vae("min_gru", 3, 10, cuda_device, 0)
    with pytest.raises(ValueError, match="loop_T"):
        make_gate(11)(mingru_params_to_kernel_weights(vae), Z)
    # the scratch of 1.1M windows (~88 GB) does not fit the card: refused
    # before any launch
    big = torch.empty(1_100_000, 100, 12, device=cuda_device)
    with pytest.raises(MemoryError, match="scratch"):
        make_gate(None)(mingru_params_to_kernel_weights(vae), big)


# --- the 4DOF commands on the card -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "min_gru", "attention"])
def test_threshold_command_runs_the_gate_only_kernel(cuda_device, tmp_path, cell):
    from chip_smoke import FAMILIES, chain_root, run_command
    from shm_tpu_torch.utils.io import load_json

    root, fam = chain_root(tmp_path, cell), FAMILIES[cell]
    # run_command fails on no launch of the family's kernel or any of another's
    n = run_command(cell, ["threshold", "--root", str(root), "--no-plots"],
                    "threshold")
    assert n == 1
    got = load_json(root / "processed" / "vae_threshold.json")
    want = load_json(ROOT_DIR / fam["root"] / "processed" / "vae_threshold.json")
    assert abs(got["threshold"] / want["threshold"] - 1) <= 1e-3
    assert got["n_val_windows_normal"] == 2010


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "min_gru", "attention"])
def test_test_pipeline_command_runs_the_residual_kernel(cuda_device, tmp_path, cell):
    from chip_smoke import FAMILIES, chain_root, check_pipeline, run_command

    root = chain_root(tmp_path, cell)
    run_command(cell, ["test-pipeline", "--root", str(root), "--no-plots"],
                "test-pipeline")
    check_pipeline(cell, root, ROOT_DIR / FAMILIES[cell]["root"], "test-pipeline")


@pytest.mark.cuda
def test_train_cnn_command_is_deterministic_on_the_card(cuda_device, tmp_path):
    """Two 3-epoch runs from one seed: the same losses and variables bit for
    bit, the CNN's inputs through the LSTM gate kernel's residual mode."""
    from shm_tpu_torch.cli.stage4dof import Paths, cmd_train_cnn
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.ops import fused_vae_gate

    from chip_smoke import chain_root

    root = chain_root(tmp_path, "lstm")
    runs = []
    for _ in range(2):
        before = fused_vae_gate.launches
        runs.append(cmd_train_cnn(Paths(str(root)), Stage4DofConfig(), epochs=3,
                                  plot=False))
        assert fused_vae_gate.launches - before == 2       # train and val inputs
    a, b = runs
    assert a.history == b.history and len(a.history["epoch"]) == 3
    assert np.isfinite(a.history["train_loss"]).all()
    assert all(torch.equal(v, b.variables[k]) for k, v in a.variables.items())
    assert (root / "models" / "cnn.msgpack").is_file()


@pytest.mark.cuda
def test_train_cnn_draws_the_same_on_the_card_as_on_the_cpu(cuda_device):
    """The trainer's generator lives on the CPU, so one seed gives the card
    the CPU's permutations and dropout masks: two epochs of the recipe on
    the same inputs end with train losses within 1e-4 relative (rounding;
    another stream's differ by percents) and the same best epoch."""
    from shm_tpu_torch.config import Stage4DofConfig, replace
    from shm_tpu_torch.models.cnn import CNN4DOF
    from shm_tpu_torch.train import train_cnn

    cfg = replace(Stage4DofConfig().cnn_train, epochs=2, seed=3)
    rng = np.random.default_rng(1)
    X = rng.normal(size=(450, 100, 12, 2)).astype(np.float32)
    y = rng.integers(0, 2, 450)
    X[y == 1, ..., 1] += 0.5                     # a signal to learn
    runs = [train_cnn(CNN4DOF(), X[:300], y[:300], X[300:], y[300:], cfg,
                      device=dev) for dev in ("cpu", cuda_device)]
    cpu, card = (r.history for r in runs)
    np.testing.assert_allclose(card["train_loss"], cpu["train_loss"], rtol=1e-4)
    assert runs[0].best_epoch == runs[1].best_epoch


@pytest.mark.cuda
def test_cnn_training_steps_on_the_card_match_the_cpu(cuda_device):
    """One epoch of the 4DOF recipe's steps (29 of batch 100, Adam lr 1e-4,
    cuDNN deterministic) on the card and on the CPU from the same init,
    batch order and dropout masks: the losses within 1e-5 relative, the
    parameters within 1e-5 (cuDNN and the CPU sum in other orders), BatchNorm's
    running variances within rtol 1e-5. The conv biases' exact gradient is 0
    (BatchNorm removes them), so their values are rounding noise under Adam:
    on each device every step's conv-bias gradient stays at rounding level
    (at most 2e-5 of its weight's largest gradient), and the running means
    are compared with that noise taken out, each step's bias times its
    weight in the running average subtracted (rtol 1e-5, atol 1e-5)."""
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.models.cnn import CNN4DOF
    from shm_tpu_torch.train.cnn import batch_loss, cross_entropy_loss
    from shm_tpu_torch.train.vae import make_optimizer

    cfg = Stage4DofConfig().cnn_train
    rng = np.random.default_rng(0)
    N, steps, bs = 600, 29, cfg.batch_size
    X = rng.normal(size=(N, 100, 12, 2)).astype(np.float32)
    X[..., 1] = 30.0 * X[..., 1] ** 2                # a squared residual's scale
    y = rng.integers(0, 2, N)
    X[y == 1, ..., 1] *= 1.5
    order = [rng.permutation(N)[:bs] for _ in range(steps)]
    masks = [rng.random((bs, 128)) < 0.5 for _ in range(steps)]
    init = CNN4DOF()
    init.init_parameters(torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", cuda_device):
        m = CNN4DOF().to(dev)
        m.load_state_dict(init.state_dict())
        m.train()
        opt = make_optimizer(m.parameters(), cfg)
        Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
        losses = []
        # sum_t 0.1 * 0.9^(steps-1-t) * b_t: the biases' share of the running mean
        bias_share = {c: torch.zeros_like(getattr(m, c).bias, dtype=torch.float64)
                      for c in ("conv1", "conv2")}
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            for o, mk in zip(order, masks):
                o = torch.from_numpy(o).to(dev)
                for c, v in bias_share.items():
                    v.mul_(0.9).add_(0.1 * getattr(m, c).bias.detach().double())
                opt.zero_grad()
                loss = batch_loss(m, Xd[o], yd[o], torch.ones(bs, device=dev),
                                  torch.from_numpy(mk).to(dev), cross_entropy_loss)
                loss.backward()
                for c in bias_share:
                    conv = getattr(m, c)
                    assert conv.bias.grad.abs().max() <= \
                        2e-5 * conv.weight.grad.abs().max(), (str(dev), c)
                opt.step()
                losses.append(float(loss.detach()))
        state = {k: v.detach().cpu().double() for k, v in m.state_dict().items()}
        for c, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            state[f"{bn}.running_mean"] -= bias_share[c].cpu()
        out[str(dev)] = (state, np.array(losses))
    (cpu, lc), (card, lg) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for k, v in cpu.items():
        if k in ("conv1.bias", "conv2.bias"):
            continue
        if k.endswith("running_mean"):
            torch.testing.assert_close(card[k], v, rtol=1e-5, atol=1e-5, msg=k)
        elif k.endswith("running_var"):
            torch.testing.assert_close(card[k], v, rtol=1e-5, atol=1e-6, msg=k)
        else:
            d = float((card[k] - v).abs().max())
            assert d <= 1e-5, (k, d)


# --- the gate kernels' activation forms and row 1's transposed residual ------
# Each non-default form launches the forms instance of its precision; it is
# held to its own plain form as the default instance is (float32: atol 1e-4 +
# rtol 1e-4; bf16: the relative mse bars of chip_smoke.py's BF16_GATE_TOL),
# moves its form's launch counter, and gives other mse bits than the default
# form wherever the plain forms' bits differ (the form gap is far inside the
# bar). The transposed residual is the NHWC
# one permuted, bit for bit, the mse the same bits.

LSTM_FORMS = [("exact", "exact"), ("tanh", "exact"), ("exact", "rational"),
              ("tanh", "rational")]
FORM_CASES = ["4dof_ragged", "openlab_L1_H64", "1dof_H32_noln", "gate_only"]
PRECISIONS = {"f32": (torch.float32, None), "bf16": (torch.bfloat16, None),
              "bf16_io": (torch.bfloat16, torch.bfloat16)}
FORM_COUNTERS = ("launches", "bf16_launches", "sigmoid_tanh_launches",
                 "tanh_rational_launches", "transposed_launches")


def _counts(gate):
    return {k: getattr(gate, k) for k in FORM_COUNTERS if hasattr(gate, k)}


def _moved(gate, before):
    return {k: v - before[k] for k, v in _counts(gate).items()}


def _want(gate, bf16, sigmoid_impl, tanh_impl="exact", transposed=False):
    want = dict(launches=int(not bf16), bf16_launches=int(bf16),
                sigmoid_tanh_launches=int(sigmoid_impl == "tanh"),
                tanh_rational_launches=int(tanh_impl == "rational"),
                transposed_launches=int(transposed))
    return {k: v for k, v in want.items() if hasattr(gate, k)}


def _other_bits_where_the_plain_forms_differ(gate, reference, w, Z, mse, mse_p,
                                             kw_default):
    """A launch that ignored its form would give the default form's bits:
    where the plain version's mse moves with the form, the kernel's must
    (in bf16 the rounding of h and y often hides the form on few windows,
    in the plain version too)."""
    if not torch.equal(mse_p, reference(w, Z, **kw_default)[0]):
        assert not torch.equal(mse, gate(w, Z, **kw_default)[0])


def _close_bf16(cell, mse, mse_p):
    from chip_smoke import BF16_GATE_TOL

    rel = (mse.double() - mse_p.double()).abs() / mse_p.double().abs()
    tmax, tmean, _ = BF16_GATE_TOL[cell]
    assert float(rel.max()) <= tmax and float(rel.mean()) <= tmean, (
        float(rel.max()), float(rel.mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("sigmoid_impl, tanh_impl", LSTM_FORMS[1:])
@pytest.mark.parametrize("name", FORM_CASES)
def test_fused_vae_kernel_forms_match_plain_version(cuda_device, name, sigmoid_impl, tanh_impl):
    vae, Z, kw = _gate_case("lstm", CASES[name], cuda_device, len(name))
    w = vae_params_to_kernel_weights(vae)
    kw = dict(kw, sigmoid_impl=sigmoid_impl, tanh_impl=tanh_impl)
    before = _counts(fused_vae_gate)
    mse, resid = fused_vae_gate(w, Z, **kw)
    torch.cuda.synchronize()
    assert _moved(fused_vae_gate, before) == _want(fused_vae_gate, False,
                                                   sigmoid_impl, tanh_impl)
    mse_p, resid_p = fused_vae_gate_reference(w, Z, **kw)
    torch.testing.assert_close(mse, mse_p, atol=1e-4, rtol=1e-4)
    if kw["with_residual"]:
        torch.testing.assert_close(resid, resid_p, atol=1e-4, rtol=1e-4)
    _other_bits_where_the_plain_forms_differ(
        fused_vae_gate, fused_vae_gate_reference, w, Z, mse, mse_p,
        dict(kw, sigmoid_impl="exact", tanh_impl="exact"))


@pytest.mark.cuda
@pytest.mark.parametrize("sigmoid_impl, tanh_impl", LSTM_FORMS)
@pytest.mark.parametrize("prec", ["bf16", "bf16_io"])
def test_fused_vae_bf16_kernel_forms_match_plain_version(cuda_device, prec, sigmoid_impl, tanh_impl):
    dtype, io = PRECISIONS[prec]
    vae, Z, kw = _gate_case("lstm", CASES["4dof_ragged"], cuda_device, 11)
    w = vae_params_to_kernel_weights(vae, torch.bfloat16)
    kw = dict(kw, sigmoid_impl=sigmoid_impl, tanh_impl=tanh_impl, dtype=dtype,
              io_dtype=io)
    before = _counts(fused_vae_gate)
    mse, _ = fused_vae_gate(w, Z, **kw)
    torch.cuda.synchronize()
    assert _moved(fused_vae_gate, before) == _want(fused_vae_gate, True,
                                                   sigmoid_impl, tanh_impl)
    mse_p = fused_vae_gate_reference(w, Z, **kw)[0]
    _close_bf16("lstm", mse, mse_p)
    if (sigmoid_impl, tanh_impl) != LSTM_FORMS[0]:
        _other_bits_where_the_plain_forms_differ(
            fused_vae_gate, fused_vae_gate_reference, w, Z, mse, mse_p,
            dict(kw, sigmoid_impl="exact", tanh_impl="exact"))


@pytest.mark.cuda
@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("name", ["4dof_ragged", "openlab_L1_H64", "mingru_L3",
                                  "mingru_T61_L4_H64"])
def test_fused_mingru_tanh_form_matches_plain_version(cuda_device, name, prec):
    dtype, io = PRECISIONS[prec]
    weights_fn, gate, reference = _gate("min_gru")
    case = {**GATE_CASES, **CASES, **MINGRU_CASES}[name]
    vae, Z, kw = _gate_case("min_gru", case, cuda_device, len(name))
    w = weights_fn(vae, dtype)
    kw = dict(kw, sigmoid_impl="tanh", dtype=dtype, io_dtype=io)
    before = _counts(gate)
    mse, resid = gate(w, Z, **kw)
    torch.cuda.synchronize()
    assert _moved(gate, before) == _want(gate, dtype == torch.bfloat16, "tanh")
    mse_p, resid_p = reference(w, Z, **kw)
    if dtype == torch.bfloat16:
        _close_bf16("min_gru", mse, mse_p)
    else:
        torch.testing.assert_close(mse, mse_p, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(resid, resid_p, atol=1e-4, rtol=1e-4)
    _other_bits_where_the_plain_forms_differ(gate, reference, w, Z, mse, mse_p,
                                             dict(kw, sigmoid_impl="exact"))


@pytest.mark.cuda
@pytest.mark.parametrize("forms", [("exact", "exact"), ("tanh", "rational")])
@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("name", ["4dof_ragged", "openlab_L1_H64", "4dof_N97",
                                  "gate_only"])
def test_fused_vae_transposed_residual_is_the_nhwc_one(cuda_device, name, prec, forms):
    from shm_tpu_torch.ops.fused_vae import padded_features

    dtype, io = PRECISIONS[prec]
    vae, Z, kw = _gate_case("lstm", CASES[name], cuda_device, len(name))
    w = vae_params_to_kernel_weights(vae, dtype)
    kw = dict(kw, dtype=dtype, io_dtype=io, sigmoid_impl=forms[0],
              tanh_impl=forms[1])
    mse, resid = fused_vae_gate(w, Z, **kw)
    before = _counts(fused_vae_gate)
    mse_t, resid_t = fused_vae_gate(w, Z, residual_layout="transposed", **kw)
    torch.cuda.synchronize()
    wr = kw["with_residual"]
    assert _moved(fused_vae_gate, before) == _want(
        fused_vae_gate, dtype == torch.bfloat16, *forms, transposed=wr)
    assert torch.equal(mse_t, mse)
    if not wr:
        assert resid is None and resid_t is None
        return
    N, T, D = Z.shape
    assert resid_t.shape == (T, padded_features(D), N)
    assert resid_t.dtype == resid.dtype == (io or torch.float32)
    assert torch.equal(resid_t[:, :D], resid.permute(1, 2, 0))
    assert not resid_t[:, D:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 64, 128])
def test_fused_vae_form_instances_fit_the_card(cuda_device, H):
    """Every instance (float32, bf16 with float32 and bf16 io; default and
    other forms) fits one block an SM and spills at most LSTM_SPILL_GUARD
    bytes; the default forms' float32 instance is the one kernel_info
    reports by default."""
    from shm_tpu_torch.ops.fused_vae import kernel_info

    assert kernel_info(100, H, 2) == kernel_info(100, H, 2, sigmoid_impl="exact")
    for dtype, io in PRECISIONS.values():
        for s, t in (("exact", "exact"), ("tanh", "rational")):
            info = kernel_info(100, H, 2, dtype=dtype, io_dtype=io,
                               sigmoid_impl=s, tanh_impl=t)
            assert info["threads"] == 4 * H and info["blocks_per_sm"] >= 1
            assert info["spill_bytes"] <= LSTM_SPILL_GUARD, (dtype, io, s, t, info)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [32, 64, 128])
def test_fused_mingru_form_instances_fit_the_card(cuda_device, H):
    from shm_tpu_torch.ops.fused_mingru import kernel_info

    assert kernel_info(100, H, 2) == kernel_info(100, H, 2, sigmoid_impl="exact")
    for dtype, io in PRECISIONS.values():
        for s in ("exact", "tanh"):
            info = kernel_info(100, H, 2, dtype=dtype, io_dtype=io, sigmoid_impl=s)
            assert info["threads"] == 4 * H and info["blocks_per_sm"] >= 1
            assert info["spill_bytes"] <= MINGRU_SPILL_GUARD, (dtype, io, s, info)


# --- row 7's MLP width and the plain modules' bf16 --------------------------
# Row 7 at each width of chip_smoke.py's P21_WIDTHS (M = 256 at H=32, 128 at
# H=64, 256 and 768 at H=128), in the resident body (T=100) and the long
# body (T=512), each softmax form: float32 within atol 1e-4 + rtol 1e-4 of
# its plain version, bf16 (float32 and bf16 io) within BF16_GATE_TOL's
# attention bars; a launch at M other than 4H moves `mlp_launches`. The bf16
# plain modules on the card against the same modules on the CPU: nearer them
# than the CPU's float32 modules are, their mse within chip_smoke.py's
# PLAIN_BF16_TOL of the CPU's.

MLP_WIDTHS = [(32, 8, 12, 5, 2), (64, 2, 3, 8, 1), (128, 2, 12, 16, 2),
              (128, 6, 12, 16, 2)]   # H, mlp_ratio, D, Z, L


@pytest.mark.cuda
@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("T", [100, 512])
@pytest.mark.parametrize("prec", list(PRECISIONS))
@pytest.mark.parametrize("H, r, D, Zd, L", MLP_WIDTHS)
def test_fused_attention_mlp_ratio_matches_plain_version(cuda_device, H, r, D, Zd, L,
                                                         prec, T, stream):
    from shm_tpu_torch.ops import (
        attention_params_to_kernel_weights, fused_attention_gate,
        fused_attention_gate_reference,
    )
    from shm_tpu_torch.ops.fused_attention import plan

    cfg = VAEConfig(input_dim=D, latent_dim=Zd, hidden_dim=H, num_layers=L,
                    cell="attention")
    rng = np.random.default_rng(H * r + T)
    vae = vae_from_flax(random_flax_vae_params(rng, cfg, mlp_ratio=r), cfg)
    assert vae.mlp_ratio == r
    dtype, io = PRECISIONS[prec]
    w = attention_params_to_kernel_weights(vae.to(cuda_device), dtype)
    Z = torch.from_numpy(rng.normal(size=(9, T, D)).astype(np.float32)).to(cuda_device)
    kw = dict(num_layers=L, use_layernorm=True, stream=stream, mlp_ratio=r,
              dtype=dtype, io_dtype=io)
    g = fused_attention_gate
    before = (g.mlp_launches, g.long_launches)
    mse, resid = g(w, Z, **kw)
    torch.cuda.synchronize()
    assert (g.mlp_launches, g.long_launches) == (
        before[0] + 1, before[1] + int(plan(T, H).body == "long"))
    mse_p, resid_p = fused_attention_gate_reference(w, Z, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(mse, mse_p, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(resid, resid_p, atol=1e-4, rtol=1e-4)
    else:
        assert resid.dtype == (io or torch.float32)
        _close_bf16("attention", mse, mse_p)


def _cpu_and_card(module, x):
    """``module``'s float32 output on the CPU and on the card."""
    with torch.no_grad():
        cpu = module.cpu()(x)
        card = module.cuda()(x.cuda())
    pick = lambda o: (o[0] if isinstance(o, tuple) else o).float().cpu()
    return pick(cpu), pick(card)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lstm", "min_gru", "attention"])
def test_bf16_plain_vae_on_the_card_matches_the_cpu(cuda_device, cell):
    from dataclasses import replace

    from chip_smoke import FAMILIES, PLAIN_BF16_TOL
    from shm_tpu_torch.cli.stage4dof import Paths, _load_vae
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.tools.workload import load_trained_workload

    cfg = Stage4DofConfig()
    root = ROOT_DIR / FAMILIES[cell]["root"]
    f32 = _load_vae(Paths(str(root)), cfg)
    bf16 = vae_from_config(replace(cfg.vae, cell=cell), torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    wl = load_trained_workload(ROOT_DIR / "data/4dof")
    x = torch.from_numpy(((wl.W[::57][:64] - wl.mean) / wl.std).astype(np.float32))
    cpu, card = _cpu_and_card(bf16, x)
    ref32, _ = _cpu_and_card(f32.eval(), x)
    assert (card - cpu).abs().mean() < (ref32 - cpu).abs().mean()
    mse = lambda r: ((x - r) ** 2).mean(dim=(1, 2)).double()
    rel = (mse(card) - mse(cpu)).abs() / mse(cpu)
    tmax, tmean = PLAIN_BF16_TOL[cell]
    assert float(rel.max()) <= tmax and float(rel.mean()) <= tmean
    assert all(p.dtype == torch.float32 for p in bf16.parameters())


@pytest.mark.cuda
def test_bf16_cnn_openlab_on_the_card_matches_the_cpu(cuda_device):
    from chip_smoke import PLAIN_BF16_TOL
    from shm_tpu_torch.convert import cnn_openlab_from_flax
    from shm_tpu_torch.models.cnn import CNNOpenLab
    from shm_tpu_torch.utils.checkpoint import load_checkpoint

    art = ROOT_DIR / "data/openlab/output/CNN_Training/artifacts"
    f32 = cnn_openlab_from_flax(load_checkpoint(art / "cnn_model_openlab.msgpack"))
    bf16 = CNNOpenLab(f32.num_classes, f32.dropout, dtype=torch.bfloat16).eval()
    bf16.load_state_dict(f32.state_dict())
    x = torch.from_numpy(np.random.default_rng(21).normal(
        size=(64, 200, 4, 1)).astype(np.float32))
    cpu, card = _cpu_and_card(bf16, x)
    ref32, _ = _cpu_and_card(f32, x)
    assert (card - cpu).abs().mean() < (ref32 - cpu).abs().mean()
    p = lambda logits: torch.softmax(logits, dim=1)[:, 1].double()
    tmax, tmean = PLAIN_BF16_TOL["cnn_openlab"]
    d = (p(card) - p(cpu)).abs()
    assert float(d.max()) <= tmax and float(d.mean()) <= tmean
