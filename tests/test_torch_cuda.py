"""Tests of the port's CUDA kernels; they need the card and skip without one.

Run them on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no JAX, so it also runs where only PyTorch is installed.
Kernel against plain version: both float32 on the card, summed in other
orders through a 2*L*T-step recurrence (or, for the attention gate, through
four transformer blocks), so within atol 1e-4 + rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import (
    fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
)

CASES = {  # name: (N, T, D, Z, H, L, layernorm, with_residual)
    "4dof_ragged": (77, 100, 12, 16, 128, 2, True, True),
    "openlab_L1_H64": (40, 200, 3, 8, 64, 1, True, True),
    "1dof_H32_noln": (33, 80, 12, 5, 32, 2, False, True),
    "gate_only": (50, 30, 12, 16, 128, 2, True, False),
    # ragged against 32 and 64 windows a block: 1 and 33 windows in the last
    "4dof_N97": (97, 100, 12, 16, 128, 2, True, True),
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
    cfg = VAEConfig(input_dim=12, latent_dim=4, hidden_dim=48, num_layers=1)
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
    from shm_tpu_torch.ops import lstm2_enc_last

    H = 48
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
    from shm_tpu_torch.ops.lstm_train import dec_forward_cuda, enc_forward_cuda

    (T, D, H, B), rng, t, u, ws, dm = _lstm_inputs(name, cuda_device)
    xs = t(rng.normal(size=(T, D, B)))
    din = t(rng.normal(size=(H, B)))
    dec_w = [u(4 * H, H)] + ws[1:] + [u(D, H), u(D, 1)]
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
    with pytest.raises(ValueError, match="contiguous float32"):
        gate(w, Z.transpose(0, 1), **kw)
    with pytest.raises(ValueError, match="contiguous float32"):
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
    from shm_tpu_torch.ops import (
        attention_params_to_kernel_weights, fused_attention_gate,
    )

    vae, Z, kw = _gate_case("attention", (2, 400, 12, 16, 128, 2, True, True),
                            cuda_device, 5)
    before = fused_attention_gate.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_attention_gate(attention_params_to_kernel_weights(vae), Z, **kw)
    assert fused_attention_gate.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("T, H", [(100, 128), (200, 64), (80, 32), (130, 32), (1, 32)])
def test_fused_attention_wrapper_counts_the_kernels_shared_memory(cuda_device, T, H):
    """The bytes the wrapper holds against the card's limit are those the
    built source computes for its own launch."""
    from shm_tpu_torch.ops import fused_attention

    assert (fused_attention._library().shm_fused_attention_smem_bytes(T, H)
            == fused_attention.shared_memory_bytes(T, H))


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
                                        ("attention", 256, 1)])
def test_default_scorer_raises_for_a_preset_the_kernel_does_not_take(cuda_device, cell, H, L):
    """On the card the default is the fused gate for every model: a preset
    the cell's kernel does not take raises, it never runs the plain modules."""
    from shm_tpu_torch.models import CNN4DOF, TemporalVAE
    from shm_tpu_torch.serve import HybridScorer

    gate = _gate(cell)[1]
    before = gate.launches
    with pytest.raises(ValueError, match="layer|unsupported shape"):
        scorer = HybridScorer(TemporalVAE(12, 16, H, L, cell=cell),
                              CNN4DOF(2, 100, 12), np.zeros(12), np.ones(12),
                              0.5, min_bucket=8, max_batch=8)
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
@pytest.mark.parametrize("tiles, T", [(1, 100), (2, 7)])
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
