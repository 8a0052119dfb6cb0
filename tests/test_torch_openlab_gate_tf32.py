"""The gates' 3xTF32 sums at the openLAB shape, emulated on the CPU.

Row 1, the fused LSTM gate at T=200, D=3, H=64, Z=8, one layer with
LayerNorm, on the committed ``data/openlab`` VAE and 512 test windows spread
over the 2,042 (both sides of the gate): the CPU model of the kernel's sums
(``tests/test_torch_vae_gate_tf32.py::emulated_gate``) keeps every gate
decision and stays within ``chip_smoke.OPENLAB_MSE_RTOL`` of the plain
version with the shipped pair-wise sum, while one TF32 term fails it.

Row 7, the attention gate at T=200, H=64, one layer, on the committed
``data/openlab_attention`` VAE and 128 of those test windows:
:func:`emulated_attention_gate` (every k-step's three TF32 products chained
into the float32 accumulator, as ``fused_attention.cu::mma_kstep`` adds
them) stays within ``chip_smoke.OPENLAB_ATTENTION_MSE_RTOL`` and keeps the
gate decisions; one TF32 term fails it.

Row 6, the minGRU gate at the same shape, on a seeded VAE of the openLAB
widths and 256 of those windows (the chain that launches it on the card
trains its own weights): ``tests/test_torch_mingru_gate_tf32.py::
emulated_gate`` stays within ``chip_smoke.OPENLAB_MINGRU_MSE_RTOL``; one
TF32 term fails it.

``tests/openlab_readings.py gate-sums`` reads the three models over all the
test and val windows, each also against a float64 pass of the model.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import (OPENLAB_ATTENTION_MSE_RTOL, OPENLAB_MINGRU_MSE_RTOL,
                        OPENLAB_MSE_RTOL)
from shm_tpu_torch.cli import openlab as ol
from shm_tpu_torch.config import OpenLabConfig, VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.models.attention import (
    HEAD_DIM, STACK_LN_EPS, flax_layer_norm, sinusoidal_positions,
)
from shm_tpu_torch.ops import (
    attention_params_to_kernel_weights, fused_attention_gate_reference,
    fused_mingru_gate_reference, fused_vae_gate_reference,
    mingru_params_to_kernel_weights, vae_params_to_kernel_weights,
)
from shm_tpu_torch.ops._gate import tf32_round
from shm_tpu_torch.ops.fused_attention import attend, softmax_form
from test_torch_mingru_gate_tf32 import emulated_gate as emulated_mingru_gate
from test_torch_vae_gate_tf32 import _k_blocks, _truncate, emulated_gate

torch.set_num_threads(1)
OL = Path(__file__).resolve().parents[1] / "data" / "openlab"
OL_ATTENTION = OL.parent / "openlab_attention"
THR_REL = "output/VAE_Validation_and_Thresholding/artifacts/vae_threshold.json"
CHUNK = 4096          # rows of A a float64 block sum holds at once


def windows(split: str, n=None, root: Path = OL):
    """``root``'s VAE, its gate weights' source, and the standardized
    ``split`` windows of ``data/openlab`` (``n`` of them spread evenly, or
    all), with the committed threshold."""
    cfg = OpenLabConfig()
    vae, mu, sd, man = ol._load_openlab_vae(ol.Paths(str(root)), cfg)
    Xc, _, meta = ol._load_extracted(ol.Paths(str(OL)))
    runs = json.loads((OL / "extracted/run_split.json").read_text())[f"{split}_runs"]
    idx = np.flatnonzero(ol._in_runs(meta, runs))
    if n is not None:
        idx = idx[np.linspace(0, len(idx) - 1, n).astype(int)]
    Z = torch.from_numpy(ol.standardize_clip(Xc[idx][:, :, man["channels_idx"]],
                                             mu, sd, cfg.standardize_clip))
    thr = json.loads((root / THR_REL).read_text())["threshold"]
    return vae, Z, np.float32(thr)


def tc3_product(a: torch.Tensor, w: torch.Tensor, tc_sum: str = "chain") -> torch.Tensor:
    """a @ w (float32 [M, K] x [K, N], K a multiple of 8) as the attention
    kernel sums it on the tensor cores: from zero, k-step by k-step (8 k
    each), a_s b_b, a_b b_s, then a_b b_b chained into one float32
    accumulator (TF32 parts of the operands; the accumulation truncates, as
    ``tc_product`` models it). ``tc_sum="one_term"`` (a planted fault)
    chains a_b b_b alone."""
    KT = a.shape[1] // 8
    wb = tf32_round(w)
    w_s = tf32_round(w - wb)
    out = []
    for a_ in a.split(CHUNK):
        ab = tf32_round(a_)
        big = _k_blocks([(ab, wb)], KT)
        acc = torch.zeros(big.shape[1:], dtype=torch.float64)
        if tc_sum == "one_term":
            for p in big:
                acc = _truncate(acc + p)
        else:
            a_s = tf32_round(a_ - ab)
            sb, bs = _k_blocks([(a_s, wb)], KT), _k_blocks([(ab, w_s)], KT)
            for k in range(KT):
                for p in (sb[k], bs[k], big[k]):
                    acc = _truncate(acc + p)
        out.append(acc.float())
    return torch.cat(out)


def emulated_attention_gate(weights, Z, *, num_layers, use_layernorm,
                            tc_sum="chain"):
    """``fused_attention_gate_reference``'s function (gate-only mse [N])
    with its four weight products summed as the kernel sums them
    (:func:`tc3_product`), in the kernel's pieces: q | k | v with their bias
    after the product, the output projection head by head into the stream
    (its bias with the first head), the MLP's hidden layer in chunks of 128
    columns, each chunk's second product into the stream (its bias with the
    first chunk). Scores, softmax (in the form the kernel takes by default:
    streaming at T=200), P.V, the norms and the heads stay in float32, as in
    the kernel."""
    N, T, D = Z.shape
    H = weights["mu_w"].shape[0]
    heads = H // HEAD_DIM
    pos = sinusoidal_positions(T, H, Z.device)
    w = weights

    def mm(a, k, rows=None, cols=None):
        wk = w[k]
        wk = wk[rows] if rows is not None else wk
        wk = wk[:, cols] if cols is not None else wk
        return tc3_product(a.reshape(-1, a.shape[-1]), wk.contiguous(),
                           tc_sum).view(*a.shape[:-1], -1)

    def block(s, p):
        nrm = flax_layer_norm(s, w[f"{p}_ln1_s"], w[f"{p}_ln1_b"], STACK_LN_EPS)
        qkv = (mm(nrm, f"{p}_wqkv") + w[f"{p}_bqkv"]).view(N, T, heads, 3, HEAD_DIM)
        q, k, v = (qkv[:, :, :, i].transpose(1, 2) for i in range(3))
        o = attend(q, k, v, softmax_form(None, T), lambda t: t)  # [N, h, T, hd]
        for h in range(heads):
            d = mm(o[:, h], f"{p}_wo", rows=slice(h * HEAD_DIM, (h + 1) * HEAD_DIM))
            s = s + (d + w[f"{p}_bo"] if h == 0 else d)
        nrm = flax_layer_norm(s, w[f"{p}_ln2_s"], w[f"{p}_ln2_b"], STACK_LN_EPS)
        for c0 in range(0, 4 * H, 128):
            c = slice(c0, c0 + 128)
            h1 = F.gelu(mm(nrm, f"{p}_w1", cols=c) + w[f"{p}_b1"][c],
                        approximate="tanh")
            d = mm(h1, f"{p}_w2", rows=c)
            s = s + (d + w[f"{p}_b2"] if c0 == 0 else d)
        return s

    def stack(tok, p):
        s = tok + pos
        for l in range(num_layers):
            s = block(s, f"{p}{l}")
        return flax_layer_norm(s, w[f"{p}_fn_s"], w[f"{p}_fn_b"], STACK_LN_EPS)

    pooled = stack(Z @ w["enc_in_w"] + w["enc_in_b"], "enc").mean(dim=1)
    if use_layernorm:
        pooled = flax_layer_norm(pooled, w["ln_scale"], w["ln_bias"], 1e-5)
    mu = pooled @ w["mu_w"] + w["mu_b"]
    h0 = torch.tanh(mu @ w["z2h_w"] + w["z2h_b"])
    tok0 = h0 @ w["dec_in_w"] + w["dec_in_b"]
    out = stack(tok0[:, None, :], "dec")
    return ((Z - (out @ w["out_w"] + w["out_b"])) ** 2).sum(dim=(1, 2)) / (T * D)


def openlab_mingru_vae(seed: int = 0):
    """A seeded minGRU VAE of the openLAB widths (D=3, H=64, Z=8, one layer
    with LayerNorm)."""
    v = OpenLabConfig().vae
    cfg = VAEConfig(input_dim=3, latent_dim=v.latent_dim, hidden_dim=v.hidden_dim,
                    num_layers=v.num_layers, use_layernorm=v.use_layernorm,
                    cell="min_gru")
    return vae_from_flax(random_flax_vae_params(np.random.default_rng(seed), cfg), cfg)


def rel(got, want) -> float:
    return float(((got - want).abs() / want.abs()).max())


@pytest.fixture(scope="module")
def gate():
    vae, Z, thr = windows("test", 512)
    w = vae_params_to_kernel_weights(vae)
    with torch.no_grad():
        plain = fused_vae_gate_reference(w, Z, num_layers=1, use_layernorm=True,
                                         with_residual=False)[0]
    return w, Z, plain, thr


@pytest.mark.parametrize("tc_sum,passes", [("split", True), ("one_term", False)])
def test_emulated_sums_against_the_bound(gate, tc_sum, passes):
    w, Z, plain, thr = gate
    with torch.no_grad():
        got = emulated_gate(w, Z, num_layers=1, use_layernorm=True, tc_sum=tc_sum)
    assert (rel(got, plain) <= OPENLAB_MSE_RTOL) is passes, rel(got, plain)
    if passes:
        assert torch.equal(got > float(thr), plain > float(thr))
        assert 0 < int((plain > float(thr)).sum()) < len(plain)


@pytest.fixture(scope="module")
def attention_gate():
    vae, Z, thr = windows("test", 128, OL_ATTENTION)
    w = attention_params_to_kernel_weights(vae)
    with torch.no_grad():
        plain = fused_attention_gate_reference(w, Z, num_layers=1, use_layernorm=True,
                                               with_residual=False)[0]
    return w, Z, plain, thr


@pytest.mark.parametrize("tc_sum,passes", [("chain", True), ("one_term", False)])
def test_attention_emulated_sums_against_the_bound(attention_gate, tc_sum, passes):
    w, Z, plain, thr = attention_gate
    with torch.no_grad():
        got = emulated_attention_gate(w, Z, num_layers=1, use_layernorm=True,
                                      tc_sum=tc_sum)
    assert (rel(got, plain) <= OPENLAB_ATTENTION_MSE_RTOL) is passes, rel(got, plain)
    if passes:
        assert torch.equal(got > float(thr), plain > float(thr))
        assert 0 < int((plain > float(thr)).sum()) < len(plain)


def test_attention_emulation_on_tf32_operands_is_the_plain_gate():
    """With every product's operands already TF32 values, the small parts
    are zero and each k-step adds one exact product: the emulation then
    differs from the plain version by float32 reorderings only."""
    vae, Z, _ = windows("test", 8, OL_ATTENTION)
    w = {k: (tf32_round(v) if k.rsplit("_", 1)[-1] in ("wqkv", "wo", "w1", "w2")
             else v) for k, v in attention_params_to_kernel_weights(vae).items()}
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    exact = tf32_round(a).double() @ w["enc0_w1"].double()
    assert float((tc3_product(tf32_round(a), w["enc0_w1"]).double() - exact).abs().max()
                 / exact.abs().max()) < 1e-6
    with torch.no_grad():
        plain = fused_attention_gate_reference(w, Z, num_layers=1, use_layernorm=True,
                                               with_residual=False)[0]
        got = emulated_attention_gate(w, Z, num_layers=1, use_layernorm=True)
    assert rel(got, plain) < 1e-5


@pytest.mark.parametrize("tc_sum,passes", [("split", True), ("one_term", False)])
def test_mingru_emulated_sums_against_the_bound(tc_sum, passes):
    vae = openlab_mingru_vae()
    _, Z, _ = windows("val", 256)
    w = mingru_params_to_kernel_weights(vae)
    with torch.no_grad():
        plain = fused_mingru_gate_reference(w, Z, num_layers=1, use_layernorm=True,
                                            with_residual=False)[0]
        got = emulated_mingru_gate(w, Z, num_layers=1, use_layernorm=True,
                                   tc_sum=tc_sum)
    assert (rel(got, plain) <= OPENLAB_MINGRU_MSE_RTOL) is passes, rel(got, plain)
