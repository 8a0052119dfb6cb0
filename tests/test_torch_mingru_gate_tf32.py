"""The minGRU gate's 3xTF32 products, emulated on the CPU.

The fused minGRU gate kernel (``ops/csrc/fused_mingru.cu``) runs every gate
product of both stacks on the tensor cores in 3xTF32, as the LSTM gate does
(``tests/test_torch_vae_gate_tf32.py``): each operand split into a TF32 big
part and a TF32 small part, a * b = a_s b_b + a_b b_s + a_b b_b, each pair
of k-steps' mma summed from zero and added to the float32 sum. It reads the
``w_ih`` as fragments that ``mingru_params_to_kernel_weights`` packs once.

These tests hold the packing (shapes, zero K padding, the parts restoring
the weights, the C entry's pointer order), and the numerics: the plain gate
with every gate product summed as the kernel sums it (bias first, then the
k-step pairs, with ``tc_product``'s model of the tensor cores' truncating
accumulation), built here and on no main path, run on the committed
``data/4dof_mingru`` artifacts against the port's float32 plain version and
the JAX package's float32 Pallas kernel (in interpret mode, as
``tests/test_torch_mingru_gate.py`` runs it). It must keep every gate
decision, the card's kernel tolerance and ``MINGRU_MSE_RTOL``; a one-term
TF32 product (a_b b_b alone) must fail ``MINGRU_MSE_RTOL``.

``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_mingru_gate_tf32.py``
runs the same emulation over all 3,636 committed test windows, with each of
the kernel's three sums, and prints what it finds.
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import ATOL, MINGRU_MSE_RTOL, RTOL
from shm_tpu.ops import fused_mingru_gate as jax_fused_mingru_gate
from shm_tpu_torch.cli.stage4dof import Paths, build_fraction_windows
from shm_tpu_torch.config import Stage4DofConfig, VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.data.windows import normalize_windows
from shm_tpu_torch.ops import (
    fused_mingru_gate_reference, mingru_params_to_kernel_weights,
)
from shm_tpu_torch.ops import fused_mingru as fused_mingru_mod
from shm_tpu_torch.ops._gate import tf32_round, unpack_fragments
from shm_tpu_torch.serve import HybridScorer
from shm_tpu_torch.utils.io import load_json
# the model of the kernel's 3xTF32 sums, shared with the LSTM gate's test
from test_torch_vae_gate_tf32 import tc_product

ROOT = Path(__file__).resolve().parents[1]
MINGRU_ROOT = ROOT / "data" / "4dof_mingru"

torch.set_num_threads(1)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _weights(D, H, L, seed=0):
    cfg = VAEConfig(input_dim=D, latent_dim=16, hidden_dim=H, num_layers=L,
                    use_layernorm=True, cell="min_gru")
    rng = np.random.default_rng(seed)
    return mingru_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(rng, cfg), cfg))


# --- the packed fragments

@pytest.mark.parametrize("D, H, L", [(12, 32, 2), (12, 64, 3), (12, 128, 2),
                                     (3, 64, 1), (3, 128, 4)])
def test_each_wih_comes_as_fragments_that_restore_it(D, H, L):
    """[2H/8 n-tiles, ceil(K/8) k-steps, 32 lanes, 4] for each [K, 2H] w_ih;
    the rows past K (D=12 -> 16, D=3 -> 8) are zero in both parts; big +
    small is w within 2^-22 |w|, big is tf32_round(w), and both parts have
    their low 13 bits zero (the tensor cores ignore those bits)."""
    w = _weights(D, H, L, seed=H + D)
    names = [f"{p}{l}_wih" for p in ("enc", "dec") for l in range(L)]
    assert sorted(k for k in w if k.endswith("_frag")) == sorted(
        f"{k}_frag" for k in names)
    for k in names:
        src, frag = w[k], w[f"{k}_frag"]
        K = src.shape[0]
        KP = -(-K // 8) * 8
        assert K == (D if k == "enc0_wih" else H)
        assert frag.shape == (2 * H // 8, KP // 8, 32, 4) and frag.is_contiguous()
        assert frag.dtype == torch.float32
        big, small = unpack_fragments(frag)
        assert big.shape == (KP, 2 * H)
        assert not bool(big[K:].any()) and not bool(small[K:].any())
        big, small = big[:K], small[:K]
        assert torch.equal(big, tf32_round(src))
        assert not bool((_bits(big) & 0x1FFF).any())
        assert not bool((_bits(small) & 0x1FFF).any())
        err = (big.double() + small.double() - src.double()).abs()
        assert bool((err <= 2.0 ** -22 * src.double().abs()).all())


def test_the_c_entry_takes_the_pointers_in_the_wrappers_order():
    """NUM_W of the source is the length of ``_WEIGHT_ORDER``, and the
    pointers ``unpack_weights`` reads sit where the wrapper puts them."""
    src = (ROOT / "shm_tpu_torch" / "ops" / "csrc" / "fused_mingru.cu").read_text()
    order = fused_mingru_mod._WEIGHT_ORDER
    LMAX = int(re.search(r"constexpr int LMAX = (\d+);", src).group(1))
    num_w = re.search(r"constexpr int NUM_W = (.+?);", src).group(1)
    assert eval(num_w, {"LMAX": LMAX}) == len(order) == 32
    found = dict(re.findall(r"W\.(\w+(?:\[l\])?) = (?:reinterpret_cast<const "
                            r"float4\*>\()?p\[([^\]]+)\]", src))
    assert len(found) == 12
    for field, index in found.items():
        for l in range(LMAX if "[l]" in field else 1):
            i = eval(index, {"LMAX": LMAX, "l": l})
            name = field.replace("[l]", "")
            want = {"enc_b": f"enc{l}_b", "dec_b": f"dec{l}_b",
                    "enc_f": f"enc{l}_wih_frag", "dec_f": f"dec{l}_wih_frag"}
            assert order[i] == want.get(name, name)


def test_check_names_missing_or_misshapen_fragments():
    w = _weights(12, 32, 1)
    Z = torch.zeros(2, 9, 12)
    missing = {k: v for k, v in w.items() if not k.endswith("_frag")}
    with pytest.raises(ValueError, match="weights missing: enc0_wih_frag"):
        fused_mingru_mod._check(missing, Z, 1, True)
    bad = dict(w, dec0_wih_frag=w["enc0_wih_frag"])
    with pytest.raises(ValueError, match=r"dec0_wih_frag .* not the fragments of a \[32, 64\]"):
        fused_mingru_mod._check(bad, Z, 1, True)


# --- the gate with emulated TF32 products

def emulated_gate(weights, Z, *, num_layers, use_layernorm, tc_sum="split",
                  steps=10):
    """``fused_mingru_gate_reference``'s function (gate-only mse [N]) with
    every gate product summed as the kernel sums it (``tc_product``): the
    bias first, then the k-step pairs; the decoder's layer 0 once. The
    sweeps, LayerNorm, the latent and output heads stay in float32, as in
    the kernel. Products run ``steps`` steps of every window at a time."""
    N, T, D = Z.shape
    H = weights["mu_w"].shape[0]
    sweep = fused_mingru_mod._sweep

    def gates(prefix, l, inp):                 # inp [M, K] -> [M, 2H]
        b = weights[f"{prefix}{l}_b"].expand(inp.shape[0], -1)
        return tc_product(b, inp, weights[f"{prefix}{l}_wih"], tc_sum)

    def layer(prefix, l, seq):                 # [N, T, K] -> [N, T, H]
        g = torch.cat([gates(prefix, l, seq[:, t:t + steps].reshape(-1, seq.shape[2]))
                       .view(N, -1, 2 * H) for t in range(0, T, steps)], dim=1)
        return sweep(torch.sigmoid(g[..., :H]), g[..., H:], T)

    seq = Z
    for l in range(num_layers):
        seq = layer("enc", l, seq)
    h_last = seq[:, -1]
    if use_layernorm:
        h_last = F.layer_norm(h_last, (H,), weights["ln_scale"],
                              weights["ln_bias"], eps=1e-5)
    mu = h_last @ weights["mu_w"] + weights["mu_b"]
    dec_in = torch.tanh(mu @ weights["z2h_w"] + weights["z2h_b"])
    g0 = gates("dec", 0, dec_in)               # constant input: once
    seq = sweep(torch.sigmoid(g0[:, :H]), g0[:, H:], T)
    for l in range(1, num_layers):
        seq = layer("dec", l, seq)
    y = seq @ weights["out_w"] + weights["out_b"]
    return ((Z - y) ** 2).sum(dim=(1, 2)) / (T * D)


@pytest.mark.parametrize("L, use_layernorm", [(1, False), (2, True), (3, True)])
def test_emulated_gate_is_the_plain_gate_on_tf32_operands(L, use_layernorm):
    """With every w_ih and every product input already TF32 values (small
    parts zero), 3xTF32 is one exact TF32 product a k-step: the emulation
    then differs from the plain version by float32 reorderings only."""
    w = _weights(12, 32, L, seed=L)
    for k in [k for k in w if k.endswith("_wih")]:
        w[k] = tf32_round(w[k])
    Z = tf32_round(torch.from_numpy(np.random.default_rng(L).normal(
        size=(6, 9, 12)).astype(np.float32)))
    kw = dict(num_layers=L, use_layernorm=use_layernorm)
    got = emulated_gate(w, Z, steps=4, **kw)
    want = fused_mingru_gate_reference(w, Z, with_residual=False, **kw)[0]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def within(got, plain):
    """Max of |got - plain| - (ATOL + RTOL |plain|): <= 0 passes."""
    return float(((got - plain).abs() - (ATOL + RTOL * plain.abs())).max())


def _workload():
    """The minGRU root's VAE, its weights, its threshold and the 3,636
    committed 4DOF test windows normalized by the root's statistics (the
    root's splits name a copy of ``data/4dof``'s runs that is not
    committed)."""
    cfg = Stage4DofConfig()
    scorer = HybridScorer.from_artifacts(MINGRU_ROOT, device="cpu")
    splits = load_json(Paths(str(ROOT / "data" / "4dof")).run_splits)
    W = np.concatenate([build_fraction_windows(splits[g]["files"], cfg.test_frac, cfg)
                        for g in ("normal", "sensor_fault", "structural_fault")])
    Z = normalize_windows(torch.from_numpy(W), scorer.mean, scorer.std).contiguous()
    return (scorer.vae, mingru_params_to_kernel_weights(scorer.vae), Z,
            float(scorer.threshold))


# The 128 of the 3,636 committed test windows whose float32 MSE through
# the minGRU root (``fused_mingru_gate_reference`` on the CPU) lies nearest
# its committed threshold (data/4dof_mingru/processed/vae_threshold.json,
# 1.3831), chosen once by ``python tests/test_torch_mingru_gate_tf32.py``,
# which prints them; 128 more are drawn from the rest with numpy seed 11.
NEAREST = np.array([107, 108, 109, 110, 111, 112, 113, 114, 115, 116, 117, 118, 119, 120, 121,
    122, 123, 124, 125, 126, 127, 307, 308, 309, 310, 311, 312, 313, 314, 315,
    316, 317, 318, 319, 320, 321, 322, 323, 324, 325, 326, 327, 328, 329, 330,
    331, 332, 333, 334, 335, 808, 809, 810, 811, 812, 813, 814, 815, 816, 817,
    818, 819, 820, 821, 822, 823, 824, 825, 826, 827, 828, 829, 830, 831, 832,
    833, 834, 835, 836, 837, 838, 839, 840, 841, 842, 843, 844, 845, 846, 847,
    848, 849, 850, 851, 852, 853, 854, 855, 856, 857, 858, 859, 860, 861, 862,
    863, 864, 865, 866, 867, 868, 869, 870, 871, 872, 873, 874, 875, 876, 877,
    878, 879, 880, 881, 882, 1818, 1819, 1820])
DRAWN_SEED, N_DRAWN = 11, 128


def _window_indices():
    rest = np.setdiff1d(np.arange(3636), NEAREST)
    drawn = np.random.default_rng(DRAWN_SEED).choice(rest, N_DRAWN, replace=False)
    return np.sort(np.concatenate([NEAREST, drawn])).astype(int)


# The tolerances on those 256 windows, with what was measured (CPU, one
# thread): the card's kernel tolerance ATOL + RTOL |plain| on the mse, and
# MINGRU_MSE_RTOL (chip_smoke.py, 4e-6) on the largest relative mse
# difference. The emulated kernel's shipping sum reads 2.4e-7 from the port's
# plain version and 6.7e-7 from the JAX kernel (the mse runs 0.24 to 265); a
# one-term TF32 product 1.9e-5 from both, inside the card's tolerance and
# flipping no decision (the nearest window is 0.28 from the threshold), so
# only MINGRU_MSE_RTOL tells the two apart. The plain version and the JAX
# kernel differ by 6.7e-7 (their float32 orders).


@pytest.fixture(scope="module")
def real_windows():
    """The 256 windows through the float32 plain version, the JAX package's
    float32 Pallas kernel (interpret mode), and the emulated kernel with its
    shipping sum and with one-term TF32 products: ({name: mse [256]},
    threshold)."""
    from shm_tpu_torch.utils.checkpoint import load_checkpoint

    vae, w, Z, thr = _workload()
    Zs = Z[_window_indices()].contiguous()
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)
    params = load_checkpoint(MINGRU_ROOT / "models" / "temporal_vae.msgpack")["params"]
    jax_mse = jax_fused_mingru_gate(params, jnp.asarray(Zs.numpy()),
                                    dtype=jnp.float32, interpret=True,
                                    batch_tile=32, sigmoid_impl="exact",
                                    with_residual=False, **kw)[0]
    out = {"plain": fused_mingru_gate_reference(w, Zs, with_residual=False, **kw)[0],
           "jax": torch.from_numpy(np.asarray(jax_mse)),
           "split": emulated_gate(w, Zs, tc_sum="split", **kw),
           "one_term": emulated_gate(w, Zs, tc_sum="one_term", **kw)}
    return out, thr


def _rel(got, want):
    return float(((got - want).abs() / want.abs()).max())


def test_window_choice():
    idx = _window_indices()
    assert len(idx) == 256 == len(np.unique(idx)) and idx.max() < 3636


@pytest.mark.parametrize("against", ["plain", "jax"])
def test_3xtf32_gate_keeps_every_decision_and_the_kernel_tolerance(real_windows, against):
    out, thr = real_windows
    got, want = out["split"], out[against]
    assert torch.equal(got > thr, want > thr)
    assert within(got, want) <= 0.0
    assert _rel(got, want) <= MINGRU_MSE_RTOL


@pytest.mark.parametrize("against", ["plain", "jax"])
def test_one_term_tf32_fails_the_tight_bound(real_windows, against):
    """The planted fault: TF32 products of one term. MINGRU_MSE_RTOL, which
    the 3-term gate passes, must catch it."""
    out, thr = real_windows
    assert _rel(out["one_term"], out[against]) > MINGRU_MSE_RTOL


def test_plain_version_and_jax_kernel_agree_on_the_windows(real_windows):
    """What the tight bound leaves room for: the two float32 paths differ by
    their order of sums."""
    out, thr = real_windows
    assert torch.equal(out["plain"] > thr, out["jax"] > thr)
    assert _rel(out["plain"], out["jax"]) <= MINGRU_MSE_RTOL


def main() -> None:
    """The emulation over all 3,636 test windows: gate decisions and mse of
    the emulated kernel with each of its sums against the float32 plain
    version, and the 128 windows nearest the threshold."""
    torch.set_num_threads(8)
    vae, w, Z, thr = _workload()
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)
    plain = fused_mingru_gate_reference(w, Z, with_residual=False, **kw)[0]
    gap = np.abs(plain.numpy() - thr)
    nearest = np.sort(np.argsort(gap)[:128])
    print(f"windows: {len(Z)}; threshold {thr}; plain float32 gate anomalous "
          f"{int((plain > thr).sum())}")
    print(f"nearest 128 to the threshold: |mse - thr| up to "
          f"{float(gap[nearest].max()):.6f}, smallest {float(gap.min()):.3e}")
    print("NEAREST =", nearest.tolist())
    for tc_sum in ("split", "chain", "one_term"):
        got = emulated_gate(w, Z, tc_sum=tc_sum, **kw)
        flips = int(((got > thr) != (plain > thr)).sum())
        d = (got - plain).abs()
        print(f"sum {tc_sum!r}: gate decisions differing {flips}; max |mse "
              f"diff| {float(d.max()):.3e}, max relative {float((d / plain.abs()).max()):.3e}; "
              f"max of |diff| - (1e-4 + 1e-4|plain|): {within(got, plain):.3e}")


if __name__ == "__main__":
    main()
    sys.exit(0)
