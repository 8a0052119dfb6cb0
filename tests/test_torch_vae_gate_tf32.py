"""The LSTM gate's 3xTF32 products, emulated on the CPU.

The fused LSTM gate kernel (``ops/csrc/fused_vae.cu``) runs every LSTM gate
product of both stacks on the tensor cores in 3xTF32: each operand split
into a TF32 big part and a TF32 small part (round to nearest, ties away from
zero), and a * b = a_s b_b + a_b b_s + a_b b_b summed in float32. It reads
the weights as fragments that ``vae_params_to_kernel_weights`` packs once.

These tests hold the packing (shapes, zero K padding, the parts restoring
the weights), and the numerics: a plain gate whose every LSTM gate product
is summed as the kernel sums it (the TF32 parts' products k-step by k-step
in its order, and a model of the tensor cores' float32 accumulation, which
truncates), built here and on no main path, run on the committed
``data/4dof`` artifacts, against the port's float32 plain version and the
JAX package's float32 Pallas kernel (in interpret mode, as
``tests/test_torch_vae_gate.py`` runs it). It must keep every gate
decision, the card's kernel tolerance and a tighter relative bound; a
one-term TF32 product (a_b b_b alone), which keeps the first two on these
windows, must fail the third.

``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_vae_gate_tf32.py``
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

from shm_tpu.ops import fused_vae_gate as jax_fused_vae_gate
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.data.windows import normalize_windows
from shm_tpu_torch.ops import fused_vae_gate_reference, vae_params_to_kernel_weights
from shm_tpu_torch.ops import fused_vae as fused_vae_mod
from shm_tpu_torch.ops._gate import tf32_round, unpack_fragments
from shm_tpu_torch.tools.workload import load_trained_workload

ROOT = Path(__file__).resolve().parents[1]
# the card's kernel tolerance (chip_smoke.py ATOL, RTOL): |got - plain| <=
# ATOL + RTOL * |plain| elementwise
ATOL, RTOL = 1e-4, 1e-4

torch.set_num_threads(1)

LSTM_WEIGHTS = ("enc0_wih", "enc0_whh", "enc1_wih", "enc1_whh",
                "dec0_wih", "dec0_whh", "dec1_wih", "dec1_whh")


def _bits(x):
    return x.contiguous().view(torch.int32)


def _weights(D, H, L, seed=0):
    cfg = VAEConfig(input_dim=D, latent_dim=16, hidden_dim=H, num_layers=L,
                    use_layernorm=True)
    rng = np.random.default_rng(seed)
    return vae_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(rng, cfg), cfg))


# --- the packed fragments

@pytest.mark.parametrize("D, H, L", [(12, 32, 2), (12, 64, 2), (12, 128, 2),
                                     (3, 64, 1), (3, 128, 2)])
def test_each_lstm_weight_comes_as_fragments_that_restore_it(D, H, L):
    """[4H/8 n-tiles, ceil(K/8) k-steps, 32 lanes, 4] for each [K, 4H] LSTM
    weight; the rows past K (D=12 -> 16, D=3 -> 8) are zero in both parts;
    big + small is w within 2^-22 |w|, big is tf32_round(w), and both parts
    have their low 13 bits zero (the tensor cores ignore those bits)."""
    w = _weights(D, H, L, seed=H + D)
    names = [k for k in LSTM_WEIGHTS if int(k[3]) < L]
    assert sorted(k for k in w if k.endswith("_frag")) == sorted(
        f"{k}_frag" for k in names)
    for k in names:
        src, frag = w[k], w[f"{k}_frag"]
        K = src.shape[0]
        KP = -(-K // 8) * 8
        assert frag.shape == (4 * H // 8, KP // 8, 32, 4) and frag.is_contiguous()
        assert frag.dtype == torch.float32
        big, small = unpack_fragments(frag)
        assert big.shape == (KP, 4 * H)
        assert not bool(big[K:].any()) and not bool(small[K:].any())
        big, small = big[:K], small[:K]
        assert torch.equal(big, tf32_round(src))
        assert not bool((_bits(big) & 0x1FFF).any())
        assert not bool((_bits(small) & 0x1FFF).any())
        err = (big.double() + small.double() - src.double()).abs()
        assert bool((err <= 2.0 ** -22 * src.double().abs()).all())


def test_the_c_entry_takes_the_pointers_in_the_wrappers_order():
    """NUM_W of the source is the length of ``_WEIGHT_ORDER``, and the
    fragment pointers ``unpack_weights`` reads sit where the wrapper puts
    them."""
    src = (ROOT / "shm_tpu_torch" / "ops" / "csrc" / "fused_vae.cu").read_text()
    order = fused_vae_mod._WEIGHT_ORDER
    assert int(re.search(r"constexpr int NUM_W = (\d+);", src).group(1)) == len(order)
    found = re.findall(r"W\.(enc|dec)_(wih|whh)_f\[l\] = static_cast<const "
                       r"float4\*>\(p\[(\d+) \+ 2 \* l\]\);", src)
    assert len(found) == 4
    for stack, kind, base in found:
        for l in range(2):
            assert order[int(base) + 2 * l] == f"{stack}{l}_{kind}_frag"


def test_check_names_missing_or_misshapen_fragments():
    w = _weights(12, 32, 1)
    Z = torch.zeros(2, 9, 12)
    missing = {k: v for k, v in w.items() if not k.endswith("_frag")}
    with pytest.raises(ValueError, match="weights missing: enc0_wih_frag"):
        fused_vae_mod._check(missing, Z, 1, True)
    bad = dict(w, dec0_wih_frag=w["enc0_wih_frag"])
    with pytest.raises(ValueError, match=r"dec0_wih_frag .* not the fragments of a \[32, 128\]"):
        fused_vae_mod._check(bad, Z, 1, True)


# --- the gate with emulated TF32 products

# A model of the card's tensor cores, as the kernel uses them: each mma adds
# the exact products of its TF32 operands to its float32 accumulator and
# truncates the sum toward zero. Truncation is what holds a sum chained
# through every mma of a product to 8e-6 relative on the mse of real
# windows on the card, 10x a float32 order change; the model reproduces it
# (PERF.md §6). Float64 holds the exact block sums; clearing the 29 low bits
# of a float64 truncates it to a float32 value.
_F32_IN_F64 = ~((1 << 29) - 1)


def _truncate(x64: torch.Tensor) -> torch.Tensor:
    """Float64 ``x64`` truncated toward zero to float32's 24 bits, in place."""
    x64.view(torch.int64).bitwise_and_(_F32_IN_F64)
    return x64


def _k_blocks(pairs, KT: int, width: int = 8) -> torch.Tensor:
    """For each of ``KT`` steps of ``width`` k, the exact sum of the products
    a[:, k] w[k, :] of every (a, w) in ``pairs`` together: [KT, N, cols]
    float64 (K padded with zeros to ``width * KT``)."""
    N, K = pairs[0][0].shape
    KP, n = width * KT, len(pairs)
    A = torch.stack([F.pad(a, (0, KP - K)) for a, _ in pairs], 1).double()
    W = torch.stack([F.pad(w, (0, 0, 0, KP - K)) for _, w in pairs], 0).double()
    A = A.view(N, n, KT, width).permute(2, 0, 1, 3).reshape(KT, N, width * n)
    W = W.view(n, KT, width, -1).permute(1, 0, 2, 3).reshape(KT, width * n, -1)
    return torch.bmm(A, W)


def tc_product(acc: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
               tc_sum: str) -> torch.Tensor:
    """acc + a @ w as the kernel sums it on the tensor cores (``acc`` float32,
    the sum so far). The k-steps go in pairs (k, k+1), each pair's six mma
    small terms first: a_s b_b and a_b b_s of k, then of k+1, then a_b b_b
    of k and of k+1 (TF32 parts of the operands). ``tc_sum`` says how they
    reach the sum: "split" (the shipping kernel) chains a pair's mma from
    zero and adds that partial to the float32 sum to nearest; "chain"
    chains every mma into the sum; "one_term" (the planted fault) chains
    a_b b_b alone. In "split" the model truncates the exact sum of a pair's
    four small-term mma once: the kernel's truncations there act on sums
    2^-11 as large as the pair's."""
    KT = -(-a.shape[1] // 16) * 2                    # k-steps, in pairs
    ab, wb = tf32_round(a), tf32_round(w)
    acc = acc.double()
    big = _k_blocks([(ab, wb)], KT)
    if tc_sum == "one_term":
        for p in big:
            acc = _truncate(acc + p)
        return acc.float()
    a_s, w_s = tf32_round(a - ab), tf32_round(w - wb)
    if tc_sum == "split":
        part = _truncate(_k_blocks([(a_s, wb), (ab, w_s)], KT // 2, 16))
        part = _truncate(_truncate(part + big[0::2]) + big[1::2])
        for p in part:
            acc = (acc + p).float().double()
        return acc.float()
    sb, bs = _k_blocks([(a_s, wb)], KT), _k_blocks([(ab, w_s)], KT)
    for k in range(0, KT, 2):
        for p in (sb[k], bs[k], sb[k + 1], bs[k + 1], big[k], big[k + 1]):
            acc = _truncate(acc + p)
    return acc.float()


def emulated_gate(weights, Z, *, num_layers, use_layernorm, tc_sum="split"):
    """``fused_vae_gate_reference``'s function (gate-only mse [N]) with every
    LSTM gate product summed as the kernel sums it (:func:`tc_product`), in
    its order: the bias first, then the input's product, then h's; the
    decoder's layer 0 from its constant projection. The latent and output
    heads, LayerNorm and the cell stay in float32, as in the kernel."""
    N, T, D = Z.shape
    H = weights["enc0_whh"].shape[0]
    mm = lambda acc, a, k: tc_product(acc, a, weights[k], tc_sum)
    bias = lambda k: weights[k].expand(N, -1)

    def step(c, gates):
        i, f, g, o = gates.split(H, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    zeros = Z.new_zeros(N, H)
    hs, cs = [zeros] * num_layers, [zeros] * num_layers
    for t in range(T):
        inp = Z[:, t]
        for l in range(num_layers):
            g = mm(mm(bias(f"enc{l}_b"), inp, f"enc{l}_wih"), hs[l], f"enc{l}_whh")
            hs[l], cs[l] = step(cs[l], g)
            inp = hs[l]
    h_last = hs[-1]
    if use_layernorm:
        h_last = F.layer_norm(h_last, (H,), weights["ln_scale"],
                              weights["ln_bias"], eps=1e-5)
    mu = h_last @ weights["mu_w"] + weights["mu_b"]
    dec_in = torch.tanh(mu @ weights["z2h_w"] + weights["z2h_b"])
    xp_const = mm(bias("dec0_b"), dec_in, "dec0_wih")
    hs, cs = [zeros] * num_layers, [zeros] * num_layers
    acc = Z.new_zeros(N)
    for t in range(T):
        hs[0], cs[0] = step(cs[0], mm(xp_const, hs[0], "dec0_whh"))
        for l in range(1, num_layers):
            g = mm(mm(bias(f"dec{l}_b"), hs[l - 1], f"dec{l}_wih"), hs[l], f"dec{l}_whh")
            hs[l], cs[l] = step(cs[l], g)
        y = hs[-1] @ weights["out_w"] + weights["out_b"]
        acc = acc + ((Z[:, t] - y) ** 2).sum(dim=1)
    return acc / (T * D)


@pytest.mark.parametrize("tc_sum", ["split", "chain", "one_term"])
def test_tc_product_is_exact_where_float32_is(tc_sum):
    """On operands that are TF32 values and whose products and sums are
    exact in float32 (small integers), every sum of the model gives
    acc + a @ w exactly: the order and the truncation change nothing."""
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-8, 9, (5, 24), generator=g).float()
    w = torch.randint(-8, 9, (24, 16), generator=g).float()
    acc = torch.randint(-50, 51, (5, 16), generator=g).float()
    assert torch.equal(tc_product(acc, a, w, tc_sum), acc + a @ w)


def test_tc_product_chained_sum_truncates_what_the_pair_keeps():
    """acc = 1 and two k-steps whose products each sum to 0.375 ulp(1):
    a sum chained through every mma truncates each to nothing; the pair's
    partial (0.75 ulp) added to nearest gives 1 + ulp, as float32 does."""
    a = torch.full((1, 16), 2.0 ** -13)
    w = torch.full((16, 8), 3 * 2.0 ** -16)
    acc = torch.ones(1, 8)
    ulp = 2.0 ** -23
    assert torch.equal(tc_product(acc, a, w, "chain"), acc)
    assert torch.equal(tc_product(acc, a, w, "one_term"), acc)
    assert torch.equal(tc_product(acc, a, w, "split"), acc + ulp)
    assert torch.equal(acc + a @ w, acc + ulp)


def within(got, plain):
    """Max of |got - plain| - (ATOL + RTOL |plain|): <= 0 passes."""
    return float(((got - plain).abs() - (ATOL + RTOL * plain.abs())).max())


def _workload():
    wl = load_trained_workload(ROOT / "data" / "4dof")
    Z = normalize_windows(torch.from_numpy(wl.W), torch.from_numpy(wl.mean),
                          torch.from_numpy(wl.std)).contiguous()
    return wl, vae_params_to_kernel_weights(wl.vae), Z


# The 128 of the 3,636 committed 4DOF test windows whose float32 MSE
# (``fused_vae_gate_reference`` on the CPU) lies nearest the committed
# threshold (data/4dof/processed/vae_threshold.json, 1.3861), chosen once by
# ``python tests/test_torch_vae_gate_tf32.py``, which prints them; 128 more
# are drawn from the rest with numpy seed 10.
NEAREST = np.array([119, 120, 121, 122, 123, 124, 125, 126, 306, 307, 308, 309, 310, 311, 312,
    313, 314, 315, 316, 317, 318, 319, 320, 321, 322, 323, 324, 325, 326,
    327, 328, 329, 330, 331, 332, 333, 334, 349, 350, 351, 352, 353, 354,
    808, 809, 810, 811, 812, 813, 814, 815, 816, 817, 818, 819, 820, 821,
    822, 823, 824, 825, 826, 827, 828, 829, 830, 831, 832, 833, 834, 835,
    836, 837, 838, 839, 840, 841, 842, 843, 844, 845, 846, 847, 848, 849,
    850, 851, 852, 853, 854, 855, 856, 857, 858, 859, 860, 861, 862, 863,
    864, 865, 866, 867, 868, 869, 870, 871, 872, 873, 874, 875, 876, 877,
    878, 879, 880, 881, 882, 1010, 1011, 1012, 1013, 1818, 1819, 1820, 1821,
    1822, 1823])
DRAWN_SEED, N_DRAWN = 10, 128


def _window_indices():
    rest = np.setdiff1d(np.arange(3636), NEAREST)
    drawn = np.random.default_rng(DRAWN_SEED).choice(rest, N_DRAWN, replace=False)
    return np.sort(np.concatenate([NEAREST, drawn]))


# Tolerances on those 256 windows, each with what was measured (CPU, one
# thread). The card's kernel tolerance ATOL + RTOL |plain| on the mse: the
# emulated kernel (its shipping sum) is within 7.6e-6 of the port's plain
# version and 3.1e-5 of the JAX kernel (max relative 7.8e-7 and 5.1e-7; the
# mse runs 0.31 to 246). A one-term TF32 product passes that tolerance too
# (max relative 5.6e-5 from both) and flips no decision: the nearest window
# is 0.29 from the threshold. So the check that tells the two apart is
# tighter, on the relative mse difference: MSE_RTOL_TIGHT, 6x the shipping
# sum's largest and 11x below the one-term product's; the card holds row 1
# to the same bound on 5,440 real windows (chip_smoke.py LSTM_MSE_RTOL).
# The plain version and the JAX kernel differ by 1.0e-6 (their float32
# orders).
MSE_RTOL_TIGHT = 5e-6


@pytest.fixture(scope="module")
def real_windows():
    """The 256 windows through the float32 plain version, the JAX package's
    float32 Pallas kernel (interpret mode), and the emulated kernel with its
    shipping sum and with one-term TF32 products: ({name: mse [256]},
    threshold)."""
    from shm_tpu_torch.utils.checkpoint import load_checkpoint

    wl, w, Z = _workload()
    Zs = Z[_window_indices()].contiguous()
    kw = dict(num_layers=2, use_layernorm=True)
    params = load_checkpoint(ROOT / "data" / "4dof" / "models"
                             / "temporal_vae.msgpack")["params"]
    jax_mse = jax_fused_vae_gate(params, jnp.asarray(Zs.numpy()), dtype=jnp.float32,
                                 interpret=True, batch_tile=32,
                                 with_residual=False, **kw)[0]
    out = {"plain": fused_vae_gate_reference(w, Zs, with_residual=False, **kw)[0],
           "jax": torch.from_numpy(np.asarray(jax_mse)),
           "split": emulated_gate(w, Zs, tc_sum="split", **kw),
           "one_term": emulated_gate(w, Zs, tc_sum="one_term", **kw)}
    return out, wl.threshold


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
    assert _rel(got, want) <= MSE_RTOL_TIGHT


@pytest.mark.parametrize("against", ["plain", "jax"])
def test_one_term_tf32_fails_the_tight_bound(real_windows, against):
    """The planted fault: TF32 products of one term. It keeps the decisions
    and the kernel tolerance on these windows (see above), and fails
    MSE_RTOL_TIGHT, which the 3-term gate passes."""
    out, thr = real_windows
    got, want = out["one_term"], out[against]
    assert _rel(got, want) > MSE_RTOL_TIGHT


def test_plain_version_and_jax_kernel_agree_on_the_windows(real_windows):
    """What the tight bound leaves room for: the two float32 paths differ by
    their order of sums and the sigmoid's form (measured 1.0e-6 relative)."""
    out, thr = real_windows
    assert torch.equal(out["plain"] > thr, out["jax"] > thr)
    assert _rel(out["plain"], out["jax"]) <= MSE_RTOL_TIGHT


def main() -> None:
    """The emulation over all 3,636 test windows: gate decisions and mse of
    the emulated kernel with each of its sums against the float32 plain
    version, and the 128 windows nearest the threshold."""
    torch.set_num_threads(8)
    wl, w, Z = _workload()
    kw = dict(num_layers=2, use_layernorm=True)
    plain = fused_vae_gate_reference(w, Z, with_residual=False, **kw)[0]
    thr = wl.threshold
    nearest = np.sort(np.argsort(np.abs(plain.numpy() - thr))[:128])
    print(f"windows: {len(Z)}; threshold {thr}; plain float32 gate anomalous "
          f"{int((plain > thr).sum())}")
    print(f"nearest 128 to the threshold: |mse - thr| up to "
          f"{float(np.abs(plain.numpy() - thr)[nearest].max()):.6f}, smallest "
          f"{float(np.abs(plain.numpy() - thr).min()):.3e}")
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
