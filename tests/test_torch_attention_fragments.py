"""The attention kernel's 3xTF32 weight fragments, on the CPU.

``attention_params_to_kernel_weights`` packs each of the four weight
products (QKV, output projection, the MLP's two) once into the B fragments
of ``mma.sync.m16n8k8`` TF32 (``tf32x3_fragments``): a TF32 big part and a
TF32 small part of every weight, both rounded to nearest with ties away from
zero, as ``cvt.rna.tf32.f32`` rounds on the card (``chip_smoke.py`` holds the
two against each other bit for bit there). These tests hold the packing to
that, and the 3xTF32 product it feeds to float32's own accuracy. The plain
version of the gate reads the [in, out] weights and is held against the JAX
package in ``tests/test_torch_attention_gate.py``.
"""

import numpy as np
import pytest
import torch

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import attention_params_to_kernel_weights
from shm_tpu_torch.ops import fused_attention as fa
from shm_tpu_torch.ops.fused_attention import (
    tf32_round, tf32x3_fragments, unpack_fragments,
)

PRODUCTS = ("wqkv", "wo", "w1", "w2")


def _weights(H, L=2, seed=0):
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=H, num_layers=L,
                    use_layernorm=True, cell="attention")
    rng = np.random.default_rng(seed)
    return attention_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(rng, cfg), cfg))


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("H", [32, 128])
def test_unpacked_fragments_restore_the_weights(H):
    """big + small is w within 2^-22 |w| (the small part keeps 11 of the up
    to 13 bits of w - big), and both parts have their low 13 bits zero, so
    the tensor cores, which ignore those bits, see all of them."""
    w = _weights(H)
    for p in ("enc", "dec"):
        for l in range(2):
            for k in PRODUCTS:
                src = w[f"{p}{l}_{k}"]
                big, small = unpack_fragments(w[f"{p}{l}_{k}_frag"])
                assert big.shape == src.shape
                assert torch.equal(big, tf32_round(src))
                assert not bool((_bits(big) & 0x1FFF).any())
                assert not bool((_bits(small) & 0x1FFF).any())
                err = (big.double() + small.double() - src.double()).abs()
                assert bool((err <= 2.0 ** -22 * src.double().abs()).all())


def test_tf32_rounding_is_to_nearest_ties_away_from_zero():
    """Planted ties (low 13 bits exactly 0x1000) round away from zero, one
    bit either side rounds to the nearer, and a tie that carries into the
    exponent does so, for both signs."""
    mant = torch.tensor([0x3F800000 | (5 << 13), 0x3FFFE000, 0x3F800000],
                        dtype=torch.int64)
    for low, up in ((0x1000, True), (0x0FFF, False), (0x1001, True),
                    (0x0001, False), (0x1FFF, True)):
        for sign in (0, 1):
            x = ((mant | low) | (sign << 31)).to(torch.int64)
            x = torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)
            got = _bits(tf32_round(x.view(torch.float32))).to(torch.int64) & 0xFFFFFFFF
            want = (mant + (0x2000 if up else 0)) | (sign << 31)
            assert got.tolist() == want.tolist(), (hex(low), sign)
    # 1 + 2^-11 is the tie between 1 and 1 + 2^-10: away from zero
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -11 - 2 ** -23])
    assert tf32_round(x).tolist() == [1 + 2 ** -10, -(1 + 2 ** -10), 1.0]


def _emulated_product(A, frags, terms):
    """A [M, K] times the packed weight as the kernel sums it: per k-step of
    8, each mma of ``terms`` added in float32 to one accumulator."""
    bb, bs = unpack_fragments(frags)
    ab = tf32_round(A)
    a_s = tf32_round(A - ab)
    ops = {"a_s b_b": (a_s, bb), "a_b b_s": (ab, bs), "a_b b_b": (ab, bb)}
    acc = torch.zeros(A.shape[0], bb.shape[1], dtype=torch.float32)
    for k in range(0, A.shape[1], 8):
        for name in terms:
            x, y = ops[name]
            acc = (acc.double() + x[:, k:k + 8].double() @ y[k:k + 8].double()).float()
    return acc


# 3xTF32 against float64, in units of sum_k |a||b|: measured 0.50-0.59x of
# float32's own error on the same product (seeds 0-2); a one-term TF32
# product is 560-790x. The bound: 4x float32's.
F32_MULTIPLE = 4.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_product_is_as_accurate_as_float32(seed):
    """A seeded [104, 128] x [128, 384] pair (the 4DOF window's rows against
    the QKV weight): the 3xTF32 sum from the packed fragments stays within
    F32_MULTIPLE of float32's own error; a one-term TF32 product does not."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.normal(size=(104, 128)).astype(np.float32))
    W = torch.from_numpy((rng.normal(size=(128, 384)) / np.sqrt(128)).astype(np.float32))
    exact = A.double() @ W.double()
    scale = A.double().abs() @ W.double().abs()
    err = lambda X: float(((X.double() - exact).abs() / scale).max())
    f32_err = err(A @ W)
    frags = tf32x3_fragments(W)
    three = _emulated_product(A, frags, ("a_s b_b", "a_b b_s", "a_b b_b"))
    one = _emulated_product(A, frags, ("a_b b_b",))
    assert err(three) <= F32_MULTIPLE * f32_err
    assert err(one) > F32_MULTIPLE * f32_err


@pytest.mark.parametrize("H", [32, 64, 128])
def test_fragment_shapes_and_offsets_match_the_kernels_tiling(H):
    """[N/8 n-tiles, K/8 k-steps, 32 lanes, 4] for a [K, N] weight, and the
    slices the kernel takes (csrc/fused_attention.cu, transformer_block):
    QKV of head h is n-tiles 12h .. 12h+11; the output projection of head h
    k-steps 4h .. 4h+3; MLP chunk c (128 columns) W1's n-tiles 16c .. 16c+15
    and W2's k-steps 16c .. 16c+15."""
    w = _weights(H, L=1)
    heads, KT = H // 32, H // 8
    shapes = {"wqkv": (3 * H // 8, KT), "wo": (KT, KT), "w1": (4 * KT, KT),
              "w2": (KT, 4 * KT)}
    for k, (nt, kt) in shapes.items():
        assert w[f"enc0_{k}_frag"].shape == (nt, kt, 32, 4)
        assert w[f"enc0_{k}_frag"].is_contiguous()
    big = lambda f: unpack_fragments(f.contiguous())[0]
    for h in range(heads):
        assert torch.equal(big(w["dec0_wqkv_frag"][12 * h:12 * h + 12]),
                           tf32_round(w["dec0_wqkv"][:, 96 * h:96 * h + 96]))
        assert torch.equal(big(w["dec0_wo_frag"][:, 4 * h:4 * h + 4]),
                           tf32_round(w["dec0_wo"][32 * h:32 * h + 32]))
    for c in range(4 * H // 128):
        assert torch.equal(big(w["enc0_w1_frag"][16 * c:16 * c + 16]),
                           tf32_round(w["enc0_w1"][:, 128 * c:128 * c + 128]))
        assert torch.equal(big(w["enc0_w2_frag"][:, 16 * c:16 * c + 16]),
                           tf32_round(w["enc0_w2"][128 * c:128 * c + 128]))


def test_fragment_lane_layout():
    """Lane (g, t) of n-tile nt, k-step kt holds {b0 big, b1 big, b0 small,
    b1 small} with b0 = w[8kt + t, 8nt + g], b1 = w[8kt + t + 4, 8nt + g]:
    the B fragment of mma.m16n8k8 .tf32, held element by element."""
    rng = np.random.default_rng(7)
    W = torch.from_numpy(rng.normal(size=(24, 40)).astype(np.float32))
    f = tf32x3_fragments(W)
    big = tf32_round(W)
    small = tf32_round(W - big)
    for nt, kt, lane in ((0, 0, 0), (4, 2, 31), (2, 1, 13), (3, 0, 6)):
        g, t = lane // 4, lane % 4
        r, c = 8 * kt + t, 8 * nt + g
        assert f[nt, kt, lane].tolist() == [big[r, c].item(), big[r + 4, c].item(),
                                            small[r, c].item(), small[r + 4, c].item()]


def test_check_names_missing_or_misshapen_fragments():
    w = _weights(32, L=1)
    Z = torch.zeros(2, 9, 12)
    missing = {k: v for k, v in w.items() if not k.endswith("_frag")}
    with pytest.raises(ValueError, match="weights missing: enc0_wqkv_frag, enc0_wo_frag"):
        fa._check(missing, Z, 1, True)
    bad = dict(w, dec0_w2_frag=w["dec0_w1_frag"])
    with pytest.raises(ValueError, match="dec0_w2_frag .* not the fragments of a \\[128, 32\\]"):
        fa._check(bad, Z, 1, True)
