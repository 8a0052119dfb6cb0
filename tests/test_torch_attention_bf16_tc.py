"""Row 7's bf16 tensor-core weights and shared memory, on the CPU.

The attention gate's bf16 resident body multiplies every weight product
on ``mma.sync.m16n8k16`` bf16: ``attention_params_to_kernel_weights(vae,
torch.bfloat16)`` packs each of the four products' weights (QKV, output
projection, the MLP's two) once into that instruction's B fragments
(``bf16_b_fragments``: per n-tile, k-step of 16 and lane two 32-bit words,
2 bytes a weight), beside the TF32 fragments the long body reads. These tests hold the packing to the layout the PTX ISA
gives for the B operand (lane g = lane // 4, t = lane % 4: b0 = B[2t, 2t+1]
[g], b1 = B[2t+8, 2t+9][g], the lower k in the low half), its unpacker to the
bf16-rounded weight, the weight dict to the names the C entry reads, and the
resident body's shared memory and plan to the kernel's layout.
``tests/test_torch_cuda.py`` holds the kernel to its plain version and the
byte counts to the C entry on the card.
"""

import numpy as np
import pytest
import torch

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import attention_params_to_kernel_weights
from shm_tpu_torch.ops import fused_attention as fa
from shm_tpu_torch.ops._gate import (
    FRAG, FRAG_BF16, FRAG_K16, bf16_b_fragments, bf16_fragments, bf16_round,
    fragment_names, unpack_bf16_b_fragments,
)

torch.set_num_threads(1)

# every product shape of the kernel: (K, N) of QKV, the output projection
# and the MLP's two at each width H and MLP width M
PRODUCT_SHAPES = sorted({shape for H in (32, 64, 128) for M in (256, 512, 768)
                         for shape in ((H, 3 * H), (H, H), (H, M), (M, H))})


def _b_tile(frags, nt, ks):
    """The [16, 8] block of B that lanes hold for n-tile nt, k-step ks, as
    the PTX ISA lays out mma.m16n8k16's B operand (bf16 bits as floats)."""
    words = frags[nt, ks].to(torch.int64) & 0xFFFFFFFF          # [32, 2]
    tile = torch.empty(16, 8)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for r in range(2):
            for half in range(2):
                bits = int(words[lane, r] >> (16 * half)) & 0xFFFF
                k = 2 * t + 8 * r + half
                tile[k, g] = float(np.array([bits << 16], np.uint32).view(np.float32)[0])
    return tile


@pytest.mark.parametrize("K, N", PRODUCT_SHAPES)
def test_b_fragments_round_trip_at_every_product_shape(K, N):
    """Packed then unpacked, a weight is its bf16 rounding, bit for bit, in
    two bytes a weight; the padding past K (none here) decodes to zero."""
    w = torch.from_numpy(np.random.default_rng(K * N).normal(size=(K, N))
                         .astype(np.float32))
    f = bf16_b_fragments(w)
    assert f.dtype == torch.int32 and f.shape == (N // 8, K // 16, 32, 2)
    assert f.numel() * 4 == 2 * w.numel()
    back = unpack_bf16_b_fragments(f)
    assert back.shape == w.shape
    assert torch.equal(back, bf16_round(w))


@pytest.mark.parametrize("K, N", [(32, 96), (128, 128), (512, 64)])
def test_b_fragments_hold_the_mma_b_layout(K, N):
    """Each lane's two words are the B operand of its n-tile and k-step as
    the instruction reads it, and the per-tile products summed over k give
    bf16(a) @ bf16(w) exactly (float64, products of bf16 values)."""
    rng = np.random.default_rng(K + N)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(16, K)).astype(np.float32))
    f = bf16_b_fragments(w)
    wr, ar = bf16_round(w).double(), bf16_round(a).double()
    out = torch.zeros(16, N, dtype=torch.float64)
    for nt in range(N // 8):
        for ks in range(K // 16):
            tile = _b_tile(f, nt, ks)
            assert torch.equal(tile, bf16_round(w)[16 * ks:16 * ks + 16,
                                                   8 * nt:8 * nt + 8])
            out[:, 8 * nt:8 * nt + 8] += ar[:, 16 * ks:16 * ks + 16] @ tile.double()
    torch.testing.assert_close(out, ar @ wr, rtol=1e-12, atol=1e-12)


def test_b_fragments_pad_k_with_zeros():
    """A K that is not a multiple of 16 (the token and head weights are never
    packed, but the packer takes any K) pads with zero rows."""
    w = torch.randn(20, 16)
    f = bf16_b_fragments(w)
    assert f.shape == (2, 2, 32, 2)
    back = unpack_bf16_b_fragments(f)
    assert torch.equal(back[:20], bf16_round(w)) and not back[20:].any()


@pytest.mark.parametrize("H, L, r", [(32, 2, 8), (64, 1, 2), (128, 2, 4)])
def test_bf16_weight_dict_emits_what_the_c_entry_reads(H, L, r):
    """A converted JAX tree packed for bf16 holds, for each of the four
    products, ``*_frag_k16`` (the resident body's m16n8k16 fragments) and
    ``*_frag_bf16`` (the long body's TF32 fragments of the bf16-rounded
    weight), and no float32 fragments: exactly the names ``fragment_names``
    gives the bf16 C entry for either body, each the packing of its weight
    (the plain bf16 version of such a dict against the JAX kernel:
    tests/test_torch_gate_bf16.py)."""
    cfg = VAEConfig(input_dim=5, latent_dim=4, hidden_dim=H, num_layers=L,
                    use_layernorm=True, cell="attention")
    rng = np.random.default_rng(H + L + r)
    params = random_flax_vae_params(rng, cfg, mlp_ratio=r)
    w = attention_params_to_kernel_weights(vae_from_flax(params, cfg),
                                           torch.bfloat16)
    for suffix, pack in ((FRAG_K16, bf16_b_fragments), (FRAG_BF16, bf16_fragments)):
        order = fragment_names(fa._WEIGHT_ORDER, True, suffix)
        want = [k for k in order if k.endswith(suffix)
                and not (k[3:4].isdigit() and int(k[3]) >= L)]
        assert sorted(k for k in w if k.endswith(suffix)) == sorted(want)
        for k in want:
            assert torch.equal(w[k], pack(w[k[:-len(suffix)]]))
    assert not any(k.endswith(FRAG) for k in w)


def _bf16_layout_bytes(T, H, group):
    """The bf16 resident body's shared memory spelled out: the stream
    [Tp, H+4] float32, its normalised copy [Tp, H+8] bf16, 512 floats of
    per-window vectors, and the larger of a group's q | k | v [3, Tk,
    32 group + 8] bf16 and an MLP chunk [Tp, 136] bf16 (Tp = T rounded up
    to 8, Tk to 16)."""
    Tp, Tk = -(-T // 8) * 8, -(-T // 16) * 16
    return (4 * Tp * (H + 4) + 2 * Tp * (H + 8) + 4 * 512
            + 2 * max(3 * Tk * (32 * group + 8), Tp * 136))


@pytest.mark.parametrize("T, H, group, nbytes", [
    (100, 128, 4, 176_640),      # the 4DOF preset: all four heads at once
    (200, 64, 2, 175_104),       # the openLAB preset: both heads
    (80, 32, 1, 41_728),         # the 1DOF preset
    (137, 128, 2, 179_456),      # past the float32 body's longest window
    (188, 128, 1, 207_872),      # past two heads' longest at H=128
])
def test_bf16_shared_memory_and_plan(T, H, group, nbytes):
    """The most heads a group whose buffers fit a block's 232,448 bytes."""
    assert fa.bf16_head_group(T, H) == group
    assert fa.shared_memory_bytes(T, H, torch.bfloat16) == nbytes
    assert _bf16_layout_bytes(T, H, group) == nbytes <= fa.SMEM_LIMIT
    if group < H // 32:
        assert _bf16_layout_bytes(T, H, 2 * group) > fa.SMEM_LIMIT
    assert fa.plan(T, H, torch.bfloat16) == ("resident", nbytes, 0)
    # float32 keeps its own count and plan
    assert fa.shared_memory_bytes(T, H) != nbytes
    f32 = fa.plan(T, H)
    assert f32.body == ("long" if T > {128: 136, 64: 208, 32: 268}[H] else "resident")


@pytest.mark.parametrize("H, longest", [(128, 208), (64, 328), (32, 464)])
def test_bf16_resident_body_takes_longer_windows_than_float32(H, longest):
    """The bf16 body stores its operands in 2 bytes, so a window stays
    resident longer; past its longest, the long body (whose shared memory
    does not depend on T) takes it, in one head a group's byte count."""
    assert fa.shared_memory_bytes(longest, H, torch.bfloat16) <= fa.SMEM_LIMIT
    assert fa.plan(longest, H, torch.bfloat16).body == "resident"
    past = fa.plan(longest + 1, H, torch.bfloat16)
    assert fa.bf16_head_group(longest + 1, H) == 0
    assert past == ("long", fa.long_shared_memory_bytes(H),
                    fa.slot_floats(longest + 1, H))
    assert fa.shared_memory_bytes(longest + 1, H, torch.bfloat16) == (
        _bf16_layout_bytes(longest + 1, H, 1))
    assert fa.plan(longest, H).body == "long"
