"""The bf16 tensor-core sums of the two probe kernels, emulated on the CPU.

Both probes' bf16 products run on ``mma.sync.m16n8k16`` with bf16 operands
and float32 accumulators: every product over all T steps of the minGRU
probe (``ops/csrc/probe_mingru_gate.cu``, PERF.md row 9) and the recurrent
product's bf16 and bf16x3 modes (``ops/csrc/probe_matmul_loop.cu``, row 10).
The tensor cores add each mma's products to its accumulator and truncate
the sum toward zero. Both kernels therefore sum a product k-step pair by
pair: each pair's mma chained from zero, and that partial added to the
float32 sum to nearest. Row 10's chained sum, the body before, is kept as a
probe instance.

These tests hold:

- the packing of the minGRU probe's weights as bf16 A fragments (shapes,
  zero padding, the C entry's pointer order, every bf16 where the PTX
  layout puts it, unpacking back to the weights bit for bit);
- one CPU model of the kernels' sums (:func:`tc_bf16_product`: exact
  products, each mma's sum truncated to float32 toward zero, as
  ``tests/test_torch_vae_gate_tf32.py`` models the 3xTF32 products), put
  into a test-only copy of each probe's plain version, on no main path:
  the minGRU probe against the JAX probe in interpret mode and against the
  plain version; row 10's bf16 mode split against chained, each against
  float64 sums.

Tolerances, each a check of the probes' own tests: the JAX comparison at
``tests/test_torch_probes.py``'s bf16 tolerance (5e-4, 3e-6); against the
plain version at ``chip_smoke.py``'s ``PROBE_TOL`` (gate (1e-4, 2e-6),
matmul_bf16 (1e-2, 1e-3)), the card's tolerances for these kernels.
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import PROBE_TOL, over_one_bf16_ulp
from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import mingru_params_to_kernel_weights
from shm_tpu_torch.ops._gate import (
    bf16_a_fragments, bf16_round, unpack_bf16_a_fragments,
)
from shm_tpu_torch.tools import probe_f32_cliff, probe_mingru_recur
# the model of the tensor cores' truncating float32 accumulation
from test_torch_vae_gate_tf32 import _truncate

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))

import probe_mingru_recur as jax_mingru_recur      # noqa: E402  tools/

BF16_TOL = (5e-4, 3e-6)           # tests/test_torch_probes.py, bf16 paths
H = 128                           # the probe kernels' only width

# pytest-xdist runs several test files at once on the same cores
torch.set_num_threads(1)


def _rel_errs(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    return d.max() / np.abs(want).max(), d.mean() / np.abs(want).mean()


def _assert_within(got, want, tol):
    max_rel, mean_rel = _rel_errs(got, want)
    assert max_rel <= tol[0] and mean_rel <= tol[1], (max_rel, mean_rel, tol)


# --- the bf16 A fragments of the minGRU probe's weights

def _weights(seed=0, H_=H):
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=H_, num_layers=2,
                    use_layernorm=True, cell="min_gru")
    rng = np.random.default_rng(seed)
    return mingru_params_to_kernel_weights(
        vae_from_flax(random_flax_vae_params(rng, cfg), cfg))


@pytest.mark.parametrize("name, shape", [
    ("enc0_wih", (16, 1, 32, 4)),     # A = w^T [2H, D=12 -> 16]: one k-step
    ("enc1_wih", (16, 8, 32, 4)),     # [2H, H]
    ("dec1_wih", (16, 8, 32, 4)),
    ("out_w", (1, 8, 32, 4)),         # [D=12 -> 16, H]: one m-tile
])
def test_fragments_unpack_to_the_bf16_weights_bit_for_bit(name, shape):
    """Each product over all T comes as int32 fragments of the tile counts
    of A = w^T; unpacked, they are the weight rounded to bf16 (nearest
    even) bit for bit, and the padding (k past D, rows past D) is zero."""
    w = _weights(seed=len(name))[name]
    f = bf16_a_fragments(w)
    assert f.shape == shape and f.dtype == torch.int32 and f.is_contiguous()
    got = unpack_bf16_a_fragments(f)
    K, M = w.shape
    assert got.shape == (16 * shape[1], 16 * shape[0])
    assert torch.equal(got[:K, :M].contiguous().view(torch.int32),
                       bf16_round(w).view(torch.int32))
    assert not got[K:].any() and not got[:, M:].any()


def test_fragments_hold_each_bf16_where_the_ptx_layout_puts_it():
    """Read back with the PTX ISA's m16n8k16 A layout, written out here
    apart from the packer's permutation: lane (g, t) register r holds
    A[16mt + g + 8(r % 2)][16ks + 8(r // 2) + 2t + {0, 1}], the lower column
    in the low half; A = w^T rounded to bf16."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(size=(40, 24)).astype(np.float32))  # K=40, M=24
    f = bf16_a_fragments(w)
    assert f.shape == (2, 3, 32, 4)
    A = F.pad(bf16_round(w).t(), (0, 8, 0, 8))          # [32, 48]
    halves = f.view(torch.int16).view(torch.bfloat16).float()   # [..., 8]
    for mt in range(2):
        for ks in range(3):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for r in range(4):
                    row = 16 * mt + g + 8 * (r % 2)
                    col = 16 * ks + 8 * (r // 2) + 2 * t
                    assert halves[mt, ks, lane, 2 * r] == A[row, col]
                    assert halves[mt, ks, lane, 2 * r + 1] == A[row, col + 1]


def test_kernel_weights_follow_the_c_entrys_pointer_order():
    """The C entry reads its 16 pointers in ``_WEIGHT_ORDER``: A fragments
    (uint4) exactly where ``kernel_weights`` gives int32 fragments, bf16
    [in, out] exactly where it gives bf16, float32 for the rest."""
    src = (ROOT / "shm_tpu_torch" / "ops" / "csrc" / "probe_mingru_gate.cu").read_text()
    order = probe_mingru_recur._WEIGHT_ORDER
    assert int(re.search(r"constexpr int NUM_W = (\d+);", src).group(1)) == len(order)
    found = re.findall(r"W\.\w+(?:\[\d\])? = static_cast<const (\w+)\*>\(w\[(\d+)\]\);", src)
    assert sorted(int(i) for _, i in found) == list(range(len(order)))
    kw = probe_mingru_recur.kernel_weights(_weights())
    assert list(kw) == list(order)
    want = {"uint4": torch.int32, "bf16_t": torch.bfloat16, "float": torch.float32}
    for ctype, i in found:
        name = order[int(i)]
        assert kw[name].dtype == want[ctype], (name, ctype)
        assert kw[name].is_contiguous()
    frag = {order[int(i)] for ctype, i in found if ctype == "uint4"}
    assert frag == set(probe_mingru_recur._FRAGMENTS) == {
        "enc0_wih", "enc1_wih", "dec1_wih", "out_w"}


def test_scratch_bytes_are_the_recount():
    """~475 KB a window at T=100 (g 2 x 3 x 51.2 KB, h 2 x 3 x 25.6 KB, x
    and y 14.4 KB): 10.34 GB at the probe's 21,760 windows, 3.09 ms at
    3.35 TB/s; 5.22 GB with one step of the loops."""
    f = probe_mingru_recur.scratch_bytes_moved
    assert f(1) == 475_200
    assert f(21_760) / 3.35e12 * 1e3 == pytest.approx(3.0867, rel=1e-4)
    assert f(21_760, loop_T=1) == pytest.approx(5.2219e9, rel=1e-4)


# --- one model of the kernels' bf16 sums

def tc_bf16_product(a: torch.Tensor, w: torch.Tensor, tc_sum: str = "split"):
    """a [R, K] @ w [K, M] (bf16 values held in float32) as the kernels sum
    it on the tensor cores: k-steps of 16 (K padded with zeros), each mma's
    products exact, added to its accumulator and the sum truncated toward
    zero to float32. "split" (both kernels' shipped sum): each pair of
    k-steps chained from zero (one mma where the pair has one k-step) and
    that partial added to the float32 sum to nearest. "chain" (row 10's
    probe instance): every k-step chained into the one sum in order.
    Returns float32 [R, M]."""
    KS = -(-a.shape[1] // 16)
    a64 = F.pad(a, (0, 16 * KS - a.shape[1])).double()
    w64 = F.pad(w, (0, 0, 0, 16 * KS - w.shape[0])).double()
    block = lambda ks: a64[:, 16 * ks:16 * ks + 16] @ w64[16 * ks:16 * ks + 16]
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float64)
    if tc_sum == "chain":
        for ks in range(KS):
            acc = _truncate(acc + block(ks))
        return acc.float()
    for kp in range(0, KS, 2):
        part = _truncate(block(kp))
        if kp + 1 < KS:
            part = _truncate(part + block(kp + 1))
        acc = (acc + part).float().double()
    return acc.float()


def test_the_model_truncates_each_mma_and_rounds_each_pair():
    """k-steps 0-3 whose products sum to 1, 0, 3*2^-26 and 3*2^-26: the
    chained sum truncates each small addend away and stays at 1, while the
    split sum adds the second pair's partial, 3*2^-25, to nearest: 1 +
    2^-23, the float32 nearest the exact sum. A negative sum truncates
    toward zero: -1 + 2^-30 gives -(1 - 2^-24), not the nearest, -1."""
    a, w = torch.zeros(1, 64), torch.zeros(64, 1)
    a[0, 0] = w[0, 0] = 1.0
    a[0, 32] = a[0, 48] = 0.75 * 2.0 ** -12
    w[32, 0] = w[48, 0] = 2.0 ** -12
    exact = torch.tensor(1.0 + 1.5 * 2.0 ** -24, dtype=torch.float64)
    assert float(tc_bf16_product(a, w, "chain")) == 1.0
    assert float(tc_bf16_product(a, w)) == 1.0 + 2.0 ** -23 == float(exact.float())
    a, w = torch.zeros(1, 32), torch.zeros(32, 1)
    a[0, 0], w[0, 0] = -1.0, 1.0
    a[0, 16] = w[16, 0] = 2.0 ** -15
    for tc_sum in ("split", "chain"):
        assert float(tc_bf16_product(a, w, tc_sum)) == -(1.0 - 2.0 ** -24)


# --- the minGRU probe (row 9) with the model's sums

def emulated_probe_gate(weights, Z, loop_T=None):
    """``probe_mingru_recur.mingru_gate_reference``'s function with every
    product over all T steps (encoder layers 0 and 1, decoder layer 1, the
    output head) summed as the kernel sums it (:func:`tc_bf16_product`,
    the bias added after the sum); the once-a-window products (mu,
    fc_latent_to_hidden, the decoder's constant layer-0 gates) and the rest
    as the plain version, in float32."""
    N, T, D = Z.shape
    TL = T if loop_T is None else loop_T
    r = bf16_round
    x = r(Z)
    W = {k: r(weights[k]) for k in probe_mingru_recur._MATMUL}
    sig = lambda v: 0.5 * (torch.tanh(0.5 * v) + 1.0)

    def tc(seq, k):                   # [N, T, K] -> [N, T, M]
        return tc_bf16_product(r(seq).reshape(N * T, -1), W[k]).reshape(N, T, -1)

    def project(seq, name):
        g = tc(seq, f"{name}_wih") + weights[f"{name}_b"]
        return r(torch.cat([sig(g[..., :H]), g[..., H:]], dim=-1))

    def sweep(z, hb):
        h, seq = x.new_zeros(N, H), x.new_zeros(N, T, H)
        for t in range(TL):
            zt, ht = (z, hb) if z.dim() == 2 else (z[:, t], hb[:, t])
            h = h + zt * (ht - h)
            seq[:, t] = r(h)
        return seq, h

    g = project(x, "enc0")
    seq, _ = sweep(g[..., :H], g[..., H:])
    g = project(seq, "enc1")
    _, h_last = sweep(g[..., :H], g[..., H:])
    m = h_last.mean(dim=1, keepdim=True)
    var = ((h_last - m) ** 2).mean(dim=1, keepdim=True)
    hl = ((h_last - m) * torch.rsqrt(var + probe_mingru_recur.LN_EPS)
          * weights["ln_scale"] + weights["ln_bias"])
    mu = r(hl) @ W["mu_w"] + weights["mu_b"]
    dec_in = torch.tanh(r(mu) @ W["z2h_w"] + weights["z2h_b"])
    g1 = r(dec_in) @ W["dec0_wih"] + weights["dec0_b"]
    seq, _ = sweep(sig(g1[:, :H]), g1[:, H:])
    g = project(seq, "dec1")
    seq, _ = sweep(g[..., :H], g[..., H:])
    y = r(tc(seq, "out_w") + weights["out_b"])
    return ((x[:, :TL] - y[:, :TL]) ** 2).sum(dim=(1, 2)) / (T * D)


@pytest.fixture(scope="module")
def probe_case():
    """256 random windows of 100 steps at the probe's widths (D=12, H=128,
    Z=16; two tiles of the JAX probe), the flax parameters and the port's
    kernel weights from one numpy seed; the JAX probe's mse (interpret
    mode), the plain version's and the model's at loop_T 100 and 1."""
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=H, num_layers=2,
                    use_layernorm=True, cell="min_gru")
    rng = np.random.default_rng(14)
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(256, 100, 12)).astype(np.float32)
    w = mingru_params_to_kernel_weights(vae_from_flax(params, cfg))
    Zt = torch.from_numpy(Z)
    out = {}
    for loop_T in (None, 1):
        with pltpu.force_tpu_interpret_mode():
            jax_mse = np.asarray(jax_mingru_recur.make_gate(loop_T)(params, jnp.asarray(Z)))
        out[loop_T] = dict(
            jax=jax_mse,
            plain=probe_mingru_recur.mingru_gate_reference(w, Zt, loop_T).numpy(),
            model=emulated_probe_gate(w, Zt, loop_T).numpy())
    return out


@pytest.mark.parametrize("loop_T", [None, 1])
def test_probe_gate_with_the_kernels_sums_matches_the_jax_probe(probe_case, loop_T):
    got = probe_case[loop_T]
    assert got["model"].shape == got["jax"].shape == (256,)
    assert np.isfinite(got["model"]).all()
    if loop_T is None:                # over 100 steps the sums' order shows
        assert not np.array_equal(got["model"], got["plain"])
    _assert_within(got["model"], got["jax"], BF16_TOL)


@pytest.mark.parametrize("loop_T", [None, 1])
def test_probe_gate_with_the_kernels_sums_holds_the_card_tolerance(probe_case, loop_T):
    got = probe_case[loop_T]
    _assert_within(got["model"], got["plain"], PROBE_TOL["gate"])


def test_phase_9_holds_the_probe_against_exact_sums():
    """``chip_smoke.py`` phase 9's minGRU case (``random_vae(420)``, 1,000
    windows) at loop_T=1, where one bf16 flip of a window's step 0 moves its
    mse as far as ``PROBE_TOL["gate"]``'s max. Only step 0 counts, so the
    windows are cut to it here (every mse scales by T, the relative errors
    not). The float32-sum plain version is a flip (1.112e-4) from the plain
    version with float64 sums at one window, where the model of the kernel's
    sums agrees with exact sums; the model is within the tolerance of exact
    sums. So phase 9 holds the kernel against the float64-sum version."""
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=H, num_layers=2,
                    use_layernorm=True, cell="min_gru")
    rng = np.random.default_rng(420)
    w = mingru_params_to_kernel_weights(vae_from_flax(random_flax_vae_params(rng, cfg), cfg))
    Z = torch.from_numpy(rng.normal(size=(1000, 100, 12)).astype(np.float32))
    Z1 = Z[:, :1].contiguous()
    ref = probe_mingru_recur.mingru_gate_reference(w, Z1, 1, sum_dtype=torch.float64)
    ref32 = probe_mingru_recur.mingru_gate_reference(w, Z1, 1)
    model = emulated_probe_gate(w, Z1, 1)
    tol = PROBE_TOL["gate"]
    _assert_within(model, ref, tol)
    assert _rel_errs(ref32, ref)[0] > tol[0]           # the float32 sums' flip
    i = int((ref32 - ref).abs().argmax())
    assert model[i] == ref[i] != ref32[i]


# --- row 10's bf16 mode with the model's sums

def emulated_matmul_loop_bf16(w, x, tc_sum, T=100):
    """``matmul_loop_reference(w, x, "bf16")`` with each step's product
    g^T = bf16(h)^T bf16(W)^T summed as ``tc_sum`` says (rows 0:H, the ones
    that feed h)."""
    w_t = bf16_round(w[:H]).t()
    h = x[:H].clone()
    for _ in range(T):
        g = tc_bf16_product(bf16_round(h).t(), w_t, tc_sum).t()
        h = torch.tanh(g) * 0.25 + h * 0.75
    return h


def _witnesses(tiles, seed):
    """Row 10's bf16 mode on ``make_inputs(tiles, seed)``, T=100: the model
    with each sum, the plain version and float64 sums; each against float64
    sums as (max_rel, mean_rel, elements more than one bf16 ulp off),
    printed (``-s`` shows them)."""
    w, x = probe_f32_cliff.make_inputs(tiles, seed=seed)
    f64 = probe_f32_cliff.matmul_loop_reference(w, x, "bf16", sum_dtype=torch.float64)
    got = {s: emulated_matmul_loop_bf16(w, x, s) for s in ("split", "chain")}
    got["plain"] = probe_f32_cliff.matmul_loop_reference(w, x, "bf16")
    errs = {}
    for name, v in got.items():
        errs[name] = (*_rel_errs(v, f64), over_one_bf16_ulp(v, f64))
        print(f"{tiles} tile(s), seed {seed}, {name} vs float64 sums: max_rel "
              f"{errs[name][0]:.3e}, mean_rel {errs[name][1]:.3e}, "
              f"{errs[name][2]} of {f64.numel()} over one bf16 ulp")
    return got, errs


def test_matmul_loop_split_sum_drifts_no_farther_than_chained():
    """One tile: the split sum is no farther from float64 sums than the
    chained one, by the drift the truncation leaves (mean relative error,
    elements more than one bf16 ulp off; the max is one element's), and it
    holds the card's bf16 tolerance against the plain version."""
    got, errs = _witnesses(1, 1)
    assert errs["split"][1] <= errs["chain"][1] and errs["split"][2] <= errs["chain"][2]
    _assert_within(got["split"], got["plain"], PROBE_TOL["matmul_bf16"])


def test_matmul_loop_model_reads_the_card_case_as_the_card_did():
    """The card case [bf16-34-100] of
    ``tests/test_torch_cuda.py::test_probe_matmul_loop_kernel_matches_plain_version``
    (34 tiles, seed 34): the chained model reads what the chained kernel
    reads on the card against float64 sums (max_rel 1.319e-2, mean 1.96e-4,
    26,102 elements over one bf16 ulp; PERF.md §6), and the split sum halves
    the drift (mean, elements) to about the plain version's. The model's
    split max stays at one column that the card's split sum does not keep
    (PERF.md §6), so the max is not held here."""
    got, errs = _witnesses(34, 34)
    assert 1.30e-2 <= errs["chain"][0] <= 1.34e-2
    assert 1.8e-4 <= errs["chain"][1] <= 2.2e-4
    assert errs["split"][1] <= 0.5 * errs["chain"][1]
    assert errs["split"][2] <= 0.5 * errs["chain"][2]
    assert errs["split"][1] <= 1.1 * errs["plain"][1]


@pytest.mark.parametrize("mode, tc, ok", [
    ("bf16", "chain", True), ("bf16x3", "chain", True), ("bf16", "split", True),
    ("f32", "split", True), ("f32", "chain", False), ("vpu", "chain", False),
    ("bf16", "pairs", False),
])
def test_matmul_loop_takes_the_chained_sum_in_tensor_core_modes_only(mode, tc, ok):
    """``tc`` says how the tensor-core modes sum; both sums have the one
    plain version, which the CPU runs."""
    w, x = probe_f32_cliff.make_inputs(1, seed=2)
    if not ok:
        with pytest.raises(ValueError, match="tc"):
            probe_f32_cliff.matmul_loop(w, x, mode, T=2, tc=tc)
        return
    before = probe_f32_cliff.matmul_loop.launches
    got = probe_f32_cliff.matmul_loop(w, x, mode, T=2, tc=tc)
    assert probe_f32_cliff.matmul_loop.launches == before
    assert torch.equal(got, probe_f32_cliff.matmul_loop_reference(w, x, mode, T=2))
