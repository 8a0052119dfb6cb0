"""The port's three probes (plain versions, on the CPU) against the JAX
package's own probes under ``tools/``, run unedited in TPU interpret mode.

Inputs and weights are made with numpy from a seed and handed to both sides.
Each comparison is held on two relative errors, (max |got - want| /
max |want|, mean |got - want| / mean |want|), with tolerances set from what
was measured, each with its margin:

- float32 paths (``matmul_loop`` vpu, f32 and bf16x3): (1e-5, 1e-6);
  measured max 1.4e-7, 1.7e-7, 1.1e-6. The two sum in other orders.
- bf16 paths (``matmul_loop`` bf16 at T=5, ``gate_variant`` B-E,
  ``make_gate``): (5e-4, 3e-6). A stored bf16 value whose last bit flips
  between the two (another order of the float32 sums before the rounding)
  moves one element by a bf16 ulp, 2^-8, and the recurrence carries it:
  measured max 1.6e-4 (``matmul_loop`` bf16), 5.0e-5 (``make_gate`` with
  one step), 2.3e-6 or less else; mean 9.3e-7 or less. A kernel that drops
  a rounding, adds one or takes another LayerNorm eps moves every element:
  the mean by 1.2e-5 (``gate_variant`` with eps 1e-5) to 1.7e-3
  (``matmul_loop`` in float32). The planted-fault tests show each fails.
- bf16 activations (``gate_variant`` F): (3e-4, 1e-4). JAX's and PyTorch's
  float32 tanh and sigmoid differ in their last bits, and rounding each
  activation to bf16 turns some of those into a bf16 ulp: measured (6.1e-5,
  2.3e-5). Dropping those roundings moves the mean by 2.7e-5 only, so the
  ``act_bf16`` knob is pinned by the planted fault on B, at B's tolerance.
- bf16x3 against the float32 loop: (3e-4, 1e-4); measured at most (1.2e-4,
  3.3e-5) at T=100 over 14 input seeds and (4.8e-6, 2.3e-6) at T=5, where
  bf16 alone is (1.4e-2, 6.2e-3) or more away.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from shm_tpu_torch.config import VAEConfig
from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax
from shm_tpu_torch.ops import (
    fused_vae_gate_reference, mingru_params_to_kernel_weights,
    vae_params_to_kernel_weights,
)
from shm_tpu_torch.ops._gate import bf16_round
from shm_tpu_torch.tools import probe_f32_cliff, probe_mingru_recur, probe_vpu_bound
from shm_tpu_torch.tools.workload import (
    PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, bound_ms,
)

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "tools")):
    if p not in sys.path:
        sys.path.insert(0, p)

import probe_f32_cliff as jax_f32_cliff            # noqa: E402  tools/
import probe_mingru_recur as jax_mingru_recur      # noqa: E402
import probe_vpu_bound as jax_vpu_bound            # noqa: E402
from chip_smoke import over_one_bf16_ulp            # noqa: E402

F32_TOL, BF16_TOL, ACT_BF16_TOL = (1e-5, 1e-6), (5e-4, 3e-6), (3e-4, 1e-4)
BF16X3_F32_TOL = (3e-4, 1e-4)

# pytest-xdist runs several test files at once on the same cores
torch.set_num_threads(1)


def _rel_errs(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    return d.max() / np.abs(want).max(), d.mean() / np.abs(want).mean()


def _within(got, want, tol) -> bool:
    max_rel, mean_rel = _rel_errs(got, want)
    return max_rel <= tol[0] and mean_rel <= tol[1]


def _assert_close(got, want, tol):
    assert _within(got, want, tol), (_rel_errs(got, want), tol)


# --- matmul_loop (row 10)

T_SMALL, TILES_SMALL = 5, 2


@pytest.fixture(scope="module")
def small_jax_matmul_loop():
    """The JAX probe's ``matmul_loop`` at T=5 and 2 tiles: it reads the module
    globals ``T`` / ``N_TILES`` when it traces, so they are set here (and the
    jit cache cleared) and restored afterwards."""
    saved = jax_f32_cliff.T, jax_f32_cliff.N_TILES
    jax_f32_cliff.T, jax_f32_cliff.N_TILES = T_SMALL, TILES_SMALL
    jax_f32_cliff.matmul_loop.clear_cache()
    yield jax_f32_cliff.matmul_loop
    jax_f32_cliff.T, jax_f32_cliff.N_TILES = saved
    jax_f32_cliff.matmul_loop.clear_cache()


@pytest.fixture(scope="module")
def jax_matmul_loop(small_jax_matmul_loop):
    """The inputs and the JAX probe's output in every mode at T=5, 2 tiles."""
    w, x = probe_f32_cliff.make_inputs(TILES_SMALL, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = {mode: np.asarray(small_jax_matmul_loop(
            jnp.asarray(w.numpy()), jnp.asarray(x.numpy()), mode))
            for mode in probe_f32_cliff.MODES}
    return w, x, want


@pytest.mark.parametrize("mode", probe_f32_cliff.MODES)
def test_matmul_loop_matches_the_jax_probe(jax_matmul_loop, mode):
    w, x, want = jax_matmul_loop
    before = probe_f32_cliff.matmul_loop.launches
    got = probe_f32_cliff.matmul_loop(w, x, mode, T=T_SMALL)
    assert probe_f32_cliff.matmul_loop.launches == before   # the CPU never launches
    assert got.shape == want[mode].shape == (128, TILES_SMALL * 256)
    _assert_close(got.numpy(), want[mode], BF16_TOL if mode == "bf16" else F32_TOL)


@pytest.mark.parametrize("case", ["jax_f32_T5", "plain_f32_T100"])
def test_matmul_loop_bf16x3_is_float32_accurate(jax_matmul_loop, case):
    """bf16x3 close to the float32 loop, where bf16 alone is not."""
    tol = BF16X3_F32_TOL
    if case == "jax_f32_T5":
        (w, x, want), T = jax_matmul_loop, T_SMALL
        f32 = want["f32"]
    else:       # the farthest of the 14 seeds measured
        (w, x), T = probe_f32_cliff.make_inputs(1, seed=1), 100
        f32 = probe_f32_cliff.matmul_loop(w, x, "f32", T=T).numpy()
    _assert_close(probe_f32_cliff.matmul_loop(w, x, "bf16x3", T=T).numpy(), f32, tol)
    assert not _within(probe_f32_cliff.matmul_loop(w, x, "bf16", T=T).numpy(), f32, tol)


def test_matmul_loop_bf16_witnesses_agree_at_34_tiles(small_jax_matmul_loop):
    """The inputs of the card case ``[bf16-34-100]`` of
    ``test_torch_cuda.py::test_probe_matmul_loop_kernel_matches_plain_version``
    (34 tiles, seed 34, T=100), whose kernel reads max_rel 1.186e-2 there
    against the card's (1e-2, 1e-3). Three bf16 versions on the CPU, each
    with float32 sums or better: the port's plain version, the same with
    float64 sums, and the JAX probe in interpret mode. Measured max_rel
    4.6e-3 (plain against float64) and 7.5e-3 (JAX against either), mean
    1.5e-4 or less, so the card's tolerance holds for them at these inputs;
    ``-s`` prints each pair's readings."""
    tiles, T = 34, 100
    w, x = probe_f32_cliff.make_inputs(tiles, seed=tiles)
    plain = probe_f32_cliff.matmul_loop(w, x, "bf16", T=T).numpy()
    f64 = probe_f32_cliff.matmul_loop_reference(
        w, x, "bf16", T=T, sum_dtype=torch.float64).numpy()
    saved = jax_f32_cliff.T, jax_f32_cliff.N_TILES
    jax_f32_cliff.T, jax_f32_cliff.N_TILES = T, tiles
    jax_f32_cliff.matmul_loop.clear_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            jax_out = np.array(small_jax_matmul_loop(
                jnp.asarray(w.numpy()), jnp.asarray(x.numpy()), "bf16"))
    finally:
        jax_f32_cliff.T, jax_f32_cliff.N_TILES = saved
        jax_f32_cliff.matmul_loop.clear_cache()
    assert not np.array_equal(plain, f64)          # the sums' order shows
    for name, got, want in (("plain vs float64 sums", plain, f64),
                            ("JAX vs float64 sums", jax_out, f64),
                            ("JAX vs plain", jax_out, plain)):
        n = over_one_bf16_ulp(torch.from_numpy(got), torch.from_numpy(want))
        max_rel, mean_rel = _rel_errs(got, want)
        print(f"{name}: max_rel {max_rel:.3e}, mean_rel {mean_rel:.3e}, {n} of "
              f"{want.size} over one bf16 ulp")      # shown with -s
        _assert_close(got, want, (1e-2, 1e-3))


def test_matmul_loop_tolerance_fails_a_planted_fault(jax_matmul_loop):
    """A bf16 mode that multiplied in float32 is caught."""
    w, x, want = jax_matmul_loop
    got = probe_f32_cliff.matmul_loop(w, x, "f32", T=T_SMALL)
    assert not _within(got.numpy(), want["bf16"], BF16_TOL)


@pytest.mark.parametrize("bad, match", [
    (dict(mode="tf32"), "mode must be"),
    (dict(ncols=200), "x must be"),
    (dict(h=64), "w must be"),
    (dict(T=-1), "T must be"),
    (dict(dtype=torch.float64), "float32"),
])
def test_matmul_loop_argument_checks(bad, match):
    h = bad.get("h", 128)
    w = torch.zeros(4 * h, h, dtype=bad.get("dtype", torch.float32))
    x = torch.zeros(512, bad.get("ncols", 256))
    with pytest.raises(ValueError, match=match):
        probe_f32_cliff.matmul_loop(w, x, bad.get("mode", "f32"), T=bad.get("T", 1))


def test_matmul_loop_counts_the_work():
    assert probe_f32_cliff.matmul_loop_flops(21 * 256, "f32") == pytest.approx(70.5e9, rel=1e-3)
    card, per_sm = probe_f32_cliff.matmul_loop_bound_ms(21 * 256, "f32")
    assert card == pytest.approx(1.052, rel=1e-3)
    assert per_sm == pytest.approx(6.61, rel=1e-3)
    card, per_sm = probe_f32_cliff.matmul_loop_bound_ms(21 * 256, "bf16")
    assert (card, per_sm) == pytest.approx((0.0713, 0.448), rel=1e-2)
    assert probe_f32_cliff.matmul_loop_flops(256, "bf16x3") == 3 * \
        probe_f32_cliff.matmul_loop_flops(256, "bf16")
    assert probe_f32_cliff.matmul_loop_flops(256, "vpu") == 0.0


# the kernel's grid at the TPU probe's 21 tiles (5,376 columns): one block a
# 256-column tile for vpu, 48 columns a block (112 blocks, one wave on 132
# SMs) for the product modes; the bound at that grid is the card's figure
# times 132 * 48 / 5,376
@pytest.mark.parametrize("mode, blocks, grid_ms", [
    ("vpu", 21, 0.001643), ("f32", 112, 1.2395), ("bf16", 112, 0.08397),
    ("bf16x3", 112, 0.2519),
])
def test_matmul_loop_grid_at_21_tiles(mode, blocks, grid_ms):
    ncols = 21 * 256
    assert probe_f32_cliff.matmul_loop_blocks(ncols, mode) == blocks
    grid = probe_f32_cliff.matmul_loop_grid_bound_ms(ncols, mode)
    assert grid == pytest.approx(grid_ms, rel=1e-3)
    card, per_sm = probe_f32_cliff.matmul_loop_bound_ms(ncols, mode)
    assert card <= grid <= per_sm


# the blocks spread evenly over the 132 SMs: 24 tiles (128 blocks of 48
# columns) are one wave, 25 (134) and 34 (182) two
@pytest.mark.parametrize("tiles, blocks, waves", [
    (1, 6, 1), (24, 128, 1), (25, 134, 2), (34, 182, 2),
])
def test_matmul_loop_grid_bound_counts_the_waves(tiles, blocks, waves):
    ncols = tiles * 256
    for mode in ("f32", "bf16x3"):
        assert probe_f32_cliff.matmul_loop_blocks(ncols, mode) == blocks
        card, _ = probe_f32_cliff.matmul_loop_bound_ms(ncols, mode)
        assert probe_f32_cliff.matmul_loop_grid_bound_ms(ncols, mode) == \
            pytest.approx(card * 132 * 48 * waves / ncols)


@pytest.mark.parametrize("flops, nbytes, peak, want", [
    (989e9, 0.0, PEAK_BF16_FLOPS, (1.0, "operations")),
    (67e9, 1e6, PEAK_F32_FLOPS, (1.0, "operations")),
    (0.0, 3.35e9, PEAK_F32_FLOPS, (1.0, "bytes")),
])
def test_bound_is_the_larger_of_operations_and_bytes(flops, nbytes, peak, want):
    got = bound_ms(flops, nbytes, peak)
    assert got[1] == want[1] and got[0] == pytest.approx(want[0])
    assert PEAK_BYTES == 3.35e12


# --- gate_variant (row 8)

@pytest.fixture(scope="module")
def lstm_case():
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=32, num_layers=2,
                    use_layernorm=True)
    rng = np.random.default_rng(8)
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(64, 10, 12)).astype(np.float32)
    return params, vae_params_to_kernel_weights(vae_from_flax(params, cfg)), Z


@pytest.fixture(scope="module")
def jax_gate_variants(lstm_case):
    """The JAX probe's MSE for each of its variants B-F."""
    params, _, Z = lstm_case
    with pltpu.force_tpu_interpret_mode():
        return {name: np.asarray(jax_vpu_bound.gate_variant(
            params, jnp.asarray(Z), batch_tile=32, **kw))
            for name, kw in probe_vpu_bound.VARIANTS.items()}


@pytest.mark.parametrize("variant", list(probe_vpu_bound.VARIANTS))
def test_gate_variant_matches_the_jax_probe(lstm_case, jax_gate_variants, variant):
    _, w, Z = lstm_case
    kw = probe_vpu_bound.VARIANTS[variant]
    want = jax_gate_variants[variant]
    before = probe_vpu_bound.gate_variant.launches
    got = probe_vpu_bound.gate_variant(w, torch.from_numpy(Z), **kw).numpy()
    assert probe_vpu_bound.gate_variant.launches == before
    assert got.shape == want.shape == (64,)
    _assert_close(got, want, ACT_BF16_TOL if kw.get("act_bf16") else BF16_TOL)


# each changes one knob of the variant it is held against, at that variant's
# tolerance: the f32 run and the model's eps against D, bf16 activations
# added to B and to D
PLANTED_GATE_FAULTS = {
    "float32_operands": ("D_probe_baseline", dict(bf16="none")),
    "bf16_weights_only": ("D_probe_baseline", dict(bf16="weights")),
    "model_layernorm_eps": ("D_probe_baseline", dict(ln_eps=1e-5)),
    "bf16_activations_on_B": ("B_sig_via_tanh", dict(sig_via_tanh=True, act_bf16=True)),
    "bf16_activations_on_D": ("D_probe_baseline", dict(act_bf16=True)),
}


@pytest.mark.parametrize("fault", list(PLANTED_GATE_FAULTS))
def test_gate_variant_tolerance_fails_a_planted_fault(lstm_case, jax_gate_variants, fault):
    _, w, Z = lstm_case
    variant, kw = PLANTED_GATE_FAULTS[fault]
    got = probe_vpu_bound.gate_variant(w, torch.from_numpy(Z), **kw).numpy()
    assert not _within(got, jax_gate_variants[variant], BF16_TOL), _rel_errs(
        got, jax_gate_variants[variant])


def test_gate_variant_interleave_changes_no_number(lstm_case):
    _, w, Z = lstm_case
    Zt = torch.from_numpy(Z)
    a = probe_vpu_bound.gate_variant(w, Zt, sig_via_tanh=True)
    b = probe_vpu_bound.gate_variant(w, Zt, sig_via_tanh=True, interleave=2)
    assert torch.equal(a, b)


def test_gate_variant_is_the_gate_in_bf16(lstm_case):
    """The probe is the shipping gate with its numerics knobs: float32 and the
    model's eps give ``fused_vae_gate``'s plain version, and bf16 weights
    only give it on the bf16-rounded weights (float32 tolerance)."""
    _, w, Z = lstm_case
    Zt = torch.from_numpy(Z)
    ship = lambda wts: fused_vae_gate_reference(
        wts, Zt, num_layers=2, use_layernorm=True, with_residual=False)[0]
    eps = probe_vpu_bound.MODEL_LN_EPS
    _assert_close(probe_vpu_bound.gate_variant(w, Zt, bf16="none", ln_eps=eps),
                  ship(w), F32_TOL)
    w_bf16 = {k: (bf16_round(v) if k in probe_vpu_bound._MATMUL else v)
              for k, v in w.items()}
    _assert_close(probe_vpu_bound.gate_variant(w, Zt, bf16="weights", ln_eps=eps),
                  ship(w_bf16), F32_TOL)


@pytest.mark.parametrize("variant", ["T_tensor_cores", "TC_chained_sum"])
def test_gate_variant_tc_plain_version_is_the_float32_gate(lstm_case, variant):
    """Variants T and TC (the tensor-core body with its shipping and its
    chained sum, 3xTF32 products at about float32's accuracy) have the
    float32 gate as their plain version: on the CPU each is variant A's
    number, bit for bit."""
    _, w, Z = lstm_case
    Zt = torch.from_numpy(Z)
    got = probe_vpu_bound.gate_variant(
        w, Zt, **probe_vpu_bound.PORT_VARIANTS[variant])
    assert torch.equal(got, probe_vpu_bound.gate_variant(w, Zt, **probe_vpu_bound.A_F32))


def test_gate_variant_one_term_plain_version_rounds_the_lstm_operands(lstm_case):
    """Variant T1's plain version (the planted fault: TF32 products of one
    term) moves variant A's mse by TF32's rounding, far more than a float32
    order change and far less than bf16."""
    _, w, Z = lstm_case
    Zt = torch.from_numpy(Z)
    one = probe_vpu_bound.gate_variant(w, Zt, **probe_vpu_bound.PORT_VARIANTS["T1_one_term"])
    a = probe_vpu_bound.gate_variant(w, Zt, **probe_vpu_bound.A_F32)
    assert 1e-6 < float(((one - a).abs() / a.abs()).max()) < 1e-2


@pytest.mark.parametrize("bad, match", [
    (dict(H=64), "unsupported shape"),
    (dict(interleave=3), "interleave"),
    (dict(L=1), "2-layer"),
    (dict(T=1), "unsupported shape"),
])
def test_gate_variant_argument_checks(bad, match):
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=bad.get("H", 128),
                    num_layers=bad.get("L", 2), use_layernorm=True)
    w = vae_params_to_kernel_weights(vae_from_flax(
        random_flax_vae_params(np.random.default_rng(0), cfg), cfg))
    Z = torch.zeros(2, bad.get("T", 5), 12)
    with pytest.raises(ValueError, match=match):
        probe_vpu_bound._check(w, Z, bad.get("interleave", 1))


@pytest.mark.parametrize("knobs, match", [
    (dict(bf16="f16"), "bf16 must be"),
    (dict(bf16="none", sig_via_tanh=True), "take bf16='all'"),
    (dict(bf16="weights", act_bf16=True), "take bf16='all'"),
    (dict(ln_eps=0.0), "ln_eps"),
    (dict(tc=True), "tc must be None or one of"),
    (dict(tc="split"), "tc takes bf16='none'"),
    (dict(tc="one_term", bf16="none", interleave=2), "and interleave=1"),
])
def test_gate_variant_knob_checks_on_every_device(lstm_case, knobs, match):
    _, w, Z = lstm_case
    with pytest.raises(ValueError, match=match):
        probe_vpu_bound.gate_variant(w, torch.from_numpy(Z), **knobs)


# --- make_gate (row 9)

@pytest.fixture(scope="module")
def mingru_case():
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=32, num_layers=2,
                    use_layernorm=True, cell="min_gru")
    rng = np.random.default_rng(9)
    params = random_flax_vae_params(rng, cfg)
    Z = rng.normal(size=(128, 10, 12)).astype(np.float32)
    return params, mingru_params_to_kernel_weights(vae_from_flax(params, cfg)), Z


@pytest.fixture(scope="module")
def jax_make_gate(mingru_case):
    params, _, Z = mingru_case
    with pltpu.force_tpu_interpret_mode():
        return {loop_T: np.asarray(jax_mingru_recur.make_gate(loop_T)(
            params, jnp.asarray(Z))) for loop_T in (None, 1)}


@pytest.mark.parametrize("loop_T", [None, 1])
def test_make_gate_matches_the_jax_probe(mingru_case, jax_make_gate, loop_T):
    _, w, Z = mingru_case
    want = jax_make_gate[loop_T]
    before = probe_mingru_recur.make_gate.launches
    got = probe_mingru_recur.make_gate(loop_T)(w, torch.from_numpy(Z)).numpy()
    assert probe_mingru_recur.make_gate.launches == before
    assert got.shape == want.shape == (128,)
    _assert_close(got, want, BF16_TOL)


@pytest.mark.parametrize("loop_T", [None, 1])
@pytest.mark.parametrize("fault", [dict(bf16=False), dict(ln_eps=1e-5)],
                         ids=["float32_scratch", "model_layernorm_eps"])
def test_make_gate_tolerance_fails_a_planted_fault(mingru_case, jax_make_gate,
                                                   fault, loop_T):
    _, w, Z = mingru_case
    got = probe_mingru_recur.mingru_gate_reference(w, torch.from_numpy(Z),
                                                   loop_T, **fault).numpy()
    assert not _within(got, jax_make_gate[loop_T], BF16_TOL), _rel_errs(
        got, jax_make_gate[loop_T])


def test_make_gate_with_one_step_reads_step_zero_only(mingru_case):
    _, w, Z = mingru_case
    Zt = torch.from_numpy(Z)
    a = probe_mingru_recur.make_gate(1)(w, Zt)
    Zt2 = Zt.clone()
    Zt2[:, 1:] = 0.0                  # later steps feed only ignored columns
    Zt2[:, 1:, 0] = 7.0
    torch.testing.assert_close(probe_mingru_recur.make_gate(1)(w, Zt2), a)


@pytest.mark.parametrize("bad, match", [
    (dict(H=64), "unsupported shape"),
    (dict(L=3), "2-layer"),
    (dict(loop_T=6), "loop_T"),
    (dict(loop_T=0), "loop_T"),
])
def test_make_gate_argument_checks(bad, match):
    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=bad.get("H", 128),
                    num_layers=bad.get("L", 2), use_layernorm=True, cell="min_gru")
    w = mingru_params_to_kernel_weights(vae_from_flax(
        random_flax_vae_params(np.random.default_rng(0), cfg), cfg))
    with pytest.raises(ValueError, match=match):
        probe_mingru_recur._check(w, torch.zeros(2, 5, 12), bad.get("loop_T"))


# --- the workload and the probes' mains

def test_trained_workload_is_the_committed_test_split():
    from shm_tpu_torch.tools.workload import load_trained_workload

    wl = load_trained_workload()
    assert wl.W.shape == (3636, 100, 12) and wl.W.dtype == np.float32
    assert np.bincount(wl.y).tolist() == [2020, 808, 808]
    thr = json.loads((ROOT / "data/4dof/processed/vae_threshold.json").read_text())
    assert wl.threshold == float(thr["threshold"])
    assert wl.vae.cell == "lstm" and wl.mean.shape == wl.std.shape == (12,)
    Z = probe_vpu_bound.tiled_windows(wl, 4000)
    assert Z.shape == (4000, 100, 12)
    np.testing.assert_array_equal(Z[3636], Z[0])


@pytest.mark.parametrize("module, argv", [
    (probe_f32_cliff, ["--device", "cpu", "--tiles", "1", "--T", "2"]),
    (probe_vpu_bound, ["--device", "cpu", "--windows", "40"]),
    (probe_mingru_recur, ["--device", "cpu", "--windows", "16"]),
])
def test_probe_main_runs_the_plain_versions_on_the_cpu(module, argv, capsys):
    module.main(argv)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines and all(row.get("ms") is None for row in lines)


def test_probe_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_f32_cliff.main([])
