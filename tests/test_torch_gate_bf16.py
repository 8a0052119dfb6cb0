"""The bf16 mode of the port's three gate kernels' plain versions
(``fused_*_gate_reference(dtype=torch.bfloat16, io_dtype=...)``) against the
JAX kernels at ``dtype=bf16`` (``shm_tpu/ops/fused_*.py``, interpret mode,
``emulate=True``: bf16 operands, float32 products and sums), each at the io
the JAX ``HybridScorer`` serves it (bf16 for attention, float32 for the
other two), called directly: ``make_hybrid_fn``'s interpret path drops the
bf16 io.

The inputs are 48 committed 4DOF test windows, evenly spread over the 3,636
(both sides of the gate), through each family's committed root. Bars:

- gate decisions (``mse > threshold`` of the root) equal;
- per-window mse relative difference, (max, mean): LSTM (1e-4, 2e-5),
  minGRU (1e-4, 1e-6) (measured 3.4e-5 / 4.1e-6 and 3.8e-7 / 1.3e-7);
  attention (3e-4, 8e-5) (measured 2.4e-4 / 5.4e-5). The attention stack
  stores its stream, q | k | v and o in bf16, so its mse follows any change
  of float32 sum order: the JAX kernel's streaming softmax form is 2.3e-4
  / 5.7e-5 from its packed form on these windows ("float-level
  differences only"), the port's plain version with float64 sums 2.8e-4 /
  4.9e-5 (``tests/bf16_readings.py rounding``). The bars are the round
  numbers that admit the JAX kernel's own other form
  (``test_attention_bars_admit_the_jax_kernels_other_form``); 1e-4 does not;
- the residual r within 2^-7 |r| + atol: 1e-4 for the LSTM (measured need
  6.2e-5: a float32 difference of h flips its bf16 rounding in the output
  head's operand), 3e-3 for the minGRU (1.9e-3: y itself is stored in bf16,
  so a flip moves r by 2 |x - y| ulp(y)), 1e-2 for attention (7.4e-3; the
  JAX kernel's two forms need 7.2e-3);
- the residual in the io type, summing to the mse;
- bf16 told apart from float32: on some window the port's bf16 mse differs
  from its float32 one by more than 3e-4 relative, and the port's float32
  mse differs from JAX's bf16 by more than the mean bar on average, so a
  float32 path cannot pass.
"""

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm_tpu.cli.stage4dof import Paths as JaxPaths
from shm_tpu.cli.stage4dof import _load_vae as jax_load_vae
from shm_tpu.config import Stage4DofConfig as JaxConfig
from shm_tpu.ops import (fused_attention_gate as jax_attention,
                         fused_mingru_gate as jax_mingru,
                         fused_vae_gate as jax_lstm)
from shm_tpu_torch.cli.stage4dof import Paths, _load_stats, _load_vae
from shm_tpu_torch.config import Stage4DofConfig
from shm_tpu_torch.data.windows import normalize_windows
from shm_tpu_torch.ops import FUSED_GATES
from shm_tpu_torch.ops._gate import (FRAG, FRAG_BF16, FRAG_K16, bf16_b_fragments,
                                    bf16_fragments, bf16_round, tf32x3_fragments,
                                    unpack_bf16_b_fragments, unpack_fragments)
from shm_tpu_torch.tools.workload import load_trained_workload
from shm_tpu_torch.utils.io import load_json

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {  # cell: (root, JAX kernel, serving io, (max, mean) mse bar, residual atol)
    "lstm": ("data/4dof", jax_lstm, None, (1e-4, 2e-5), 1e-4),
    "min_gru": ("data/4dof_mingru", jax_mingru, None, (1e-4, 1e-6), 3e-3),
    "attention": ("data/4dof_attention", jax_attention, torch.bfloat16,
                  (3e-4, 8e-5), 1e-2),
}
N_WINDOWS = 48
torch.set_num_threads(1)


@functools.cache
def _windows():
    W = load_trained_workload(ROOT / "data" / "4dof").W
    return W[np.linspace(0, len(W) - 1, N_WINDOWS).astype(int)]


@functools.cache
def _outputs(cell: str) -> dict:
    """The port's and the JAX package's outputs on the windows."""
    rel, jax_gate, io, bars, atol = FAMILIES[cell]
    root = ROOT / rel
    mean, std = _load_stats(Paths(str(root)))
    Z = normalize_windows(torch.from_numpy(_windows()), torch.as_tensor(mean),
                          torch.as_tensor(std)).contiguous()
    vae = _load_vae(Paths(str(root)), Stage4DofConfig())
    assert vae.cell == cell
    weights_fn, gate, reference = FUSED_GATES[cell]
    w = weights_fn(vae, torch.bfloat16)
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)
    before = (gate.launches, gate.bf16_launches)
    port = gate(w, Z, dtype=torch.bfloat16, io_dtype=io, **kw)
    assert (gate.launches, gate.bf16_launches) == before  # the CPU never launches
    port32 = reference(w, Z, **kw)
    jvae, params = jax_load_vae(JaxPaths(str(root)), JaxConfig())
    jkw = dict(interpret=True, emulate=True, dtype=jnp.bfloat16,
               io_dtype=jnp.bfloat16 if io is not None else None, **kw)
    if cell == "attention":
        jkw["batch_tile"] = 16
    as_np = lambda out: (np.asarray(out[0], np.float64),
                         np.asarray(out[1].astype(jnp.float32), np.float64))
    out = dict(jax=as_np(jax_gate(params, jnp.asarray(Z.numpy()), **jkw)))
    if cell == "attention":      # the JAX kernel's other softmax form
        out["jax_stream"] = as_np(jax_gate(params, jnp.asarray(Z.numpy()),
                                           stream=True, **jkw))
    thr = float(load_json(root / "processed" / "vae_threshold.json")["threshold"])
    return dict(cell=cell, io=io, bars=bars, atol=atol, Z=Z, thr=thr,
                port=port, port32=port32, **out)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    return _outputs(request.param)


def mse_rel(mse, mse_ref):
    return np.abs(np.asarray(mse, np.float64) - mse_ref) / mse_ref


def residual_atol_needed(r, r_ref):
    """The least atol with |r - r_ref| <= 2^-7 |r_ref| + atol everywhere."""
    return float((np.abs(r - r_ref) - 2.0 ** -7 * np.abs(r_ref)).max())


def test_mse_and_gates_match_jax(family):
    (mse, _), (mse_j, _) = family["port"], family["jax"]
    assert mse.dtype == torch.float32 and mse.shape == (N_WINDOWS,)
    rel = mse_rel(mse.numpy(), mse_j)
    bar_max, bar_mean = family["bars"]
    assert rel.max() <= bar_max and rel.mean() <= bar_mean, (rel.max(), rel.mean())
    thr = family["thr"]
    np.testing.assert_array_equal(mse.numpy() > thr, mse_j > thr)
    assert 0 < (mse_j > thr).sum() < N_WINDOWS     # both sides of the gate


def test_residual_matches_jax(family):
    (mse, resid), (_, resid_j) = family["port"], family["jax"]
    io = family["io"] or torch.float32
    assert resid.dtype == io and resid.shape == family["Z"].shape
    r = resid.double().numpy()
    need = residual_atol_needed(r, resid_j)
    assert need <= family["atol"], need
    if io == torch.float32:       # a bf16 residual is rounded after the sum
        np.testing.assert_allclose(r.mean(axis=(1, 2)), mse.numpy(), rtol=1e-5)


def test_bf16_is_told_apart_from_float32(family):
    (mse, _), (mse32, _), (mse_j, _) = (family["port"], family["port32"],
                                        family["jax"])
    own = (mse.double() - mse32.double()).abs() / mse32.double()
    assert own.max() > 3e-4
    assert mse_rel(mse32.numpy(), mse_j).mean() > family["bars"][1]


def test_attention_bars_admit_the_jax_kernels_other_form():
    """The JAX attention kernel's two softmax forms (``stream``, the same
    function) differ on these windows by more than 1e-4 per window and need
    a residual atol past 1e-5, and stay within the attention bars, as the
    port does."""
    family = _outputs("attention")
    (mse_s, r_s), (mse_j, r_j) = family["jax_stream"], family["jax"]
    rel = mse_rel(mse_s, mse_j)
    bar_max, bar_mean = family["bars"]
    assert 1e-4 < rel.max() <= bar_max and rel.mean() <= bar_mean
    assert 1e-5 < residual_atol_needed(r_s, r_j) <= family["atol"]


@pytest.mark.parametrize("cell", list(FAMILIES))
def test_kernel_weights_are_packed_for_one_precision(cell):
    """A weight dict holds the fragments of the precision it was packed
    for: ``*_frag`` (3xTF32) by default; for bf16 ``*_frag_bf16`` (of the
    bf16-rounded weight, small parts zero), and row 7 also ``*_frag_k16``
    (the m16n8k16 bf16 B fragments its resident body reads, 2 bytes a
    weight), each decoding to the bf16-rounded weight."""
    vae = _load_vae(Paths(str(ROOT / FAMILIES[cell][0])), Stage4DofConfig())
    weights_fn = FUSED_GATES[cell][0]
    w32, w16 = weights_fn(vae), weights_fn(vae, torch.bfloat16)
    suffixes = (FRAG_BF16, FRAG_K16) if cell == "attention" else (FRAG_BF16,)
    frag32 = {k[:-len(FRAG)] for k in w32 if k.endswith(FRAG)}
    assert frag32 and not any(k.endswith((FRAG_BF16, FRAG_K16)) for k in w32)
    assert set(w16) == {k for k in w32 if not k.endswith(FRAG)} | {
        b + sfx for b in frag32 for sfx in suffixes}
    for b in frag32:
        torch.testing.assert_close(w32[b + FRAG], tf32x3_fragments(w32[b]),
                                   rtol=0, atol=0)
        f = w16[b + FRAG_BF16]
        torch.testing.assert_close(f, bf16_fragments(w32[b]), rtol=0, atol=0)
        big, small = unpack_fragments(f)
        assert not small.any()
        torch.testing.assert_close(big[:w32[b].shape[0]], bf16_round(w32[b]),
                                   rtol=0, atol=0)
        if cell == "attention":
            f = w16[b + FRAG_K16]
            assert f.dtype == torch.int32 and f.numel() * 2 == w32[b].numel()
            assert torch.equal(f, bf16_b_fragments(w32[b]))
            torch.testing.assert_close(unpack_bf16_b_fragments(f),
                                       bf16_round(w32[b]), rtol=0, atol=0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        weights_fn(vae, torch.float16)


@pytest.mark.parametrize("dtype, io, match", [
    (torch.float64, None, "float32 or bfloat16"),
    (torch.float32, torch.bfloat16, "bfloat16 with bfloat16 io"),
    (torch.bfloat16, torch.float16, "float32 or bfloat16"),
])
def test_unsupported_precisions_raise(dtype, io, match):
    w = FUSED_GATES["lstm"][0](_load_vae(Paths(str(ROOT / "data/4dof")),
                                         Stage4DofConfig()))
    with pytest.raises(ValueError, match=match):
        FUSED_GATES["lstm"][1](w, torch.zeros(2, 5, 12), num_layers=2,
                               use_layernorm=True, dtype=dtype, io_dtype=io)
