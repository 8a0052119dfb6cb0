"""Probe: what share of the minGRU gate goes to its serial recurrence sweeps.

Counterpart of ``tools/probe_mingru_recur.py``. ``make_gate(loop_T)`` returns
``gate(weights, Z) -> mse [N]``, a clone of the gate-only minGRU-VAE pass
(2 layers, LayerNorm on) built as the TPU clone is: layer by layer, each
layer's projection over all T steps into a bf16 scratch, then the sweep
``h_t = h_{t-1} + z_t * (h~_t - h_{t-1})``. The sweeps and the output-MSE loop
run ``loop_T`` steps (None = T); the MSE still divides by T*D, so with
``loop_T=1`` the result depends on step 0 only. Numerics as the TPU clone:
product operands in bf16, sums in float32, sigmoid as 0.5*(tanh(x/2)+1), the
g / h / y scratch in bf16, LayerNorm eps 1e-6 (that clone's; the model's is
1e-5).

On a CUDA tensor the gate launches ``ops/csrc/probe_mingru_gate.cu`` with its
scratch in device memory (sized from N; a request that does not fit raises)
and adds one to ``make_gate.launches``; on a CPU tensor it runs
:func:`mingru_gate_reference`. The kernel runs every product over all T
steps on the tensor cores in bf16 (``mma.sync`` m16n8k16, each pair of
k-steps summed from zero and added to the float32 sum), reading those
weights as the A fragments :func:`kernel_weights` packs once a call.
``main`` times the shipping ``fused_mingru_gate``, the clone at full T and
with loops cut to 1, and prints the sweeps' share.

    python -m shm_tpu_torch.tools.probe_mingru_recur        # on the card
    python -m shm_tpu_torch.tools.probe_mingru_recur --device cpu --windows 64
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
from typing import Dict, Optional

import numpy as np
import torch

from shm_tpu_torch.ops._build import count_launch, load_library, raise_on_error
from shm_tpu_torch.ops._gate import (
    bf16_a_fragments, bf16_round, check_weights, check_windows, pointer_array,
)
from shm_tpu_torch.tools.workload import timed

LN_EPS = 1e-6                     # tools/probe_mingru_recur.py:114
N_WINDOWS = 21760
_H, _D_MAX, _Z_MAX = 128, 16, 32
# pointer order of the C entry (csrc/probe_mingru_gate.cu)
_WEIGHT_ORDER = ("enc0_wih", "enc1_wih", "enc0_b", "enc1_b", "ln_scale",
                 "ln_bias", "mu_w", "mu_b", "z2h_w", "z2h_b", "dec0_wih",
                 "dec1_wih", "dec0_b", "dec1_b", "out_w", "out_b")
_MATMUL = ("enc0_wih", "enc1_wih", "mu_w", "z2h_w", "dec0_wih", "dec1_wih",
           "out_w")
# the products over all T steps, on the tensor cores: the kernel reads them
# as bf16 A fragments; the once-a-window ones (FMA pipes) as bf16 [in, out]
_FRAGMENTS = ("enc0_wih", "enc1_wih", "dec1_wih", "out_w")


def _sig(v: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.tanh(0.5 * v) + 1.0)


def mingru_gate_reference(weights: Dict[str, torch.Tensor], Z: torch.Tensor,
                          loop_T: Optional[int] = None, *, bf16: bool = True,
                          ln_eps: float = LN_EPS,
                          sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: mse [N]. Each product sums in
    ``sum_dtype`` and is rounded to float32; float64 gives the function with
    its sums all but exact, whatever order a float32 sum would take.
    ``bf16=False`` (every operand and scratch in float32) or another
    ``ln_eps`` is not the kernel's function: the checks use them to show
    that their tolerance fails a kernel that drops the probe's numerics."""
    N, T, D = Z.shape
    H = weights["mu_w"].shape[0]
    TL = T if loop_T is None else loop_T
    r = bf16_round if bf16 else (lambda v: v)
    x = r(Z.to(torch.float32))
    W = {k: r(weights[k]) for k in _MATMUL}

    def mm(a, k):
        return (r(a).to(sum_dtype) @ W[k].to(sum_dtype)).to(torch.float32)

    def project(seq, name):           # [N, T, in] -> the bf16 scratch [N, T, 2H]
        g = mm(seq, f"{name}_wih") + weights[f"{name}_b"]
        return r(torch.cat([_sig(g[..., :H]), g[..., H:]], dim=-1))

    def sweep(z, hb):                 # [N, T, H] each, or [N, H] constant
        const = z.dim() == 2
        h = x.new_zeros(N, H)
        seq = x.new_zeros(N, T, H)
        for t in range(TL):
            zt, ht = (z, hb) if const else (z[:, t], hb[:, t])
            h = h + zt * (ht - h)
            seq[:, t] = r(h)
        return seq, h

    g = project(x, "enc0")
    seq, _ = sweep(g[..., :H], g[..., H:])
    g = project(seq, "enc1")
    _, h_last = sweep(g[..., :H], g[..., H:])
    m = h_last.mean(dim=1, keepdim=True)
    var = ((h_last - m) ** 2).mean(dim=1, keepdim=True)
    hl = ((h_last - m) * torch.rsqrt(var + ln_eps) * weights["ln_scale"]
          + weights["ln_bias"])
    mu = mm(hl, "mu_w") + weights["mu_b"]
    dec_in = torch.tanh(mm(mu, "z2h_w") + weights["z2h_b"])
    g1 = mm(dec_in, "dec0_wih") + weights["dec0_b"]
    seq, _ = sweep(_sig(g1[:, :H]), g1[:, H:])
    g = project(seq, "dec1")
    seq, _ = sweep(g[..., :H], g[..., H:])
    y = r(mm(seq, "out_w") + weights["out_b"])
    acc = ((x[:, :TL] - y[:, :TL]) ** 2).sum(dim=(1, 2))
    return acc / (T * D)


def _check(weights, Z, loop_T):
    check_windows(Z)
    if "enc1_wih" not in weights or "dec2_wih" in weights or "ln_scale" not in weights:
        raise ValueError("the minGRU probe takes the 2-layer preset with LayerNorm")
    H, Zd = weights["mu_w"].shape
    N, T, D = Z.shape
    if H != _H or D > _D_MAX or Zd > _Z_MAX:
        raise ValueError(f"unsupported shape for the probe kernel: H={H} "
                         f"(need {_H}), D={D} (<= {_D_MAX}), Z={Zd} (<= {_Z_MAX})")
    if weights["enc0_wih"].shape != (D, 2 * H):
        raise ValueError(f"enc0_wih {tuple(weights['enc0_wih'].shape)} does "
                         f"not match D={D}, H={H}")
    if loop_T is not None and not 1 <= loop_T <= T:
        raise ValueError(f"loop_T must be in 1..{T}, got {loop_T}")
    check_weights(weights, _WEIGHT_ORDER, Z.device)
    return H, Zd


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("probe_mingru_gate")
    lib.shm_probe_mingru_gate.restype = ctypes.c_int
    lib.shm_probe_mingru_gate.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.shm_probe_mingru_gate_scratch_bytes.restype = ctypes.c_longlong
    lib.shm_probe_mingru_gate_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.shm_probe_mingru_gate_info.restype = ctypes.c_int
    lib.shm_probe_mingru_gate_info.argtypes = [ctypes.c_void_p]
    return lib


def kernel_weights(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """What the C entry reads, by the names of ``_WEIGHT_ORDER``: the
    products over all T (``_FRAGMENTS``) as :func:`bf16_a_fragments` of
    their [in, out] weight, the other matmul weights in bf16 [in, out], the
    rest as given (float32)."""
    return {k: (bf16_a_fragments(weights[k]) if k in _FRAGMENTS
                else weights[k].to(torch.bfloat16) if k in _MATMUL
                else weights[k]) for k in _WEIGHT_ORDER}


def kernel_info() -> dict:
    """How the card takes the kernel: registers and local-memory (spill)
    bytes a thread, threads and dynamic shared bytes a block, windows a
    block, blocks an SM at once."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    raise_on_error(lib, lib.shm_probe_mingru_gate_info(out), "probe_mingru_gate info")
    return dict(zip(("registers", "spill_bytes", "threads", "shared_bytes",
                     "windows_per_block", "blocks_per_sm"), out))


def scratch_bytes_moved(n: int, T: int = 100, D: int = 12,
                        loop_T: Optional[int] = None) -> float:
    """Bytes the project-then-sweep structure moves through device memory
    for n windows: per window g written by three projections and read by
    three sweeps (loop_T steps), h written by three sweeps and read by three
    projections (the output head's among them), the windows read by the
    first projection and the output loop, y written and read. Its bytes
    bound, beside the function's own (x once, mse)."""
    TL = T if loop_T is None else loop_T
    H, H2 = _H, 2 * _H
    g = 3 * T * H2 * 2 + 3 * TL * H2 * 2
    h = 3 * TL * H * 2 + 3 * T * H * 2
    xy = T * D * 4 + TL * D * 4 + T * D * 2 + TL * D * 2
    return float(n * (g + h + xy))


def _launch(weights, Z, loop_T):
    H, Zd = _check(weights, Z, loop_T)
    N, T, D = Z.shape
    mse = torch.empty(N, device=Z.device, dtype=torch.float32)
    if N == 0:
        return mse
    lib = _library()
    nbytes = lib.shm_probe_mingru_gate_scratch_bytes(N, T)
    free, _ = torch.cuda.mem_get_info(Z.device)
    if nbytes > free:
        raise MemoryError(f"the minGRU probe needs {nbytes / 2**30:.2f} GiB of "
                          f"scratch for N={N}, T={T}; {free / 2**30:.2f} GiB free")
    scratch = torch.empty(nbytes, device=Z.device, dtype=torch.uint8)
    w = kernel_weights(weights)
    ptrs = pointer_array(w, _WEIGHT_ORDER, _WEIGHT_ORDER)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = lib.shm_probe_mingru_gate(
            Z.data_ptr(), mse.data_ptr(), ptrs, len(_WEIGHT_ORDER),
            scratch.data_ptr(), N, T, D, H, Zd,
            T if loop_T is None else loop_T, stream)
    raise_on_error(lib, err, "probe_mingru_gate")
    count_launch(make_gate)
    return mse


def make_gate(loop_T: Optional[int] = None):
    """``gate(weights, Z) -> mse [N]`` with the sweeps cut to ``loop_T``
    steps (None = T); ``weights`` from ``mingru_params_to_kernel_weights``."""

    def gate(weights: Dict[str, torch.Tensor], Z: torch.Tensor) -> torch.Tensor:
        if Z.device.type == "cuda":
            return _launch(weights, Z, loop_T)
        if Z.device.type == "cpu":
            return mingru_gate_reference(weights, Z, loop_T)
        raise ValueError(f"make_gate: unsupported device {Z.device}")

    return gate


# kernel launches so far (every gate make_gate returns); callers reset it
make_gate.launches = 0


def probe_inputs(n: int = N_WINDOWS, device="cuda"):
    """The TPU probe's workload: a 4DOF-width minGRU VAE (2 layers, LayerNorm)
    from the port's initialiser with a generator seeded 0 and its kernel
    weights, and N random normal windows [N, 100, 12] from a numpy seed."""
    from shm_tpu_torch.config import VAEConfig
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.ops import mingru_params_to_kernel_weights

    cfg = VAEConfig(input_dim=12, latent_dim=16, hidden_dim=128, num_layers=2,
                    use_layernorm=True, cell="min_gru")
    vae = vae_from_config(cfg)
    vae.init_parameters(torch.Generator().manual_seed(0))
    vae = vae.to(device)
    rng = np.random.default_rng(1)
    Z = torch.from_numpy(rng.normal(size=(n, 100, 12)).astype(np.float32))
    return vae, mingru_params_to_kernel_weights(vae), Z.to(device)


def probe_table(weights, Z, reps: int = 5):
    """The shipping ``fused_mingru_gate``, the clone at full T and with the
    loops cut to 1, and the loops' share of the clone's time (``ms`` None
    off the card)."""
    from shm_tpu_torch.ops import fused_mingru_gate

    on_card = Z.device.type == "cuda"
    n = Z.shape[0]
    runs = {
        "shipping kernel": lambda: fused_mingru_gate(
            weights, Z, num_layers=2, use_layernorm=True, with_residual=False)[0],
        "probe clone (full T)": lambda: make_gate(None)(weights, Z),
        "loops truncated to 1": lambda: make_gate(1)(weights, Z),
    }
    rows, ms = [], {}
    for name, fn in runs.items():
        out = fn()
        ms[name] = timed(fn, reps) if on_card else None
        rows.append({"run": name, "ms": ms[name],
                     "win_per_sec": n / (ms[name] / 1e3) if on_card else None,
                     "mse_mean": float(out.mean())})
    full, rec1 = ms["probe clone (full T)"], ms["loops truncated to 1"]
    rows.append({"recurrence_loops_share": (full - rec1) / full
                 if on_card else None})
    return rows


def main(argv=None) -> None:
    from shm_tpu_torch.device import resolve_device, set_full_f32_precision

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; cpu runs the plain versions")
    ap.add_argument("--windows", type=int, default=N_WINDOWS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_full_f32_precision()
    _, weights, Z = probe_inputs(args.windows, device)
    for row in probe_table(weights, Z, args.reps):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
