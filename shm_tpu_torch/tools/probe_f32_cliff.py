"""Probe: what a recurrent [4H, H] x [H, BT] product costs on the card in
float32 on the FMA pipes against bf16 on the tensor cores.

Counterpart of ``tools/probe_f32_cliff.py``. ``matmul_loop(w, x, mode)``
runs, per tile of BT=256 columns of ``x`` [4H, ncols], T steps of
``g = W h`` then ``h = tanh(g[0:H]) * 0.25 + h * 0.75`` from ``h = x[0:H]``
and returns h [H, ncols]:

- ``vpu``: no product, ``h = h * 1.000001 + x[0:H]`` (elementwise baseline);
- ``f32``: float32 operands and sums (FMA pipes: Hopper has no full-float32
  tensor-core path);
- ``bf16``: bf16 operands, float32 sums (tensor cores, ``mma.sync``);
- ``bf16x3``: the hi/lo bf16 split of both operands, three tensor-core
  products (about float32 accuracy).

The tensor-core modes sum each pair of k-steps from zero and add that
partial to the float32 sum to nearest (``tc="split"``); ``tc="chain"``, a
probe option, chains every mma into the one sum, the body before the split,
whose truncated sums drift (PERF.md §6). Both have the one plain version.

On a CUDA tensor it launches ``ops/csrc/probe_matmul_loop.cu`` and adds one
to ``matmul_loop.launches``; on a CPU tensor it runs
:func:`matmul_loop_reference`. The kernel's grid is not the TPU probe's one
block a tile: a block owns ``SHIP_CB`` columns, so 21 tiles fill
the card (``matmul_loop_blocks``, ``matmul_loop_grid_bound_ms``). ``main``
also times the port's float32 ``fused_vae_gate`` (the TPU probe's part A;
the port has no bf16 gate yet).

    python -m shm_tpu_torch.tools.probe_f32_cliff            # on the card
    python -m shm_tpu_torch.tools.probe_f32_cliff --device cpu --tiles 1 --T 3
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json

import numpy as np
import torch

from shm_tpu_torch.ops._build import count_launch, load_library, raise_on_error
from shm_tpu_torch.ops._gate import bf16_round
from shm_tpu_torch.tools.workload import (
    N_SMS, PEAK_BF16_FLOPS, PEAK_F32_FLOPS, bound_ms, timed,
)

H, BT = 128, 256
MODES = ("vpu", "f32", "bf16", "bf16x3")
# how the tensor-core modes sum, by the C entry's tc_sum (TcSum)
TC_SUMS = ("chain", "split")
N_TILES = 21          # the TPU probe's 21 tiles (~5,440 windows / 256)
T_STEPS = 100
# columns a block owns on the card in the product modes
# (ops/csrc/probe_matmul_loop.cu's SHIP_CB), chosen among 32, 48 and 64 by
# measurement at 21 tiles (PERF.md §6)
SHIP_CB = 48


def matmul_loop_reference(w: torch.Tensor, x: torch.Tensor, mode: str, *,
                          T: int = T_STEPS,
                          sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the kernel: h [H, ncols] after T steps.
    Each product sums in ``sum_dtype`` and is rounded to float32; float64
    gives a witness whose sums are all but exact."""
    x0 = x[:H]
    h = x0.clone()
    if mode == "vpu":
        for _ in range(T):
            h = h * 1.000001 + x0
        return h
    w_hi = bf16_round(w)
    w_lo = bf16_round(w - w_hi)

    def mm(a, b):
        return (a.to(sum_dtype) @ b.to(sum_dtype)).float()

    for _ in range(T):
        if mode == "f32":
            g = mm(w, h)
        elif mode == "bf16":
            g = mm(w_hi, bf16_round(h))
        else:
            hb = bf16_round(h)
            h_lo = bf16_round(h - hb)
            g = mm(w_hi, hb) + mm(w_hi, h_lo) + mm(w_lo, hb)
        h = torch.tanh(g[:H]) * 0.25 + h * 0.75
    return h


def _check(w, x, mode, T, tc):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if tc not in TC_SUMS:
        raise ValueError(f"tc must be one of {TC_SUMS}, got {tc!r}")
    if tc != "split" and mode not in ("bf16", "bf16x3"):
        raise ValueError(f"tc={tc!r} takes a tensor-core mode (bf16, bf16x3)")
    for name, t in (("w", w), ("x", x)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 matrix")
    if w.shape != (4 * H, H):
        raise ValueError(f"w must be [{4 * H}, {H}], got {tuple(w.shape)}")
    ncols = x.shape[1]
    if x.shape[0] != 4 * H or ncols == 0 or ncols % BT:
        raise ValueError(f"x must be [{4 * H}, k * {BT}] with k >= 1, got "
                         f"{tuple(x.shape)}")
    if w.device != x.device:
        raise ValueError("w and x must be on one device")
    if T < 0:
        raise ValueError(f"T must be >= 0, got {T}")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load_library("probe_matmul_loop")
    lib.shm_probe_matmul_loop.restype = ctypes.c_int
    lib.shm_probe_matmul_loop.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.shm_probe_matmul_loop_scratch_bytes.restype = ctypes.c_longlong
    lib.shm_probe_matmul_loop_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.shm_probe_matmul_loop_blocks.restype = ctypes.c_int
    lib.shm_probe_matmul_loop_blocks.argtypes = [ctypes.c_int] * 2
    return lib


def _launch(w, x, mode, T, tc):
    lib = _library()
    ncols = x.shape[1]
    m = MODES.index(mode)
    nbytes = lib.shm_probe_matmul_loop_scratch_bytes(ncols, m)
    out = torch.empty(H, ncols, device=x.device, dtype=torch.float32)
    scratch = torch.empty(nbytes, device=x.device, dtype=torch.uint8)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.shm_probe_matmul_loop(
            w.data_ptr(), x.data_ptr(), out.data_ptr(),
            scratch.data_ptr() if nbytes else None, ncols, T, m,
            TC_SUMS.index(tc), stream)
    raise_on_error(lib, err, "probe_matmul_loop")
    count_launch(matmul_loop)
    return out


def matmul_loop(w: torch.Tensor, x: torch.Tensor, mode: str, *,
                T: int = T_STEPS, tc: str = "split") -> torch.Tensor:
    """h [H, ncols] after T steps of ``mode``, the tensor-core modes summed
    as ``tc`` says (see the module docstring)."""
    _check(w, x, mode, T, tc)
    if x.device.type == "cuda":
        return _launch(w, x, mode, T, tc)
    if x.device.type == "cpu":
        return matmul_loop_reference(w, x, mode, T=T)
    raise ValueError(f"matmul_loop: unsupported device {x.device}")


# kernel launches so far; callers reset it to 0 to count one run's launches
matmul_loop.launches = 0


def matmul_loop_flops(ncols: int, mode: str, T: int = T_STEPS) -> float:
    """Product FLOPs of one call: 2*4H*H per column and step, three times
    that for bf16x3, none for vpu."""
    passes = {"vpu": 0, "f32": 1, "bf16": 1, "bf16x3": 3}[mode]
    return float(passes * 2 * 4 * H * H * ncols * T)


def matmul_loop_bound_ms(ncols: int, mode: str, T: int = T_STEPS):
    """(whole-card bound, per-SM bound) in ms: the FLOPs over the peak of the
    mode's operand type (float32 FMA for f32, bf16 tensor cores otherwise)
    or the bytes of x[0:H] and h, whichever is larger, and the same with one
    SM a tile."""
    card, by = _card_bound(ncols, mode, T)
    return card, card if by == "bytes" else card * N_SMS / (ncols // BT)


def _card_bound(ncols, mode, T):
    peak = PEAK_F32_FLOPS if mode == "f32" else PEAK_BF16_FLOPS
    return bound_ms(matmul_loop_flops(ncols, mode, T), 2 * 4 * H * ncols, peak)


def block_columns(mode: str) -> int:
    """Columns one block of the kernel owns in ``mode``: the TPU probe's tile
    for vpu, else ``SHIP_CB``."""
    return BT if mode == "vpu" else SHIP_CB


def matmul_loop_blocks(ncols: int, mode: str) -> int:
    """Blocks the kernel launches for ``ncols`` columns in ``mode`` (the C
    entry's ``shm_probe_matmul_loop_blocks``); a ragged last block computes
    on zero columns."""
    return -(-ncols // block_columns(mode))


def matmul_loop_grid_bound_ms(ncols: int, mode: str, T: int = T_STEPS) -> float:
    """The bound at the grid the kernel launches: the busiest SM's columns
    (a block's columns times its blocks, the blocks spread evenly over the
    SMs) at one SM's share of the peak; the card's figure where bytes bind."""
    card, by = _card_bound(ncols, mode, T)
    if by == "bytes":
        return card
    blocks = matmul_loop_blocks(ncols, mode)
    cols = block_columns(mode) * -(-blocks // N_SMS)
    return card * N_SMS * cols / ncols


def make_inputs(tiles: int = N_TILES, seed: int = 0, device="cpu"):
    """The TPU probe's inputs: W ~ 0.1 N(0, 1) [4H, H], x ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(4 * H, H)).astype(np.float32) * np.float32(0.1))
    x = rng.normal(size=(4 * H, tiles * BT)).astype(np.float32)
    return torch.from_numpy(w).to(device), torch.from_numpy(x).to(device)


def probe_table(tiles: int = N_TILES, T: int = T_STEPS, reps: int = 20,
                device="cuda"):
    """The probe's rows: ``matmul_loop`` in every mode on the TPU probe's
    inputs, then the port's float32 ``fused_vae_gate`` (gate-only, random
    init, N=5,440 random windows; 8 on the CPU). ``ms`` is None off the card."""
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.ops import fused_vae_gate, vae_params_to_kernel_weights

    device = torch.device(device)
    on_card = device.type == "cuda"
    w, x = make_inputs(tiles, device=device)
    ncols = x.shape[1]
    rows = []
    for mode in MODES:
        out = matmul_loop(w, x, mode, T=T)
        card, per_sm = matmul_loop_bound_ms(ncols, mode, T)
        ms = (timed(lambda: matmul_loop(w, x, mode, T=T), reps=reps)
              if on_card else None)
        rows.append({"probe": f"matmul_loop/{mode}", "ms": ms,
                     "bound_ms": card, "bound_ms_per_sm": per_sm,
                     "blocks": matmul_loop_blocks(ncols, mode),
                     "bound_ms_grid": matmul_loop_grid_bound_ms(ncols, mode, T),
                     "tiles": tiles, "T": T,
                     "checksum": float(out.double().sum())})

    cfg = Stage4DofConfig()
    vae = vae_from_config(cfg.vae)
    vae.init_parameters(torch.Generator().manual_seed(0))
    wts = vae_params_to_kernel_weights(vae.to(device))
    n = 5440 if on_card else 8
    rng = np.random.default_rng(0)
    Z = torch.from_numpy(rng.normal(size=(n, cfg.seq_len, cfg.vae.input_dim))
                         .astype(np.float32)).to(device)
    gate = lambda: fused_vae_gate(wts, Z, num_layers=2, use_layernorm=True,
                                  with_residual=False)
    mse = gate()[0]
    rows.append({"probe": "fused_gate/f32", "windows": n,
                 "ms": timed(gate, reps=reps) if on_card else None,
                 "mse_mean": float(mse.mean())})
    rows.append({"probe": "fused_gate/bf16", "ms": None,
                 "note": "waits for the bf16 gate path (ROADMAP.md Queue 2 "
                         "item 1)"})
    return rows


def main(argv=None) -> None:
    from shm_tpu_torch.device import resolve_device, set_full_f32_precision

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; cpu runs the plain versions")
    ap.add_argument("--tiles", type=int, default=N_TILES)
    ap.add_argument("--T", type=int, default=T_STEPS)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_full_f32_precision()
    for row in probe_table(args.tiles, args.T, args.reps, device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
