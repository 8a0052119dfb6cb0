#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the final line):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (nvcc, ``sm_90a``, from ``shm_tpu_torch/ops/csrc``, six sources at once);
2. each of the three fused gate kernels (LSTM, minGRU, attention) against
   its plain PyTorch version on the card, random weights from a numpy seed,
   at four shapes (minGRU also at three layers);
3. the main path, once per model family:
   ``HybridScorer.from_artifacts("data/4dof" | "data/4dof_mingru" |
   "data/4dof_attention")`` on cuda scoring the 3,636 committed 4DOF test
   windows, held against the root's ``figures/pipeline_metrics.json`` and
   against the port's plain path on the same card; the launch count of the
   family's kernel must be > 0 (and of the LSTM kernel 0 in the other two);
   then ``reconstruction_mse`` through the family's gate-only kernel mode;
4. timings at bench.py's 5,440-window workload, per family: kernel, plain
   version, the operation/byte bound, a library yardstick (cuDNN ``nn.LSTM``;
   ``torch.matmul`` with a log-depth scan; ``scaled_dot_product_attention``),
   and ``score()`` windows/s end to end; for the LSTM kernel also its
   registers, spills and shared bytes a block at each width, its instances'
   HMMA and FFMA counts (``cuobjdump -sass``), the 3xTF32 tensor-core bound
   of its gate products, and on the real windows the largest relative mse
   difference from the plain version, held to ``LSTM_MSE_RTOL`` (beside the
   tensor-core body's other sums and the float32 FMA body, each timed; the
   one-term instance must fail it); for the minGRU kernel the same, held to
   ``MINGRU_MSE_RTOL``, beside every tile of its variant entry (TC steps x
   MT m-tiles, and the chained and one-term sums), each timed at 5,440 and
   at the 8,192 bucket; for the attention kernel also its
   registers, spills, threads and shared bytes a block, its packed TF32
   weights and its split of activations against ``cvt.rna.tf32.f32`` on the
   card (bit for bit), and the 3xTF32 tensor-core bound of its four weight
   products beside the f32 bound;
5. where one ``score()`` call's time goes (``torch.profiler``), per family:
   device time by kernel and the device's idle share;
6. the four LSTM training kernels (encoder and decoder, forward and backward)
   against autograd of their plain versions: both forwards and every
   gradient, at the 4DOF training shape, a ragged batch, the 1DOF shape, a
   unit mask, a batch of 1,024 (the reverse scan's clusters in waves), one
   window and H=64; every output of both forwards (h_last / recon, the
   final state, and the stash and gate stash they keep for the backward)
   against ``lstm2_scan_stash_reference``, in the training mode and in the
   trainer's validation mode (no gradient, no stash, null mask) at the same
   shapes; and how the card places each forward- and reverse-scan instance
   (clusters at once, shared memory, registers, spills);
7. the training path at full width: ``train-vae`` on the committed normal
   runs into a temporary root, the recipe unchanged but for 8 epochs of 50,
   on the card through the kernels; launch counts, finite and falling losses, the same losses bit for bit
   from a second run, the kernel path's first-batch loss and gradient against
   the plain autograd path, the written checkpoint read back, and
   ``reconstruction_mse`` through the fused gate kernel;
8. timings of the four kernels and of one training step (kernel path, plain
   autograd path, a cuDNN ``nn.LSTM`` yardstick), their bounds, and where a
   step's time goes; with ``--parent DIR`` (another checkout of the
   repository, e.g. the parent commit unpacked), also rows 1-7 of that
   tree on this card (rows 1, 6 and 7 at 5,440 windows and at the 8,192
   bucket), in turns with this tree's, its gradients against this tree's on
   the same inputs and its rows 1, 6 and 7 mse against this tree's;
9. the probes (``shm_tpu_torch/tools``): each of the three probe kernels
   against its plain version (``matmul_loop`` in every mode at one tile and
   at 21, bf16x3 also against the float32 loop; ``gate_variant``'s variants
   at N=1000 ragged, its float32 FMA instance A against its plain version
   and its shipping tensor-core instance T against ``fused_vae_gate`` bit
   for bit;
   the minGRU clone at ``loop_T`` T and 1), with planted faults
   (float32 for bf16, another LayerNorm eps, bf16 activations added) that
   each tolerance must fail; then the probe path: the three probes' tables
   at the TPU probes' sizes (launch counts reset before, read after), and
   each kernel's time against its bound, its plain version and a library
   yardstick.

Prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Exits non-zero without a card, and when
run from a directory that does not hold the repository. Usage:
``python3 chip_smoke.py [--parent DIR]``; ``--child DIR OUT`` is the child
mode ``--parent`` runs (``child``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# the card's peaks and the bound they give: shm_tpu_torch/tools/workload.py
# (PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES, bound_ms)

# kernel vs plain, both float32 on the card: the two sum in different orders
# and round differently inside expf/tanhf, and the 2*L*T-step recurrence
# carries those last-bit differences forward; |kernel - plain| must stay
# within ATOL + RTOL * |plain| elementwise
ATOL, RTOL = 1e-4, 1e-4
N_BENCH = 5440                  # bench.py's workload
REPS = 7
# gradients of the LSTM training kernels against autograd of the plain
# versions: each weight-gradient entry sums T*B (25,600 at 4DOF) products in
# another order, and the recurrence carries last-bit differences of
# expf/tanhf through 2*T steps in both directions; |kernel - plain| must stay
# within GRAD_ATOL_REL * max|plain| + RTOL * |plain| elementwise
GRAD_ATOL_REL = 2e-4
# row 1 (the LSTM gate) against its plain version on the 5,440 real windows,
# on the largest relative mse difference: ATOL and RTOL let pass a gate whose
# products keep one TF32 term, so row 1 is also held to LSTM_MSE_RTOL. Over
# the 3,636 test windows the CPU model of the kernel's sums
# (tests/test_torch_vae_gate_tf32.py) reads 7.8e-7 for the shipped sum,
# 9.9e-6 for a sum chained through every mma, 9.7e-5 for one TF32 term; the
# one-term instance must fail the bound on the card (PERF.md §6)
LSTM_MSE_RTOL = 5e-6
# row 6 (the minGRU gate) on the same 5,440 real windows, held the same way.
# Over the 3,636 test windows through data/4dof_mingru the CPU model of the
# kernel's sums (tests/test_torch_mingru_gate_tf32.py) reads 3.5e-7 for the
# shipped sum, 4.7e-7 for a sum chained through every mma (no recurrent
# product carries the truncation here), 2.5e-5 for one TF32 term; on its 256
# windows 2.4e-7 / 6.7e-7 (plain / JAX kernel) and 1.9e-5. The one-term
# instance must fail the bound on the card (PERF.md §6)
MINGRU_MSE_RTOL = 4e-6
TRAIN_EPOCHS = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS, warm: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    from shm_tpu_torch.tools.workload import timed

    return timed(fn, reps, warm)


def vae_work(N: int, T: int, D: int, H: int, Z: int, L: int,
             with_residual: bool = True):
    """(FLOPs, bytes) one fused VAE gate call must do: matmul FLOPs only
    (elementwise excluded, as in bench.py's count); bytes = x read once,
    resid and mse written once, every weight read once."""
    enc = T * sum(2 * 4 * H * ((D if l == 0 else H) + H) for l in range(L))
    heads = 2 * H * Z + 2 * Z * H
    dec = 2 * 4 * H * H + T * (2 * 4 * H * H
                               + (L - 1) * 2 * 4 * H * 2 * H + 2 * H * D)
    flops = N * (enc + heads + dec)
    n_w = (sum(((D if l == 0 else H) + H + 1) * 4 * H for l in range(L))
           + L * (2 * H + 1) * 4 * H               # decoder layers
           + 2 * H + (H + 1) * Z + (Z + 1) * H + (H + 1) * D)
    nbytes = 4 * (N * T * D * (2 if with_residual else 1) + N + n_w)
    return float(flops), float(nbytes)


def mingru_work(N: int, T: int, D: int, H: int, Z: int, L: int,
                with_residual: bool = True):
    """(FLOPs, bytes) one fused minGRU gate call must do, counted as
    ``vae_work`` counts: a layer is one [in, 2H] product per step, the
    decoder's layer 0 one product in all."""
    enc = T * sum(2 * 2 * H * (D if l == 0 else H) for l in range(L))
    heads = 2 * H * Z + 2 * Z * H
    dec = 2 * 2 * H * H + T * ((L - 1) * 2 * 2 * H * H + 2 * H * D)
    flops = N * (enc + heads + dec)
    n_w = (sum(((D if l == 0 else H) + 1) * 2 * H for l in range(L))
           + L * (H + 1) * 2 * H
           + 2 * H + (H + 1) * Z + (Z + 1) * H + (H + 1) * D)
    nbytes = 4 * (N * T * D * (2 if with_residual else 1) + N + n_w)
    return float(flops), float(nbytes)


def attention_work(N: int, T: int, D: int, H: int, Z: int, L: int,
                   with_residual: bool = True):
    """(FLOPs, bytes) one fused attention gate call must do. A block: QKV
    2*T*H*3H, scores and PV 2*2*T*T*H, output projection 2*T*H*H, MLP
    2*2*T*H*4H; the decoder's in_proj once a window. Bytes: x, resid, mse,
    every weight and the [T, H] position table once."""
    block = 2 * T * H * 3 * H + 2 * 2 * T * T * H + 2 * T * H * H + 2 * 2 * T * H * 4 * H
    flops = N * (2 * T * D * H + 2 * L * block + 2 * H * Z + 2 * Z * H
                 + 2 * H * H + 2 * T * H * D)
    block_w = 4 * H + (3 * H + 1) * H + 3 * H + (H + 1) * H + (4 * H + 1) * H + 4 * H + 4 * H * H
    stack_w = lambda i: (i + 1) * H + L * block_w + 2 * H
    n_w = (stack_w(D) + stack_w(H) + 2 * H + (H + 1) * Z + (Z + 1) * H
           + (H + 1) * D + T * H)
    nbytes = 4 * (N * T * D * (2 if with_residual else 1) + N + n_w)
    return float(flops), float(nbytes)


def attention_dense_flops(N: int, T: int, H: int, L: int) -> float:
    """The part of ``attention_work`` in the kernel's four weight products
    (QKV, output projection, the MLP's two), which run in 3xTF32 on the
    tensor cores."""
    return float(N * 2 * L * (2 * T * H * 3 * H + 2 * T * H * H
                              + 2 * 2 * T * H * 4 * H))


def lstm_gate_flops(N: int, T: int, D: int, H: int, L: int) -> float:
    """The part of ``vae_work`` in the LSTM gate products of both stacks
    (each step's x_t W0i, h W_hh and h0 W1i, and the decoder's
    once-per-window input projection), which the kernel runs in 3xTF32 on
    the tensor cores."""
    G = 4 * H
    enc = T * sum(2 * G * ((D if l == 0 else H) + H) for l in range(L))
    dec = 2 * G * H + T * (2 * G * H + (L - 1) * 2 * G * 2 * H)
    return float(N * (enc + dec))


def mingru_gate_flops(N: int, T: int, D: int, H: int, L: int) -> float:
    """The part of ``mingru_work`` in the gate products of both stacks
    (each step's [in, 2H] product of every layer but the decoder's layer 0,
    which runs once a window), which the kernel runs in 3xTF32 on the
    tensor cores."""
    G = 2 * H
    enc = T * sum(2 * G * (D if l == 0 else H) for l in range(L))
    dec = 2 * G * H + T * (L - 1) * 2 * G * H
    return float(N * (enc + dec))


def sass_counts(name: str, marker: str) -> dict:
    """{kernel function of the built library ``name`` whose symbol holds
    ``marker``: (HMMA, FFMA) instruction counts} from ``cuobjdump -sass``."""
    import shutil

    from shm_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    listing = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
    counts, fn = {}, None
    for line in listing.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            if marker in fn:
                counts[fn] = [0, 0]
        elif fn in counts:
            op = line.split("*/")[1].split() if "*/" in line else []
            op = [t for t in op if not t.startswith("@")][:1]
            if op and op[0].startswith("HMMA"):
                counts[fn][0] += 1
            elif op and op[0].startswith("FFMA"):
                counts[fn][1] += 1
    return {k: tuple(v) for k, v in counts.items()}


def phase_lstm_kernel(w, Z, mse_k, mse_p, T: int, D: int, H: int, L: int) -> dict:
    """How the card takes the LSTM gate kernel (registers, spills, threads,
    shared bytes and windows a block, blocks an SM) at every width it takes;
    what its instances run (HMMA and FFMA counts in SASS); the 3xTF32
    tensor-core bound of its gate products; and on the real windows ``Z``,
    the tensor-core body's three sums and the float32 FMA body each against
    the plain version ``mse_p`` (time and largest relative mse difference):
    the kernel's ``mse_k`` must stay within LSTM_MSE_RTOL, which the one-term
    instance must fail."""
    import torch

    from shm_tpu_torch.ops.fused_vae import kernel_info
    from shm_tpu_torch.tools.probe_vpu_bound import (
        A_F32, SHIP_TC, TC_SUMS, gate_variant,
    )
    from shm_tpu_torch.tools.workload import PEAK_F32_FLOPS, PEAK_TF32_FLOPS

    tag = "[lstm]"
    N = Z.shape[0]
    for h_ in (32, 64, 128):
        info = kernel_info(T, h_, L)
        print(f"{tag} kernel at T={T} H={h_} L={L}: {info['registers']} registers "
              f"and {info['spill_bytes']} B of local memory (spills) a thread, "
              f"{info['threads']} threads, {info['windows_per_block']} windows and "
              f"{info['shared_bytes']} B of shared memory a block, "
              f"{info['blocks_per_sm']} block(s) an SM")
        check(info["blocks_per_sm"] >= 1, f"the LSTM gate kernel does not fit "
                                          f"an SM at H={h_}")
    counts = sass_counts("fused_vae", "fused_vae_")
    for fn, (hmma, ffma) in sorted(counts.items()):
        print(f"{tag} SASS {fn}: {hmma} HMMA, {ffma} FFMA")
    # the shipping instances: fused_vae_tc_kernel<H, 2, TC_SPLIT = 1>
    ship = [fn for fn in counts if any(
        f"fused_vae_tc_kernelILi{h_}ELi2ELi1EE" in fn for h_ in (32, 64, 128))]
    check(len(ship) == 3 and all(counts[fn][0] > 0 for fn in ship),
          f"the shipping instances run no HMMA: {ship}")
    dense = lstm_gate_flops(N, T, D, H, L)
    tc_ms = 3 * dense / PEAK_TF32_FLOPS * 1e3
    print(f"{tag} gate products at N={N}: {dense / 1e9:.2f} GFLOP -> 3xTF32 "
          f"tensor-core bound {tc_ms:.4f} ms (3 x {PEAK_TF32_FLOPS / 1e12:g} "
          f"TFLOP/s TF32), f32 FMA-pipe bound {dense / PEAK_F32_FLOPS * 1e3:.4f} ms")

    rel = lambda m: float(((m - mse_p).abs() / mse_p.abs()).max())
    got = {}
    for name, kw in [("A (float32 FMA)", A_F32)] + [
            (f"tc={s!r}", dict(A_F32, tc=s)) for s in TC_SUMS]:
        got[name] = gate_variant(w, Z, **kw)
        ms = time_ms(lambda: gate_variant(w, Z, **kw))
        print(f"{tag} probe instance {name} at N={N}: {ms:.4f} ms, largest "
              f"relative mse diff against the plain version {rel(got[name]):.3e}")
    check(torch.equal(got[f"tc={SHIP_TC!r}"], mse_k),
          "the probe's shipping tensor-core instance is not fused_vae_gate")
    r_k, r_1 = rel(mse_k), rel(got["tc='one_term'"])
    print(f"{tag} kernel vs plain, largest relative mse diff {r_k:.3e} (<= "
          f"{LSTM_MSE_RTOL:g}); planted fault, the one-term instance: {r_1:.3e} "
          f"-> {'caught' if r_1 > LSTM_MSE_RTOL else 'MISSED'}")
    check(r_k <= LSTM_MSE_RTOL, f"row 1 is {r_k:.3e} from its plain version "
                                f"(relative mse), past {LSTM_MSE_RTOL:g}")
    check(r_1 > LSTM_MSE_RTOL, f"LSTM_MSE_RTOL {LSTM_MSE_RTOL:g} does not tell the "
                               f"one-term instance ({r_1:.3e})")
    return {"bound_3xtf32_ms": tc_ms}


def phase_mingru_kernel(w, Z, mse_k, mse_p, T: int, D: int, H: int, L: int,
                        ln: bool) -> dict:
    """How the card takes the minGRU gate kernel (registers, spills, threads,
    shared bytes, windows and steps a tile, blocks an SM) at every width;
    what its instances run (HMMA and FFMA counts in SASS); the 3xTF32 bound
    of its gate products; and on the real windows ``Z`` (N=5,440) and tiled
    to the 8,192 bucket, each instance of the variant entry (the shipping sum
    at every tile of TC steps and MT m-tiles, the chained and the one-term
    sum at the shipping tile) timed beside the kernel with its largest
    relative mse difference from the plain version ``mse_p``: the kernel's
    ``mse_k`` must stay within MINGRU_MSE_RTOL, which the one-term instance
    must fail."""
    import torch

    from shm_tpu_torch.ops.fused_mingru import gate_variant, kernel_info
    from shm_tpu_torch.tools.workload import PEAK_F32_FLOPS, PEAK_TF32_FLOPS

    tag = "[min_gru]"
    N = Z.shape[0]
    for h_ in (32, 64, 128):
        info = kernel_info(T, h_, L)
        print(f"{tag} kernel at T={T} H={h_} L={L}: {info['registers']} registers "
              f"and {info['spill_bytes']} B of local memory (spills) a thread, "
              f"{info['threads']} threads, {info['windows_per_block']} windows x "
              f"{info['steps_per_tile']} steps a tile, {info['shared_bytes']} B of "
              f"shared memory a block, {info['blocks_per_sm']} block(s) an SM")
        check(info["blocks_per_sm"] >= 1, f"the minGRU gate kernel does not fit "
                                          f"an SM at H={h_}")
    tc, mt = info["steps_per_tile"], info["windows_per_block"] // 16
    counts = sass_counts("fused_mingru", "fused_mingru_tc_kernel")
    for fn, (hmma, ffma) in sorted(counts.items()):
        print(f"{tag} SASS {fn}: {hmma} HMMA, {ffma} FFMA")
    # the shipping instances: fused_mingru_tc_kernel<H, MT, TC, TC_SPLIT = 1>
    ship = [fn for fn in counts if any(
        f"fused_mingru_tc_kernelILi{h_}ELi{mt}ELi{tc}ELi1EE" in fn
        for h_ in (32, 64, 128))]
    check(len(ship) == 3 and all(counts[fn][0] > 0 for fn in ship),
          f"the shipping instances run no HMMA: {ship}")
    dense = mingru_gate_flops(N, T, D, H, L)
    tc_ms = 3 * dense / PEAK_TF32_FLOPS * 1e3
    dense8 = mingru_gate_flops(8192, T, D, H, L)
    print(f"{tag} gate products at N={N}: {dense / 1e9:.2f} GFLOP -> 3xTF32 "
          f"tensor-core bound {tc_ms:.4f} ms (3 x {PEAK_TF32_FLOPS / 1e12:g} "
          f"TFLOP/s TF32), f32 FMA-pipe bound {dense / PEAK_F32_FLOPS * 1e3:.4f} ms; "
          f"at N=8192: {dense8 / 1e9:.2f} GFLOP -> "
          f"{3 * dense8 / PEAK_TF32_FLOPS * 1e3:.4f} ms")

    Z8 = torch.cat([Z, Z[:8192 - N]]).contiguous()
    kw = dict(num_layers=L, use_layernorm=ln)
    rel = lambda m: float(((m - mse_p).abs() / mse_p.abs()).max())
    variants = [("split", t_, m_) for t_ in (1, 2, 4) for m_ in (1, 2)] + [
        ("chain", tc, mt), ("one_term", tc, mt)]
    got = {}
    for s_, t_, m_ in variants:
        v = dict(tc_sum=s_, tc=t_, mt=m_, **kw)
        got[s_, t_, m_] = gate_variant(w, Z, **v)
        ms = time_ms(lambda: gate_variant(w, Z, **v))
        ms8 = time_ms(lambda: gate_variant(w, Z8, **v))
        print(f"{tag} variant sum={s_!r} TC={t_} MT={m_}: {ms:.4f} ms at N={N}, "
              f"{ms8:.4f} ms at N=8192; largest relative mse diff against the "
              f"plain version {rel(got[s_, t_, m_]):.3e}")
    check(torch.equal(got["split", tc, mt], mse_k),
          "the variant entry's shipping instance is not fused_mingru_gate")
    r_k, r_1 = rel(mse_k), rel(got["one_term", tc, mt])
    print(f"{tag} kernel vs plain, largest relative mse diff {r_k:.3e} (<= "
          f"{MINGRU_MSE_RTOL:g}); planted fault, the one-term instance: {r_1:.3e} "
          f"-> {'caught' if r_1 > MINGRU_MSE_RTOL else 'MISSED'}")
    check(r_k <= MINGRU_MSE_RTOL, f"row 6 is {r_k:.3e} from its plain version "
                                  f"(relative mse), past {MINGRU_MSE_RTOL:g}")
    check(r_1 > MINGRU_MSE_RTOL, f"MINGRU_MSE_RTOL {MINGRU_MSE_RTOL:g} does not "
                                 f"tell the one-term instance ({r_1:.3e})")
    return {"bound_3xtf32_ms": tc_ms}


def phase_attention_kernel(w, N: int, T: int, H: int, L: int) -> dict:
    """How the card takes the attention kernel (registers, spills, threads,
    shared bytes a block, at the trained root's shape and at the longest
    window of each width), the wrapper's packed TF32 weights against the
    kernel's own ``cvt.rna.tf32.f32`` on the trained weights ``w`` (bit for
    bit), and the 3xTF32 tensor-core bound of the dense products."""
    import torch

    from shm_tpu_torch.ops.fused_attention import (
        kernel_info, tf32_round_on_card, unpack_fragments,
    )
    from shm_tpu_torch.tools.workload import PEAK_F32_FLOPS, PEAK_TF32_FLOPS

    tag = "[attention]"
    for t_, h_ in ((T, H), (136, 128), (208, 64), (268, 32)):
        info = kernel_info(t_, h_)
        print(f"{tag} kernel at T={t_} H={h_}: {info['registers']} registers and "
              f"{info['spill_bytes']} B of local memory (spills) a thread, "
              f"{info['threads']} threads and {info['shared_bytes']} B of shared "
              f"memory a block, {info['blocks_per_sm']} block(s) an SM")
        check(info["blocks_per_sm"] >= 1, f"the attention kernel does not fit "
                                          f"an SM at T={t_} H={h_}")
    frags = [k for k in w if k.endswith("_frag")]
    for k in frags:
        src = w[k[:-len("_frag")]]
        big, small = unpack_fragments(w[k])
        same = (torch.equal(big, tf32_round_on_card(src))
                and torch.equal(small, tf32_round_on_card((src - big).contiguous())))
        check(same, f"{k}: packed TF32 parts differ from cvt.rna.tf32.f32 on the card")
    print(f"{tag} packed TF32 big and small parts of {len(frags)} weights equal "
          f"cvt.rna.tf32.f32 on the card, bit for bit")
    # the kernel's own split of its activations (integer rounding) against
    # cvt.rna.tf32.f32, on every weight and on 2^20 wide-ranging values
    xs = [w[k[:-len("_frag")]] for k in frags]
    for x in xs + [torch.randn(1 << 20, device="cuda") * 30.0]:
        check(torch.equal(tf32_round_on_card(x, exact=False), tf32_round_on_card(x)),
              "the kernel's TF32 split differs from cvt.rna.tf32.f32")
    print(f"{tag} the kernel's split of A rounds as cvt.rna.tf32.f32, bit for "
          f"bit, on {len(xs)} weights and 2^20 random values")
    dense = attention_dense_flops(N, T, H, L)
    tc_ms = 3 * dense / PEAK_TF32_FLOPS * 1e3
    print(f"{tag} dense products at N={N}: {dense / 1e9:.2f} GFLOP -> 3xTF32 "
          f"tensor-core bound {tc_ms:.4f} ms (3 x {PEAK_TF32_FLOPS / 1e12:g} "
          f"TFLOP/s TF32), f32 FMA-pipe bound {dense / PEAK_F32_FLOPS * 1e3:.4f} ms")
    return {"bound_3xtf32_ms": tc_ms}


# the three model families the port scores: the committed artifacts, the
# fused gate kernel, the TPU kernel it replaces, and how many windows of the
# root's committed confusion matrix may move on the card. LSTM root: 2,
# because pipeline_metrics.json was made at another matmul precision and the
# JAX package's own float32 CPU path moves the same 2 (logit margins 0.026,
# 0.019). minGRU and attention roots: 0, because the JAX package's float32
# CPU path and the port's reproduce both files exactly on all 3,636 windows
# (tests/test_torch_pipeline_cells.py), and the narrowest logit margin of any
# faulty test window is 0.028 (minGRU) and 0.012 (attention), a thousand
# times a float32 reordering of the sums.
FAMILIES = {
    "lstm": dict(root="data/4dof", kernel="fused_vae_gate",
                 source="shm_tpu_torch/ops/csrc/fused_vae.cu",
                 replaces="shm_tpu/ops/fused_vae.py:125", work=vae_work,
                 library="cuDNN nn.LSTM", cm_limit=2),
    "min_gru": dict(root="data/4dof_mingru", kernel="fused_mingru_gate",
                    source="shm_tpu_torch/ops/csrc/fused_mingru.cu",
                    replaces="shm_tpu/ops/fused_mingru.py:69", work=mingru_work,
                    library="torch.matmul + log-depth scan", cm_limit=0),
    "attention": dict(root="data/4dof_attention", kernel="fused_attention_gate",
                      source="shm_tpu_torch/ops/csrc/fused_attention.cu",
                      replaces="shm_tpu/ops/fused_attention.py:157",
                      work=attention_work,
                      library="scaled_dot_product_attention + torch.matmul",
                      cm_limit=0),
}


def phase_build():
    from shm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    res = _build.build(["fused_vae", "lstm_train", "fused_mingru",
                        "fused_attention", "probe_mingru_gate",
                        "probe_matmul_loop"])
    wall = time.perf_counter() - t0
    for name, (path, secs, log) in res.items():
        print(f"[build] {name}: {path.relative_to(ROOT)} in {secs:.2f} s")
        for line in log.splitlines():
            if "Compiling entry function" in line:
                print(f"[build]   {line.split('Compiling entry function')[1].strip()[:100]}")
            elif "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]     {line.strip()}")
    print(f"[build] total {wall:.2f} s")


def random_vae(seed: int, D, Z, H, L, ln, cell: str = "lstm"):
    from shm_tpu_torch.config import VAEConfig
    from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax

    cfg = VAEConfig(input_dim=D, latent_dim=Z, hidden_dim=H, num_layers=L,
                    use_layernorm=ln, cell=cell)
    rng = np.random.default_rng(seed)
    return vae_from_flax(random_flax_vae_params(rng, cfg), cfg).cuda(), rng


def compare(name: str, got, ref) -> float:
    """Max |got - ref|; fails past ATOL + RTOL * |ref|."""
    got, ref = got.detach(), ref.detach()
    err = (got - ref).abs()
    worst = float((err - RTOL * ref.abs()).max())
    max_abs = float(err.max())
    ok = worst <= ATOL
    print(f"[kernel]   {name}: max |diff| {max_abs:.3e} "
          f"(tolerance {ATOL:g} + {RTOL:g}*|plain|) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version "
              f"(max |diff| {max_abs:.3e})")
    return max_abs


def phase_kernel_vs_plain(cell: str = "lstm"):
    """A family's gate kernel against its plain version, random weights.
    Returns the max |diff| over the cases."""
    import torch

    from shm_tpu_torch.ops import FUSED_GATES

    weights_fn, gate, reference = FUSED_GATES[cell]
    cases = [  # name, N, T, D, Z, H, L, LN, with_residual
        ("4dof N=1000 (ragged tile)", 1000, 100, 12, 16, 128, 2, True, True),
        ("openLAB 1-layer H=64 T=200 D=3", 300, 200, 3, 8, 64, 1, True, True),
        ("1dof 2-layer H=32 T=80 no LN", 300, 80, 12, 5, 32, 2, False, True),
        ("4dof with_residual=False", 333, 100, 12, 16, 128, 2, True, False),
    ]
    if cell == "min_gru":
        cases.append(("3-layer H=64 T=60", 200, 60, 12, 16, 64, 3, True, True))
    worst = 0.0
    for i, (name, N, T, D, Zd, H, L, ln, wr) in enumerate(cases):
        vae, rng = random_vae(100 + i, D, Zd, H, L, ln, cell)
        w = weights_fn(vae)
        Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).cuda()
        kw = dict(num_layers=L, use_layernorm=ln, with_residual=wr)
        mse, resid = gate(w, Z, **kw)
        torch.cuda.synchronize()
        mse_p, resid_p = reference(w, Z, **kw)
        print(f"[kernel] {gate.__name__} {name}: N={N} T={T} D={D} H={H} "
              f"Z={Zd} L={L} LN={ln} with_residual={wr}")
        check(mse.shape == (N,) and bool(torch.isfinite(mse).all()),
              f"{name}: mse not finite / wrong shape")
        worst = max(worst, compare("mse", mse, mse_p))
        if wr:
            check(resid.shape == (N, T, D), f"{name}: resid shape {resid.shape}")
            worst = max(worst, compare("resid", resid, resid_p))
        else:
            check(resid is None, f"{name}: resid returned with_residual=False")
    return worst


def phase_main_path(W, y, cell: str = "lstm"):
    """Score the 3,636 test windows through a family's committed artifacts on
    the card; returns the scorer and its kernel's launch count."""
    import torch

    from shm_tpu_torch.evals import accuracy, confusion_matrix
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.train import reconstruction_mse
    from shm_tpu_torch.utils.io import load_json

    fam = FAMILIES[cell]
    root = ROOT / fam["root"]
    gate = FUSED_GATES[cell][1]
    tag0 = f"[main {cell}]"
    ref = load_json(root / "figures" / "pipeline_metrics.json")
    scorer = HybridScorer.from_artifacts(root)
    check(scorer.device.type == "cuda" and scorer.use_fused_vae
          and scorer.vae.cell == cell,
          f"{cell}: scorer did not select the card, the cell and its kernel")

    for _, g, _ in FUSED_GATES.values():
        g.launches = 0
    t0 = time.perf_counter()
    out = scorer.score(W)
    wall = time.perf_counter() - t0
    launches = gate.launches
    others = {g.__name__: g.launches for _, g, _ in FUSED_GATES.values()
              if g is not gate}
    print(f"{tag0} score() of {len(W)} windows in {wall * 1e3:.1f} ms "
          f"(first call, includes the kernel's first load); {gate.__name__} "
          f"launches: {launches}; other gate kernels: {others}")
    check(launches > 0, f"the {cell} main path did not launch {gate.__name__}")
    check(not any(others.values()),
          f"the {cell} main path launched another family's kernel: {others}")
    check(all(np.isfinite(out[k]).all() for k in ("mse", "p_struct"))
          and out["mse"].shape == (len(W),), "non-finite or mis-shaped output")

    tags = {0: "normal/test", 1: "sensor/test", 2: "struct/test"}
    for g, tag in tags.items():
        m = y == g
        anom = int(out["anomalous"][m].sum())
        want = int(ref["gate"]["gate_stats"][tag]["anom"])
        print(f"{tag0} gate {tag}: {anom}/{int(m.sum())} anomalous "
              f"(rate {anom / m.sum():.4f}; reference {want})")
        check(anom == want, f"{cell}: gate decisions differ on {tag}")

    cm = confusion_matrix(y, out["y_pred"], 3)
    cm_ref = np.asarray(ref["confusion_matrix_counts"])
    acc = accuracy(y, out["y_pred"])
    moved = int(np.abs(cm - cm_ref).sum()) // 2
    print(f"{tag0} confusion matrix {cm.tolist()} (reference "
          f"{cm_ref.tolist()}); windows moved: {moved} (limit "
          f"{fam['cm_limit']})")
    print(f"{tag0} accuracy {acc:.6f} (reference {ref['accuracy']:.6f})")
    logits = scorer._dispatch(torch.from_numpy(W)).logits.cpu().numpy()
    margin = np.abs(logits[:, 1] - logits[:, 0])
    print(f"{tag0} narrowest logit margins of faulty windows: "
          f"{np.sort(margin[y > 0])[:3].round(5).tolist()}")
    if moved:
        # the windows in the cells that gained are the flips; show those
        # nearest the CNN's decision boundary with their logit margins
        for t, p in zip(*np.nonzero(cm > cm_ref)):
            idx = np.nonzero((y == t) & (out["y_pred"] == p))[0]
            idx = idx[np.argsort(margin[idx])][: cm[t, p] - cm_ref[t, p]]
            for i in idx:
                print(f"{tag0}   flip: window {i} true {t} -> pred {p}, "
                      f"logit margin {margin[i]:.5f}")
    check(moved <= fam["cm_limit"], f"{cell}: confusion matrix off by {moved} "
                                    f"windows (> {fam['cm_limit']})")

    plain = HybridScorer.from_artifacts(root, use_fused_vae=False)
    outp = plain.score(W)
    gate_diff = int((outp["anomalous"] != out["anomalous"]).sum())
    y_diff = int((outp["y_pred"] != out["y_pred"]).sum())
    mse_rel = float(np.max(np.abs(outp["mse"] - out["mse"])
                           / np.abs(outp["mse"])))
    print(f"{tag0} kernel path vs plain path on the card: gate decisions "
          f"differing {gate_diff}, y_pred differing {y_diff}, max mse rel "
          f"diff {mse_rel:.3e}")
    # the gate's margins are wide, so its decisions must agree exactly; a
    # CNN decision within float32 rounding of its boundary may flip, within
    # the family's limit
    check(gate_diff == 0 and y_diff <= fam["cm_limit"],
          f"{cell}: kernel path and plain path disagree on the card")

    if cell != "lstm":
        # reconstruction_mse through the family's gate-only kernel mode (the
        # LSTM family's runs on freshly trained weights in the training phase)
        from shm_tpu_torch.data.windows import normalize_windows

        Zn = normalize_windows(torch.from_numpy(W).cuda(), scorer.mean,
                               scorer.std).cpu().numpy()
        before = gate.launches
        mse_k = reconstruction_mse(scorer.vae, Zn)
        n_launch = gate.launches - before
        mse_p = reconstruction_mse(scorer.vae, Zn, fused=False)
        check(n_launch == 1 and gate.launches - before == 1,
              f"{cell}: reconstruction_mse launched {gate.__name__} "
              f"{n_launch} times, not once")
        print(f"{tag0} reconstruction_mse of {len(W)} windows through "
              f"{gate.__name__}(with_residual=False): mean {mse_k.mean():.6f}")
        compare(f"{cell} reconstruction_mse vs plain model",
                torch.from_numpy(mse_k), torch.from_numpy(mse_p))
    return scorer, launches


def cudnn_vae_pass(vae):
    """The same VAE pass composed from ``torch.nn.LSTM`` (cuDNN): a yardstick
    timed here only; the port never calls it."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    H, L = vae.hidden_dim, vae.num_layers

    def lstm_from(stack, in_dim):
        m = nn.LSTM(in_dim, H, L, batch_first=True).cuda()
        with torch.no_grad():
            for l, layer in enumerate(stack.layers):
                getattr(m, f"weight_ih_l{l}").copy_(layer.weight_ih)
                getattr(m, f"weight_hh_l{l}").copy_(layer.weight_hh)
                getattr(m, f"bias_ih_l{l}").copy_(layer.bias_ih)
                getattr(m, f"bias_hh_l{l}").copy_(layer.bias_hh)
        m.flatten_parameters()
        return m

    enc = lstm_from(vae.encoder_lstm, vae.input_dim)
    dec = lstm_from(vae.decoder_lstm, H)

    @torch.inference_mode()
    def run(Z):
        N, T, _ = Z.shape
        _, (hn, _) = enc(Z)
        h = hn[-1]
        if vae.layer_norm is not None:
            h = vae.layer_norm(h)
        dec_in = torch.tanh(vae.fc_latent_to_hidden(vae.fc_mu(h)))
        out, _ = dec(dec_in[:, None].expand(N, T, H))
        r = (Z - vae.output_layer(out)) ** 2
        return r.mean(dim=(1, 2)), r

    return run


def scan_mingru_pass(vae):
    """The same minGRU-VAE pass from ``torch.matmul`` projections and the
    log-depth (doubling) form of the linear recurrence, seven passes over
    [T, N, H] instead of T steps: a yardstick timed here only; the port's
    scoring never takes this form."""
    import torch
    import torch.nn.functional as F

    from shm_tpu_torch.models.minrnn import linear_recurrence

    H = vae.hidden_dim

    def stack(layers, inp, T):
        for layer in layers:
            g = F.linear(inp, layer.weight_ih, layer.bias_ih)
            z = torch.sigmoid(g[..., :H])
            a, b = 1.0 - z, z * g[..., H:]
            if g.dim() == 2:                      # constant decoder input
                a, b = a.expand(T, *a.shape), b.expand(T, *b.shape)
            else:
                a, b = a.transpose(0, 1), b.transpose(0, 1)
            inp = linear_recurrence(a, b, impl="associative").transpose(0, 1)
        return inp

    @torch.inference_mode()
    def run(Z):
        T = Z.shape[1]
        h = stack(vae.encoder_lstm.layers, Z, T)[:, -1]
        if vae.layer_norm is not None:
            h = vae.layer_norm(h)
        dec_in = torch.tanh(vae.fc_latent_to_hidden(vae.fc_mu(h)))
        out = stack(vae.decoder_lstm.layers, dec_in, T)
        r = (Z - vae.output_layer(out)) ** 2
        return r.mean(dim=(1, 2)), r

    return run


def sdpa_attention_pass(vae):
    """The same attention-VAE pass composed from
    ``F.scaled_dot_product_attention``, ``F.linear``, ``F.layer_norm`` and
    ``F.gelu``: a yardstick timed here only; the port never calls it."""
    import torch
    import torch.nn.functional as F

    from shm_tpu_torch.models.attention import sinusoidal_positions

    H = vae.hidden_dim

    def ln(x, m, eps=1e-6):
        return F.layer_norm(x, (H,), m.weight, m.bias, eps)

    def stack(st, tok):
        N, T, _ = tok.shape
        heads = st.num_heads
        s = tok + sinusoidal_positions(T, H, tok.device)
        split = lambda t: t.view(N, T, heads, H // heads).transpose(1, 2)
        for b in st.layers:
            h = ln(s, b.attn_norm)
            o = F.scaled_dot_product_attention(
                split(b.query(h)), split(b.key(h)), split(b.value(h)))
            s = s + b.out(o.transpose(1, 2).reshape(N, T, H))
            s = s + b.mlp_out(F.gelu(b.mlp_in(ln(s, b.mlp_norm)),
                                     approximate="tanh"))
        return ln(s, st.final_norm)

    @torch.inference_mode()
    def run(Z):
        N, T, _ = Z.shape
        h = stack(vae.encoder_lstm, vae.encoder_lstm.in_proj(Z)).mean(dim=1)
        if vae.layer_norm is not None:
            h = vae.layer_norm(h)
        h0 = torch.tanh(vae.fc_latent_to_hidden(vae.fc_mu(h)))
        tok0 = vae.decoder_lstm.in_proj(h0)
        out = stack(vae.decoder_lstm, tok0[:, None].expand(N, T, H))
        r = (Z - vae.output_layer(out)) ** 2
        return r.mean(dim=(1, 2)), r

    return run


LIBRARY_PASS = {"lstm": cudnn_vae_pass, "min_gru": scan_mingru_pass,
                "attention": sdpa_attention_pass}


def phase_timing(scorer, W, cell: str = "lstm"):
    import torch

    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.serve import bucket_size
    from shm_tpu_torch.tools.workload import (
        PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, bound_ms,
    )

    fam = FAMILIES[cell]
    weights_fn, gate, reference = FUSED_GATES[cell]
    tag = f"[time {cell}]"
    Wb = np.resize(W, (N_BENCH,) + W.shape[1:]).astype(np.float32)
    vae = scorer.vae
    N, T, D = Wb.shape
    Z = normalize_windows(torch.from_numpy(Wb).cuda(), scorer.mean,
                          scorer.std).contiguous()
    w = weights_fn(vae)
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)

    mse_k, resid_k = gate(w, Z, **kw)
    mse_p, resid_p = reference(w, Z, **kw)
    torch.cuda.synchronize()
    print(f"{tag} kernel vs plain at N={N} (trained weights, real windows):")
    err = max(compare("mse", mse_k, mse_p), compare("resid", resid_k, resid_p))
    print(f"{tag} max relative mse diff, kernel vs plain: "
          f"{float(((mse_k - mse_p).abs() / mse_p.abs()).max()):.3e}")
    del resid_p
    extra = {}
    if cell == "attention":
        extra = phase_attention_kernel(w, N, T, vae.hidden_dim, vae.num_layers)
    elif cell == "lstm":
        extra = phase_lstm_kernel(w, Z, mse_k, mse_p, T, D, vae.hidden_dim,
                                  vae.num_layers)
    else:
        extra = phase_mingru_kernel(w, Z, mse_k, mse_p, T, D, vae.hidden_dim,
                                    vae.num_layers, vae.use_layernorm)
    library = LIBRARY_PASS[cell](vae)
    mse_c, _ = library(Z)
    print(f"{tag} {fam['library']} yardstick vs kernel: max |mse diff| "
          f"{float((mse_c - mse_k).abs().max()):.3e}")

    ms = time_ms(lambda: gate(w, Z, **kw))
    plain_ms = time_ms(lambda: reference(w, Z, **kw), reps=5)
    library_ms = time_ms(lambda: library(Z))
    flops, nbytes = fam["work"](N, T, D, vae.hidden_dim, vae.latent_dim,
                                vae.num_layers)
    bound, bound_by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
    print(f"{tag} {gate.__name__} N={N}: kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | {fam['library']} yardstick {library_ms:.4f} ms")
    print(f"{tag} work {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB -> "
          f"bound {bound:.4f} ms ({bound_by}; f32 "
          f"{flops / PEAK_F32_FLOPS * 1e3:.4f} ms, bf16 tensor-core "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.4f} ms, bytes "
          f"{nbytes / PEAK_BYTES * 1e3:.4f} ms); kernel at "
          f"{bound / ms * 100:.1f}% of the f32 bound")

    scorer.score(Wb)                                   # warm the bucket
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        scorer.score(Wb)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    bucket = bucket_size(N, scorer.min_bucket, scorer.max_batch)
    print(f"{tag} score() end to end, {N} windows: median {wall * 1e3:.2f} ms "
          f"over 5 -> {N / wall:.1f} windows/s (one dispatch padded to "
          f"{bucket} windows)")
    profile_device(lambda: scorer.score(Wb),
                   f"{cell} score() of {len(Wb)} windows")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
            **extra}


def profile_device(fn, what: str, calls: int = 3, groups=None, rest: str = ""):
    """Where the time of one ``fn()`` goes: device time by kernel from
    ``torch.profiler`` over ``calls`` calls, against their host wall time,
    and the device's idle share. ``groups`` ({label: name fragments}) sums the
    kernels under labels first; ``rest`` labels what no group matched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # device-side events only (kernels, copies): the CPU operators that
    # launched them report the same device time again
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / calls)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    if not rows:
        print("[profile] the profiler recorded no device time: not measured")
        return
    busy = sum(ms for _, ms in rows)
    print(f"[profile] {what} under the profiler: wall {wall_ms:.2f} ms/call, "
          f"device busy {busy:.2f} ms/call, device idle share "
          f"{max(1 - busy / wall_ms, 0.0):.3f}")
    if groups:
        left = busy
        for label, keys in groups.items():
            g = sum(ms for n, ms in rows if any(k in n.lower() for k in keys))
            left -= g
            print(f"[profile]   {g:9.3f} ms  {g / busy * 100:5.1f}%  {label}")
        print(f"[profile]   {left:9.3f} ms  {left / busy * 100:5.1f}%  {rest}")
    for name, ms in rows[:10]:
        print(f"[profile]     {ms:9.3f} ms  {ms / busy * 100:5.1f}%  {name[:90]}")


# ---------------------------------------------------------------------------
# the LSTM training kernels (phases 6-8)
# ---------------------------------------------------------------------------

LSTM_KERNELS = {   # name in the kernels line: the TPU kernel it replaces
    "lstm2_enc_fwd": "shm_tpu/ops/lstm_train.py:153",
    "lstm2_enc_bwd": "shm_tpu/ops/lstm_train.py:191",
    "lstm2_dec_fwd": "shm_tpu/ops/lstm_train.py:359",
    "lstm2_dec_bwd": "shm_tpu/ops/lstm_train.py:399",
}
# the gradients of the encoder and the decoder op, in their order
LSTM_GRAD_NAMES = (["x", "w0i", "w0h", "b0", "w1i", "w1h", "b1"],
                   ["dec_in", "w0i", "w0h", "b0", "w1i", "w1h", "b1", "out_w", "out_b"])


def lstm_work(kernel: str, T: int, D: int, H: int, B: int, K: int = 0,
              with_dx: bool = False, mask: bool = True, recompute: bool = False):
    """(FLOPs, bytes) one call of an LSTM training kernel must do. FLOPs are
    matmul FLOPs (elementwise excluded, as in ``vae_work``): the forward's
    gate products; for a backward the transposed products of the dh chain
    and the weight-gradient products. Bytes: each input read once, each
    output written once (the gate gradients that pass between the backward's
    two passes are neither); the forward writes the gate stash [T,2,4H,B]
    and the backward reads it. ``recompute=True`` counts the design before
    the gate stash: no gate stash, and a backward that computes the forward's
    gate products again."""
    G = 4 * H
    n_w = G * (3 * H + 2) + G * (D if kernel.startswith("lstm2_enc") else K)
    gates = 0 if recompute else T * 2 * G * B
    stream = T * H * B * (1 if mask else 0) + T * G * B + G * B + gates
    if kernel == "lstm2_enc_fwd":
        flops = 2 * G * (D + 3 * H) * T * B
        words = T * D * B + stream + H * B + n_w
    elif kernel == "lstm2_enc_bwd":
        flops = ((2 * G * (D + 3 * H) * T * B if recompute else 0)
                 + 2 * G * 3 * H * T * B                # W^T dg for dh0, dh1
                 + 2 * G * (D + 3 * H) * T * B          # weight gradients
                 + (2 * G * D * T * B if with_dx else 0))
        words = (T * D * B + stream + H * B + n_w        # inputs
                 + n_w + (T * D * B if with_dx else 0))  # gradients out
    elif kernel == "lstm2_dec_fwd":
        flops = 2 * G * K * B + T * B * (2 * G * 3 * H + 2 * D * H)
        words = K * B + stream + n_w + (H + 1) * D + T * D * B
    elif kernel == "lstm2_dec_bwd":
        flops = ((2 * G * K * B + T * B * 2 * G * 3 * H if recompute else 0)
                 + T * B * (2 * G * 3 * H + 2 * D * H)   # W^T dg, head^T dr
                 + T * B * (2 * G * 3 * H + 2 * D * H)   # weight + head grads
                 + 2 * 2 * G * K * B)                    # layer-0 fold, d dec_in
        words = (K * B + stream + n_w + (H + 1) * D + T * D * B
                 + K * B + n_w + (H + 1) * D)
    else:
        raise ValueError(kernel)
    return float(flops), 4.0 * words


def lstm_case(seed: int, T, D, H, B, drop):
    """numpy-seeded inputs of one case, on the card, in the ops' layouts."""
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    u = lambda *s: t(rng.uniform(-1, 1, size=s) / np.sqrt(H))
    stack = lambda in_dim: [u(4 * H, in_dim), u(4 * H, H), u(4 * H, 1),
                            u(4 * H, H), u(4 * H, H), u(4 * H, 1)]
    mask = lambda: (t((rng.random((T, H, B)) > drop) / (1.0 - drop))
                    if drop else None)
    return dict(
        xs=t(rng.normal(size=(T, D, B))), dm_enc=mask(), enc_w=stack(D),
        R_enc=t(rng.normal(size=(H, B))),
        din=t(np.tanh(rng.normal(size=(H, B)))), dm_dec=mask(),
        dec_w=stack(H) + [u(D, H), u(D, 1)],
        R_dec=t(rng.normal(size=(T, D, B))))


def compare_grads(tag: str, got, want, names) -> float:
    """Max |got - want| over all gradients; fails past the stated tolerance."""
    worst_abs = 0.0
    for n, g, w in zip(names, got, want):
        err = (g - w).abs()
        atol = GRAD_ATOL_REL * max(float(w.abs().max()), 1e-12)
        over = float((err - RTOL * w.abs()).max())
        worst_abs = max(worst_abs, float(err.max()))
        print(f"[lstm]     {tag} d{n}: max |diff| {float(err.max()):.3e}, max "
              f"|plain| {float(w.abs().max()):.3e} (tolerance {GRAD_ATOL_REL:g}"
              f"*max|plain| + {RTOL:g}*|plain|) {'ok' if over <= atol else 'FAIL'}")
        check(over <= atol, f"{tag}: gradient {n} disagrees with autograd of "
                            f"the plain version (max |diff| {float(err.max()):.3e})")
    return worst_abs


def phase_lstm_kernels_vs_plain():
    """Both forwards and every gradient of the four kernels against autograd
    of the plain versions, and both forwards in the validation mode, same
    inputs, on the card. Returns the max |diff| per kernel at the 4DOF
    training shape."""
    import torch

    from shm_tpu_torch.ops import (
        lstm2_dec_head, lstm2_dec_head_reference, lstm2_enc_last,
        lstm2_scan_reference,
    )

    cases = [  # name, T, D, H, B, dropout
        ("4dof training shape", 100, 12, 128, 256, 0.3),
        ("4dof ragged batch", 100, 12, 128, 200, 0.3),
        ("1dof 2-layer shape", 80, 12, 32, 64, 0.2),
        ("unit mask", 100, 12, 128, 64, 0.0),
        ("4dof batch of 1,024 (clusters in waves)", 100, 12, 128, 1024, 0.3),
        ("one window", 100, 12, 128, 1, 0.3),
        ("H=64", 40, 12, 64, 45, 0.3),
    ]
    from shm_tpu_torch.ops.lstm_train import bwd_scan_info, fwd_scan_info

    # the forward- and reverse-scan instances as the card places them
    # (cudaFuncGetAttributes, cudaOccupancyMaxActiveClusters); raises where
    # no cluster fits
    for H in (32, 64, 128):
        for dec in (False, True):
            for scan, info in (("forward", fwd_scan_info(H, dec)),
                               ("reverse", bwd_scan_info(H, dec))):
                print(f"[lstm] {scan} scan H={H} {'decoder' if dec else 'encoder'}: "
                      f"{info['max_active_clusters']} clusters of 8 blocks at once, "
                      f"{info['threads']} threads and {info['shared_bytes']} B of "
                      f"shared memory a block, {info['registers']} registers and "
                      f"{info['local_bytes']} B of local memory (spills) a thread")
    errs = {}
    leaf = lambda ts: [a.clone().requires_grad_(True) for a in ts]
    for i, (name, T, D, H, B, drop) in enumerate(cases):
        c = lstm_case(200 + i, T, D, H, B, drop)
        print(f"[lstm] {name}: T={T} D={D} H={H} B={B} dropout={drop}")

        lv = leaf([c["xs"]] + c["enc_w"])
        out = lstm2_enc_last(lv[0], c["dm_enc"], *lv[1:])
        got = torch.autograd.grad((out * c["R_enc"]).sum(), lv)
        torch.cuda.synchronize()
        lp = leaf([c["xs"]] + c["enc_w"])
        ref = lstm2_scan_reference(lp[0], c["dm_enc"], *lp[1:])[-1]
        want = torch.autograd.grad((ref * c["R_enc"]).sum(), lp)
        check(out.shape == (H, B) and bool(torch.isfinite(out).all()),
              f"{name}: h_last not finite / wrong shape")
        e_fwd = compare("encoder h_last", out, ref)
        e_bwd = compare_grads("encoder", got, want, LSTM_GRAD_NAMES[0])
        if i == 0:
            errs["lstm2_enc_fwd"], errs["lstm2_enc_bwd"] = e_fwd, e_bwd

        lv = leaf([c["din"]] + c["dec_w"])
        out = lstm2_dec_head(lv[0], c["dm_dec"], *lv[1:], T=T)
        got = torch.autograd.grad((out * c["R_dec"]).sum(), lv)
        torch.cuda.synchronize()
        lp = leaf([c["din"]] + c["dec_w"])
        ref = lstm2_dec_head_reference(lp[0], c["dm_dec"], *lp[1:], T)
        want = torch.autograd.grad((ref * c["R_dec"]).sum(), lp)
        check(out.shape == (T, D, B) and bool(torch.isfinite(out).all()),
              f"{name}: recon not finite / wrong shape")
        e_fwd = compare("decoder recon", out, ref)
        e_bwd = compare_grads("decoder", got, want, LSTM_GRAD_NAMES[1])
        if i == 0:
            errs["lstm2_dec_fwd"], errs["lstm2_dec_bwd"] = e_fwd, e_bwd

        # every output of the forwards (what they keep for the backward too)
        # against the plain forward's, in both modes
        e_stash = compare_stash(c, T)
        if i == 0:
            errs["lstm2_enc_fwd"] = max(errs["lstm2_enc_fwd"], e_stash)
            errs["lstm2_dec_fwd"] = max(errs["lstm2_dec_fwd"], e_stash)

        # the trainer's validation mode: no gradient, so no stash is written,
        # and a null mask pointer
        with torch.no_grad():
            e_val = compare(
                "validation-mode lstm2_enc_last",
                lstm2_enc_last(c["xs"], None, *c["enc_w"]),
                lstm2_scan_reference(c["xs"], None, *c["enc_w"])[-1])
            d_val = compare(
                "validation-mode lstm2_dec_head",
                lstm2_dec_head(c["din"], None, *c["dec_w"], T=T),
                lstm2_dec_head_reference(c["din"], None, *c["dec_w"], T))
        if i == 0:
            errs["lstm2_enc_fwd"] = max(errs["lstm2_enc_fwd"], e_val)
            errs["lstm2_dec_fwd"] = max(errs["lstm2_dec_fwd"], d_val)
    return errs


def compare_stash(c, T: int) -> float:
    """Every output of both forward kernels against
    ``lstm2_scan_stash_reference`` on the same inputs, in the training mode
    (the case's masks; stash and gate stash kept) and in the trainer's
    validation mode (null mask, no stash): h_last / recon, the final state,
    and in the training mode the stash and the gate stash; max |diff|."""
    import torch

    from shm_tpu_torch.ops import lstm2_scan_stash_reference
    from shm_tpu_torch.ops.lstm_train import dec_forward_cuda, enc_forward_cuda

    worst = 0.0
    ow, ob = c["dec_w"][6:]
    with torch.no_grad():
        for mode, keep, dm_e, dm_d in (("training", True, c["dm_enc"], c["dm_dec"]),
                                       ("validation-mode", False, None, None)):
            h1s, *enc_ref = lstm2_scan_stash_reference(c["xs"], dm_e, *c["enc_w"])
            h_last, enc_saved = enc_forward_cuda(c["xs"], dm_e, *c["enc_w"],
                                                 keep_stash=keep)
            h1d, *dec_ref = lstm2_scan_stash_reference(c["din"], dm_d, *c["dec_w"][:6], T=T)
            recon, dec_saved = dec_forward_cuda(c["din"], dm_d, *c["dec_w"], T=T,
                                                keep_stash=keep)
            check(keep or enc_saved[3] is None and dec_saved[3] is None,
                  "a forward in validation mode wrote a stash")
            rows = [("encoder h_last", h_last, h1s[-1]),
                    ("decoder recon", recon, ow @ h1d + ob)]
            for tag, saved, ref in (("encoder", enc_saved, enc_ref),
                                    ("decoder", dec_saved, dec_ref)):
                rows.append((f"{tag} final state", saved[5], ref[2]))
                if keep:
                    rows += [(f"{tag} stash", saved[3], ref[0]),
                             (f"{tag} gate stash", saved[4], ref[1])]
            for what, got, want in rows:
                worst = max(worst, compare(f"{mode} {what}", got, want))
    return worst


def lstm_launch_counts():
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last

    return {"lstm2_enc_fwd": lstm2_enc_last.fwd_launches,
            "lstm2_enc_bwd": lstm2_enc_last.bwd_launches,
            "lstm2_dec_fwd": lstm2_dec_head.fwd_launches,
            "lstm2_dec_bwd": lstm2_dec_head.bwd_launches}


def reset_lstm_launch_counts():
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last

    lstm2_enc_last.fwd_launches = lstm2_enc_last.bwd_launches = 0
    lstm2_dec_head.fwd_launches = lstm2_dec_head.bwd_launches = 0


def phase_train_path():
    """``train-vae`` at full width on the committed normal runs, the recipe of
    ``Stage4DofConfig`` cut to ``TRAIN_EPOCHS`` epochs, on the card through
    the kernels, into a temporary root."""
    import shutil
    import tempfile

    import torch

    from shm_tpu_torch.cli.stage4dof import Paths, cmd_train_vae
    from shm_tpu_torch.config import Stage4DofConfig, replace
    from shm_tpu_torch.convert import vae_from_flax, vae_state_dict
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.ops import fused_vae_gate
    from shm_tpu_torch.train import reconstruction_mse, train_vae
    from shm_tpu_torch.train.vae import batch_loss, draw_batch_noise
    from shm_tpu_torch.utils.checkpoint import load_checkpoint
    from shm_tpu_torch.utils.io import load_json

    # the recipe unchanged; only the depth is cut (8 epochs of 50): the KL
    # weight of the cut run still ramps over its first 30%, and the
    # reconstruction loss falls over the 8 epochs under it
    cfg = Stage4DofConfig()
    tcfg = cfg.vae_train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        paths = Paths(tmp)
        paths.processed.mkdir(parents=True)
        shutil.copy(Paths(str(ROOT / "data" / "4dof")).run_splits,
                    paths.run_splits)

        reset_lstm_launch_counts()
        gate0 = fused_vae_gate.launches
        res = cmd_train_vae(paths, cfg, epochs=TRAIN_EPOCHS)
        torch.cuda.synchronize()
        counts = lstm_launch_counts()

        # the windows, as the command built them, for the checks below
        from shm_tpu_torch.cli.stage4dof import (
            _load_stats, build_fraction_windows_multi,
        )
        from shm_tpu_torch.data.windows import normalize_windows

        files = load_json(paths.run_splits)["normal"]["files"]
        Wtr, Wva = build_fraction_windows_multi(
            files, (cfg.train_frac, cfg.val_frac), cfg)
        mean, std = (torch.from_numpy(a).cuda() for a in _load_stats(paths))
        Ztr = normalize_windows(torch.from_numpy(Wtr).cuda(), mean, std)
        Zva = normalize_windows(torch.from_numpy(Wva).cuda(), mean, std)

        steps = TRAIN_EPOCHS * -(-len(Wtr) // tcfg.batch_size)
        vals = TRAIN_EPOCHS * -(-len(Wva) // tcfg.batch_size)
        print(f"[train] {len(Wtr)} train / {len(Wva)} val windows, "
              f"{TRAIN_EPOCHS} epochs = {steps} steps + {vals} validation "
              f"batches in {res.seconds:.2f} s ({res.seconds / TRAIN_EPOCHS:.3f} "
              f"s/epoch); launches {counts}")
        # every step launches each forward and each backward once; every
        # validation batch launches the two forwards (unit mask, no stash)
        check(counts["lstm2_enc_bwd"] == steps and counts["lstm2_dec_bwd"] == steps,
              f"backward launches {counts} != {steps} training steps")
        check(counts["lstm2_enc_fwd"] == steps + vals
              and counts["lstm2_dec_fwd"] == steps + vals,
              f"forward launches {counts} != {steps} steps + {vals} validation batches")
        h = res.history
        check(len(h["epoch"]) == TRAIN_EPOCHS and all(
            np.isfinite(h[k]).all() for k in h), "non-finite loss in the history")
        print(f"[train] train recon by epoch {h['train_recon']}, val total "
              f"{h['val_total']}, best epoch {res.best_epoch}")
        check(h["train_recon"][-1] < h["train_recon"][0],
              "the training reconstruction loss did not fall")

        # the written checkpoint, read back by the port's reader
        tree = load_checkpoint(paths.models / "temporal_vae.msgpack")
        sd = vae_state_dict(tree["params"], cfg.vae.num_layers,
                            cfg.vae.use_layernorm)
        check(sd.keys() == res.params.keys() and all(
            torch.equal(sd[k], res.params[k].cpu()) for k in sd),
            "temporal_vae.msgpack read back differs from the trained params")
        vae = vae_from_flax(tree["params"], cfg.vae).cuda()

        # gate-only scoring of the validation windows through the fused kernel
        mse_k = reconstruction_mse(vae, Zva)
        gate_launches = fused_vae_gate.launches - gate0
        mse_p = reconstruction_mse(vae, Zva, fused=False)
        check(gate_launches == 1, f"reconstruction_mse launched the gate "
                                  f"kernel {gate_launches} times, not once")
        check(mse_k.shape == (len(Wva),) and np.isfinite(mse_k).all(),
              "reconstruction_mse not finite / wrong shape")
        print(f"[train] reconstruction_mse of {len(Wva)} val windows through "
              f"fused_vae_gate(with_residual=False): mean {mse_k.mean():.6f}")
        compare("reconstruction_mse vs plain model",
                torch.from_numpy(mse_k), torch.from_numpy(mse_p))

    # the same run again, now that every kernel of the loop is loaded: the
    # first call above pays the first use of each of them
    again = train_vae(vae_from_config(cfg.vae), Ztr, Zva,
                      replace(tcfg, epochs=TRAIN_EPOCHS))
    print(f"[train] second run of {TRAIN_EPOCHS} epochs: "
          f"{again.seconds / TRAIN_EPOCHS:.3f} s/epoch (first run "
          f"{res.seconds / TRAIN_EPOCHS:.3f} s/epoch)")
    check(again.history["train_total"] == res.history["train_total"],
          "two runs from one seed gave different training losses")

    # first batch, same noise: kernel path against plain autograd path
    model = vae_from_config(cfg.vae).cuda()
    model.init_parameters(torch.Generator().manual_seed(tcfg.seed))
    model.train()
    bs = tcfg.batch_size
    gen = torch.Generator(device="cuda").manual_seed(tcfg.seed)
    xb = Ztr[:bs].contiguous()
    bmask = torch.ones(bs, device="cuda")
    eps, dm_e, dm_d = draw_batch_noise(model, bs, xb.shape[1], gen, xb.device)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for kernel in (True, False):
        total, _, _ = batch_loss(model, xb, bmask, eps, dm_e, dm_d, 0.5, kernel)
        out[kernel] = (total.detach(), torch.autograd.grad(total, params))
    torch.cuda.synchronize()
    print("[train] first batch, same noise, kernel path vs plain autograd path:")
    compare("loss", out[True][0], out[False][0])
    compare_grads("step", out[True][1], out[False][1], names)
    return counts, dict(model=model, xb=xb, bmask=bmask, noise=(eps, dm_e, dm_d),
                        seconds_per_epoch=again.seconds / TRAIN_EPOCHS)


def cudnn_lstm(in_dim: int, H: int, drop: float):
    from torch import nn

    m = nn.LSTM(in_dim, H, 2, batch_first=True, dropout=drop).cuda().train()
    m.flatten_parameters()
    return m


def time_fwd_bwd(make_loss, leaves, reps: int = REPS):
    """(forward ms, backward ms): the forward alone, and forward + backward
    minus it (a graph is built anew for every backward)."""
    import torch

    fwd = time_ms(make_loss, reps=reps)
    both = time_ms(lambda: torch.autograd.grad(make_loss(), leaves), reps=reps)
    return fwd, max(both - fwd, 0.0)


def lstm_kernel_ms(c, T: int):
    """CUDA-event ms of the four kernels on the inputs of one ``lstm_case``
    (a training step asks for no dx), through the wrappers' public calls."""
    from shm_tpu_torch.ops.lstm_train import (
        dec_backward_cuda, dec_forward_cuda, enc_backward_cuda,
        enc_forward_cuda,
    )

    _, enc_saved = enc_forward_cuda(c["xs"], c["dm_enc"], *c["enc_w"])
    _, dec_saved = dec_forward_cuda(c["din"], c["dm_dec"], *c["dec_w"], T=T)
    return {
        "lstm2_enc_fwd": time_ms(lambda: enc_forward_cuda(
            c["xs"], c["dm_enc"], *c["enc_w"])),
        "lstm2_enc_bwd": time_ms(lambda: enc_backward_cuda(
            enc_saved, c["R_enc"], need_dx=False)),
        "lstm2_dec_fwd": time_ms(lambda: dec_forward_cuda(
            c["din"], c["dm_dec"], *c["dec_w"], T=T)),
        "lstm2_dec_bwd": time_ms(lambda: dec_backward_cuda(dec_saved, c["R_dec"])),
    }


def phase_lstm_timing(errs, counts, ctx):
    """CUDA-event times of the four kernels at the 4DOF training shape, of
    their plain versions and of a cuDNN ``nn.LSTM`` yardstick; one training
    step on the three paths; where a kernel-path step's time goes."""
    import torch
    from torch import nn

    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.ops import (
        lstm2_dec_head_reference, lstm2_scan_reference,
    )
    from shm_tpu_torch.tools.workload import PEAK_BYTES, PEAK_F32_FLOPS, bound_ms
    from shm_tpu_torch.train.vae import batch_loss, make_optimizer

    cfg = Stage4DofConfig()
    T, D, H, B, drop = cfg.seq_len, cfg.vae.input_dim, cfg.vae.hidden_dim, \
        cfg.vae_train.batch_size, cfg.vae.dropout
    c = lstm_case(300, T, D, H, B, drop)
    leaf = lambda ts: [a.clone().requires_grad_(True) for a in ts]

    ms = lstm_kernel_ms(c, T)
    # --- plain versions under autograd (weights are the leaves, as in training)
    ew, dw = leaf(c["enc_w"]), leaf(c["dec_w"])
    din = c["din"].clone().requires_grad_(True)
    plain = {}
    plain["lstm2_enc_fwd"], plain["lstm2_enc_bwd"] = time_fwd_bwd(
        lambda: (lstm2_scan_reference(c["xs"], c["dm_enc"], *ew)[-1]
                 * c["R_enc"]).sum(), ew, reps=5)
    plain["lstm2_dec_fwd"], plain["lstm2_dec_bwd"] = time_fwd_bwd(
        lambda: (lstm2_dec_head_reference(din, c["dm_dec"], *dw, T)
                 * c["R_dec"]).sum(), [din] + dw, reps=5)
    # --- cuDNN yardstick: nn.LSTM (2 layers, dropout between) computes the
    # same scans, all T outputs included; the decoder adds a Linear head
    enc_l, dec_l = cudnn_lstm(D, H, drop), cudnn_lstm(H, H, drop)
    head = nn.Linear(H, D).cuda()
    x_bt = c["xs"].permute(2, 0, 1).contiguous()
    din_bt = c["din"].t().contiguous().requires_grad_(True)
    R_enc_bt, R_dec_bt = c["R_enc"].t().contiguous(), c["R_dec"].permute(2, 0, 1).contiguous()
    lib = {}
    lib["lstm2_enc_fwd"], lib["lstm2_enc_bwd"] = time_fwd_bwd(
        lambda: (enc_l(x_bt)[1][0][-1] * R_enc_bt).sum(), list(enc_l.parameters()))
    lib["lstm2_dec_fwd"], lib["lstm2_dec_bwd"] = time_fwd_bwd(
        lambda: (head(dec_l(din_bt[:, None].expand(B, T, H))[0]) * R_dec_bt).sum(),
        [din_bt] + list(dec_l.parameters()) + list(head.parameters()))

    rows = []
    for name, replaces in LSTM_KERNELS.items():
        flops, nbytes = lstm_work(name, T, D, H, B, K=H)
        bound, bound_by = bound_ms(flops, nbytes, PEAK_F32_FLOPS)
        old = bound_ms(*lstm_work(name, T, D, H, B, K=H, recompute=True),
                       PEAK_F32_FLOPS)[0]
        print(f"[time] {name} T={T} H={H} B={B}: kernel {ms[name]:.4f} ms | "
              f"plain {plain[name]:.4f} ms | cuDNN nn.LSTM {lib[name]:.4f} ms | "
              f"work {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB -> bound "
              f"{bound:.4f} ms (f32 {flops / PEAK_F32_FLOPS * 1e3:.4f}, bytes "
              f"{nbytes / PEAK_BYTES * 1e3:.4f}; with the backward's gate "
              f"recompute and no gate stash, as before the gate stash: "
              f"{old:.4f}); kernel at {bound / ms[name] * 100:.1f}% of the bound")
        rows.append(dict(
            name=name, route="cuda",
            source="shm_tpu_torch/ops/csrc/lstm_train.cu", replaces=replaces,
            launches=counts[name], max_abs_err=errs[name], ms=ms[name],
            plain_ms=plain[name], bound_ms=bound, bound_by=bound_by,
            library_ms=lib[name]))

    # --- one training step: kernel path, plain autograd path, cuDNN yardstick
    model, xb, bmask = ctx["model"], ctx["xb"], ctx["bmask"]
    eps, dm_e, dm_d = ctx["noise"]
    opt = make_optimizer(model.parameters(), cfg.vae_train)

    def step(kernel):
        opt.zero_grad()
        total, _, _ = batch_loss(model, xb, bmask, eps, dm_e, dm_d, 0.5, kernel)
        total.backward()
        opt.step()

    others = [model.fc_mu, model.fc_logvar, model.fc_latent_to_hidden,
              model.output_layer] + ([model.layer_norm] if model.layer_norm is not None else [])
    cparams = [p for m in [enc_l, dec_l] + others for p in m.parameters()]
    copt = make_optimizer(cparams, cfg.vae_train)

    def cudnn_step():
        from shm_tpu_torch.models.vae import vae_loss

        copt.zero_grad()
        h = enc_l(xb)[1][0][-1]
        if model.layer_norm is not None:
            h = model.layer_norm(h)
        mu, logvar = model.fc_mu(h), model.fc_logvar(h)
        z = mu + eps * torch.exp(0.5 * logvar)
        d = torch.tanh(model.fc_latent_to_hidden(z))
        recon = model.output_layer(dec_l(d[:, None].expand(B, T, H))[0])
        vae_loss(recon, xb, mu, logvar, 0.5, mask=bmask)[0].backward()
        copt.step()

    step_ms = time_ms(lambda: step(True))
    plain_step_ms = time_ms(lambda: step(False), reps=3, warm=1)
    cudnn_step_ms = time_ms(cudnn_step)
    print(f"[time] one training step (batch {B}, forward + backward + "
          f"optimizer): kernel path {step_ms:.3f} ms | plain autograd path "
          f"{plain_step_ms:.3f} ms | cuDNN nn.LSTM yardstick {cudnn_step_ms:.3f} ms; "
          f"train-vae's loop ran at {ctx['seconds_per_epoch']:.3f} s/epoch")
    kern = sum(ms.values())
    print(f"[time] the four kernels sum to {kern:.3f} ms = "
          f"{kern / step_ms * 100:.1f}% of the kernel-path step")
    profile_device(
        lambda: step(True), "one kernel-path training step",
        groups={"recurrent scans (lstm2_*_kernel)": ("lstm2_",),
                "gradient pass (contract/reduce/sum/wt_dg)":
                    ("contract_partial", "reduce_partial", "sum_t_rowsum", "wt_dg"),
                "optimizer (foreach/Adam kernels)": ("multi_tensor", "foreach", "adam")},
        rest="autograd glue (LayerNorm, heads, loss, transposes, clip)")
    return rows


# the gate rows that --child / --parent time: the trained VAE of this
# checkout's root of the family (the committed test windows of data/4dof,
# tiled), at bench.py's workload and at the 8,192-window bucket that score()
# pads it to
GATE_ROW_NS = (N_BENCH, 8192)


def gate_row(cell: str):
    """A gate row of the importable tree: the trained VAE of this checkout's
    root of ``cell`` through that tree's public calls, on the 3,636 committed
    test windows tiled to each of ``GATE_ROW_NS``. Returns ({N: kernel ms},
    mse at ``N_BENCH``)."""
    import torch

    from shm_tpu_torch.cli.stage4dof import build_fraction_windows
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.ops import FUSED_GATES
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.utils.io import load_json

    cfg = Stage4DofConfig()
    scorer = HybridScorer.from_artifacts(ROOT / FAMILIES[cell]["root"])
    # the runs' paths are relative to this checkout, not to the child tree
    splits = load_json(ROOT / "data" / "4dof" / "processed" / "run_splits.json")
    W = np.concatenate([build_fraction_windows(
        [str(ROOT / f) for f in splits[g]["files"]], cfg.test_frac, cfg)
        for g in ("normal", "sensor_fault", "structural_fault")])
    weights_fn, gate, _ = FUSED_GATES[cell]
    w = weights_fn(scorer.vae)
    kw = dict(num_layers=scorer.vae.num_layers,
              use_layernorm=scorer.vae.use_layernorm)
    ms, mse = {}, None
    for n in GATE_ROW_NS:
        Wb = np.resize(W, (n,) + W.shape[1:]).astype(np.float32)
        Z = normalize_windows(torch.from_numpy(Wb).cuda(), scorer.mean,
                              scorer.std).contiguous()
        if n == N_BENCH:
            mse = gate(w, Z, **kw)[0].cpu()
        ms[n] = time_ms(lambda: gate(w, Z, **kw))
    return ms, mse


# the gate rows of --child / --parent: (cell, kernel name, row number)
PARENT_GATE_ROWS = (("lstm", "fused_vae_gate", 1),
                    ("min_gru", "fused_mingru_gate", 6),
                    ("attention", "fused_attention_gate", 7))


def child(root: str, out: str) -> int:
    """Child mode (``--child ROOT OUT``): kernels of the tree at ROOT on this
    card, through its public calls only: the four LSTM kernels (the
    gradients of phase 6's 4DOF case and their ms at the 4DOF training
    shape) and rows 1, 6 and 7 (``gate_row``), saved to OUT with
    ``torch.save``."""
    sys.path.insert(0, root)
    import torch

    import shm_tpu_torch
    from shm_tpu_torch.device import set_full_f32_precision
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last

    set_full_f32_precision()
    T = 100
    c = lstm_case(200, T, 12, 128, 256, 0.3)
    leaf = lambda ts: [a.clone().requires_grad_(True) for a in ts]
    lv = leaf([c["xs"]] + c["enc_w"])
    enc = torch.autograd.grad((lstm2_enc_last(lv[0], c["dm_enc"], *lv[1:])
                               * c["R_enc"]).sum(), lv)
    lv = leaf([c["din"]] + c["dec_w"])
    dec = torch.autograd.grad((lstm2_dec_head(lv[0], c["dm_dec"], *lv[1:], T=T)
                               * c["R_dec"]).sum(), lv)
    ms = lstm_kernel_ms(lstm_case(300, T, 12, 128, 256, 0.3), T)
    gate_mse = {}
    for cell, name, _ in PARENT_GATE_ROWS:
        by_n, gate_mse[name] = gate_row(cell)
        ms[name] = by_n[N_BENCH]
        for n, v in by_n.items():
            if n != N_BENCH:
                ms[f"{name} N={n}"] = v
    package = str(Path(shm_tpu_torch.__file__).parent)
    print(f"[child] {package}: " + ", ".join(f"{n} {v:.4f}" for n, v in ms.items())
          + " ms")
    torch.save(dict(package=package, ms=ms, gate_mse=gate_mse,
                    enc=[g.cpu() for g in enc], dec=[g.cpu() for g in dec]), out)
    return 0


def phase_parent(parent: str, rows) -> None:
    """Rows 1-7 of the tree at ``parent`` (e.g. the parent commit, unpacked)
    and of this tree on this card, one child process each, in turns parent,
    this, this, parent: their kernel ms side by side (rows 1, 6 and 7 also
    at the 8,192 bucket); the LSTM gradients of the two trees on the same
    inputs (bit for bit, or within the stated tolerance) and rows 1, 6 and
    7's MSE (within the kernel tolerance of the parent's; this tree's two
    runs bit for bit). Adds ``parent_ms`` (median of the parent's two runs)
    to those rows."""
    import tempfile

    import torch

    runs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parent_") as tmp:
        for k, root in enumerate([parent, str(ROOT), str(ROOT), parent]):
            out = Path(tmp) / f"run{k}.pt"
            r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                "--child", str(root), str(out)],
                               capture_output=True, text=True, timeout=900)
            check(r.returncode == 0, f"child run on {root} failed:\n{r.stderr[-3000:]}")
            runs.append(torch.load(out))
            print(f"[parent] run {k}: {runs[-1]['package']}: " + ", ".join(
                f"{n} {v:.4f}" for n, v in runs[-1]["ms"].items()) + " ms")
    for name in runs[0]["ms"]:
        par = [runs[0]["ms"][name], runs[3]["ms"][name]]
        new = [runs[1]["ms"][name], runs[2]["ms"][name]]
        print(f"[parent] {name}: parent {par[0]:.4f} / {par[1]:.4f} ms, this tree "
              f"{new[0]:.4f} / {new[1]:.4f} ms ({min(new) / min(par):.3f}x of the parent)")
        for row in rows:
            if row["name"] == name:
                row["parent_ms"] = float(np.median(par))
    for tag, names in zip(("enc", "dec"), LSTM_GRAD_NAMES):
        same = [bool(torch.equal(a, b)) for a, b in zip(runs[0][tag], runs[1][tag])]
        print(f"[parent] {tag} gradients equal to the parent's bit for bit: "
              + ", ".join(f"d{n} {'yes' if s_ else 'no'}" for n, s_ in zip(names, same)))
        compare_grads(f"{tag} this tree vs parent", runs[1][tag], runs[0][tag], names)
        check(all(torch.equal(a, b) for a, b in zip(runs[1][tag], runs[2][tag])),
              f"{tag}: two runs of this tree gave different gradients")
    for _, name, row in PARENT_GATE_ROWS:
        new, par = runs[1]["gate_mse"][name], runs[0]["gate_mse"][name]
        print(f"[parent] row {row} mse at N={N_BENCH}, this tree against the "
              f"parent's:")
        compare(f"{name} mse, this tree vs parent", new, par)
        check(torch.equal(new, runs[2]["gate_mse"][name]),
              f"row {row}: two runs of this tree gave different mse")
        print(f"[parent] row {row} mse of this tree's two runs: equal bit for bit")


# ---------------------------------------------------------------------------
# the probes (phase 9)
# ---------------------------------------------------------------------------

PROBES = {   # name in the kernels line: (source, the TPU kernel it replaces)
    "fused_vae_probe": ("shm_tpu_torch/ops/csrc/fused_vae.cu",
                        "tools/probe_vpu_bound.py:76"),
    "probe_mingru_gate": ("shm_tpu_torch/ops/csrc/probe_mingru_gate.cu",
                          "tools/probe_mingru_recur.py:49"),
    "probe_matmul_loop": ("shm_tpu_torch/ops/csrc/probe_matmul_loop.cu",
                          "tools/probe_f32_cliff.py:50"),
}
# The probes' bf16 paths against their plain versions. A stored bf16 value
# whose last bit flips when the two sum in another order moves by one bf16
# ulp and the recurrence carries it forward: that moves a few elements far.
# A kernel that drops or adds a rounding, or takes another LayerNorm eps,
# moves every element a little. So each path is held on (max |diff| /
# max |plain|, mean |diff| / mean |plain|), and the checks show that each
# tolerance fails such a planted fault. Measured on the card (PERF.md §6):
# gate_variant and make_gate, N=1000, T=100: kernel (1.5e-5, 8.8e-7); with
# bf16 activations (6 more roundings a cell, so more flips) (2.3e-5, 2.4e-6);
# the faults move the mean by 7.2e-6 (eps) to 1.4e-4 (float32).
# matmul_loop bf16, T=100: kernel (4.8e-3, 4.3e-4); float32 instead of bf16
# moves the mean by 7.3e-3.
PROBE_TOL = {"gate": (1e-4, 2e-6), "gate_act_bf16": (1e-4, 5e-6),
             "matmul_bf16": (1e-2, 1e-3)}
# bf16x3 (three bf16 products) against the float32 loop's plain version at
# T=100: measured at most (1.2e-4, 3.3e-5) over 14 input seeds, where bf16
# alone is (1.4e-2, 6.2e-3) or more away
BF16X3_F32_TOL = (3e-4, 1e-4)
PROBE_REPS = 5


def rel_errs(got, ref):
    """(max |got - ref| / max |ref|, mean |got - ref| / mean |ref|)."""
    d, r = (got - ref).abs().double(), ref.abs().double()
    return float(d.max() / r.max()), float(d.mean() / r.mean())


def compare_rel(name: str, got, ref, tol) -> float:
    """Max |got - ref|; fails past either relative tolerance of ``tol``."""
    max_rel, mean_rel = rel_errs(got, ref)
    ok = max_rel <= tol[0] and mean_rel <= tol[1]
    print(f"[probe]   {name}: max_rel {max_rel:.3e} (<= {tol[0]:g}), mean_rel "
          f"{mean_rel:.3e} (<= {tol[1]:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: probe kernel disagrees with its plain version "
              f"(max_rel {max_rel:.3e}, mean_rel {mean_rel:.3e})")
    return float((got - ref).abs().max())


def planted_fault(name: str, got, wrong_ref, tol) -> None:
    """``tol`` must tell the kernel's output from ``wrong_ref``, the plain
    version with one numerics knob changed."""
    max_rel, mean_rel = rel_errs(got, wrong_ref)
    caught = max_rel > tol[0] or mean_rel > tol[1]
    print(f"[probe]   planted fault, {name}: max_rel {max_rel:.3e}, mean_rel "
          f"{mean_rel:.3e} -> {'caught' if caught else 'MISSED'}")
    check(caught, f"the tolerance {tol} does not tell {name}")


def phase_probes_vs_plain():
    """Each probe kernel against its plain version on the card, random
    inputs from a numpy seed, and the planted faults each tolerance must
    fail. Returns the max |diff| per kernel."""
    import torch

    from shm_tpu_torch.ops import (
        fused_vae_gate, mingru_params_to_kernel_weights,
        vae_params_to_kernel_weights,
    )
    from shm_tpu_torch.tools.probe_f32_cliff import (
        MODES, make_inputs, matmul_loop, matmul_loop_reference,
    )
    from shm_tpu_torch.tools.probe_mingru_recur import (
        make_gate, mingru_gate_reference,
    )
    from shm_tpu_torch.tools.probe_vpu_bound import (
        A_F32, MODEL_LN_EPS, PORT_VARIANTS, SHIP_TC, VARIANTS, gate_variant,
        gate_variant_reference,
    )

    errs = dict.fromkeys(PROBES, 0.0)
    tol = PROBE_TOL["matmul_bf16"]
    for tiles in (1, 21):
        w, x = make_inputs(tiles, seed=400 + tiles, device="cuda")
        f32_ref = matmul_loop_reference(w, x, "f32")
        for mode in MODES:
            out = matmul_loop(w, x, mode)
            torch.cuda.synchronize()
            ref = f32_ref if mode == "f32" else matmul_loop_reference(w, x, mode)
            check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                  f"matmul_loop/{mode}: not finite / wrong shape")
            name = f"matmul_loop/{mode} {tiles} tile(s), T=100"
            if mode == "bf16":
                e = compare_rel(name, out, ref, tol)
                planted_fault(f"{name} held against the float32 loop", out,
                              f32_ref, tol)
            else:
                e = compare(name, out, ref)
            if mode == "bf16x3":
                compare_rel(f"{name} against the float32 loop", out, f32_ref,
                            BF16X3_F32_TOL)
            errs["probe_matmul_loop"] = max(errs["probe_matmul_loop"], e)

    tol = PROBE_TOL["gate"]
    vae, rng = random_vae(410, 12, 16, 128, 2, True)
    w = vae_params_to_kernel_weights(vae)
    Z = torch.from_numpy(rng.normal(size=(1000, 100, 12)).astype(np.float32)).cuda()
    out = {}
    for name, kw in {**PORT_VARIANTS, **VARIANTS}.items():
        out[name] = gate_variant(w, Z, **kw)
        torch.cuda.synchronize()
        check(out[name].shape == (1000,) and bool(torch.isfinite(out[name]).all()),
              f"gate_variant {name}: not finite / wrong shape")
        ref = gate_variant_reference(w, Z, **kw)
        label = f"gate_variant {name} N=1000"
        # float32 operands (bf16 weights at most): the gate's float32 tolerance
        if kw.get("bf16", "all") != "all":
            e = compare(label, out[name], ref)
        else:
            e = compare_rel(label, out[name], ref,
                            PROBE_TOL["gate_act_bf16" if kw.get("act_bf16") else "gate"])
        errs["fused_vae_probe"] = max(errs["fused_vae_probe"], e)
    # A, the float32 FMA instance, against the plain version; T, the
    # tensor-core body at the model's eps, is the shipping kernel bit for bit
    a = gate_variant(w, Z, **A_F32)
    torch.cuda.synchronize()
    errs["fused_vae_probe"] = max(errs["fused_vae_probe"], compare(
        "gate_variant A (float32 FMA) N=1000", a, gate_variant_reference(w, Z, **A_F32)))
    ship = fused_vae_gate(w, Z, num_layers=2, use_layernorm=True,
                          with_residual=False)[0]
    check(torch.equal(out["T_tensor_cores"], ship),
          "gate_variant T (tc, eps 1e-5) is not fused_vae_gate bit for bit")
    print(f"[probe]   gate_variant T (tc={SHIP_TC!r}, bf16='none', eps 1e-5) == "
          "fused_vae_gate, bit for bit")
    planted_fault("gate_variant D held against float32 operands",
                  out["D_probe_baseline"], gate_variant_reference(w, Z, bf16="none"), tol)
    planted_fault("gate_variant D held against LayerNorm eps 1e-5",
                  out["D_probe_baseline"],
                  gate_variant_reference(w, Z, ln_eps=MODEL_LN_EPS), tol)
    planted_fault("gate_variant F held against B (bf16 activations added)",
                  out["F_tanh_bf16_act"],
                  gate_variant_reference(w, Z, sig_via_tanh=True), tol)
    planted_fault("gate_variant B held against F (bf16 activations dropped)",
                  out["B_sig_via_tanh"],
                  gate_variant_reference(w, Z, sig_via_tanh=True, act_bf16=True),
                  PROBE_TOL["gate_act_bf16"])

    vae, rng = random_vae(420, 12, 16, 128, 2, True, cell="min_gru")
    w = mingru_params_to_kernel_weights(vae)
    Z = torch.from_numpy(rng.normal(size=(1000, 100, 12)).astype(np.float32)).cuda()
    for loop_T in (100, 1):
        o = make_gate(loop_T)(w, Z)
        torch.cuda.synchronize()
        check(o.shape == (1000,) and bool(torch.isfinite(o).all()),
              f"make_gate({loop_T}): not finite / wrong shape")
        label = f"make_gate(loop_T={loop_T}) N=1000"
        e = compare_rel(label, o, mingru_gate_reference(w, Z, loop_T), tol)
        planted_fault(f"{label} held against float32 scratch and operands", o,
                      mingru_gate_reference(w, Z, loop_T, bf16=False), tol)
        planted_fault(f"{label} held against LayerNorm eps 1e-5", o,
                      mingru_gate_reference(w, Z, loop_T, ln_eps=MODEL_LN_EPS), tol)
        errs["probe_mingru_gate"] = max(errs["probe_mingru_gate"], e)
    return errs


def matmul_loop_library(w, x, dtype, T: int = 100):
    """``matmul_loop``'s function as a T-step loop of ``torch.matmul`` in
    ``dtype``: a yardstick timed here only."""
    import torch

    H = w.shape[1]
    wd, h = w.to(dtype), x[:H].clone()
    for _ in range(T):
        g = torch.matmul(wd, h.to(dtype)).float()
        h = torch.tanh(g[:H]) * 0.25 + h * 0.75
    return h


def phase_probe_path(errs, wl):
    """The probe path: the three probes' tables at the TPU probes' sizes on
    the trained 4DOF workload ``wl``, launch counts from 0; then each kernel
    row's plain, library and bound."""
    import torch

    from shm_tpu_torch.ops import vae_params_to_kernel_weights
    from shm_tpu_torch.tools import (
        probe_f32_cliff, probe_mingru_recur, probe_vpu_bound,
    )
    from shm_tpu_torch.tools.workload import (
        PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, bound_ms,
    )

    vae8 = wl.vae.cuda()
    w8 = vae_params_to_kernel_weights(vae8)
    Z8 = torch.from_numpy(probe_vpu_bound.tiled_windows(wl)).cuda()
    vae9, w9, Z9 = probe_mingru_recur.probe_inputs()
    counters = {"fused_vae_probe": probe_vpu_bound.gate_variant,
                "probe_mingru_gate": probe_mingru_recur.make_gate,
                "probe_matmul_loop": probe_f32_cliff.matmul_loop}

    for fn in counters.values():
        fn.launches = 0
    rows8 = probe_vpu_bound.probe_table(w8, Z8, wl.threshold, PROBE_REPS)
    rows9 = probe_mingru_recur.probe_table(w9, Z9, PROBE_REPS)
    rows10 = probe_f32_cliff.probe_table(reps=PROBE_REPS)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    for tag, rows in (("probe_vpu_bound", rows8), ("probe_mingru_recur", rows9),
                      ("probe_f32_cliff", rows10)):
        for row in rows:
            print(f"[{tag}] {json.dumps(row)}")
    print(f"[probe] launches on the probe path: {launches}")
    check(all(launches.values()), f"a probe kernel was not launched: {launches}")
    for row in rows8[1:]:
        check(row["gate_agree"] >= 0.99, f"{row['variant']}: gate decisions "
                                         f"agree on {row['gate_agree']:.4f} < 0.99")

    ms8 = next(r["ms"] for r in rows8 if r["variant"] == "D_probe_baseline")
    ms9 = next(r["ms"] for r in rows9 if r.get("run") == "probe clone (full T)")
    ms10 = next(r["ms"] for r in rows10 if r["probe"] == "matmul_loop/f32")
    w, x = probe_f32_cliff.make_inputs(device="cuda")
    plain = {
        "fused_vae_probe": time_ms(lambda: probe_vpu_bound.gate_variant_reference(
            w8, Z8), reps=2, warm=1),
        "probe_mingru_gate": time_ms(
            lambda: probe_mingru_recur.mingru_gate_reference(w9, Z9), reps=2, warm=1),
        "probe_matmul_loop": time_ms(
            lambda: probe_f32_cliff.matmul_loop_reference(w, x, "f32"), reps=3, warm=1),
    }
    lib8, lib9 = cudnn_vae_pass(vae8), scan_mingru_pass(vae9)
    lib_bf16 = time_ms(lambda: matmul_loop_library(w, x, torch.bfloat16), reps=3, warm=1)
    library = {
        "fused_vae_probe": time_ms(lambda: lib8(Z8), reps=3, warm=1),
        "probe_mingru_gate": time_ms(lambda: lib9(Z9), reps=3, warm=1),
        "probe_matmul_loop": time_ms(
            lambda: matmul_loop_library(w, x, torch.float32), reps=3, warm=1),
    }
    n = Z8.shape[0]
    work = {
        "fused_vae_probe": vae_work(n, 100, 12, 128, 16, 2, with_residual=False),
        "probe_mingru_gate": mingru_work(n, 100, 12, 128, 16, 2, with_residual=False),
        "probe_matmul_loop": (probe_f32_cliff.matmul_loop_flops(x.shape[1], "f32"),
                              4.0 * (w.numel() + x.numel() + x.shape[1] * 128)),
    }
    ms = {"fused_vae_probe": ms8, "probe_mingru_gate": ms9, "probe_matmul_loop": ms10}
    # rows 8 and 9 (variant D, the clone) multiply bf16 operands, as the TPU
    # probes' `mm` does: their bound is at the bf16 tensor-core rate, though
    # the kernels run the FMA pipes (that figure: bound_fma_ms); row 10 is
    # its f32 mode
    rows = []
    for name, (source, replaces) in PROBES.items():
        flops, nbytes = work[name]
        peak = PEAK_F32_FLOPS if name == "probe_matmul_loop" else PEAK_BF16_FLOPS
        bound, bound_by = bound_ms(flops, nbytes, peak)
        fma_ms = flops / PEAK_F32_FLOPS * 1e3
        print(f"[probe] {name}: kernel {ms[name]:.4f} ms | plain {plain[name]:.4f} "
              f"ms | library {library[name]:.4f} ms | work {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB -> bound {bound:.4f} ms ({bound_by}, "
              f"{'f32' if peak == PEAK_F32_FLOPS else 'bf16 tensor-core'} rate; "
              f"f32 FMA pipes {fma_ms:.4f}, bytes {nbytes / PEAK_BYTES * 1e3:.4f}); "
              f"kernel at {bound / ms[name] * 100:.1f}% of the bound, "
              f"{fma_ms / ms[name] * 100:.1f}% of the FMA-pipe figure")
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms[name],
            plain_ms=plain[name], bound_ms=bound, bound_by=bound_by,
            library_ms=library[name], bound_fma_ms=fma_ms))
    print(f"[probe] matmul_loop library yardstick in bf16 (torch.matmul loop): "
          f"{lib_bf16:.4f} ms; the kernels row reports the f32 mode")
    return rows


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        return child(argv[1], argv[2])
    parent = None
    if argv[:1] == ["--parent"]:
        parent = str(Path(argv[1]).resolve())
    elif argv:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "shm_tpu_torch" / "ops" / "csrc").is_dir() or not all(
            (ROOT / fam["root"] / "models").is_dir() for fam in FAMILIES.values()):
        print(f"chip_smoke: {ROOT} does not hold the repository "
              "(shm_tpu_torch/ and data/4dof*/)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from shm_tpu_torch.device import set_full_f32_precision

    set_full_f32_precision()
    t_start = time.perf_counter()
    try:
        print(gpu_line())
        phase_build()
        from shm_tpu_torch.tools.workload import load_trained_workload

        wl = load_trained_workload(ROOT / "data" / "4dof")
        W, y = wl.W, wl.y                  # the 3,636 committed test windows
        gate_rows = []
        for cell, fam in FAMILIES.items():
            err = phase_kernel_vs_plain(cell)
            scorer, launches = phase_main_path(W, y, cell)
            nums = phase_timing(scorer, W, cell)
            nums["max_abs_err"] = max(nums["max_abs_err"], err)
            gate_rows.append(dict(
                name=fam["kernel"], route="cuda", source=fam["source"],
                replaces=fam["replaces"], launches=launches, **nums))
            del scorer
            torch.cuda.empty_cache()
        errs = phase_lstm_kernels_vs_plain()
        counts, ctx = phase_train_path()
        lstm_rows = phase_lstm_timing(errs, counts, ctx)
        if parent is not None:
            phase_parent(parent, lstm_rows + gate_rows)
        else:
            print("[parent] no --parent DIR given: the parent tree's rows 1-7 "
                  "are not timed in this run")
        torch.cuda.empty_cache()
        probe_rows = phase_probe_path(phase_probes_vs_plain(), wl)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    # the kernel table's order: rows 1-5, the two other families, the probes
    kernels = gate_rows[:1] + lstm_rows + gate_rows[1:] + probe_rows
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
