"""Probe: where the time of the port's LSTM gate kernel goes.

Counterpart of ``tools/probe_vpu_bound.py``. ``gate_variant(weights, Z)`` is
the gate-only 2-layer LSTM-VAE MSE [N] of ``fused_vae_gate`` with the TPU
probe's numerics (windows, weights and product operands in bf16, sums in
float32, LayerNorm eps 1e-6 as that probe has it, not the model's 1e-5) and
its three knobs:

- ``sig_via_tanh``: sigmoid(x) = 0.5 * (tanh(0.5x) + 1);
- ``interleave=2``: each thread advances two independent groups of windows
  in one loop;
- ``act_bf16``: gates, activations and c rounded to bf16 around the
  transcendentals.

Two more knobs take the numerics apart: ``bf16`` ("all" as above,
"weights": only the weights kept in bf16, "none": float32) and ``ln_eps``.
With ``bf16="none"`` and the model's eps a variant is the gate on the
float32 FMA pipes (A); ``tc`` (float32 only) takes the tensor-core body
instead, every LSTM gate product in 3xTF32, with one of its sums
(``TC_SUMS``): ``"split"``, the shipping one (T: with the model's eps it is
``fused_vae_gate`` bit for bit), ``"chain"`` (TC, every mma of a product
chained into one sum) or ``"one_term"`` (T1, a_b b_b alone: a planted
fault).

On a CUDA tensor it launches the variant's instance of
``ops/csrc/fused_vae.cu``: the gate's float32 FMA body with the knobs as
template parameters, or with ``tc`` the tensor-core body (C entry
``shm_fused_vae_probe``), and adds one to ``gate_variant.launches``; on a
CPU tensor it runs :func:`gate_variant_reference`. ``main`` prints one JSON
line per variant on the committed 4DOF test windows tiled to 21,760: A =
the float32 FMA instance at the model's eps, then the port's own variants,
each of which differs from A in one knob (T, TC, T1 their tensor-core
products), then the TPU probe's B-F, with ``rel_err`` against A and
``gate_agree`` at the committed threshold.

    python -m shm_tpu_torch.tools.probe_vpu_bound          # on the card
    python -m shm_tpu_torch.tools.probe_vpu_bound --device cpu --windows 64
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from shm_tpu_torch.ops._build import count_launch, raise_on_error
from shm_tpu_torch.ops._gate import (
    bf16_round, check_weights, check_windows, pointer_array, tf32_round,
)
from shm_tpu_torch.ops.fused_vae import _PRODUCTS, _WEIGHT_ORDER, _library
from shm_tpu_torch.tools.workload import timed

LN_EPS = 1e-6                     # tools/probe_vpu_bound.py:118
MODEL_LN_EPS = 1e-5               # the model's and the shipping kernel's
BF16 = ("none", "weights", "all")  # the C entry's `numerics` 0, 1, 2
# the tensor-core body's sums, the C entry's `numerics` 3, 4, 5 (TcSum in
# csrc/fused_vae.cu); the shipping kernel's is "split"
TC_SUMS = ("chain", "split", "one_term")
SHIP_TC = "split"
N_WINDOWS = 21760                 # the TPU probe's workload: 4 x 5,440
_H, _D_MAX, _Z_MAX = 128, 16, 32
_MATMUL = tuple(k for k in _WEIGHT_ORDER if not k.endswith(("_b", "_frag"))
                and not k.startswith("ln_"))
# the TPU probe's variants (tools/probe_vpu_bound.py:225-232)
VARIANTS = {
    "B_sig_via_tanh": dict(sig_via_tanh=True),
    "C_interleave2": dict(interleave=2),
    "D_probe_baseline": dict(),
    "E_tanh_plus_il2": dict(sig_via_tanh=True, interleave=2),
    "F_tanh_bf16_act": dict(sig_via_tanh=True, act_bf16=True),
}
# A: the gate's float32 FMA instance at the model's eps
A_F32 = dict(bf16="none", ln_eps=MODEL_LN_EPS)
# the port's own: each differs from A in one knob; T is the shipping body
PORT_VARIANTS = {
    "T_tensor_cores": dict(A_F32, tc=SHIP_TC),
    "TC_chained_sum": dict(A_F32, tc="chain"),
    "T1_one_term": dict(A_F32, tc="one_term"),
    "W_bf16_weights": dict(bf16="weights", ln_eps=MODEL_LN_EPS),
    "G_f32_interleave2": dict(A_F32, interleave=2),
}


def gate_variant_reference(weights: Dict[str, torch.Tensor], Z: torch.Tensor,
                           *, sig_via_tanh: bool = False, interleave: int = 1,
                           act_bf16: bool = False, bf16: str = "all",
                           ln_eps: float = LN_EPS,
                           tc: Optional[str] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: mse [N]. ``interleave`` changes
    only the kernel's schedule, not the numbers; ``tc`` "split" and "chain"
    change how the float32 products are summed (3xTF32, about float32's
    accuracy), so their plain version is the float32 one; "one_term"
    multiplies the LSTM gate products' operands rounded to TF32."""
    N, T, D = Z.shape
    H = weights["enc0_whh"].shape[0]
    r = bf16_round
    keep = lambda v: v
    r_w = keep if bf16 == "none" else r           # the stored weights
    r_op = r if bf16 == "all" else keep           # every other product operand
    x = r_op(Z.to(torch.float32))
    W = {k: r_w(weights[k]) for k in _MATMUL}

    def mm(a, k):
        if tc == "one_term" and k in _PRODUCTS:
            return tf32_round(a) @ tf32_round(W[k])
        return r_op(a) @ W[k]

    def sig(v):
        if sig_via_tanh:
            if act_bf16:
                return 0.5 * r(r(torch.tanh(0.5 * v)) + 1.0)
            return 0.5 * (torch.tanh(0.5 * v) + 1.0)
        return r(torch.sigmoid(v)) if act_bf16 else torch.sigmoid(v)

    def tanh_a(v):
        return r(torch.tanh(v)) if act_bf16 else torch.tanh(v)

    def step(c, gates):
        if act_bf16:
            gates = r(gates)
        i, f, g, o = gates.split(H, dim=1)
        c = sig(f) * c + sig(i) * tanh_a(g)
        return sig(o) * tanh_a(r(c) if act_bf16 else c), c

    zeros = x.new_zeros(N, H)
    h1 = c1 = h2 = c2 = zeros
    for t in range(T):
        h1, c1 = step(c1, mm(x[:, t], "enc0_wih") + mm(h1, "enc0_whh")
                      + weights["enc0_b"])
        h2, c2 = step(c2, mm(h1, "enc1_wih") + mm(h2, "enc1_whh")
                      + weights["enc1_b"])
    m = h2.mean(dim=1, keepdim=True)
    var = ((h2 - m) ** 2).mean(dim=1, keepdim=True)
    hl = ((h2 - m) * torch.rsqrt(var + ln_eps) * weights["ln_scale"]
          + weights["ln_bias"])
    mu = mm(hl, "mu_w") + weights["mu_b"]
    dec_in = torch.tanh(mm(mu, "z2h_w") + weights["z2h_b"])
    xpc = mm(dec_in, "dec0_wih") + weights["dec0_b"]
    h1 = c1 = h2 = c2 = zeros
    acc = x.new_zeros(N)
    for t in range(T):
        h1, c1 = step(c1, xpc + mm(h1, "dec0_whh"))
        h2, c2 = step(c2, mm(h1, "dec1_wih") + mm(h2, "dec1_whh")
                      + weights["dec1_b"])
        y = mm(h2, "out_w") + weights["out_b"]
        acc = acc + ((x[:, t] - y) ** 2).sum(dim=1)
    return acc / (T * D)


def _check_knobs(interleave, bf16, sig_via_tanh, act_bf16, ln_eps, tc):
    if tc is not None and tc not in TC_SUMS:
        raise ValueError(f"tc must be None or one of {TC_SUMS}, got {tc!r}")
    if tc is not None and (bf16 != "none" or interleave != 1):
        raise ValueError("tc takes bf16='none' and interleave=1 (the shipping "
                         "body as it ships)")
    if interleave not in (1, 2):
        raise ValueError(f"interleave must be 1 or 2, got {interleave}")
    if bf16 not in BF16:
        raise ValueError(f"bf16 must be one of {BF16}, got {bf16!r}")
    if bf16 != "all" and (sig_via_tanh or act_bf16):
        raise ValueError("sig_via_tanh and act_bf16 take bf16='all' (the TPU "
                         "probe's numerics)")
    if not ln_eps > 0:
        raise ValueError(f"ln_eps must be > 0, got {ln_eps}")


def _check(weights, Z, interleave):
    """The kernel's shapes: the 2-layer preset with LayerNorm at H=128."""
    check_windows(Z)
    if interleave not in (1, 2):
        raise ValueError(f"interleave must be 1 or 2, got {interleave}")
    if "enc1_wih" not in weights or "ln_scale" not in weights:
        raise ValueError("gate_variant takes the 2-layer preset with LayerNorm")
    H = weights["enc0_whh"].shape[0]
    Zd = weights["mu_w"].shape[1]
    N, T, D = Z.shape
    if H != _H or D > _D_MAX or Zd > _Z_MAX or T < 2:
        raise ValueError(f"unsupported shape for the probe kernel: H={H} "
                         f"(need {_H}), D={D} (<= {_D_MAX}), Z={Zd} "
                         f"(<= {_Z_MAX}), T={T} (>= 2)")
    if weights["enc0_wih"].shape != (D, 4 * H):
        raise ValueError(f"enc0_wih {tuple(weights['enc0_wih'].shape)} does "
                         f"not match D={D}, H={H}")
    check_weights(weights, _WEIGHT_ORDER, Z.device)
    return H, Zd


def _launch(weights, Z, sig_via_tanh, interleave, act_bf16, bf16, ln_eps, tc):
    H, Zd = _check(weights, Z, interleave)
    N, T, D = Z.shape
    mse = torch.empty(N, device=Z.device, dtype=torch.float32)
    if N == 0:
        return mse
    lib = _library()
    # the weights the kernel streams, kept in bf16 unless bf16="none"
    w = {k: (v.to(torch.bfloat16) if k in _MATMUL and bf16 != "none" else v)
         for k, v in weights.items()}
    ptrs = pointer_array(w, _WEIGHT_ORDER, _WEIGHT_ORDER)
    with torch.cuda.device(Z.device):
        stream = torch.cuda.current_stream(Z.device).cuda_stream
        err = lib.shm_fused_vae_probe(
            Z.data_ptr(), mse.data_ptr(), ptrs, len(_WEIGHT_ORDER), N, T, D,
            H, Zd, 3 + TC_SUMS.index(tc) if tc else BF16.index(bf16),
            int(sig_via_tanh), interleave, int(act_bf16), ln_eps, stream)
    raise_on_error(lib, err, "fused_vae probe")
    count_launch(gate_variant)
    return mse


def gate_variant(weights: Dict[str, torch.Tensor], Z: torch.Tensor, *,
                 sig_via_tanh: bool = False, interleave: int = 1,
                 act_bf16: bool = False, bf16: str = "all",
                 ln_eps: float = LN_EPS,
                 tc: Optional[str] = None) -> torch.Tensor:
    """Gate-only MSE [N] of one probe variant; ``weights`` from
    ``vae_params_to_kernel_weights``."""
    kw = dict(sig_via_tanh=sig_via_tanh, interleave=interleave,
              act_bf16=act_bf16, bf16=bf16, ln_eps=ln_eps, tc=tc)
    _check_knobs(interleave, bf16, sig_via_tanh, act_bf16, ln_eps, tc)
    if Z.device.type == "cuda":
        return _launch(weights, Z, **kw)
    if Z.device.type == "cpu":
        return gate_variant_reference(weights, Z, **kw)
    raise ValueError(f"gate_variant: unsupported device {Z.device}")


# kernel launches so far; callers reset it to 0 to count one run's launches
gate_variant.launches = 0


def tiled_windows(wl, n: int = N_WINDOWS) -> np.ndarray:
    """The workload's normalized test windows tiled to ``n``, as the TPU
    probe builds its 4x workload."""
    W = np.resize(wl.W, (n,) + wl.W.shape[1:])
    return ((W - wl.mean) / wl.std).astype(np.float32)


def probe_table(weights, Z, thr: float, reps: int = 5):
    """One row per variant: A (the gate's float32 FMA instance), the port's
    own variants (T, TC, T1: the tensor-core body), then the TPU probe's;
    ``ms`` None off the card."""
    on_card = Z.device.type == "cuda"
    n = Z.shape[0]
    base = lambda: gate_variant(weights, Z, **A_F32)
    ref = base()
    rows = [{"variant": "A_f32_fma",
             "ms": timed(base, reps) if on_card else None}]
    for name, kw in {**PORT_VARIANTS, **VARIANTS}.items():
        out = gate_variant(weights, Z, **kw)
        err = float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-9))
        agree = float(((out > thr) == (ref > thr)).double().mean())
        rows.append({"variant": name,
                     "ms": timed(lambda: gate_variant(weights, Z, **kw), reps)
                     if on_card else None,
                     "rel_err": err, "gate_agree": agree})
    for row in rows:
        row["win_per_sec"] = n / (row["ms"] / 1e3) if row["ms"] else None
    return rows


def main(argv=None) -> None:
    from shm_tpu_torch.device import resolve_device, set_full_f32_precision
    from shm_tpu_torch.ops import vae_params_to_kernel_weights
    from shm_tpu_torch.tools.workload import load_trained_workload

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; cpu runs the plain versions")
    ap.add_argument("--windows", type=int, default=N_WINDOWS)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_full_f32_precision()
    wl = load_trained_workload()
    weights = vae_params_to_kernel_weights(wl.vae.to(device))
    Z = torch.from_numpy(tiled_windows(wl, args.windows)).to(device)
    for row in probe_table(weights, Z, wl.threshold, args.reps):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
