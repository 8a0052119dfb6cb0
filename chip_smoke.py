#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero before the final line):

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (nvcc, ``sm_90a``, from ``shm_tpu_torch/ops/csrc``);
2. each kernel against its plain PyTorch version on the card, random weights
   from a numpy seed, at four shapes;
3. the main path: ``HybridScorer.from_artifacts("data/4dof")`` on cuda scoring
   the 3,636 committed 4DOF test windows, held against
   ``data/4dof/figures/pipeline_metrics.json`` and against the port's plain
   path on the same card; the kernel's launch count must be > 0;
4. timings at bench.py's 5,440-window workload: kernel, plain version, the
   operation/byte bound, a cuDNN ``nn.LSTM`` yardstick, and ``score()``
   windows/s end to end;
5. where one ``score()`` call's time goes (``torch.profiler``): device time
   by kernel and the device's idle share.

Prints one JSON line of per-kernel numbers, then, as its last line,
``{"ok": true, "device": {...}}``. Exits non-zero without a card, and when
run from a directory that does not hold the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# card peaks for the bound (H100 SXM data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12          # float32 without tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 tensor cores, dense
PEAK_BYTES = 3.35e12            # HBM3

# kernel vs plain, both float32 on the card: the two sum in different orders
# and round differently inside expf/tanhf, and the 2*L*T-step recurrence
# carries those last-bit differences forward; |kernel - plain| must stay
# within ATOL + RTOL * |plain| elementwise
ATOL, RTOL = 1e-4, 1e-4
N_BENCH = 5440                  # bench.py's workload
REPS = 7


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
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


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


def phase_build():
    from shm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    res = _build.build(["fused_vae"])
    wall = time.perf_counter() - t0
    for name, (path, secs, log) in res.items():
        print(f"[build] {name}: {path.relative_to(ROOT)} in {secs:.2f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] total {wall:.2f} s")


def random_vae(seed: int, D, Z, H, L, ln):
    from shm_tpu_torch.config import VAEConfig
    from shm_tpu_torch.convert import random_flax_vae_params, vae_from_flax

    cfg = VAEConfig(input_dim=D, latent_dim=Z, hidden_dim=H, num_layers=L,
                    use_layernorm=ln)
    rng = np.random.default_rng(seed)
    return vae_from_flax(random_flax_vae_params(rng, cfg), cfg).cuda(), rng


def compare(name: str, got, ref) -> float:
    """Max |got - ref|; fails past ATOL + RTOL * |ref|."""
    err = (got - ref).abs()
    worst = float((err - RTOL * ref.abs()).max())
    max_abs = float(err.max())
    ok = worst <= ATOL
    print(f"[kernel]   {name}: max |diff| {max_abs:.3e} "
          f"(tolerance {ATOL:g} + {RTOL:g}*|plain|) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: kernel disagrees with its plain version "
              f"(max |diff| {max_abs:.3e})")
    return max_abs


def phase_kernel_vs_plain():
    import torch

    from shm_tpu_torch.ops import (
        fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
    )

    cases = [  # name, N, T, D, Z, H, L, LN, with_residual
        ("4dof N=1000 (ragged tile)", 1000, 100, 12, 16, 128, 2, True, True),
        ("openLAB 1-layer H=64 T=200 D=3", 300, 200, 3, 8, 64, 1, True, True),
        ("1dof 2-layer H=32 T=80 no LN", 300, 80, 12, 5, 32, 2, False, True),
        ("4dof with_residual=False", 333, 100, 12, 16, 128, 2, True, False),
    ]
    for i, (name, N, T, D, Zd, H, L, ln, wr) in enumerate(cases):
        vae, rng = random_vae(100 + i, D, Zd, H, L, ln)
        w = vae_params_to_kernel_weights(vae)
        Z = torch.from_numpy(rng.normal(size=(N, T, D)).astype(np.float32)).cuda()
        kw = dict(num_layers=L, use_layernorm=ln, with_residual=wr)
        mse, resid = fused_vae_gate(w, Z, **kw)
        torch.cuda.synchronize()
        mse_p, resid_p = fused_vae_gate_reference(w, Z, **kw)
        print(f"[kernel] {name}: N={N} T={T} D={D} H={H} Z={Zd} L={L} "
              f"LN={ln} with_residual={wr}")
        check(mse.shape == (N,) and bool(torch.isfinite(mse).all()),
              f"{name}: mse not finite / wrong shape")
        compare("mse", mse, mse_p)
        if wr:
            check(resid.shape == (N, T, D), f"{name}: resid shape {resid.shape}")
            compare("resid", resid, resid_p)
        else:
            check(resid is None, f"{name}: resid returned with_residual=False")


def test_windows():
    from shm_tpu_torch.cli.stage4dof import Paths, build_fraction_windows
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.utils.io import load_json

    cfg = Stage4DofConfig()
    splits = load_json(Paths(str(ROOT / "data" / "4dof")).run_splits)
    groups = [build_fraction_windows(splits[g]["files"], cfg.test_frac, cfg)
              for g in ("normal", "sensor_fault", "structural_fault")]
    y = np.concatenate([np.full(len(g), i) for i, g in enumerate(groups)])
    return np.concatenate(groups), y


def phase_main_path(W, y):
    import torch

    from shm_tpu_torch.evals import accuracy, confusion_matrix
    from shm_tpu_torch.ops import fused_vae_gate
    from shm_tpu_torch.serve import HybridScorer
    from shm_tpu_torch.utils.io import load_json

    ref = load_json(ROOT / "data" / "4dof" / "figures" / "pipeline_metrics.json")
    scorer = HybridScorer.from_artifacts(ROOT / "data" / "4dof")
    check(scorer.device.type == "cuda" and scorer.use_fused_vae,
          "scorer did not select the card and the fused kernel")

    fused_vae_gate.launches = 0
    t0 = time.perf_counter()
    out = scorer.score(W)
    wall = time.perf_counter() - t0
    launches = fused_vae_gate.launches
    print(f"[main] score() of {len(W)} windows in {wall * 1e3:.1f} ms "
          f"(first call, includes the kernel's first load); fused_vae_gate "
          f"launches: {launches}")
    check(launches > 0, "the main path did not launch the fused kernel")
    check(all(np.isfinite(out[k]).all() for k in ("mse", "p_struct"))
          and out["mse"].shape == (len(W),), "non-finite or mis-shaped output")

    tags = {0: "normal/test", 1: "sensor/test", 2: "struct/test"}
    for g, tag in tags.items():
        m = y == g
        anom = int(out["anomalous"][m].sum())
        want = int(ref["gate"]["gate_stats"][tag]["anom"])
        print(f"[main] gate {tag}: {anom}/{int(m.sum())} anomalous "
              f"(rate {anom / m.sum():.4f}; reference {want})")
        check(anom == want, f"gate decisions differ on {tag}")

    cm = confusion_matrix(y, out["y_pred"], 3)
    cm_ref = np.asarray(ref["confusion_matrix_counts"])
    acc = accuracy(y, out["y_pred"])
    moved = int(np.abs(cm - cm_ref).sum()) // 2
    print(f"[main] confusion matrix {cm.tolist()} (reference "
          f"{cm_ref.tolist()}); windows moved: {moved}")
    print(f"[main] accuracy {acc:.6f} (reference {ref['accuracy']:.6f})")
    if moved:
        # the windows in the cells that gained are the flips; show those
        # nearest the CNN's decision boundary with their logit margins
        logits = scorer._dispatch(torch.from_numpy(W)).logits.cpu().numpy()
        margin = np.abs(logits[:, 1] - logits[:, 0])
        for t, p in zip(*np.nonzero(cm > cm_ref)):
            idx = np.nonzero((y == t) & (out["y_pred"] == p))[0]
            idx = idx[np.argsort(margin[idx])][: cm[t, p] - cm_ref[t, p]]
            for i in idx:
                print(f"[main]   flip: window {i} true {t} -> pred {p}, "
                      f"logit margin {margin[i]:.5f}")
    check(moved <= 2, f"confusion matrix off by {moved} windows (> 2)")

    plain = HybridScorer.from_artifacts(ROOT / "data" / "4dof",
                                        use_fused_vae=False)
    outp = plain.score(W)
    gate_diff = int((outp["anomalous"] != out["anomalous"]).sum())
    y_diff = int((outp["y_pred"] != out["y_pred"]).sum())
    mse_rel = float(np.max(np.abs(outp["mse"] - out["mse"])
                           / np.abs(outp["mse"])))
    print(f"[main] kernel path vs plain path on the card: gate decisions "
          f"differing {gate_diff}, y_pred differing {y_diff}, max mse rel "
          f"diff {mse_rel:.3e}")
    # the gate's margins are wide, so its decisions must agree exactly; a
    # CNN decision within float32 rounding of its boundary may flip
    check(gate_diff == 0 and y_diff <= 2,
          "kernel path and plain path disagree on the card")
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
                getattr(m, f"bias_ih_l{l}").copy_(layer.bias)
                getattr(m, f"bias_hh_l{l}").zero_()
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


def phase_timing(scorer, W):
    import torch

    from shm_tpu_torch.data.windows import normalize_windows
    from shm_tpu_torch.ops import (
        fused_vae_gate, fused_vae_gate_reference, vae_params_to_kernel_weights,
    )
    from shm_tpu_torch.serve import bucket_size

    Wb = np.resize(W, (N_BENCH,) + W.shape[1:]).astype(np.float32)
    vae = scorer.vae
    N, T, D = Wb.shape
    Z = normalize_windows(torch.from_numpy(Wb).cuda(), scorer.mean,
                          scorer.std).contiguous()
    w = vae_params_to_kernel_weights(vae)
    kw = dict(num_layers=vae.num_layers, use_layernorm=vae.use_layernorm)

    mse_k, resid_k = fused_vae_gate(w, Z, **kw)
    mse_p, resid_p = fused_vae_gate_reference(w, Z, **kw)
    torch.cuda.synchronize()
    print(f"[time] kernel vs plain at N={N} (trained weights, real windows):")
    err = max(compare("mse", mse_k, mse_p), compare("resid", resid_k, resid_p))
    cudnn = cudnn_vae_pass(vae)
    mse_c, _ = cudnn(Z)
    print(f"[time] cuDNN yardstick vs kernel: max |mse diff| "
          f"{float((mse_c - mse_k).abs().max()):.3e}")

    ms = time_ms(lambda: fused_vae_gate(w, Z, **kw))
    plain_ms = time_ms(lambda: fused_vae_gate_reference(w, Z, **kw), reps=5)
    cudnn_ms = time_ms(lambda: cudnn(Z))
    flops, nbytes = vae_work(N, T, D, vae.hidden_dim, vae.latent_dim,
                             vae.num_layers)
    t_f32 = flops / PEAK_F32_FLOPS * 1e3
    t_bf16 = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_f32, t_bytes)
    print(f"[time] fused_vae_gate N={N}: kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | cuDNN nn.LSTM yardstick {cudnn_ms:.4f} ms")
    print(f"[time] work {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB -> "
          f"bound {bound_ms:.4f} ms ({'operations' if t_f32 >= t_bytes else 'bytes'}"
          f"; f32 {t_f32:.4f} ms, bf16 tensor-core {t_bf16:.4f} ms, bytes "
          f"{t_bytes:.4f} ms); kernel at {t_f32 / ms * 100:.1f}% of the f32 "
          f"bound")

    scorer.score(Wb)                                   # warm the bucket
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        scorer.score(Wb)
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    bucket = bucket_size(N, scorer.min_bucket, scorer.max_batch)
    print(f"[time] score() end to end, {N} windows: median {wall * 1e3:.2f} ms "
          f"over 5 -> {N / wall:.1f} windows/s (one dispatch padded to "
          f"{bucket} windows)")
    phase_profile(scorer, Wb)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_f32 >= t_bytes else "bytes",
            "library_ms": cudnn_ms}


def phase_profile(scorer, Wb, calls: int = 3):
    """Where one ``score()`` call's time goes: device time by kernel from
    ``torch.profiler`` over ``calls`` calls, against their host wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            scorer.score(Wb)
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    # device-side events only (kernels, copies): the CPU operators that
    # launched them report the same device time again
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / calls)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    busy = sum(ms for _, ms in rows)
    if not rows:
        print("[profile] the profiler recorded no device time: not measured")
        return
    print(f"[profile] score() of {len(Wb)} windows under the profiler: "
          f"wall {wall_ms:.2f} ms/call, device busy {busy:.2f} ms/call, "
          f"device idle share {1 - busy / wall_ms:.3f}")
    for name, ms in rows[:10]:
        print(f"[profile]   {ms:9.3f} ms  {ms / busy * 100:5.1f}%  {name[:90]}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "shm_tpu_torch" / "ops" / "csrc").is_dir() \
            or not (ROOT / "data" / "4dof" / "models").is_dir():
        print(f"chip_smoke: {ROOT} does not hold the repository "
              "(shm_tpu_torch/ and data/4dof/)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from shm_tpu_torch.device import set_full_f32_precision

    set_full_f32_precision()
    t_start = time.perf_counter()
    try:
        print(gpu_line())
        phase_build()
        phase_kernel_vs_plain()
        W, y = test_windows()
        scorer, launches = phase_main_path(W, y)
        nums = phase_timing(scorer, W)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [dict(
        name="fused_vae_gate", route="cuda",
        source="shm_tpu_torch/ops/csrc/fused_vae.cu",
        replaces="shm_tpu/ops/fused_vae.py:125", launches=launches, **nums)]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
