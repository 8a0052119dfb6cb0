"""Readings of the LSTM training ops in bf16 that the tests and
``chip_smoke.py`` phase 18 rest on.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/lstm_train_bf16_readings.py ops
    PYTHONPATH=. python tests/lstm_train_bf16_readings.py train

``ops``: the JAX package's ``lstm2_enc_last`` / ``lstm2_dec_head`` at
``dtype=bf16`` (interpret mode, ``batch_tile`` the case's batch) against the
port's plain bf16 versions (``dtype=torch.bfloat16`` on CPU tensors), same
numpy-made inputs: both forwards and every gradient of a loss ``sum(out *
R)``. Cases: the shape of ``tests/test_torch_lstm_train_bf16.py`` and the
small shapes of phase 6 / 18 (the 1-DOF shape, H=64). One ``OPS`` line per
output: (max |diff| / max |ref|, mean |diff| / mean |ref|), the share of
elements more than one bf16 ulp off, and the same three of the float32
gap (the port's plain float32 version against its plain bf16 one). Two sum
orders of the same bf16 computation differ where a float32 difference flips
a bf16 rounding: that moves a few elements far, and the recurrence carries
it on; a missing or extra rounding moves every element.

``train``: ``train_vae`` on the committed 4DOF normal runs at the 4DOF
recipe with the hidden width cut to 32 (a full-width run is for the card),
8 epochs, on the CPU through the ops' plain versions (``use_kernel=True``),
seed 42 at float32 and at bf16, and seed 43 at float32. One ``TRAIN`` line
per epoch: the validation totals and the relative differences of bf16 from
float32 and of seed 43 from seed 42.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
# name, T, D, H, B, dropout: the test's shape, then phase 6's small ones
CASES = (("test shape", 12, 6, 8, 32, 0.3),
         ("1dof shape", 80, 12, 32, 64, 0.2),
         ("H=64", 40, 12, 64, 45, 0.3))
ENC_NAMES = ("xs", "w0i", "w0h", "b0", "w1i", "w1h", "b1")
DEC_NAMES = ("dec_in", "w0i", "w0h", "b0", "w1i", "w1h", "b1", "out_w", "out_b")


def rel(got: np.ndarray, ref: np.ndarray):
    """(max |got - ref| / max |ref|, mean |got - ref| / mean |ref|, share of
    elements more than one bf16 ulp (2^(e - 8) for |ref| in [2^(e-1), 2^e))
    off)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d, r = np.abs(got - ref), np.abs(ref)
    ulp = np.ldexp(1.0, np.frexp(ref)[1] - 8)
    return float(d.max() / r.max()), float(d.mean() / r.mean()), float((d > ulp).mean())


def case_inputs(seed: int, T, D, H, B, drop):
    """numpy inputs of one case: xs, dm, the encoder's and decoder's weights
    (the decoder's input width is H), dec_in, the two loss weights."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    u = lambda *s: f(rng.uniform(-1, 1, size=s) / np.sqrt(H))
    stack = lambda k: [u(4 * H, k), u(4 * H, H), u(4 * H, 1), u(4 * H, H),
                       u(4 * H, H), u(4 * H, 1)]
    dm = f((rng.random((T, H, B)) > drop) / (1.0 - drop))
    return dict(xs=f(rng.normal(size=(T, D, B))), dm=dm, enc_w=stack(D),
                din=f(np.tanh(rng.normal(size=(H, B)))),
                dec_w=stack(H) + [u(D, H), u(D, 1)],
                R_enc=f(rng.normal(size=(H, B))), R_dec=f(rng.normal(size=(T, D, B))))


def jax_outputs(c, T: int, B: int):
    """The JAX ops at dtype=bf16: ((h_last, enc grads), (recon, dec grads))."""
    import jax
    import jax.numpy as jnp

    from shm_tpu.ops.lstm_train import lstm2_dec_head, lstm2_enc_last

    dm = jnp.asarray(c["dm"])
    enc = lambda a: lstm2_enc_last(a[0], dm, *a[1:], B, jnp.bfloat16, True)
    dec = lambda a: lstm2_dec_head(a[0], dm, *a[1:], T, B, jnp.bfloat16, True)
    out = []
    for fn, args, R in ((enc, [c["xs"]] + c["enc_w"], c["R_enc"]),
                        (dec, [c["din"]] + c["dec_w"], c["R_dec"])):
        a = [jnp.asarray(x) for x in args]
        y = fn(a)
        g = jax.grad(lambda a: jnp.sum(fn(a) * R))(a)
        out.append((np.asarray(y), [np.asarray(x) for x in g]))
    return out


def port_outputs(c, T: int, dtype):
    """The port's ops on CPU tensors at ``dtype``, as :func:`jax_outputs`."""
    from shm_tpu_torch.ops import lstm2_dec_head, lstm2_enc_last

    dm = torch.from_numpy(c["dm"])
    out = []
    for fn, args, R in ((lambda a: lstm2_enc_last(a[0], dm, *a[1:], dtype=dtype),
                         [c["xs"]] + c["enc_w"], c["R_enc"]),
                        (lambda a: lstm2_dec_head(a[0], dm, *a[1:], T=T, dtype=dtype),
                         [c["din"]] + c["dec_w"], c["R_dec"])):
        a = [torch.from_numpy(x.copy()).requires_grad_(True) for x in args]
        y = fn(a)
        g = torch.autograd.grad((y * torch.from_numpy(R)).sum(), a)
        out.append((y.detach().numpy(), [x.numpy() for x in g]))
    return out


def ops_readings() -> None:
    torch.set_num_threads(1)
    for i, (name, T, D, H, B, drop) in enumerate(CASES):
        c = case_inputs(i, T, D, H, B, drop)
        t0 = time.perf_counter()
        jx = jax_outputs(c, T, B)
        bf = port_outputs(c, T, torch.bfloat16)
        f32 = port_outputs(c, T, torch.float32)
        for s, (stack, names) in enumerate((("encoder", ("h_last",) + ENC_NAMES),
                                            ("decoder", ("recon",) + DEC_NAMES))):
            outs = [(jx[s][0], bf[s][0], f32[s][0])] + list(zip(jx[s][1], bf[s][1], f32[s][1]))
            for n, (j, b, f) in zip(names, outs):
                a, g = rel(b, j), rel(f, b)
                print(f"OPS {name} T={T} D={D} H={H} B={B} {stack} {n}: JAX "
                      f"{a[0]:.3e} {a[1]:.3e} {a[2]:.4f} | float32 gap "
                      f"{g[0]:.3e} {g[1]:.3e} {g[2]:.4f}", flush=True)
        print(f"OPS {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def train_readings() -> None:
    from shm_tpu_torch.cli.stage4dof import build_fraction_windows_multi
    from shm_tpu_torch.config import Stage4DofConfig, replace
    from shm_tpu_torch.data.windows import (
        compute_mean_std_from_windows, normalize_windows,
    )
    from shm_tpu_torch.models.vae import vae_from_config
    from shm_tpu_torch.train import train_vae
    from shm_tpu_torch.utils.io import load_json

    torch.set_num_threads(4)
    cfg = Stage4DofConfig()
    files = load_json(ROOT / "data" / "4dof" / "processed" / "run_splits.json")[
        "normal"]["files"]
    files = [str(ROOT / f) if not Path(f).is_absolute() else f for f in files]
    Wtr, Wva = build_fraction_windows_multi(files, (cfg.train_frac, cfg.val_frac), cfg)
    mean, std = compute_mean_std_from_windows(torch.from_numpy(Wtr))
    Ztr, Zva = (normalize_windows(torch.from_numpy(W), mean, std) for W in (Wtr, Wva))
    vcfg = replace(cfg.vae, hidden_dim=32)
    runs = {}
    for tag, seed, dtype in (("f32", 42, torch.float32), ("bf16", 42, torch.bfloat16),
                             ("f32 seed 43", 43, torch.float32)):
        t0 = time.perf_counter()
        res = train_vae(vae_from_config(vcfg), Ztr, Zva,
                        replace(cfg.vae_train, epochs=8, seed=seed),
                        use_kernel=True, kernel_dtype=dtype, device="cpu")
        runs[tag] = np.asarray(res.history["val_total"])
        print(f"TRAIN {tag}: {time.perf_counter() - t0:.1f} s, val_total "
              f"{runs[tag].tolist()}", flush=True)
    for e in range(8):
        f, b, s = runs["f32"][e], runs["bf16"][e], runs["f32 seed 43"][e]
        print(f"TRAIN epoch {e + 1}: val_total f32 {f:.6f} bf16 {b:.6f} "
              f"(rel {abs(b - f) / f:.3e}); seed 43 f32 {s:.6f} (rel "
              f"{abs(s - f) / f:.3e})")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "ops"
    {"ops": ops_readings, "train": train_readings}[mode]()
