"""Readings of the plain modules' bf16 (``dtype=torch.bfloat16``) that the
bars of ``tests/test_torch_plain_dtype.py`` and ``chip_smoke.py`` phase 21
rest on.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/plain_dtype_readings.py jax
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/plain_dtype_readings.py port

``jax``: the JAX package's flax ``TemporalVAE`` of each committed 4DOF root
(``data/4dof``, ``data/4dof_mingru``, ``data/4dof_attention``) at
``dtype=bf16`` against the same model at float32, on the 3,636 committed
test windows (the posterior-mean reconstruction's mse, as
``reconstruction_mse(fused=False)`` scores it), and ``CNNOpenLab`` of
``data/openlab`` on the openLAB test split's fault windows (p(ST) and the
label at the committed CNN threshold). One ``JAX`` line each: the largest
and mean relative mse difference (for the CNN the largest |p(ST)|
difference) of bf16 from float32, and the gate decisions (labels) that
differ. ``chip_smoke.py``'s ``PLAIN_BF16_TOL`` is twice these.

``port``: on the test's windows (:func:`vae_windows`, :func:`cnn_windows`),
the port's bf16 modules against JAX's bf16 ones, beside JAX's float32 ones
against JAX's bf16: one ``PORT`` line a family, the outputs (recon,
logits) element by element and the mse. The test's bars are twice the
port's distances, and the port must sit nearer JAX bf16 than JAX float32
does.

The JAX modules run under ``jax.jit`` with XLA's excess precision off for
that computation (``compiler_options={"xla_allow_excess_precision":
False}``, :func:`jit_rounding`), so that each bf16 operation rounds where
the module writes it, as the port's do. By default XLA on the CPU fuses
chains of elementwise operations and keeps float32 between them, which
the port models none of: the port's bf16 then sits about as far from
JAX's bf16 as JAX's float32 does (attention 1.67e-3 against 1.43e-3 mean
|recon| difference on 32 windows). Applied op by op outside ``jit``, the
LSTM, minGRU and CNN give these readings' bits too.
"""

from __future__ import annotations

import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
ROOTS = {"lstm": "data/4dof", "min_gru": "data/4dof_mingru",
         "attention": "data/4dof_attention"}
OPENLAB = ROOT / "data" / "openlab"
TEST_WINDOWS = 16           # 4DOF windows a test case runs through JAX
CNN_TEST_WINDOWS = 8        # openLAB windows (JAX's bf16 convolutions run
                            # op by op take ~0.6 s a window on the CPU)


def _rel(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def all_vae_windows() -> np.ndarray:
    """The 3,636 committed raw 4DOF test windows (all three roots score
    these)."""
    from shm_tpu_torch.tools.workload import load_trained_workload

    return load_trained_workload(ROOT / ROOTS["lstm"]).W


def vae_windows(cell: str, W: np.ndarray | None = None, n: int = TEST_WINDOWS):
    """(normalized windows [n, 100, 12] float32, the root's gate threshold):
    every ``len(W) // n``-th committed test window (normal and both fault
    kinds) through the ``cell`` root's statistics."""
    from shm_tpu_torch.cli.stage4dof import Paths, _load_stats
    from shm_tpu_torch.utils.io import load_json

    W = all_vae_windows() if W is None else W
    root = ROOT / ROOTS[cell]
    mean, std = _load_stats(Paths(str(root)))
    Wn = W[::max(1, len(W) // n)][:n] if n < len(W) else W
    Z = ((Wn - mean) / std).astype(np.float32)
    thr = float(load_json(root / "processed" / "vae_threshold.json")["threshold"])
    return Z, thr


def port_vae(cell: str, dtype=torch.float32):
    """The ``cell`` root's trained VAE in the port at ``dtype``, on the CPU."""
    from shm_tpu_torch.cli.stage4dof import Paths, _load_vae
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.models.vae import vae_from_config

    cfg = Stage4DofConfig()
    f32 = _load_vae(Paths(str(ROOT / ROOTS[cell])), cfg)
    vae = vae_from_config(replace(cfg.vae, cell=cell), dtype).eval()
    vae.load_state_dict(f32.state_dict())
    return vae


def jax_vae(cell: str):
    """(the JAX ``TemporalVAE`` of the ``cell`` root at float32, its params:
    the checkpoint's arrays, read without a flax template)."""
    from shm_tpu.config import Stage4DofConfig
    from shm_tpu.models.vae import vae_from_config
    from shm_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = replace(Stage4DofConfig().vae, cell=cell)
    params = load_checkpoint(ROOT / ROOTS[cell] / "models" / "temporal_vae.msgpack")
    return vae_from_config(cfg), params["params"]


def jit_rounding(fn, *args):
    """``fn(*args)`` through ``jax.jit`` with XLA's excess precision off for
    this one computation (module docstring)."""
    import jax

    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def jax_recon(vae, params, Z: np.ndarray, dtype) -> np.ndarray:
    """The JAX model's posterior-mean reconstruction (z = mu) at ``dtype``,
    returned float32 as the model returns it (:func:`jit_rounding`)."""
    import jax.numpy as jnp

    model = vae.clone(dtype=dtype)
    fn = lambda p, x: model.apply({"params": p}, x)[0]
    return np.concatenate([np.asarray(jit_rounding(fn, params, jnp.asarray(
        Z[i:i + 512]))) for i in range(0, len(Z), 512)])


def port_recon(vae, Z: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return torch.cat([vae(torch.from_numpy(Z[i:i + 512]))[0]
                          for i in range(0, len(Z), 512)]).numpy()


def mse(Z: np.ndarray, recon: np.ndarray) -> np.ndarray:
    """``reconstruction_mse(fused=False)``'s score: float32 ((x - recon)**2)
    averaged over (T, D), as float64."""
    return ((Z - recon) ** 2).mean(axis=(1, 2)).astype(np.float64)


def cnn_windows(n: int | None = CNN_TEST_WINDOWS):
    """(standardized openLAB test fault windows [n, 200, 4, 1] float32 (all
    of them for None), the committed CNN threshold)."""
    from shm_tpu_torch.cli.openlab import (
        Paths, _load_extracted, _sf_st_split_data, standardize_clip,
    )
    from shm_tpu_torch.config import OpenLabConfig
    from shm_tpu_torch.utils.io import load_json

    paths, cfg = Paths(str(OPENLAB)), OpenLabConfig()
    _, Xr, meta = _load_extracted(paths)
    X, _ = _sf_st_split_data(Xr, meta, load_json(
        paths.extracted / "run_split.json"), "test")
    if n is not None:
        X = X[::max(1, len(X) // n)][:n]
    mu, sd = np.load(paths.cnn_dir / "artifacts" / "cnn_raw_mu_sd.npy")
    thr = float(np.load(paths.cnn_val_dir / "artifacts" /
                        "cnn_best_threshold.npy").ravel()[0])
    return standardize_clip(X, mu, sd, cfg.standardize_clip)[..., None], thr


def port_cnn(dtype=torch.float32):
    from shm_tpu_torch.convert import cnn_openlab_from_flax
    from shm_tpu_torch.utils.checkpoint import load_checkpoint

    cnn = cnn_openlab_from_flax(load_checkpoint(
        OPENLAB / "output/CNN_Training/artifacts/cnn_model_openlab.msgpack"))
    out = type(cnn)(cnn.num_classes, cnn.dropout, dtype=dtype).eval()
    out.load_state_dict(cnn.state_dict())
    return out


def jax_cnn_logits(X: np.ndarray, dtype) -> np.ndarray:
    """Logits (float32) of the JAX ``CNNOpenLab`` of ``data/openlab`` at
    ``dtype`` (:func:`jit_rounding`)."""
    import jax.numpy as jnp

    from shm_tpu.models import CNNOpenLab
    from shm_tpu_torch.utils.checkpoint import load_checkpoint

    v = {"params": load_checkpoint(
        OPENLAB / "output/CNN_Training/artifacts/cnn_model_openlab.msgpack")["params"]}
    model = CNNOpenLab(dtype=dtype)
    fn = lambda x: model.apply(v, x, train=False)
    return np.concatenate([np.asarray(jit_rounding(fn, jnp.asarray(
        X[i:i + 256]))) for i in range(0, len(X), 256)])


def p_st(logits: np.ndarray) -> np.ndarray:
    """p(ST) of float32 logits, as float64."""
    return torch.softmax(torch.from_numpy(logits), dim=1)[:, 1].double().numpy()


def port_cnn_logits(cnn, X: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return cnn(torch.from_numpy(X)).numpy()


def jax_readings() -> None:
    import jax.numpy as jnp

    W = all_vae_windows()
    for cell in ROOTS:
        t0 = time.perf_counter()
        Z, thr = vae_windows(cell, W, len(W))
        vae, params = jax_vae(cell)
        b = mse(Z, jax_recon(vae, params, Z, jnp.bfloat16))
        f = mse(Z, jax_recon(vae, params, Z, jnp.float32))
        r = _rel(b, f)
        flips = np.flatnonzero((b > thr) != (f > thr))
        print(f"JAX {cell}: {len(Z)} windows, bf16 against float32 mse: max "
              f"rel {r.max():.4e} mean rel {r.mean():.4e}; gate flips "
              f"{len(flips)} {flips.tolist()}; {time.perf_counter() - t0:.0f} s",
              flush=True)
    t0 = time.perf_counter()
    X, thr = cnn_windows(None)
    b = p_st(jax_cnn_logits(X, jnp.bfloat16))
    f = p_st(jax_cnn_logits(X, jnp.float32))
    flips = np.flatnonzero((b >= thr) != (f >= thr))
    print(f"JAX cnn_openlab: {len(X)} windows, bf16 against float32 p(ST): "
          f"max abs {np.abs(b - f).max():.4e} mean abs {np.abs(b - f).mean():.4e}; "
          f"label flips {len(flips)} {flips.tolist()}; "
          f"{time.perf_counter() - t0:.0f} s", flush=True)


def port_readings() -> None:
    import jax.numpy as jnp

    torch.set_num_threads(1)
    W = all_vae_windows()
    for cell in ROOTS:
        Z, thr = vae_windows(cell, W)
        vae, params = jax_vae(cell)
        jb = jax_recon(vae, params, Z, jnp.bfloat16)
        jf = jax_recon(vae, params, Z, jnp.float32)
        pb = port_recon(port_vae(cell, torch.bfloat16), Z)
        dp, df = np.abs(pb - jb), np.abs(jf - jb)
        rp, rf = _rel(mse(Z, pb), mse(Z, jb)), _rel(mse(Z, jf), mse(Z, jb))
        print(f"PORT {cell}: {len(Z)} windows; against JAX bf16, recon of "
              f"port bf16: max abs {dp.max():.4e} mean abs {dp.mean():.4e} "
              f"equal {np.mean(dp == 0):.4f}; of JAX float32: max abs "
              f"{df.max():.4e} mean abs {df.mean():.4e} equal "
              f"{np.mean(df == 0):.4f}; mse of port bf16: max rel "
              f"{rp.max():.4e} mean rel {rp.mean():.4e}; of JAX float32: max "
              f"rel {rf.max():.4e} mean rel {rf.mean():.4e}; gates differ "
              f"{int(((mse(Z, pb) > thr) != (mse(Z, jb) > thr)).sum())}",
              flush=True)
    X, thr = cnn_windows()
    jb, jf = jax_cnn_logits(X, jnp.bfloat16), jax_cnn_logits(X, jnp.float32)
    pb = port_cnn_logits(port_cnn(torch.bfloat16), X)
    dp, df = np.abs(pb - jb), np.abs(jf - jb)
    print(f"PORT cnn_openlab: {len(X)} windows; against JAX bf16, logits of "
          f"port bf16: max abs {dp.max():.4e} mean abs {dp.mean():.4e} equal "
          f"{np.mean(dp == 0):.4f}; of JAX float32: max abs {df.max():.4e} "
          f"mean abs {df.mean():.4e} equal {np.mean(df == 0):.4f}; labels "
          f"differ {int(((p_st(pb) >= thr) != (p_st(jb) >= thr)).sum())}",
          flush=True)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "tests"))
    {"jax": jax_readings, "port": port_readings}[sys.argv[1]]()
