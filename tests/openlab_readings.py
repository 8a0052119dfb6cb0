"""Readings of the openLAB stage that ``chip_smoke.py`` phase 14 rests on.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/openlab_readings.py cnn-seeds jax 42 43 44
    PYTHONPATH=. python tests/openlab_readings.py cnn-seeds port --device cpu 42
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/openlab_readings.py attention
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/openlab_readings.py margins
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/openlab_readings.py gate-sums

``cnn-seeds``: ``train-cnn`` at the full recipe (at most 100 epochs,
patience 25, batch 128, focal loss, weighted sampling, ST-F2 selection) on
a temporary root over the committed ``data/openlab`` windows, one seed a
run; one ``SPREAD`` line per seed with the tuned VAL ST-F2, the best and
the stopping epoch. ``chip_smoke.py``'s ``OPENLAB_CNN_F2_FLOOR`` was set
from the ``jax`` lines (their mean less 3 standard deviations).

``attention``: the JAX package's ``test-hybrid`` on a temporary copy of
``data/openlab_attention`` (its ``extracted/`` and ``features/`` are those
of ``data/openlab``), each confusion matrix against the committed
``cm3_all.npz``.

``margins``: on the committed ``data/openlab`` test and val windows, the
JAX package's float32 gate mse nearest the committed threshold (relative),
and for each stage-2 model the p(ST) of a routed window nearest its
threshold, with the JAX package's on-device tree and SVM exports.

``gate-sums``: the CPU models of the three gate kernels' sums at the
openLAB shape (``tests/test_torch_openlab_gate_tf32.py``) over all the
test and val windows of ``data/openlab``: row 1 on its committed VAE, row
7 on ``data/openlab_attention``'s, row 6 on a minGRU VAE that the port's
``train-vae --cell min_gru`` trains here for two epochs, as
``chip_smoke.py`` does on the card. One ``GATE`` line per gate and split:
the largest relative mse difference of each emulated sum from the plain
version (``*_gate_reference``) and from a float64 pass of the model, and
of the plain version and the model's float32 pass (what
``reconstruction_mse(fused=False)`` runs) from that float64 pass, with the
gate decisions that differ from the plain version's.
``chip_smoke.py``'s ``OPENLAB_MSE_RTOL``, ``OPENLAB_MINGRU_MSE_RTOL`` and
``OPENLAB_ATTENTION_MSE_RTOL`` rest on these lines.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OPENLAB = ROOT / "data" / "openlab"


def temp_root(tmp: Path, src: Path = OPENLAB, outputs=()) -> Path:
    """A root under ``tmp`` with ``src``'s ``extracted/`` and ``features/``
    and the named ``output/`` subdirectories copied."""
    root = tmp / "root"
    for sub in ("extracted", "features"):
        shutil.copytree(OPENLAB / sub, root / sub)
    for sub in outputs:
        shutil.copytree(src / "output" / sub, root / "output" / sub)
    return root


def _silence_jax_plots() -> None:
    import shm_tpu.report as jax_report

    for name in jax_report.__all__:
        if name.startswith("plot_"):
            setattr(jax_report, name, lambda *a, **k: None)


def cnn_seeds(package: str, seeds, device=None) -> None:
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="openlab_cnn_seed_") as tmp:
            root = temp_root(Path(tmp))
            if package == "jax":
                _silence_jax_plots()
                from shm_tpu.cli import openlab as ol
                from shm_tpu.config import OpenLabConfig, replace

                cfg = OpenLabConfig()
                cfg = replace(cfg, cnn_train=replace(cfg.cnn_train, seed=seed))
                ol.cmd_train_cnn(ol.Paths(str(root), ""), cfg)
            else:
                from shm_tpu_torch.cli.openlab import main as cli_main

                cli_main(["train-cnn", "--root", str(root), "--seed", str(seed),
                          "--no-plots"]
                         + (["--device", device] if device else []))
            info = json.loads((root / "output/CNN_Training/artifacts"
                               / "cnn_training_info.json").read_text())
        print("SPREAD " + json.dumps({
            "package": package, "device": device, "seed": seed,
            "tuned_val_f2_st": info["val"]["f2_st"],
            "best_st_f2": info["best_st_f2"], "best_epoch": info["best_epoch"],
            "stopped_epoch": info["stopped_epoch"],
            "train_seconds": info["train_seconds"]}), flush=True)


def attention() -> None:
    _silence_jax_plots()
    from shm_tpu.cli import openlab as ol
    from shm_tpu.config import OpenLabConfig

    src = ROOT / "data" / "openlab_attention"
    with tempfile.TemporaryDirectory(prefix="openlab_attention_") as tmp:
        root = temp_root(Path(tmp), src, ("VAE_Training",
                                          "VAE_Validation_and_Thresholding",
                                          "CNN_Training", "CNN_Validation",
                                          "ML_Baselines"))
        ol.cmd_test_hybrid(ol.Paths(str(root), ""), OpenLabConfig())
        rep = "output/Hybrid_Pipeline/reports/"
        got = np.load(root / rep / "cm3_all.npz")
        summ = json.loads((root / rep / "comparison_summary.json").read_text())
    want = np.load(src / rep / "cm3_all.npz")
    committed = json.loads((src / rep / "comparison_summary.json").read_text())
    for k in want.files:
        print(f"ATTENTION {k}: {got[k].tolist()} committed {want[k].tolist()} "
              f"{'equal' if np.array_equal(got[k], want[k]) else 'DIFFERENT'}")
    print(f"ATTENTION anomaly rate {summ['anomaly_rate']} committed "
          f"{committed['anomaly_rate']}")
    for m, c in zip(summ["models"], committed["models"]):
        a = m["stage2_metrics_on_routed_anomalies"]["auroc_ST"]
        b = c["stage2_metrics_on_routed_anomalies"]["auroc_ST"]
        print(f"ATTENTION {m['name']} AUROC {a} committed {b}")


def margins() -> None:
    import warnings

    import joblib

    from shm_tpu.cli import openlab as ol
    from shm_tpu.config import OpenLabConfig
    from shm_tpu.models.forest_jax import (ensemble_predict_proba,
                                           export_ensemble, transform_features)
    from shm_tpu.models.svm_jax import export_svm, svm_predict_proba
    from shm_tpu.train.vae import reconstruction_mse
    from shm_tpu.utils.io import load_json

    warnings.simplefilter("ignore")
    cfg = OpenLabConfig()
    paths = ol.Paths(str(OPENLAB), "")
    Xc, Xr, meta = ol._load_extracted(paths)
    split = load_json(paths.extracted / "run_split.json")
    model, params, mu, sd, manifest = ol._load_openlab_vae(paths, cfg)
    thr = float(load_json(paths.vae_val_dir / "artifacts"
                          / "vae_threshold.json")["threshold"])
    feats = np.load(paths.features / "X_feat.npy").astype(np.float32)
    art = paths.ml_dir / "artifacts"
    for s in ("val", "test"):
        m = meta["run_id"].astype(str).isin(split[f"{s}_runs"]).to_numpy()
        Z = ol.standardize_clip(Xc[m][:, :, manifest["channels_idx"]], mu, sd,
                                cfg.standardize_clip)
        mse = reconstruction_mse(model, params, Z, fused=False)
        rel = np.abs(mse - thr) / thr
        print(f"MARGIN gate {s}: nearest mse {mse[rel.argmin()]:.7g} "
              f"relative distance {rel.min():.3e} ({int((mse > thr).sum())} "
              f"of {len(mse)} above)")
        if s != "test":
            continue
        anom = mse > thr
        for name in ("cart", "rf", "gb", "hgb", "svm_rbf"):
            mdl = joblib.load(art / f"{name}.joblib")
            Xd = transform_features(mdl, feats[m][anom])
            p = np.asarray(svm_predict_proba(export_svm(mdl), Xd)
                           if name == "svm_rbf" else
                           ensemble_predict_proba(export_ensemble(mdl), Xd),
                           np.float64)
            t = float(np.load(art / f"{name}_threshold.npy").ravel()[0])
            d = np.abs(p - t)
            print(f"MARGIN {name}: threshold {t:.6g}, nearest p_st "
                  f"{p[d.argmin()]:.9g} at {d.min():.3e}")


def gate_sums(epochs: int) -> None:
    import copy

    import torch

    from shm_tpu_torch.cli import openlab as port_ol
    from shm_tpu_torch.ops import (
        attention_params_to_kernel_weights, fused_attention_gate_reference,
        fused_mingru_gate_reference, fused_vae_gate_reference,
        mingru_params_to_kernel_weights, vae_params_to_kernel_weights,
    )
    from shm_tpu_torch.train import reconstruction_mse
    from test_torch_openlab_gate_tf32 import (
        OL_ATTENTION, emulated_attention_gate, emulated_gate,
        emulated_mingru_gate, rel, windows,
    )

    torch.set_num_threads(min(8, os.cpu_count() or 1))

    def f64(vae, Z):
        m = copy.deepcopy(vae).double().eval()
        Zd = Z.double()
        with torch.no_grad():
            return torch.cat([((z - m(z)[0]) ** 2).mean(dim=(1, 2))
                              for z in Zd.split(512)])

    with tempfile.TemporaryDirectory(prefix="openlab_gate_sums_") as tmp:
        mg = temp_root(Path(tmp))
        for cmd in ("train-vae", "validate-vae"):
            port_ol.main([cmd, "--root", str(mg), "--cell", "min_gru", "--epochs",
                          str(epochs), "--no-plots", "--device", "cpu"])
        gates = [
            ("row 1 (lstm)", OPENLAB, vae_params_to_kernel_weights,
             fused_vae_gate_reference, emulated_gate, ("split", "chain", "one_term")),
            ("row 6 (min_gru)", mg, mingru_params_to_kernel_weights,
             fused_mingru_gate_reference, emulated_mingru_gate, ("split", "one_term")),
            ("row 7 (attention)", OL_ATTENTION, attention_params_to_kernel_weights,
             fused_attention_gate_reference, emulated_attention_gate,
             ("chain", "one_term")),
        ]
        for name, root, weights_fn, reference, emulate, sums in gates:
            for split in ("test", "val"):
                vae, Z, thr = windows(split, None, root)
                w = weights_fn(vae)
                kw = dict(num_layers=1, use_layernorm=True)
                with torch.no_grad():
                    plain = reference(w, Z, with_residual=False, **kw)[0]
                model = torch.from_numpy(reconstruction_mse(vae, Z, device="cpu"))
                exact = f64(vae, Z)
                line = {"gate": name, "windows_of": split, "windows": len(Z),
                        "threshold": float(thr),
                        "plain_vs_f64": rel(plain.double(), exact),
                        "model_vs_f64": rel(model.double(), exact),
                        "model_vs_plain": rel(model, plain)}
                for tc_sum in sums:
                    with torch.no_grad():
                        got = emulate(w, Z, tc_sum=tc_sum, **kw)
                    line[tc_sum] = {
                        "vs_plain": rel(got, plain), "vs_model": rel(got, model),
                        "vs_f64": rel(got.double(), exact),
                        "gates_differing": int(((got > float(thr))
                                                != (plain > float(thr))).sum())}
                print("GATE " + json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    c = sub.add_parser("cnn-seeds")
    c.add_argument("package", choices=["jax", "port"])
    c.add_argument("seeds", type=int, nargs="+")
    c.add_argument("--device", default=None,
                   help="port only: torch device (default: the CUDA card)")
    sub.add_parser("attention")
    sub.add_parser("margins")
    g = sub.add_parser("gate-sums")
    g.add_argument("--epochs", type=int, default=2,
                   help="epochs of the minGRU VAE's train-vae (chip_smoke.py: 2)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    if args.what == "cnn-seeds":
        cnn_seeds(args.package, args.seeds, args.device)
    elif args.what == "attention":
        attention()
    elif args.what == "gate-sums":
        gate_sums(args.epochs)
    else:
        margins()
    return 0


if __name__ == "__main__":
    sys.exit(main())
