"""The spread of the 4DOF CNN trainer's outcome over seeds.

For each seed: ``train-cnn`` at the full recipe (50 epochs, batch 100,
early-stop patience 15) on a temporary copy of ``data/4dof``, then
``test-pipeline`` with that CNN and the committed threshold; one line per
seed with the accuracy, the best and the stopping epoch, and the best
validation CE. Figures are off.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/cnn_seed_spread.py jax 42 43 44
    PYTHONPATH=. python tests/cnn_seed_spread.py port --device cpu 42 43 44
    python tests/cnn_seed_spread.py port 42 43 44        # on the CUDA card

``jax`` runs the JAX package's CLI (from the repository root: its
``run_splits.json`` paths are repo-relative); ``port`` runs the port's, and
imports no JAX, so it also runs where only PyTorch is installed.
``chip_smoke.py``'s ``CNN_ACCURACY_FLOOR`` was set from the ``jax`` lines
of seeds 42, 43, 44.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("package", choices=["jax", "port"])
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--device", default=None,
                    help="port only: torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    os.chdir(ROOT)
    if args.package == "jax":
        import shm_tpu.report as jax_report
        from shm_tpu.cli.stage4dof import main as cli_main

        for name in jax_report.__all__:
            if name.startswith("plot_"):
                setattr(jax_report, name, lambda *a, **k: None)
        extra = []
    else:
        from shm_tpu_torch.cli.stage4dof import main as cli_main

        extra = ["--no-plots"] + (["--device", args.device] if args.device else [])
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="cnn_seed_spread_") as tmp:
            root = Path(tmp)
            for sub in ("processed", "models"):
                shutil.copytree(ROOT / "data/4dof" / sub, root / sub)
            cli_main(["train-cnn", "--root", tmp, "--seed", str(seed)] + extra)
            cli_main(["test-pipeline", "--root", tmp] + extra)
            m = json.loads((root / "figures/pipeline_metrics.json").read_text())
            meta = json.loads(
                (root / "processed/stage2_cnn_train_meta.json").read_text())
        print("SPREAD " + json.dumps({
            "package": args.package, "device": args.device, "seed": seed,
            "accuracy": m["accuracy"], "cm": m["confusion_matrix_counts"],
            "best_epoch": meta["best_epoch"], "stopped_epoch": meta["stopped_epoch"],
            "best_val_ce": meta["best_val_ce"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
