"""The 4DOF CNN trainer on the CUDA card against the same run on the CPU.

For each seed, the full recipe (50 epochs, batch 100, early-stop patience 15)
three times on the same inputs (``data/4dof``'s train and val windows through
the LSTM gate kernel's residual mode, made once on the card) and the same
draws (the trainer's generator lives on the CPU):

- ``cpu``: ``train_cnn`` on the CPU;
- ``cuda``: ``train_cnn`` on the card;
- ``cpu_ulp``: the CPU run again with every training input moved one float32
  ulp up, a perturbation at rounding's own scale, so the growth of its
  distance from ``cpu`` is what rounding alone does to this recipe.

Printed per epoch: each run's train and val loss and the two distances from
``cpu``; per run its best and stopping epoch and the accuracy of
``test-pipeline`` on the card with its CNN (committed VAE and threshold).
A card that only rounds differently diverges from ``cpu`` as ``cpu_ulp``
does; a fault shows as a jump that ``cpu_ulp`` does not have.

    python tests/cnn_card_vs_cpu.py 42 44 --out build/cnn_card_vs_cpu.json
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RUNS = ("cpu", "cuda", "cpu_ulp")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--out", default=None, help="write the numbers as JSON here")
    ap.add_argument("--device", default="cuda",
                    help="the run compared with the CPU (cpu: a dry run of "
                         "the script itself)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="cut the recipe's 50 epochs (a dry run)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import os
    from dataclasses import replace

    import torch

    from shm_tpu_torch.cli.stage4dof import (
        Paths, cmd_test_pipeline, cnn_train_sets,
    )
    from shm_tpu_torch.config import Stage4DofConfig
    from shm_tpu_torch.convert import cnn4dof_to_flax
    from shm_tpu_torch.device import command_device
    from shm_tpu_torch.models.cnn import CNN4DOF
    from shm_tpu_torch.train import train_cnn
    from shm_tpu_torch.utils.checkpoint import save_checkpoint

    os.chdir(ROOT)                     # run_splits.json's paths are repo-relative
    cfg = Stage4DofConfig()
    card = command_device(args.device)
    sets = cnn_train_sets(Paths("data/4dof"), cfg, card)
    (Xtr, ytr), (Xva, yva) = sets["train"], sets["val"]
    inputs = {"cpu": (Xtr.cpu(), Xva.cpu(), "cpu"), "cuda": (Xtr, Xva, card),
              "cpu_ulp": (torch.nextafter(Xtr.cpu(), torch.tensor(float("inf"))),
                          Xva.cpu(), "cpu")}
    report = {}
    for seed in args.seeds:
        tcfg = replace(cfg.cnn_train, seed=seed,
                       epochs=args.epochs or cfg.cnn_train.epochs)
        runs = {}
        for name in RUNS:
            xtr, xva, dev = inputs[name]
            cnn = CNN4DOF(num_classes=cfg.cnn.num_classes, seq_len=cfg.seq_len,
                          num_features=cfg.num_features, dropout=cfg.cnn.dropout)
            res = train_cnn(cnn, xtr, ytr, xva, yva, tcfg, device=dev)
            with tempfile.TemporaryDirectory(prefix="cnn_card_vs_cpu_") as tmp:
                for sub in ("processed", "models"):
                    shutil.copytree(ROOT / "data/4dof" / sub, Path(tmp) / sub)
                save_checkpoint(cnn4dof_to_flax(res.variables, cfg.seq_len,
                                                cfg.num_features),
                                Path(tmp) / "models" / "cnn.msgpack")
                acc = cmd_test_pipeline(Paths(tmp), cfg, plot=False,
                                        device=card)["accuracy"]
            runs[name] = {"train_loss": res.history["train_loss"],
                          "val_loss": res.history["val_loss"],
                          "best_epoch": res.best_epoch,
                          "stopped_epoch": res.stopped_epoch,
                          "best_val": res.best_val, "accuracy": acc,
                          "seconds": res.seconds}
        report[seed] = runs
        base = runs["cpu"]
        print(f"[seed {seed}] epoch | train loss cpu / cuda / cpu_ulp | val loss "
              "cpu / cuda / cpu_ulp | |val cuda - cpu| | |val cpu_ulp - cpu|")
        for e in range(max(len(r["val_loss"]) for r in runs.values())):
            row = [runs[n][k][e] if e < len(runs[n][k]) else float("nan")
                   for k in ("train_loss", "val_loss") for n in RUNS]
            print(f"[seed {seed}] {e + 1:3d} | " + " / ".join(f"{v:.7f}" for v in row[:3])
                  + " | " + " / ".join(f"{v:.7f}" for v in row[3:])
                  + f" | {abs(row[4] - row[3]):.3e} | {abs(row[5] - row[3]):.3e}")
        for name in ("cuda", "cpu_ulp"):
            d = [abs(a - b) for a, b in zip(runs[name]["val_loss"], base["val_loss"])]
            first = {t: next((e + 1 for e, v in enumerate(d) if v > t), None)
                     for t in (1e-6, 1e-4, 1e-2)}
            runs[name]["first_epoch_val_diff_over"] = first
            print(f"[seed {seed}] {name} vs cpu: first epoch with |val diff| over "
                  f"1e-6 / 1e-4 / 1e-2: {first[1e-6]} / {first[1e-4]} / {first[1e-2]}")
        for name, r in runs.items():
            print(f"[seed {seed}] {name}: best epoch {r['best_epoch']}, stopped "
                  f"{r['stopped_epoch']}, best val {r['best_val']:.7f}, "
                  f"test-pipeline accuracy {r['accuracy']:.6f}, {r['seconds']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
