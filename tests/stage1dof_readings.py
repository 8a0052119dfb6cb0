"""The CPU readings behind ``chip_smoke.py`` phase 13's 1-DOF tolerances.

``seeds``: for each seed, ``train-vae`` at the full recipe (100 epochs) on a
temporary root holding the committed ``data/1dof/raw`` CSVs, then
``test-seen`` and ``test-unseen``; one JSON line per seed with the seen
and unseen mean segment RMSE and the training seconds. Figures are off.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/stage1dof_readings.py seeds jax 42 43 44
    PYTHONPATH=. python tests/stage1dof_readings.py seeds port --device cpu 42

``distances``: ``gen-seen`` / ``gen-unseen`` of the JAX package and of the
port on the CPU, each channel's max |diff| over the committed (or the JAX)
channel's peak; and the committed model's ``test-seen`` / ``test-unseen``
tables of both against the committed ones (max |diff|).

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/stage1dof_readings.py distances

``chip_smoke.py``'s ``STAGE1_SEEN_RMSE_CEILING`` was set from the ``jax``
lines of seeds 42-47, its ``STAGE1_GEN_RTOL`` and ``STAGE1_TABLE_ATOL``
from the ``distances`` lines. ``jax`` needs the JAX package; ``port`` alone
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "data/1dof"


def _cli(package: str):
    if package == "jax":
        from shm_tpu.cli import stage1dof
    else:
        from shm_tpu_torch.cli import stage1dof
    return stage1dof


def _seed_cfg(package: str, seed: int):
    if package == "jax":
        from shm_tpu.config import Stage1DofConfig, replace
    else:
        from shm_tpu_torch.config import Stage1DofConfig, replace
    cfg = Stage1DofConfig()
    return replace(cfg, train=replace(cfg.train, seed=seed))


def seeds(package: str, seed_list, device) -> None:
    cli = _cli(package)
    kw = {} if package == "jax" else {"device": device}
    for seed in seed_list:
        cfg = _seed_cfg(package, seed)
        with tempfile.TemporaryDirectory(prefix="stage1dof_seed_") as tmp:
            shutil.copytree(COMMITTED / "raw", Path(tmp) / "raw")
            paths = cli.Paths(tmp)
            t0 = time.perf_counter()
            cli.cmd_train_vae(paths, cfg, plot=False, **kw)
            secs = time.perf_counter() - t0
            cli.cmd_test_seen(paths, cfg, plot=False, **kw)
            cli.cmd_test_unseen(paths, cfg, plot=False, **kw)
            mean = {tag: float(np.loadtxt(paths.tables / f"reconstruction_{tag}"
                                          / "segment_rmse.csv", delimiter=",",
                                          skiprows=1)[:, 1].mean())
                    for tag in ("seen", "unseen")}
        print(json.dumps({"package": package, "seed": seed,
                          "seen_mean_rmse": mean["seen"],
                          "unseen_mean_rmse": mean["unseen"],
                          "train_vae_seconds": secs}), flush=True)


def distances() -> None:
    from chip_smoke import STAGE1_TABLES, load_f32_csv

    with tempfile.TemporaryDirectory(prefix="stage1dof_dist_") as tmp:
        roots = {}
        for package in ("jax", "port"):
            cli = _cli(package)
            root = Path(tmp) / package
            for sub in ("raw", "processed", "models"):
                shutil.copytree(COMMITTED / sub, root / "eval" / sub)
            extra = [] if package == "jax" else ["--device", "cpu"]
            for c in ("gen-seen", "gen-unseen"):
                cli.main([c, "--root", str(root / "gen"), "--no-plots"] + extra)
            for c in ("test-seen", "test-unseen"):
                cli.main([c, "--root", str(root / "eval"), "--no-plots"] + extra)
            roots[package] = root
        for kind in ("seen", "unseen"):
            rel = f"raw/1dof_{kind}_variants.csv"
            names, com = load_f32_csv(COMMITTED / rel)
            got = {p: load_f32_csv(r / "gen" / rel)[1] for p, r in roots.items()}
            rows = {f"{p} vs committed": got[p] for p in got}
            rows["port vs jax"] = got["port"]
            for what, a in rows.items():
                ref = got["jax"] if what == "port vs jax" else com
                r = np.abs(a[:, 1:] - ref[:, 1:]).max(0) / np.abs(ref[:, 1:]).max(0)
                print(json.dumps({"csv": rel, "pair": what, "worst": float(r.max()),
                                  "channel": names[int(r.argmax()) + 1]}))
        for rel in STAGE1_TABLES[:4]:
            _, com = load_f32_csv(COMMITTED / rel)
            for p, r in roots.items():
                d = np.abs(load_f32_csv(r / "eval" / rel)[1][:, 1:] - com[:, 1:]).max()
                print(json.dumps({"table": rel, "pair": f"{p} vs committed",
                                  "max_abs_diff": float(d)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    s = sub.add_parser("seeds")
    s.add_argument("package", choices=["jax", "port"])
    s.add_argument("seeds", type=int, nargs="+")
    s.add_argument("--device", default=None,
                   help="port only: torch device (default: the CUDA card)")
    sub.add_parser("distances")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if args.what == "seeds":
        seeds(args.package, args.seeds, args.device)
    else:
        distances()
    return 0


if __name__ == "__main__":
    sys.exit(main())
