"""The port's data-generation commands (``gen-normal``, ``gen-faults`` in
both regimes, ``make-splits``) and ``all`` on the CPU, into temporary roots.

Every CSV is held per channel to the committed ``data/4dof/raw`` run (max
|diff| over max |committed| within COMMITTED_RTOL) and to the JAX commands'
output made here (within JAX_RTOL); ``make-splits`` must rebuild the
committed ``run_splits.json`` of ``data/4dof`` and ``data/4dof_legacy``
with only the root's prefix rewritten.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from shm_tpu.cli.stage4dof import main as jax_main
from shm_tpu_torch.cli import stage4dof as cli
from shm_tpu_torch.config import (
    Stage4DofConfig, SystemConfig, TrainConfig, VAEConfig, replace,
)
from shm_tpu_torch.sim import simulate_runs, smoothed_gaussian_force_np

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# float32 Newmark runs of 1,001 steps against the committed CSVs, which a TPU
# made: the port reads <= 1.11e-4 (stiff_red_30pct), the JAX package on the
# CPU <= 1.03e-4
COMMITTED_RTOL = 2e-4
# against the JAX commands on the same CPU: the port reads <= 4.7e-5
JAX_RTOL = 1e-4
CASES = ["noise_x4", "spikes_x1", "drift_x2", "bias_x3"]
STRUCT = ["stiff_red_10pct", "stiff_red_20pct", "stiff_red_30pct", "stiff_red_40pct"]
LEGACY = ["stiff_red_8pct", "stiff_red_9pct", "stiff_red_18pct",
          "stiff_red_19pct", "stiff_red_30pct", "stiff_red_40pct"]


def _csvs(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in (root / "raw").rglob("*.csv"))


def _load(path: Path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64)


def _rel(got: np.ndarray, ref: np.ndarray) -> float:
    return float((np.abs(got - ref).max(axis=0) / np.abs(ref).max(axis=0)).max())


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """gen-normal, gen-faults and make-splits of the port (absolute root) and
    of the JAX package (its own root), both on the CPU."""
    port = tmp_path_factory.mktemp("port") / "r4dof"
    jax_root = tmp_path_factory.mktemp("jax") / "r4dof"
    for c in ("gen-normal", "gen-faults", "make-splits"):
        cli.main([c, "--root", str(port), "--device", "cpu", "--no-plots"])
    for c in ("gen-normal", "gen-faults"):
        jax_main([c, "--root", str(jax_root), "--no-plots"])
    return port, jax_root


def test_the_runs_and_their_format(generated):
    port, _ = generated
    want = _csvs(ROOT / "data/4dof")
    assert _csvs(port) == want and len(want) == 18
    for rel in want:
        got_lines = (port / rel).read_text().splitlines()
        ref_lines = (ROOT / "data/4dof" / rel).read_text().splitlines()
        assert got_lines[0] == ref_lines[0] == ",".join(cli.COLUMNS)
        assert len(got_lines) == len(ref_lines) == 1002
        # %.10g: at most 10 significant digits, no padding
        assert all(re.fullmatch(r"-?\d(\.\d{1,9})?(e[-+]\d\d)?|-?0\.\d+(e[-+]\d\d)?"
                                r"|-?\d+(\.\d+)?", v)
                   for v in got_lines[500].split(","))


@pytest.mark.parametrize("rel", sorted(
    [f"raw/normal/normal_seed{s}.csv" for s in range(2025, 2035)]
    + [f"raw/faults/structural_fault/{c}/{c}.csv" for c in STRUCT]
    + [f"raw/faults/sensor_fault/{c}/{c}.csv" for c in CASES]))
def test_each_run_against_the_committed_one_and_jax(generated, rel):
    port, jax_root = generated
    got = _load(port / rel)
    assert _rel(got, _load(ROOT / "data/4dof" / rel)) <= COMMITTED_RTOL
    assert _rel(got, _load(jax_root / rel)) <= JAX_RTOL


def test_spike_positions_are_the_committed_ones(generated):
    """The 10 spiked samples of spikes_x1 on x1, v1 and a1: where the run
    leaves the nominal one (simulated here), and the committed run there."""
    port, _ = generated
    cfg = Stage4DofConfig()
    f = cfg.faults
    force = smoothed_gaussian_force_np(10.0, 0.01, 4, f.force_rms, f.force_seed)
    nominal = simulate_runs(np.array(cfg.system.mass)[None],
                            np.array(cfg.system.stiffness)[None],
                            np.full(1, cfg.system.damping_ratio), force[None],
                            device="cpu")[0].numpy().astype(np.float64)
    rel = "raw/faults/sensor_fault/spikes_x1/spikes_x1.csv"
    got, committed = _load(port / rel), _load(ROOT / "data/4dof" / rel)
    for c in (0, 4, 8):
        scale = np.abs(nominal[:, c]).max()
        hit = np.nonzero(np.abs(got[:, c] - nominal[:, c]) > 1e-3 * scale)[0]
        hit_c = np.nonzero(np.abs(committed[:, c] - nominal[:, c]) > 1e-3 * scale)[0]
        assert len(hit) == 10 and np.array_equal(hit, hit_c)


def test_make_splits_rebuilds_the_committed_document(generated):
    port, _ = generated
    got = json.loads((port / "processed/run_splits.json").read_text())
    want = (ROOT / "data/4dof/processed/run_splits.json").read_text()
    assert got == json.loads(want.replace("data/4dof/", port.as_posix() + "/"))
    assert all(Path(p).is_absolute() and cli.resolve_run_path(p).is_file()
               for p in got["normal"]["files"])


def test_legacy_regime_replaces_the_other_regime(generated, tmp_path, capsys,
                                                 monkeypatch):
    """gen-faults --legacy-faults on a root of the other regime removes its
    known cases (10 and 20 %), keeps an unknown stiff_red_* directory with a
    warning, and make-splits (from the root's parent, a relative root)
    rebuilds data/4dof_legacy's committed splits once the unknown case is
    gone."""
    import shutil

    port, _ = generated
    root = tmp_path / "data" / "4dof_legacy"
    shutil.copytree(port / "raw", root / "raw")
    (root / "raw/faults/structural_fault/stiff_red_50pct").mkdir()
    monkeypatch.chdir(tmp_path)
    cli.main(["gen-faults", "--root", "data/4dof_legacy", "--legacy-faults",
              "--device", "cpu", "--no-plots"])
    out = capsys.readouterr().out
    for gone in ("stiff_red_10pct", "stiff_red_20pct"):
        assert f"removed stale structural case from the other regime: {gone}" in out
    assert "[WARN] unrecognized structural case dir kept: stiff_red_50pct" in out
    dirs = sorted(d.name for d in (root / "raw/faults/structural_fault").iterdir())
    assert dirs == sorted(LEGACY + ["stiff_red_50pct"])
    for c in LEGACY:
        rel = f"raw/faults/structural_fault/{c}/{c}.csv"
        assert len((root / rel).read_text().splitlines()) == 1002
    (root / "raw/faults/structural_fault/stiff_red_50pct").rmdir()
    cli.main(["make-splits", "--root", "data/4dof_legacy"])
    got = json.loads((root / "processed/run_splits.json").read_text())
    want = json.loads((ROOT / "data/4dof_legacy/processed/run_splits.json").read_text())
    assert got == want
    assert cli.resolve_run_path(got["structural_fault"]["files"][0]) == Path(
        got["structural_fault"]["files"][0])          # found from here


def test_gen_commands_draw_their_figures(tmp_path, monkeypatch):
    small = replace(Stage4DofConfig(), n_normal_runs=2,
                    system=replace(SystemConfig(), t_total=1.0))
    monkeypatch.setattr(cli, "Stage4DofConfig", lambda: small)
    for c in ("gen-normal", "gen-faults"):
        cli.main([c, "--root", str(tmp_path), "--device", "cpu"])
    figs = sorted(p.relative_to(tmp_path / "figures").as_posix()
                  for p in (tmp_path / "figures").rglob("*.png"))
    assert "normal_run_seed2025_displacement_stacked.png" in figs
    assert ("faults/sensor_fault/bias_x3/"
            "bias_x3_normal_vs_sensor_fault_displacement_stacked.png") in figs
    assert len(figs) == 1 + 4 + 4


def test_all_runs_the_seven_commands_in_order(tmp_path, monkeypatch, capsys):
    """``all`` at a cut config (2 runs of 4 s, stride 4, a tiny VAE, one
    epoch each): the seven commands in the JAX CLI's order, every artifact
    written, the cell recorded."""
    small = replace(
        Stage4DofConfig(), n_normal_runs=2, stride=4,
        system=replace(SystemConfig(), t_total=4.0),
        vae=VAEConfig(input_dim=12, latent_dim=4, hidden_dim=8, num_layers=2,
                      dropout=0.3, use_layernorm=True),
        vae_train=TrainConfig(epochs=1, batch_size=64, seed=3),
        cnn_train=replace(Stage4DofConfig().cnn_train, batch_size=32))
    monkeypatch.setattr(cli, "Stage4DofConfig", lambda: small)
    cli.main(["all", "--root", str(tmp_path), "--cell", "min_gru",
              "--epochs", "1", "--device", "cpu", "--no-plots"])
    heads = re.findall(r"===== (\S+) =====", capsys.readouterr().out)
    assert heads == ["gen-normal", "gen-faults", "make-splits", "train-vae",
                     "threshold", "train-cnn", "test-pipeline"]
    for rel in ("raw/normal/normal_seed2026.csv", "processed/run_splits.json",
                "models/temporal_vae.msgpack", "processed/vae_threshold.json",
                "models/cnn.msgpack", "figures/pipeline_metrics.json"):
        assert (tmp_path / rel).is_file(), rel
    meta = json.loads((tmp_path / "processed/stage1_vae_train_meta.json").read_text())
    assert meta["cell"] == "min_gru" and meta["epochs"] == 1
    assert not list(tmp_path.rglob("*.png"))         # --no-plots
    m = json.loads((tmp_path / "figures/pipeline_metrics.json").read_text())
    assert sum(map(sum, m["confusion_matrix_counts"])) == m["throughput"]["n_windows"] > 0
