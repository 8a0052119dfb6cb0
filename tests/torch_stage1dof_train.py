"""Shared checks of the tests that train the port's 1-DOF VAE through its
``train-vae`` command on the CPU and hand the result to the JAX package
(``tests/test_torch_cli_stage1dof_train.py`` for the LSTM,
``tests/test_torch_cli_stage1dof_train_cells.py`` for min_gru and
attention): one epoch of the cell on the committed seen series, the
port's checkpoint restored by the JAX command's ``_load_model``, and the
JAX ``test-seen`` on a copy of the port's root.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import load_f32_csv
from shm_tpu.cli import stage1dof as jax_cli
from shm_tpu.config import Stage1DofConfig as JaxStage1DofConfig
from shm_tpu.data import compute_standardizer as jax_standardizer
from shm_tpu_torch.cli import stage1dof as cli
from shm_tpu_torch.config import Stage1DofConfig
from shm_tpu_torch.convert import vae_state_dict

ROOT = Path(__file__).resolve().parents[1]
# the port's test-seen tables against the JAX command's with the port's
# one-epoch model, both float32 on the CPU: the series within 1e-5 of each
# column's peak and each segment RMSE within 1e-5 relative (measured 2.0e-6
# / 2.2e-7 for lstm, 4.6e-7 / 1.6e-7 for min_gru, 5.5e-7 / 1.9e-7 for
# attention: a one-epoch LSTM reconstructs some channels as a near-constant
# whose peak is small, so its relative distance reads higher than the
# committed model's 6.3e-7)
TABLE_JAX_RTOL = 1e-5


def train_and_test_seen(tmp_path_factory, cell: str):
    """train-vae --epochs 1 --cell <cell> of the port on the committed seen
    series, then test-seen of the port on its root and of the JAX package
    on a copy of it; (cell, port root, JAX root)."""
    root = tmp_path_factory.mktemp(f"port_{cell}")
    shutil.copytree(ROOT / "data/1dof/raw", root / "raw")
    cli.main(["train-vae", "--root", str(root), "--device", "cpu", "--no-plots",
              "--epochs", "1", "--cell", cell])
    jax_root = tmp_path_factory.mktemp(f"jax_{cell}")
    for sub in ("raw", "processed", "models"):
        shutil.copytree(root / sub, jax_root / sub)
    cli.main(["test-seen", "--root", str(root), "--device", "cpu", "--no-plots"])
    jax_cli.cmd_test_seen(jax_cli.Paths(str(jax_root)), JaxStage1DofConfig(), plot=False)
    return cell, root, jax_root


def check_train_vae_artifacts(cell: str, root: Path) -> None:
    """split.json with the cell, the first half's statistics (ddof 0, within
    2 float32 ulps of JAX's), and one row of training_losses.csv under the
    committed header."""
    split = json.loads((root / "processed/split.json").read_text())
    assert split == {"T": 3001, "split_index": 1500, "train_frac": 0.5, "cell": cell}
    _, data = load_f32_csv(root / "raw/1dof_seen_variants.csv")
    jm, js = jax_standardizer(jnp.asarray(data[:1500, 1:]))
    np.testing.assert_allclose(np.load(root / "processed/vae_mean.npy"), np.asarray(jm),
                               rtol=2.4e-7, atol=1e-9)
    np.testing.assert_allclose(np.load(root / "processed/vae_std.npy"), np.asarray(js),
                               rtol=2.4e-7)
    rel = "tables/training/training_losses.csv"
    lines = (root / rel).read_text().splitlines()
    assert lines[0] == (ROOT / "data/1dof" / rel).read_text().splitlines()[0]
    row = np.array(lines[1].split(","), float)
    assert len(lines) == 2 and row[0] == 1 and np.isfinite(row).all()


def check_jax_load_model(cell: str, root: Path) -> None:
    """The JAX command's _load_model (cell from split.json, flax
    from_state_dict against its own template) reads the port's
    temporal_vae.msgpack; its parameters are the port's bit for bit."""
    model, params = jax_cli._load_model(jax_cli.Paths(str(root)), JaxStage1DofConfig())
    assert model.cell == cell
    port = cli._load_model(cli.Paths(str(root)), Stage1DofConfig())
    assert port.cell == cell
    ref = vae_state_dict(jax.tree.map(np.asarray, params), 2, False, cell)
    got = port.state_dict()
    assert ref.keys() == got.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def check_test_seen_tables(root: Path, jax_root: Path, rel: str) -> None:
    """The JAX test-seen's table ``rel`` within TABLE_JAX_RTOL of the port's."""
    names, got = load_f32_csv(root / rel)
    ref_names, ref = load_f32_csv(jax_root / rel)
    assert names == ref_names and got.shape == ref.shape
    d = np.abs(got[:, 1:] - ref[:, 1:])
    if "series" in rel:
        assert (d.max(0) <= TABLE_JAX_RTOL * np.abs(ref[:, 1:]).max(0)).all()
    else:
        assert (d <= TABLE_JAX_RTOL * np.abs(ref[:, 1:])).all()
