"""The port's 1-DOF commands (``shm_tpu_torch/cli/stage1dof.py``) against
the JAX package's (``shm_tpu/cli/stage1dof.py``) on the CPU, into temporary
roots, figures off.

``gen-seen`` / ``gen-unseen`` are held per channel to the JAX commands'
output made here and to the committed ``data/1dof/raw`` CSVs (the tolerances
of ``chip_smoke.py`` phase 13); ``test-seen`` / ``test-unseen`` /
``compare-rmse`` with the committed model to the JAX commands on a copy of
``data/1dof`` and to the committed tables. Tolerances are stated where they
are used.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (
    STAGE1_A_SQUARE_RTOL, STAGE1_GEN_RTOL, STAGE1_TABLE_ATOL, STAGE1_TABLES,
    load_f32_csv,
)
from shm_tpu.cli import stage1dof as jax_cli
from shm_tpu_torch.cli import stage1dof as cli
from test_torch_signals import UNSEEN_RTOL

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "data/1dof"
# the seen series against the JAX command on the same CPU, max |diff| over
# the channel's peak: both integrate the oscillator in float32 for 3,000
# steps, XLA with its own contractions; the port reads <= 9.7e-4
# (a_amplitude_scaled)
SEEN_JAX_RTOL = 2e-3
# the eval tables against the JAX commands with the same model, both float32
# on the CPU: the series within 2e-6 of each column's peak (the port reads
# <= 6.3e-7), each segment RMSE within 2e-6 relative (<= 3.5e-7)
TABLE_JAX_RTOL = 2e-6


def _copy_committed(dest: Path) -> Path:
    for sub in ("raw", "processed", "models"):
        shutil.copytree(COMMITTED / sub, dest / sub)
    return dest


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    port = tmp_path_factory.mktemp("port_gen")
    jax = tmp_path_factory.mktemp("jax_gen")
    for c in ("gen-seen", "gen-unseen"):
        cli.main([c, "--root", str(port), "--device", "cpu", "--no-plots"])
        jax_cli.main([c, "--root", str(jax), "--no-plots"])
    return port, jax


@pytest.mark.parametrize("kind", ["seen", "unseen"])
def test_generated_csv_format(generated, kind):
    """The committed header, 3,001 rows, and the text pandas writes: where
    the JAX command and the port hold the same float32 value, the same
    characters (the time column on every row)."""
    port, jax = generated
    rel = f"raw/1dof_{kind}_variants.csv"
    got = (port / rel).read_text().splitlines()
    ref = (jax / rel).read_text().splitlines()
    assert got[0] == ref[0] == (COMMITTED / rel).read_text().splitlines()[0]
    assert len(got) == len(ref) == 3002
    assert [l.split(",")[0] for l in got] == [l.split(",")[0] for l in ref]
    names, a = load_f32_csv(port / rel)
    _, b = load_f32_csv(jax / rel)
    same = a == b
    rows = [i for i in range(a.shape[0]) if same[i].all()]
    assert rows and all(got[i + 1] == ref[i + 1] for i in rows)


@pytest.mark.parametrize("kind", ["seen", "unseen"])
def test_generated_channels_against_jax_and_committed(generated, kind):
    """Every channel within STAGE1_GEN_RTOL of the committed run (max |diff|
    over max |committed|), and of the JAX command's within SEEN_JAX_RTOL
    (seen) or the signal tests' UNSEEN_RTOL by quantity (unseen); the time
    column equal to both."""
    port, jax = generated
    rel = f"raw/1dof_{kind}_variants.csv"
    names, got = load_f32_csv(port / rel)
    _, ref = load_f32_csv(jax / rel)
    _, com = load_f32_csv(COMMITTED / rel)
    assert np.array_equal(got[:, 0], ref[:, 0]) and np.array_equal(got[:, 0], com[:, 0])
    for j, c in enumerate(names[1:], start=1):
        peak = np.abs(com[:, j]).max()
        assert np.abs(got[:, j] - com[:, j]).max() <= STAGE1_GEN_RTOL[kind] * peak, c
        tol = SEEN_JAX_RTOL if kind == "seen" else UNSEEN_RTOL[c[0]]
        assert np.abs(got[:, j] - ref[:, j]).max() <= tol * np.abs(ref[:, j]).max(), c


def test_square_wave_channels_exact(generated):
    """x_square, v_square and a_square equal to the JAX command's; x_square
    and v_square equal to the committed ones, a_square within one float32
    ulp (STAGE1_A_SQUARE_RTOL) with its zeros where the committed ones are."""
    port, jax = generated
    rel = "raw/1dof_unseen_variants.csv"
    names, got = load_f32_csv(port / rel)
    _, ref = load_f32_csv(jax / rel)
    _, com = load_f32_csv(COMMITTED / rel)
    for c in ("x_square", "v_square", "a_square"):
        k = names.index(c)
        np.testing.assert_array_equal(got[:, k], ref[:, k], err_msg=c)
        if c != "a_square":
            np.testing.assert_array_equal(got[:, k], com[:, k], err_msg=c)
    k = names.index("a_square")
    assert np.array_equal(got[:, k] == 0, com[:, k] == 0)
    assert (np.abs(got[:, k] - com[:, k]) <= STAGE1_A_SQUARE_RTOL * np.abs(com[:, k])).all()
    assert got[0, names.index("x_square")] == 0.0      # sign(sin(0)) = 0


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """test-seen, test-unseen and compare-rmse of the port and of the JAX
    package, each on its own copy of data/1dof (the committed model)."""
    port = _copy_committed(tmp_path_factory.mktemp("port_eval"))
    jax = _copy_committed(tmp_path_factory.mktemp("jax_eval"))
    for c in ("test-seen", "test-unseen", "compare-rmse"):
        cli.main([c, "--root", str(port), "--device", "cpu", "--no-plots"])
        jax_cli.main([c, "--root", str(jax), "--no-plots"])
    return port, jax


@pytest.mark.parametrize("rel", STAGE1_TABLES[:4])
def test_eval_tables_against_jax_and_committed(evaluated, rel):
    """Headers and shapes those of the JAX command and of the committed
    table; values within TABLE_JAX_RTOL of the JAX command's and within
    STAGE1_TABLE_ATOL of the committed ones (made on a TPU)."""
    port, jax = evaluated
    names, got = load_f32_csv(port / rel)
    ref_names, ref = load_f32_csv(jax / rel)
    com_names, com = load_f32_csv(COMMITTED / rel)
    assert names == ref_names == com_names and got.shape == ref.shape == com.shape
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    d = np.abs(got[:, 1:] - ref[:, 1:])
    if "series" in rel:
        assert (d.max(0) <= TABLE_JAX_RTOL * np.abs(ref[:, 1:]).max(0)).all()
    else:
        assert (d <= TABLE_JAX_RTOL * np.abs(ref[:, 1:])).all()
        assert got.shape[0] == (16 if "_seen" in rel else 31)
    tol = STAGE1_TABLE_ATOL["seen" if "_seen" in rel else "unseen"]
    assert np.abs(got[:, 1:] - com[:, 1:]).max() <= tol[0 if "series" in rel else 1]


def test_compare_rmse_summary_against_jax(evaluated):
    """rmse_summary_stats.csv: the JAX command's rows and columns, each
    statistic within 2e-6 relative (the segment RMSEs' own tolerance; the
    statistics are float64 on both sides), std with ddof 1."""
    port, jax = evaluated
    rel = STAGE1_TABLES[4]
    got = [l.split(",") for l in (port / rel).read_text().splitlines()]
    ref = [l.split(",") for l in (jax / rel).read_text().splitlines()]
    assert got[0] == ref[0] == ["Set", "Mean", "Median", "Std", "Min", "Max"]
    assert [r[0] for r in got[1:]] == [r[0] for r in ref[1:]] == ["Seen", "Unseen"]
    np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                               np.array([r[1:] for r in ref[1:]], float), rtol=TABLE_JAX_RTOL)
    seen = np.loadtxt(port / STAGE1_TABLES[1], delimiter=",", skiprows=1)[:, 1]
    assert float(got[1][3]) == pytest.approx(seen.std(ddof=1), rel=1e-12)


def test_all_runs_the_six_commands_in_order(monkeypatch, tmp_path):
    calls = []
    for name in ("cmd_gen_seen", "cmd_gen_unseen", "cmd_train_vae", "cmd_test_seen",
                 "cmd_test_unseen", "cmd_compare_rmse"):
        monkeypatch.setattr(cli, name, lambda *a, _n=name, **k: calls.append((_n, k)))
    cli.main(["all", "--root", str(tmp_path), "--device", "cpu", "--no-plots",
              "--epochs", "3"])
    assert [c for c, _ in calls] == ["cmd_gen_seen", "cmd_gen_unseen", "cmd_train_vae",
                                     "cmd_test_seen", "cmd_test_unseen",
                                     "cmd_compare_rmse"]
    assert all(k.get("device", "cpu") == "cpu" for _, k in calls)


def test_commands_default_to_the_card(monkeypatch, tmp_path):
    """No --device: the command asks for the CUDA card and raises without
    one; it never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["gen-unseen", "--root", str(tmp_path), "--no-plots"])
    assert not (tmp_path / "raw").exists()


def test_no_plots_imports_no_matplotlib(tmp_path):
    """--no-plots draws no figure and imports no matplotlib (the card's
    machine has none)."""
    import subprocess
    import sys

    code = ("import sys; from shm_tpu_torch.cli.stage1dof import main; "
            f"main(['gen-unseen', '--root', {str(tmp_path)!r}, '--device', 'cpu', "
            "'--no-plots']); assert 'matplotlib' not in sys.modules, 'imported'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
    assert not (tmp_path / "figures").exists()
