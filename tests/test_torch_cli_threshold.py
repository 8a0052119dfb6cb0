"""The port's ``threshold`` command on a copy of ``data/4dof`` (LSTM gate),
on the CPU, against the JAX package's command on another copy and against
the committed ``processed/vae_threshold.json``; its ``--sample`` mode; and
``main``'s dispatch of the three commands. The other two roots:
``test_torch_cli_threshold_{mingru,attention}.py`` (one root a file, so
that pytest-xdist spreads them over its workers). Tolerances:
``tests/torch_cli_roots.py``.
"""

import numpy as np
import pytest
import torch

from shm_tpu_torch.cli import stage4dof as cli
from shm_tpu_torch.config import Stage4DofConfig, replace
from shm_tpu_torch.data.windows import normalize_windows
from shm_tpu_torch.train import reconstruction_mse
from shm_tpu_torch.utils.io import load_json
from torch_cli_roots import (
    ROOT, check_threshold_against_committed, check_threshold_against_jax,
    chain_root, run_both,
)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return run_both(tmp_path_factory, "lstm", "threshold")


def test_threshold_matches_the_jax_command(roots):
    port, jax, _ = roots
    check_threshold_against_jax(port, jax)


def test_threshold_is_within_the_envelope_of_the_committed_file(roots):
    port, _, committed = roots
    check_threshold_against_committed(port, committed)


def test_threshold_is_the_p99_of_the_healthy_scores(roots):
    port, _, _ = roots
    out = load_json(port / "processed" / "vae_threshold.json")
    summ = out["score_summary"]
    assert out["threshold"] == summ["normal_val"]["p99"]
    assert out["percentile"] == 99.0 and out["healthy_frac"] == [0.4, 0.7]
    # the gate separates the groups on the validation fraction
    assert summ["sensor_val"]["min"] > out["threshold"]
    assert summ["structural_val"]["min"] > out["threshold"]


def test_sample_draws_from_a_generator_seeded_zero(tmp_path):
    """``--sample``: the same threshold from two runs, the one the generator
    seeded 0 gives through ``reconstruction_mse(sample=True)``, and not the
    posterior mean's. A narrow validation fraction keeps it short."""
    root = chain_root(tmp_path, "lstm")
    paths = cli.Paths(str(root))
    cfg = replace(Stage4DofConfig(), val_frac=(0.4, 0.55))
    runs = [cli.cmd_threshold(paths, cfg, sample=s, plot=False, device="cpu")
            for s in (True, True, False)]
    assert runs[0] == runs[1]
    assert runs[0]["stochastic_eval"] is True and runs[2]["stochastic_eval"] is False
    assert runs[0]["threshold"] != runs[2]["threshold"]

    splits = load_json(paths.run_splits)
    W = np.concatenate([cli.build_fraction_windows(splits[g]["files"],
                                                   cfg.val_frac, cfg)
                        for g in ("normal", "sensor_fault", "structural_fault")])
    mean, std = (torch.from_numpy(a) for a in cli._load_stats(paths))
    Z = normalize_windows(torch.from_numpy(W), mean, std)
    s = reconstruction_mse(cli._load_vae(paths, cfg), Z, sample=True,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    n = runs[0]["n_val_windows_normal"]
    assert runs[0]["threshold"] == float(np.percentile(s[:n], 99))


def test_main_dispatches_the_ported_commands(monkeypatch):
    seen = []
    for name in ("cmd_threshold", "cmd_train_cnn", "cmd_test_pipeline"):
        monkeypatch.setattr(cli, name, lambda paths, cfg, *a, _n=name, **kw:
                            seen.append((_n, str(paths.root), a, kw)))
    cli.main(["threshold", "--root", "r", "--sample", "--no-plots",
              "--device", "cpu"])
    cli.main(["train-cnn", "--root", "r", "--epochs", "2", "--seed", "5"])
    cli.main(["test-pipeline", "--no-plots"])
    assert seen == [
        ("cmd_threshold", "r", (True,), {"plot": False, "device": "cpu"}),
        ("cmd_train_cnn", "r", (2,), {"seed": 5, "plot": True, "device": None,
                                      "devices": None}),
        ("cmd_test_pipeline", "data/4dof", (), {"plot": False, "device": None}),
    ]
    seen.clear()
    for name in ("cmd_gen_normal", "cmd_gen_faults", "cmd_make_splits",
                 "cmd_train_vae"):
        monkeypatch.setattr(cli, name, lambda paths, cfg, *a, _n=name, **kw:
                            seen.append((_n, str(paths.root), a, kw)))
    cli.main(["all", "--root", "r", "--legacy-faults", "--no-plots",
              "--device", "cpu", "--epochs", "1"])
    assert [s[0] for s in seen] == [
        "cmd_gen_normal", "cmd_gen_faults", "cmd_make_splits", "cmd_train_vae",
        "cmd_threshold", "cmd_train_cnn", "cmd_test_pipeline"]
    assert seen[1][3] == {"legacy": True, "device": "cpu"}
    assert all(s[1] == "r" for s in seen)


def test_commands_run_on_the_card_unless_asked_for_the_cpu(tmp_path):
    """With no ``--device`` a command asks for the CUDA card and raises
    without one (no silent drop to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run on it")
    root = chain_root(tmp_path, "lstm")
    for command in ("threshold", "train-cnn", "test-pipeline"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([command, "--root", str(root), "--no-plots"])
    assert (root / "processed" / "vae_threshold.json").read_bytes() == (
        ROOT / "data/4dof/processed/vae_threshold.json").read_bytes()
