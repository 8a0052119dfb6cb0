"""The port's ``test-pipeline`` command on a copy of ``data/4dof`` (LSTM
gate, the committed CNN and threshold), on the CPU, against the JAX
package's command on another copy and against the committed
``figures/pipeline_metrics.json`` and its two split files. The other two
roots: ``test_torch_cli_test_pipeline_{mingru,attention}.py`` (one root a
file, so that pytest-xdist spreads them over its workers). Tolerances:
``tests/torch_cli_roots.py``.
"""

import pytest

from shm_tpu_torch.utils.io import load_json
from torch_cli_roots import (
    check_pipeline_against_committed, check_pipeline_against_jax, run_both,
)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return run_both(tmp_path_factory, "lstm", "test-pipeline")


def test_pipeline_metrics_match_the_jax_command(roots):
    port, jax, _ = roots
    check_pipeline_against_jax(port, jax)


def test_pipeline_metrics_are_within_the_limits_of_the_committed_files(roots):
    port, _, committed = roots
    check_pipeline_against_committed(port, committed, "lstm")


def test_the_float32_path_moves_the_two_known_windows(roots):
    """The committed matrix was made at another matmul precision; any
    float32 evaluation, the JAX package's included, moves the same 2."""
    port, _, committed = roots
    got = load_json(port / "figures" / "pipeline_metrics.json")
    want = load_json(committed / "figures" / "pipeline_metrics.json")
    assert want["confusion_matrix_counts"] == [[2020, 0, 0], [0, 795, 13], [0, 10, 798]]
    assert got["confusion_matrix_counts"] == [[2020, 0, 0], [0, 796, 12], [0, 11, 797]]
    assert got["gate"]["precision"] == got["gate"]["recall"] == 1.0
    assert got["gate"]["average_precision"] == got["gate"]["gate_auroc"] == 1.0


def test_report_lists_every_class_and_average(roots):
    port, _, _ = roots
    text = (port / "figures" / "pipeline_classification_report.txt").read_text()
    keys = [line.split(": ", 1)[0] for line in text.splitlines()]
    assert keys == ["Normal", "Sensor Fault", "Structural Fault", "accuracy",
                    "macro avg", "weighted avg"]
