"""The port's ``test-pipeline`` on a copy of ``data/4dof_mingru``, on the
CPU, against the JAX package's command and the committed
``figures/pipeline_metrics.json`` (as
``tests/test_torch_cli_test_pipeline.py`` for ``data/4dof``; tolerances:
``tests/torch_cli_roots.py``). Here the float32 path reproduces the
committed confusion matrix exactly."""

import pytest

from torch_cli_roots import (
    check_pipeline_against_committed, check_pipeline_against_jax, load, run_both,
)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return run_both(tmp_path_factory, "min_gru", "test-pipeline")


def test_pipeline_metrics_match_the_jax_command(roots):
    port, jax, _ = roots
    check_pipeline_against_jax(port, jax)


def test_pipeline_metrics_are_within_the_limits_of_the_committed_files(roots):
    port, _, committed = roots
    check_pipeline_against_committed(port, committed, "min_gru")
    got, want = (load(r, "figures/pipeline_metrics.json") for r in (port, committed))
    assert got["confusion_matrix_counts"] == want["confusion_matrix_counts"]
