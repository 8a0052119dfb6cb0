"""The port's ``threshold`` on a copy of ``data/4dof_attention``, on the CPU,
against the JAX package's command and the committed
``processed/vae_threshold.json`` (as ``tests/test_torch_cli_threshold.py``
for ``data/4dof``; tolerances: ``tests/torch_cli_roots.py``)."""

import pytest

from torch_cli_roots import (
    check_threshold_against_committed, check_threshold_against_jax, run_both,
)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return run_both(tmp_path_factory, "attention", "threshold")


def test_threshold_matches_the_jax_command(roots):
    port, jax, _ = roots
    check_threshold_against_jax(port, jax)


def test_threshold_is_within_the_envelope_of_the_committed_file(roots):
    port, _, committed = roots
    check_threshold_against_committed(port, committed)
