"""The port's 1-DOF ``train-vae --cell min_gru`` / ``attention`` on the CPU
against the JAX package, as ``tests/test_torch_cli_stage1dof_train.py``
holds the LSTM (shared checks and tolerances:
``tests/torch_stage1dof_train.py``)."""

import pytest
import torch

from chip_smoke import STAGE1_TABLES
from torch_stage1dof_train import (
    check_jax_load_model, check_test_seen_tables, check_train_vae_artifacts,
    train_and_test_seen,
)

torch.set_num_threads(1)

CELLS = ["min_gru", "attention"]


@pytest.fixture(scope="module", params=CELLS)
def trained(request, tmp_path_factory):
    return train_and_test_seen(tmp_path_factory, request.param)


def test_train_vae_artifacts(trained):
    cell, root, _ = trained
    check_train_vae_artifacts(cell, root)


def test_jax_load_model_restores_the_port_checkpoint(trained):
    cell, root, _ = trained
    check_jax_load_model(cell, root)


@pytest.mark.parametrize("rel", STAGE1_TABLES[:2])
def test_jax_test_seen_gives_the_port_s_tables(trained, rel):
    _, root, jax_root = trained
    check_test_seen_tables(root, jax_root, rel)
