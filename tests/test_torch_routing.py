"""The port's fused-gate routing rule against the JAX package's.

``shm_tpu_torch.ops.auto_fused_gate(model, device)`` decides, before any
launch, whether a surface that defaults its fused flag runs the cell's fused
kernel on the card or the plain modules. It must send a model to the plain
modules exactly where ``shm_tpu.ops.auto_fused_gate(model)`` computes on XLA
on its chip: an attention VAE of H not a multiple of 32 or past 128, any
cell at L not 1 or 2, a cell with no kernel. The one deliberate difference:
the port's minGRU kernel takes 3 and 4 layers and keeps them. The JAX rule
asks its backend first; here ``shm_tpu.ops.is_tpu_backend`` is stubbed to
True, so only its shape clauses are compared. Both rules read nothing but
the model's ``cell``, ``hidden_dim`` and ``num_layers``.
"""

from types import SimpleNamespace

import pytest
import torch

import shm_tpu.ops as jax_ops
from shm_tpu.config import VAEConfig as JaxVAEConfig
from shm_tpu.models import vae_from_config as jax_vae_from_config
from shm_tpu_torch import ops
from shm_tpu_torch.models import TemporalVAE

torch.set_num_threads(1)      # see tests/test_torch_vae_gate.py

HIDDEN = (8, 32, 48, 64, 96, 100, 128, 160, 256)
LAYERS = (1, 2, 3, 4, 5)


@pytest.fixture()
def jax_rule(monkeypatch):
    """The JAX package's rule with its backend taken for a TPU."""
    monkeypatch.setattr(jax_ops, "is_tpu_backend", lambda: True)
    return jax_ops.auto_fused_gate


def _deliberate(cell: str, L: int) -> bool:
    """Where the port keeps its kernel and the JAX rule computes on XLA."""
    return cell == "min_gru" and L in (3, 4)


@pytest.mark.parametrize("cell", ["lstm", "min_gru", "attention", "gru"])
def test_rule_is_the_jax_rule_on_the_card(jax_rule, cell):
    for H in HIDDEN:
        for L in LAYERS:
            model = SimpleNamespace(cell=cell, hidden_dim=H, num_layers=L)
            want = jax_rule(model) or _deliberate(cell, L)
            assert ops.auto_fused_gate(model, "cuda") is want, (cell, H, L)
            assert ops.auto_fused_gate(model, torch.device("cuda:0")) is want
            assert ops.auto_fused_gate(model, "cpu") is False


@pytest.mark.parametrize("cell, H, L, kernel", [
    ("lstm", 128, 2, True), ("lstm", 48, 1, True), ("lstm", 128, 3, False),
    ("lstm", 160, 2, True),             # the JAX kernel's: the port raises
    ("min_gru", 96, 2, True), ("min_gru", 64, 4, True), ("min_gru", 32, 5, False),
    ("attention", 128, 2, True), ("attention", 64, 3, False),
    ("attention", 48, 1, False), ("attention", 256, 1, False),
])
def test_rule_on_the_models_of_both_packages(jax_rule, cell, H, L, kernel):
    """The models themselves (the port's ``TemporalVAE``, the flax one)
    carry what the rules read; on the card the port's rule gives ``kernel``,
    the JAX rule the same but for the deliberate difference."""
    port = TemporalVAE(5, 4, H, L, cell=cell)
    jax_model = jax_vae_from_config(JaxVAEConfig(5, 4, H, L, 0.0, cell=cell))
    assert ops.auto_fused_gate(port, "cuda") is kernel
    assert jax_rule(jax_model) is (kernel and not _deliberate(cell, L))
    assert ops.auto_fused_gate(port, "cpu") is False


def test_a_routed_shape_past_the_ports_bound_is_refused_not_rerouted():
    """An LSTM of H=160 is inside the JAX kernel's reach, so the rule sends
    it to the port's kernel, whose checks refuse it before a launch: nothing
    gives way to the plain modules."""
    from shm_tpu_torch.ops import fused_vae

    model = TemporalVAE(5, 4, 160, 2)
    assert ops.auto_fused_gate(model, "cuda")
    weights_fn, _ = ops.fused_gate_for(model)
    with pytest.raises(ValueError, match="unsupported shape.*H=160"):
        fused_vae._check(weights_fn(model), torch.zeros(2, 6, 5), 2, True)
