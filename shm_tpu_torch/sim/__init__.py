"""Structural simulation and fault injection (counterpart of ``shm_tpu/sim``).

``prng`` mirrors the ``jax.random`` draws the JAX simulators make; the
Newmark integrators and the 1-DOF signal variants (``signals``) run in plain
PyTorch on the device.
"""

from shm_tpu_torch.sim.faults import (
    FAULT_KINDS,
    SENSOR_FAULT_CASES,
    inject_bias,
    inject_drift,
    inject_noise,
    inject_sensor_fault_triplet,
    inject_spikes,
)
from shm_tpu_torch.sim.forces import smoothed_gaussian_force, smoothed_gaussian_force_np
from shm_tpu_torch.sim.newmark import (
    chain_stiffness_matrix,
    compute_matrices,
    newmark_ndof,
    rayleigh_damping,
    simulate_free_vibration_sdof,
    simulate_runs,
)
from shm_tpu_torch.sim.signals import (
    SEEN_COLUMNS,
    UNSEEN_COLUMNS,
    make_clean_variants,
    make_unseen_variants,
    variants_to_matrix,
)

__all__ = [
    "simulate_free_vibration_sdof",
    "chain_stiffness_matrix",
    "rayleigh_damping",
    "compute_matrices",
    "newmark_ndof",
    "simulate_runs",
    "smoothed_gaussian_force",
    "smoothed_gaussian_force_np",
    "inject_noise",
    "inject_spikes",
    "inject_drift",
    "inject_bias",
    "inject_sensor_fault_triplet",
    "SENSOR_FAULT_CASES",
    "FAULT_KINDS",
    "make_clean_variants",
    "make_unseen_variants",
    "variants_to_matrix",
    "SEEN_COLUMNS",
    "UNSEEN_COLUMNS",
]
