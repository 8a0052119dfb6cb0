"""The trained 4DOF workload the probes run on, a CUDA-event timer, and the
card's peak rates with the bound they give.

Counterpart of ``bench.py::load_trained_workload``: the committed trained
VAE and CNN of ``data/4dof``, the 3,636 test windows (the
``Stage4DofConfig.test_frac`` slice of every normal and faulty run), the
normalization statistics and the gate threshold, read with the port's own
loaders.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from shm_tpu_torch.cli.stage4dof import (
    Paths, _load_stats, _load_vae, build_fraction_windows,
)
from shm_tpu_torch.config import Stage4DofConfig
from shm_tpu_torch.convert import cnn4dof_from_flax
from shm_tpu_torch.models.cnn import CNN4DOF
from shm_tpu_torch.models.vae import TemporalVAE
from shm_tpu_torch.utils.checkpoint import load_checkpoint
from shm_tpu_torch.utils.io import load_json

ROOT_4DOF = Path(__file__).resolve().parents[2] / "data" / "4dof"

# one H100's published peaks (NVIDIA data sheet, SXM part, dense rates at the
# 700 W power limit)
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12        # TF32 on the tensor cores
PEAK_BYTES = 3.35e12            # HBM3
N_SMS = 132


@dataclass
class TrainedWorkload:
    vae: TemporalVAE          # on the CPU
    cnn: CNN4DOF              # on the CPU
    W: np.ndarray             # [N, T, D] float32 raw test windows
    y: np.ndarray             # [N] 0 normal, 1 sensor fault, 2 structural
    mean: np.ndarray          # [D]
    std: np.ndarray           # [D]
    threshold: float


def load_trained_workload(root: Path | str = ROOT_4DOF) -> TrainedWorkload:
    cfg = Stage4DofConfig()
    paths = Paths(str(root))
    mean, std = _load_stats(paths)
    vae = _load_vae(paths, cfg)
    cnn = cnn4dof_from_flax(load_checkpoint(paths.models / "cnn.msgpack"),
                            cfg.cnn.num_classes, cfg.seq_len, cfg.num_features)
    thr = float(load_json(paths.processed / "vae_threshold.json")["threshold"])
    splits = load_json(paths.run_splits)
    groups = [build_fraction_windows(splits[g]["files"], cfg.test_frac, cfg)
              for g in ("normal", "sensor_fault", "structural_fault")]
    y = np.concatenate([np.full(len(g), i) for i, g in enumerate(groups)])
    return TrainedWorkload(vae, cnn, np.concatenate(groups).astype(np.float32),
                           y, mean, std, thr)


def timed(fn: Callable[[], object], reps: int = 7, warm: int = 2) -> float:
    """Median device milliseconds of ``fn()`` over ``reps`` runs, each
    between two CUDA events, after ``warm`` runs."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return float(np.median(ts))


def bound_ms(flops: float, nbytes: float, peak_flops: float):
    """(ms, "operations" | "bytes"): the least time the card could take, the
    larger of ``flops`` over ``peak_flops`` (the rate of the operands' type)
    and ``nbytes`` over the memory rate, and which of the two it is."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


__all__ = ["TrainedWorkload", "load_trained_workload", "timed", "bound_ms",
           "ROOT_4DOF", "PEAK_F32_FLOPS", "PEAK_BF16_FLOPS", "PEAK_TF32_FLOPS",
           "PEAK_BYTES",
           "N_SMS"]
