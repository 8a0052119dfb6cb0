"""What the fused gate wrappers share: input checks, the pointer array of a
C entry, and the one rule of dispatch (a CUDA tensor launches the kernel, a
CPU tensor runs the plain version, nothing gives way)."""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Sequence

import torch


def f32(t: torch.Tensor) -> torch.Tensor:
    """A detached contiguous float32 copy or view of ``t``."""
    return t.detach().to(torch.float32).contiguous()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), kept in float32: the plain
    versions' stand-in for a kernel's bf16 operand or stored value."""
    return t.to(torch.bfloat16).to(torch.float32)


def check_windows(Z: torch.Tensor) -> None:
    if Z.dtype != torch.float32 or Z.dim() != 3 or not Z.is_contiguous():
        raise ValueError(f"Z must be a contiguous float32 [N, T, D] tensor, "
                         f"got {Z.dtype} {tuple(Z.shape)}")


def check_weights(weights: Dict[str, torch.Tensor], need: Iterable[str],
                  device: torch.device) -> None:
    need = list(need)
    missing = [k for k in need if k not in weights]
    if missing:
        raise ValueError(f"weights missing: {', '.join(missing)}")
    for k in need:
        w = weights[k]
        if (w.device != device or w.dtype != torch.float32
                or not w.is_contiguous()):
            raise ValueError(f"weight {k} must be contiguous float32 on "
                             f"{device}")


def pointer_array(weights: Dict[str, torch.Tensor], order: Sequence[str],
                  need: Iterable[str]):
    """``void*[len(order)]`` of the weights' device pointers, null where a
    name is not in ``need``."""
    need = set(need)
    return (ctypes.c_void_p * len(order))(
        *[weights[k].data_ptr() if k in need else None for k in order])


def dispatch_gate(name: str, Z: torch.Tensor, launch, reference, weights,
                  **kw):
    if Z.device.type == "cuda":
        return launch(weights, Z, **kw)
    if Z.device.type == "cpu":
        return reference(weights, Z, **kw)
    raise ValueError(f"{name}: unsupported device {Z.device}")
