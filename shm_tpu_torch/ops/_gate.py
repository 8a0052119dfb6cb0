"""What the fused gate wrappers share: input checks, the pointer array of a
C entry, the one rule of dispatch (a CUDA tensor launches the kernel, a
CPU tensor runs the plain version, nothing gives way), and the 3xTF32
packing of the weights that a kernel multiplies on the tensor cores."""

from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Sequence, Tuple

import torch
import torch.nn.functional as F


def f32(t: torch.Tensor) -> torch.Tensor:
    """A detached contiguous float32 copy or view of ``t``."""
    return t.detach().to(torch.float32).contiguous()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even), kept in float32: the plain
    versions' stand-in for a kernel's bf16 operand or stored value."""
    return t.to(torch.bfloat16).to(torch.float32)


def tf32_round(w: torch.Tensor) -> torch.Tensor:
    """``w`` (float32) rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, kept in float32 with the low 13 bits zero: what
    ``cvt.rna.tf32.f32`` gives on the card."""
    bits = w.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32x3_fragments(w: torch.Tensor) -> torch.Tensor:
    """A weight ``w`` [K, N] (N a multiple of 8) as a kernel's 3xTF32 B
    fragments of ``mma.sync.m16n8k8`` [N/8, ceil(K/8), 32, 4]: for n-tile nt,
    k-step kt and lane (g = lane // 4, t = lane % 4) the float4 {b0 big,
    b1 big, b0 small, b1 small} with b0 = w[8kt + t, 8nt + g],
    b1 = w[8kt + t + 4, 8nt + g], big = :func:`tf32_round` (w) and
    small = :func:`tf32_round` (w - big). Rows past K are zero."""
    w = F.pad(w, (0, 0, 0, -w.shape[0] % 8))
    K, N = w.shape
    big = tf32_round(w)
    small = tf32_round(w - big)
    # [kt, half, t, nt, g] -> [nt, kt, g, t, half]; w[8kt + 4half + t, 8nt + g]
    frag = lambda x: x.reshape(K // 8, 2, 4, N // 8, 8).permute(3, 0, 4, 2, 1)
    return torch.stack([frag(big), frag(small)], dim=-2).reshape(
        N // 8, K // 8, 32, 4).contiguous()


def unpack_fragments(f: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) [K, N] from fragments made by :func:`tf32x3_fragments`."""
    NT, KT = f.shape[:2]
    x = f.reshape(NT, KT, 8, 4, 2, 2).permute(4, 1, 5, 3, 0, 2)
    x = x.reshape(2, 8 * KT, 8 * NT)
    return x[0], x[1]


def check_fragments(weights: Dict[str, torch.Tensor],
                    need: Iterable[str]) -> None:
    """Each ``<name>_frag`` in ``need`` has the shape of
    :func:`tf32x3_fragments` of ``weights[<name>]``."""
    for k in need:
        if k.endswith("_frag"):
            K, N = weights[k[:-len("_frag")]].shape
            if weights[k].shape != (N // 8, -(-K // 8), 32, 4):
                raise ValueError(f"weight {k} {tuple(weights[k].shape)} is not "
                                 f"the fragments of a [{K}, {N}] weight")


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
