"""Device selection and f32 precision policy for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    There is no silent drop to the CPU: with ``device=None`` and no CUDA
    runtime this raises, and a CPU run has to ask for ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_full_f32_precision() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits); the port's f32 path must match the JAX reference, so TF32 is
    switched off for both matmuls and convolutions.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def command_device(device=None) -> torch.device:
    """A command's device (:func:`resolve_device`); on the card float32
    matmuls and convolutions are set to stay full float32 (no TF32)."""
    device = resolve_device(device)
    if device.type == "cuda":
        set_full_f32_precision()
    return device


__all__ = ["resolve_device", "set_full_f32_precision", "command_device"]
