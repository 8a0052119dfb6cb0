"""CNN4DOF fault-attribution classifier, inference (counterpart of ``shm_tpu/models/cnn.py``).

Input stays NHWC (B, T=100, D=12, C=2) at the public boundary, as in the JAX
package; inside, the convolutions run NCHW through ``F.conv2d`` (the JAX
package leaves them to XLA too). Topology: 2x [Conv3x3 SAME -> BatchNorm
(eval, eps 1e-5) -> ReLU -> MaxPool2x2] -> flatten (32*25*3 = 2400) -> fc1 128
-> ReLU -> fc2. ``fc1``'s weight columns are stored in NCHW flatten order
(c, t, d); :mod:`shm_tpu_torch.convert` permutes the JAX (t, d, c) rows once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class CNN4DOF(nn.Module):
    def __init__(self, num_classes: int = 2, seq_len: int = 100,
                 num_features: int = 12):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 16, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(16, eps=1e-5)
        self.conv2 = nn.Conv2d(16, 32, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(32, eps=1e-5)
        flat = 32 * (seq_len // 4) * (num_features // 4)
        self.fc1 = nn.Linear(flat, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, D, 2) NHWC -> (B, num_classes) float32 logits."""
        x = x.permute(0, 3, 1, 2)                                  # NCHW
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 2)       # (B,16,50,6)
        x = F.max_pool2d(F.relu(self.bn2(self.conv2(x))), 2)       # (B,32,25,3)
        x = F.relu(self.fc1(x.flatten(1)))
        return self.fc2(x)


def stack_vae_residual_nhwc(Z: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """2-channel CNN input [Z, (Z - Z_hat)^2] as NHWC (B, T, D, 2)."""
    return torch.stack([Z, (Z - recon) ** 2], dim=-1)


__all__ = ["CNN4DOF", "stack_vae_residual_nhwc"]
