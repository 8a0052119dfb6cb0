"""The fault-attribution CNNs (counterpart of ``shm_tpu/models/cnn.py``):
``CNN4DOF`` and the bridge stage's ``CNNOpenLab`` (at the end).

Input stays NHWC (B, T=100, D=12, C=2) at the public boundary, as in the JAX
package; inside, the convolutions run NCHW through ``F.conv2d`` (the JAX
package leaves them to XLA too). Topology: 2x [Conv3x3 SAME -> BatchNorm
(eps 1e-5) -> ReLU -> MaxPool2x2] -> flatten (32*25*3 = 2400) -> fc1 128
-> ReLU -> Dropout(0.5) -> fc2. ``fc1``'s weight columns are stored in NCHW
flatten order (c, t, d); :mod:`shm_tpu_torch.convert` permutes the JAX
(t, d, c) rows once.

Training mode follows flax's ``nn.BatchNorm`` and ``nn.Dropout``: BatchNorm
normalizes by the batch's statistics and moves its running statistics with
flax's momentum 0.9 (torch's ``momentum=0.1``), the running variance from
the BIASED batch variance (torch's own ``BatchNorm2d`` would use the
unbiased one); dropout keeps each fc1 unit with probability 0.5 and scales
the kept ones by 2. In eval mode (the default) it is the inference model.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters and buffers, so the same state
    dict) whose training mode moves the running statistics as flax's
    ``nn.BatchNorm(momentum=0.9)`` does: ``r = 0.9 r + 0.1 s`` with ``s`` the
    batch mean and the biased batch variance over (N, H, W)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class CNN4DOF(nn.Module):
    #: the (conv, BatchNorm) stages, each then ReLU and a 2x2 max pool:
    #: (B,16,50,6), then (B,32,25,3); :func:`forward_shards` walks them too
    STAGES = (("conv1", "bn1"), ("conv2", "bn2"))

    def __init__(self, num_classes: int = 2, seq_len: int = 100,
                 num_features: int = 12, dropout: float = 0.5):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = dropout
        self.conv1 = nn.Conv2d(2, 16, 3, padding=1)
        self.bn1 = FlaxBatchNorm2d(16, eps=1e-5)
        self.conv2 = nn.Conv2d(16, 32, 3, padding=1)
        self.bn2 = FlaxBatchNorm2d(32, eps=1e-5)
        flat = 32 * (seq_len // 4) * (num_features // 4)
        self.fc1 = nn.Linear(flat, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.eval()

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh parameters, as the JAX model draws them: Xavier-uniform
        kernels, zero biases, BatchNorm at (1, 0) with running statistics
        (0, 1). ``generator`` is a CPU generator; the values are copied to
        the module's device."""
        for layer in (self.conv1, self.conv2, self.fc1, self.fc2):
            w = torch.empty(layer.weight.shape)
            nn.init.xavier_uniform_(w, generator=generator)
            with torch.no_grad():
                layer.weight.copy_(w)
                layer.bias.zero_()
        for bn in (self.bn1, self.bn2):
            bn.reset_parameters()

    def forward(self, x: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, D, 2) NHWC -> (B, num_classes) float32 logits.

        ``dropout_mask``: in training mode, the units of fc1 to keep, a
        (B, 128) boolean tensor (None draws one from torch's global
        generator); ignored in eval mode.
        """
        x = x.permute(0, 3, 1, 2)                                  # NCHW
        for conv, bn in self.STAGES:
            x = F.max_pool2d(F.relu(getattr(self, bn)(getattr(self, conv)(x))),
                             2)
        return self.head(x, dropout_mask)

    def head(self, x: torch.Tensor,
             dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """fc1 -> ReLU -> dropout -> fc2 on the pooled (B, 32, 25, 3)
        features."""
        x = F.relu(self.fc1(x.flatten(1)))
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            if dropout_mask is None:
                dropout_mask = torch.rand_like(x) < keep
            x = torch.where(dropout_mask, x / keep, torch.zeros_like(x))
        return self.fc2(x)


def batch_norm_shards(bns, hs):
    """Training-mode BatchNorm of one batch split into shards ``hs`` (NCHW,
    in order, one :class:`FlaxBatchNorm2d` replica each): the mean and the
    biased variance over the WHOLE batch, summed on the first shard's
    device and sent back to each shard (autograd carries the gradient back
    the same way), and the running statistics of ``bns[0]`` moved once."""
    dev0 = hs[0].device
    n = sum(h.numel() // h.shape[1] for h in hs)
    mean = torch.stack([h.sum(dim=(0, 2, 3)).to(dev0) for h in hs]).sum(0) / n
    cs = [h - mean.to(h.device)[None, :, None, None] for h in hs]
    var = torch.stack([(c * c).sum(dim=(0, 2, 3)).to(dev0)
                       for c in cs]).sum(0) / n
    bn = bns[0]
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
        bn.running_var.copy_((1 - m) * bn.running_var + m * var)
        bn.num_batches_tracked.add_(1)
    col = lambda t: t[None, :, None, None]
    return [c * col(torch.rsqrt(var.to(c.device) + b.eps) * b.weight)
            + col(b.bias) for c, b in zip(cs, bns)]


def forward_shards(models, xs, dropout_masks=None):
    """The forward of one batch split over model replicas (shard ``i`` of
    ``xs`` through ``models[i]``, on its device), as one model would run the
    whole batch. For ``CNN4DOF`` in training mode the shards meet at each
    BatchNorm in lock step (:func:`batch_norm_shards`: the whole batch's
    statistics); otherwise each shard runs alone (GroupNorm and eval mode
    need nothing from the others). ``dropout_masks``: fc1's keep mask of
    each shard. Returns each shard's logits."""
    masks = dropout_masks or [None] * len(xs)
    if not (isinstance(models[0], CNN4DOF) and models[0].training):
        return [m(x, dropout_mask=k) for m, x, k in zip(models, xs, masks)]
    hs = [x.permute(0, 3, 1, 2) for x in xs]
    for conv, bn in CNN4DOF.STAGES:
        hs = batch_norm_shards([getattr(m, bn) for m in models],
                               [getattr(m, conv)(h) for m, h in zip(models, hs)])
        hs = [F.max_pool2d(F.relu(h), 2) for h in hs]
    return [m.head(h, k) for m, h, k in zip(models, hs, masks)]


def stack_vae_residual_nhwc(Z: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """2-channel CNN input [Z, (Z - Z_hat)^2] as NHWC (B, T, D, 2)."""
    return torch.stack([Z, (Z - recon) ** 2], dim=-1)


# the openLAB CNN's blocks: (output channels, kernel height); width 3 each
OPENLAB_BLOCKS = ((32, 7), (64, 5), (128, 5), (256, 3))


def _kaiming_normal_(w: torch.Tensor, fan_in: int,
                     generator: Optional[torch.Generator]) -> None:
    """flax's ``kaiming_normal``: a normal truncated at two standard
    deviations, scaled so that the variance is ``2 / fan_in``."""
    std = (2.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


class CNNOpenLab(nn.Module):
    """The openLAB CNN. NHWC (B, T=200, D=4, C=1) in, (B, num_classes)
    logits out. Four blocks of [Conv (kt x 3) SAME -> GroupNorm(8, eps 1e-5)
    -> SiLU], kt = 7, 5, 5, 3 and widths 32, 64, 128, 256, a time-only max
    pool (2, 1) after each of the first three, the mean over (T, D), then
    fc1 128 -> SiLU -> dropout -> fc2. GroupNorm keeps no running
    statistics, so training and eval mode differ only in the dropout. The
    convolutions run NCHW through ``F.conv2d`` (cuDNN on the card).

    Training mode takes the JAX model's dropout (keep each fc1 unit with
    probability ``1 - dropout``, scale the kept ones); in eval mode (the
    default) it is the inference model.
    """

    def __init__(self, num_classes: int = 2, dropout: float = 0.4):
        super().__init__()
        self.num_classes = num_classes
        self.dropout = dropout
        cin = 1
        for i, (cout, kt) in enumerate(OPENLAB_BLOCKS, start=1):
            setattr(self, f"b{i}_conv",
                    nn.Conv2d(cin, cout, (kt, 3), padding=(kt // 2, 1)))
            setattr(self, f"b{i}_gn", nn.GroupNorm(8, cout, eps=1e-5))
            cin = cout
        self.fc1 = nn.Linear(cin, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.eval()

    def init_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Fresh parameters, as the JAX model draws them: kaiming-normal
        (truncated) kernels, zero biases, GroupNorm at (1, 0).
        ``generator`` is a CPU generator; the values are copied to the
        module's device."""
        layers = [getattr(self, f"b{i}_conv")
                  for i in range(1, len(OPENLAB_BLOCKS) + 1)] + [self.fc1, self.fc2]
        for layer in layers:
            w = torch.empty(layer.weight.shape)
            _kaiming_normal_(w, layer.weight[0].numel(), generator)
            with torch.no_grad():
                layer.weight.copy_(w)
                layer.bias.zero_()
        for i in range(1, len(OPENLAB_BLOCKS) + 1):
            getattr(self, f"b{i}_gn").reset_parameters()

    def forward(self, x: torch.Tensor,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, D, 1) NHWC -> (B, num_classes) float32 logits.

        ``dropout_mask``: in training mode, the units of fc1 to keep, a
        (B, 128) boolean tensor (None draws one from torch's global
        generator); ignored in eval mode.
        """
        x = x.permute(0, 3, 1, 2)                                  # NCHW
        n = len(OPENLAB_BLOCKS)
        for i in range(1, n + 1):
            x = F.silu(getattr(self, f"b{i}_gn")(getattr(self, f"b{i}_conv")(x)))
            if i < n:
                x = F.max_pool2d(x, (2, 1))                        # T halves
        x = F.silu(self.fc1(x.mean(dim=(2, 3))))
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            if dropout_mask is None:
                dropout_mask = torch.rand_like(x) < keep
            x = torch.where(dropout_mask, x / keep, torch.zeros_like(x))
        return self.fc2(x)


__all__ = ["CNN4DOF", "CNNOpenLab", "FlaxBatchNorm2d", "batch_norm_shards",
           "forward_shards", "stack_vae_residual_nhwc"]
