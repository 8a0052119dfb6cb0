"""CNN classifier training (counterpart of ``shm_tpu/train/cnn.py``).

Two recipes share the trainer:

- the 4DOF one: cross-entropy, Adam lr 1e-4 with coupled weight decay 5e-5,
  batch 100, at most 50 epochs, early-stop patience 15, the best validation
  loss's epoch kept;
- an inverse-frequency ``class_alpha`` focal loss (gamma 2) with
  ``sample_weights`` drawn as ``WeightedRandomSampler(replacement=True)``
  does (exactly N draws an epoch), and a checkpoint chosen by a validation
  metric (``val_metric_fn``, higher is better) rather than the loss.

Batches keep the JAX trainer's layout exactly. An epoch of N windows in
batches of ``bs`` has ``pad = ceil(N / bs) * bs - N`` extra rows in its last
batch: the first ``pad`` windows of the permutation again (with sampling
weights, window 0). They enter BatchNorm's batch statistics and its running
statistics, and the loss masks them out. The optimizer is
:func:`shm_tpu_torch.train.vae.make_optimizer`, as in the JAX package.

Not ported: the JAX trainer's ``fused_epoch``, a dispatch option of its
compiler with the same math.

``mesh=`` (a :class:`shm_tpu_torch.parallel.Mesh` of one process) trains
data-parallel, the same math as one device, as the JAX trainer does: each
batch and its dropout mask are split into contiguous shards, each shard
runs on its own replica, ``CNN4DOF``'s BatchNorm normalizes by the
statistics of the WHOLE batch (the shards meet at each BatchNorm in lock
step, ``models/cnn.py::forward_shards``, and its running statistics move
once), each shard's loss divides by the whole batch's window count, one
backward runs through every shard, the gradients are summed on the first
device in shard order, then one optimizer step, and the replicas are
refreshed. ``CNNOpenLab``'s GroupNorm is per window and needs nothing.

Noise. All randomness of a run comes from ONE ``torch.Generator`` on the
CPU, seeded with ``cfg.seed``, whatever the training device: one seed draws
the same permutations and masks on the card as on the CPU (as ``jax.random``
does on any device), and each is copied to the device. Drawn in this order: with
``init_params=None``, one integer that seeds the parameter init; then per
epoch the permutation of the training windows (or the N weighted draws),
then per batch fc1's dropout mask [bs, 128]. The numbers differ from the
JAX package's ``jax.random`` streams by nature; :func:`batch_loss`, the
loss of one batch as the trainer computes it without a mesh, takes the
batch and the mask as arguments, so that a test can feed both frameworks
the same.

On CUDA the convolutions run under cuDNN's deterministic algorithms (and
without TF32), and nothing in a step sums with atomics, so two runs from one
seed give the same losses bit for bit.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from shm_tpu_torch.config import TrainConfig
from shm_tpu_torch.device import resolve_device
from shm_tpu_torch.models.cnn import CNN4DOF, forward_shards
from shm_tpu_torch.parallel.mesh import mesh_device
from shm_tpu_torch.train.vae import _batch_plan, _clone_state, make_optimizer

_HIST_KEYS = ("epoch", "train_loss", "val_loss", "val_metric")


def weighted_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                        alpha: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    """Per-sample focal loss ``alpha_y * (1 - p_y)^gamma * (-log p_y)``."""
    ce = -torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    pt = torch.exp(-ce)
    return alpha[labels] * (1.0 - pt) ** gamma * ce


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits, labels, reduction="none")


def batch_loss(model: CNN4DOF, xb: torch.Tensor, yb: torch.Tensor,
               bmask: torch.Tensor, dropout_mask: Optional[torch.Tensor],
               loss_fn: Callable) -> torch.Tensor:
    """The masked mean loss of one batch: ``sum(per * bmask) / max(sum(bmask), 1)``.
    In training mode every row (pad rows too) enters BatchNorm's statistics;
    ``dropout_mask`` is fc1's keep mask [bs, 128]."""
    per = loss_fn(model(xb, dropout_mask=dropout_mask), yb)
    return (per * bmask).sum() / bmask.sum().clamp(min=1.0)


def epoch_order(gen: torch.Generator, N: int, bs: int,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One epoch's window indices as [nb, bs] batches, drawn from ``gen``.

    Without ``weights``: a permutation of the N windows, the last batch
    padded with its first ``pad`` entries. With ``weights`` (probabilities,
    (N,)): exactly N draws with replacement, as ``WeightedRandomSampler``
    makes an epoch, the last batch padded with window 0. The pad rows are
    the ones the trainer's mask zeroes.
    """
    nb, pad = _batch_plan(N, bs)
    if weights is None:
        perm = torch.randperm(N, generator=gen, device=gen.device)
        idx = torch.cat([perm, perm[:pad]]) if pad else perm
    else:
        idx = torch.multinomial(weights, N, replacement=True, generator=gen)
        idx = torch.cat([idx, idx.new_zeros(pad)]) if pad else idx
    return idx.reshape(nb, bs)


@dataclass
class CNNTrainResult:
    variables: Any                  # the state dict of the selected epoch
    history: Dict[str, list] = field(default_factory=dict)
    best_val: float = float("inf")  # val loss at the selected epoch
    best_metric: float = float("-inf")
    best_epoch: int = -1
    stopped_epoch: int = -1
    seconds: float = 0.0


def _loss_fn(loss: str, focal_gamma: float, alpha: torch.Tensor) -> Callable:
    if loss == "focal":
        return lambda out, y: weighted_focal_loss(out, y, alpha, focal_gamma)
    if loss == "ce":
        return cross_entropy_loss
    raise ValueError(f"unknown loss {loss!r} (expected 'ce' or 'focal')")


def _cudnn_flags(device: torch.device):
    """cuDNN's deterministic algorithms, TF32 off, for a CUDA run; a no-op
    context on the CPU."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def train_cnn(
    model: CNN4DOF,
    Xtr,
    ytr,
    Xva,
    yva,
    cfg: TrainConfig,
    *,
    loss: str = "ce",
    focal_gamma: float = 2.0,
    class_alpha: Optional[np.ndarray] = None,
    sample_weights: Optional[np.ndarray] = None,
    val_metric_fn: Optional[Callable[[np.ndarray, np.ndarray], float]] = None,
    init_params: Optional[Dict[str, torch.Tensor]] = None,
    log_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = True,
    device=None,
    mesh=None,
) -> CNNTrainResult:
    """Train ``model`` on NHWC inputs ``Xtr`` (N, T, D, C) with integer
    labels ``ytr`` (numpy or tensors); select the epoch by validation loss (default) or by
    ``val_metric_fn(probs, yva)`` (higher wins) when given.

    ``init_params``: a state dict to start from; None draws fresh parameters
    (consuming one draw of the generator first). The model is moved to
    ``device`` (None = the CUDA card), trained in place, and left in eval
    mode holding the LAST parameters; ``result.variables`` is the state dict
    (parameters and BatchNorm statistics) of the selected epoch.

    ``early_stop_patience`` in ``cfg`` stops after that many epochs without
    improvement (0: never). ``checkpoint_dir`` / ``checkpoint_every=k``
    persist the full training state every k epochs; a later call with
    ``resume=True`` continues the run on the same trajectory.

    ``mesh``: data-parallel training over its devices (the module
    docstring); the model, the data and the selection live on its first
    device (``device`` must be of its type, or None).
    """
    device = mesh_device(mesh, device)
    Xtr, Xva = (torch.as_tensor(a, dtype=torch.float32).to(device)
                for a in (Xtr, Xva))
    ytr, yva = (torch.as_tensor(a, dtype=torch.long).to(device)
                for a in (ytr, yva))
    yva_np = yva.cpu().numpy()
    N, Nva = Xtr.shape[0], Xva.shape[0]
    bs = min(cfg.batch_size, N)
    nb, pad = _batch_plan(N, bs)
    nvb, vpad = _batch_plan(Nva, bs)

    alpha = torch.as_tensor(
        np.ones(model.num_classes) if class_alpha is None else class_alpha,
        dtype=torch.float32, device=device)
    loss_fn = _loss_fn(loss, focal_gamma, alpha)
    weights = None
    if sample_weights is not None:
        w = np.asarray(sample_weights, np.float64)
        weights = torch.as_tensor(w / w.sum(), dtype=torch.float32)

    gen = torch.Generator()
    gen.manual_seed(cfg.seed)
    model.to(device)
    init_consumed = init_params is None
    if init_params is None:
        seed = int(torch.randint(2 ** 62, (1,), generator=gen))
        model.init_parameters(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(init_params)
    opt = make_optimizer(model.parameters(), cfg)

    hist: Dict[str, list] = {k: [] for k in _HIST_KEYS}
    best_val, best_metric, best_epoch = float("inf"), float("-inf"), -1
    best_vars = _clone_state(model)
    patience, bad = cfg.early_stop_patience, 0
    stopped = cfg.epochs
    start_epoch = 1

    ckpt_path = None
    if checkpoint_dir:
        from shm_tpu_torch.train.checkpoint import (
            load_train_ckpt, save_train_ckpt,
        )

        ckpt_path = f"{checkpoint_dir}/cnn_train_state.pt"
        restored = load_train_ckpt(ckpt_path, device) if resume else None
        if restored is not None:
            arrays, meta = restored
            if meta.get("init_consumed", init_consumed) != init_consumed:
                raise ValueError(
                    "checkpoint was written with a different "
                    "init_params-presence than this resume call; the noise "
                    "stream would silently diverge (checkpoint "
                    f"init_consumed={meta['init_consumed']})")
            model.load_state_dict(arrays["params"])
            opt.load_state_dict(arrays["opt_state"])
            best_vars = arrays["best_vars"]
            gen.set_state(arrays["rng"].cpu())
            hist = meta["history"]
            best_val, best_metric = meta["best_val"], meta["best_metric"]
            best_epoch, bad = meta["best_epoch"], meta["bad"]
            start_epoch = meta["epoch"] + 1
            print(f"[resume] restored epoch {meta['epoch']} from {ckpt_path}")

    train_mask = torch.cat([torch.ones(N, device=device),
                            torch.zeros(pad, device=device)]).reshape(nb, bs)
    val_idx = torch.cat([torch.arange(Nva, device=device),
                         torch.zeros(vpad, dtype=torch.long, device=device)]
                        ).reshape(nvb, bs)
    val_mask = torch.cat([torch.ones(Nva, device=device),
                          torch.zeros(vpad, device=device)]).reshape(nvb, bs)
    units = model.fc1.out_features
    replicas, loss_fns = [model], [loss_fn]
    if mesh is not None:
        from shm_tpu_torch.parallel.mesh import (replicas_of, shard_slices,
                                                 sum_grads, sync_replicas)

        replicas = replicas_of(model, mesh)
        loss_fns = [_loss_fn(loss, focal_gamma, alpha.to(d))
                    for d in mesh.devices]

    def shard_sums(xb, yb, bmask, keep):
        """The masked loss sum of each shard of one batch (one shard without
        a mesh), on the first device, and the batch's logits by shard."""
        if mesh is None:
            outs = [model(xb, dropout_mask=keep)]
            return [(loss_fn(outs[0], yb) * bmask).sum()], outs
        sls = shard_slices(xb.shape[0], len(mesh.devices))
        outs = forward_shards(
            replicas, [xb[sl].to(d) for sl, d in zip(sls, mesh.devices)],
            None if keep is None else [keep[sl].to(d)
                                       for sl, d in zip(sls, mesh.devices)])
        return [(fn(o, yb[sl].to(o.device)) * bmask[sl].to(o.device))
                .sum().to(device)
                for fn, o, sl in zip(loss_fns, outs, sls)], outs

    def train_epoch() -> torch.Tensor:
        for m in replicas:
            m.train()
        idx = epoch_order(gen, N, bs, weights).to(device)
        ls, ns = [], []
        for b in range(nb):
            bmask = train_mask[b]
            keep = (torch.rand(bs, units, generator=gen)
                    < 1.0 - model.dropout).to(device)
            opt.zero_grad()
            sums, _ = shard_sums(Xtr[idx[b]], ytr[idx[b]], bmask, keep)
            l = torch.stack(sums).sum() / bmask.sum().clamp(min=1.0)
            l.backward()
            if mesh is not None:
                sum_grads(replicas, mesh)
            opt.step()
            if mesh is not None:
                sync_replicas(replicas)
            n = bmask.sum()
            ls.append(l.detach() * n)
            ns.append(n)
        return torch.stack(ls).sum() / torch.stack(ns).sum().clamp(min=1.0)

    @torch.no_grad()
    def val_epoch():
        for m in replicas:
            m.eval()
        ls, ns, probs = [], [], []
        for b in range(nvb):
            bmask = val_mask[b]
            sums, outs = shard_sums(Xva[val_idx[b]], yva[val_idx[b]], bmask,
                                    None)
            ls.append(torch.stack(sums).sum())
            ns.append(bmask.sum())
            probs.append(torch.cat([torch.softmax(o, dim=-1).to(device)
                                    for o in outs]))
        vloss = torch.stack(ls).sum() / torch.stack(ns).sum().clamp(min=1.0)
        return vloss, torch.cat(probs)[:Nva]

    t0 = time.perf_counter()
    with _cudnn_flags(device):
        for epoch in range(start_epoch, cfg.epochs + 1):
            tl = train_epoch()
            vl, vprobs = val_epoch()
            # ONE host fetch per epoch (plus the probabilities for a metric)
            tl, vl = torch.stack([tl, vl]).tolist()
            metric = (float(val_metric_fn(vprobs.cpu().numpy(), yva_np))
                      if val_metric_fn is not None else None)
            for k, v in zip(_HIST_KEYS, (epoch, tl, vl, metric)):
                hist[k].append(v)
            if log_every and epoch % log_every == 0:
                m = f" | metric={metric:.4f}" if metric is not None else ""
                print(f"[cnn] epoch {epoch:03d}/{cfg.epochs} | train={tl:.6f} "
                      f"| val={vl:.6f}{m}")

            improved = (metric > best_metric if val_metric_fn is not None
                        else vl < best_val)
            if improved:
                best_val, best_epoch, bad = vl, epoch, 0
                if metric is not None:
                    best_metric = metric
                best_vars = _clone_state(model)
            else:
                bad += 1
                if patience and bad >= patience:
                    stopped = epoch
                    break

            if ckpt_path and checkpoint_every and epoch % checkpoint_every == 0:
                save_train_ckpt(
                    ckpt_path,
                    {"params": model.state_dict(), "opt_state": opt.state_dict(),
                     "best_vars": best_vars, "rng": gen.get_state()},
                    {"epoch": epoch, "best_val": best_val,
                     "best_metric": best_metric, "best_epoch": best_epoch,
                     "bad": bad, "history": hist,
                     "init_consumed": init_consumed})

    model.eval()
    return CNNTrainResult(
        variables=best_vars, history=hist, best_val=best_val,
        best_metric=best_metric, best_epoch=best_epoch, stopped_epoch=stopped,
        seconds=time.perf_counter() - t0)


@torch.no_grad()
def predict_probs(model: CNN4DOF, X, batch_size: int = 4096,
                  device=None) -> np.ndarray:
    """Softmax probabilities of NHWC inputs in batches (eval mode: running
    BatchNorm statistics, no dropout). The model is moved to ``device``
    (None = the CUDA card)."""
    device = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32)
    if X.shape[0] == 0:
        return np.zeros((0, model.num_classes), np.float32)
    model.to(device).eval()
    out = [torch.softmax(model(xb.to(device)), dim=-1).cpu()
           for xb in X.split(batch_size)]
    return torch.cat(out).numpy().astype(np.float32)


__all__ = ["weighted_focal_loss", "cross_entropy_loss", "batch_loss",
           "epoch_order", "train_cnn", "predict_probs", "CNNTrainResult"]
