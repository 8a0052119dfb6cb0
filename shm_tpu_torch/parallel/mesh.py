"""Data parallelism over the devices of one process (counterpart of
``shm_tpu/parallel/mesh.py``).

The scale axis of this workload is the window count (thousands of
overlapping windows per run; the models are under 1M parameters), so the
strategy is pure data parallelism, as in the JAX package:

- the parameters are replicated: one copy of each module a device;
- the window batch is split into contiguous shards along dim 0, in device
  order (the order ``P("data")`` gives in JAX);
- training sums the shards' gradients (and, across processes,
  ``torch.distributed.all_reduce`` sums them; :mod:`.distributed`), then
  takes one optimizer step and refreshes the replicas;
- bulk inference scores each shard on its device and needs no collective.

A :class:`Mesh` is an ordered tuple of ``torch.device``\\ s with the axis
name ``"data"``. On the card :func:`make_mesh` takes the first ``n`` of
``torch.cuda.device_count()``; ``device="cpu"`` gives ``n`` shards on the
CPU, the counterpart of the forced host device count
(``--xla_force_host_platform_device_count``) the JAX tests run under: the
same split, per-shard passes and sums as a mesh of cards, on one CPU. A mesh
may name one card more than once (``Mesh((cuda0, cuda0))``): two shards on
one card, which runs the multi-device code on CUDA tensors on a one-card
host.

Tensor, pipeline and sequence parallelism are not implemented, as in the
JAX package: every model fits one device with room to spare.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from shm_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A 1-D data mesh: this process's devices, in shard order.

    ``process_index`` / ``num_processes`` place the process in a global
    mesh (:func:`shm_tpu_torch.parallel.distributed.make_global_mesh`):
    shards are numbered process-major, so this process holds shards
    ``first_shard .. first_shard + len(devices) - 1`` of ``size``.
    """

    devices: Tuple[torch.device, ...]
    axis: str = "data"
    process_index: int = 0
    num_processes: int = 1

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))

    @property
    def size(self) -> int:
        """The number of shards over every process (JAX's
        ``mesh.devices.size``)."""
        return self.num_processes * len(self.devices)

    @property
    def first_shard(self) -> int:
        """The global index of this process's first shard."""
        return self.process_index * len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of ``device``'s type.

    ``device=None`` is the card (:func:`shm_tpu_torch.device.resolve_device`):
    the first ``n_devices`` of ``torch.cuda.device_count()`` (default: all).
    Requesting more than exist raises ``ValueError`` rather than training on
    fewer devices than asked. ``device="cpu"`` gives ``n_devices`` shards
    (default 1) on the CPU, as the JAX tests' forced host device count does.
    """
    dev = resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    if dev.type == "cpu":
        return Mesh((dev,) * (n_devices or 1), axis)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    n = n_devices or count
    if n > count or n < 1:
        raise ValueError(
            f"requested a {n}-device mesh but only {count} {dev.type} "
            f"device(s) are available on this host; for a CPU mesh of n "
            "shards pass device='cpu'")
    return Mesh(tuple(torch.device(dev.type, i) for i in range(n)), axis)


def make_mesh_opt(devices: Optional[int], axis: str = "data",
                  device=None) -> Optional[Mesh]:
    """CLI ``--devices N`` adapter: a mesh over the first N devices of
    ``device``'s type (:func:`make_mesh`), or None for the single-device
    path when the flag is absent or N <= 1."""
    if not devices or devices <= 1:
        return None
    return make_mesh(devices, axis, device)


def shard_slices(n: int, k: int) -> List[slice]:
    """The rows of each of ``k`` contiguous shards of ``n`` rows, in order;
    an uneven ``n`` gives the first ``n % k`` shards one row more (as
    ``torch.tensor_split``)."""
    q, r = divmod(n, k)
    out, a = [], 0
    for i in range(k):
        b = a + q + (i < r)
        out.append(slice(a, b))
        a = b
    return out


def shard_batch(x, mesh: Mesh) -> List[torch.Tensor]:
    """Contiguous shards of a batch-leading tensor (or array) along dim 0,
    one per device of ``mesh`` in its order (:func:`shard_slices`), each on
    its device."""
    x = torch.as_tensor(x)
    return [x[sl].to(d, non_blocking=True) for sl, d in
            zip(shard_slices(x.shape[0], len(mesh.devices)), mesh.devices)]


def _copy_to(tree, device):
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    if isinstance(tree, dict):
        return {k: _copy_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_to(v, device) for v in tree)
    return tree


def replicate(tree, mesh: Mesh) -> list:
    """One independent copy of ``tree`` per device of ``mesh``, in its
    order: a module, a tensor, or a dict / list / tuple of them (other
    leaves are shared). Two shards on one device get two copies."""
    return [_copy_to(tree, d) for d in mesh.devices]


def mesh_device(mesh: Optional[Mesh], device) -> torch.device:
    """The device an entry point given ``mesh=`` keeps its models and data
    on: ``resolve_device(device)`` without a mesh; with one (of one
    process; ``device``, if given, of its type) the mesh's first device."""
    if mesh is None:
        return resolve_device(device)
    if mesh.num_processes != 1:
        raise ValueError("the trainers and scorers take a mesh of one "
                         "process; across processes use "
                         "parallel.make_dp_*_train_step")
    first = mesh.devices[0]
    if device is not None and torch.device(device).type != first.type:
        raise ValueError(f"device={device!r} is not the mesh's device type "
                         f"({first.type})")
    return first


def replicas_of(model: torch.nn.Module, mesh: Mesh) -> List[torch.nn.Module]:
    """``model`` itself, moved to the mesh's first device, then a copy on
    each other device: the replicas a data-parallel trainer steps, the
    first holding the parameters the optimizer updates."""
    model.to(mesh.devices[0])
    return [model] + [copy.deepcopy(model).to(d) for d in mesh.devices[1:]]


def all_reduce_sum(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Sum ``tensors`` in place across the processes of a global mesh (one
    ``torch.distributed.all_reduce`` of their concatenation); a no-op for a
    mesh of one process."""
    if mesh.num_processes == 1 or not tensors:
        return
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def sum_grads(replicas: Sequence[torch.nn.Module], mesh: Mesh,
              extra: Sequence[torch.Tensor] = (), scale: float = 1.0) -> None:
    """Sum every replica's gradients into the first replica's, on the first
    device, in shard order (a left fold, no atomics, so the same order every
    step); across processes then sum them, with ``extra`` (summed in place
    alongside, e.g. the loss), by :func:`all_reduce_sum`; then scale the
    gradients by ``scale``."""
    master = list(replicas[0].parameters())
    for rep in replicas[1:]:
        for p, q in zip(master, rep.parameters()):
            if q.grad is None:
                continue
            g = q.grad.to(p.device)
            if p.grad is None:
                p.grad = g.clone()
            else:
                p.grad.add_(g)
    grads = [p.grad for p in master if p.grad is not None]
    all_reduce_sum(grads + list(extra), mesh)
    if scale != 1.0 and grads:
        torch._foreach_mul_(grads, scale)


@torch.no_grad()
def sync_replicas(replicas: Sequence[torch.nn.Module]) -> None:
    """Copy the first replica's parameters and buffers into the others and
    clear their gradients."""
    src_p, src_b = list(replicas[0].parameters()), list(replicas[0].buffers())
    for rep in replicas[1:]:
        for q, p in zip(rep.parameters(), src_p):
            q.copy_(p)
        for q, b in zip(rep.buffers(), src_b):
            q.copy_(b)
        rep.zero_grad(set_to_none=True)


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
    """The noise generator of global shard ``shard`` of a data-parallel step
    seeded ``seed``: ``manual_seed(seed * 2**20 + shard)`` on ``device`` (the
    counterpart of JAX's ``fold_in(key, axis_index)``). Shard ``i`` draws the
    same numbers whichever process holds it."""
    return torch.Generator(device=device).manual_seed(int(seed) * 2 ** 20
                                                      + int(shard))


def make_dp_vae_train_step(model, tx, mesh: Mesh):
    """Data-parallel VAE train step: per-shard gradients, then their mean.

    ``model``: the :class:`~shm_tpu_torch.models.vae.TemporalVAE` to train
    (moved to the mesh's first device; a replica is made on each other);
    ``tx``: its optimizer (``train.vae.make_optimizer(model.parameters(),
    cfg)``). Returns ``step(shards, seed, kl_w) -> loss``: ``shards`` is
    one batch shard a local device (:func:`shard_batch`, or
    ``distributed.host_local_batch_to_global``), equal in size across the
    mesh. Each shard runs the sampled training forward in training mode with
    its noise from :func:`shard_generator` ``(seed, global shard index)``;
    the gradients are the mean of the shards' (summed in shard order, then
    across processes), the loss the mean of the shards' mean losses; one
    ``tx`` step, then the replicas are refreshed. The plain autograd path:
    no training kernel runs under a mesh, as in the JAX package.
    """
    from shm_tpu_torch.models.vae import vae_loss

    replicas = replicas_of(model, mesh)

    def step(shards: Sequence[torch.Tensor], seed: int, kl_w) -> torch.Tensor:
        if len(shards) != len(replicas):
            raise ValueError(f"need {len(replicas)} shards, got {len(shards)}")
        tx.zero_grad()
        losses = []
        for i, (rep, xb) in enumerate(zip(replicas, shards)):
            rep.train()
            g = shard_generator(seed, mesh.first_shard + i, xb.device)
            recon, mu, logvar = rep(xb, sample=True, generator=g)
            total, _, _ = vae_loss(recon, xb, mu, logvar, kl_w)
            total.backward()
            losses.append(total.detach().to(mesh.devices[0]))
        loss = torch.stack(losses).sum()
        sum_grads(replicas, mesh, extra=[loss], scale=1.0 / mesh.size)
        tx.step()
        sync_replicas(replicas)
        return loss / mesh.size

    return step


def make_dp_cnn_train_step(model, tx, mesh: Mesh, loss: str = "ce",
                           focal_gamma: float = 2.0, alpha=None):
    """Data-parallel CNN train step: per-shard gradients and per-shard
    BatchNorm batch statistics, each averaged over the shards.

    ``model``: a CNN (``CNN4DOF`` or ``CNNOpenLab``), ``tx`` its optimizer.
    Returns ``step(x_shards, y_shards, seed) -> loss``: each shard runs the
    training forward on its own batch statistics, with fc1's dropout mask
    drawn from :func:`shard_generator`; the running statistics become the
    mean of the shards' updated ones (JAX ``pmean`` of ``batch_stats``),
    the gradients and the loss the mean of the shards'. (``train_cnn(mesh=)``
    instead normalizes by the statistics of the whole batch.)
    """
    from shm_tpu_torch.train.cnn import _loss_fn

    alpha_t = torch.as_tensor(
        [1.0] * model.num_classes if alpha is None else alpha,
        dtype=torch.float32)
    replicas = replicas_of(model, mesh)
    loss_fns = [_loss_fn(loss, focal_gamma, alpha_t.to(d))
                for d in mesh.devices]
    units = model.fc1.out_features

    def step(x_shards, y_shards, seed: int) -> torch.Tensor:
        if len(x_shards) != len(replicas) or len(y_shards) != len(replicas):
            raise ValueError(f"need {len(replicas)} shards")
        tx.zero_grad()
        losses = []
        for i, (rep, xb, yb, fn) in enumerate(
                zip(replicas, x_shards, y_shards, loss_fns)):
            rep.train()
            g = shard_generator(seed, mesh.first_shard + i, xb.device)
            keep = torch.rand(xb.shape[0], units, generator=g,
                              device=xb.device) < 1.0 - model.dropout
            l = fn(rep(xb, dropout_mask=keep), yb.long()).mean()
            l.backward()
            losses.append(l.detach().to(mesh.devices[0]))
        stats = [b for b in replicas[0].buffers() if b.is_floating_point()]
        with torch.no_grad():
            for rep in replicas[1:]:
                for s, b in zip(stats, [b for b in rep.buffers()
                                        if b.is_floating_point()]):
                    s.add_(b.to(s.device))
        loss = torch.stack(losses).sum()
        sum_grads(replicas, mesh, extra=[loss] + stats, scale=1.0 / mesh.size)
        with torch.no_grad():
            for s in stats:
                s.div_(mesh.size)
        tx.step()
        sync_replicas(replicas)
        return loss / mesh.size

    return step


def _concat_shards(outs, device):
    """Concatenate per-shard outputs (tensors, or tuples / NamedTuples of
    tensors) in shard order on ``device``."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    vals = [torch.cat([o[k].to(device) for o in outs])
            for k in range(len(first))]
    return type(first)(*vals) if hasattr(first, "_fields") else tuple(vals)


def make_dp_hybrid_fn(hybrid_fns: Sequence[Callable], mesh: Mesh):
    """Data-parallel wrapper of per-device scoring functions, one per device
    of ``mesh`` (each bound to the models on its device):
    ``run(X, *args)`` splits ``X`` by :func:`shard_batch`, calls
    ``hybrid_fns[i](shard_i, *args)`` with each tensor of ``args`` moved to
    device ``i``, launching every shard before reading any result (no host
    synchronisation between them), and concatenates the outputs in shard
    order on the first device. No collective."""
    if len(hybrid_fns) != len(mesh.devices):
        raise ValueError(f"need one function per mesh device "
                         f"({len(mesh.devices)}), got {len(hybrid_fns)}")

    def to(a, d):
        return a.to(d, non_blocking=True) if isinstance(a, torch.Tensor) else a

    @torch.inference_mode()
    def run(X, *args):
        outs = [fn(x, *(to(a, d) for a in args)) for fn, x, d in
                zip(hybrid_fns, shard_batch(X, mesh), mesh.devices)]
        return _concat_shards(outs, mesh.devices[0])

    return run


def make_dp_hybrid_shardmap(vae_model, cnn_model, mesh: Mesh,
                            **hybrid_kwargs):
    """Data-parallel hybrid inference: each device runs
    :func:`shm_tpu_torch.pipeline.make_hybrid_fn` (``hybrid_kwargs``, e.g.
    ``use_fused_vae=True``: on the card the gate kernel of the VAE's cell,
    launched once per shard) on its batch shard with its own replica of the
    two models (:func:`replicas_of`). Returns ``fn(W, mean, std, threshold)
    -> HybridOutputs`` (:func:`make_dp_hybrid_fn`)."""
    from shm_tpu_torch.pipeline import make_hybrid_fn

    vaes = replicas_of(vae_model.eval(), mesh)
    cnns = replicas_of(cnn_model.eval(), mesh)
    return make_dp_hybrid_fn(
        [make_hybrid_fn(v, c, **hybrid_kwargs) for v, c in zip(vaes, cnns)],
        mesh)


__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_opt",
    "shard_slices",
    "shard_batch",
    "replicate",
    "replicas_of",
    "mesh_device",
    "sum_grads",
    "sync_replicas",
    "shard_generator",
    "make_dp_vae_train_step",
    "make_dp_cnn_train_step",
    "make_dp_hybrid_fn",
    "make_dp_hybrid_shardmap",
]
