"""Several processes, one data-parallel program (counterpart of
``shm_tpu/parallel/distributed.py``).

One process per device (or per group of devices), joined by
``torch.distributed``: every process runs the same script, holds its own
shards of each global batch, and the train steps of
:mod:`shm_tpu_torch.parallel.mesh` sum their gradients across processes with
``all_reduce``. The backend follows the process's device, NCCL for CUDA and
gloo for the CPU, unless the caller names one (gloo also reduces CUDA
tensors, which two processes on one card need: NCCL takes one rank a card).

Usage (every process runs the same script)::

    from shm_tpu_torch.parallel import distributed as dist
    dist.initialize("host0:1234", num_processes=NPROC, process_id=RANK)
    mesh = dist.make_global_mesh()
    vae = dist.replicate_from_host(vae, mesh)[0]   # identical everywhere
    step = make_dp_vae_train_step(vae, make_optimizer(vae.parameters(), cfg),
                                  mesh)
    loss = step(dist.host_local_batch_to_global(W_local, mesh), seed, kl_w)

Tested without a card by 2-process gloo runs on the CPU
(``tests/test_torch_distributed.py``, ``shm_tpu_torch/tools/dist_worker.py``)
that give the loss of one process with a 2-shard mesh.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import torch

from shm_tpu_torch.parallel.mesh import Mesh, replicate

# the process's local devices, set by initialize() (a process group is
# process-wide state in torch.distributed too)
_LOCAL: List[torch.device] = []


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               initialization_timeout: Optional[int] = None, *,
               device=None, backend: Optional[str] = None) -> None:
    """Join this process to the process group.

    ``coordinator_address``: ``"host:port"`` of process 0, which listens
    there (``init_method="tcp://..."``); None reads torch's environment
    variables (``MASTER_ADDR``, ``RANK``, ...: ``env://``, as ``torchrun``
    sets them). ``device``: ``"cpu"`` for CPU shards, else the card (None).
    ``local_device_ids``: the devices this process holds, in shard order:
    CUDA indices (default ``process_id % torch.cuda.device_count()``); on
    the CPU one shard per entry (default one). ``backend``: None is NCCL on
    the card and gloo on the CPU.

    ``initialization_timeout`` (seconds; torch's default otherwise): when a
    process never arrives (crashed before startup, a wrong count, a dead
    host) every other process raises within it rather than hanging, so a
    launcher restarts the whole job from the trainer's checkpoints.
    """
    import torch.distributed as dist

    from shm_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    rank = 0 if process_id is None else int(process_id)
    if dev.type == "cuda":
        ids = (list(local_device_ids) if local_device_ids is not None
               else [rank % torch.cuda.device_count()])
        torch.cuda.set_device(ids[0])
        local = [torch.device("cuda", i) for i in ids]
    else:
        local = [dev] * (len(local_device_ids) if local_device_ids else 1)
    kw = {}
    if initialization_timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=int(initialization_timeout))
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=("env://" if coordinator_address is None
                     else f"tcp://{coordinator_address}"),
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else rank, **kw)
    _LOCAL[:] = local


def shutdown() -> None:
    """Leave the process group."""
    import torch.distributed as dist

    dist.destroy_process_group()
    _LOCAL.clear()


def make_global_mesh(axis: str = "data") -> Mesh:
    """The mesh over every process's devices, process-major: this process's
    devices with its index and the process count, so that it holds shards
    ``rank * k .. rank * k + k - 1`` of a global batch (k local devices,
    the same on every process)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_global_mesh() needs initialize() first")
    return Mesh(tuple(_LOCAL), axis, dist.get_rank(), dist.get_world_size())


def host_local_batch_to_global(x, mesh: Mesh) -> List[torch.Tensor]:
    """This process's rows as its shards of a global batch of
    ``num_processes * rows`` rows: split over its local devices
    (:func:`shm_tpu_torch.parallel.mesh.shard_batch`). Every process passes
    its own rows, the same count on each."""
    from shm_tpu_torch.parallel.mesh import shard_batch

    return shard_batch(x, mesh)


def replicate_from_host(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` (a module, a tensor, or a dict / list of them)
    per local device, after checking that it is identical on every process
    (same seed, same init): process 0's values are broadcast and compared
    bit for bit, and a difference raises ``ValueError``."""
    import torch.distributed as dist

    if mesh.num_processes > 1:
        if isinstance(tree, torch.nn.Module):
            leaves = list(tree.state_dict().values())
        elif isinstance(tree, dict):
            leaves = list(tree.values())
        elif isinstance(tree, torch.Tensor):
            leaves = [tree]
        else:
            leaves = list(tree)
        leaves = [t.detach().to(mesh.devices[0]) for t in leaves
                  if isinstance(t, torch.Tensor)]
        flat = torch.cat([t.reshape(-1).double() for t in leaves])
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        if not torch.equal(ref, flat):
            raise ValueError(
                f"replicate_from_host: process {mesh.process_index}'s values "
                "differ from process 0's; every process must build them from "
                "the same seed")
    return replicate(tree, mesh)


__all__ = [
    "initialize",
    "shutdown",
    "make_global_mesh",
    "host_local_batch_to_global",
    "replicate_from_host",
]
