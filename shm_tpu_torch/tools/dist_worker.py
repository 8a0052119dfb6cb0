"""One process of a data-parallel VAE step across processes (counterpart of
``tools/dist_worker.py``).

Each process joins the process group, builds the global mesh, runs two
data-parallel VAE train steps on its rows of the global batch and prints
the global loss of each as ``LOSS <x>`` and ``LOSS2 <x>`` (the JAX worker's
``--two-steps``). The second loss is taken on the parameters the first
step's summed gradients moved, so it sees the gradient exchange across
processes. A run of one process with ``--local-devices 2`` holds both shards
itself and prints the same losses as two processes of one shard each.

    python -m shm_tpu_torch.tools.dist_worker RANK NPROC PORT
        [--device cpu] [--backend gloo|nccl] [--local-devices K]
        [--init-timeout S]

``--device``: the card by default (shard ``j`` of rank ``r`` on
``cuda:(r * K + j) % device_count``), ``cpu`` for CPU shards.
``--backend``: NCCL on the card and gloo on the CPU by default.
``--init-timeout S``: ``initialization_timeout=S``.
"""

from __future__ import annotations

import argparse


def step_losses(mesh, rank: int = 0) -> tuple:
    """Two data-parallel VAE steps (seeds 2 and 3) of the worker's fixed
    problem on ``mesh``: a batch of 16 windows (T=10, D=4) and a VAE (Z=3,
    H=8, 2 layers) made from the same seeds on every process, this
    process's rows of the batch (its share, ``rank``-th of
    ``mesh.num_processes``) split over its devices; the global loss of
    each step."""
    import numpy as np
    import torch

    from shm_tpu_torch.config import TrainConfig
    from shm_tpu_torch.models.vae import TemporalVAE
    from shm_tpu_torch.parallel import distributed as dist
    from shm_tpu_torch.parallel import make_dp_vae_train_step
    from shm_tpu_torch.train.vae import make_optimizer

    B, T, D = 16, 10, 4
    if B % mesh.size:
        raise ValueError(f"the batch of {B} does not split over {mesh.size} "
                         "shards")
    W = np.random.default_rng(0).standard_normal((B, T, D)).astype(np.float32)
    vae = TemporalVAE(D, 3, 8, 2, use_layernorm=True, dropout=0.0)
    vae.init_parameters(torch.Generator().manual_seed(1))
    vae = dist.replicate_from_host(vae, mesh)[0]
    tx = make_optimizer(vae.parameters(),
                        TrainConfig(batch_size=B, lr=1e-3, weight_decay=1e-5,
                                    grad_clip=2.0))
    per = B // mesh.num_processes
    Wg = dist.host_local_batch_to_global(W[rank * per:(rank + 1) * per], mesh)
    step = make_dp_vae_train_step(vae, tx, mesh)
    return tuple(float(step(Wg, seed=s, kl_w=0.5)) for s in (2, 3))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="shm_tpu_torch.tools.dist_worker")
    ap.add_argument("rank", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--local-devices", type=int, default=1)
    ap.add_argument("--init-timeout", type=int, default=None)
    args = ap.parse_args(argv)

    import torch

    from shm_tpu_torch.device import resolve_device
    from shm_tpu_torch.parallel import distributed as dist

    dev = resolve_device(args.device)
    k = args.local_devices
    ids = list(range(args.rank * k, args.rank * k + k))
    if dev.type == "cuda":
        ids = [i % torch.cuda.device_count() for i in ids]
    dist.initialize(f"localhost:{args.port}", args.nproc, args.rank,
                    local_device_ids=ids,
                    initialization_timeout=args.init_timeout,
                    device=args.device, backend=args.backend)
    mesh = dist.make_global_mesh()
    print(f"BACKEND {torch.distributed.get_backend()} {mesh}", flush=True)
    loss, loss2 = step_losses(mesh, args.rank)
    print(f"LOSS {loss:.9f}", flush=True)
    print(f"LOSS2 {loss2:.9f}", flush=True)
    dist.shutdown()


if __name__ == "__main__":
    main()
