"""PyTorch/CUDA port of ``shm_tpu`` — hybrid VAE+CNN structural health monitoring.

The JAX package ``shm_tpu`` stays the reference; this package mirrors its
module names so each port module sits beside its counterpart:

    config.py               VAEConfig / CNNConfig / Stage4DofConfig
    utils/io.py             load_json, load_csv_numeric (numpy only)
    utils/checkpoint.py     pure-Python reader of flax msgpack checkpoints
    convert.py              flax parameter trees -> the port's state dicts
    data/windows.py         make_windows / normalize_windows / slice_frac
    models/{lstm,vae,cnn}.py  plain PyTorch modules (the reference path;
                            CNN4DOF also in bf16)
    models/cnn_int8.py      the int8 attribution CNN (not wired in)
    ops/fused_vae.py        hand-written CUDA kernel of the whole VAE gate,
                            float32 and bf16 instances
    pipeline.py             make_hybrid_fn: normalize -> gate -> CNN
    serve.py                HybridScorer (bucketed scoring of window stacks),
                            StreamScorer (continuous streams)
    monitor.py              DriftMonitor (the gate's anomaly rate)
    serve_batch.py          DynamicBatcher (coalesced concurrent requests)
    serve_shadow.py         ShadowEngine (a candidate model on live traffic)
    serve_http.py           the HTTP daemon (python -m shm_tpu_torch.serve_http)
    cli/stage4dof.py        artifact loaders
    evals/metrics.py        accuracy, confusion_matrix
    parallel/               data parallelism: make_mesh (the devices of one
                            process; a CPU mesh of n shards), the scorers'
                            and trainers' mesh=, distributed.py (processes
                            joined by torch.distributed), every --devices

Entry points run on ``cuda`` unless the caller passes ``device=``; without a
card and without ``device=`` they raise (see :func:`device.resolve_device`).
Nothing here imports JAX, flax, optax or ``shm_tpu``.
"""

from shm_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
