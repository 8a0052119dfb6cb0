"""Data parallelism (counterpart of ``shm_tpu/parallel``): meshes of one
process (:mod:`.mesh`) and across processes (:mod:`.distributed`)."""

from shm_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_mesh_opt,
    shard_batch,
    replicate,
    make_dp_vae_train_step,
    make_dp_cnn_train_step,
    make_dp_hybrid_fn,
    make_dp_hybrid_shardmap,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "make_mesh_opt",
    "shard_batch",
    "replicate",
    "make_dp_vae_train_step",
    "make_dp_cnn_train_step",
    "make_dp_hybrid_fn",
    "make_dp_hybrid_shardmap",
]
