"""Probes of the port's kernels (counterparts of the JAX package's
``tools/probe_*.py``), each with its hand-written CUDA kernel, its plain
PyTorch version and a ``main`` runnable as ``python -m
shm_tpu_torch.tools.probe_<name>``."""
