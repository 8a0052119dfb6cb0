"""The port's data parallelism across processes
(``shm_tpu_torch/parallel/distributed.py``) on the CPU, with no card.

Two gloo processes of ``shm_tpu_torch/tools/dist_worker.py``, one shard
each, run two data-parallel VAE steps over the global mesh and must print
the same losses as each other and, within rtol 1e-6 (the JAX test's bound,
``tests/test_distributed.py``), as one process holding both shards. The
second step's loss is read on the parameters that the first step's
gradients, summed across the two processes, moved: a rank that stepped on
its own shard's gradient alone would print another. A
process group whose second process never arrives raises within its
``initialization_timeout`` rather than hanging. Each process is killed on
the test's own timeout, so no rank outlives its test.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(rank: int, nproc: int, port: int, *flags: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "shm_tpu_torch.tools.dist_worker", str(rank),
         str(nproc), str(port), "--device", "cpu", *flags],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _communicate_all(procs, timeout: int):
    """(returncode, stdout, stderr) per process; kills every straggler on
    timeout."""
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return results


def _losses(out: str) -> list:
    """The LOSS and LOSS2 lines' values, in that order."""
    got = {l.split()[0]: float(l.split()[1]) for l in out.splitlines()
           if l.startswith("LOSS")}
    assert set(got) == {"LOSS", "LOSS2"}, f"no LOSS / LOSS2 lines:\n{out}"
    return [got["LOSS"], got["LOSS2"]]


def test_two_gloo_processes_match_one_process_with_two_shards():
    port = _free_port()
    results = _communicate_all([_launch(r, 2, port) for r in range(2)], 120)
    for rc, out, err in results:
        assert rc == 0, f"rank failed (rc={rc}):\n{out}\n{err[-3000:]}"
    losses = [_losses(out) for _, out, _ in results]
    assert losses[0] == losses[1], losses
    [(rc, out, err)] = _communicate_all(
        [_launch(0, 1, _free_port(), "--local-devices", "2")], 120)
    assert rc == 0, err[-3000:]
    np.testing.assert_allclose(losses[0], _losses(out), rtol=1e-6)


def test_missing_process_raises_within_the_timeout():
    """Rank 0 of 2 alone, with a 5 s timeout: it raises (the store's
    wait for the second process) well inside the test's 120 s."""
    [(rc, out, err)] = _communicate_all(
        [_launch(0, 2, _free_port(), "--init-timeout", "5")], 120)
    assert rc != 0, f"expected a failure, got:\n{out}"
    assert "LOSS" not in out
    assert "Timed out" in err or "timed out" in err, err[-3000:]
