"""The JAX CLI's ``all`` on the committed windows written back as catman
exports (each run's first 300 windows, ``--epochs 1``; its figures skipped)
writes the files ``tests/torch_openlab_roots.py::ALL_FILES`` lists, which
``tests/test_torch_cli_openlab_extract.py`` holds the port's ``all`` to;
and the port's ``extract``, ``make-splits`` and ``featurize`` on the same
files write its ``extracted/``, ``run_split.json`` and ``features/`` byte
for byte.
"""

import torch

from shm_tpu_torch.cli import openlab as ol
from torch_openlab_roots import (
    ALL_FILES, SHORT_WINDOWS, catman_runs, files_under, silence_jax_plots,
)

torch.set_num_threads(1)


def test_jax_all_writes_all_files_and_the_port_agrees(tmp_path, monkeypatch):
    from shm_tpu.cli import openlab as jol

    silence_jax_plots(monkeypatch)
    raw = catman_runs(tmp_path / "raw", SHORT_WINDOWS)
    jol.main(["all", "--root", str(tmp_path / "jax"), "--raw-dir", str(raw),
              "--epochs", "1"])
    assert files_under(tmp_path / "jax") == set(ALL_FILES)
    for step in ("extract", "make-splits", "featurize"):
        ol.main([step, "--root", str(tmp_path / "port"), "--raw-dir", str(raw),
                 "--device", "cpu"])
    for rel in ALL_FILES:
        if rel.startswith(("extracted/", "features/")):
            assert (tmp_path / "port" / rel).read_bytes() == \
                (tmp_path / "jax" / rel).read_bytes(), rel
