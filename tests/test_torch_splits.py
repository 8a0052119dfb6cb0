"""The port's split construction (``shm_tpu_torch/data/splits.py``) against
``shm_tpu/data/splits.py``, and the committed ``run_splits.json`` of
``data/4dof`` rebuilt from its committed runs. Pure Python: exact equality.
"""

import json
from pathlib import Path

import pytest

from shm_tpu.data import splits as J
from shm_tpu_torch.cli import stage4dof as cli
from shm_tpu_torch.config import Stage4DofConfig
from shm_tpu_torch.data import splits as P

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("s", ["", "a", "data/4dof/raw/normal/x.csv", "é"])
def test_stable_int(s):
    assert P.stable_int(s) == J.stable_int(s)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 10, 99, 902, 1000])
@pytest.mark.parametrize("fr", [(0.4, 0.3), (0.5, 0.5), (0.7, 0.4), (0.0, 0.0)])
def test_split_indices_contiguous(n, fr):
    assert P.split_indices_contiguous(n, *fr) == J.split_indices_contiguous(n, *fr)


def test_groups_and_document():
    normal = [("n/a.csv", 1001), ("n/b.csv", 50), ("n/c.csv", 300)]
    sensor = [("s/a.csv", 1001)]
    struct = [("t/a.csv", 100), ("t/b.csv", 99)]
    for args in ((normal, 100, 1), (normal, 100, 7), (struct, 100, 1)):
        assert P.build_window_split_group(*args) == J.build_window_split_group(*args)
    for kw in ({}, {"seq_len": 50, "stride": 3, "seed": 1, "train_frac": 0.5,
                    "val_frac": 0.25}):
        assert (P.make_run_splits_json(normal, sensor, struct, **kw)
                == J.make_run_splits_json(normal, sensor, struct, **kw))


@pytest.mark.parametrize("n", [3, 4, 5, 10, 17, 40])
@pytest.mark.parametrize("seed", [0, 42])
def test_run_based_split(n, seed):
    ids = [f"run{i:03d}" for i in range(n)][::-1]
    assert P.run_based_split(ids, seed=seed) == J.run_based_split(ids, seed=seed)
    with pytest.raises(ValueError, match="at least 3 runs"):
        P.run_based_split(ids[:2])


def test_committed_run_splits_rebuilt_from_the_committed_runs(monkeypatch):
    """make-splits from the repository root on data/4dof's committed runs
    writes its committed run_splits.json byte for byte in content."""
    written = {}
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(cli, "save_json", lambda doc, path: written.update(
        doc=json.loads(json.dumps(doc)), path=path))
    doc = cli.cmd_make_splits(cli.Paths("data/4dof"), Stage4DofConfig())
    want = json.loads((ROOT / "data/4dof/processed/run_splits.json").read_text())
    assert written["doc"] == want == json.loads(json.dumps(doc))
    assert written["path"] == Path("data/4dof/processed/run_splits.json")
    # every path it names resolves from the repository root and from elsewhere
    for f in want["sensor_fault"]["files"]:
        assert cli.resolve_run_path(f).is_file()
    monkeypatch.chdir("/")
    assert all(cli.resolve_run_path(f).is_file() for f in want["normal"]["files"])
