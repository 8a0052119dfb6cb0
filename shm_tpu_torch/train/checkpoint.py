"""Mid-training checkpoint/resume (counterpart of ``shm_tpu/train/checkpoint.py``).

A trainer persists its FULL state (parameters, optimizer moments and step,
best-so-far parameters, random-generator state) so that an interrupted run
continues on the same trajectory. One ``torch.save`` file holds the tensors; a
sidecar ``.meta.json`` holds the scalars and the history, so progress can be
read without loading tensors. The tensor file is the port's own format: the
two frameworks' random streams differ, so resuming a run of one framework in
the other would mean nothing.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch


def save_train_ckpt(path: str | Path, arrays: Any, meta: Dict) -> None:
    """Persist (tensor tree, JSON-serializable meta) atomically."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    torch.save(arrays, tmp)
    tmp.replace(p)
    meta_p = p.with_suffix(".meta.json")
    tmp_m = meta_p.with_suffix(".tmp")
    tmp_m.write_text(json.dumps(meta, indent=2), encoding="utf-8")
    tmp_m.replace(meta_p)


def load_train_ckpt(path: str | Path, map_location=None
                    ) -> Optional[Tuple[Any, Dict]]:
    """(tensor tree, meta), or None if no checkpoint exists."""
    p = Path(path)
    meta_p = p.with_suffix(".meta.json")
    if not p.exists() or not meta_p.exists():
        return None
    arrays = torch.load(p, map_location=map_location, weights_only=True)
    meta = json.loads(meta_p.read_text(encoding="utf-8"))
    return arrays, meta


__all__ = ["save_train_ckpt", "load_train_ckpt"]
