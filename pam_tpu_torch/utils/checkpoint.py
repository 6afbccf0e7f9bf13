"""Checkpoint and resume of the coupler state (port of the npz form of
pam_tpu/utils/checkpoint.py; its orbax form is not ported).

The reference has no checkpoint subsystem: in MMF use the GCM feeds the
state back each step, so the coupler state is the checkpoint surface
(state list = allocate_coupler_state, pam_coupler.h:255-293). This
persists exactly that surface: a flat dict of arrays in ``<path>.npz``
and the metadata in ``<path>.json``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..convert import host_array


def _paths(path: str) -> tuple[str, str]:
    """(arrays .npz path, metadata .json path) for a checkpoint name."""
    stem = path[:-4] if path.endswith(".npz") else path
    return stem + ".npz", stem + ".json"


def save_checkpoint(path: str, state: dict, etime: float = 0.0,
                    meta: dict = None):
    """Persist a coupler state dict (name -> tensor) plus metadata."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    npath, mpath = _paths(path)
    arrays = {k: host_array(v) for k, v in state.items()}
    np.savez_compressed(npath, **arrays)
    meta = dict(meta or {})
    meta["etime"] = float(etime)
    meta["fields"] = sorted(arrays)
    with open(mpath, "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str, dtype: torch.dtype = None, device="cuda"):
    """Restore (state, etime, meta): tensors on ``device``, in ``dtype``
    (each array's own dtype if None)."""
    npath, mpath = _paths(path)
    with np.load(npath) as data:
        state = {k: torch.as_tensor(data[k], dtype=dtype, device=device)
                 for k in data.files}
    meta = {}
    if os.path.exists(mpath):
        with open(mpath) as f:
            meta = json.load(f)
    return state, float(meta.get("etime", 0.0)), meta
