"""Checkpoint / resume (PyTorch port of ``fluid_tpu/checkpoint.py``).

The reference has none: its state lives only in memory.  Here the SoA
state round-trips through ``.npz`` in the JAX package's format: the six
fields as float32 arrays plus ``__meta__``, the UTF-8 JSON of
``{"config": dataclasses.asdict(cfg), "frame": frame}`` as uint8.  A file
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

import numpy as np
import torch

from .config import Config
from .state import FIELDS, ParticleState
from .utils.platform import resolve_device


def save(path, p: ParticleState, cfg: Config, frame: int = 0) -> None:
    arrays = {f: getattr(p, f).detach().cpu().numpy() for f in FIELDS}
    meta = json.dumps({"config": dataclasses.asdict(cfg), "frame": frame})
    np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8), **arrays)


def load(path, device=None) -> Tuple[ParticleState, Config, int]:
    """(particles on ``device``, config, frame); ``device`` None means
    ``default_device()``, the card."""
    device = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        p = ParticleState(**{f: torch.as_tensor(z[f]).to(device) for f in FIELDS})
    c = meta["config"]
    c["gravity"] = tuple(c["gravity"])
    c["boundary_clip"] = tuple(tuple(b) for b in c["boundary_clip"])
    return p, Config(**c), meta["frame"]
