"""Quadratic B-spline weights and the 3^D stencil (PyTorch port).

Counterpart of ``fluid_tpu/ops/bspline.py`` (reference
``2d_multi.rs:368-374``): ``w = [0.5(0.5-d)^2, 0.75-d^2, 0.5(0.5+d)^2]``
for ``d = pos - (floor(pos) + 0.5)``.  The offset table orders taps with x
varying fastest, like the reference's ``grid_search(0, 3)``.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
import torch

from ..utils.graph import device_const


def quadratic_weights(cell_diff: torch.Tensor) -> torch.Tensor:
    """[..., D] offsets in [-0.5, 0.5) -> [..., 3, D] per-axis weights."""
    d = cell_diff
    return torch.stack(
        [0.5 * (0.5 - d) * (0.5 - d), 0.75 - d * d, 0.5 * (0.5 + d) * (0.5 + d)],
        dim=-2,
    )


@lru_cache(maxsize=None)
def _stencil_offsets_np(dim: int) -> np.ndarray:
    combos = itertools.product(*[range(3)] * dim)
    return np.array([c[::-1] for c in combos], dtype=np.int64)


def stencil_offsets(dim: int, device=None) -> torch.Tensor:
    """[3^dim, dim] int64 stencil offsets (0..2 per axis); a shared
    ``device_const``, not to be written to."""
    return device_const(_stencil_offsets_np(dim), device)


def stencil_weights(ws: torch.Tensor) -> torch.Tensor:
    """[..., 3, D] per-axis weights -> [..., 3^D] tensor-product weights,
    ordered like ``stencil_offsets``: the outer product of the axes, axis 0
    fastest, each tap's product formed in axis order.  Slices, not an index
    table: indexing with a host table would copy it to the device."""
    dim = ws.shape[-1]
    lead = ws.shape[:-2]
    out = ws[..., 0]  # [..., 3]
    for d in range(1, dim):
        out = (out.unsqueeze(-2) * ws[..., d].unsqueeze(-1)).reshape(*lead, 3 ** (d + 1))
    return out
