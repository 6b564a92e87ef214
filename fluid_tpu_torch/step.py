"""Simulation step (PyTorch port of ``fluid_tpu/step.py``).

One substep is p2g_1 -> p2g_2 -> grid_update -> g2p (``2d_multi.rs:111-133``);
a frame is ``cfg.iterations`` substeps.  PyTorch runs eagerly, so a frame is
a Python loop of substeps.  Five backends:

  "dense"  — ops.transfer, the reference (CPU and GPU)
  "sorted" — ops.sorted_transfer, one sort by cell per substep, then
             segment sums in a fixed order (the scale path)
  "tiled"  — ops.tiled_transfer, tile binning every substep and per-tile
             profile contractions (batched matrix products)
  "stream" — ops.stream_transfer, the persistent tile-binned slot stream
             whose hot stages are hand-written CUDA kernels on the GPU
  "pallas" — ops.pallas_transfer, tile binning every substep over a sorted
             particle stream; deposit, p2g2 and collect are hand-written
             CUDA kernels on the GPU (the JAX package's Pallas backend)

"sorted" and "tiled" run plain PyTorch on either device: their JAX
counterparts reach no Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .config import Config
from .domain import Domain
from .ops import transfer
from .state import GridState, ParticleState

BACKENDS = ("dense", "sorted", "tiled", "stream", "pallas")


def _get_backend(name: str):
    if name == "dense":
        return transfer
    if name == "sorted":
        from .ops import sorted_transfer

        return sorted_transfer
    if name == "tiled":
        from .ops import tiled_transfer

        return tiled_transfer
    if name == "stream":
        from .ops import stream_transfer

        return stream_transfer
    if name == "pallas":
        from .ops import pallas_transfer

        return pallas_transfer
    raise ValueError(f"unknown transfer backend {name!r} (have {BACKENDS})")


def substep(p: ParticleState, cfg: Config, domain: Domain,
            mouse_pos: torch.Tensor, mouse_active: torch.Tensor,
            backend: str = "dense") -> Tuple[ParticleState, GridState]:
    """One MLS-MPM substep; returns the new particles and the updated grid."""
    ops = _get_backend(backend)
    if hasattr(ops, "substep"):
        return ops.substep(p, cfg, domain, mouse_pos, mouse_active)
    grid = ops.p2g_1(p, cfg, domain)
    grid, density, pressure = ops.p2g_2(p, grid, cfg, domain)
    grid = ops.grid_update(grid, cfg)
    p = ops.g2p(p, grid, cfg, domain, mouse_pos, mouse_active, density, pressure)
    return p, grid


def frame_body(p: ParticleState, cfg: Config, domain: Domain,
               mouse_pos: torch.Tensor, mouse_active: torch.Tensor,
               backend: str = "dense", substeps: int | None = None
               ) -> ParticleState:
    """``cfg.iterations`` substeps (or ``substeps``).  The stream backend
    bins once, runs every substep on the binned layout and un-bins once;
    the tiled and pallas backends skip the dense grid their ``substep``
    returns."""
    ops = _get_backend(backend)
    if hasattr(ops, "frame"):
        return ops.frame(p, cfg, domain, mouse_pos, mouse_active, substeps=substeps)
    for _ in range(cfg.iterations if substeps is None else substeps):
        p, _ = substep(p, cfg, domain, mouse_pos, mouse_active, backend)
    return p


def frame(p: ParticleState, cfg: Config, domain: Domain,
          mouse_pos: torch.Tensor, mouse_active: torch.Tensor,
          backend: str = "dense") -> ParticleState:
    """One frame (``Simulation::step``, ``2d_multi.rs:110-134``)."""
    return frame_body(p, cfg, domain, mouse_pos, mouse_active, backend)


def no_mouse() -> Tuple[torch.Tensor, torch.Tensor]:
    """(mouse_pos, mouse_active) for a frame without interaction."""
    return torch.zeros((2,), dtype=torch.float32), torch.tensor(False)


def mouse(pos_xy) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mouse_pos, mouse_active) with the mouse at ``pos_xy`` (world units;
    the xy plane in 3D, ``3d_multi.rs:305-310``)."""
    return torch.as_tensor(pos_xy, dtype=torch.float32), torch.tensor(True)
