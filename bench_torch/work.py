"""The work a substep of the scene needs, and the least time the card could take for it.

Counted from the valid particles ``n`` and the occupied grid cells ``c``
(the cells some particle's 3^D stencil touches) alone: no term depends on
the active-tile budget, the slot cap, padding or how the program tiles the
grid, so the count holds whatever kernels do the work.  Each of the four
stages of the reference's substep reads its inputs once and writes its
outputs once (float32):

  p2g1    reads pos, vel, C, mass; writes cell mass and momentum
  p2g2    reads pos, C, mass, cell mass and momentum; writes momentum and
          each particle's density and pressure
  update  reads cell mass and momentum; writes cell velocity
  g2p     reads pos and cell velocity; writes pos, vel, C

A stage's least time is the larger of its bytes over the HBM rate and its
fp32 operations over the fp32 peak (H100 SXM data sheet, at its 700 W
limit; a card set lower runs slower, so its limit is printed beside).  The
operation counts are the direct tap form's (``particle_ops``).
"""

from __future__ import annotations

import torch

from . import reference

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4


def particle_ops(kind: str, D: int, n: int) -> int:
    """fp32 adds and multiplies of ``n`` particles' 3^D taps: stencil 10 per
    axis; a tap weight D-1; p2g1 mass and APIC momentum 2(1+D) + 2D^2; the
    eq-16 force 2D + 2D^2; density gather 2 + (D-1); EOS 10, stress 6D^2;
    g2p 2 + 2D + 2D^2 and the particle tail 8D + 20."""
    stencil, w = 10 * D, D - 1
    per_tap, per_particle = {
        "p2g1": (w + 2 * (1 + D) + 2 * D * D, stencil + 4 * D * D),
        "p2g2": (2 * w + 2 + 2 * D + 2 * D * D, stencil + 10 + 6 * D * D),
        "g2p": (w + 2 + 2 * D + 2 * D * D, stencil + 10 + 2 * D * D + 8 * D + 20),
    }[kind]
    return n * 3**D * per_tap + n * per_particle


def substep_stages(D: int, n: int, c: int) -> dict:
    """stage -> (bytes, fp32 operations) of one substep."""
    return {
        "p2g1": ((n * (2 * D + D * D + 1) + c * (1 + D)) * F32, particle_ops("p2g1", D, n)),
        "p2g2": ((n * (D + D * D + 1) + c * (1 + D) + c * D + 2 * n) * F32,
                 particle_ops("p2g2", D, n)),
        "update": ((c * (1 + D) + c * D) * F32, 2 * D * c),
        "g2p": ((n * D + c * D + n * (2 * D + D * D)) * F32, particle_ops("g2p", D, n)),
    }


def least_seconds(D: int, n: int, c: float) -> float:
    """The least time of one substep: each stage bound by bytes or by
    operations, whichever takes longer, summed over the stages."""
    return sum(max(b / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
               for b, ops in substep_stages(D, n, int(round(c))).values())


def occupied_cells(pos: torch.Tensor, walls) -> int:
    """Grid cells that some particle's stencil touches (each tap's weight is
    above zero)."""
    grid = reference.Grid(*walls, device=pos.device)
    flat, _, _ = reference.stencil(pos, grid)
    mark = torch.zeros(grid.cells, dtype=torch.bool, device=pos.device)
    mark[flat.reshape(-1)] = True
    return int(mark.sum())
