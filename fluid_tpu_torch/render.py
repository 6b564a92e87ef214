"""ASCII density renderer (PyTorch port of ``fluid_tpu/render.py``).

Particles bin into an 80x40 console grid (3D projects onto xy,
``3d_multi.rs:473``); counts map onto the ramp ``' .-=*%$#'``
(``2d_multi.rs:465-474``).  The histogram is reduced on the particles'
device, so a frame moves only the count grid to the host; ``render`` is
the whole path from a ``ParticleState`` to console lines.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

RAMP = " .-=*%$#"
DEFAULT_VIEWPORT = (64.0, 64.0)  # 2d_multi.rs:515
DEFAULT_CONSOLE = (80, 40)  # 2d_multi.rs:516 (width, height)


def histogram_xy(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                 viewport_size, console_size: Tuple[int, int]) -> torch.Tensor:
    """(H, W) int32 counts of the points (x, y) where ``valid``; points
    outside the console are skipped (``2d_multi.rs:452-454``)."""
    w, h = console_size
    cx = torch.floor(x / float(viewport_size[0]) * w).to(torch.int64)
    cy = torch.floor(y / float(viewport_size[1]) * h).to(torch.int64)
    ok = valid & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
    flat = cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
    counts = torch.zeros((h * w,), dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat.reshape(-1), ok.reshape(-1).to(torch.int32))
    return counts.reshape(h, w)


def histogram(pos: torch.Tensor, viewport_size=DEFAULT_VIEWPORT,
              console_size: Tuple[int, int] = DEFAULT_CONSOLE) -> torch.Tensor:
    """Bin [N, D] positions (xy only) into an (H, W) int32 count grid."""
    valid = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    return histogram_xy(pos[..., 0], pos[..., 1], valid, viewport_size, console_size)


def ascii_frame(counts) -> list[str]:
    """Map an (H, W) count grid on the host (an array or a CPU tensor) to
    console lines via the reference ramp."""
    counts = np.asarray(counts)
    lut = np.array(list(RAMP))
    return ["".join(row) for row in lut[np.clip(counts, 0, len(RAMP) - 1)]]


def render(p, viewport_size=DEFAULT_VIEWPORT,
           console_size: Tuple[int, int] = DEFAULT_CONSOLE) -> list[str]:
    """Console lines of a ``ParticleState``: histogram on its device, then
    the ramp on the host."""
    return ascii_frame(histogram(p.pos, viewport_size, tuple(console_size)).cpu())
