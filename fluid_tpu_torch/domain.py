"""Static domain geometry — the analog of ``set_rect`` (PyTorch port).

A verbatim copy of ``fluid_tpu/domain.py`` (which imports no JAX itself,
but is reached only through ``fluid_tpu/__init__.py``, which does), plus
``PackedDomain``, the domain of a batch of scenes laid side by side along
x (``scene.pack_scenes``), which states its scene count and stride.

The reference (``2d_multi.rs:79-102`` / ``3d_multi.rs:79-102``) derives, from a
world-space rectangle, an *active* chunk rect ``a_rect``, a *padded* chunk rect
``p_rect`` (one chunk of halo on every side so any active particle's 3^D
stencil lands on allocated grid), and allocates a dense cell grid spanning
``p_rect``.  Chunk edge length equals ``grid_res`` world units; cell size is
1.0 world unit (``cell_pos = pos.floor()``, ``2d_multi.rs:153``).

Here the same geometry becomes *static shape metadata* computed at trace time:
a grid origin (in integer cell coordinates, possibly negative) and a grid
shape.  The reference's hash-map chunking, migration buffers and touched-cell
list all disappear — SoA arrays with static shapes replace them (SURVEY.md
§5.7, §7.3 hard part 2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from .config import Config


def _key_from_pos(x: float, grid_res: int) -> int:
    """Chunk key along one axis: ``pos.div_euclid(grid_res)`` (2d_multi.rs:376-379)."""
    return math.floor(x / grid_res)


@dataclasses.dataclass(frozen=True)
class Domain:
    """Static grid geometry. Hashable => usable as a jit static arg.

    Attributes:
      origin: integer cell coordinate of grid[0, ...] in world space
        (= ``p_rect.0 * grid_res`` in the reference, ``2d_multi.rs:168``).
      shape: dense grid shape in cells (= ``(p_rect.1 - p_rect.0) * grid_res``,
        ``2d_multi.rs:94``).
      a_rect / p_rect: active / padded chunk rects (diagnostic parity only).
    """

    origin: Tuple[int, ...]
    shape: Tuple[int, ...]
    a_rect: Tuple[Tuple[int, ...], Tuple[int, ...]]
    p_rect: Tuple[Tuple[int, ...], Tuple[int, ...]]

    @property
    def dim(self) -> int:
        return len(self.shape)

    @property
    def num_cells(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass(frozen=True)
class PackedDomain(Domain):
    """A batch of ``scenes`` scenes laid side by side along x in one grid:
    scene k owns the ``scene_stride`` grid columns from ``k * scene_stride``
    on, and a particle of scene k keeps its own scene's coordinates (the
    stream backend adds ``k * scene_stride`` where a position becomes a
    cell)."""

    scenes: int
    scene_stride: int  # cells, along x

    def __post_init__(self):
        if self.scenes < 1 or self.scene_stride * self.scenes != self.shape[0]:
            raise ValueError(f"{self.scenes} scenes of {self.scene_stride} cells do not "
                             f"tile the grid's {self.shape[0]} along x")


def packing(domain) -> Tuple[int, int]:
    """(scenes, scene stride in cells) of a domain: (1, 0) for one scene,
    whichever package's Domain it is."""
    return getattr(domain, "scenes", 1), getattr(domain, "scene_stride", 0)


def make_domain(cfg: Config, rect_min=None, rect_max=None, halo_cells=None) -> Domain:
    """Derive the dense-grid geometry for a world rect (default: boundary_clip).

    Mirrors ``set_rect`` (``2d_multi.rs:79-102``): active rect =
    ``[key(min), key(max)+1)`` chunks, padded rect = active ± 1 chunk,
    grid = padded-rect span × grid_res cells per axis.

    For the reference 2D defaults this yields a 160×160 grid with origin
    (-32,-32); for 3D, 112³ with origin (-16,-16,-16) (SURVEY.md §2.2).

    ``halo_cells``: the reference pads by a FULL CHUNK (grid_res cells) per
    side purely because its allocation granularity is the chunk; the physics
    only ever touches 1 halo cell (stencil radius of clamped particles).
    Pass a small value (e.g. 4) for a tight grid with identical semantics —
    the 3D reference domain shrinks 112³ -> 72³ (3.8x fewer cells).  Shapes
    are rounded up to a multiple of 8 (tile-size friendly).
    """
    if rect_min is None:
        rect_min = cfg.boundary_clip[0]
    if rect_max is None:
        rect_max = cfg.boundary_clip[1]

    a_min = tuple(_key_from_pos(x, cfg.grid_res) for x in rect_min)
    a_max = tuple(_key_from_pos(x, cfg.grid_res) + 1 for x in rect_max)
    p_min = tuple(k - 1 for k in a_min)
    p_max = tuple(k + 1 for k in a_max)

    if halo_cells is None:
        origin = tuple(k * cfg.grid_res for k in p_min)
        shape = tuple((hi - lo) * cfg.grid_res for lo, hi in zip(p_min, p_max))
    else:
        if halo_cells < 1:
            raise ValueError("halo_cells must cover the stencil radius (>= 1)")
        origin = tuple(
            int(math.floor(x)) - halo_cells for x in rect_min
        )
        shape = tuple(
            -(-(int(math.ceil(hi)) + halo_cells - o) // 8) * 8
            for hi, o in zip(rect_max, origin)
        )
    return Domain(origin=origin, shape=shape, a_rect=(a_min, a_max), p_rect=(p_min, p_max))
