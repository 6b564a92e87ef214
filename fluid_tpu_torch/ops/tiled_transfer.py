"""Tile binning for the "pallas" backend (PyTorch port of the parts of
``fluid_tpu/ops/tiled_transfer.py`` that ``pallas_transfer.substep`` uses).

Particles are sorted by the tile (T^D cells) of their cell; each tile's
particles then lie in one contiguous run of the sorted order, starting at
``start[tile]``.  Occupied tiles are compacted, in tile order, into a
static budget of ``active`` entries (``tile_of_active``; ``nt`` marks an
unused entry).  A tile holds at most ``cap`` particles; the particles past
``cap`` and those of occupied tiles beyond the budget are ``frozen`` for
the substep (their old state passes through) and counted by
``overflow_count``.

The sort is stable, as ``jnp.argsort`` is: the order inside a tile decides
which particles take the ``cap`` slots and the order of every sum, so
binning equals the JAX module's exactly.  Every shape is known on the host
(``A = spec.active or nt``), so binning reads nothing back from the device.

The tiled backend's own substep (per-tile profile contractions) and its
slot gather ``bsrc`` are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config import Config
from ..domain import Domain


@dataclasses.dataclass(frozen=True)
class TileSpec:
    tile: int = 4  # cells per tile edge
    cap: int = 256  # particle slots per tile
    active: Optional[int] = None  # occupied-tile budget (None = all tiles)
    # strict=True skips the frozen fallback (one [N]-row gather per substep)
    # by ASSERTING overflow never happens: check overflow_count first
    strict: bool = False


def default_spec(cfg: Config, n_particles: Optional[int] = None) -> TileSpec:
    """About 6x the rest-density particles per tile; ``active`` covers
    every tile."""
    t = 4
    cap = int(math.ceil(cfg.rest_density * t**cfg.dim * 6.0))
    cap = max(32, -(-cap // 8) * 8)
    return TileSpec(tile=t, cap=cap, active=None)


def _tile_geometry(domain: Domain, spec: TileSpec):
    T = spec.tile
    if any(s % T for s in domain.shape):
        raise ValueError(f"grid shape {domain.shape} not divisible by tile={T}")
    tshape = tuple(s // T for s in domain.shape)
    return tshape, math.prod(tshape)


def _flatten_coords(c: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """[..., D] coordinates -> C-order flat index."""
    out = c[..., 0]
    for d in range(1, len(shape)):
        out = out * shape[d] + c[..., d]
    return out


def _unflatten(idx: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """C-order flat index -> [..., D] coordinates."""
    out = []
    for d in range(len(shape) - 1, -1, -1):
        out.append(idx % shape[d])
        idx = idx // shape[d]
    return torch.stack(out[::-1], dim=-1)


def bin_particles(pos: torch.Tensor, domain: Domain, spec: TileSpec) -> dict:
    """Sort by tile id, compact occupied tiles, build the slot structure.

    Returns a dict of int64 tensors (bool for masks) on ``pos``'s device:
      order [N], sid [N] (sorted tile ids), start [nt+1],
      tile_of_active [A] (nt = unused), act_start [A], act_count [A],
      valid [A, cap], frozen [N] (sorted order: slot or budget overflow),
    and the host values tshape and n_active (A).
    """
    tshape, nt = _tile_geometry(domain, spec)
    T, cap = spec.tile, spec.cap
    A = spec.active if spec.active is not None else nt
    n = pos.shape[0]
    dev = pos.device
    cf = torch.floor(pos).to(torch.int64)
    cell = torch.stack(
        [(cf[:, d] - domain.origin[d]).clamp(0, domain.shape[d] - 1) for d in range(len(tshape))],
        dim=-1,
    )
    tid = _flatten_coords(cell // T, tshape)

    order = torch.argsort(tid, stable=True)
    sid = tid[order]
    ranks = torch.arange(n, device=dev)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    start = torch.full((nt + 1,), n, dtype=torch.int64, device=dev)
    start.scatter_reduce_(0, sid, torch.where(first, ranks, n), "amin", include_self=True)
    start = torch.cummin(start.flip(0), 0).values.flip(0)
    count = start[1:] - start[:-1]  # [nt]

    occ = count > 0
    rank = torch.cumsum(occ.to(torch.int64), 0) - 1  # occupied rank per tile
    act_of_tile = torch.where(occ & (rank < A), rank, A)  # A = "inactive"
    tile_of_active = torch.full((A,), -1, dtype=torch.int64, device=dev)
    tile_of_active.scatter_reduce_(
        0, act_of_tile.clamp(0, A - 1),
        torch.where(act_of_tile < A, torch.arange(nt, device=dev), -1),
        "amax", include_self=True,
    )
    tile_of_active = torch.where(tile_of_active < 0, nt, tile_of_active)

    # start[nt] == n, so an unused entry starts past the last particle
    act_start = start[tile_of_active]
    act_count = torch.cat([count, count.new_zeros(1)])[tile_of_active]
    valid = torch.arange(cap, device=dev)[None, :] < act_count[:, None]

    slot_rank = ranks - start[:-1][sid]
    frozen = (slot_rank >= cap) | (act_of_tile[sid] >= A)
    return dict(
        order=order, sid=sid, start=start, tile_of_active=tile_of_active,
        act_start=act_start, act_count=act_count, valid=valid, frozen=frozen,
        tshape=tshape, n_active=A,
    )


def overflow_count(pos: torch.Tensor, domain: Domain, spec: TileSpec) -> torch.Tensor:
    """Particles that would freeze (slot or active-budget overflow)."""
    return bin_particles(pos, domain, spec)["frozen"].sum()
