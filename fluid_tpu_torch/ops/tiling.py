"""Tile blocks <-> dense grid, and the halo sum in block space (PyTorch port).

Counterpart of ``fluid_tpu/ops/tiling.py``.  A tile of T^D cells owns an
expanded block of E = T + 2 cells per axis (its cells plus a one-cell
stencil halo on every side); block cell e of tile t lies on grid cell
``t*T + e - 1`` along each axis.

* ``assemble``: overlap-add every tile's block into the dense grid;
* ``extract``: the transpose, each tile's window read from the grid;
* ``halo_sum``: every block cell gets the global sum at its grid cell,
  from its neighbours' blocks, without a dense grid;
* ``edge_mask``: 1 where a block cell lies on the grid, 0 in the halo of
  boundary tiles (the reference drops those taps, ``2d_multi.rs:165-167``).

The JAX module realises the stride-T comb with padded panels and reshapes,
a TPU answer to its lack of strided writes; here it is a strided slice-add,
which sums the same terms in the same order.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def _axis_pass_assemble(x: torch.Tensor, axis: int, T: int) -> torch.Tensor:
    """One axis of overlap-add: [..., nt, E, ...] -> [..., nt*T + E - T, ...]
    (index ``t*T + e`` along the merged axis: the out-of-grid halo cell at
    each end is kept; callers crop)."""
    nt, E = x.shape[axis], x.shape[axis + 1]
    shape = list(x.shape[:axis]) + [nt * T + E - T] + list(x.shape[axis + 2:])
    canvas = x.new_zeros(shape)
    lead = (slice(None),) * axis
    for e in range(E):
        canvas[lead + (slice(e, e + nt * T, T),)] += x.select(axis + 1, e)
    return canvas


def _axis_pass_extract(x: torch.Tensor, axis: int, T: int, E: int) -> torch.Tensor:
    """One axis of windowed read: [..., nt*T + E - T, ...] -> [..., nt, E, ...]."""
    nt = (x.shape[axis] - (E - T)) // T
    idx = (torch.arange(nt, device=x.device)[:, None] * T
           + torch.arange(E, device=x.device)[None, :]).reshape(-1)
    out = x.index_select(axis, idx)
    return out.reshape(*x.shape[:axis], nt, E, *x.shape[axis + 1:])


def assemble(blocks: torch.Tensor, tshape: Tuple[int, ...], T: int) -> torch.Tensor:
    """Overlap-add tile blocks [n_tiles, E, ..., E, *chan] (C-order tiles)
    into the dense grid [tshape[0]*T, ..., *chan]; out-of-grid halo cells
    are dropped."""
    D = len(tshape)
    E = blocks.shape[1]
    h = (E - T) // 2
    chan = blocks.shape[1 + D:]
    x = blocks.reshape(*tshape, *(E,) * D, *chan)
    perm = [i for d in range(D) for i in (d, D + d)] + [2 * D + i for i in range(len(chan))]
    x = x.permute(perm)  # [nt0, E, nt1, E, ..., *chan]
    for d in range(D):
        x = _axis_pass_assemble(x, d, T)
    return x[tuple(slice(h, h + tshape[d] * T) for d in range(D))]


def extract(grid: torch.Tensor, tshape: Tuple[int, ...], T: int, halo: int = 1) -> torch.Tensor:
    """Each tile's expanded window [n_tiles, E, ..., E, *chan] (E = T +
    2*halo) read from the dense grid [tshape[0]*T, ..., *chan]; out-of-grid
    cells read as 0."""
    D = len(tshape)
    E = T + 2 * halo
    chan = grid.shape[D:]
    x = grid.new_zeros([s + 2 * halo for s in grid.shape[:D]] + list(chan))
    x[tuple(slice(halo, halo + s) for s in grid.shape[:D])] = grid
    for d in range(D):
        x = _axis_pass_extract(x, 2 * d, T, E)  # axis d sits at 2d after the splits
    perm = [2 * d for d in range(D)] + [2 * d + 1 for d in range(D)]
    perm += [2 * D + i for i in range(len(chan))]
    return x.permute(perm).reshape(math.prod(tshape), *(E,) * D, *chan)


def halo_sum(blocks: torch.Tensor, tshape: Tuple[int, ...], T: int) -> torch.Tensor:
    """Overlap-add in block space: afterwards every block cell holds the
    global sum at its grid cell.  One separable pass per axis, two slice-adds
    each (from the +1 and the -1 neighbour); out-of-grid cells are not
    cropped, apply ``edge_mask`` after."""
    D = len(tshape)
    E = blocks.shape[1]
    chan = blocks.shape[1 + D:]
    x = blocks.reshape(*tshape, *(E,) * D, *chan)

    def sl(d, tile_s, e_s):
        idx = [slice(None)] * (2 * D)
        idx[d] = tile_s
        idx[D + d] = e_s
        return tuple(idx)

    for d in range(D):
        out = x.clone()
        # from the +1 neighbour: my e in [T, E) is its [0, E-T)
        out[sl(d, slice(None, -1), slice(T, E))] += x[sl(d, slice(1, None), slice(0, E - T))]
        # from the -1 neighbour: my e in [0, E-T) is its [T, E)
        out[sl(d, slice(1, None), slice(0, E - T))] += x[sl(d, slice(None, -1), slice(T, E))]
        x = out
    return x.reshape(math.prod(tshape), *(E,) * D, *chan)


def edge_mask(tshape: Tuple[int, ...], T: int, dtype=torch.float32, halo: int = 1,
              device=None) -> torch.Tensor:
    """[n_tiles, E, ..., E] mask: 1 where the block cell maps to a grid
    cell, 0 in the out-of-grid halo of boundary tiles.  E = T + 2*halo."""
    D = len(tshape)
    E = T + 2 * halo
    per_axis = []
    for d in range(D):
        g = (torch.arange(tshape[d], device=device)[:, None] * T
             + torch.arange(E, device=device)[None, :] - halo)
        per_axis.append(((g >= 0) & (g < tshape[d] * T)).to(dtype))
    m = per_axis[0]
    for d in range(1, D):
        m = m[..., None, None] * per_axis[d]  # grows as [t0, E, t1, E, ...]
    perm = [2 * d for d in range(D)] + [2 * d + 1 for d in range(D)]
    return m.permute(perm).reshape(math.prod(tshape), *(E,) * D)
