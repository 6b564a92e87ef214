"""The sorted backend (PyTorch port of ``fluid_tpu/ops/sorted_transfer.py``).

Particles are ordered by flattened cell id once per substep; for a fixed
stencil offset the target cell of every particle is its cell id plus a
constant, which stays sorted, so each of the 3^D per-offset scatters of a
deposit is a segment sum over sorted ids.  ``_seg_sum`` takes each
segment's sum in slot order (``torch.segment_reduce`` over the offsets of
the sorted ids), never with atomics, so the grid sums alike on every run
and a replayed frame is bit-identical on the card, as
``segment_sum(..., indices_are_sorted=True)`` fixes JAX's order.

The particles are returned in their original order (one inverse
permutation), so the backend is a drop-in for the dense one; results
differ only in float32 summation order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import Config
from ..domain import Domain
from ..state import FIELDS, GridState, ParticleState
from ..utils.graph import device_const
from .bspline import _stencil_offsets_np, quadratic_weights, stencil_weights
from .eos import stress_tensor, tait_pressure


def _flat_strides(shape: Tuple[int, ...]) -> np.ndarray:
    """C-order strides (in elements) for flattening cell coordinates."""
    return np.array([int(np.prod(shape[d + 1:], dtype=np.int64)) for d in range(len(shape))],
                    np.int64)


def sort_by_cell(p: ParticleState, domain: Domain):
    """Order particles by flattened cell id (a stable sort, as
    ``jnp.argsort``).  Returns (sorted state, sorted flat cell id [N],
    inverse permutation [N])."""
    dev = p.device
    strides = device_const(_flat_strides(domain.shape), dev)
    origin = device_const(domain.origin, dev)
    shape = device_const(domain.shape, dev)
    # out-of-grid cells are clamped per axis; their taps are masked later
    cell = torch.minimum((torch.floor(p.pos).to(torch.int64) - origin).clamp_min(0), shape - 1)
    flat = (cell * strides).sum(dim=-1)
    order = torch.argsort(flat, stable=True)
    inv = torch.argsort(order, stable=True)
    sorted_p = ParticleState(**{f: getattr(p, f)[order] for f in FIELDS})
    return sorted_p, flat[order], inv


def _tap_ids_and_masks(p: ParticleState, flat_sorted: torch.Tensor, domain: Domain):
    """Per-tap geometry of cell-sorted particles: (ids, K tensors [N],
    clamped and sorted; valid [N, K]; w [N, K]; dpos [N, K, D])."""
    dev = p.device
    offs_np = _stencil_offsets_np(p.dim) - 1  # [K, D] in {-1, 0, 1}
    strides_np = _flat_strides(domain.shape)
    shape = device_const(domain.shape, dev)
    origin = device_const(domain.origin, dev)

    cell = torch.floor(p.pos).to(torch.int64)  # [N, D] world cells
    w = stencil_weights(quadratic_weights(p.pos - (cell.to(p.pos.dtype) + 0.5)))  # [N, K]
    offs = device_const(offs_np, dev)
    idxk = (cell - origin)[:, None, :] + offs[None]  # [N, K, D]
    valid = ((idxk >= 0) & (idxk < shape)).all(dim=-1)
    dpos = ((cell[:, None, :] + offs[None]).to(p.pos.dtype) + 0.5) - p.pos[:, None, :]
    ncells = domain.num_cells
    ids = [(flat_sorted + int((off * strides_np).sum())).clamp(0, ncells - 1) for off in offs_np]
    return ids, valid, w, dpos


def _seg_sum(vals: torch.Tensor, ids: torch.Tensor, ncells: int) -> torch.Tensor:
    """Sums of ``vals`` [N, ...] over the runs of equal sorted ``ids`` [N]
    -> [ncells, ...]: each run summed in slot order, empty cells 0."""
    offsets = torch.searchsorted(ids, torch.arange(ncells + 1, device=ids.device))
    return torch.segment_reduce(vals, "sum", offsets=offsets, axis=0, unsafe=True)


def substep(p: ParticleState, cfg: Config, domain: Domain, mouse_pos, mouse_active
            ) -> Tuple[ParticleState, GridState]:
    """One substep on the cell-sorted layout: the four phases of the
    reference (p2g_1 ``2d_multi.rs:148-180``, p2g_2 ``:182-238``, update
    ``:240-250``, g2p ``:252-359``), with segment sums for scatters."""
    ncells, dim, dev = domain.num_cells, p.dim, p.device
    ps, flat, inv = sort_by_cell(p, domain)
    ids, valid, w, dpos = _tap_ids_and_masks(ps, flat, domain)
    K = len(ids)

    # ---- p2g_1: mass + APIC momentum (one segment sum per tap) -----------
    mc = torch.where(valid, w * ps.mass[:, None], 0.0)  # [N, K]
    q = torch.einsum("nij,nkj->nki", ps.C, dpos)
    mom = mc[..., None] * (ps.vel[:, None, :] + q)  # [N, K, D]
    m_mv = torch.cat([mc[..., None], mom], dim=-1)  # [N, K, 1+D]
    grid = p.pos.new_zeros((ncells, 1 + dim))
    for k in range(K):
        grid = grid + _seg_sum(m_mv[:, k], ids[k], ncells)
    grid_m, grid_mv = grid[:, 0], grid[:, 1:]

    # ---- p2g_2: density gather + EOS + force scatter --------------------
    wv = torch.where(valid, w, 0.0)
    density = p.pos.new_zeros((ps.n,))
    for k in range(K):
        density = density + wv[:, k] * grid_m[ids[k]]
    pos_density = torch.where(density > 0.0, density, 1.0)
    volume = torch.where(density > 0.0, ps.mass / pos_density, 0.0)
    pressure = tait_pressure(density, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                             cfg.pressure_floor)
    stress = stress_tensor(ps.C, pressure, cfg.dynamic_viscosity)
    term = (-4.0 * cfg.dt) * volume[:, None, None] * stress  # [N, D, D]
    contrib = wv[..., None] * torch.einsum("nij,nkj->nki", term, dpos)  # [N, K, D]
    for k in range(K):
        grid_mv = grid_mv + _seg_sum(contrib[:, k], ids[k], ncells)

    # ---- update_grid ----------------------------------------------------
    g = device_const(cfg.gravity, dev, p.pos.dtype)
    m = grid_m[:, None]
    grid_v = torch.where(m > 0.0, grid_mv / torch.where(m > 0.0, m, 1.0) + cfg.dt * g, 0.0)

    # ---- g2p: gather + advect + boundary conditions ----------------------
    vel = torch.zeros_like(ps.vel)
    B = torch.zeros_like(ps.C)
    for k in range(K):
        wvk = wv[:, k, None] * grid_v[ids[k]]  # [N, D]
        vel = vel + wvk
        B = B + wvk[:, :, None] * dpos[:, k, None, :]  # outer(wv, dpos)
    C = 4.0 * B
    pos = ps.pos + vel * cfg.dt

    # mouse (quirk Q3), clamp and soft wall (quirk Q2), as the dense path
    mouse_pos = mouse_pos.to(device=dev, dtype=pos.dtype)
    dist = pos[:, :2] - mouse_pos
    dist_sq = (dist * dist).sum(dim=-1)
    norm = torch.sqrt(dist_sq)
    push2 = torch.where(norm[:, None] > 0.0, dist / torch.where(norm > 0.0, norm, 1.0)[:, None],
                        0.0)
    hit = mouse_active.to(dev) & (dist_sq < cfg.mouse_radius * cfg.mouse_radius)
    push = torch.cat([push2, torch.zeros_like(vel[:, 2:])], dim=1)
    vel = vel + torch.where(hit[:, None], push, 0.0)

    lo = device_const(cfg.boundary_clip[0], dev, pos.dtype)
    hi = device_const(cfg.boundary_clip[1], dev, pos.dtype)
    pos = torch.clamp(pos, lo, hi)
    nxt = pos + vel
    wall_min = lo + cfg.boundary_damp_dist
    wall_max = hi - cfg.boundary_damp_dist
    vel = vel + torch.where(nxt < wall_min, wall_min - nxt, 0.0)
    vel = vel + torch.where(nxt > wall_max, wall_max - nxt, 0.0)

    out_sorted = dict(pos=pos, vel=vel, C=C, mass=ps.mass, density=density, pressure=pressure)
    # back to the original slot order (a drop-in for the dense backend)
    out = ParticleState(**{f: v[inv] for f, v in out_sorted.items()})
    grid = GridState(mass=grid_m.reshape(domain.shape),
                     vel=grid_v.reshape(*domain.shape, dim))
    return out, grid
