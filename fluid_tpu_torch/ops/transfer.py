"""Particle<->grid transfer — the dense reference path (PyTorch port).

Counterpart of ``fluid_tpu/ops/transfer.py``: the reference's four phases
(``2d_multi.rs:148-359``) as whole-array ops over the particles, with the
3^D stencil as a broadcast against the static offset table.  Scatters are
``index_add_`` into the flattened dense grid; gathers are plain indexing.
It is the plain reference of the whole slice, on the CPU and on the card
(``index_add_`` on CUDA sums in no fixed order, so dense results on the card
are not bit-reproducible; the stream backend's kernels are).

Quirks carried over (SURVEY.md §2.3): the mouse impulse acts after advection
(Q3, ``2d_multi.rs:289-298``) and the soft wall looks ahead by the un-scaled
velocity from the clamped position (Q2, ``2d_multi.rs:302-325``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import Config
from ..domain import Domain
from ..state import GridState, ParticleState
from ..utils.graph import device_const
from .bspline import quadratic_weights, stencil_offsets, stencil_weights
from .eos import stress_tensor, tait_pressure


def stencil_geometry(pos: torch.Tensor, domain: Domain):
    """Per-particle stencil: (flat cell index [N, K] int64, dpos [N, K, D],
    w [N, K], valid [N, K]); taps outside the grid are masked by ``valid``
    and index a clamped cell (``2d_multi.rs:165-167``)."""
    dim = pos.shape[-1]
    dev = pos.device
    cell = torch.floor(pos).to(torch.int64)
    diff = pos - (cell.to(pos.dtype) + 0.5)
    w = stencil_weights(quadratic_weights(diff))
    cell_n = cell[:, None, :] + (stencil_offsets(dim, dev) - 1)[None]
    dpos = (cell_n.to(pos.dtype) + 0.5) - pos[:, None, :]
    shape = device_const(domain.shape, dev)
    idx = cell_n - device_const(domain.origin, dev)
    valid = ((idx >= 0) & (idx < shape)).all(dim=-1)
    idx = torch.minimum(idx.clamp_min(0), shape - 1)
    flat = idx[..., 0]
    for d in range(1, dim):
        flat = flat * domain.shape[d] + idx[..., d]
    return flat, dpos, w, valid


def p2g_1(p: ParticleState, cfg: Config, domain: Domain) -> GridState:
    """Scatter ``w m`` into cell mass and ``w m (v + C dpos)`` into cell
    momentum (``2d_multi.rs:148-180``)."""
    flat, dpos, w, valid = stencil_geometry(p.pos, domain)
    mass_contrib = torch.where(valid, w * p.mass[:, None], 0.0)
    q = torch.einsum("nij,nkj->nki", p.C, dpos)
    mom = mass_contrib[..., None] * (p.vel[:, None, :] + q)
    grid = GridState.zeros(domain.shape, device=p.pos.device)
    grid.mass.view(-1).index_add_(0, flat.reshape(-1), mass_contrib.reshape(-1))
    grid.vel.view(-1, p.dim).index_add_(0, flat.reshape(-1), mom.reshape(-1, p.dim))
    return grid


def p2g_2(p: ParticleState, grid: GridState, cfg: Config, domain: Domain
          ) -> Tuple[GridState, torch.Tensor, torch.Tensor]:
    """Density gather, Tait pressure, viscous stress, and the eq-16 force
    scatter ``w (-4 V sigma dt) dpos`` (``2d_multi.rs:182-238``).  Returns
    (grid with updated momentum, density [N], pressure [N])."""
    flat, dpos, w, valid = stencil_geometry(p.pos, domain)
    w = torch.where(valid, w, 0.0)
    density = (grid.mass.reshape(-1)[flat] * w).sum(dim=-1)
    pos_density = torch.where(density > 0.0, density, 1.0)
    volume = torch.where(density > 0.0, p.mass / pos_density, 0.0)
    pressure = tait_pressure(
        density, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
        cfg.pressure_floor,
    )
    stress = stress_tensor(p.C, pressure, cfg.dynamic_viscosity)
    term = (-4.0 * cfg.dt) * volume[:, None, None] * stress
    contrib = w[..., None] * torch.einsum("nij,nkj->nki", term, dpos)
    vel = grid.vel.clone()
    vel.view(-1, p.dim).index_add_(0, flat.reshape(-1), contrib.reshape(-1, p.dim))
    return GridState(mass=grid.mass, vel=vel), density, pressure


def grid_update(grid: GridState, cfg: Config) -> GridState:
    """``vel = where(mass > 0, momentum / mass + dt g, 0)``
    (``2d_multi.rs:240-250``)."""
    g = device_const(cfg.gravity, grid.vel.device, torch.float32)
    m = grid.mass[..., None]
    vel = torch.where(
        m > 0.0, grid.vel / torch.where(m > 0.0, m, 1.0) + cfg.dt * g, 0.0
    )
    return GridState(mass=grid.mass, vel=vel)


def g2p(p: ParticleState, grid: GridState, cfg: Config, domain: Domain,
        mouse_pos: torch.Tensor, mouse_active: torch.Tensor,
        density: torch.Tensor, pressure: torch.Tensor) -> ParticleState:
    """Gather grid velocity, rebuild C = 4 B, advect, then the mouse impulse
    (Q3) and the clamp + un-scaled soft wall (Q2) (``2d_multi.rs:252-359``)."""
    dev = p.pos.device
    flat, dpos, w, valid = stencil_geometry(p.pos, domain)
    w = torch.where(valid, w, 0.0)
    wv = w[..., None] * grid.vel.reshape(-1, p.dim)[flat]
    vel = wv.sum(dim=1)
    C = 4.0 * torch.einsum("nki,nkj->nij", wv, dpos)
    pos = p.pos + vel * cfg.dt

    mouse_pos = mouse_pos.to(device=dev, dtype=torch.float32)
    mouse_active = mouse_active.to(dev)
    dist = pos[:, :2] - mouse_pos
    dist_sq = (dist * dist).sum(dim=-1)
    norm = torch.sqrt(dist_sq)
    push = torch.where(
        norm[:, None] > 0.0, dist / torch.where(norm > 0.0, norm, 1.0)[:, None], 0.0
    )
    hit = mouse_active & (dist_sq < cfg.mouse_radius * cfg.mouse_radius)
    vel = vel.clone()
    vel[:, :2] = vel[:, :2] + torch.where(hit[:, None], push, 0.0)

    lo = device_const(cfg.boundary_clip[0], dev, torch.float32)
    hi = device_const(cfg.boundary_clip[1], dev, torch.float32)
    pos = torch.clamp(pos, lo, hi)
    nxt = pos + vel
    wall_min = lo + cfg.boundary_damp_dist
    wall_max = hi - cfg.boundary_damp_dist
    vel = vel + torch.where(nxt < wall_min, wall_min - nxt, 0.0)
    vel = vel + torch.where(nxt > wall_max, wall_max - nxt, 0.0)
    return ParticleState(pos=pos, vel=vel, C=C, mass=p.mass,
                         density=density, pressure=pressure)
