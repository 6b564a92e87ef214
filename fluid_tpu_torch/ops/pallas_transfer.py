"""The "pallas" backend: tile-binned substep over a sorted particle stream
(PyTorch port of ``fluid_tpu/ops/pallas_transfer.py``).

Every substep bins the particles by tile (``tiled_transfer.bin_particles``)
and packs them, in tile-sorted order, into a field-major stream ``[FP, N]``
(FP = 2D + D^2 + 1 rows: pos, vel, C, mass), so each tile's particles are
one contiguous run of columns.  Three kernels (``pallas_kernels``; CUDA on
the card, their plain versions on the CPU) do the particle work:

  deposit   p2g_1: mass + APIC momentum of each active tile into its
            expanded block [A, E^D, 1+D] (E = T + 2)
  p2g2      density from the halo'd mass block, Tait EOS, stress, and the
            eq-16 force block [A, E^D, D]
  collect   g2p + particle tail (advect, mouse Q3, clamp + soft wall Q2)
            into slot-major rows [A, FO, cap]

Between them, plain PyTorch does what XLA did in JAX: blocks to the dense
per-tile array, the halo sum in block space (``tiling.halo_sum``), the edge
mask, the grid update on active blocks, and the un-bin.  Shapes are static
and nothing is read back from the device during a substep.

Dropped from the TPU version: the stream's zero rows past the end and its
lane padding to 128 (a kernel reads only its tile's min(count, cap)
columns), the double-buffered DMA of ``_pipelined_load``, and ``interpret``.

PyTorch runs eagerly, so there is no dead-code elimination of the dense
``GridState`` the JAX substep returns: ``substep`` assembles it, and
``frame`` (what ``step.frame`` runs) skips it.
"""

from __future__ import annotations

import types
from typing import Optional, Tuple

import torch

from ..config import Config
from ..domain import Domain
from ..state import GridState, ParticleState
from ..utils.graph import device_const
from . import pallas_kernels as pk
from . import tiled_transfer as tt
from .stream_kernels import TileGeom, gravity_step
from .tiling import assemble, edge_mask, halo_sum


def collect_params(cfg: Config, mouse_pos, mouse_active, device) -> torch.Tensor:
    """[10 + 2D] f32: dt, rest_density, eos_stiffness, eos_power,
    pressure_floor, mouse_radius, boundary_damp_dist, mouse_active, mouse_x,
    mouse_y, clip_lo[D], clip_hi[D].  The mouse tensors are copied on the
    device, never read on the host."""
    lo, hi = cfg.boundary_clip
    head = device_const([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                         cfg.pressure_floor, cfg.mouse_radius, cfg.boundary_damp_dist],
                        device, torch.float32)
    mouse = [torch.as_tensor(mouse_active).reshape(1), torch.as_tensor(mouse_pos).reshape(2)]
    mouse = [m.to(device, torch.float32, non_blocking=True) for m in mouse]
    return torch.cat([head, *mouse, device_const([*lo, *hi], device, torch.float32)])


def make_plan(cfg: Config, domain: Domain, spec: tt.TileSpec, mouse_pos, mouse_active, device):
    """What every substep of a frame shares: geometry, kernel parameters,
    gravity step and the edge mask with a zero row for unused entries."""
    tshape, nt = tt._tile_geometry(domain, spec)
    D = len(tshape)
    emask = edge_mask(tshape, spec.tile, device=device).reshape(nt, -1)
    return types.SimpleNamespace(
        spec=spec, tshape=tshape, nt=nt,
        geom=TileGeom(dim=D, tile=spec.tile, halo=1, cap=spec.cap, tshape=tshape,
                      origin=tuple(int(o) for o in domain.origin)),
        params6=device_const([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                              cfg.pressure_floor, cfg.dynamic_viscosity], device, torch.float32),
        params_c=collect_params(cfg, mouse_pos, mouse_active, device),
        dtg=device_const(gravity_step(cfg.dt, cfg.gravity), device),
        emask=torch.cat([emask, emask.new_zeros((1, emask.shape[1]))]),
    )


def bin_stream(p: ParticleState, domain: Domain, plan):
    """Bin the particles and pack the tile-sorted field-major stream
    [FP, N]; ``tiles`` are the kernels' (act_start, act_count, tid) int32
    rows and ``emask`` the edge mask of every active entry [A, E^D, 1]."""
    D, n, nt = p.dim, p.n, plan.nt
    b = tt.bin_particles(p.pos, domain, plan.spec)
    toa = b["tile_of_active"]
    packed = torch.cat([p.pos, p.vel, p.C.reshape(n, D * D), p.mass[:, None]], dim=1)
    return types.SimpleNamespace(
        b=b, toa=toa,
        stream=packed[b["order"]].t().contiguous(),
        tiles=(b["act_start"].to(torch.int32), b["act_count"].to(torch.int32),
               toa.clamp(0, nt - 1).to(torch.int32)),
        emask=plan.emask[toa][..., None],
    )


def _to_dense(blocks: torch.Tensor, toa: torch.Tensor, plan) -> torch.Tensor:
    """Active blocks [A, E^D, CH] -> per-tile blocks [nt, E, ..., E, CH].
    Rows are distinct, so a copy (not an add) keeps the result
    deterministic; unused entries land in the dropped sentinel row nt."""
    A, ncell, CH = blocks.shape
    dense = blocks.new_zeros((plan.nt + 1, ncell * CH))
    dense.index_copy_(0, toa, blocks.reshape(A, -1))
    return dense[:plan.nt].reshape(plan.nt, *(plan.geom.E,) * plan.geom.dim, CH)


def halo_blocks(blocks: torch.Tensor, st, plan):
    """Kernel blocks [A, E^D, CH] -> (per-tile blocks before the halo sum,
    active blocks after it, edge-masked)."""
    dense = _to_dense(blocks, st.toa, plan)
    x = halo_sum(dense, plan.tshape, plan.spec.tile).reshape(plan.nt, -1)
    x = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return dense, x[st.toa].reshape(blocks.shape) * st.emask


def grid_velocity(mom: torch.Tensor, mass: torch.Tensor, dtg: torch.Tensor) -> torch.Tensor:
    """The grid update: momentum / mass + dt g where mass > 0, else 0."""
    return torch.where(mass > 0.0, mom / torch.where(mass > 0.0, mass, 1.0) + dtg, 0.0)


def _advance(p: ParticleState, domain: Domain, plan, preserve_order: bool):
    """One substep on the tile-binned stream.  Returns the new particles
    and the per-tile p2g_1 and force blocks before the halo sum."""
    spec, g = plan.spec, plan.geom
    D, n, cap = p.dim, p.n, spec.cap
    st = bin_stream(p, domain, plan)
    b, order = st.b, st.b["order"]
    A = b["n_active"]

    blocks1 = pk.deposit(st.stream, *st.tiles, g, mode="p2g1")
    dense1, act1 = halo_blocks(blocks1, st, plan)
    mblocks = act1[..., 0:1].contiguous()
    dense2, act2 = halo_blocks(pk.p2g2(st.stream, mblocks, *st.tiles, plan.params6, g), st, plan)
    v_b = grid_velocity(act1[..., 1:] + act2, mblocks, plan.dtg)
    out_slots = pk.collect(st.stream, v_b, mblocks, *st.tiles, plan.params_c, g)
    FO = out_slots.shape[1]  # pos, vel, C, rho, pressure, mass

    # un-bin: sorted particle r sits in slot (occupied rank, rank in tile)
    count = b["start"][1:] - b["start"][:-1]
    s_rank = torch.arange(n, device=p.device) - b["start"][:-1][b["sid"]]
    occ_rank = (torch.cumsum((count > 0).to(torch.int64), 0) - 1)[b["sid"]]
    sorted_out = out_slots[occ_rank.clamp(0, A - 1), :, s_rank.clamp(0, cap - 1)]  # [N, FO]

    if not spec.strict:
        fallback = torch.cat([p.pos, p.vel, p.C.reshape(n, D * D), p.density[:, None],
                              p.pressure[:, None], p.mass[:, None]], dim=1)
        sorted_out = torch.where(b["frozen"][:, None], fallback[order], sorted_out)

    if preserve_order:
        unpacked = torch.empty_like(sorted_out).index_copy_(0, order, sorted_out)
        mass_out = p.mass
    else:
        unpacked = sorted_out
        mass_out = unpacked[:, FO - 1].contiguous()

    out = ParticleState(
        pos=unpacked[:, 0:D].contiguous(),
        vel=unpacked[:, D:2 * D].contiguous(),
        C=unpacked[:, 2 * D:2 * D + D * D].reshape(n, D, D),
        mass=mass_out,
        density=unpacked[:, FO - 3].contiguous(),
        pressure=unpacked[:, FO - 2].contiguous(),
    )
    return out, dense1, dense2


def substep(p: ParticleState, cfg: Config, domain: Domain, mouse_pos, mouse_active,
            spec: Optional[tt.TileSpec] = None, preserve_order: bool = True
            ) -> Tuple[ParticleState, GridState]:
    """One MLS-MPM substep through the three kernels; returns the particles
    and the dense post-update grid.  Same physics as the dense backend,
    quirks Q2/Q3 included.

    ``preserve_order=False`` returns the particles in tile-sorted order
    (mass travels with them) instead of the caller's, skipping the inverse
    permutation."""
    if spec is None:
        spec = tt.default_spec(cfg, p.n)
    plan = make_plan(cfg, domain, spec, mouse_pos, mouse_active, p.device)
    out, dense1, dense2 = _advance(p, domain, plan, preserve_order)
    T = spec.tile
    grid_all = assemble(dense1, plan.tshape, T)
    grid_m = grid_all[..., 0]
    grid_mv = grid_all[..., 1:] + assemble(dense2, plan.tshape, T)
    return out, GridState(mass=grid_m, vel=grid_velocity(grid_mv, grid_m[..., None], plan.dtg))


def frame(p: ParticleState, cfg: Config, domain: Domain, mouse_pos, mouse_active,
          substeps: Optional[int] = None) -> ParticleState:
    """``cfg.iterations`` substeps (or ``substeps``) with ``default_spec``,
    without the dense grid that ``substep`` assembles for its callers."""
    plan = make_plan(cfg, domain, tt.default_spec(cfg, p.n), mouse_pos, mouse_active, p.device)
    for _ in range(cfg.iterations if substeps is None else substeps):
        p = _advance(p, domain, plan, preserve_order=True)[0]
    return p
