"""The tiled backend (PyTorch port of ``fluid_tpu/ops/tiled_transfer.py``).

Particles are sorted by the tile (T^D cells) of their cell; each tile's
particles then lie in one contiguous run of the sorted order, starting at
``start[tile]``.  Occupied tiles are compacted, in tile order, into a
static budget of ``active`` entries (``tile_of_active``; ``nt`` marks an
unused entry).  A tile holds at most ``cap`` particles; the particles past
``cap`` and those of occupied tiles beyond the budget are ``frozen`` for
the substep (their old state passes through) and counted by
``overflow_count``.  The "pallas" backend bins with ``bin_particles`` too.

The sort is stable, as ``jnp.argsort`` is: the order inside a tile decides
which particles take the ``cap`` slots and the order of every sum, so
binning equals the JAX module's exactly.  Every shape is known on the host
(``A = spec.active or nt``), so binning reads nothing back from the device.

``substep`` runs one MLS-MPM substep on the binned slots ``[A, F, cap]``
(``cap`` minor): per-axis quadratic B-spline profiles over each tile's
expanded window (E = T + 2), the deposits and the collects as staged
tensor-product contractions ending in one batched matrix product over the
slots (``torch.bmm`` in float32, TF32 off; JAX's ``lax.dot_general``
outside any kernel), the halo sum in block space (``ops/tiling.py``) and
one packed un-bin.  No scatter sums in an order that varies: the block
scatter targets distinct tiles (the unused entries land in a padding row
that is dropped) and the un-bin is a permutation, so a replayed frame is
bit-identical on the card.  ``frame`` runs substeps without assembling the
dense grid that ``substep`` returns (XLA drops it from JAX's frame loop
when nothing reads it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from ..config import Config
from ..domain import Domain
from ..state import GridState, ParticleState
from ..utils.graph import device_const
from .eos import tait_pressure
from .tiling import assemble, edge_mask, halo_sum


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
      bsrc [A, cap] (original particle index per slot), valid [A, cap],
      frozen [N] (sorted order: slot or budget overflow),
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
    s_arange = torch.arange(cap, device=dev)
    valid = s_arange[None, :] < act_count[:, None]
    bsrc = order[(act_start[:, None] + s_arange[None, :]).clamp(0, n - 1)]

    slot_rank = ranks - start[:-1][sid]
    frozen = (slot_rank >= cap) | (act_of_tile[sid] >= A)
    return dict(
        order=order, sid=sid, start=start, tile_of_active=tile_of_active,
        act_start=act_start, act_count=act_count, bsrc=bsrc, valid=valid, frozen=frozen,
        tshape=tshape, n_active=A,
    )


# ---------------------------------------------------------------------------
# Profiles ([A, E, cap], cap minor) and contractions
# ---------------------------------------------------------------------------


def _axis_weights(dv: torch.Tensor) -> torch.Tensor:
    """dv [A, cap] -> [A, 3, cap] quadratic weights (``2d_multi.rs:368-374``)."""
    return torch.stack([0.5 * (0.5 - dv) ** 2, 0.75 - dv * dv, 0.5 * (0.5 + dv) ** 2], dim=1)


def _profiles_axis(blc_d: torch.Tensor, w3_d: torch.Tensor, E: int):
    """blc_d [A, cap] window row of each slot's first tap, w3_d [A, 3, cap].
    Returns the (plain, moment) profiles [A, E, cap]: the tap weight at
    each window row, and the weight times the tap offset o - 1."""
    e_io = torch.arange(E, device=blc_d.device)[None, :, None]
    plain = w3_d.new_zeros((w3_d.shape[0], E, w3_d.shape[2]))
    moment = torch.zeros_like(plain)
    for o in range(3):
        eq = e_io == (blc_d[:, None, :] + o)
        plain = plain + torch.where(eq, w3_d[:, o:o + 1, :], 0.0)
        moment = moment + torch.where(eq, w3_d[:, o:o + 1, :] * (o - 1.0), 0.0)
    return plain, moment


def _deposit(profs: List[torch.Tensor], ch: torch.Tensor) -> torch.Tensor:
    """profs: D profiles [A, E, cap]; ch [A, C, cap].  Returns blocks
    [A, E0, C * E1 * ... * E_{D-1}] (axis-0 window leading, then the
    channel-major trailing layout [C, E1, ..., E_{D-1}] flattened)."""
    A, _, cap = ch.shape
    X = ch  # ascending d keeps the trailing layout (C, E1, E2, ...)
    for d in range(1, len(profs)):
        X = (X[:, :, None, :] * profs[d][:, None, :, :]).reshape(A, -1, cap)
    # contract the slots: [A, E, cap] x [A, F, cap] -> [A, E, F]
    return torch.bmm(profs[0], X.transpose(1, 2))


def _collect(profs: List[torch.Tensor], blocks: torch.Tensor, C: int) -> torch.Tensor:
    """Transpose of ``_deposit``: blocks [A, E, C*E*...*E] -> per slot [A, C, cap]."""
    A, E = blocks.shape[0], profs[0].shape[1]
    cap = profs[0].shape[-1]
    X = torch.bmm(blocks.transpose(1, 2), profs[0])  # contract E0: [A, F, cap]
    for d in range(1, len(profs)):
        rest = X.shape[1] // (C * E)  # layout [A, C, E_d, rest, cap]
        X = X.reshape(A, C, E, rest, cap)
        X = (X * profs[d][:, None, :, None, :]).sum(dim=2).reshape(A, -1, cap)
    return X


def _axis_variants(plain, moment, d):
    return [moment[i] if i == d else plain[i] for i in range(len(plain))]


def _cat_profiles(plain, moment):
    """Per axis, the 1+D variant groups concatenated along the slots: group
    g uses the moment profile on axis g-1 and the plain one elsewhere, so
    sum_g P_g X_g is one product of the concatenations.  Returns D profiles
    [A, E, (1+D)*cap]."""
    D = len(plain)
    return [torch.cat([plain[axis]] + [moment[axis] if g == axis else plain[axis]
                                       for g in range(D)], dim=-1)
            for axis in range(D)]


def _deposit_merged(plain, moment, ch_groups) -> torch.Tensor:
    """The sum of the 1+D variant deposits as one contraction; ch_groups:
    1+D channel tensors [A, C, cap] (a group's unused rows are zero)."""
    return _deposit(_cat_profiles(plain, moment), torch.cat(ch_groups, dim=-1))


def _collect_all_variants(plain, moment, blocks: torch.Tensor, C: int):
    """All 1+D variant collects (plain, then the moment one of each axis)
    in one contraction: a list of 1+D tensors [A, C, cap]."""
    cap = plain[0].shape[-1]
    X = _collect(_cat_profiles(plain, moment), blocks, C)  # [A, C, (1+D)*cap]
    return [X[:, :, g * cap:(g + 1) * cap] for g in range(1 + len(plain))]


# ---------------------------------------------------------------------------
# Substep
# ---------------------------------------------------------------------------


def _advance(p: ParticleState, cfg: Config, domain: Domain, mouse_pos, mouse_active,
             spec: TileSpec, preserve_order: bool):
    """One substep on the tile-binned layout.  Returns the new particles
    and the per-tile p2g_1 and force blocks before the halo sum, dense over
    every tile ([nt, E, ..., E, CH], for the grid ``substep`` returns)."""
    D, n, dev = p.dim, p.n, p.device
    T, cap = spec.tile, spec.cap
    E = T + 2
    b = bin_particles(p.pos, domain, spec)
    tshape, nt = _tile_geometry(domain, spec)
    A = b["n_active"]
    toa = b["tile_of_active"]
    origin = device_const(domain.origin, dev)[None, :, None]
    shape = device_const(domain.shape, dev)[None, :, None]

    # ---- one packed gather into the slots [A, F, cap] --------------------
    packed = torch.cat([p.pos, p.vel, p.C.reshape(n, D * D), p.mass[:, None]], dim=1)
    F = packed.shape[1]
    binned = packed[b["bsrc"].reshape(-1)].reshape(A, cap, F).transpose(1, 2)
    bpos = binned[:, 0:D, :]
    bvel = binned[:, D:2 * D, :]
    bC = binned[:, 2 * D:2 * D + D * D, :].reshape(A, D, D, cap)
    bmass = torch.where(b["valid"], binned[:, F - 1, :], 0.0)  # [A, cap]

    # ---- local geometry --------------------------------------------------
    tco = _unflatten(toa.clamp(0, nt - 1), tshape)  # [A, D]
    bcell = torch.minimum((torch.floor(bpos).to(torch.int64) - origin).clamp_min(0), shape - 1)
    blc = (bcell - (tco * T)[:, :, None]).clamp(0, T - 1)
    dvec = bpos - (bcell + origin).to(bpos.dtype) - 0.5  # [A, D, cap]
    plain, moment = [], []
    for d in range(D):
        pl, mo = _profiles_axis(blc[:, d, :], _axis_weights(dvec[:, d, :]), E)
        plain.append(pl)
        moment.append(mo)

    # ---- p2g_1: mass + APIC momentum ------------------------------------
    # tap momentum m(v + C dpos_tap), dpos_tap = -dvec + (o - 1): the 1+D
    # variant groups (plain, then the moment of each axis) as one
    # contraction; a zero mass row aligns the moment groups' channels
    Cdv = torch.einsum("aijs,ajs->ais", bC, dvec)
    Aval = bmass[:, None, :] * (bvel - Cdv)
    CH0 = 1 + D
    zrow = bpos.new_zeros((A, 1, cap))
    ch_groups = [torch.cat([bmass[:, None, :], Aval], dim=1)]
    for d in range(D):
        ch_groups.append(torch.cat([zrow, bmass[:, None, :] * bC[:, :, d, :]], dim=1))
    dep = _deposit_merged(plain, moment, ch_groups)  # [A, E, CH0*E^{D-1}]

    def to_dense_blocks(active_blocks, C):
        """Active blocks -> every tile's [nt, E, ..., E, C]: distinct targets,
        the unused entries (tile nt) into a padding row that is dropped."""
        flat = active_blocks.reshape(A, -1)
        dense = flat.new_zeros((nt + 1, flat.shape[1]))
        dense.index_add_(0, toa, flat)
        dense = dense[:nt].reshape((nt, E, C) + (E,) * (D - 1))
        return dense.permute((0, 1) + tuple(range(3, 2 + D)) + (2,))

    perm_in = (0, 1, 1 + D) + tuple(range(2, 1 + D))

    def to_active_blocks(dense_blocks):
        x = dense_blocks.permute(perm_in).reshape(nt, -1)  # [nt, E, C, E...]
        x = torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)
        return x[toa].reshape(A, E, -1)

    # out-of-grid halo cells of boundary tiles read as 0 (the reference drops
    # those taps, 2d_multi.rs:165-167), masked on the active blocks only
    emask_act = to_active_blocks(edge_mask(tshape, T, bpos.dtype, device=dev)[..., None])

    def mask_act(act, C):
        return (act.reshape(A, E, C, -1) * emask_act[:, :, None, :]).reshape(A, E, -1)

    # the halo sum in block space, no dense grid in the loop
    dense_dep = to_dense_blocks(dep, CH0)  # [nt, E..., 1+D]
    act1 = mask_act(to_active_blocks(halo_sum(dense_dep, tshape, T)), CH0)
    act1_r = act1.reshape(A, E, CH0, -1)
    mact = act1_r[:, :, 0, :].reshape(A, E, -1)

    rho = _collect(plain, mact, 1)[:, 0, :]  # [A, cap]
    rho_pos = torch.where(rho > 0.0, rho, 1.0)
    volume = torch.where(rho > 0.0, bmass / rho_pos, 0.0)
    pressure = tait_pressure(rho, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                             cfg.pressure_floor)
    strain = bC + bC.transpose(1, 2)
    eye = torch.eye(D, dtype=bpos.dtype, device=dev)[None, :, :, None]
    stress = -pressure[:, None, None, :] * eye + cfg.dynamic_viscosity * strain
    term = (-4.0 * cfg.dt) * volume[:, None, None, :] * stress  # [A, D, D, cap]

    A2 = -torch.einsum("aijs,ajs->ais", term, dvec)
    dep2 = _deposit_merged(plain, moment, [A2] + [term[:, :, d, :] for d in range(D)])
    dense_dep2 = to_dense_blocks(dep2, D)
    act2 = mask_act(to_active_blocks(halo_sum(dense_dep2, tshape, T)), D).reshape(A, E, D, -1)

    # ---- grid update (on the active blocks; halo replicas agree) --------
    g = device_const(cfg.gravity, dev, bpos.dtype)
    m_b = act1_r[:, :, 0:1, :]
    mom_b = act1_r[:, :, 1:, :] + act2
    v_b = torch.where(m_b > 0.0,
                      mom_b / torch.where(m_b > 0.0, m_b, 1.0) + cfg.dt * g[None, None, :, None],
                      0.0)

    # ---- g2p --------------------------------------------------------------
    collected = _collect_all_variants(plain, moment, v_b.reshape(A, E, -1), D)
    v_slot = collected[0]  # [A, D, cap]
    B = v_slot[:, :, None, :] * (-dvec)[:, None, :, :]  # v_i * (-dvec_j)
    for d in range(D):
        B[:, :, d, :] += collected[1 + d]  # sum over taps of w (o_d - 1) v_i
    newC = 4.0 * B
    newpos = bpos + v_slot * cfg.dt

    # mouse (quirk Q3), clamp and soft wall (quirk Q2)
    mouse_pos = mouse_pos.to(device=dev, dtype=bpos.dtype)
    dist = newpos[:, :2, :] - mouse_pos[None, :, None]
    dist_sq = (dist * dist).sum(dim=1)  # [A, cap]
    norm = torch.sqrt(dist_sq)
    push2 = torch.where(norm[:, None, :] > 0.0,
                        dist / torch.where(norm > 0.0, norm, 1.0)[:, None, :], 0.0)
    hit = mouse_active.to(dev) & (dist_sq < cfg.mouse_radius * cfg.mouse_radius)
    push = torch.cat([push2, bpos.new_zeros((A, D - 2, cap))], dim=1)
    newvel = v_slot + torch.where(hit[:, None, :], push, 0.0)

    lo = device_const(cfg.boundary_clip[0], dev, bpos.dtype)[None, :, None]
    hi = device_const(cfg.boundary_clip[1], dev, bpos.dtype)[None, :, None]
    newpos = torch.clamp(newpos, lo, hi)
    nxt = newpos + newvel
    wall_min = lo + cfg.boundary_damp_dist
    wall_max = hi - cfg.boundary_damp_dist
    newvel = newvel + torch.where(nxt < wall_min, wall_min - nxt, 0.0)
    newvel = newvel + torch.where(nxt > wall_max, wall_max - nxt, 0.0)

    # ---- un-bin: one packed gather to sorted order, one permutation -------
    out_packed = torch.cat([newpos, newvel, newC.reshape(A, D * D, cap), rho[:, None, :],
                            pressure[:, None, :], bmass[:, None, :]], dim=1)  # [A, FO, cap]
    FO = out_packed.shape[1]
    out_flat = out_packed.transpose(1, 2).reshape(A * cap, FO)
    start, sid = b["start"], b["sid"]
    s_rank = torch.arange(n, device=dev) - start[:-1][sid]
    occ_rank = (torch.cumsum((start[1:] - start[:-1] > 0).to(torch.int64), 0) - 1)[sid]
    slot = occ_rank.clamp(0, A - 1) * cap + s_rank.clamp(0, cap - 1)
    sorted_out = out_flat[slot]  # [N, FO]
    if not spec.strict:
        fallback = torch.cat([p.pos, p.vel, p.C.reshape(n, D * D), p.density[:, None],
                              p.pressure[:, None], p.mass[:, None]], dim=1)
        sorted_out = torch.where(b["frozen"][:, None], fallback[b["order"]], sorted_out)
    if preserve_order:
        unpacked = torch.empty_like(sorted_out)
        unpacked[b["order"]] = sorted_out  # a permutation: one write per row
        mass_out = p.mass
    else:
        unpacked = sorted_out  # tile-sorted order; the mass travels in the pack
        mass_out = unpacked[:, FO - 1]
    out = ParticleState(
        pos=unpacked[:, 0:D], vel=unpacked[:, D:2 * D],
        C=unpacked[:, 2 * D:2 * D + D * D].reshape(n, D, D), mass=mass_out,
        density=unpacked[:, FO - 3], pressure=unpacked[:, FO - 2],
    )
    return out, dense_dep, dense_dep2


def substep(p: ParticleState, cfg: Config, domain: Domain, mouse_pos, mouse_active,
            spec: Optional[TileSpec] = None, preserve_order: bool = True
            ) -> Tuple[ParticleState, GridState]:
    """One MLS-MPM substep on the tile-binned layout: the physics of
    ``ops.transfer`` (p2g_1 ``2d_multi.rs:148-180``, p2g_2 ``:182-238``,
    update ``:240-250``, g2p ``:252-359``, quirks Q2/Q3), other data
    movement.  Returns the particles and the dense post-update grid,
    assembled from the pre-halo blocks.

    ``preserve_order=False`` returns the particles in tile-sorted order
    (the mass travels with them) instead of the caller's, skipping the
    inverse permutation."""
    spec = spec if spec is not None else default_spec(cfg, p.n)
    out, dense_dep, dense_dep2 = _advance(p, cfg, domain, mouse_pos, mouse_active, spec,
                                          preserve_order)
    tshape, _ = _tile_geometry(domain, spec)
    grid_all = assemble(dense_dep, tshape, spec.tile)  # [*shape, 1+D]
    grid_m = grid_all[..., 0]
    grid_mv = grid_all[..., 1:] + assemble(dense_dep2, tshape, spec.tile)
    m = grid_m[..., None]
    g = torch.as_tensor(cfg.gravity, dtype=grid_m.dtype, device=grid_m.device)
    grid_v = torch.where(m > 0.0, grid_mv / torch.where(m > 0.0, m, 1.0) + cfg.dt * g, 0.0)
    return out, GridState(mass=grid_m, vel=grid_v)


def frame(p: ParticleState, cfg: Config, domain: Domain, mouse_pos, mouse_active,
          substeps: Optional[int] = None, spec: Optional[TileSpec] = None) -> ParticleState:
    """``cfg.iterations`` substeps (or ``substeps``) with ``spec`` (None:
    ``default_spec``), without the dense grid ``substep`` assembles."""
    spec = spec if spec is not None else default_spec(cfg, p.n)
    for _ in range(cfg.iterations if substeps is None else substeps):
        p = _advance(p, cfg, domain, mouse_pos, mouse_active, spec, True)[0]
    return p


def overflow_count(pos: torch.Tensor, domain: Domain, spec: TileSpec) -> torch.Tensor:
    """Particles that would freeze (slot or active-budget overflow)."""
    return bin_particles(pos, domain, spec)["frozen"].sum()
