"""Stream transfer — the persistent tile-binned slot stream (PyTorch port).

Counterpart of ``fluid_tpu/ops/stream_transfer.py``.  Particles live binned
by tile in a slot stream ``[A, F, cap]`` that persists across substeps:
kernels re-derive each particle's cell from its position every substep, and
the expanded window E = T + 2h stays valid until a particle drifts out of
its tile's drift window, which the collect kernel flags; the frame then
re-bins.  One substep runs the stages of ``substep_stages``:

  dep1       p2g_1 deposit (mass + APIC momentum) into per-tile windows
  halo_m     separable halo of the mass channel, all D passes in one launch
  dep2       density, Tait EOS, eq-16 force, plus the p2g_1 momentum
  halo_gblk  momentum+force halo, all D passes, and the grid update, in
             one launch
  collect    g2p + particle tail + drift flag (+ the next substep's p2g_1)

The five kernel entry points live in ``stream_kernels.py``: hand-written CUDA
on the GPU, their plain PyTorch versions on the CPU.  So do the re-bin's
two: ``rebin_gather`` compacts and keys the live slots, ``rebin_fill``
writes the slot structure from the sorted rows.  Everything else here (the
sort, the active set, neighbour tables, un-binning) is plain PyTorch,
ported operation by operation from the JAX module so that binning is
bit-identical to it.

Kept ``StreamSpec`` knobs: ``tile``, ``cap``, ``halo``, ``active`` and
``scene_stride``, which must be the domain's (``domain.PackedDomain``: a
batch of scenes side by side along x, each particle in its own scene's
coordinates; the tile's scene adds its offset where a position becomes a
cell, ``stream_kernels.TileGeom.scene_cells``).  The TPU's block-geometry
knobs (``group``, ``pair``, ``wchunk``, ``mhalo``, ``interpret``,
``rebin_margin``, ``dyn`` and the ``ZFAC_*`` toggles) have no counterpart:
the binning counts its occupied entries on the device
(``StreamState.occupied``; they come first), and every kernel of the
substep works on the entries below that count, read from device memory at
each launch, so no host read sizes a grid.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import types
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..domain import Domain, packing
from ..state import GridState, ParticleState
from ..utils.graph import device_const, eager_branch
from . import pallas_transfer as ptx
from . import stream_kernels as sk

_LOOKAHEAD = 6.0  # predictive-binning horizon, in substeps


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static layout parameters."""

    tile: int = 4  # T: cells per tile edge
    cap: int = 128  # particle slots per tile (a multiple of 32: the kernels walk whole warps)
    halo: int = 2  # h: window reach beyond the tile; E = T + 2h
    active: int = 64  # A: active-tile budget
    # packed scenes: grid cells of one scene along x, the domain's
    # scene_stride (0: one scene)
    scene_stride: float = 0.0

    def __post_init__(self):
        if self.halo < 1:
            raise ValueError("halo must cover the stencil radius (>= 1)")
        sk.check_cap(self.cap)

    @property
    def E(self) -> int:
        return self.tile + 2 * self.halo

    @property
    def A(self) -> int:
        return self.active


# A tile's slot headroom over its rest-density estimate, in cells at rest
# density: a packed ring under the mouse or a splash fills a tile of few
# cells far above its average (2D, 16 cells: 205 of an estimate of 64 in the
# cap sweep), a tile of many cells less so.
_CAP_HEADROOM_CELLS = 48


def default_spec(cfg: Config, domain: Domain, n: int) -> StreamSpec:
    """T=4, halo 2.  Slot cap: the rest-density tile estimate
    ``rest_density * T**dim`` plus ``_CAP_HEADROOM_CELLS`` cells' worth,
    rounded up to whole warps (``check_cap``): 128 for the 3D reference
    scene, 256 for the 2D one, whose tiles have a quarter of the cells.
    Active budget like ``fluid_tpu``'s: 32x the rest-density tile
    estimate, capped by the tile count.  The 110k cap exists for the TPU's
    scalar memory; it is kept only so both packages size A alike.  The
    scene stride is the domain's."""
    T = 4
    per_tile = cfg.rest_density * T**cfg.dim
    occupied = max(2048, int(n / max(per_tile, 1.0)) * 32)
    nt = math.prod(s // T for s in domain.shape)
    cap = 32 * math.ceil(cfg.rest_density * (T**cfg.dim + _CAP_HEADROOM_CELLS) / 32)
    return StreamSpec(tile=T, cap=cap, halo=2, active=min(occupied, nt, 110_000),
                      scene_stride=float(packing(domain)[1]))


def _id_row(D: int) -> int:
    # stream rows: pos[D], vel[D], C[D*D], mass, id, rho, prs
    return 2 * D + D * D + 1


@dataclasses.dataclass
class StreamState:
    """Persistent binned particle state (tensors on one device).

    stream [A, F, cap] f32; count, tid [A] int32 (tid == nt: unused entry);
    flag [A, cap] f32 drift verdicts of the last collect (2.0 = re-bin);
    nbr [2D, A] int32 +/- face neighbours' active index (A = none);
    shell_drop, need_peak, fill_peak, rebins [1] int32 watermarks / counter:
    fill_peak is the most particles a binning asked one tile to hold, taken
    before the clip to cap (above cap: particles were lost);
    occupied [1] int32: the entries with count > 0, which the binning puts
    first, so the kernels work on the entries below it.  A state made
    without it (an old one) derives it from ``count`` (``occupied_of``).
    """

    stream: torch.Tensor
    count: torch.Tensor
    tid: torch.Tensor
    flag: torch.Tensor
    nbr: torch.Tensor
    shell_drop: torch.Tensor
    need_peak: torch.Tensor
    fill_peak: torch.Tensor
    rebins: torch.Tensor
    occupied: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.occupied is None:
            self.occupied = occupied_of(self.count)

    def clone(self) -> "StreamState":
        return StreamState(**{f.name: getattr(self, f.name).clone()
                              for f in dataclasses.fields(self)})

    def to_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in dataclasses.fields(self)}


def occupied_of(count: torch.Tensor) -> torch.Tensor:
    """[1] int32: one past the last entry with count > 0, on the device (no
    host read): in a binned state, whose occupied entries come first, their
    number, ``(count > 0).sum()``."""
    entry = torch.arange(1, count.shape[0] + 1, dtype=torch.int32, device=count.device)
    return torch.where(count > 0, entry, 0).max().reshape(1)


def stream_state_from_numpy(d: dict, spec: StreamSpec, device=None) -> StreamState:
    """A ``fluid_tpu`` StreamState as numpy (``pair=False``; layout
    ``stream [NG, F, G*cap]``, ``flag [NG, G, cap]``) -> the port's layout.
    ``nbrg`` (gated tables) has no counterpart and is ignored; without a
    ``fill_peak`` (``fluid_tpu`` keeps none) it is the fullest tile's count,
    without an ``occupied`` it is derived from the count (``occupied_of``)."""
    A, cap = spec.A, spec.cap
    stream = np.asarray(d["stream"], np.float32)
    NG, F, GL = stream.shape
    G = GL // cap
    if NG * G != A:
        raise ValueError(f"stream holds {NG * G} tiles, spec.A is {A}")
    stream = stream.reshape(NG, F, G, cap).transpose(0, 2, 1, 3).reshape(A, F, cap)

    def t(x, dtype):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    return StreamState(
        stream=t(stream, torch.float32),
        count=t(d["count"], torch.int32),
        tid=t(d["tid"], torch.int32),
        flag=t(np.asarray(d["flag"]).reshape(A, cap), torch.float32),
        nbr=t(d["nbr"], torch.int32),
        shell_drop=t(d["shell_drop"], torch.int32),
        need_peak=t(d["need_peak"], torch.int32),
        fill_peak=t(d.get("fill_peak", [np.max(d["count"], initial=0)]), torch.int32),
        rebins=t(d["rebins"], torch.int32),
        occupied=t(d["occupied"], torch.int32) if "occupied" in d else None,
    )


def stream_state_to_numpy(st: StreamState, group: int) -> dict:
    """The port's StreamState -> ``fluid_tpu``'s numpy layout with ``group``
    tiles per group (no ``nbrg``: rebuild it with ``_gated_nbr`` there)."""
    d = st.to_numpy()
    A, F, cap = d["stream"].shape
    NG = A // group
    d["stream"] = (d["stream"].reshape(NG, group, F, cap).transpose(0, 2, 1, 3)
                   .reshape(NG, F, group * cap))
    d["flag"] = d["flag"].reshape(NG, group, cap)
    return d


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


def _tile_geometry(domain: Domain, spec: StreamSpec):
    T = spec.tile
    if any(s % T for s in domain.shape):
        raise ValueError(f"grid shape {domain.shape} not divisible by tile={T}")
    scenes, stride = packing(domain)
    if spec.scene_stride != stride:
        raise ValueError(f"spec.scene_stride {spec.scene_stride:g} contradicts the domain's "
                         f"{stride} ({scenes} scene(s))")
    if stride % T:
        raise ValueError(f"scene stride {stride} not divisible by tile={T}")
    tshape = tuple(s // T for s in domain.shape)
    return tshape, math.prod(tshape)


def tile_geom(domain: Domain, spec: StreamSpec) -> sk.TileGeom:
    tshape, _ = _tile_geometry(domain, spec)
    return sk.TileGeom(
        dim=len(tshape), tile=spec.tile, halo=spec.halo, cap=spec.cap,
        tshape=tshape, origin=tuple(int(o) for o in domain.origin),
        scene_cells=packing(domain)[1],
    )


def scene_offsets(n: int, domain: Domain, device) -> Optional[torch.Tensor]:
    """[n] int64 x offset ``k * scene_stride`` of each row of a packed
    domain's particles, scene-major, ``n / scenes`` a scene (None for one
    scene)."""
    scenes, stride = packing(domain)
    if scenes == 1:
        return None
    if n % scenes:
        raise ValueError(f"{n} particles do not split into {scenes} scenes")
    return torch.arange(n, device=device) // (n // scenes) * stride


def _flatten_coords(c: torch.Tensor, shape) -> torch.Tensor:
    out = c[..., 0]
    for d in range(1, len(shape)):
        out = out * shape[d] + c[..., d]
    return out


def _keys_from_pos(pos, domain: Domain, spec: StreamSpec, tshape, vel=None, dt=0.0):
    """Tile key per particle (int64).  With ``vel``, bins PREDICTIVELY by
    ``pos + clip(6 dt vel, +-1 cell)`` when that keeps the current cell in
    the chosen tile's drift window (``stream_kernels.tile_keys``); a packed
    domain's rows key in their own scenes (``scene_offsets``)."""
    g = sk.TileGeom(dim=len(tshape), tile=spec.tile, halo=spec.halo, cap=spec.cap,
                    tshape=tuple(tshape), origin=tuple(int(o) for o in domain.origin),
                    scene_cells=packing(domain)[1])
    return sk.tile_keys(pos, g, vel, _LOOKAHEAD * dt,
                        scene_offsets(pos.shape[0], domain, pos.device))


def _active_index(tid_act, nt: int, A: int) -> torch.Tensor:
    """[nt + 1] int64: the active index of each tile (A = not active)."""
    tid_act = tid_act.to(torch.int64)
    inv = torch.full((nt + 1,), A, dtype=torch.int64, device=tid_act.device)
    a_io = torch.arange(A, device=tid_act.device)
    inv.scatter_reduce_(0, tid_act.clamp(0, nt),
                        torch.where(tid_act < nt, a_io, A), "amin", include_self=True)
    return inv


def _nbr_table(tid_act, tshape, nt: int, A: int) -> torch.Tensor:
    """[2D, A] int32 active index of every active tile's +/- face neighbour
    (A = no active neighbour)."""
    inv = _active_index(tid_act, nt, A)
    ok = tid_act < nt
    out = []
    for d in range(len(tshape)):
        rs = math.prod(tshape[d + 1:])
        coord = (tid_act // rs) % tshape[d]
        idp = torch.where(ok & (coord < tshape[d] - 1), tid_act + rs, nt)
        idm = torch.where(ok & (coord > 0), tid_act - rs, nt)
        out += [inv[idp], inv[idm]]
    return torch.stack(out).to(torch.int32)


def _dilate_axes(o: torch.Tensor, axes) -> torch.Tensor:
    """+/-1 max filter along the given axes of a bool array."""
    for d in axes:
        n = o.shape[d]
        a = torch.zeros_like(o)
        b = torch.zeros_like(o)
        a.narrow(d, 0, n - 1).copy_(o.narrow(d, 1, n - 1))
        b.narrow(d, 1, n - 1).copy_(o.narrow(d, 0, n - 1))
        o = o | a | b
    return o


def _active_set(occ: torch.Tensor, tshape) -> torch.Tensor:
    """Needed-relay closure of a [nt] bool occupancy map: occupied tiles plus
    the tiles the separable halo relays diagonal deposit flows through
    (``fluid_tpu`` ``_active_set``)."""
    D = len(tshape)
    o = occ.reshape(tshape)
    if D == 1:
        return o.reshape(-1)
    act = o | (_dilate_axes(o, [0]) & _dilate_axes(o, range(1, D)))
    if D > 2:
        act = act | (_dilate_axes(o, range(D - 1)) & _dilate_axes(o, [D - 1]))
    return act.reshape(-1)


# ---------------------------------------------------------------------------
# Binning: ParticleState <-> StreamState
# ---------------------------------------------------------------------------


def _bin_rows(rows, tid_of_particle, spec: StreamSpec, nt: int, tshape, occ_force=None,
              out: Optional[StreamState] = None) -> StreamState:
    """rows [N, F] + tile ids [n] -> slot structure, occupied tiles first.

    Tile ids >= nt never land in a tile.  The sort is stable (slot order
    within a tile follows row order, as ``jnp.argsort`` does).
    ``occ_force`` ([nt] bool) marks tiles the needed-relay closure treats
    as occupied although no local particle is in them (the sharded
    backend's ghost columns, filled by the exchange); they bin as
    zero-count actives.  The slot structure (stream, count, tid, flag,
    nbr, occupied) is written into ``out``'s tensors where given, which the
    result shares, else into new ones (rebins 0); the result's shell_drop,
    need_peak and fill_peak are this binning's.  ``occupied`` is the number
    of entries with particles, the first ones.  The tile bookkeeping is
    PyTorch over the grid's tiles; ``stream_kernels.rebin_fill`` writes the
    slots."""
    cap, A = spec.cap, spec.A
    dev = rows.device
    order = torch.argsort(tid_of_particle, stable=True)
    sid = tid_of_particle[order]
    start = torch.searchsorted(sid, torch.arange(nt + 2, dtype=sid.dtype, device=dev), right=False)
    count_t = (start[1:] - start[:-1])[:nt]

    occ_p = count_t > 0
    occ = _active_set(occ_p if occ_force is None else occ_p | occ_force, tshape)
    shell = occ & ~occ_p
    n_occ = occ_p.sum()
    rank_p = torch.cumsum(occ_p.to(torch.int64), 0) - 1
    rank_s = n_occ + torch.cumsum(shell.to(torch.int64), 0) - 1
    occ_rank = torch.where(occ_p, rank_p, rank_s)
    act_of_tile = torch.where(occ & (occ_rank < A), occ_rank, A)
    tid_act = torch.full((A,), -1, dtype=torch.int64, device=dev)
    tid_act.scatter_reduce_(
        0, act_of_tile.clamp(0, A - 1),
        torch.where(act_of_tile < A, torch.arange(nt, device=dev), -1),
        "amax", include_self=True,
    )
    tid_act = torch.where(tid_act < 0, nt, tid_act)
    count_pad = torch.cat([count_t, count_t.new_zeros(1)])
    count_act = torch.clamp_max(count_pad[tid_act.clamp(0, nt)], cap)
    act_start = start[:-1][tid_act.clamp(0, nt)]
    need = occ.sum().reshape(1).to(torch.int32)
    drop = torch.clamp_min(need - A, 0)
    fill = count_t.max().reshape(1).to(torch.int32)

    if out is None:
        i32 = dict(dtype=torch.int32, device=dev)
        out = StreamState(
            stream=torch.empty((A, rows.shape[1], cap), dtype=torch.float32, device=dev),
            count=torch.empty((A,), **i32), tid=torch.empty((A,), **i32),
            flag=torch.empty((A, cap), dtype=torch.float32, device=dev),
            nbr=torch.empty((2 * len(tshape), A), **i32), shell_drop=drop, need_peak=need,
            fill_peak=fill, rebins=torch.zeros((1,), **i32), occupied=torch.empty((1,), **i32),
        )
    else:
        out = dataclasses.replace(out, shell_drop=drop, need_peak=need, fill_peak=fill)
    out.occupied.copy_(torch.clamp_max(n_occ, A).reshape(1))
    out.count.copy_(count_act)
    out.tid.copy_(tid_act)
    out.nbr.copy_(_nbr_table(tid_act, tshape, nt, A))
    sk.rebin_fill(rows, order, act_start, out.count, out.stream, out.flag)
    return out


def bin_particles(p: ParticleState, domain: Domain, spec: StreamSpec,
                  dt: float = 0.0) -> StreamState:
    """ParticleState -> persistent stream layout (predictive when dt > 0)."""
    tshape, nt = _tile_geometry(domain, spec)
    n, D = p.n, p.dim
    if n >= 2**24:
        raise ValueError(f"n={n}: the float32 id row is exact only below 2**24")
    rows = torch.cat(
        [p.pos, p.vel, p.C.reshape(n, D * D), p.mass[:, None],
         torch.arange(n, dtype=torch.float32, device=p.device)[:, None],
         p.density[:, None], p.pressure[:, None]],
        dim=1,
    )
    tid_p = _keys_from_pos(p.pos, domain, spec, tshape, vel=p.vel, dt=dt)
    return _bin_rows(rows, tid_p, spec, nt, tshape)


def unbin(st: StreamState, domain: Domain, spec: StreamSpec, n: int, D: int) -> ParticleState:
    """Stream -> ParticleState in the original particle order (id row)."""
    rows, _ = sk.rebin_gather(st.stream, st.count, n, tile_geom(domain, spec), 0.0, st.tid)
    out = rows[torch.argsort(rows[:, _id_row(D)].to(torch.int64), stable=True)]
    return ParticleState(
        pos=out[:, 0:D].contiguous(),
        vel=out[:, D:2 * D].contiguous(),
        C=out[:, 2 * D:2 * D + D * D].reshape(n, D, D).contiguous(),
        mass=out[:, 2 * D + D * D].contiguous(),
        density=out[:, 2 * D + D * D + 2].contiguous(),
        pressure=out[:, 2 * D + D * D + 3].contiguous(),
    )


def _rebin_full(st: StreamState, cfg: Config, domain: Domain, spec: StreamSpec,
                tshape, nt: int, n: int, out: Optional[StreamState] = None) -> StreamState:
    """Re-bin the live slots, O(n): compact and key them predictively
    (``stream_kernels.rebin_gather``), then bin them (``_bin_rows``), into
    ``out``'s tensors where given (``st`` itself: the compaction has read
    the stream before the fill writes it)."""
    rows, keys = sk.rebin_gather(st.stream, st.count, n, tile_geom(domain, spec),
                                 _LOOKAHEAD * cfg.dt, st.tid)
    return _bin_rows(rows, keys, spec, nt, tshape, out=out)


def overflow_count(pos, domain: Domain, spec: StreamSpec, vel=None, dt: float = 0.0) -> torch.Tensor:
    """Particles that would not fit the slot structure, plus needed relay
    tiles beyond the active budget (the strict check at t=0)."""
    tshape, nt = _tile_geometry(domain, spec)
    n = pos.shape[0]
    dev = pos.device
    tid_p = _keys_from_pos(pos, domain, spec, tshape, vel=vel, dt=dt)
    order = torch.argsort(tid_p, stable=True)
    sid = tid_p[order]
    ranks = torch.arange(n, device=dev)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sid[1:] != sid[:-1]])
    start = torch.full((nt + 1,), n, dtype=torch.int64, device=dev)
    start.scatter_reduce_(0, sid, torch.where(first, ranks, n), "amin", include_self=True)
    start = torch.cummin(start.flip(0), 0).values.flip(0)
    count_t = start[1:] - start[:-1]
    occ_p = count_t > 0
    dil = _active_set(occ_p, tshape)
    rank_p = torch.cumsum(occ_p.to(torch.int64), 0) - 1
    s_rank = ranks - start[:-1][sid]
    a_rank = rank_p[sid]
    frozen = (s_rank >= spec.cap) | (a_rank >= spec.A)
    return frozen.sum() + torch.clamp_min(dil.sum() - spec.A, 0)


# ---------------------------------------------------------------------------
# Substep + frame drivers
# ---------------------------------------------------------------------------


def collect_params(cfg: Config, mouse_pos, mouse_active, device=None) -> torch.Tensor:
    """[10 + 2D] f32: dt, rest_density, eos_stiffness, eos_power,
    pressure_floor, mouse_radius, boundary_damp_dist, mouse_active, mouse_x,
    mouse_y, clip_lo[D], clip_hi[D]: the pallas collect's parameters.  The
    walls and the mouse are in a scene's own coordinates, so a packed batch
    has the walls of one scene and the mouse acts on every scene alike.
    The mouse tensors are copied on the device, never read on the host."""
    return ptx.collect_params(cfg, mouse_pos, mouse_active, device)


def substep_stages(cfg: Config, domain: Domain, spec: StreamSpec, device):
    """Stage closures of the stream substep, on ``device``, each working on
    the entries below ``st.occupied`` (their windows past it undefined)::

      dep1(st[, out])            -> p2g_1 windows [A, 1+D, E^D] (into out)
      halo_m(st, dep1v)          -> halo'd mass windows [A, 1, E^D]
      dep2(st, dep1v, hs_m)      -> combined momentum+force windows [A, D, E^D]
      halo_gblk(st, dep2v, hs_m) -> grid values [A, 1+D, E^D] (v rows, mass)
      collect(st, gblk, params[, out])
                                 -> (stream', flag, dep1_next); with
                                    out = (st.stream, st.flag), in place
    """
    g = tile_geom(domain, spec)
    params6 = device_const([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                            cfg.pressure_floor, cfg.dynamic_viscosity], device, torch.float32)
    dtg = sk.gravity_step(cfg.dt, cfg.gravity)

    def dep1(st, out=None):
        return sk.deposit_p2g1(st.count, st.tid, st.stream, g, out, occupied=st.occupied)

    def halo_m(st, dep1v):
        return sk.halo_axes(dep1v[:, :1].contiguous(), st.count, st.nbr, g,
                            occupied=st.occupied)

    def dep2(st, dep1v, hs_m):
        return sk.deposit_p2g2(st.count, st.tid, st.stream, hs_m, params6, dep1v, g,
                               occupied=st.occupied)

    def halo_gblk(st, dep2v, hs_m):
        return sk.halo_gblk(dep2v, hs_m, st.count, st.nbr, dtg, g, occupied=st.occupied)

    def collect(st, gblk, params, out=None):
        return sk.collect(st.count, st.tid, params, st.stream, gblk, g, out,
                          occupied=st.occupied)

    return types.SimpleNamespace(
        dep1=dep1, halo_m=halo_m, dep2=dep2, halo_gblk=halo_gblk, collect=collect,
    )


def _substep_core(st: StreamState, dep1, stages, params):
    """One substep given its p2g_1 windows, updating ``st``'s stream and
    flag in place (the collect writes each live slot over itself); returns
    the next substep's p2g_1 windows."""
    hs_m = stages.halo_m(st, dep1)
    d2 = stages.dep2(st, dep1, hs_m)
    gblk = stages.halo_gblk(st, d2, hs_m)
    return stages.collect(st, gblk, params, (st.stream, st.flag))[2]


def needs_rebin(st: StreamState) -> torch.Tensor:
    """True (0-dim bool tensor) when a valid particle's next deposit would
    fall outside its tile's drift window (a flag of 2.0)."""
    return torch.any(st.flag >= 2.0)


def frame_inplace(st: StreamState, cfg: Config, domain: Domain, spec: StreamSpec,
                  mouse_pos, mouse_active, branch=eager_branch, substeps: Optional[int] = None,
                  n: Optional[int] = None) -> None:
    """``cfg.iterations`` substeps with drift-triggered re-binning, updating
    ``st`` in place: the frame body that ``frame_binned`` runs eagerly and a
    ``Session`` on the card captures into one CUDA graph
    (``utils/graph.py``).

    The collect of each substep updates the stream and flag in place and
    also deposits the next substep's p2g_1.  After each substep
    ``branch(needs_rebin(st), rebin)`` decides on the re-bin, as the JAX
    frame's ``lax.cond`` does: ``eager_branch`` reads the flag on the host,
    a capture makes the re-bin the body of an IF node that the card
    decides.  The re-bin writes into ``st`` and the substep's p2g_1
    windows, so where it does not run nothing runs and they already hold
    the fused p2g_1.  ``n`` is the live particle count (default: every
    slot)."""
    tshape, nt = _tile_geometry(domain, spec)
    dev = st.stream.device
    n_sub = cfg.iterations if substeps is None else substeps
    n_c = spec.A * spec.cap if n is None else n
    stages = substep_stages(cfg, domain, spec, dev)
    params = collect_params(cfg, mouse_pos, mouse_active, dev)
    dep1 = stages.dep1(st)
    for _ in range(n_sub):
        dep1 = _substep_core(st, dep1, stages, params)
        branch(needs_rebin(st), functools.partial(
            _rebin_into, st, dep1, cfg, domain, spec, tshape, nt, n_c, stages))


def _rebin_into(st: StreamState, dep1, cfg, domain, spec, tshape, nt, n, stages) -> None:
    """Re-bin ``st`` in place (``_rebin_full`` with ``st`` as its output),
    carry the shell_drop / need_peak / fill_peak watermarks and count the
    re-bin; the fused p2g_1 is stale after it and is redeposited into
    ``dep1``."""
    st2 = _rebin_full(st, cfg, domain, spec, tshape, nt, n, out=st)
    st.shell_drop.copy_(torch.maximum(st.shell_drop, st2.shell_drop))
    st.need_peak.copy_(torch.maximum(st.need_peak, st2.need_peak))
    torch.maximum(st.fill_peak, st2.fill_peak, out=st.fill_peak)
    st.rebins.add_(1)
    stages.dep1(st, dep1)


def frame_binned(st: StreamState, cfg: Config, domain: Domain, spec: StreamSpec,
                 mouse_pos, mouse_active, substeps: Optional[int] = None,
                 n: Optional[int] = None) -> StreamState:
    """``frame_inplace`` on a copy of ``st``, deciding each re-bin on the
    host (one device read per substep); ``st`` is left as it was."""
    out = st.clone()
    frame_inplace(out, cfg, domain, spec, mouse_pos, mouse_active, eager_branch, substeps, n)
    return out


def frame(p: ParticleState, cfg: Config, domain: Domain, mouse_pos, mouse_active,
          spec: Optional[StreamSpec] = None, substeps: Optional[int] = None) -> ParticleState:
    """Bin once, run the substeps on the persistent layout, un-bin once."""
    if spec is None:
        spec = default_spec(cfg, domain, p.n)
    st = bin_particles(p, domain, spec, dt=cfg.dt)
    st = frame_binned(st, cfg, domain, spec, mouse_pos, mouse_active, substeps, n=p.n)
    return unbin(st, domain, spec, p.n, p.dim)


def windows_to_dense(win: torch.Tensor, tid: torch.Tensor, domain: Domain,
                     spec: StreamSpec) -> torch.Tensor:
    """Sum per-tile windows [A, CH, E^D] (before the halo) into a dense grid
    [*shape, CH].  Window cells outside the grid hold no deposits."""
    tshape, nt = _tile_geometry(domain, spec)
    D = len(tshape)
    A, CH, ncell = win.shape
    E, T, dev = spec.E, spec.tile, win.device
    e_io = torch.arange(ncell, device=dev)
    tid = tid.to(torch.int64)
    shape = torch.as_tensor(domain.shape, device=dev)
    cells = []
    for d in range(D):
        coord = (tid // math.prod(tshape[d + 1:])) % tshape[d]
        e_d = (e_io // E ** (D - 1 - d)) % E
        cells.append(coord[:, None] * T + e_d[None, :] - spec.halo)
    cell = torch.stack(cells, dim=-1)  # [A, ncell, D]
    ok = (tid < nt)[:, None] & ((cell >= 0) & (cell < shape)).all(dim=-1)
    flat = _flatten_coords(torch.minimum(cell.clamp_min(0), shape - 1), domain.shape)
    vals = torch.where(ok[..., None], win.permute(0, 2, 1), 0.0)
    dense = torch.zeros((math.prod(domain.shape), CH), dtype=torch.float32, device=dev)
    dense.index_add_(0, flat.reshape(-1), vals.reshape(-1, CH))
    return dense.reshape(*domain.shape, CH)


def substep(p: ParticleState, cfg: Config, domain: Domain, mouse_pos, mouse_active,
            spec: Optional[StreamSpec] = None) -> Tuple[ParticleState, GridState]:
    """Bin -> one substep -> un-bin, plus the post-update dense grid (API
    parity with the dense backend; the fast path is ``frame``)."""
    if spec is None:
        spec = default_spec(cfg, domain, p.n)
    dev = p.device
    st = bin_particles(p, domain, spec, dt=cfg.dt)
    stages = substep_stages(cfg, domain, spec, dev)
    params = collect_params(cfg, mouse_pos, mouse_active, dev)
    d1 = stages.dep1(st)
    hs_m = stages.halo_m(st, d1)
    d2 = stages.dep2(st, d1, hs_m)
    stream2 = stages.collect(st, stages.halo_gblk(st, d2, hs_m), params)[0]
    st2 = dataclasses.replace(st, stream=stream2)
    # the windows past st.occupied are undefined: only the occupied ones sum
    live = (st.count > 0)[:, None, None]
    m = windows_to_dense(torch.where(live, d1[:, :1], 0.0), st.tid, domain, spec)
    mf = windows_to_dense(torch.where(live, d2, 0.0), st.tid, domain, spec)
    g = torch.as_tensor(sk.gravity_step(cfg.dt, cfg.gravity), device=dev)
    vel = torch.where(m > 0.0, mf / torch.where(m > 0.0, m, 1.0) + g, 0.0)
    return unbin(st2, domain, spec, p.n, p.dim), GridState(mass=m[..., 0], vel=vel)
