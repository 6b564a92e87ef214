"""The sharded stream backend (PyTorch port of ``fluid_tpu/parallel/stream_shard.py``).

The persistent tile-binned stream of ``ops/stream_transfer.py``, split into
x-slabs over a list of devices.  The same five kernels (K1-K5 of
``csrc/stream_kernels.cu``) run on each slab:

* **Decomposition**: 1-D x-slabs in tile space.  Shard d owns the global
  tile columns ``[d*TS, (d+1)*TS)``; its local tile grid has ``TS + 2``
  columns, one GHOST column per side (local tx = 0 and TS+1).  Every shard
  works in the shard-0 template: its positions are stored with x shifted
  by ``-d*TS*T``, and the collect's x walls and mouse are shifted to match.
* **Halo**: windows reach one tile over (h <= T), so after each deposit the
  edge-owned columns' windows (local tx = 1 and TS) are copied into the
  neighbours' ghost columns, and the ordinary separable halo completes the
  sums locally.  Two exchanges per substep: the p2g_1 mass channel (the
  only one the mass halo reads) and the combined p2g_2 momentum+force.
  Ghost tiles hold no particle, so the halos are gated on ``count + ghost``
  rather than ``count`` (``ShardStreamState.gate``; JAX's ghost-aware
  ``nbrg`` tables): gated on count alone, every flow across a slab boundary
  would be dropped.  Ghost tiles also enter the needed-relay closure as if
  occupied (``_bin_rows(occ_force=...)``), so cross-boundary diagonal flows
  keep their relays.
* **Migration**: particles stay validly binned between re-bins, so slots
  move only when a re-bin fires, which every shard takes together (one
  host read of the drift flags of all shards per substep, as the
  single-device ``frame_binned`` makes one).  Movers (new key in a ghost
  column) travel in fixed-capacity buffers and bin with the local rows.

One process drives every shard: ``devices`` is a list of torch devices,
one per shard, and may repeat a device (the CPU tests run ``["cpu"] * s``;
``chip_smoke.py`` runs ``[cuda:0] * s`` on one card).  ``lax.ppermute``
becomes ``_from_neighbour``: shard d receives shard d +- 1's buffer with
``.to(device, non_blocking=True)``, and the edge shards receive zeros.

Differences from JAX: no TPU block knobs (``group``, ``pair``, ``dyn``,
``mhalo``); binning runs on each shard's device; a re-bin takes each
shard's live rows (read on the host), not ``live_cap`` rows, and counts the
rows it cannot keep (beyond ``live_cap``, or movers beyond ``migrate_cap``,
which would stay in a ghost tile whose window the exchange overwrites)
into ``shell_drop``, so strict mode raises where JAX goes on silently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import render as render_mod
from .. import step as step_mod
from ..config import Config
from ..domain import Domain, packing
from ..ops import stream_kernels as sk
from ..ops import stream_transfer as stx
from ..ops.stream_transfer import StreamSpec, StreamState
from ..state import ParticleState
from ..utils.platform import cuda_devices

# ---------------------------------------------------------------------------
# Static geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamShardSpec:
    """Static sharded-stream geometry.  ``spec`` is the per-shard
    StreamSpec; its active budget covers the slab's needed-relay closure
    plus the two ghost columns."""

    domain: Domain  # the GLOBAL domain
    n_shards: int
    ts: int  # owned tile columns per shard
    spec: StreamSpec
    migrate_cap: int  # most movers per direction per shard and re-bin
    # most live rows of one shard at a re-bin (0: every slot); a shard can
    # never hold more than the global particle count
    live_cap: int = 0

    def __post_init__(self):
        T = self.spec.tile
        if self.domain.shape[0] % T:
            raise ValueError("global x extent not tile-aligned")
        if self.spec.halo > T:
            raise ValueError("ghost-column halo requires halo <= tile")
        if self.spec.scene_stride or packing(self.domain)[0] > 1:
            raise ValueError("packed scenes are not sharded")

    @property
    def live_cap_rows(self) -> int:
        nslots = self.spec.A * self.spec.cap
        return min(self.live_cap, nslots) if self.live_cap > 0 else nslots

    @property
    def tile(self) -> int:
        return self.spec.tile

    @property
    def local_domain(self) -> Domain:
        """The shard-0 template every shard works in: x spans TS + 2 tile
        columns, starting one tile left of the global origin."""
        T = self.tile
        return Domain(
            origin=(self.domain.origin[0] - T, *self.domain.origin[1:]),
            shape=((self.ts + 2) * T, *self.domain.shape[1:]),
            a_rect=self.domain.a_rect, p_rect=self.domain.p_rect,
        )

    @property
    def ncol(self) -> int:
        """Tiles per x column, the width of an exchange."""
        return math.prod(s // self.tile for s in self.domain.shape[1:])

    def shift(self, d: int) -> int:
        """Shard d's x offset (cells) from the template."""
        return d * self.ts * self.tile


def default_shard_spec(cfg: Config, domain: Domain, n_shards: int, n: int, pos=None,
                       vel=None, active_mult: float = 3.0,
                       active_floor: int = 1024) -> StreamShardSpec:
    """Per-shard budget.  With ``pos`` (global positions, optionally
    ``vel`` for the predictive key) it is measured: ``active_mult`` times
    the largest slab's t=0 needed-relay closure with both ghost columns
    occupied (what ``_bin_local`` provisions), at least ``active_floor``.
    Without ``pos``: the slab's share of particles at the stream spec's x32
    slack plus both ghost columns.  Budget exhaustion shows in
    ``shell_drop``."""
    T = 4
    ntx = domain.shape[0] // T
    ts = -(-ntx // n_shards)
    ncol = math.prod(s // T for s in domain.shape[1:])
    nt_local = (ts + 2) * ncol
    if pos is None:
        per_tile = cfg.rest_density * T**cfg.dim
        occupied = max(2048, int(n / n_shards / max(per_tile, 1.0)) * 32)
        active = min(occupied + 2 * ncol, nt_local, 110_000)
    else:
        peak = _probe_slab_peak(cfg, domain, n_shards, ts, pos, vel)
        active = min(max(active_floor, int(peak * active_mult)), nt_local, 110_000)
    return StreamShardSpec(
        domain=domain, n_shards=n_shards, ts=ts,
        spec=StreamSpec(tile=T, cap=128, halo=2, active=active),
        migrate_cap=max(256, n // n_shards // 4), live_cap=n,
    )


def _probe_slab_peak(cfg: Config, domain: Domain, n_shards: int, ts: int, pos, vel) -> int:
    """Largest t=0 needed-relay closure of a slab, in the slab's local
    template with its ghost columns occupied, on the positions' device."""
    T = 4
    gtshape = tuple(s // T for s in domain.shape)
    rs = math.prod(gtshape[1:])
    ltshape = (ts + 2,) + gtshape[1:]
    nt_local = math.prod(ltshape)
    dev = pos.device
    tx_l = torch.arange(nt_local, device=dev) // rs
    ghost = (tx_l == 0) | (tx_l == ts + 1)
    probe = StreamSpec(tile=T, cap=128, halo=2, active=1)
    gkeys = stx._keys_from_pos(pos, domain, probe, gtshape, vel=vel, dt=cfg.dt)
    gtx = gkeys // rs
    owner = (gtx // ts).clamp(0, n_shards - 1)
    lkeys = (gtx - owner * ts + 1) * rs + gkeys % rs
    peaks = []
    for d in range(n_shards):
        occ = torch.zeros((nt_local + 1,), dtype=torch.bool, device=dev)
        occ[torch.where(owner == d, lkeys, nt_local)] = True
        peaks.append(stx._active_set(occ[:nt_local] | ghost, ltshape).sum())
    return int(torch.stack(peaks).max())


@dataclasses.dataclass
class ShardStreamState:
    """One shard's stream state plus its exchange tables.

    col [4, ncol] int32: active indices (A = absent) of the x columns
    [own-left tx=1, own-right tx=TS, ghost-left tx=0, ghost-right tx=TS+1],
    in (ty, tz) order; gate [A] int32: count + ghost, what the halos gate
    on; migrated [1] int32: rows this shard has sent to its neighbours
    since it was binned.  All built at (re-)bin time."""

    st: StreamState
    col: torch.Tensor
    gate: torch.Tensor
    migrated: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.st.stream.device

    def clone(self) -> "ShardStreamState":
        return ShardStreamState(st=self.st.clone(), col=self.col.clone(),
                                gate=self.gate.clone(), migrated=self.migrated.clone())


# ---------------------------------------------------------------------------
# Local binning
# ---------------------------------------------------------------------------


def _local_tshape(sspec: StreamShardSpec):
    return tuple(s // sspec.tile for s in sspec.local_domain.shape)


def _col_table(tid_act, sspec: StreamShardSpec) -> torch.Tensor:
    """[4, ncol] active index of each exchange column's tiles."""
    tshape = _local_tshape(sspec)
    rs = math.prod(tshape[1:])
    inv = stx._active_index(tid_act, math.prod(tshape), sspec.spec.A)
    return torch.stack([inv[tx * rs:(tx + 1) * rs]
                        for tx in (1, sspec.ts, 0, sspec.ts + 1)]).to(torch.int32)


def _ghost_mask(sspec: StreamShardSpec, device) -> torch.Tensor:
    """[nt] bool: the two ghost columns (local tx = 0 and TS+1), occupied
    remotely: their windows arrive through the exchange."""
    tshape = _local_tshape(sspec)
    tx = torch.arange(math.prod(tshape), device=device) // math.prod(tshape[1:])
    return (tx == 0) | (tx == tshape[0] - 1)


def _shard_state(st: StreamState, col, sspec: StreamShardSpec) -> ShardStreamState:
    """A shard's state around its binned stream: the halos' gate is count
    plus one at the active ghost tiles."""
    nt = math.prod(_local_tshape(sspec))
    ghost = _ghost_mask(sspec, st.count.device)
    gact = torch.cat([ghost, ghost.new_zeros(1)])[st.tid.long().clamp(0, nt)]
    return ShardStreamState(st=st, col=col, gate=st.count + gact.to(torch.int32),
                            migrated=torch.zeros((1,), dtype=torch.int32, device=st.count.device))


def _bin_local(rows, sspec: StreamShardSpec, keys) -> ShardStreamState:
    """``_bin_rows`` on the local template with the ghost columns forced
    into the closure, plus the column tables and the halos' gate."""
    tshape = _local_tshape(sspec)
    st = stx._bin_rows(rows, keys, sspec.spec, math.prod(tshape), tshape,
                       occ_force=_ghost_mask(sspec, rows.device))
    return _shard_state(st, _col_table(st.tid, sspec), sspec)


def _local_keys(pos_local, vel, sspec: StreamShardSpec, dt: float):
    """Predictive tile keys in the local template."""
    return stx._keys_from_pos(pos_local, sspec.local_domain, sspec.spec,
                              _local_tshape(sspec), vel=vel, dt=dt)


# ---------------------------------------------------------------------------
# Exchange between neighbouring shards
# ---------------------------------------------------------------------------


def _from_neighbour(xs: List[torch.Tensor], step: int) -> List[torch.Tensor]:
    """out[d] = xs[d + step] on shard d's device; zeros where d + step is
    no shard (a non-circular ``ppermute``)."""
    s = len(xs)
    return [xs[d + step].to(x.device, non_blocking=True) if 0 <= d + step < s
            else torch.zeros_like(x) for d, x in enumerate(xs)]


def _exchange_blocks(blocks: List[torch.Tensor], states: List[ShardStreamState]) -> List[torch.Tensor]:
    """Fill each shard's ghost columns with its neighbours' edge-owned
    windows, in place; blocks [A, CH, E^D].  The kernels leave a ghost
    tile's own window zero (it holds no particle), so adding the incoming
    rows writes them; rows of absent tiles (col == A) travel as zeros and
    add nothing."""
    A = blocks[0].shape[0]

    def column(flat, idx):
        return torch.where((idx < A)[:, None], flat[idx.long().clamp_max(A - 1)], 0.0)

    send_l, send_r = [], []
    for x, ss in zip(blocks, states):
        flat = x.view(A, -1)
        send_l.append(column(flat, ss.col[0]))  # my left-owned column -> left neighbour
        send_r.append(column(flat, ss.col[1]))  # my right-owned column -> right neighbour
    recv_r = _from_neighbour(send_l, +1)  # lands in my right ghost column
    recv_l = _from_neighbour(send_r, -1)  # lands in my left ghost column
    for x, ss, rr, rl in zip(blocks, states, recv_r, recv_l):
        flat = x.view(A, -1)
        for idx, rows in ((ss.col[3], rr), (ss.col[2], rl)):
            ok = (idx < A)[:, None]
            flat.index_add_(0, idx.long().clamp_max(A - 1), torch.where(ok, rows, 0.0))
    return blocks


def exchange_bytes(sspec: StreamShardSpec) -> int:
    """Bytes one substep copies between shards: per boundary, both
    directions of a column of mass windows and of momentum+force windows."""
    D = sspec.domain.dim
    return (sspec.n_shards - 1) * 2 * sspec.ncol * (1 + D) * sspec.spec.E**D * 4


# ---------------------------------------------------------------------------
# Substep, re-bin, frame
# ---------------------------------------------------------------------------


class _Stages:
    """Per-shard kernel parameters of one frame: the p2g_2 and collect
    parameters on each shard's device, the collect's x walls and mouse
    shifted into the local template."""

    def __init__(self, cfg: Config, sspec: StreamShardSpec, states, mouse_pos, mouse_active):
        D = cfg.dim
        self.g = stx.tile_geom(sspec.local_domain, sspec.spec)
        self.dtg = sk.gravity_step(cfg.dt, cfg.gravity)
        self.params6, self.params = [], []
        for d, ss in enumerate(states):
            dev = ss.device
            self.params6.append(torch.tensor(
                [cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                 cfg.pressure_floor, cfg.dynamic_viscosity], dtype=torch.float32, device=dev))
            p = stx.collect_params(cfg, mouse_pos, mouse_active, dev)
            for i in (8, 10, 10 + D):  # mouse x, clip_lo x, clip_hi x
                p[i] -= sspec.shift(d)
            self.params.append(p)

    def dep1(self, states):
        return [sk.deposit_p2g1(ss.st.count, ss.st.tid, ss.st.stream, self.g) for ss in states]


def _sharded_substep(states: List[ShardStreamState], dep1, stages: _Stages):
    """One substep on every shard, the exchanges between deposit and halo:
    K4 mass and K5 read the ghost windows through the ``gate``.  Returns
    (states, next substep's p2g_1 windows)."""
    g = stages.g
    m1 = _exchange_blocks([d1[:, :1].contiguous() for d1 in dep1], states)
    hs_m = [sk.halo_axes(m, ss.st.count, ss.st.nbr, g, gate=ss.gate)
            for m, ss in zip(m1, states)]
    d2 = _exchange_blocks(
        [sk.deposit_p2g2(ss.st.count, ss.st.tid, ss.st.stream, h, p6, d1, g)
         for ss, h, p6, d1 in zip(states, hs_m, stages.params6, dep1)], states)
    out, dep1_next = [], []
    for ss, x, h, p in zip(states, d2, hs_m, stages.params):
        gblk = sk.halo_gblk(x, h, ss.st.count, ss.st.nbr, stages.dtg, g, gate=ss.gate)
        stream, flag, dep = sk.collect(ss.st.count, ss.st.tid, p, ss.st.stream, gblk, g)
        out.append(dataclasses.replace(ss, st=dataclasses.replace(ss.st, stream=stream, flag=flag)))
        dep1_next.append(dep)
    return out, dep1_next


def _extract_k(mask, k: int):
    """Indices of the first k set entries of ``mask`` (index order) and
    their validity."""
    n = mask.shape[0]
    prio = torch.where(mask, torch.arange(n, device=mask.device), n)
    order = torch.argsort(prio, stable=True)[:k]
    return order, mask[order]


def _sharded_rebin(states: List[ShardStreamState], cfg: Config,
                   sspec: StreamShardSpec) -> List[ShardStreamState]:
    """Re-bin every shard's live rows (at most ``live_cap_rows``) and move
    the rows whose predictive key lands in a ghost column to the neighbour
    that owns it (up to ``migrate_cap`` each way).  Watermarks and counters
    carry over; rows this re-bin cannot keep count into ``shell_drop``.
    Each shard's live count is read on the host, so the re-bin's row shape
    follows it (JAX needs the static ``live_cap`` shape instead)."""
    D = cfg.dim
    tshape = _local_tshape(sspec)
    nt, rs = math.prod(tshape), math.prod(tshape[1:])
    mcap = sspec.migrate_cap
    g = stx.tile_geom(sspec.local_domain, sspec.spec)
    parts = []
    for d, ss in enumerate(states):
        st = ss.st
        live = int(st.count.sum())
        ncap = max(min(live, sspec.live_cap_rows), 1)  # one invalid row when empty
        # the live rows in slot order and their local keys (nt past the live rows)
        rows, keys = sk.rebin_gather(st.stream, st.count, ncap, g, stx._LOOKAHEAD * cfg.dt)
        keys = keys.long()
        valid = torch.arange(ncap, device=ss.device) < live
        tx = keys // rs
        go_l, go_r = valid & (tx == 0), valid & (tx == sspec.ts + 1)
        sel_l, val_l = _extract_k(go_l, mcap)
        sel_r, val_r = _extract_k(go_r, mcap)
        em = []
        for sel, val in ((sel_l, val_l), (sel_r, val_r)):
            e = torch.where(val[:, None], rows[sel], 0.0)
            e[:, 0] += torch.where(val, float(sspec.shift(d)), 0.0)  # leaves in global x
            keys[sel] = torch.where(val, nt, keys[sel])
            em.append(e)
        # rows past live_cap, and movers past migrate_cap (which would bin
        # in a ghost tile), are lost to the physics
        dropped = (max(live - sspec.live_cap_rows, 0) + (go_l.sum() - mcap).clamp_min(0)
                   + (go_r.sum() - mcap).clamp_min(0)).to(torch.int32)
        shipped = (val_l.sum() + val_r.sum()).to(torch.int32)
        parts.append((rows, keys, em[0], val_l, em[1], val_r, dropped, shipped))
    im_r = _from_neighbour([p[2] for p in parts], +1)  # from the right neighbour's left movers
    imv_r = _from_neighbour([p[3] for p in parts], +1)
    im_l = _from_neighbour([p[4] for p in parts], -1)
    imv_l = _from_neighbour([p[5] for p in parts], -1)
    out = []
    for d, (ss, part) in enumerate(zip(states, parts)):
        rows, keys, _, _, _, _, dropped, shipped = part
        im = torch.cat([im_l[d], im_r[d]])
        imv = torch.cat([imv_l[d], imv_r[d]])
        im[:, 0] -= torch.where(imv, float(sspec.shift(d)), 0.0)
        im_keys = torch.where(imv, _local_keys(im[:, :D], im[:, D:2 * D], sspec, cfg.dt), nt)
        rows_all = torch.cat([rows, im])
        new = _bin_local(rows_all, sspec, torch.cat([keys, im_keys]))
        old = ss.st
        new.st = dataclasses.replace(
            new.st,
            shell_drop=torch.maximum(old.shell_drop, new.st.shell_drop + dropped),
            need_peak=torch.maximum(old.need_peak, new.st.need_peak),
            fill_peak=torch.maximum(old.fill_peak, new.st.fill_peak),
            rebins=old.rebins + 1,
        )
        new.migrated = ss.migrated + shipped
        out.append(new)
    return out


def sharded_frame_binned(states: List[ShardStreamState], cfg: Config, sspec: StreamShardSpec,
                         mouse_pos, mouse_active, substeps: Optional[int] = None):
    """``cfg.iterations`` substeps (or ``substeps``) on every shard, with
    re-bins and migration when any shard's drift flag fires.  Returns
    (states, re-bins this frame), the count every shard agrees on."""
    stages = _Stages(cfg, sspec, states, mouse_pos, mouse_active)
    dev0 = states[0].device
    dep1 = stages.dep1(states)
    rebins = 0
    for _ in range(cfg.iterations if substeps is None else substeps):
        states, dep1 = _sharded_substep(states, dep1, stages)
        # one host read per substep for the whole mesh (lax.pmax in JAX)
        if bool(torch.stack([stx.needs_rebin(ss.st).to(dev0) for ss in states]).any()):
            states = _sharded_rebin(states, cfg, sspec)
            dep1 = stages.dep1(states)
            rebins += 1
    return states, rebins


# ---------------------------------------------------------------------------
# Building, gathering, carrying state across
# ---------------------------------------------------------------------------


def shard_stream(p: ParticleState, cfg: Config, sspec: StreamShardSpec,
                 devices: Sequence) -> List[ShardStreamState]:
    """Bin particles into per-shard local streams, shard d on
    ``devices[d]``.  A particle's owner follows its predictive key, the
    key local binning uses: an owner by raw position could key a boundary
    resident into its own ghost column, where the exchange overwrites it."""
    spec, s, T, D, n = sspec.spec, sspec.n_shards, sspec.tile, p.dim, p.n
    if len(devices) != s:
        raise ValueError(f"{len(devices)} devices for {s} shards")
    if n >= 2**24:
        raise ValueError(f"n={n}: the float32 id row is exact only below 2**24")
    tshape = _local_tshape(sspec)
    nt = math.prod(tshape)
    gtshape = tuple(sh // T for sh in sspec.domain.shape)
    gkeys = stx._keys_from_pos(p.pos, sspec.domain, spec, gtshape, vel=p.vel, dt=cfg.dt)
    owner = (gkeys // math.prod(gtshape[1:]) // sspec.ts).clamp(0, s - 1)
    rows_all = torch.cat(
        [p.pos, p.vel, p.C.reshape(n, D * D), p.mass[:, None],
         torch.arange(n, dtype=torch.float32, device=p.device)[:, None],
         p.density[:, None], p.pressure[:, None]], dim=1)
    order = torch.argsort(owner, stable=True)
    sizes = torch.bincount(owner, minlength=s).tolist()
    out, start = [], 0
    for d, (dev, size) in enumerate(zip(devices, sizes)):
        if size > spec.A * spec.cap:
            raise ValueError(f"shard {d}: {size} particles > budget {spec.A * spec.cap}")
        rows = rows_all[order[start:start + size]].to(dev)
        start += size
        rows[:, 0] -= sspec.shift(d)  # into the local template
        keys = _local_keys(rows[:, :D], rows[:, D:2 * D], sspec, cfg.dt)
        if size == 0:  # one row that lands in no tile
            rows, keys = rows.new_zeros((1, rows.shape[1])), keys.new_full((1,), nt)
        out.append(_bin_local(rows, sspec, keys))
    return out


def gather_stream(states: List[ShardStreamState], cfg: Config, sspec: StreamShardSpec,
                  n: int) -> ParticleState:
    """Every shard's live slots back in one ParticleState in the original
    order, on the first shard's device.  Raises on particle loss or an
    exhausted budget (``shell_drop``)."""
    D = cfg.dim
    g = stx.tile_geom(sspec.local_domain, sspec.spec)
    dev0 = states[0].device
    out = torch.zeros((n, 2 * D + D * D + 4), dtype=torch.float32, device=dev0)
    seen = 0
    for d, ss in enumerate(states):
        live = int(ss.st.count.sum())
        if live == 0:
            continue
        rows = sk.rebin_gather(ss.st.stream, ss.st.count, live, g, 0.0)[0].to(dev0)
        rows[:, 0] += sspec.shift(d)  # back to global x
        out[rows[:, stx._id_row(D)].long()] = rows
        seen += live
    if seen != n:
        raise RuntimeError(f"particle loss across shards: {seen} != {n}")
    drops = max(int(ss.st.shell_drop.max()) for ss in states)
    if drops:
        raise RuntimeError(f"a shard's re-bin dropped {drops} relay tiles or rows: physics invalid")
    return ParticleState(
        pos=out[:, 0:D].contiguous(), vel=out[:, D:2 * D].contiguous(),
        C=out[:, 2 * D:2 * D + D * D].reshape(n, D, D).contiguous(),
        mass=out[:, 2 * D + D * D].contiguous(),
        density=out[:, 2 * D + D * D + 2].contiguous(),
        pressure=out[:, 2 * D + D * D + 3].contiguous(),
    )


def shard_stream_state_from_numpy(d: dict, sspec: StreamShardSpec,
                                  devices: Sequence) -> List[ShardStreamState]:
    """A ``fluid_tpu`` ShardStreamState as numpy (``pair=False``): the
    fields of its StreamState plus ``col``, each with the device axis merged
    into dim 0 -> the port's per-shard list, shard k on ``devices[k]``."""
    out = []
    for k, dev in enumerate(devices):
        part = {key: np.split(np.asarray(v), sspec.n_shards)[k] for key, v in d.items()}
        col = torch.as_tensor(np.array(part["col"]), dtype=torch.int32, device=dev)
        out.append(_shard_state(stx.stream_state_from_numpy(part, sspec.spec, dev), col, sspec))
    return out


# ---------------------------------------------------------------------------
# Interactive session
# ---------------------------------------------------------------------------


class ShardedSession:
    """The ``Session`` counterpart for the sharded stream backend: holds
    every shard's binned state across frames, advances frames with shared
    re-bins and migration, renders from per-shard histograms.  Strict mode
    checks conservation and the ``shell_drop`` watermark after every frame.

    devices : one per shard, repeats allowed (None: every card; raises
        without one, never falls back to the CPU)
    """

    def __init__(self, cfg: Config, domain: Domain, p: ParticleState, devices=None,
                 sspec: Optional[StreamShardSpec] = None, strict: bool = True):
        self.devices = cuda_devices() if devices is None else [torch.device(d) for d in devices]
        self.cfg = cfg
        self.domain = domain
        self.n = p.n
        self.strict = strict
        s = len(self.devices)
        self.sspec = sspec if sspec is not None else default_shard_spec(
            cfg, domain, s, p.n, pos=p.pos, vel=p.vel)
        if self.sspec.n_shards != s:
            raise ValueError(f"spec of {self.sspec.n_shards} shards for {s} devices")
        self._ss = shard_stream(p, cfg, self.sspec, self.devices)
        self._frames = 0
        self.rebins = 0  # re-bins since binning

    def _check(self, label: str) -> None:
        drops = self.shell_drop()
        if drops:
            raise RuntimeError(f"budget exhaustion {label}: {drops} relay tiles or rows dropped "
                               f"on a shard (raise spec.active, live_cap or migrate_cap)")
        live = self.live_count()
        if live != self.n:
            raise RuntimeError(f"particle loss {label}: sum(count)={live} != n={self.n} "
                               f"(raise spec.active/cap)")

    def frame(self, mouse=None) -> None:
        """Advance one frame (``cfg.iterations`` substeps)."""
        mp, ma = mouse if mouse is not None else step_mod.no_mouse()
        self._ss, nrb = sharded_frame_binned(self._ss, self.cfg, self.sspec, mp, ma)
        self.rebins += nrb
        self._frames += 1
        if self.strict:
            self._check(f"at frame {self._frames}")

    def run(self, frames: int, mouse=None) -> None:
        """Advance ``frames`` frames with the same mouse input."""
        for _ in range(frames):
            self.frame(mouse)

    def snapshot(self):
        """Deep copy of every shard's state; ``restore`` replays from it."""
        return self._frames, self.rebins, [ss.clone() for ss in self._ss]

    def restore(self, snap) -> None:
        """Reset to a ``snapshot()`` (copies again, so a snapshot survives
        repeated restores)."""
        self._frames, self.rebins, src = snap
        self._ss = [ss.clone() for ss in src]

    def live_count(self) -> int:
        return sum(int(ss.st.count.sum()) for ss in self._ss)

    def shell_drop(self) -> int:
        return max(int(ss.st.shell_drop.max()) for ss in self._ss)

    def need_peak(self) -> int:
        return max(int(ss.st.need_peak.max()) for ss in self._ss)

    def migrated(self) -> int:
        """Rows sent across a slab boundary since binning."""
        return sum(int(ss.migrated.sum()) for ss in self._ss)

    def block_until_ready(self) -> None:
        """Wait for every card, then read one element of each shard."""
        for dev in {ss.device for ss in self._ss}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        for ss in self._ss:
            float(ss.st.stream.reshape(-1)[0])

    def shard_states(self) -> List[ShardStreamState]:
        return self._ss

    def particles(self) -> ParticleState:
        return gather_stream(self._ss, self.cfg, self.sspec, self.n)

    def histogram(self, viewport_size, console_size) -> torch.Tensor:
        """(H, W) int32 console counts: each shard bins its live slots in
        global x on its device; the first shard's device sums them."""
        dev0 = self._ss[0].device
        total = None
        for d, ss in enumerate(self._ss):
            st = ss.st
            h = render_mod.console_histogram(st.stream[:, 0, :], st.stream[:, 1, :], st.count,
                                             viewport_size, console_size,
                                             x_shift=float(self.sspec.shift(d))).to(dev0)
            total = h if total is None else total + h
        return total

    def render(self, viewport_size, console_size) -> list:
        return render_mod.ascii_frame(self.histogram(viewport_size, console_size).cpu())
