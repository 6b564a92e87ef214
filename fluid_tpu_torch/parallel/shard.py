"""Dense x-slab decomposition with backpressured migration (PyTorch port of
``fluid_tpu/parallel/shard.py``).

The reference's chunk halo and ``swap_mul`` migration buffers
(``2d_multi.rs:79-87``, ``:327-358``) as an owner-computes + ghost-exchange
pattern over a list of devices, one per shard:

* the dense grid is split into x-slabs, each shard holding its slab plus a
  one-cell halo on each side (the stencil radius);
* after the local P2G scatters, halo partial sums are added into the
  neighbour that owns them and the completed edge cells are copied back
  into the halos (``_exchange_add`` / ``_exchange_fill``);
* particles crossing a slab boundary migrate through fixed-capacity
  buffers into free slots of the neighbour (``_migrate``), never deleted
  (quirk Q6): a sender ships no more than its neighbour advertised free
  slots, and the rest stay alive where they are until there is room.

Each shard holds ``capacity`` particle slots with an ``alive`` mask; dead
slots carry zero mass.  The local substep is the dense reference's
(``ops/transfer.py``) on the shard's slab, a ``Domain`` whose origin is the
slab's.  Edge shards exchange with nobody (zeros arrive), which drops taps
outside the grid as the dense path does (``2d_multi.rs:165-167``).  Plain
PyTorch: no kernel runs here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..domain import Domain
from ..ops import transfer
from ..state import FIELDS, ParticleState
from .stream_shard import _extract_k, _from_neighbour


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Static decomposition geometry."""

    domain: Domain
    n_shards: int
    capacity: int  # particle slots per shard
    migrate_cap: int  # most emigrants per direction and substep

    def __post_init__(self):
        if self.n_shards > self.domain.shape[0]:
            raise ValueError(f"{self.n_shards} shards exceed grid x-extent {self.domain.shape[0]}")

    @property
    def slab(self) -> int:
        """Owned cells along x per shard (ceil: the conceptual grid pads up
        to slab * n_shards; particles never reach the pad)."""
        return -(-self.domain.shape[0] // self.n_shards)

    def local_domain(self, d: int) -> Domain:
        """Shard d's slab plus its one-cell halos."""
        dom = self.domain
        return dataclasses.replace(
            dom, origin=(dom.origin[0] + d * self.slab - 1, *dom.origin[1:]),
            shape=(self.slab + 2, *dom.shape[1:]))


@dataclasses.dataclass
class LocalParticles:
    """One shard's fixed-capacity particle slots."""

    p: ParticleState
    alive: torch.Tensor  # [capacity] bool
    uid: torch.Tensor  # [capacity] int32, the global particle id (-1: free)


# ---------------------------------------------------------------------------
# Halo exchange
# ---------------------------------------------------------------------------


def _exchange_add(arrs: List[torch.Tensor], slab: int) -> List[torch.Tensor]:
    """Fold each halo slice's partial sums into the neighbour's edge cells."""
    from_right = _from_neighbour([a[0:1] for a in arrs], +1)  # right neighbour's left halo
    from_left = _from_neighbour([a[slab + 1:slab + 2] for a in arrs], -1)
    out = []
    for a, r, l in zip(arrs, from_right, from_left):
        a = a.clone()
        a[slab:slab + 1] += r
        a[1:2] += l
        out.append(a)
    return out


def _exchange_fill(arrs: List[torch.Tensor], slab: int) -> List[torch.Tensor]:
    """Copy the completed edge cells into the neighbours' halo slices."""
    from_right = _from_neighbour([a[1:2] for a in arrs], +1)  # their first owned cells
    from_left = _from_neighbour([a[slab:slab + 1] for a in arrs], -1)
    out = []
    for a, r, l in zip(arrs, from_right, from_left):
        a = a.clone()
        a[slab + 1:slab + 2] = r
        a[0:1] = l
        out.append(a)
    return out


# ---------------------------------------------------------------------------
# Substep
# ---------------------------------------------------------------------------


def _substep(lps: List[LocalParticles], cfg: Config, spec: ShardSpec,
             mouse_pos, mouse_active) -> List[LocalParticles]:
    """One substep on every shard: p2g_1, the mass halo, p2g_2, the
    momentum halo, the grid update, the velocity halo, g2p, migration."""
    slab = spec.slab
    doms = [spec.local_domain(d) for d in range(len(lps))]
    # dead slots deposit nothing
    live = [dataclasses.replace(lp.p, mass=torch.where(lp.alive, lp.p.mass, 0.0)) for lp in lps]
    grids = [transfer.p2g_1(q, cfg, dom) for q, dom in zip(live, doms)]
    masses = _exchange_fill(_exchange_add([g.mass for g in grids], slab), slab)
    out = [transfer.p2g_2(q, dataclasses.replace(g, mass=m), cfg, dom)
           for q, g, m, dom in zip(live, grids, masses, doms)]
    moms = _exchange_add([g.vel for g, _, _ in out], slab)
    vels = _exchange_fill([transfer.grid_update(dataclasses.replace(g, vel=v), cfg).vel
                           for (g, _, _), v in zip(out, moms)], slab)
    new = []
    for lp, (g, density, pressure), v, dom in zip(lps, out, vels, doms):
        p = transfer.g2p(lp.p, dataclasses.replace(g, vel=v), cfg, dom, mouse_pos,
                         mouse_active, density, pressure)
        new.append(LocalParticles(p=p, alive=lp.alive, uid=lp.uid))
    return _migrate(new, spec)


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------


def _arrays(lp: LocalParticles):
    return tuple(getattr(lp.p, f) for f in FIELDS) + (lp.uid,)


def _migrate(lps: List[LocalParticles], spec: ShardSpec) -> List[LocalParticles]:
    """Lossless migration with receiver backpressure (quirk Q6,
    ``2d_multi.rs:302-306``, ``:327-358``):

    1. each shard tells each neighbour how many immigrants it accepts (its
       free slots, split between the two directions);
    2. senders extract at most ``min(migrate_cap, budget)`` emigrants per
       direction; the rest stay alive at the sender, their stencil taps
       beyond the local halo dropped while they wait;
    3. receivers place arrivals into free slots, which (1) guarantees.
    """
    slab, cap, mcap = spec.slab, spec.capacity, spec.migrate_cap
    ext = []
    for d, lp in enumerate(lps):
        cx = torch.floor(lp.p.pos[:, 0]).to(torch.int64) - spec.domain.origin[0]
        free = cap - lp.alive.sum()
        ext.append((cx, free // 2, free - free // 2))
    budget_r = _from_neighbour([e[1] for e in ext], +1)  # the right neighbour's quota for me
    budget_l = _from_neighbour([e[2] for e in ext], -1)
    sends_l, sends_r, kept = [], [], []
    rank = torch.arange(mcap)
    for d, (lp, (cx, _, _)) in enumerate(zip(lps, ext)):
        x0 = d * slab
        alive = lp.alive.clone()
        arrays = _arrays(lp)
        out = []
        for mask, budget in ((lp.alive & (cx < x0), budget_l[d]),
                             (lp.alive & (cx >= x0 + slab), budget_r[d])):
            sel, val = _extract_k(mask, mcap)
            val = val & (rank[:sel.shape[0]].to(mask.device) < budget)  # backpressure
            alive[sel] = alive[sel] & ~val
            em = tuple(torch.where(val.reshape((-1,) + (1,) * (a.ndim - 1)), a[sel], 0)
                       for a in arrays)
            out.append(em + (val,))
        sends_l.append(out[0])
        sends_r.append(out[1])
        kept.append(alive)
    recv_r = list(zip(*[_from_neighbour(list(col), +1) for col in zip(*sends_l)]))
    recv_l = list(zip(*[_from_neighbour(list(col), -1) for col in zip(*sends_r)]))
    new = []
    for lp, alive, im_r, im_l in zip(lps, kept, recv_r, recv_l):
        imv_r, imv_l = im_r[-1], im_l[-1]
        # left immigrants take the first free slots, right ones the next
        free, free_ok = _extract_k(~alive, 2 * mcap)
        k = free.shape[0]
        n_l = imv_l.sum()
        slots_l = free[:mcap]
        idx_r = (n_l + torch.arange(mcap, device=alive.device)).clamp(0, k - 1)
        slots_r = free[idx_r]
        ok_l = imv_l & free_ok[:mcap]
        ok_r = imv_r & free_ok[idx_r]
        arrays = []
        for a, il, ir in zip(_arrays(lp), im_l[:-1], im_r[:-1]):
            a = a.clone()
            shape = (-1,) + (1,) * (a.ndim - 1)
            a[slots_l] = torch.where(ok_l.reshape(shape), il, a[slots_l])
            a[slots_r] = torch.where(ok_r.reshape(shape), ir, a[slots_r])
            arrays.append(a)
        alive[slots_l] = alive[slots_l] | ok_l
        alive[slots_r] = alive[slots_r] | ok_r
        new.append(LocalParticles(p=ParticleState(**dict(zip(FIELDS, arrays[:-1]))),
                                  alive=alive, uid=arrays[-1]))
    return new


# ---------------------------------------------------------------------------
# Building, gathering, the frame
# ---------------------------------------------------------------------------


def default_spec(domain: Domain, n_shards: int, n_particles: int,
                 capacity_factor: float = 6.0) -> ShardSpec:
    """Per-shard capacity: ``capacity_factor`` times the mean share, since
    a dam break starts in the few slabs under its seed box."""
    cap = max(int(np.ceil(n_particles / n_shards * capacity_factor)), 8)
    return ShardSpec(domain=domain, n_shards=n_shards, capacity=cap, migrate_cap=max(cap // 4, 4))


def shard_particles(p: ParticleState, spec: ShardSpec, devices: Sequence) -> List[LocalParticles]:
    """Place particles into their owner slabs' slots, shard d on
    ``devices[d]``."""
    s, cap = spec.n_shards, spec.capacity
    if len(devices) != s:
        raise ValueError(f"{len(devices)} devices for {s} shards")
    cx = torch.floor(p.pos[:, 0]).to(torch.int64) - spec.domain.origin[0]
    owner = (cx // spec.slab).clamp(0, s - 1)
    out = []
    for d, dev in enumerate(devices):
        ids = torch.nonzero(owner == d)[:, 0]
        k = ids.shape[0]
        if k > cap:
            raise ValueError(f"shard {d} holds {k} particles > capacity {cap}")
        fields = {}
        for f in FIELDS:
            a = getattr(p, f)
            fields[f] = torch.zeros((cap,) + a.shape[1:], dtype=a.dtype, device=dev)
            fields[f][:k] = a[ids].to(dev)
        alive = torch.zeros((cap,), dtype=torch.bool, device=dev)
        alive[:k] = True
        uid = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        uid[:k] = ids.to(device=dev, dtype=torch.int32)
        out.append(LocalParticles(p=ParticleState(**fields), alive=alive, uid=uid))
    return out


def gather_particles(lps: List[LocalParticles], n: int) -> ParticleState:
    """The alive particles in global id order, on the first shard's device;
    raises unless exactly ``n`` are alive."""
    dev0 = lps[0].alive.device
    uid = torch.cat([lp.uid[lp.alive].to(dev0) for lp in lps]).long()
    if uid.shape[0] != n:
        raise RuntimeError(f"expected {n} alive particles, found {uid.shape[0]}")
    out = {}
    for f in FIELDS:
        a = torch.cat([getattr(lp.p, f)[lp.alive].to(dev0) for lp in lps])
        full = torch.zeros_like(a)
        full[uid] = a
        out[f] = full
    return ParticleState(**out)


def sharded_frame(lps: List[LocalParticles], cfg: Config, spec: ShardSpec, mouse_pos,
                  mouse_active, substeps: Optional[int] = None) -> List[LocalParticles]:
    """One frame (``cfg.iterations`` substeps, or ``substeps``) on every
    shard, the counterpart of ``step.frame``."""
    for _ in range(cfg.iterations if substeps is None else substeps):
        lps = _substep(lps, cfg, spec, mouse_pos, mouse_active)
    return lps
