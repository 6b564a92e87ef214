"""The stream backend's kernel entry points: wrapper, plain version, count.

Each of the substep's ``deposit_p2g1``, ``deposit_p2g2``, ``collect``,
``halo_axes`` and ``halo_gblk``, and the re-bin's ``rebin_gather`` and
``rebin_fill``, is a wrapper that checks its tensors and then

* for CPU tensors, runs the plain PyTorch version below (direct 3^D taps
  with ``index_add_`` and gathers at the tile-window level) — the CPU tests'
  path, and what ``chip_smoke.py`` holds the kernels against on the card;
* for CUDA tensors, launches the hand-written kernel of
  ``csrc/stream_kernels.cu`` (the re-bin's: ``csrc/rebin_kernels.cu``) and
  raises if the launch reports an error.  There is no fallback from a CUDA
  tensor to the plain version.

``LIBRARY`` builds those two sources and the console render's
(``csrc/render_kernels.cu``, launched by ``render.console_histogram``) into
the stream library (``cuda_build``) at the first launch; ``_launch`` calls
an entry point of it, or of the library another module's wrapper passes.

``LAUNCHES[name]`` counts the kernel launches of each wrapper (never the
plain versions), one name per TPU kernel and per re-bin kernel, so a run
can show that its main path went through every kernel; ``halo_axes``
counts as ``halo_axis``.

The plain versions compute each particle's and each tap's values in the
kernels' arithmetic order (taps in stencil order, axis 0 fastest), and
collect and the halo sum in the kernels' order too, so those agree bit for
bit on the card, as the re-bin's do.  The deposits do not: the kernels sum
a cell's particles in slot order and the plain versions with
``index_add_``, in its own order, so the two differ by rounding.

Layouts (see ``csrc/stream_kernels.cu``): stream ``[A, F, cap]``, windows
``[A, CH, E^D]`` in flat cell order ``(e_0, ..., e_{D-1})``, flag
``[A, cap]``, count / tid / neighbour rows ``[A]`` int32.

The occupied entries: the five substep wrappers take ``occupied``, a [1]
int32 tensor on the device, the number of entries with count > 0, which the
binning puts first (``StreamState.occupied``).  They then work on the
entries below it only, and the windows they return (or write into ``out``)
are undefined at and past it: nothing reads them.  The kernels leave those
rows as the buffer held them; the plain versions leave an ``out`` buffer's
rows as they were and fill a new output's with NaN, so that a stage that
read one would show it in the CPU tests.  ``occupied`` None is every entry
of A, with zero windows at count 0 (the sharded path, whose ghost entries
are zero-count actives that its exchange fills).

Packed scenes (``TileGeom.scene_cells``): a tile of scene k holds its
particles in that scene's coordinates, and every kernel that turns a
position into a cell adds the integer ``k * scene_cells`` on axis 0, folded
into the tile's corner (``_tile_corner``) once a tile; the collect keeps
each particle inside its own scene's walls, which are the configuration's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.graph import device_const
from . import cuda_build
from .bspline import quadratic_weights, stencil_offsets

KERNELS = ("deposit_p2g1", "deposit_p2g2", "collect", "halo_axis", "halo_gblk",
           "rebin_gather", "rebin_fill")
LAUNCHES = {name: 0 for name in KERNELS}
LIBRARY = cuda_build.Library("stream", ("stream_kernels.cu", "rebin_kernels.cu", "render_kernels.cu"))


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True)
class TileGeom:
    """Static tile geometry the kernels need."""

    dim: int
    tile: int  # T, cells per tile edge
    halo: int  # h, window reach beyond the tile
    cap: int  # slots per tile
    tshape: Tuple[int, ...]  # tiles per axis
    origin: Tuple[int, ...]  # domain origin, in cells
    # packed scenes: grid cells of one scene along axis 0 (0: one scene)
    scene_cells: int = 0

    @property
    def sx(self) -> int:
        """Grid cells of one scene along axis 0: the grid's for one scene."""
        return self.scene_cells or self.tshape[0] * self.tile

    @property
    def E(self) -> int:
        return self.tile + 2 * self.halo

    @property
    def ncell(self) -> int:
        return self.E**self.dim

    @property
    def F(self) -> int:
        return 2 * self.dim + self.dim * self.dim + 4


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _undefined_past(x: torch.Tensor, occupied, out=None) -> torch.Tensor:
    """A stage output ``x`` [A, ...] as the kernels leave it given
    ``occupied``: the rows below it, and past it ``out``'s rows as they
    were (written into ``out``) or, for a new output, NaN.  ``occupied``
    None: ``x`` itself (or copied into ``out``)."""
    if occupied is None:
        return x if out is None else out.copy_(x)
    below = torch.arange(x.shape[0], device=x.device) < occupied
    below = below.reshape(-1, *([1] * (x.dim() - 1)))
    return (torch.where(below, x, float("nan")) if out is None
            else out.copy_(torch.where(below, x, out)))


def _valid_slots(count: torch.Tensor, cap: int):
    """(tile index, slot index) of every valid slot, in slot order."""
    s = torch.arange(cap, device=count.device)
    return (s[None, :] < count[:, None]).nonzero(as_tuple=True)


def _scene_offset(corner0: torch.Tensor, g: TileGeom) -> torch.Tensor:
    """The x offset ``k * sx`` of the scene that owns grid column ``corner0``
    (0 for one scene)."""
    return corner0 // g.sx * g.sx


def _tile_corner(tid: torch.Tensor, g: TileGeom) -> torch.Tensor:
    """[V, D] int64 cell of each tile's corner in its scene's coordinates:
    ``origin + coord * T``, less the scene's offset on axis 0."""
    coord = torch.stack(
        [(tid // math.prod(g.tshape[d + 1:])) % g.tshape[d] for d in range(g.dim)],
        dim=-1,
    ) * g.tile
    corner = torch.as_tensor(g.origin, device=tid.device) + coord
    if g.scene_cells:
        corner[:, 0] -= _scene_offset(coord[:, 0], g)
    return corner


def _stencil(pos: torch.Tensor, tid: torch.Tensor, g: TileGeom):
    """Window row base [V, D] (clipped to the drift window), dvec [V, D] and
    per-axis weights [V, 3, D] of particles at ``pos`` in tiles ``tid``."""
    cf = torch.floor(pos)
    lc = cf.to(torch.int64) - _tile_corner(tid, g)
    base = (lc + g.halo - 1).clamp(0, g.E - 3)
    dvec = (pos - cf) - 0.5
    return base, dvec, quadratic_weights(dvec)


def _taps(base, dvec, ws, g: TileGeom):
    """Per tap (stencil order): weight [V, K], window cell [V, K], dpos
    [V, K, D] = tap cell centre minus particle."""
    offs = stencil_offsets(g.dim, base.device)  # [K, D]
    D = g.dim
    w = ws[:, offs[:, 0], 0]
    for d in range(1, D):
        w = w * ws[:, offs[:, d], d]
    e = base[:, None, 0] + offs[None, :, 0]
    for d in range(1, D):
        e = e * g.E + (base[:, None, d] + offs[None, :, d])
    dpos = (offs - 1).to(torch.float32)[None] - dvec[:, None, :]
    return w, e, dpos


def _scatter_windows(a_idx, e, vals, A: int, g: TileGeom) -> torch.Tensor:
    """vals [V, K, CH] summed into windows [A, CH, E^D] at cells (a, e)."""
    CH = vals.shape[-1]
    out = torch.zeros((A * g.ncell, CH), dtype=torch.float32, device=vals.device)
    out.index_add_(0, (a_idx[:, None] * g.ncell + e).reshape(-1), vals.reshape(-1, CH))
    return out.reshape(A, g.ncell, CH).permute(0, 2, 1).contiguous()


def _p2g1_windows(a_idx, pos, vel, C, mass, tid, A: int, g: TileGeom):
    """Mass + APIC momentum windows [A, 1+D, E^D] of the given particles."""
    base, dvec, ws = _stencil(pos, tid, g)
    w, e, dpos = _taps(base, dvec, ws, g)
    mc = w * mass[:, None]
    cols = [mc]
    for i in range(g.dim):
        q = C[:, i, 0, None] * dpos[..., 0]
        for j in range(1, g.dim):
            q = q + C[:, i, j, None] * dpos[..., j]
        cols.append(mc * (vel[:, i, None] + q))
    return _scatter_windows(a_idx, e, torch.stack(cols, dim=-1), A, g)


def _tap_sum(w, vals):
    """sum_k w[:, k] * vals[:, k] in stencil order (the kernels' order)."""
    acc = torch.zeros_like(w[:, 0])
    for k in range(w.shape[1]):
        acc = acc + w[:, k] * vals[:, k]
    return acc


def _pressure(rho, rest, k_eos, gamma, floor_p):
    return torch.clamp_min(k_eos * (torch.pow(rho / rest, gamma) - 1.0), floor_p)


def _particle_tail(newpos, v, params, x_shift):
    """Per-axis lists of advected positions and grid velocities [V], in
    place: the mouse impulse after advection (quirk Q3, xy plane), then the
    clamp and the un-scaled soft wall (quirk Q2) with the x walls shifted by
    ``x_shift``.  ``mpm::particle_tail`` of ``csrc/mpm_common.cuh``, which
    has no shift: both collects pass 0, a packed scene's particles being in
    its own coordinates."""
    D = len(newpos)
    mouse_r, damp, m_active, mx, my = params[5], params[6], params[7], params[8], params[9]
    dx = newpos[0] - mx
    dy = newpos[1] - my
    d2 = dx * dx + dy * dy
    nrm = torch.sqrt(d2)
    inv = torch.where(nrm > 0.0, 1.0 / torch.where(nrm > 0.0, nrm, 1.0), 0.0)
    hit = (m_active > 0.0) & (d2 < mouse_r * mouse_r)
    v[0] = v[0] + torch.where(hit, dx * inv, 0.0)
    v[1] = v[1] + torch.where(hit, dy * inv, 0.0)

    for d in range(D):
        off = x_shift if d == 0 else 0.0
        lo = params[10 + d] + off
        hi = params[10 + D + d] + off
        p_cl = torch.minimum(torch.maximum(newpos[d], lo), hi)
        nxt = p_cl + v[d]
        wmin = lo + damp
        wmax = hi - damp
        vv = v[d] + torch.where(nxt < wmin, wmin - nxt, 0.0)
        vv = vv + torch.where(nxt > wmax, wmax - nxt, 0.0)
        newpos[d] = p_cl
        v[d] = vv


def deposit_p2g1_plain(count, tid, stream, g: TileGeom, occupied=None, out=None) -> torch.Tensor:
    A, D = count.shape[0], g.dim
    a_idx, s_idx = _valid_slots(count, g.cap)
    pos = stream[a_idx, 0:D, s_idx]
    vel = stream[a_idx, D:2 * D, s_idx]
    C = stream[a_idx, 2 * D:2 * D + D * D, s_idx].reshape(-1, D, D)
    mass = stream[a_idx, 2 * D + D * D, s_idx]
    d1 = _p2g1_windows(a_idx, pos, vel, C, mass, tid.long()[a_idx], A, g)
    return _undefined_past(d1, occupied, out)


def deposit_p2g2_plain(count, tid, stream, hs_m, params, d1, g: TileGeom,
                       occupied=None) -> torch.Tensor:
    A, D = count.shape[0], g.dim
    a_idx, s_idx = _valid_slots(count, g.cap)
    pos = stream[a_idx, 0:D, s_idx]
    C = stream[a_idx, 2 * D:2 * D + D * D, s_idx].reshape(-1, D, D)
    mass = stream[a_idx, 2 * D + D * D, s_idx]
    base, dvec, ws = _stencil(pos, tid.long()[a_idx], g)
    w, e, dpos = _taps(base, dvec, ws, g)
    rho = _tap_sum(w, hs_m.reshape(A, g.ncell)[a_idx[:, None], e])
    dt, rest, k_eos, gamma, floor_p, mu = params.unbind()
    volume = torch.where(rho > 0.0, mass / torch.where(rho > 0.0, rho, 1.0), 0.0)
    pressure = _pressure(rho, rest, k_eos, gamma, floor_p)
    scale = (-4.0 * dt) * volume
    cols = []
    for i in range(D):
        term = []
        for j in range(D):
            visc = mu * (C[:, i, j] + C[:, j, i])
            term.append(scale * (-pressure + visc if i == j else visc))
        f = term[0][:, None] * dpos[..., 0]
        for j in range(1, D):
            f = f + term[j][:, None] * dpos[..., j]
        cols.append(w * f)
    out = _scatter_windows(a_idx, e, torch.stack(cols, dim=-1), A, g) + d1[:, 1:]
    return _undefined_past(torch.where((count > 0)[:, None, None], out, 0.0), occupied)


def collect_plain(count, tid, params, stream, gblk, g: TileGeom, out=None, occupied=None):
    A, D, cap = count.shape[0], g.dim, g.cap
    a_idx, s_idx = _valid_slots(count, cap)
    tid_v = tid.long()[a_idx]
    pos = stream[a_idx, 0:D, s_idx]
    mass = stream[a_idx, 2 * D + D * D, s_idx]
    pid = stream[a_idx, 2 * D + D * D + 1, s_idx]
    base, dvec, ws = _stencil(pos, tid_v, g)
    w, e, dpos = _taps(base, dvec, ws, g)
    gw = gblk.reshape(A, 1 + D, g.ncell)
    gv = [gw[a_idx[:, None], i, e] for i in range(D)]
    zero = torch.zeros_like(w[:, 0])
    v = [zero] * D
    B = [[zero] * D for _ in range(D)]
    for k in range(w.shape[1]):
        for i in range(D):
            wv = w[:, k] * gv[i][:, k]
            v[i] = v[i] + wv
            for j in range(D):
                B[i][j] = B[i][j] + wv * dpos[:, k, j]
    rho = _tap_sum(w, gw[a_idx[:, None], D, e])
    newC = [4.0 * B[i][j] for i in range(D) for j in range(D)]

    dt = params[0]
    pressure = _pressure(rho, *params[1:5])
    newpos = [pos[:, d] + v[d] * dt for d in range(D)]
    _particle_tail(newpos, v, params, 0.0)

    bad = torch.zeros_like(rho, dtype=torch.bool)
    corner = _tile_corner(tid_v, g)
    for d in range(D):
        lcn = torch.floor(newpos[d]).to(torch.int64) - corner[:, d]
        bad = bad | (lcn < 1 - g.halo) | (lcn > g.tile - 2 + g.halo)

    rows = torch.stack(newpos + v + newC + [mass, pid, rho, pressure], dim=-1)
    if out is None:
        out = (torch.zeros_like(stream),
               torch.zeros((A, cap), dtype=torch.float32, device=stream.device))
    stream_out, flag = out
    stream_out[a_idx, :, s_idx] = rows
    flag[a_idx, s_idx] = torch.where(bad, 2.0, 0.0)
    pos_n = torch.stack(newpos, dim=-1)
    vel_n = torch.stack(v, dim=-1)
    C_n = torch.stack(newC, dim=-1).reshape(-1, D, D)
    dep = _p2g1_windows(a_idx, pos_n, vel_n, C_n, mass, tid_v, A, g)
    return stream_out, flag, _undefined_past(dep, occupied)


def halo_axis_plain(x, nbp, nbm, g: TileGeom, axis: int) -> torch.Tensor:
    """One separable overlap-add pass (``halo_pull``'s math for one axis)."""
    E, T = g.E, g.tile
    lstride = E ** (g.dim - 1 - axis)
    shift = T * lstride
    e_d = (torch.arange(g.ncell, device=x.device) // lstride) % E
    xp = torch.cat([x, torch.zeros_like(x[:1])], dim=0)
    yp = xp[nbp.long()]
    ys = torch.zeros_like(x)
    ys[..., shift:] = yp[..., :-shift]
    acc = x + torch.where(e_d >= T, ys, 0.0)
    ym = xp[nbm.long()]
    ys = torch.zeros_like(x)
    ys[..., :-shift] = ym[..., shift:]
    return acc + torch.where(e_d < E - T, ys, 0.0)


def halo_axes_plain(x, count, nbr, g: TileGeom, gate=None, occupied=None) -> torch.Tensor:
    """The D passes of the separable halo, one after the other, on the
    occupancy-gated input ``where(gate > 0, x, 0)`` (``gate`` defaults to
    ``count``)."""
    gate = count if gate is None else gate
    x = torch.where((gate > 0)[:, None, None], x, 0.0)
    for d in range(g.dim):
        x = halo_axis_plain(x, nbr[2 * d], nbr[2 * d + 1], g, d)
    return _undefined_past(x, occupied)


def halo_gblk_plain(x, hs_m, count, nbr, dtg, g: TileGeom, gate=None,
                    occupied=None) -> torch.Tensor:
    """All D passes of the m+f halo on the gated input, then the grid
    update: v = mf/m + dt g where m > 0 else 0, then m; zeros at tiles whose
    gate (default: count) is 0."""
    gate = count if gate is None else gate
    mf = halo_axes_plain(x, gate, nbr, g)
    dtg = torch.as_tensor(dtg, dtype=torch.float32, device=x.device)
    v = torch.where(
        hs_m > 0.0, mf / torch.where(hs_m > 0.0, hs_m, 1.0) + dtg[None, :, None], 0.0
    )
    out = torch.where((gate > 0)[:, None, None], torch.cat([v, hs_m], dim=1), 0.0)
    return _undefined_past(out, occupied)


def tile_keys(pos, g: TileGeom, vel=None, step: float = 0.0, xoff=None) -> torch.Tensor:
    """Tile key per particle (int64).  With ``vel`` and a look-ahead
    ``step`` (in time), bins PREDICTIVELY by ``pos + clip(step vel, +-1
    cell)`` on each axis where that keeps the current cell in the chosen
    tile's drift window (``fluid_tpu`` ``_keys_from_pos``).  Packed scenes:
    ``xoff`` [n] int64 is each particle's scene offset ``k * sx``, added to
    its x cell, which is clipped to its scene's columns."""
    dev = pos.device
    shape = device_const([g.sx] + [t * g.tile for t in g.tshape[1:]], dev)
    origin = device_const(g.origin, dev)

    def _cell(x):
        c = torch.minimum((torch.floor(x).to(torch.int64) - origin).clamp_min(0), shape - 1)
        if xoff is not None:
            c[..., 0] += xoff
        return c

    T, h = g.tile, g.halo
    cell = _cell(pos)
    kt = cell // T
    if vel is not None and step != 0.0:
        ct = _cell(pos + torch.clamp(vel * step, -1.0, 1.0)) // T
        lc = cell - ct * T
        kt = torch.where((lc >= 1 - h) & (lc <= T - 2 + h), ct, kt)
    key = kt[..., 0]
    for d in range(1, g.dim):
        key = key * g.tshape[d] + kt[..., d]
    return key


def rebin_gather_plain(stream, count, n: int, g: TileGeom, step: float, tid=None):
    A, F, cap = stream.shape
    a_idx, s_idx = _valid_slots(count, cap)
    live = stream[a_idx, :, s_idx][:n]
    m, D = live.shape[0], g.dim
    rows = torch.zeros((n, F), dtype=torch.float32, device=stream.device)
    rows[:m] = live
    keys = torch.full((n,), math.prod(g.tshape), dtype=torch.int32, device=stream.device)
    xoff = None
    if g.scene_cells:
        t = tid.long()[a_idx[:m]]
        xoff = _scene_offset((t // math.prod(g.tshape[1:])) % g.tshape[0] * g.tile, g)
    keys[:m] = tile_keys(live[:, :D], g, live[:, D:2 * D], step, xoff).to(torch.int32)
    return rows, keys


def rebin_fill_plain(rows, order, start, count, stream, flag) -> None:
    A, F, cap = stream.shape
    s_io = torch.arange(cap, device=stream.device)
    valid = s_io[None, :] < count[:, None]
    bidx = (start[:, None] + s_io[None, :]).clamp(0, order.shape[0] - 1)
    stream.copy_(torch.where(valid[..., None], rows[order[bidx]], 0.0).permute(0, 2, 1))
    flag.zero_()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _on_cpu(device: torch.device) -> bool:
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"the kernels run on cuda (or plain on cpu), not {device}")
    return False


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _ints(vals):
    """A host int[3] (tile shape or origin) as a pointer argument."""
    arr = (ctypes.c_int * 3)(*(list(vals) + [0] * (3 - len(vals))))
    return ctypes.cast(arr, ctypes.c_void_p)


def _launch(name: str, fn, *args, lib: cuda_build.Library = LIBRARY,
            counts: Optional[dict] = LAUNCHES, what: str = "") -> None:
    """Call entry point ``fn`` of ``lib`` on the current stream; raise on its
    error code (naming ``what``, the instantiation asked for, where given),
    else add one to ``counts[name]``.  ``lib`` and ``counts`` are this
    module's unless another module's wrapper passes its own (``counts``
    ``None`` counts nothing)."""
    rc = getattr(lib.load(), fn)(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}"
                           + (f" ({what})" if what else ""))
    if counts is not None:
        counts[name] += 1


def check_cap(cap: int) -> None:
    """Raise unless ``cap`` suits the kernels: a positive multiple of 32, as
    a deposit or collect block walks its slots in chunks of whole warps
    (``StreamSpec`` checks it when it is built)."""
    if cap <= 0 or cap % 32:
        raise ValueError(f"cap {cap}: the kernels walk a tile's slots in whole "
                         "warps, so cap must be a positive multiple of 32")


def _check_tiles(count, tid, stream, g: TileGeom, occupied=None):
    A = count.shape[0]
    dev = stream.device
    _check("count", count, (A,), torch.int32, dev)
    if occupied is not None:
        _check("occupied", occupied, (1,), torch.int32, dev)
    _check("tid", tid, (A,), torch.int32, dev)
    _check("stream", stream, (A, g.F, g.cap), torch.float32, dev)
    if dev.type == "cuda":
        check_cap(g.cap)
    return A, dev


def deposit_p2g1(count, tid, stream, g: TileGeom, out=None, occupied=None) -> torch.Tensor:
    """p2g_1 windows [A, 1+D, E^D]: mass and APIC momentum of each tile,
    written into ``out`` where given (the re-bin's in-place deposit); with
    ``occupied``, of the entries below it (see the module's docstring)."""
    A, dev = _check_tiles(count, tid, stream, g, occupied)
    if out is not None:
        _check("out", out, (A, 1 + g.dim, g.ncell), torch.float32, dev)
    if _on_cpu(dev):
        return deposit_p2g1_plain(count, tid, stream, g, occupied, out)
    if out is None:
        out = torch.empty((A, 1 + g.dim, g.ncell), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("deposit_p2g1", "fluid_deposit", g.dim, 1, _ptr(occupied), _ptr(count),
                _ptr(tid), _ptr(stream), _ptr(None), _ptr(None), _ptr(None), _ptr(out), A,
                g.tile, g.halo, g.cap, _ints(g.tshape), _ints(g.origin), g.sx)
    return out


def deposit_p2g2(count, tid, stream, hs_m, params, d1, g: TileGeom,
                 occupied=None) -> torch.Tensor:
    """Combined momentum + eq-16 force windows [A, D, E^D] (density from the
    halo'd mass windows ``hs_m`` [A, 1, E^D], p2g1 momentum from ``d1``).
    params: [dt, rest_density, eos_stiffness, eos_power, floor, mu]."""
    A, dev = _check_tiles(count, tid, stream, g, occupied)
    _check("hs_m", hs_m, (A, 1, g.ncell), torch.float32, dev)
    _check("d1", d1, (A, 1 + g.dim, g.ncell), torch.float32, dev)
    _check("params", params, (6,), torch.float32, dev)
    if _on_cpu(dev):
        return deposit_p2g2_plain(count, tid, stream, hs_m, params, d1, g, occupied)
    out = torch.empty((A, g.dim, g.ncell), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("deposit_p2g2", "fluid_deposit", g.dim, 2, _ptr(occupied), _ptr(count),
                _ptr(tid), _ptr(stream), _ptr(hs_m), _ptr(d1), _ptr(params), _ptr(out), A,
                g.tile, g.halo, g.cap, _ints(g.tshape), _ints(g.origin), g.sx)
    return out


def collect(count, tid, params, stream, gblk, g: TileGeom, out=None, occupied=None):
    """g2p + particle tail -> (next stream [A, F, cap], flag [A, cap], the
    next substep's p2g1 windows [A, 1+D, E^D]).
    params: see ``stream_transfer.collect_params``.

    With ``out`` = (stream', flag'), the live slots' new rows and flags are
    written there and every other slot is left as it is: ``out`` may be
    ``(stream, flag)``, the state updated in place, whose slots past the
    count hold zeros.  Without it the result is new buffers, zeros past the
    count.  With ``occupied``, the p2g1 windows are those of the entries
    below it."""
    A, dev = _check_tiles(count, tid, stream, g, occupied)
    _check("gblk", gblk, (A, 1 + g.dim, g.ncell), torch.float32, dev)
    _check("params", params, (10 + 2 * g.dim,), torch.float32, dev)
    if out is not None:
        _check("out stream", out[0], stream.shape, torch.float32, dev)
        _check("out flag", out[1], (A, g.cap), torch.float32, dev)
    if _on_cpu(dev):
        return collect_plain(count, tid, params, stream, gblk, g, out, occupied)
    if out is None:
        out = (torch.zeros_like(stream),
               torch.zeros((A, g.cap), dtype=torch.float32, device=dev))
    out_s, flag = out
    dep = torch.empty((A, 1 + g.dim, g.ncell), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("collect", "fluid_collect", g.dim, _ptr(occupied), _ptr(count), _ptr(tid),
                _ptr(params), _ptr(stream), _ptr(gblk), _ptr(out_s), _ptr(flag), _ptr(dep), A,
                g.tile, g.halo, g.cap, _ints(g.tshape), _ints(g.origin), g.sx)
    return out_s, flag, dep


def halo_axes(x, count, nbr, g: TileGeom, gate=None, occupied=None) -> torch.Tensor:
    """The D halo passes over windows [A, CH, E^D] in one launch, the
    input read as ``where(gate > 0, x, 0)``; ``nbr`` [2D, A] holds the
    active indices of each axis's +/- face neighbours (A = none).  ``gate``
    [A] int32 defaults to ``count``; the sharded backend passes count plus
    its ghost columns, whose windows the exchange fills.  Returns a new
    tensor, bit-equal to the passes chained (``halo_axes_plain``)."""
    A, CH = x.shape[0], x.shape[1]
    dev = x.device
    gate = count if gate is None else gate
    _check("x", x, (A, CH, g.ncell), torch.float32, dev)
    _check("gate", gate, (A,), torch.int32, dev)
    _check("nbr", nbr, (2 * g.dim, A), torch.int32, dev)
    if occupied is not None:
        _check("occupied", occupied, (1,), torch.int32, dev)
    if _on_cpu(dev):
        return halo_axes_plain(x, gate, nbr, g, occupied=occupied)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        # the kernel reads its count argument only as this gate
        _launch("halo_axis", "fluid_halo_axes", _ptr(x), _ptr(occupied), _ptr(gate), _ptr(nbr),
                _ptr(out), A, CH, g.dim, g.E, g.tile)
    return out


def gravity_step(dt: float, gravity) -> np.ndarray:
    """dt * g in float32, as the grid update adds it."""
    return np.float32(dt) * np.asarray(gravity, np.float32)


def halo_gblk(x, hs_m, count, nbr, dtg: np.ndarray, g: TileGeom, gate=None,
              occupied=None) -> torch.Tensor:
    """The whole momentum+force halo (the D passes over the gated m+f
    windows ``x`` [A, D, E^D]) and the grid update, in one launch: grid
    values [A, 1+D, E^D] = (mf/m + dt g where m > 0 else 0, then m), with
    the halo'd masses ``hs_m`` [A, 1, E^D]; zeros at tiles whose gate
    (default: count, see ``halo_axes``) is 0, which read nothing."""
    A = x.shape[0]
    dev = x.device
    gate = count if gate is None else gate
    _check("x", x, (A, g.dim, g.ncell), torch.float32, dev)
    _check("hs_m", hs_m, (A, 1, g.ncell), torch.float32, dev)
    _check("gate", gate, (A,), torch.int32, dev)
    _check("nbr", nbr, (2 * g.dim, A), torch.int32, dev)
    if occupied is not None:
        _check("occupied", occupied, (1,), torch.int32, dev)
    if _on_cpu(dev):
        return halo_gblk_plain(x, hs_m, gate, nbr, dtg, g, occupied=occupied)
    out = torch.empty((A, 1 + g.dim, g.ncell), dtype=torch.float32, device=dev)
    d = [float(v) for v in dtg] + [0.0] * (3 - g.dim)
    with torch.cuda.device(dev):
        _launch("halo_gblk", "fluid_halo_gblk", _ptr(x), _ptr(hs_m), _ptr(occupied), _ptr(gate),
                _ptr(nbr), _ptr(out), A, g.dim, g.E, g.tile, d[0], d[1], d[2])
    return out


def rebin_gather(stream, count, n: int, g: TileGeom, step: float, tid=None):
    """The re-bin's compaction: the live slots of ``stream`` [A, F, cap]
    (``count`` [A] of each tile) as rows [n, F] in slot order, and each
    row's tile key [n] int32 (``tile_keys`` with the look-ahead ``step``;
    0 keys by position alone).  Rows past the live count are zeros with the
    key ``nt``, of no tile; live rows past ``n`` are dropped.  Packed scenes
    (``g.scene_cells``) key a row in its tile's scene, from ``tid`` [A]."""
    A, dev = count.shape[0], stream.device
    _check("count", count, (A,), torch.int32, dev)
    _check("stream", stream, (A, g.F, g.cap), torch.float32, dev)
    if n < 1:
        raise ValueError(f"rebin_gather: n={n} rows, expected at least 1")
    if g.scene_cells:
        if tid is None:
            raise ValueError("rebin_gather: packed scenes key by the tiles' ids, tid is needed")
        _check("tid", tid, (A,), torch.int32, dev)
    if _on_cpu(dev):
        return rebin_gather_plain(stream, count, n, g, step, tid)
    check_cap(g.cap)
    rows = torch.empty((n, g.F), dtype=torch.float32, device=dev)
    keys = torch.empty((n,), dtype=torch.int32, device=dev)
    cum = torch.cumsum(count, 0, dtype=torch.int32)
    with torch.cuda.device(dev):
        _launch("rebin_gather", "fluid_rebin_gather", g.dim, _ptr(stream), _ptr(count), _ptr(cum),
                _ptr(tid if g.scene_cells else None), _ptr(rows), _ptr(keys), A, g.cap, n,
                g.tile, g.halo, _ints(g.tshape), _ints(g.origin), g.sx, int(step != 0.0), step)
    return rows, keys


def rebin_fill(rows, order, start, count, stream, flag) -> None:
    """The re-bin's slot structure, written into ``stream`` [A, F, cap] and
    ``flag`` [A, cap]: slot s < count[a] of tile a gets row
    ``order[start[a] + s]`` of ``rows`` [N, F], every other slot 0, and
    the flag is zeroed.  ``order`` [n] and ``start`` [A] are int64 (an
    argsort and the tiles' first sorted ranks), ``count`` [A] int32."""
    A, F, cap = stream.shape
    dev = stream.device
    _check("stream", stream, (A, F, cap), torch.float32, dev)
    _check("rows", rows, (rows.shape[0], F), torch.float32, dev)
    _check("order", order, (order.shape[0],), torch.int64, dev)
    _check("start", start, (A,), torch.int64, dev)
    _check("count", count, (A,), torch.int32, dev)
    _check("flag", flag, (A, cap), torch.float32, dev)
    if order.shape[0] < 1:
        raise ValueError("rebin_fill: an empty order")
    if _on_cpu(dev):
        return rebin_fill_plain(rows, order, start, count, stream, flag)
    check_cap(cap)
    dim = {2 * d + d * d + 4: d for d in (2, 3)}.get(F)
    if dim is None:
        raise ValueError(f"rebin_fill: {F} stream rows, a 2D (12) or 3D (19) particle's expected")
    with torch.cuda.device(dev):
        _launch("rebin_fill", "fluid_rebin_fill", dim, _ptr(rows), _ptr(order), _ptr(start),
                _ptr(count), _ptr(stream), _ptr(flag), A, cap, order.shape[0])
