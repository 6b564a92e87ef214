"""The "pallas" backend's kernel entry points: wrapper, plain version, count.

Each of ``deposit`` (modes "p2g1" and "force"), ``p2g2`` and ``collect`` is a
wrapper that checks its tensors and then

* for CPU tensors, runs the plain PyTorch version below (direct 3^D taps,
  ``index_add_`` for the deposits) — the CPU tests' path, and what
  ``chip_smoke.py`` holds the kernels against on the card;
* for CUDA tensors, launches the hand-written kernel of
  ``csrc/pallas_kernels.cu`` and raises if the launch reports an error.
  There is no fallback from a CUDA tensor to the plain version.

``LAUNCHES[name]`` counts the kernel launches of each wrapper (never the
plain versions), so a run can show that its main path went through every
kernel.

The plain versions compute in the kernels' arithmetic order (a particle's
contribution to a cell formed as one value, particles in slot order, taps in
flat cell order), so on the CPU they give what the kernels compute, and on
the card the two differ only where ``index_add_`` sums in another order.

Layouts (see ``csrc/pallas_kernels.cu``): stream ``[FP, n]`` field-major in
tile-sorted order, blocks ``[A, E^D, CH]``, slots ``[A, FO, cap]``,
act_start / act_count / tid ``[A]`` int32.  Geometry is a ``TileGeom`` with
``halo=1`` (E = T + 2).
"""

from __future__ import annotations

import itertools

import torch

from . import cuda_build
from .bspline import quadratic_weights
from .stream_kernels import (TileGeom, _check, _ints, _launch, _on_cpu, _particle_tail,
                             _pressure, _ptr, _tap_sum, _valid_slots)
from .tiled_transfer import _unflatten

KERNELS = ("pallas_deposit_p2g1", "pallas_deposit_force", "pallas_p2g2", "pallas_collect")
LAUNCHES = {name: 0 for name in KERNELS}
LIBRARY = cuda_build.Library("pallas", ("pallas_kernels.cu",))
_MODES = {"p2g1": 1, "force": 2}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def stream_rows(dim: int, mode: str = "p2g1") -> int:
    """FP: pos, vel, C, mass (p2g1) or A2, term, pos (force)."""
    return 2 * dim + dim * dim + (1 if mode == "p2g1" else 0)


def slot_rows(dim: int) -> int:
    """FO: pos, vel, C, rho, pressure, mass."""
    return 2 * dim + dim * dim + 3


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _slots(act_start, act_count, cap: int):
    """(tile, slot, stream column) of every slot below min(count, cap)."""
    a_idx, s_idx = _valid_slots(act_count, cap)
    return a_idx, s_idx, act_start.long()[a_idx] + s_idx


def _taps(pos, tid, g: TileGeom):
    """Stencil of particles at ``pos`` [V, D] in tiles ``tid`` [V]: per tap
    in flat cell order (axis D-1 fastest) the weight [V, K], window cell
    [V, K] and moment weights (o_d - 1) w [V, K, D]; and dvec [V, D]."""
    D, T, E = g.dim, g.tile, g.E
    cf = torch.floor(pos)
    org = torch.as_tensor(g.origin, device=pos.device)
    lc = (cf.to(torch.int64) - (org + _unflatten(tid, g.tshape) * T)).clamp(0, T - 1)
    dvec = (pos - cf) - 0.5
    ws = quadratic_weights(dvec)  # [V, 3, D]
    offs = torch.tensor(list(itertools.product(range(3), repeat=D)), device=pos.device)
    w = ws[:, offs[:, 0], 0]
    for d in range(1, D):
        w = w * ws[:, offs[:, d], d]
    e = lc[:, None, 0] + offs[None, :, 0]
    for d in range(1, D):
        e = e * E + (lc[:, None, d] + offs[None, :, d])
    sign = (offs - 1).to(torch.float32)  # exact: -1, 0 or 1
    wd = torch.where(sign[None] == 0, 0.0, sign[None] * w[..., None])
    return w, e, wd, dvec


def _deposit_window(a_idx, e, w, wd, g0, gd, A: int, g: TileGeom) -> torch.Tensor:
    """Blocks [A, E^D, CH] from per-particle channel values g0 [V, CH] and
    moment values gd [V, D(d), D(i)] (the last D channels):
    val = w g0 + sum_d (o_d - 1) w gd[d], summed into cells in slot order."""
    D, CH = g.dim, g0.shape[1]
    vals = []
    for c in range(CH):
        val = w * g0[:, c, None]
        if c >= CH - D:
            i = c - (CH - D)
            for d in range(D):
                val = val + wd[..., d] * gd[:, d, i, None]
        vals.append(val)
    out = torch.zeros((A * g.ncell, CH), dtype=torch.float32, device=w.device)
    out.index_add_(0, (a_idx[:, None] * g.ncell + e).reshape(-1),
                   torch.stack(vals, dim=-1).reshape(-1, CH))
    return out.reshape(A, g.ncell, CH)


def deposit_plain(stream, act_start, act_count, tile_id, g: TileGeom, mode: str = "p2g1"):
    A, D = act_count.shape[0], g.dim
    a_idx, _, col = _slots(act_start, act_count, g.cap)
    rows = stream[:, col].t()  # [V, FP]
    tid = tile_id.long()[a_idx]
    if mode == "p2g1":
        pos, vel = rows[:, 0:D], rows[:, D:2 * D]
        C = rows[:, 2 * D:2 * D + D * D].reshape(-1, D, D)
        m = rows[:, 2 * D + D * D]
        w, e, wd, dvec = _taps(pos, tid, g)
        cols = [m]
        for i in range(D):
            cd = C[:, i, 0] * dvec[:, 0]
            for j in range(1, D):
                cd = cd + C[:, i, j] * dvec[:, j]
            cols.append(m * (vel[:, i] - cd))
        g0 = torch.stack(cols, dim=1)
        gd = (m[:, None, None] * C).transpose(1, 2)  # gd[d][i] = m C[i][d]
    else:
        pos = rows[:, D + D * D:2 * D + D * D]
        w, e, wd, _ = _taps(pos, tid, g)
        g0 = rows[:, 0:D]
        gd = rows[:, D:D + D * D].reshape(-1, D, D)  # row D + d*D + i = term[i][d]
    return _deposit_window(a_idx, e, w, wd, g0, gd, A, g)


def _p2g2_terms(stream, mblocks, act_start, act_count, tile_id, params, g: TileGeom):
    """Per valid slot: density from the mass block, Tait pressure, the
    eq-16 term -4 V dt (-p I + mu (C + C^T)) and A2 = term (-dvec).
    Returns the slots, their stencil, and (A2 [V, D], term [V, D, D])."""
    A, D = act_count.shape[0], g.dim
    a_idx, _, col = _slots(act_start, act_count, g.cap)
    rows = stream[:, col].t()
    C = rows[:, 2 * D:2 * D + D * D].reshape(-1, D, D)
    m = rows[:, 2 * D + D * D]
    w, e, wd, dvec = _taps(rows[:, 0:D], tile_id.long()[a_idx], g)
    rho = _tap_sum(w, mblocks.reshape(A, g.ncell)[a_idx[:, None], e])
    dt, mu = params[0], params[5]
    volume = torch.where(rho > 0.0, m / torch.where(rho > 0.0, rho, 1.0), 0.0)
    pressure = _pressure(rho, *params[1:5])
    scale = (-4.0 * volume) * dt
    term = [[scale * ((-pressure if i == j else 0.0) + mu * (C[:, i, j] + C[:, j, i]))
             for j in range(D)] for i in range(D)]
    a2 = []
    for i in range(D):
        acc = term[i][0] * (-dvec[:, 0])
        for j in range(1, D):
            acc = acc + term[i][j] * (-dvec[:, j])
        a2.append(acc)
    term = torch.stack([torch.stack(t, dim=1) for t in term], dim=1)  # [V, i, j]
    return (a_idx, col, rows, e, w, wd), torch.stack(a2, dim=1), term


def p2g2_plain(stream, mblocks, act_start, act_count, tile_id, params, g: TileGeom):
    (a_idx, _, _, e, w, wd), a2, term = _p2g2_terms(
        stream, mblocks, act_start, act_count, tile_id, params, g)
    return _deposit_window(a_idx, e, w, wd, a2, term.transpose(1, 2), act_count.shape[0], g)


def force_stream_plain(stream, mblocks, act_start, act_count, tile_id, params, g: TileGeom):
    """The force stream [2D + D^2, n] that ``p2g2`` deposits from: rows A2
    (D), term (row D + j*D + i = term[i][j]) and pos (D), zero for the
    particles in no slot.  ``deposit(..., mode="force")`` of it gives the
    blocks of ``p2g2``."""
    D = g.dim
    (_, col, rows, _, _, _), a2, term = _p2g2_terms(
        stream, mblocks, act_start, act_count, tile_id, params, g)
    out = stream.new_zeros((stream_rows(D, "force"), stream.shape[1]))
    out[:, col] = torch.cat([a2, term.transpose(1, 2).reshape(-1, D * D), rows[:, 0:D]], dim=1).t()
    return out


def collect_plain(stream, vblocks, mblocks, act_start, act_count, tile_id, params, g: TileGeom):
    A, D, cap = act_count.shape[0], g.dim, g.cap
    a_idx, s_idx, col = _slots(act_start, act_count, cap)
    rows = stream[:, col].t()
    pos = rows[:, 0:D]
    w, e, wd, dvec = _taps(pos, tile_id.long()[a_idx], g)
    rho = _tap_sum(w, mblocks.reshape(A, g.ncell)[a_idx[:, None], e])
    gv = vblocks[a_idx[:, None], e]  # [V, K, D]
    zero = torch.zeros_like(rho)
    v = [zero] * D
    Md = [[zero] * D for _ in range(D)]
    for k in range(w.shape[1]):
        for i in range(D):
            v[i] = v[i] + w[:, k] * gv[:, k, i]
            for j in range(D):
                Md[j][i] = Md[j][i] + wd[:, k, j] * gv[:, k, i]
    dt = params[0]
    newpos = [pos[:, d] + v[d] * dt for d in range(D)]
    pressure = _pressure(rho, *params[1:5])
    newC = [4.0 * (v[i] * (-dvec[:, j]) + Md[j][i]) for i in range(D) for j in range(D)]
    _particle_tail(newpos, v, params, 0.0)

    vals = torch.stack(newpos + v + newC + [rho, pressure, rows[:, 2 * D + D * D]], dim=-1)
    out = torch.zeros((A, slot_rows(D), cap), dtype=torch.float32, device=stream.device)
    out[a_idx, :, s_idx] = vals
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_tiles(stream, act_start, act_count, tile_id, fp: int):
    A = act_count.shape[0]
    dev = stream.device
    if stream.dim() != 2:
        raise ValueError(f"stream: shape {tuple(stream.shape)}, expected [{fp}, n]")
    _check("stream", stream, (fp, stream.shape[1]), torch.float32, dev)
    for name, t in (("act_start", act_start), ("act_count", act_count), ("tile_id", tile_id)):
        _check(name, t, (A,), torch.int32, dev)
    return A, dev


def _launch_deposit(name, mode: int, ch: int, stream, mblocks, params,
                    act_start, act_count, tile_id, g: TileGeom, dev) -> torch.Tensor:
    A = act_count.shape[0]
    out = torch.empty((A, g.ncell, ch), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch(name, "fluid_pallas_deposit", g.dim, mode, _ptr(act_start), _ptr(act_count),
                _ptr(tile_id), _ptr(stream), _ptr(mblocks), _ptr(params), _ptr(out), A,
                stream.shape[1], g.tile, g.cap, _ints(g.tshape), _ints(g.origin), lib=LIBRARY,
                counts=LAUNCHES)
    return out


def deposit(stream, act_start, act_count, tile_id, g: TileGeom, mode: str = "p2g1") -> torch.Tensor:
    """Every active tile's block [A, E^D, CH]: mass and APIC momentum
    (mode "p2g1", CH = 1+D, from the particle stream) or the force of a
    precomputed force stream (mode "force", CH = D)."""
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}, expected one of {tuple(_MODES)}")
    _, dev = _check_tiles(stream, act_start, act_count, tile_id, stream_rows(g.dim, mode))
    if _on_cpu(dev):
        return deposit_plain(stream, act_start, act_count, tile_id, g, mode)
    ch = 1 + g.dim if mode == "p2g1" else g.dim
    return _launch_deposit(f"pallas_deposit_{mode}", _MODES[mode], ch, stream, None, None,
                           act_start, act_count, tile_id, g, dev)


def p2g2(stream, mblocks, act_start, act_count, tile_id, params, g: TileGeom) -> torch.Tensor:
    """Fused p2g_2: density from the halo'd, edge-masked mass blocks
    ``mblocks`` [A, E^D, 1], Tait pressure, stress and the force blocks
    [A, E^D, D].  params: [dt, rest_density, eos_stiffness, eos_power,
    pressure_floor, mu]."""
    A, dev = _check_tiles(stream, act_start, act_count, tile_id, stream_rows(g.dim))
    _check("mblocks", mblocks, (A, g.ncell, 1), torch.float32, dev)
    _check("params", params, (6,), torch.float32, dev)
    if _on_cpu(dev):
        return p2g2_plain(stream, mblocks, act_start, act_count, tile_id, params, g)
    return _launch_deposit("pallas_p2g2", 3, g.dim, stream, mblocks, params,
                           act_start, act_count, tile_id, g, dev)


def collect(stream, vblocks, mblocks, act_start, act_count, tile_id, params, g: TileGeom) -> torch.Tensor:
    """g2p + particle tail -> slot-major rows [A, FO, cap] (pos, vel, C,
    rho, pressure, mass; zero past count).  params: [dt, rest_density,
    eos_stiffness, eos_power, pressure_floor, mouse_radius, damp,
    mouse_active, mouse_x, mouse_y, lo(D), hi(D)]."""
    A, dev = _check_tiles(stream, act_start, act_count, tile_id, stream_rows(g.dim))
    _check("vblocks", vblocks, (A, g.ncell, g.dim), torch.float32, dev)
    _check("mblocks", mblocks, (A, g.ncell, 1), torch.float32, dev)
    _check("params", params, (10 + 2 * g.dim,), torch.float32, dev)
    if _on_cpu(dev):
        return collect_plain(stream, vblocks, mblocks, act_start, act_count, tile_id, params, g)
    out = torch.empty((A, slot_rows(g.dim), g.cap), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("pallas_collect", "fluid_pallas_collect", g.dim, _ptr(act_start), _ptr(act_count),
                _ptr(tile_id), _ptr(params), _ptr(stream), _ptr(vblocks), _ptr(mblocks), _ptr(out),
                A, stream.shape[1], g.tile, g.cap, _ints(g.tshape), _ints(g.origin), lib=LIBRARY,
                counts=LAUNCHES)
    return out
