"""The sum order that the pallas deposits K6, K6f and K7 keep.

``csrc/pallas_kernels.cu`` forms one value per particle and covered cell
and adds a tile's particles into each cell in slot order, starting from
0.0f, one chunk of slots after the other.  On the CPU the wrappers run the
plain versions (``pk.deposit_plain``, ``pk.p2g2_plain``), which the card's
check compares the kernels with.  Here those plain versions must equal,
bit for bit, a direct loop that forms each value as the kernel does and
adds the particles to the cells one after the other in slot order.

The tiles are made with numpy from a seed: a domain origin off zero,
particles up to 0.9 cells outside their tile (the clipped stencil base),
one tile past the kernel's chunk of 128 slots, one past the cap (only the
first cap slots deposit), empty tiles and an unused entry (act_start = n).
"""

import itertools
import math

import numpy as np
import pytest
import torch

from fluid_tpu_torch.config import default_2d, default_3d
from fluid_tpu_torch.ops import pallas_kernels as pk
from fluid_tpu_torch.ops import stream_kernels as sk

torch.set_num_threads(1)

T, CAP, CHUNK = 4, 192, 128  # CHUNK: DEPOSIT_CHUNK of the kernel
F = np.float32
TSHAPE = {2: (3, 4), 3: (2, 3, 2)}
ORIGIN = {2: (-4, 0), 3: (0, -4, 4)}


def _tiles(dim, seed=0):
    """Per tile its count (one past CHUNK, one past CAP, some empty), the
    tile-sorted particle positions, act_start / act_count / tid with an
    unused entry last, and the geometry."""
    rng = np.random.default_rng(seed)
    nt = math.prod(TSHAPE[dim])
    counts = rng.integers(1, 40, nt)
    counts[[1, nt - 2]] = 0
    counts[0], counts[nt - 1] = CHUNK + 37, CAP + 50
    pos = []
    for t, c in enumerate(counts):
        coord = np.array(np.unravel_index(t, TSHAPE[dim]))
        lo = np.array(ORIGIN[dim]) + coord * T
        pos.append(rng.uniform(lo - 0.9, lo + T + 0.9, (c, dim)))
    n = int(counts.sum())
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    act_start = np.append(start, n).astype(np.int32)
    act_count = np.append(counts, 0).astype(np.int32)
    tid = np.append(np.arange(nt), nt - 1).astype(np.int32)
    g = sk.TileGeom(dim=dim, tile=T, halo=1, cap=CAP, tshape=TSHAPE[dim], origin=ORIGIN[dim])
    return rng, np.concatenate(pos).astype(F), act_start, act_count, tid, g


def _stencils(pos, tile_of, g):
    """Per particle the flat window cell of each tap [n, 3^D] (taps in flat
    cell order, axis D-1 fastest), the tap weights w [n, 3^D] (the per-axis
    weights multiplied in axis order), the moment weights wd [n, 3^D, D]
    (-w, 0 or w for offsets 0, 1, 2) and dvec [n, D]."""
    D, E = g.dim, g.E
    cf = np.floor(pos)
    coord = np.stack(np.unravel_index(tile_of, g.tshape), axis=1)
    base = np.clip(cf.astype(np.int64) - (np.array(g.origin) + coord * T), 0, T - 1)
    dv = (pos - cf) - F(0.5)
    ws = np.stack([F(0.5) * (F(0.5) - dv) * (F(0.5) - dv), F(0.75) - dv * dv,
                   F(0.5) * (F(0.5) + dv) * (F(0.5) + dv)], axis=1)  # [n, 3, D]
    offs = np.array(list(itertools.product(range(3), repeat=D)))
    w = ws[:, offs[:, 0], 0]
    for d in range(1, D):
        w = w * ws[:, offs[:, d], d]
    e = base[:, None, 0] + offs[None, :, 0]
    for d in range(1, D):
        e = e * E + (base[:, None, d] + offs[None, :, d])
    wd = np.stack([np.where(offs[None, :, d] == 0, -w, np.where(offs[None, :, d] == 2, w, F(0.0)))
                   for d in range(D)], axis=-1)
    return e, w, wd, dv


def _values(w, wd, g0, gd):
    """[n, 3^D, CH]: w g0[c], and for the last D channels + wd_d gd[d][i]
    for d = 0 .. D-1 in turn (the zero terms added too)."""
    D, CH = gd.shape[1], g0.shape[1]
    vals = []
    for c in range(CH):
        val = w * g0[:, None, c]
        if c >= CH - D:
            for d in range(D):
                val = val + wd[..., d] * gd[:, None, d, c - (CH - D)]
        vals.append(val)
    return np.stack(vals, axis=-1)


def _slot_order_sum(vals, e, act_start, act_count, g):
    """Every tile's block from 0.0, its particles added in slot order."""
    A, CH = act_count.shape[0], vals.shape[-1]
    out = np.zeros((A, g.ncell, CH), F)
    for a in range(A):
        for j in range(act_start[a], act_start[a] + min(act_count[a], g.cap)):
            out[a, e[j]] = out[a, e[j]] + vals[j]  # one particle's taps: distinct cells
    return out


def _p2g2_values(stream, mblocks, act_start, act_count, tile_of, params, g):
    """Per particle the force channels of K7: the density gathered from the
    tile's mass block (taps in flat cell order), the Tait pressure, the
    volume, the eq-16 term and A2 = term (-dvec)."""
    D = g.dim
    n = stream.shape[1]
    pos, C, m = stream[:D].T, stream[2 * D:2 * D + D * D].T.reshape(n, D, D), stream[-1]
    e, w, wd, dv = _stencils(pos, tile_of, g)
    owner = np.repeat(np.arange(act_count.shape[0]), act_count)
    mw = mblocks[owner, :, 0]
    rho = np.zeros(n, F)
    for k in range(w.shape[1]):
        rho = rho + w[:, k] * mw[np.arange(n), e[:, k]]
    dt, rest, k_eos, gamma, floor_p, mu = (params[i] for i in range(6))
    # the pressure through torch's pow, on the valid slots as one row, as the
    # plain version evaluates it (the kernel: powf)
    valid = np.concatenate([np.arange(s, s + min(c, g.cap)) for s, c in zip(act_start, act_count)])
    p_t = torch.clamp_min(k_eos * (torch.pow(torch.from_numpy(rho[valid]) / rest, gamma) - 1.0),
                          floor_p)
    pressure = np.zeros(n, F)
    pressure[valid] = p_t.numpy()
    volume = np.where(rho > 0, m / np.where(rho > 0, rho, F(1.0)), F(0.0))
    scale = (F(-4.0) * volume) * F(dt)
    term = np.empty((n, D, D), F)
    for i in range(D):
        for j in range(D):
            visc = F(mu) * (C[:, i, j] + C[:, j, i])
            term[:, i, j] = scale * ((-pressure if i == j else F(0.0)) + visc)
    a2 = np.empty((n, D), F)
    for i in range(D):
        acc = term[:, i, 0] * (-dv[:, 0])
        for j in range(1, D):
            acc = acc + term[:, i, j] * (-dv[:, j])
        a2[:, i] = acc
    return e, _values(w, wd, a2, term.transpose(0, 2, 1))  # gd[d][i] = term[i][d]


def _bits_equal(got: torch.Tensor, want: np.ndarray) -> bool:
    return np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["p2g1", "force", "p2g2"])
def test_plain_deposit_sums_in_slot_order(dim, mode):
    rng, pos, act_start, act_count, tid, g = _tiles(dim, seed=dim)
    n, D = pos.shape[0], dim
    assert act_count.max() > g.cap > CHUNK and (act_count > CHUNK).sum() >= 2
    tile_of = np.repeat(tid[:-1], act_count[:-1])
    ts = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    tiles = (ts(act_start), ts(act_count), ts(tid))
    if mode == "p2g1":
        vel = rng.normal(0.0, 0.4, (n, D)).astype(F)
        C = rng.normal(0.0, 0.3, (n, D, D)).astype(F)
        m = rng.uniform(0.5, 1.5, n).astype(F)
        stream = np.concatenate([pos, vel, C.reshape(n, D * D), m[:, None]], axis=1).T
        e, w, wd, dv = _stencils(pos, tile_of, g)
        g0 = [m]
        for i in range(D):
            cd = C[:, i, 0] * dv[:, 0]
            for j in range(1, D):
                cd = cd + C[:, i, j] * dv[:, j]
            g0.append(m * (vel[:, i] - cd))
        vals = _values(w, wd, np.stack(g0, axis=1), m[:, None, None] * C.transpose(0, 2, 1))
        got = pk.deposit(ts(stream), *tiles, g, mode="p2g1")
    elif mode == "force":
        rows = rng.normal(0.0, 1.0, (n, D + D * D)).astype(F)
        stream = np.concatenate([rows, pos], axis=1).T
        e, w, wd, _ = _stencils(pos, tile_of, g)
        gd = rows[:, D:].reshape(n, D, D)  # row D + d*D + i = term[i][d]
        vals = _values(w, wd, rows[:, :D], gd)
        got = pk.deposit(ts(stream), *tiles, g, mode="force")
    else:
        cfg = default_2d() if dim == 2 else default_3d()
        params = np.array([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                           cfg.pressure_floor, cfg.dynamic_viscosity], F)
        vel = rng.normal(0.0, 0.4, (n, D)).astype(F)
        C = rng.normal(0.0, 0.3, (n, D, D)).astype(F)
        stream = np.concatenate([pos, vel, C.reshape(n, D * D), np.ones((n, 1), F)], axis=1).T
        mblocks = rng.uniform(0.0, 2.0 * cfg.rest_density, (act_count.shape[0], g.ncell, 1))
        mblocks = np.where(mblocks < 0.2 * cfg.rest_density, 0.0, mblocks).astype(F)
        e, vals = _p2g2_values(stream, mblocks, act_start, act_count, tile_of, params, g)
        got = pk.p2g2(ts(stream), ts(mblocks), *tiles, ts(params), g)
    want = _slot_order_sum(vals, e, act_start, act_count, g)
    assert np.abs(want).max() > 0.1 and not want[-1].any()  # real deposits; the unused entry zero
    assert _bits_equal(got, want), f"max |diff| {np.abs(got.numpy() - want).max()}"
