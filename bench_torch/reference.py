"""Plain PyTorch MLS-MPM frame: the yardstick the benchmark's outputs are held to.

Written from the reference's substep (``fluid-rs`` ``src/3d_multi.rs``:
p2g_1 :148-183, p2g_2 :185-247, grid update :249-259, g2p :261-381) and
imports nothing of the program under test.  The physics constants come from
the configuration file's ``physics`` group.  The grid is dense and sized
here, from the walls, to hold every stencil of a clamped particle; the
scatters are ``index_add_`` in float32.

Quirks kept from the reference: the mouse impulse acts after advection and
the soft wall looks ahead by the un-scaled velocity from the clamped
position.

``contract`` rounds the operands of every particle-grid contraction (the
deposits' and the gathers' products); ``tf32`` is that rounding as a TF32
tensor-core product does it (10 mantissa bits, round to nearest even, sums
in float32).  It makes the lower-precision control of the comparison.
"""

from __future__ import annotations

import math

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    bits = x.contiguous().view(torch.int32)
    low = bits & 0x1FFF
    up = (low > 0x1000) | ((low == 0x1000) & ((bits & 0x2000) != 0))
    return (bits - low + up.to(torch.int32) * 0x2000).view(torch.float32)


def _exact(x: torch.Tensor) -> torch.Tensor:
    return x


class Grid:
    """Dense cell grid covering every stencil of a particle inside the walls
    ``[lo, hi]``: cells ``floor(lo) - 2 .. ceil(hi) + 2`` on each axis."""

    def __init__(self, lo, hi, device):
        self.origin = torch.tensor([math.floor(v) - 2 for v in lo], device=device)
        self.shape = [math.ceil(h) + 3 - (math.floor(v) - 2) for v, h in zip(lo, hi)]
        self.cells = math.prod(self.shape)
        self.device = device

    def flat(self, cell: torch.Tensor) -> torch.Tensor:
        idx = cell - self.origin
        if bool(((idx < 0) | (idx >= torch.tensor(self.shape, device=self.device))).any()):
            raise ValueError("a stencil reaches outside the reference grid")
        out = idx[..., 0]
        for d in range(1, idx.shape[-1]):
            out = out * self.shape[d] + idx[..., d]
        return out


def stencil(pos: torch.Tensor, grid: Grid):
    """(flat cell [N, K], dpos [N, K, D], w [N, K]) of the 3^D quadratic
    B-spline taps, axis 0 varying fastest."""
    n, D = pos.shape
    base = torch.floor(pos)
    diff = pos - (base + 0.5)
    wa = torch.stack([0.5 * (0.5 - diff) ** 2, 0.75 - diff * diff, 0.5 * (0.5 + diff) ** 2],
                     dim=-1)  # [N, D, 3]
    ks = torch.cartesian_prod(*[torch.arange(3, device=pos.device)] * D).reshape(-1, D)
    ks = ks.flip(-1)  # axis 0 fastest
    w = torch.ones((n, ks.shape[0]), dtype=pos.dtype, device=pos.device)
    for d in range(D):
        w = w * wa[:, d, :][:, ks[:, d]]
    cell = base.to(torch.int64)[:, None, :] + (ks - 1)[None]
    dpos = (cell.to(pos.dtype) + 0.5) - pos[:, None, :]
    return grid.flat(cell), dpos, w


def substep(s: dict, phys: dict, grid: Grid, mouse=None, contract=_exact) -> dict:
    """One substep of the particles ``s`` (pos [N, D], vel [N, D], C [N, D, D],
    mass [N]); returns the new pos, vel, C, density and pressure (mass kept)."""
    pos, vel, C, mass = s["pos"], s["vel"], s["C"], s["mass"]
    n, D = pos.shape
    r = contract
    dt = phys["dt"]
    flat, dpos, w = stencil(pos, grid)
    fl = flat.reshape(-1)

    # p2g_1: mass and APIC momentum
    wm = r(w) * r(mass)[:, None]
    q = torch.einsum("nij,nkj->nki", r(C), r(dpos))
    gm = torch.zeros(grid.cells, dtype=pos.dtype, device=pos.device)
    gm.index_add_(0, fl, wm.reshape(-1))
    gp = torch.zeros((grid.cells, D), dtype=pos.dtype, device=pos.device)
    gp.index_add_(0, fl, (wm[..., None] * (r(vel)[:, None, :] + q)).reshape(-1, D))

    # p2g_2: density, Tait EOS, viscous stress, the eq-16 force
    density = (r(gm[flat]) * r(w)).sum(dim=1)
    volume = torch.where(density > 0, mass / torch.where(density > 0, density, 1.0), 0.0)
    pressure = torch.clamp_min(
        phys["eos_stiffness"] * ((density / phys["rest_density"]) ** phys["eos_power"] - 1.0),
        phys["pressure_floor"])
    eye = torch.eye(D, dtype=pos.dtype, device=pos.device)
    stress = -pressure[:, None, None] * eye + phys["dynamic_viscosity"] * (C + C.transpose(1, 2))
    term = (-4.0 * dt) * volume[:, None, None] * stress
    force = r(w)[..., None] * torch.einsum("nij,nkj->nki", r(term), r(dpos))
    gp.index_add_(0, fl, force.reshape(-1, D))

    # grid update
    g = torch.tensor(phys["gravity"], dtype=pos.dtype, device=pos.device)
    m = gm[:, None]
    gv = torch.where(m > 0, gp / torch.where(m > 0, m, 1.0) + dt * g, 0.0)

    # g2p, advection, mouse, walls
    wv = r(w)[..., None] * r(gv[flat])
    v = wv.sum(dim=1)
    Cn = 4.0 * torch.einsum("nki,nkj->nij", wv, r(dpos))
    p = pos + v * dt
    if mouse is not None:
        mxy = torch.tensor(mouse, dtype=pos.dtype, device=pos.device)
        dist = p[:, :2] - mxy
        dsq = (dist * dist).sum(dim=1)
        norm = torch.sqrt(dsq)
        push = torch.where(norm[:, None] > 0, dist / torch.where(norm > 0, norm, 1.0)[:, None], 0.0)
        hit = dsq < phys["mouse_radius"] ** 2
        v = torch.cat([v[:, :2] + torch.where(hit[:, None], push, 0.0), v[:, 2:]], dim=1)
    lo = torch.tensor(phys["walls"][0], dtype=pos.dtype, device=pos.device)
    hi = torch.tensor(phys["walls"][1], dtype=pos.dtype, device=pos.device)
    p = torch.clamp(p, lo, hi)
    nxt = p + v
    damp = phys["boundary_damp_dist"]
    v = v + torch.where(nxt < lo + damp, (lo + damp) - nxt, 0.0)
    v = v + torch.where(nxt > hi - damp, (hi - damp) - nxt, 0.0)
    return {"pos": p, "vel": v, "C": Cn, "mass": mass, "density": density, "pressure": pressure}


def frame(s: dict, phys: dict, mouse=None, contract=_exact) -> dict:
    """``phys["iterations"]`` substeps from the particles ``s``, float32
    throughout (TF32 off for the small products ``einsum`` may hand to a
    matrix multiply)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = Grid(*phys["walls"], device=s["pos"].device)
    for _ in range(phys["iterations"]):
        s = substep(s, phys, grid, mouse, contract)
    return s


def histogram(pos: torch.Tensor, viewport, console) -> torch.Tensor:
    """(rows, cols) int64 counts of the particles' xy in the console grid
    (``2d_multi.rs:448-456``): ``floor(x / viewport_w * cols)``; points
    outside the console are skipped."""
    cols, rows = console
    cx = torch.floor(pos[:, 0] / float(viewport[0]) * cols).to(torch.int64)
    cy = torch.floor(pos[:, 1] / float(viewport[1]) * rows).to(torch.int64)
    ok = (cx >= 0) & (cx < cols) & (cy >= 0) & (cy < rows)
    counts = torch.zeros(rows * cols, dtype=torch.int64, device=pos.device)
    counts.index_add_(0, (cy * cols + cx)[ok], torch.ones_like(cx[ok]))
    return counts.reshape(rows, cols)


RAMP = " .-=*%$#"  # 2d_multi.rs:465-474


def ascii_lines(counts: torch.Tensor) -> list:
    """Console lines of a count grid through the reference's ramp."""
    idx = counts.clamp(0, len(RAMP) - 1).cpu().tolist()
    return ["".join(RAMP[c] for c in row) for row in idx]
