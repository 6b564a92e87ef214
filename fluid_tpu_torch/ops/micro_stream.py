"""The stream-probe kernels M5-M8: wrapper, plain version, count.

Counterparts of the Pallas kernels of ``bench/micro_kernels.py``, used by
``fluid_tpu_torch/micro/micro_kernels.py``.  Each takes a tile's stream
block from any of the script's four stream layouts, described by a
``Strided`` view:

* ``stage_fill`` (M5): each program (``tb`` tiles) stages its whole stream
  block into shared memory by the bulk-copy engine and fills its output
  with the block's first value of each tile, or (``nodma``) with the tile
  index and nothing read (``case_dma_only``, ``case_nodma``,
  ``case_dma_tb``, ``case_tb2_dma``, ``_tb3_dma``, ``_tb4_dma``);
* ``window_contract`` (M6): ``out[t, e, n] = sum_p W0[e, p] V[n, p]`` over
  all cap slots, V the first N stream fields or ones
  (``case_window_build``, ``case_matmul``);
* ``p2g1_deposit`` (M7): the p2g1 block of the valid slots, in the forms
  "current" (four windows of four rows) and "onewindow" (one 16-row
  contraction and the e_d fix-up), or the raw 16 rows Y ("raw": tb2's
  ``fixup="xla"``) (``case_deposit_current``, ``case_deposit_onewindow``,
  ``case_deposit_onewindow_tb``, ``case_tb2_deposit``, ``_tb3_deposit``,
  ``_tb4_deposit``);
* ``window_collect`` (M8): ``X = W0^T Bcat`` over all cap slots and the
  18-row particle tail (``case_tb2_collect``, ``_tb3_collect``,
  ``_tb4_collect``).

The window is the script's: per axis d, the particle's cell lc (clipped
and shifted by ``E - T - 2``, or for "current" clipped to [0, T-1] and
not shifted) gives three quadratic B-spline weights at rows lc + o of an
E-row profile (rows past E dropped), and ``W0[e0*E*E + e1*E + e2, p] =
(prof0[e0, p] * prof1[e1, p]) * prof2[e2, p]``.  The tile's coordinate
comes from the tile index, or from ``tid`` where the script reads it.

Each wrapper checks its tensors, then for CPU tensors runs the plain
PyTorch version below (one a function: "current" and "onewindow" share
the one-window contraction; what the CPU tests compare with the JAX script
in interpret mode, and what ``chip_smoke.py`` and the entry point hold the
kernels against on the card), and for CUDA tensors launches the kernel of
``csrc/micro_stream.cu`` or raises.  ``LAUNCHES[name]`` counts each
wrapper's launches, never the plain versions'.  Tiles the script's grid
never writes (the ``A % TB`` tail, tb4's lanes past E^3) come out zero.
The contractions sum in another order than the plain versions'
``torch.matmul``, so the two agree to rounding; the fills are bit-equal.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from . import cuda_build
from .stream_kernels import _ints, _launch, _on_cpu, _ptr

KERNELS = ("micro_stage_fill", "micro_window_contract", "micro_p2g1_deposit",
           "micro_window_collect")
LAUNCHES = {name: 0 for name in KERNELS}
LIBRARY = cuda_build.Library("micro_stream", ("micro_stream.cu",))
PLAIN_TILES = 512  # tiles a step of the plain versions, so W0 is never held for all
MAX_VALUES = 16  # fill values a program (its tiles)
DEPOSIT_FORMS = {"current": 0, "onewindow": 1, "raw": 2}
D = 3
FO = 2 * D + D * D + 3  # 18 collect rows


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


@dataclasses.dataclass(frozen=True, eq=False)
class Strided:
    """A tile tensor inside a flat float32 tensor: tile i's entry (a, b) at
    ``base(i) + a * sa + b * sb``, where ``base(i) = offset + (i // group) *
    group_stride + (i % group) * tile_stride``, or, given ``starts`` (the
    row-major stream, a row of ``sb`` floats a slot), ``offset + (clamp(
    starts[i - i % tb], 0, last_row) + (i % tb) * cap) * sb``: the first row
    of tile i's program clamped as ``dynamic_slice`` clamps it."""

    sa: int
    sb: int
    group: int = 1
    group_stride: int = 0
    tile_stride: int = 0
    offset: int = 0
    starts: Optional[torch.Tensor] = None
    tb: int = 1
    cap: int = 0
    last_row: int = 0

    def bases(self, tiles: torch.Tensor) -> torch.Tensor:
        """int64 float offsets of ``tiles``' entry (0, 0)."""
        if self.starts is not None:
            first = self.starts[tiles - tiles % self.tb].long().clamp(0, self.last_row)
            return self.offset + (first + (tiles % self.tb) * self.cap) * self.sb
        return (self.offset + (tiles // self.group) * self.group_stride
                + (tiles % self.group) * self.tile_stride)

    def params(self):
        """The view as the kernels take it: a host long long[9]."""
        vals = (self.group, self.group_stride, self.tile_stride, self.sa, self.sb, self.offset,
                self.tb, self.cap, self.last_row)
        return ctypes.cast((ctypes.c_longlong * 9)(*vals), ctypes.c_void_p)

    def aligned(self) -> bool:
        """Every tile base a multiple of 4 floats (16-byte rows)."""
        return all(v % 4 == 0 for v in (self.group_stride, self.tile_stride, self.offset)) and (
            self.starts is None or (self.sb % 4 == 0 and self.cap % 4 == 0))


def row_major(starts: torch.Tensor, rows: int, width: int, cap: int, tb: int = 1) -> Strided:
    """Stream [rows, width] (slot-major rows of ``width`` fields): tile i's
    program of ``tb`` tiles reads ``tb * cap`` rows from ``starts[i - i %
    tb]``, clamped into the stream; (field, slot) -> (1, width)."""
    if rows < tb * cap:
        raise ValueError(f"a program's {tb * cap} rows do not fit a {rows}-row stream")
    return Strided(sa=1, sb=width, starts=starts, tb=tb, cap=cap, last_row=rows - tb * cap)


def slot_major(A: int, cap: int, offset: int = 0) -> Strided:
    """[rows, A * cap]: tile i's (row, slot) at column i * cap + slot."""
    return Strided(sa=A * cap, sb=1, group_stride=cap, offset=offset)


def blocks(rows: int, cols: int) -> Strided:
    """[A, rows, cols]: tile i's own block."""
    return Strided(sa=cols, sb=1, group_stride=rows * cols)


def blocks_t(rows: int, cols: int) -> Strided:
    """[A, cols, rows] read as tile i's (row, col): a transposed block."""
    return Strided(sa=1, sb=rows, group_stride=rows * cols)


def grouped(rows: int, G: int, width: int, offset: int = 0) -> Strided:
    """[NG, rows, G * width]: tile i's (row, lane) at group i // G, lanes
    (i % G) * width + lane."""
    return Strided(sa=G * width, sb=1, group=G, group_stride=rows * G * width,
                   tile_stride=width, offset=offset)


def grouped_t(rows: int, G: int, width: int, offset: int = 0) -> Strided:
    """[NG, cols, G * width] read as tile i's (lane, col)."""
    v = grouped(rows, G, width, offset)
    return dataclasses.replace(v, sa=1, sb=G * width)


@dataclasses.dataclass(frozen=True)
class Window:
    """The script's window geometry: E rows a profile axis, tile size T,
    tile grid ``tshape``, ``cap`` slots a tile."""

    E: int
    T: int
    tshape: Tuple[int, int, int]
    cap: int

    @property
    def E3(self) -> int:
        return self.E**3


def _check_float(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: contiguous float32 expected, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _check_ints(name: str, t: Optional[torch.Tensor], A: int, device) -> None:
    if t is None:
        return
    if t.dtype != torch.int32 or not t.is_contiguous() or t.shape[0] < A:
        raise ValueError(f"{name}: contiguous int32 of at least {A} tiles expected")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _chunks(n: int):
    for a in range(0, n, PLAIN_TILES):
        yield torch.arange(a, min(n, a + PLAIN_TILES))


def _entries(view: Strided, tiles: torch.Tensor, na: int, nb: int, dev) -> torch.Tensor:
    """int64 [c, na, nb]: the flat offsets of ``tiles``' entries (a, b)."""
    return (view.bases(tiles.to(dev))[:, None, None]
            + torch.arange(na, device=dev)[:, None] * view.sa + torch.arange(nb, device=dev) * view.sb)


def gather_tiles(x: torch.Tensor, view: Strided, tiles: torch.Tensor, na: int,
                 nb: int) -> torch.Tensor:
    """[c, na, nb]: entries (a, b) of ``tiles`` under ``view``."""
    return x.reshape(-1)[_entries(view, tiles, na, nb, x.device)]


def _scatter(out: torch.Tensor, view: Strided, tiles: torch.Tensor, vals: torch.Tensor) -> None:
    """Write ``vals`` [c, na, nb] at ``tiles``' entries under ``view``."""
    out.view(-1)[_entries(view, tiles, *vals.shape[1:], out.device)] = vals


def tile_coords(tiles: torch.Tensor, tid: Optional[torch.Tensor], tshape) -> torch.Tensor:
    """[c, 3] tile coordinates from the tile index, or from ``tid``."""
    t = tiles if tid is None else tid[tiles].long()
    div = (tshape[1] * tshape[2], tshape[2], 1)
    return torch.stack([(t // div[d]) % tshape[d] for d in range(D)], 1)


def profiles(pos: torch.Tensor, coord: torch.Tensor, w: Window, shifted: bool = True):
    """Per-axis profiles [c, 3, E, cap], the window row of each particle's
    first tap (lc + shift) [c, 3, cap] int32 and dv [c, 3, cap], from
    positions [c, 3, cap] and tile coordinates [c, 3]: the script's
    ``_profiles`` (``shifted``) or ``case_deposit_current``'s clip."""
    shift = w.E - w.T - 2 if shifted else 0
    cell = torch.floor(pos)
    lc = (cell.to(torch.int32) - (coord * w.T).to(torch.int32)[:, :, None]).clamp(
        -shift, w.T - 1 + shift)
    dv = pos - cell - 0.5
    a, b = 0.5 - dv, 0.5 + dv
    taps = (0.5 * (a * a), 0.75 - dv * dv, 0.5 * (b * b))
    base = lc + shift
    e = torch.arange(w.E, device=pos.device, dtype=torch.int32)[:, None]
    prof = torch.zeros(pos.shape[0], D, w.E, pos.shape[2], dtype=torch.float32, device=pos.device)
    for o in range(3):
        prof = torch.where(e == (base + o)[:, :, None, :], taps[o][:, :, None, :], prof)
    return prof, base, dv


def window(prof: torch.Tensor) -> torch.Tensor:
    """W0 [c, E^3, cap] = (prof0 * prof1) * prof2, axis 0 slowest."""
    c, _, E, cap = prof.shape
    w01 = (prof[:, 0, :, None, :] * prof[:, 1, None, :, :]).reshape(c, E * E, cap)
    return (w01[:, :, None, :] * prof[:, 2, None, :, :]).reshape(c, E**3, cap)


def _e_rows(E: int, device) -> torch.Tensor:
    """[3, E^3] float: e0, e1, e2 of each window row."""
    e = torch.arange(E**3, device=device)
    return torch.stack([e // (E * E), e // E % E, e % E]).float()


def p2g1_rows(pm: torch.Tensor, valid: torch.Tensor, base: torch.Tensor, dv: torch.Tensor):
    """The one-window deposit's 16 rows [c, 16, cap] (the script's
    ``_dep_values``): [mass, A_i - sum_d (base_d + 1) m C[i][d]], then for
    each axis d [0, m C[0][d], m C[1][d], m C[2][d]]; mass 0 where not
    ``valid``."""
    vel = pm[:, D:2 * D]
    C = pm[:, 2 * D:2 * D + D * D].reshape(pm.shape[0], D, D, -1)
    mass = torch.where(valid, pm[:, 2 * D + D * D], torch.zeros((), device=pm.device))
    lcf = base.float() + 1.0
    rows = [mass]
    for i in range(D):
        cd = C[:, i, 0] * dv[:, 0]
        for j in range(1, D):
            cd = cd + C[:, i, j] * dv[:, j]
        acc = mass * (vel[:, i] - cd)
        for d in range(D):
            acc = acc - lcf[:, d] * (mass * C[:, i, d])
        rows.append(acc)
    zero = torch.zeros_like(mass)
    for d in range(D):
        rows += [zero] + [mass * C[:, i, d] for i in range(D)]
    return torch.stack(rows, 1)


# ---------------------------------------------------------------------------
# M5: stage the program's block, fill the output
# ---------------------------------------------------------------------------


def _fill_values(view: Strided, nval: int):
    """Offsets (floats) of a program's fill values from its block start."""
    if view.starts is not None:
        return [k * view.cap * view.sb for k in range(nval)]
    base = view.bases(torch.arange(nval))
    return (base - base[0]).tolist()


def stage_fill_plain(src, view: Strided, *, tb: int, nval: int, nprog: int, out_shape,
                     seg_len: int, nseg: int = 1, seg_stride: int = 0, nodma: bool = False):
    out = torch.zeros(out_shape, dtype=torch.float32, device=src.device)
    tiles = (torch.arange(nprog)[:, None] * tb + torch.arange(nval)).reshape(-1).to(src.device)
    vals = tiles.float() if nodma else src.reshape(-1)[view.bases(tiles)]
    out[: nprog * nval] = vals.view(-1, *(1,) * (len(out_shape) - 1))
    return out


def stage_fill(src, view: Strided, *, tb: int, nval: int, nprog: int, out_shape,
               seg_len: int, nseg: int = 1, seg_stride: int = 0, nodma: bool = False):
    """Program q (tiles q*tb ... q*tb + tb - 1) reads its block: ``nseg``
    segments of ``seg_len`` floats, ``seg_stride`` apart, from tile q*tb's
    base; its ``nval`` outputs (``out_shape[0]`` of them in all, each the
    rest of ``out_shape``) are filled with the block's first value of tile
    q*tb + k, or with that tile's index (``nodma``: nothing read).  Outputs
    past ``nprog * nval`` are zero."""
    dev = src.device
    _check_float("src", src, dev)
    _check_ints("starts", view.starts, nprog * tb, dev)
    if not 0 < nval <= MAX_VALUES or out_shape[0] < nprog * nval:
        raise ValueError(f"{nval} values a program, {nprog} programs, {out_shape[0]} outputs")
    offs = _fill_values(view, nval)
    if not nodma and not all(0 <= o < seg_len for o in offs):
        raise ValueError("a fill value lies outside the program's first segment")
    if _on_cpu(dev):
        return stage_fill_plain(src, view, tb=tb, nval=nval, nprog=nprog, out_shape=out_shape,
                                seg_len=seg_len, nseg=nseg, seg_stride=seg_stride, nodma=nodma)
    out_len = math.prod(out_shape[1:])
    if not nodma and (seg_len % 4 or seg_stride % 4 or not view.aligned()):
        raise ValueError("the bulk copy moves 16-byte rows: segments and bases in 4 floats")
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    offs_arr = (ctypes.c_longlong * MAX_VALUES)(*offs)
    with torch.cuda.device(dev):
        _launch("micro_stage_fill", "fluid_micro_stage_fill", int(nodma), _ptr(src),
                _ptr(view.starts), view.params(), ctypes.cast(offs_arr, ctypes.c_void_p), tb, nval,
                nprog, nseg, seg_len, seg_stride, out_len, out.numel(), _ptr(out), lib=LIBRARY,
                counts=LAUNCHES)
    return out


# ---------------------------------------------------------------------------
# M6: window contraction against the stream's first N fields
# ---------------------------------------------------------------------------


def window_contract_plain(src, view: Strided, w: Window, A: int, N: int):
    cols = 8 if N == 0 else N
    out = torch.empty((A, w.E3, cols), dtype=torch.float32, device=src.device)
    for tiles in _chunks(A):
        pm = gather_tiles(src, view, tiles, max(D, N), w.cap)
        W0 = window(profiles(pm[:, :D], tile_coords(tiles.to(src.device), None, w.tshape), w)[0])
        V = torch.ones((1, cols, w.cap), device=src.device) if N == 0 else pm[:, :N]
        out[tiles.to(src.device)] = torch.matmul(W0, V.transpose(1, 2))
    return out


def window_contract(src, view: Strided, w: Window, A: int, N: int):
    """``out[t, e, n] = sum_p W0[e, p] V[n, p]`` over all cap slots of tile
    t (its coordinate from the tile index), V the tile's first N fields, or
    (N = 0) ones in 8 columns (the window's row sums).  Out [A, E^3, N or 8]."""
    dev = src.device
    _check_float("src", src, dev)
    _check_ints("starts", view.starts, A, dev)
    if _on_cpu(dev):
        return window_contract_plain(src, view, w, A, N)
    out = torch.empty((A, w.E3, 8 if N == 0 else N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("micro_window_contract", "fluid_micro_window_contract", w.E, N, _ptr(src),
                _ptr(view.starts), view.params(), A, w.cap, w.T, _ints(w.tshape), _ptr(out),
                lib=LIBRARY, counts=LAUNCHES, what=f"E = {w.E}, N = {N}")
    return out


# ---------------------------------------------------------------------------
# M7: the p2g1 deposit
# ---------------------------------------------------------------------------


def p2g1_deposit_plain(src, view: Strided, count, tid, w: Window, *, form: str, A: int,
                       written: int, out_view: Strided, out_shape, ep: int = 0, tpc: int = 1):
    """One plain version for every form: the one-window contraction (the
    "current" form's four windows sum to it: its moment profile is the
    plain one times ``e_d - lc_d - 1``) with the form's clip rule.  ``ep``
    and ``tpc`` are the kernel's: the zeros here cover the padding and the
    tail."""
    dev = src.device
    out = torch.zeros(out_shape, dtype=torch.float32, device=dev)  # the tail and padding stay 0
    ed = _e_rows(w.E, dev)
    for tiles in _chunks(written):
        tiles = tiles.to(dev)
        pm = gather_tiles(src, view, tiles, 2 * D + D * D + 1, w.cap)
        prof, base, dv = profiles(pm[:, :D], tile_coords(tiles, tid, w.tshape), w,
                                  shifted=form != "current")
        valid = torch.arange(w.cap, device=dev) < count[tiles].long()[:, None]
        V = p2g1_rows(pm, valid, base, dv)
        Y = torch.matmul(window(prof), V.transpose(1, 2))  # [c, E^3, 16]
        if form != "raw":
            Y = (Y[..., 0:4] + ed[0, :, None] * Y[..., 4:8] + ed[1, :, None] * Y[..., 8:12]
                 + ed[2, :, None] * Y[..., 12:16])
        _scatter(out, out_view, tiles, Y)
    return out


def p2g1_deposit(src, view: Strided, count, tid, w: Window, *, form: str, A: int, written: int,
                 out_view: Strided, out_shape, ep: int = 0, tpc: int = 1):
    """The p2g1 block of the valid slots (slot < count[t]) of tiles t <
    ``written``, entry (e, c) of tile t at ``out_view``; tiles from
    ``written`` to A, and window rows from E^3 to ``ep`` (a padded tile),
    are zero.  ``form``: "current" (clip to [0, T-1], four windows of four
    rows), "onewindow" (the shifted clip, one 16-row contraction and the e_d
    fix-up; 4 channels) or "raw" (its 16 rows Y).  The tile coordinate is
    ``tid[t]``, or t when ``tid`` is None.  ``tpc`` tiles a CTA."""
    dev = src.device
    if form not in DEPOSIT_FORMS:
        raise ValueError(f"form {form!r}: one of {tuple(DEPOSIT_FORMS)}")
    _check_float("src", src, dev)
    _check_ints("starts", view.starts, written, dev)
    _check_ints("count", count, A, dev)
    _check_ints("tid", tid, A, dev)
    if not 0 <= written <= A:
        raise ValueError(f"{written} written tiles of {A}")
    if _on_cpu(dev):
        return p2g1_deposit_plain(src, view, count, tid, w, form=form, A=A, written=written,
                                  out_view=out_view, out_shape=out_shape, ep=ep, tpc=tpc)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("micro_p2g1_deposit", "fluid_micro_p2g1", w.E, DEPOSIT_FORMS[form], _ptr(src),
                _ptr(view.starts), view.params(), _ptr(count), _ptr(tid), _ptr(out),
                out_view.params(), max(ep, w.E3), A, written, tpc, w.cap, w.T, _ints(w.tshape),
                lib=LIBRARY, counts=LAUNCHES, what=f"E = {w.E}, form {form}")
    return out


# ---------------------------------------------------------------------------
# M8: the collect contraction and particle tail
# ---------------------------------------------------------------------------


def bcat(v, m, E: int):
    """Bcat [c, E^3, 13] = [v, e0 v, e1 v, e2 v, m] from ``v`` [c, E^3, 3]
    and ``m`` [c, E^3, 1]."""
    ed = _e_rows(E, v.device)[:, :, None]
    return torch.cat([v, ed[0] * v, ed[1] * v, ed[2] * v, m], -1)


def collect_x(pm, v, m, coord, w: Window):
    """X [c, 13, cap] = W0^T Bcat, and the profiles' base and dv."""
    prof, base, dv = profiles(pm[:, :D], coord, w)
    X = torch.matmul(window(prof).transpose(1, 2), bcat(v, m, w.E)).transpose(1, 2)
    return X, base, dv


def collect_tail(pm, X, base, dv):
    """The 18 rows [c, 18, cap]: pos + 0.066 v, v, newC (dd-major), rho,
    max(-0.1, 10 (rho^4 - 1)), mass."""
    v = X[:, 0:D]
    lcf = base.float() + 1.0
    newC = []
    for dd in range(D):
        for i in range(D):
            Md = X[:, D * (dd + 1) + i] - lcf[:, dd] * v[:, i]
            newC.append(4.0 * (v[:, i] * (-dv[:, dd]) + Md))
    rho = X[:, 4 * D]
    r2 = rho * rho
    prs = torch.clamp_min(10.0 * (r2 * r2 - 1.0), -0.1)
    rows = [pm[:, d] + v[:, d] * 0.066 for d in range(D)]
    rows += [v[:, d] for d in range(D)] + newC + [rho, prs, pm[:, 2 * D + D * D]]
    return torch.stack(rows, 1)


def window_collect_plain(src, view: Strided, v, v_view: Strided, m, m_view: Strided, w: Window, *,
                         A: int, written: int, out_view: Strided, out_shape, tpc: int = 1):
    dev = src.device
    out = torch.zeros(out_shape, dtype=torch.float32, device=dev)
    for tiles in _chunks(written):
        tiles = tiles.to(dev)
        pm = gather_tiles(src, view, tiles, 2 * D + D * D + 1, w.cap)
        X, base, dv = collect_x(pm, gather_tiles(v, v_view, tiles, w.E3, D),
                                gather_tiles(m, m_view, tiles, w.E3, 1), tile_coords(tiles, None, w.tshape), w)
        _scatter(out, out_view, tiles, collect_tail(pm, X, base, dv))
    return out


def window_collect(src, view: Strided, v, v_view: Strided, m, m_view: Strided, w: Window, *,
                   A: int, written: int, out_view: Strided, out_shape, tpc: int = 1):
    """Per slot p of tile t < ``written`` (its coordinate from t), with no
    count mask: ``X[c, p] = sum_e W0[e, p] Bcat[e, c]`` and the 18 rows of
    ``collect_tail``, row r of slot p at ``out_view`` entry (r, p); tiles
    from ``written`` to A are zero.  ``v`` entry (e, i) of tile t at
    ``v_view``, ``m`` entry (e, 0) at ``m_view``.  ``tpc`` tiles a CTA."""
    dev = src.device
    _check_float("src", src, dev)
    _check_float("v", v, dev)
    _check_float("m", m, dev)
    _check_ints("starts", view.starts, written, dev)
    if _on_cpu(dev):
        return window_collect_plain(src, view, v, v_view, m, m_view, w, A=A, written=written,
                                    out_view=out_view, out_shape=out_shape)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _launch("micro_window_collect", "fluid_micro_collect", w.E, _ptr(src), _ptr(view.starts),
                view.params(), _ptr(v), v_view.params(), _ptr(m), m_view.params(), _ptr(out),
                out_view.params(), A, written, tpc, w.cap, w.T, _ints(w.tshape), lib=LIBRARY,
                counts=LAUNCHES, what=f"E = {w.E}")
    return out
