"""The micro-benchmark entry points' kernels M1-M4: wrapper, plain version, count.

Counterparts of the Pallas kernels of ``bench/micro_sep.py``,
``micro_pb.py``, ``micro_dma.py`` and ``micro_zfac.py``, used by
``fluid_tpu_torch/micro/``:

* ``prefix_copy`` (M1): the first ``rows * lanes`` floats of each group,
  ``pb`` groups a CTA (micro_sep / micro_pb ``make_copy``,
  micro_dma ``make_pipelined``);
* ``bulk_copy`` (M2): an identity copy through shared memory by the
  bulk-copy engine, ``chunk`` groups a CTA (micro_dma ``make_manual``);
* ``window_deposit`` (M3): per tile ``Y[r, e] = sum_p U[r, p] W0[e, p]``
  in forms "wide" (dep_cur), "zfac" (dep_z), and micro_sep's two
  deposits "onewindow" and "sep" (sep3 and sepsel) with their moment
  fix-ups;
* ``window_gather`` (M4): ``rho[p] = sum_e m[tile, e] W0[e, p]`` and
  ``X[c, p] = sum_e B[c, e] W0[e, p]`` in forms "wide" and "zfac".

Each wrapper checks its tensors, then for CPU tensors runs the plain
PyTorch version below (one a function: a contraction's wide and zfac forms
share the one against W0; what the CPU tests compare with the JAX scripts in
interpret mode, and what ``chip_smoke.py`` and the entry points hold the
kernels against on the card), and for CUDA tensors launches the kernel of
``csrc/micro_kernels.cu`` or raises.  ``LAUNCHES[name]`` counts each
wrapper's kernel launches, never the plain versions'.

Shapes are the scripts' (``W0[e0*64 + e1*8 + e2, p] = wx[e0,p] * (wy[e1,p]
* wz[e2,p])``, axis 0 slowest): groups of G = 8 tiles of CAP = 128
particles, profiles ``[ng, 8, GL]``, ``U`` ``[ng, 12, GL]``, ``m`` ``[ng,
32, 128]``, ``B`` ``[ng, 16, 512]``; only ``ng`` varies.  The plain
versions walk the groups in chunks of ``PLAIN_CHUNK``, so W0 of all 4,096
groups (8.6 GB) is never held at once.  The contractions of the kernels
and the plain versions (``torch.matmul``, full float32) sum in different
orders, so they agree to rounding, not bit for bit; the copies are
bit-equal.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .stream_kernels import _check, _launch, _on_cpu, _ptr

G, CAP, E, R = 8, 128, 8, 12
GL, E2, E3 = G * CAP, E * E, E**3
S1 = E3 // CAP  # 128-wide rows of one tile's window
PLAIN_CHUNK = 256

KERNELS = ("micro_prefix_copy", "micro_bulk_copy", "micro_window_deposit", "micro_window_gather")
LAUNCHES = {name: 0 for name in KERNELS}
LIBRARY = cuda_build.Library("micro_kernels", ("micro_kernels.cu",))
COPY_PB = (2, 4, 8, 16)
DEPOSIT_FORMS = {"wide": 0, "zfac": 1, "onewindow": 2, "sep": 3}
GATHER_KINDS = {"rho": 1, "g2p": 16}
GATHER_FORMS = {"wide": 0, "zfac": 1}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _rows(name: str, t: torch.Tensor, nrows: int, ng: int, device) -> None:
    """A [ng, nrows, GL] float32 row input: each group row-major (a row
    slice of a wider stream is fine), 16-byte aligned on the card."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if tuple(t.shape) != (ng, nrows, GL):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {(ng, nrows, GL)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.stride(2) != 1 or t.stride(1) != GL or t.stride(0) % 4:
        raise ValueError(f"{name}: strides {t.stride()}, expected (4k, {GL}, 1)")
    if device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned")


def _group_chunks(ng: int):
    for a in range(0, ng, PLAIN_CHUNK):
        yield slice(a, min(ng, a + PLAIN_CHUNK))


def _w12(wy, wz):
    """Pair window [c, 64, GL], yz = e1*8 + e2."""
    return (wy[:, :, None, :] * wz[:, None, :, :]).reshape(-1, E2, GL)


def _w0(wx, wy, wz):
    """Window [c, 512, GL] = wx * (wy * wz), e0 slowest."""
    return (wx[:, :, None, :] * _w12(wy, wz)[:, None, :, :]).reshape(-1, E3, GL)


def _tiles(x):
    """[c, rows, GL] -> [c, G, rows, CAP]."""
    return x.reshape(x.shape[0], x.shape[1], G, CAP).transpose(1, 2)


# ---------------------------------------------------------------------------
# M1, M2: copies
# ---------------------------------------------------------------------------


def prefix_copy_plain(src: torch.Tensor, rows: int, lanes: int) -> torch.Tensor:
    ng = src.shape[0]
    return src.reshape(ng, -1)[:, : rows * lanes].reshape(ng, rows, lanes).clone()


def prefix_copy(src: torch.Tensor, rows: int, lanes: int, pb: int = 4) -> torch.Tensor:
    """``out[g] = src[g].flatten()[:rows * lanes].reshape(rows, lanes)`` for
    a contiguous float32 ``src`` [ng, ...]; ``pb`` groups a CTA."""
    ng, n = src.shape[0], rows * lanes
    if src.dtype != torch.float32 or not src.is_contiguous():
        raise ValueError("src: contiguous float32 expected")
    per = src[0].numel() if ng else 0
    if not 0 < n <= max(per, 1):
        raise ValueError(f"rows * lanes = {n} floats of a {per}-float group")
    if _on_cpu(src.device):
        return prefix_copy_plain(src, rows, lanes)
    if pb not in COPY_PB:
        raise ValueError(f"pb {pb}: the kernel is built for {COPY_PB}")
    if n % 4 or per % 4 or src.data_ptr() % 16:
        raise ValueError("the kernel copies float4s: rows * lanes and the group size "
                         "must be multiples of 4, src 16-byte aligned")
    out = torch.empty((ng, rows, lanes), dtype=torch.float32, device=src.device)
    _launch("micro_prefix_copy", "fluid_micro_prefix_copy", pb, _ptr(src), per, _ptr(out), n, ng,
            lib=LIBRARY, counts=LAUNCHES)
    return out


def bulk_copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def bulk_copy(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """``x`` [ng, ...] copied through shared memory, ``chunk`` consecutive
    groups a CTA (``ng`` a multiple of ``chunk``, as make_manual's
    ``ng // chunk`` chunks cover every group only then)."""
    ng = x.shape[0]
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x: contiguous float32 expected")
    if chunk <= 0 or ng % chunk:
        raise ValueError(f"chunk {chunk} does not divide ng {ng}")
    if _on_cpu(x.device):
        return bulk_copy_plain(x)
    group_bytes = x[0].numel() * 4 if ng else 0
    if group_bytes % 16 or x.data_ptr() % 16:
        raise ValueError("the bulk copy moves 16-byte units: group bytes a multiple of 16")
    out = torch.empty_like(x)
    _launch("micro_bulk_copy", "fluid_micro_bulk_copy", _ptr(x), _ptr(out), group_bytes, ng, chunk,
            lib=LIBRARY, counts=LAUNCHES)
    return out


# ---------------------------------------------------------------------------
# M3: deposit contraction
# ---------------------------------------------------------------------------


def _contract_rows(V, W):
    """[c, rows, GL] x [c, cols, GL] -> [c, G, rows, cols], summed per tile."""
    return torch.matmul(_tiles(V), _tiles(W).transpose(-1, -2))


def _deposit_chunk(form, U, wx, wy, wz, part, part_scale):
    c = U.shape[0]
    if form != "sep":  # wide = zfac (one function) and onewindow, against W0
        Y = _contract_rows(U, _w0(wx, wy, wz))  # [c, G, R, 512]
        if form != "onewindow":
            return Y
        e = torch.arange(E3, device=U.device)
        e0, e1 = (e // E2).float(), (e // E % E).float()
        return Y[:, :, 0:4] + e0 * Y[:, :, 4:8] + e1 * Y[:, :, 8:12]
    # sep: rows (r, e0) = wx * (U + e0 * part_scale * part), against wy (x) wz
    wxe = wx[:, None, :, :]  # [c, 1, 8, GL]
    e0f = torch.arange(E, device=U.device, dtype=torch.float32)[:, None]
    Uz = wxe * U[:, :, None, :] + (e0f * wxe) * (part_scale * part)[:, :, None, :]
    Y = _contract_rows(Uz.reshape(c, R * E, GL), _w12(wy, wz)).reshape(c, G, R, E, E2)
    yz = torch.arange(E2, device=U.device)
    e1, e2 = (yz // E).float(), (yz % E).float()
    out = Y[:, :, 0:4] + e1 * Y[:, :, 4:8] + e2 * Y[:, :, 8:12]  # [c, G, 4, 8, 64]
    return out.reshape(c, G, 4, E3)


def window_deposit_plain(form, U, wx, wy, wz, part=None, part_scale=1.0):
    """The plain version of ``window_deposit``; "wide" and "zfac" are one
    function and one plain version, against W0."""
    ng = U.shape[0]
    rows = R if form in ("wide", "zfac") else 4
    out = torch.empty((ng, G, rows, E3), dtype=torch.float32, device=U.device)
    for sl in _group_chunks(ng):
        out[sl] = _deposit_chunk(form, U[sl], wx[sl], wy[sl], wz[sl],
                                 None if part is None else part[sl], part_scale)
    return out.reshape(ng, G * rows * S1, CAP)


def window_deposit(form: str, U, wx, wy, wz, part=None, part_scale: float = 1.0) -> torch.Tensor:
    """Per tile j of each group: ``Y[r, e] = sum_{p in j} U[r, p] W0[e, p]``.

    form "wide" / "zfac": the raw [R*4, 128] block of each tile, out [ng,
    G*R*4, 128] (micro_zfac dep_cur / dep_z).  form "onewindow": the [16,
    128] block ``Y[c] + e0 Y[4+c] + e1 Y[8+c]``; form "sep": with ``U'[r,
    e0] = U[r] + e0 * part_scale * part[r]``, ``Y'[c] + e1 Y'[4+c] + e2
    Y'[8+c]``; out [ng, G*16, 128] (micro_sep make_dep).
    """
    if form not in DEPOSIT_FORMS:
        raise ValueError(f"form {form!r}: one of {tuple(DEPOSIT_FORMS)}")
    ng, dev = U.shape[0], U.device
    _rows("U", U, R, ng, dev)
    for name, t in (("wx", wx), ("wy", wy), ("wz", wz)):
        _rows(name, t, E, ng, dev)
    if (part is not None) != (form == "sep"):
        raise ValueError("part is given with form 'sep' and only then")
    if part is not None:
        _rows("part", part, R, ng, dev)
    if _on_cpu(dev):
        return window_deposit_plain(form, U, wx, wy, wz, part, part_scale)
    rows = R if form in ("wide", "zfac") else 4
    out = torch.empty((ng, G * rows * S1, CAP), dtype=torch.float32, device=dev)
    _launch("micro_window_deposit", "fluid_micro_deposit", DEPOSIT_FORMS[form],
            _ptr(U), U.stride(0), _ptr(wx), wx.stride(0), _ptr(wy), wy.stride(0),
            _ptr(wz), wz.stride(0), _ptr(part), 0 if part is None else part.stride(0),
            float(part_scale), _ptr(out), ng, lib=LIBRARY, counts=LAUNCHES)
    return out


# ---------------------------------------------------------------------------
# M4: gather contraction
# ---------------------------------------------------------------------------


def _gather_chunk(kind, x, wx, wy, wz):
    c = x.shape[0]
    W0 = _w0(wx, wy, wz)
    if kind == "rho":
        rho = torch.matmul(x.reshape(c, G, 1, E3), _tiles(W0))  # [c, G, 1, CAP]
        return rho.reshape(c, 1, GL).expand(c, 8, GL)
    return torch.matmul(x, W0)  # [c, 16, GL]


def window_gather_plain(kind, x, wx, wy, wz):
    """The plain version of both forms of ``kind`` (one function), against W0."""
    ng = x.shape[0]
    out = torch.empty((ng, 8 if kind == "rho" else 16, GL), dtype=torch.float32, device=x.device)
    for sl in _group_chunks(ng):
        out[sl] = _gather_chunk(kind, x[sl], wx[sl], wy[sl], wz[sl])
    return out


def window_gather(kind: str, form: str, x, wx, wy, wz) -> torch.Tensor:
    """kind "rho": ``rho[p] = sum_e m[j, e] W0[e, p]`` for p in tile j, x =
    m [ng, G*4, 128] (tile j's window in rows 4j..4j+3), out [ng, 8, GL]
    (8 equal rows).  kind "g2p": ``X[c, p] = sum_e B[c, e] W0[e, p]``, x = B
    [ng, 16, 512], out [ng, 16, GL].  form "wide" or "zfac" (micro_zfac
    rho_cur / rho_z, g2p_cur / g2p_z)."""
    if kind not in GATHER_KINDS or form not in GATHER_FORMS:
        raise ValueError(f"kind {kind!r} / form {form!r}: one of {tuple(GATHER_KINDS)} / "
                         f"{tuple(GATHER_FORMS)}")
    ng, dev = x.shape[0], x.device
    _check("x", x, (ng, G * S1, CAP) if kind == "rho" else (ng, 16, E3), torch.float32, dev)
    for name, t in (("wx", wx), ("wy", wy), ("wz", wz)):
        _rows(name, t, E, ng, dev)
    if _on_cpu(dev):
        return window_gather_plain(kind, x, wx, wy, wz)
    out = torch.empty((ng, 8 if kind == "rho" else 16, GL), dtype=torch.float32, device=dev)
    _launch("micro_window_gather", "fluid_micro_gather", GATHER_KINDS[kind], GATHER_FORMS[form],
            _ptr(x), x.stride(0), _ptr(wx), wx.stride(0), _ptr(wy), wy.stride(0),
            _ptr(wz), wz.stride(0), _ptr(out), ng, lib=LIBRARY, counts=LAUNCHES)
    return out
