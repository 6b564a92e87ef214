"""Per-tile costs of the round-2 deposit and collect design (port of
``bench/micro_kernels.py``).

At the 3d-1m scale (n = 1,000,000 particles, A = n / 64 tiles of cap =
128 slots, 64 occupied, T = 4), each case is one pass over every tile:

* ``dma``: the tile's stream block staged, its first value written: the
  fixed cost a tile (M5 ``stage_fill``); ``tb``'s ``nodma`` writes the tile
  index and reads nothing, ``dma_tb`` stages TB tiles' block at once;
* ``window``, ``matmul``: the window W0 [E^3, cap] against ones (its row
  sums) or the first N stream fields (M6 ``window_contract``);
* ``deposit``: the p2g1 block, "current" (four windows of four rows)
  against "onewindow" (one 16-row contraction and the e_d fix-up)
  (M7 ``p2g1_deposit``); ``tb`` the onewindow deposit TB tiles a CTA;
* ``tb2``, ``tb3``, ``tb4``: the same fills and deposits on the
  slot-major [16, A*cap], block [A, 16, cap] and grouped [NG, 16, G*cap]
  layouts, and the collect, ``X = W0^T Bcat`` and the 18-row particle tail
  (M8 ``window_collect``);
* ``glue``: argsort, a stream gather and scatter, and ``halo_sum``, as
  plain PyTorch ops.

Each ``case_*`` / ``_tb*`` returns a callable on tensors with its plain
PyTorch version as ``.plain`` (and ``.kernel``, the kernel it launches).
What the JAX script's TPU blocking becomes: ``PrefetchScalarGridSpec``, the
manual double buffer of ``_pipelined_load`` and the TB / G programs only
set the tiles a CTA owns; their data semantics stay: a TB program reads
``TB * cap`` rows from its first tile's start, clamped into the stream as
``dynamic_slice`` clamps it (on the TPU those rows past the stream are
undefined), and the ``A % TB`` tiles its ``A // TB`` programs never reach,
and tb4's lanes past E^3, come out zero (the TPU leaves them unwritten).
``prec`` "high" and "default" run the same float32 kernel as "highest"
(TF32 stays off); tb4's ``mode`` "abt" and "tr" are one function and one
kernel.

Run: python3 -m fluid_tpu_torch.micro.micro_kernels [--cases dma,window,...] [--n 1000000]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import micro_stream as ms
from ..ops.tiling import halo_sum
from ..utils.platform import card_info, require_cuda, resolve_device
from .micro_sep import expect, timeit, with_plain

PRECISIONS = ("default", "high", "highest")
D = 3
FO = ms.FO


# ---------------------------------------------------------------------------
# Synthetic binned scenes (3D, the 3d-1m bench layout), numpy as the script
# draws them, then on the device
# ---------------------------------------------------------------------------


def _tshape(A):
    side = max(4, int(round(A ** (1 / 3))) + 1)
    return (side, side, side)


def _tile_fields(rng, A, cap, T, tshape):
    """[A, cap, 16] fields (pos, vel, C, mass) drawn as the script's
    slot-major, block and grouped ``synth_*`` draw them."""
    tid = np.arange(A, dtype=np.int32)
    tco = np.stack(np.unravel_index(tid, tshape), -1).astype(np.float32) * T
    pos = rng.uniform(0, T, (A, cap, 3)).astype(np.float32) + tco[:, None, :]
    vel = rng.normal(0, 0.5, (A, cap, 3)).astype(np.float32)
    C = rng.normal(0, 0.1, (A, cap, 9)).astype(np.float32)
    mass = np.ones((A, cap, 1), np.float32)
    return np.concatenate([pos, vel, C, mass], -1)


def _on(device, **arrays):
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}


def synth(n, T=4, cap=128, occupancy=64, seed=0, device=None):
    """The row-major stream [n + cap, 128] (16 fields, zero padding) and
    the tile tables of the 1M bench: tile t starts at row 64 t."""
    rng = np.random.default_rng(seed)
    A = n // occupancy
    FP = 2 * D + D * D + 1  # 16
    tshape = _tshape(A)
    tid = np.arange(A, dtype=np.int32)
    act_start = (tid * occupancy).astype(np.int32)
    act_count = np.full((A,), occupancy, np.int32)
    tco = np.stack(np.unravel_index(tid, tshape), -1).astype(np.float32) * T
    pos = rng.uniform(0, T, (A, occupancy, 3)).astype(np.float32) + tco[:, None, :]
    pos = pos.reshape(-1, 3)
    vel = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    C = rng.normal(0, 0.1, (n, 9)).astype(np.float32)
    mass = np.ones((n, 1), np.float32)
    stream = np.concatenate([pos, vel, C, mass], 1)
    stream = np.concatenate([stream, np.zeros((cap, FP), np.float32)], 0)
    stream = np.pad(stream, ((0, 0), (0, 128 - FP)))
    return dict(**_on(device, stream=stream, act_start=act_start, act_count=act_count, tid=tid),
                tshape=tshape, A=A, n=n, cap=cap, T=T)


def synth_slotmajor(n, T=4, cap=128, occupancy=64, seed=0, F=16, device=None):
    """Slot-major stream [F, A*cap]: tile t owns columns [t*cap, (t+1)*cap)."""
    rng = np.random.default_rng(seed)
    A = n // occupancy
    tshape = _tshape(A)
    st = _tile_fields(rng, A, cap, T, tshape)
    count = np.full((A,), occupancy, np.int32)
    return dict(**_on(device, stream=st.reshape(A * cap, F).T, count=count),
                tshape=tshape, A=A, n=n, cap=cap, T=T, F=F)


def synth_blocks(n, T=4, cap=128, occupancy=64, seed=0, F=16, device=None):
    """Per-tile blocks [A, F, cap]."""
    rng = np.random.default_rng(seed)
    A = n // occupancy
    tshape = _tshape(A)
    st = _tile_fields(rng, A, cap, T, tshape)
    count = np.full((A,), occupancy, np.int32)
    return dict(**_on(device, stream=np.swapaxes(st, 1, 2), count=count),
                tshape=tshape, A=A, n=n, cap=cap, T=T, F=F)


def synth_grouped(n, T=4, cap=128, occupancy=64, seed=0, F=16, G=8, device=None):
    """Grouped lanes [NG, F, G*cap]: G tiles side by side a group (A cut to
    a multiple of G)."""
    rng = np.random.default_rng(seed)
    A = n // occupancy
    A = (A // G) * G
    NG = A // G
    tshape = _tshape(A)
    st = np.swapaxes(_tile_fields(rng, A, cap, T, tshape), 1, 2)  # [A, F, cap]
    stream = st.reshape(NG, G, F, cap).transpose(0, 2, 1, 3).reshape(NG, F, G * cap)
    count = np.full((A,), occupancy, np.int32)
    return dict(**_on(device, stream=stream, count=count),
                tshape=tshape, A=A, NG=NG, G=G, n=n, cap=cap, T=T, F=F)


# ---------------------------------------------------------------------------
# The cases: callables on tensors, each with its plain version
# ---------------------------------------------------------------------------


def _case(kernel: str, args):
    """A case's callable: ``args(*tensors)`` (kept as ``.args``) gives the
    positional and keyword arguments of ``kernel`` (an ``ops.micro_stream``
    function) and of its plain version."""
    op, plain = getattr(ms, kernel), getattr(ms, f"{kernel}_plain")

    def fn(*tensors):
        pos, kw = args(*tensors)
        return op(*pos, **kw)

    def fn_plain(*tensors):
        pos, kw = args(*tensors)
        return plain(*pos, **kw)

    fn.kernel, fn.args, fn.exact = f"micro_{kernel}", args, kernel == "stage_fill"
    return with_plain(fn, fn_plain)


def _check_stream(data, stream):
    if tuple(stream.shape) != tuple(data["stream"].shape):
        raise ValueError(f"stream {tuple(stream.shape)}, the case was made for "
                         f"{tuple(data['stream'].shape)}")


def _check_prec(prec):
    if prec not in PRECISIONS:
        raise ValueError(f"prec {prec!r}: one of {PRECISIONS} (all float32 on Hopper)")


def _window(data, E):
    return ms.Window(E, data["T"], tuple(data["tshape"]), data["cap"])


def _row_view(data, stream, act_start, TB=1):
    _check_stream(data, stream)
    return ms.row_major(act_start, stream.shape[0], stream.shape[1], data["cap"], TB)


def _row_fill(data, E, TB, nodma=False):
    """Row-major fills: program q reads TB*cap rows, tile q*TB + j gets the
    first value of its cap rows (nodma: its index)."""
    A, cap, E3 = data["A"], data["cap"], E**3

    def args(act_start, act_count, tid, stream):
        view = _row_view(data, stream, act_start, TB)
        return (stream, view), dict(tb=TB, nval=TB, nprog=A // TB, out_shape=(A, E3, 8),
                                    seg_len=TB * cap * stream.shape[1], nodma=nodma)

    return _case("stage_fill", args)


def case_dma_only(data, E=6, prec=None):
    """Fixed overhead: the tile's block staged + a trivial write."""
    return _row_fill(data, E, 1)


def case_window_build(data, E=6, prec="highest"):
    """W0 build + row sums (no matmul), 8 equal columns."""
    _check_prec(prec)

    def args(act_start, act_count, tid, stream):
        return (stream, _row_view(data, stream, act_start), _window(data, E), data["A"], 0), {}

    return _case("window_contract", args)


def case_matmul(data, E=6, N=16, prec="highest"):
    """W0 build + one [E^3, cap] @ [cap, N] product, V the first N lanes."""
    _check_prec(prec)
    if not 0 < N <= data["stream"].shape[1]:
        raise ValueError(f"N {N}: the stream has {data['stream'].shape[1]} lanes")

    def args(act_start, act_count, tid, stream):
        return (stream, _row_view(data, stream, act_start), _window(data, E), data["A"], N), {}

    return _case("window_contract", args)


def _deposit(data, E, form, *, TB=1, tid_coords=False, view=None, out_view=None,
             out_shape=None, ep=0):
    """A p2g1 case: tiles [0, A // TB * TB) written, TB a CTA; ``view`` the
    layout's, None for the row-major stream (its view made from the
    call's ``act_start``)."""
    A = data["A"]
    ch = 16 if form == "raw" else 4
    out_view = out_view or ms.blocks(E**3, ch)
    out_shape = out_shape or (A, E**3, ch)

    def args(view, count, tid, stream):
        return (stream, view, count, tid if tid_coords else None, _window(data, E)), dict(
            form=form, A=A, written=A // TB * TB, out_view=out_view, out_shape=out_shape, ep=ep,
            tpc=TB)

    if view is None:
        return _case("p2g1_deposit", lambda act_start, act_count, tid, stream: args(
            _row_view(data, stream, act_start, TB), act_count, tid, stream))

    def layout_args(count, stream):
        _check_stream(data, stream)
        return args(view, count, None, stream)

    return _case("p2g1_deposit", layout_args)


def case_deposit_current(data, E=6, prec="highest"):
    """Round-1 formulation: 4 window builds + 4 matmuls (p2g1), lc clipped
    to [0, T-1] and not shifted."""
    _check_prec(prec)
    return _deposit(data, E, "current")


def case_deposit_onewindow(data, E=6, prec="highest"):
    """One-window reformulation: 1 build + 1 matmul + row fixups."""
    _check_prec(prec)
    return _deposit(data, E, "onewindow")


def case_nodma(data, E=6):
    """Dispatch-only: the tile index written, no stream read."""
    return _row_fill(data, E, 1, nodma=True)


def case_dma_tb(data, TB=4, E=6):
    return _row_fill(data, E, TB)


def case_deposit_onewindow_tb(data, TB=4, E=6, prec="highest"):
    """TB tiles a program: the program's TB*cap rows from its first tile's
    start; tile coordinates and counts from ``tid`` and ``act_count``."""
    _check_prec(prec)
    return _deposit(data, E, "onewindow", TB=TB, tid_coords=True)


def _layout_fill(data, TB, view, out_shape, nseg, seg_len, seg_stride=0, nval=None):
    """Program q reads its block of TB tiles; its ``nval`` outputs (TB, or
    one for the whole group) get the first values of tiles q*TB + j."""

    def args(count, stream):
        _check_stream(data, stream)
        return (stream, view), dict(tb=TB, nval=TB if nval is None else nval,
                                    nprog=data["A"] // TB, out_shape=out_shape, seg_len=seg_len,
                                    nseg=nseg, seg_stride=seg_stride)

    return _case("stage_fill", args)


def case_tb2_dma(data, TB=8, E=6):
    A, cap, F = data["A"], data["cap"], data["F"]
    return _layout_fill(data, TB, ms.slot_major(A, cap), (A, E**3, 8), F, TB * cap, A * cap)


def case_tb2_deposit(data, TB=8, E=6, prec="highest", fixup="kernel"):
    """One-window deposit on the slot-major layout.

    fixup="kernel": emit [E^3, 4] blocks (row fixup in-kernel)
    fixup="xla":    emit raw [E^3, 16] Y
    """
    _check_prec(prec)
    if fixup not in ("kernel", "xla"):
        raise ValueError(f"fixup {fixup!r}: 'kernel' or 'xla'")
    form = "onewindow" if fixup == "kernel" else "raw"
    return _deposit(data, E, form, TB=TB, view=ms.slot_major(data["A"], data["cap"]))


def _collect(data, E, TB, view, v_view, m_view, out_view, out_shape, gblk=False):
    A = data["A"]

    def args(count, stream, v, m=None):
        _check_stream(data, stream)
        return (stream, view, v, v_view, v if gblk else m, m_view, _window(data, E)), dict(
            A=A, written=A // TB * TB, out_view=out_view, out_shape=out_shape, tpc=TB)

    return _case("window_collect", args)


def case_tb2_collect(data, TB=8, E=6, prec="highest"):
    """Collect-direction matmul + particle-tail-sized work + stream out;
    vblk [A, E^3, 3], mblk [A, E^3, 1] cell-major, out [18, A*cap]."""
    _check_prec(prec)
    A, cap, E3 = data["A"], data["cap"], E**3
    return _collect(data, E, TB, ms.slot_major(A, cap), ms.blocks(E3, D), ms.blocks(E3, 1),
                    ms.slot_major(A, cap), (FO, A * cap))


def _tb3_deposit(data, TB=8, E=6, prec="highest"):
    _check_prec(prec)
    return _deposit(data, E, "onewindow", TB=TB, view=ms.blocks(data["F"], data["cap"]))


def _tb3_dma(data, TB=8, E=6):
    A, cap, F = data["A"], data["cap"], data["F"]
    return _layout_fill(data, TB, ms.blocks(F, cap), (A, E**3, 4), 1, TB * F * cap)


def _tb3_collect(data, TB=8, E=6, prec="highest"):
    """Transposed collect: vblk arrives as vT [A, D, E^3], mblk as mT [A,
    1, E^3]; out [A, 18, cap]."""
    _check_prec(prec)
    A, cap, F, E3 = data["A"], data["cap"], data["F"], E**3
    return _collect(data, E, TB, ms.blocks(F, cap), ms.blocks_t(E3, D), ms.blocks_t(E3, 1),
                    ms.blocks(FO, cap), (A, FO, cap))


def _ep(E):
    return 256 if E == 6 else 512


def _tb4_deposit(data, E=6, prec="highest", mode="abt"):
    """Grouped deposit: out [NG, 4, G*EP] (4 fat rows per group, tile j's
    window at lanes [j*EP, j*EP + E^3), the rest zero).  mode "abt" and
    "tr" (the TPU's two ways to transpose) are one function."""
    _check_prec(prec)
    if mode not in ("abt", "tr"):
        raise ValueError(f"mode {mode!r}: 'abt' or 'tr'")
    G, NG, cap, F, EP = data["G"], data["NG"], data["cap"], data["F"], _ep(E)
    return _deposit(data, E, "onewindow", TB=G, view=ms.grouped(F, G, cap),
                    out_view=ms.grouped_t(4, G, EP), out_shape=(NG, 4, G * EP), ep=EP)


def _tb4_collect(data, E=6, prec="highest"):
    """Grouped collect: gblk [NG, 4, G*EP] (v rows 0-2, mass row 3) -> out
    stream [NG, 18, G*cap]."""
    _check_prec(prec)
    G, NG, cap, F, EP = data["G"], data["NG"], data["cap"], data["F"], _ep(E)
    return _collect(data, E, G, ms.grouped(F, G, cap), ms.grouped_t(4, G, EP),
                    ms.grouped_t(4, G, EP, offset=3 * G * EP), ms.grouped(FO, G, cap),
                    (NG, FO, G * cap), gblk=True)


def _tb4_dma(data, E=6):
    """The group's first value over all of its [4, G*256] output."""
    G, NG, cap, F = data["G"], data["NG"], data["cap"], data["F"]
    return _layout_fill(data, G, ms.grouped(F, G, cap), (NG, 4, G * 256), 1, F * G * cap, nval=1)


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------


def _label(name):
    return name + (" (f32 on Hopper)" if name.endswith(("_high", "_default")) else "")


def run_case(name, fn, args, A, iters):
    """Hold ``fn`` against its plain version (fills bit-equal, contractions
    within 1e-5 x max|plain|), then time it and print the script's line."""
    expect(fn(*args), fn.plain(*args), name, exact=fn.exact)
    torch.cuda.empty_cache()
    dt = timeit(fn, *args, iters=iters)
    print(f"{_label(name):32s} {dt*1e3:9.3f} ms   {dt/A*1e9:8.1f} ns/tile", flush=True)
    return dt


def collect_inputs(rng, data, E, shape):
    """The script's random v and mass blocks (or gblk) for one collect:
    ``shape`` "cell" ([A, E^3, 3], [A, E^3, 1]), "channel" ([A, 3, E^3],
    [A, 1, E^3]) or "gblk" ([NG, 4, G*EP])."""
    dev = data["stream"].device
    if shape == "gblk":
        g = rng.normal(size=(data["NG"], 4, data["G"] * _ep(E))).astype(np.float32)
        return (torch.from_numpy(g).to(dev),)
    A, E3 = data["A"], E**3
    vs, mshape = ((A, E3, 3), (A, E3, 1)) if shape == "cell" else ((A, 3, E3), (A, 1, E3))
    v = rng.normal(size=vs).astype(np.float32)
    m = rng.uniform(0.5, 2.0, mshape).astype(np.float32)
    return torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev)


def _with_collects(data, cases, collects, shape):
    """(name, callable, tensors) of ``cases``, then of ``collects`` [(name,
    E, callable)], their inputs drawn from ``default_rng(1)`` in order."""
    args = (data["count"], data["stream"])
    out = [(name, fn, args) for name, fn in cases]
    rng = np.random.default_rng(1)
    for name, E, fn in collects:
        out.append((name, fn, args + collect_inputs(rng, data, E, shape)))
    return out


def tb2_all(data):
    """Every case ``run_tb2`` runs, with its tensors."""
    return _with_collects(data, [
        ("tb2_dma_tb8", case_tb2_dma(data, TB=8)),
        ("tb2_dep_tb4_E6", case_tb2_deposit(data, TB=4, E=6)),
        ("tb2_dep_tb8_E6", case_tb2_deposit(data, TB=8, E=6)),
        ("tb2_dep_tb8_E6_xlafix", case_tb2_deposit(data, TB=8, E=6, fixup="xla")),
        ("tb2_dep_tb16_E6", case_tb2_deposit(data, TB=16, E=6)),
        ("tb2_dep_tb8_E8", case_tb2_deposit(data, TB=8, E=8)),
        ("tb2_dep_tb8_E6_default", case_tb2_deposit(data, TB=8, E=6, prec="default")),
    ], [(f"tb2_collect_tb8_E{E}", E, case_tb2_collect(data, TB=8, E=E)) for E in (6, 8)], "cell")


def tb3_all(data):
    """Every case ``run_tb3`` runs, with its tensors."""
    return _with_collects(data, [
        ("tb3_dma_tb8", _tb3_dma(data, TB=8)),
        ("tb3_dep_tb8_E6", _tb3_deposit(data, TB=8, E=6)),
        ("tb3_dep_tb16_E6", _tb3_deposit(data, TB=16, E=6)),
        ("tb3_dep_tb8_E8", _tb3_deposit(data, TB=8, E=8)),
    ], [(f"tb3_collect_tb8_E{E}", E, _tb3_collect(data, TB=8, E=E)) for E in (6, 8)], "channel")


def tb4_all(data):
    """Every case ``run_tb4`` runs at the data's G, with its tensors."""
    G = data["G"]
    return _with_collects(data, [
        (f"tb4_dma_G{G}", _tb4_dma(data)),
        (f"tb4_dep_abt_G{G}_E6", _tb4_deposit(data, E=6, mode="abt")),
        (f"tb4_dep_tr_G{G}_E6", _tb4_deposit(data, E=6, mode="tr")),
        (f"tb4_dep_abt_G{G}_E8", _tb4_deposit(data, E=8, mode="abt")),
    ], [(f"tb4_collect_G{G}_E{E}", E, _tb4_collect(data, E=E))
        for E in ((6, 8) if G == 8 else (6,))], "gblk")


def _run_all(cases, A, iters):
    for name, fn, tensors in cases:
        run_case(name, fn, tensors, A, iters)


def run_tb2(args):
    data = synth_slotmajor(args.n)
    A, cap = data["A"], data["cap"]
    print(f"# slot-major: A={A} tiles, {A*cap} slots", file=sys.stderr)
    _run_all(tb2_all(data), A, args.iters)


def run_tb3(args):
    data = synth_blocks(args.n)
    A, cap = data["A"], data["cap"]
    print(f"# block layout: A={A} tiles, [A,16,{cap}] stream", file=sys.stderr)
    _run_all(tb3_all(data), A, args.iters)


def run_tb4(args):
    for G in (8, 16):
        data = synth_grouped(args.n, G=G)
        print(f"# grouped G={G}: A={data['A']} tiles, NG={data['NG']}", file=sys.stderr)
        _run_all(tb4_all(data), data["A"], args.iters)


def xla_glue(n, device=None):
    """Seconds of the binning glue at n particles, as plain PyTorch ops (no
    kernel of this package): a stable argsort of n tile keys, a gather and
    a scatter of [n, 16] rows, ``halo_sum`` over 31^3 tiles of E = 6."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    res = {}
    keys = torch.from_numpy(rng.integers(0, n // 64, n).astype(np.int32)).to(device)
    res["argsort_1m"] = timeit(lambda k: torch.argsort(k, stable=True), keys, iters=10)
    packed = torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32)).to(device)
    order = torch.from_numpy(rng.permutation(n).astype(np.int64)).to(device)
    res["gather_n16"] = timeit(lambda p, o: p.index_select(0, o), packed, order, iters=10)
    res["scatter_n16"] = timeit(lambda p, o: torch.zeros_like(p).index_copy_(0, o, p),
                                packed, order, iters=10)
    nt, E, CH = 31**3, 6, 4
    blocks = torch.from_numpy(rng.normal(size=(nt, E**3, CH)).astype(np.float32)).to(device)
    res["halo_sum_31c_E6"] = timeit(
        lambda b: halo_sum(b.reshape(nt, E, E, E, CH), (31, 31, 31), 4), blocks, iters=10)
    return res


CASES = {
    "dma": lambda d: [("dma_only_E6", case_dma_only(d, E=6))],
    "window": lambda d: [
        ("window_E6", case_window_build(d, E=6)),
        ("window_E8", case_window_build(d, E=8)),
    ],
    "matmul": lambda d: [
        (f"mm_E{E}_N{N}_{p}", case_matmul(d, E=E, N=N, prec=p))
        for (E, N, p) in [
            (6, 16, "highest"), (6, 16, "high"), (6, 16, "default"),
            (6, 128, "highest"), (8, 16, "highest"), (8, 16, "high"),
        ]
    ],
    "tb": lambda d: [
        ("nodma_E6", case_nodma(d, E=6)),
        ("dma_tb4", case_dma_tb(d, TB=4)),
        ("dma_tb8", case_dma_tb(d, TB=8)),
        ("dep_onewin_tb4_E6", case_deposit_onewindow_tb(d, TB=4, E=6)),
        ("dep_onewin_tb8_E6", case_deposit_onewindow_tb(d, TB=8, E=6)),
        ("dep_onewin_tb8_E8", case_deposit_onewindow_tb(d, TB=8, E=8)),
        ("dep_onewin_tb16_E6", case_deposit_onewindow_tb(d, TB=16, E=6)),
    ],
    "deposit": lambda d: [
        ("dep_current_E6_highest", case_deposit_current(d, E=6, prec="highest")),
        ("dep_onewin_E6_highest", case_deposit_onewindow(d, E=6, prec="highest")),
        ("dep_onewin_E6_high", case_deposit_onewindow(d, E=6, prec="high")),
        ("dep_onewin_E8_high", case_deposit_onewindow(d, E=8, prec="high")),
    ],
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="dma,window,matmul,deposit,glue")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--interpret-check", action="store_true")  # unused, as in the script
    args = ap.parse_args(argv)

    device = require_cuda()
    print(f"card: {card_info()}", flush=True)
    want = args.cases.split(",")
    data = synth(args.n, device=device)
    A = data["A"]
    print(f"# devices: {torch.cuda.get_device_name(device)}  A={A} tiles, n={args.n}",
          file=sys.stderr)
    row_args = (data["act_start"], data["act_count"], data["tid"], data["stream"])
    for group in want:
        if group == "tb2":
            run_tb2(args)
        elif group == "tb3":
            run_tb3(args)
        elif group == "tb4":
            run_tb4(args)
        elif group == "glue":
            for name, dt in xla_glue(args.n, device).items():
                print(f"{name:32s} {dt*1e3:9.3f} ms", flush=True)
        else:
            for name, fn in CASES[group](data):
                run_case(name, fn, row_args, A, args.iters)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
