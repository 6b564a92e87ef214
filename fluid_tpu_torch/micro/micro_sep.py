"""Separable deposit dots and block lane widths (port of ``bench/micro_sep.py``).

At the 3d-1m shapes (ng = 4096 groups, G = 8 tiles, cap = 128, E = 8,
D = 3):

1. ``make_copy``: the first ``rows * lanes`` floats of each [24, 1024]
   stream group written as a [rows, lanes] block, on M1 (the TPU question
   was the write lane width; the Hopper kernel writes 16-byte vectors at
   every width).
2. ``make_dep``: the one-window deposit against the separable one, on M3:
   "onewindow" contracts the tile's 12 rows against W0 and folds the (e0,
   e1) moments; "sep3" and "sepsel" (one function: the two TPU ways to
   repeat rows, one Hopper form) contract e0-partnered rows against the
   pair window and fold the (e1, e2) moments.

Usage: python3 -m fluid_tpu_torch.micro.micro_sep [--ng 4096] [--iters 20]
"""

from __future__ import annotations

import argparse

import torch

from ..ops import micro_kernels as mk
from ..utils.platform import card_info, require_cuda, resolve_device

G, CAP, E, D = mk.G, mk.CAP, mk.E, 3
E3 = E**D  # 512
GL = G * CAP
STREAM_ROWS = 24
DEP_MODES = {"onewindow": "onewindow", "sep3": "sep", "sepsel": "sep"}


def timeit(fn, *args, iters: int = 20) -> float:
    """Mean seconds of ``fn(*args)`` over ``iters`` calls after one warm-up,
    by CUDA events."""
    fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def expect(got: torch.Tensor, want: torch.Tensor, what: str, exact: bool,
           tol: float = 1e-5) -> float:
    """Raise unless ``got`` equals ``want`` (``exact``) or is within ``tol`` x
    max|want| (a contraction summed in another order); returns max |d|."""
    err = float((got - want).abs().max())
    if exact:
        ok = torch.equal(got, want)
    else:
        ok = err <= tol * float(want.abs().max())
    if not ok:
        raise RuntimeError(f"{what}: max|d| {err} against its plain version")
    return err


def with_plain(fn, plain):
    fn.plain = plain
    return fn


def check_groups(x: torch.Tensor, ng: int) -> None:
    if x.shape[0] != ng:
        raise ValueError(f"{x.shape[0]} groups, the kernel was made for {ng}")


def synth(ng: int, seed: int = 0, device=None):
    """Random stream [ng, 24, GL] and x profiles [ng, 8, GL], uniform in [0, 1)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    stream = torch.rand((ng, STREAM_ROWS, GL), generator=gen, device=device)
    wx = torch.rand((ng, 8, GL), generator=gen, device=device)
    return stream, wx


def make_copy(ng: int, rows: int, lanes: int, pb: int = 4):
    """Read the stream group, write a [rows, lanes] block of its first rows."""
    k, rem = divmod(rows * lanes, GL)
    if rem or not 0 < k <= STREAM_ROWS:
        raise ValueError(f"[{rows}, {lanes}] is not a whole number of the stream's rows")

    def copy(stream):
        check_groups(stream, ng)
        return mk.prefix_copy(stream, rows, lanes, pb)

    return with_plain(copy, lambda stream: mk.prefix_copy_plain(stream, rows, lanes))


def _dep_args(stream):
    """The script's stand-ins from the stream rows: wy = rows 0-7, wz = rows
    8-15, the U rows 0-11 and the e0-partner rows 12-23 times 0.5."""
    return stream[:, 0:12], stream[:, 0:8], stream[:, 8:16], stream[:, 12:24]


def make_dep(ng: int, mode: str, pb: int = 4):
    """mode 'onewindow', 'sep3' or 'sepsel' (sep3 and sepsel are one
    function).  Output [ng, G*16, 128].  ``pb`` is the TPU kernel's groups a
    grid step; the Hopper kernel takes one tile a CTA whatever it is."""
    form = DEP_MODES[mode]

    def args(stream, wx):
        check_groups(stream, ng)
        U, wy, wz, part = _dep_args(stream)
        if form == "sep":
            return (form, U, wx, wy, wz, part, 0.5)
        return (form, U, wx, wy, wz)

    return with_plain(lambda stream, wx: mk.window_deposit(*args(stream, wx)),
                      lambda stream, wx: mk.window_deposit_plain(*args(stream, wx)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ng", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    ng = args.ng
    device = require_cuda()
    print(f"card: {card_info()}")
    stream, wx = synth(ng, device=device)

    print(f"ng={ng} groups, G={G}, cap={CAP}, E={E} (3d-1m-like shapes)")
    for rows, lanes in ((64, 128), (32, 256), (16, 512), (8, 1024)):
        f = make_copy(ng, rows, lanes)
        expect(f(stream), f.plain(stream), f"copy out [{rows}, {lanes}]", exact=True)
        t = timeit(f, stream, iters=args.iters)
        print(f"copy out [{rows:3d},{lanes:4d}]: {t*1e3:7.2f} ms")

    for mode in DEP_MODES:
        f = make_dep(ng, mode)
        expect(f(stream, wx), f.plain(stream, wx), f"deposit {mode}", exact=False)
        t = timeit(f, stream, wx, iters=args.iters)
        print(f"deposit {mode:10s}: {t*1e3:7.2f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
