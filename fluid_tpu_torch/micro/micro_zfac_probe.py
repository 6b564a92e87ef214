"""The z-factored dots' constructs, one probe each (port of
``bench/micro_zfac_probe.py``).

The script isolated which construct of the z-factored dots crashed Mosaic
on the v5e: thirteen one-block kernels p1-p13, each run on inputs of ones
by ``run``, which printed "OK" and the output's sum or "FAIL" from a bare
``except``.  On the card every construct is index arithmetic on three
kernels (``ops/micro_probe.py``): M9 maps (p1, p3, p4, p8, p9, p11, p12),
M10 contractions (p2, p5, p6, p10, p13), M11 the roll-merge (p7).  A build
failure is a fault, so what this port measures is that each probe gives
the script's sum and equals its plain version, and its time beside the
empty kernel's launch.

``p1`` ... ``p13`` are callables on the script's ``[1, ...]`` float32
blocks with their plain versions as ``.plain``.  Importing this module
runs nothing; ``main`` runs on the card: the script's thirteen lines on
ones, then each probe against its plain version on seeded normal inputs
and timed with CUDA events.  A probe that fails to launch or differs makes
``main`` return 1, after its line.

Usage: python3 -m fluid_tpu_torch.micro.micro_zfac_probe
"""

from __future__ import annotations

import torch

from ..ops import micro_probe as mp
from ..utils.platform import card_info, require_cuda, resolve_device
from .micro_sep import expect, timeit, with_plain

GL = 1024
E = 8
E2 = 64
cap = 128
REPS = 20  # launches a timing averages over

# the script's name of each probe, as ``run`` prints it
NAMES = {
    "p1": "p1 build Uz [96,GL]",
    "p2": "p2 dot ->[96,64]",
    "p3": "p3 merge [96,64]->[12,512]",
    "p4": "p4 split [32,128]->[64,64]",
    "p5": "p5 dot N=64 pad->128",
    "p6": "p6 dot padded-B ->[96,128]",
    "p7": "p7 roll-merge",
    "p8": "p8 4D sub-group index",
    "p9": "p9 roll-select merge",
    "p10": "p10 3D slice k-combine",
    "p11": "p11 row-dep e0 coeff",
    "p12": "p12 periodic row rep",
    "p13": "p13 sel-dot row rep",
}


def _probe(name: str):
    return with_plain(lambda *xs: mp.probe(name, *xs), lambda *xs: mp.plain(name, *xs))


PROBES = {name: _probe(name) for name in NAMES}
p1, p2, p3, p4, p5, p6, p7, p8, p9, p10, p11, p12, p13 = PROBES.values()


def ones(name: str, device=None) -> list:
    """The script's inputs of probe ``name``: ``[1, ...]`` blocks of ones."""
    device = resolve_device(device)
    return [torch.ones((1, *s), dtype=torch.float32, device=device) for s in mp.PROBES[name].ins]


def make_inputs(name: str, seed: int = 0, device=None) -> list:
    """Seeded standard-normal ``[1, ...]`` blocks of probe ``name``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((1, *s), generator=gen, device=device) for s in mp.PROBES[name].ins]


def check(name: str, got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Raise unless ``got`` agrees with ``want`` as closely as probe ``name``
    must (``Probe.tol``); returns max |d|."""
    tol = mp.PROBES[name].tol
    return expect(got, want, what, exact=tol == 0, tol=tol)


def main() -> int:
    device = require_cuda()
    print(f"card: {card_info()}", flush=True)
    failed = []
    for name, label in NAMES.items():  # the script's run(): inputs of ones
        f, xs = PROBES[name], ones(name, device)
        try:
            out = f(*xs)
            check(name, out, f.plain(*xs), label)
        except RuntimeError as err:
            print(f"{label}: FAIL {err}", flush=True)
            failed.append(name)
            continue
        print(f"{label}: OK   sum={float(out.sum()):.1f}", flush=True)

    floor = timeit(mp.empty_launch, device, iters=REPS)
    print(f"empty launch: {floor * 1e6:.2f} us", flush=True)
    for seed, (name, f) in enumerate(PROBES.items()):
        if name in failed:
            continue
        xs = make_inputs(name, seed, device)
        try:
            err = check(name, f(*xs), f.plain(*xs), name)
        except RuntimeError as e:
            print(f"{name}: FAIL {e}", flush=True)
            failed.append(name)
            continue
        t, t_plain = timeit(f, *xs, iters=REPS), timeit(f.plain, *xs, iters=REPS)
        print(f"{name:3s} {mp.PROBES[name].kernel:22s}: {t * 1e6:7.2f} us "
              f"({t / floor:4.2f}x the empty launch)  plain {t_plain * 1e6:8.2f} us  "
              f"max|d| {err:.2e}", flush=True)
    if failed:
        print(f"failed: {', '.join(failed)}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
