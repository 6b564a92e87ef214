"""Copy-floor sweep over groups a program (port of ``bench/micro_pb.py``).

B2's copy with k = 8 stream rows into [ng, 64, 128] blocks, on M1 at PB =
2, 4, 8, 16 groups a CTA, beside the one PyTorch call that copies the same
bytes.  ``arb=True`` chose the TPU's "arbitrary" dimension semantics, which
Hopper has no counterpart of: the argument stays and runs the same kernel.

Usage: python3 -m fluid_tpu_torch.micro.micro_pb [--ng 4096]
"""

from __future__ import annotations

import argparse

import torch

from ..ops import micro_kernels as mk
from ..utils.platform import card_info, require_cuda
from .micro_sep import GL, check_groups, expect, synth, timeit, with_plain

ROWS, LANES = 64, 128


def make_copy(ng: int, pb: int, arb: bool = False):
    def copy(stream):
        check_groups(stream, ng)
        return mk.prefix_copy(stream, ROWS, LANES, pb)

    return with_plain(copy, lambda stream: mk.prefix_copy_plain(stream, ROWS, LANES))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ng", type=int, default=4096)
    args = ap.parse_args(argv)
    ng = args.ng
    device = require_cuda()
    print(f"card: {card_info()}", flush=True)
    stream, _ = synth(ng, device=device)
    # PyTorch reference: one copy of the same bytes
    out = torch.empty((ng, ROWS * LANES // GL, GL), device=device)
    lib = timeit(lambda: out.copy_(stream[:, : ROWS * LANES // GL]), iters=10)
    print(f"torch copy same bytes : {lib*1e3:7.2f} ms", flush=True)
    for pb in (2, 4, 8, 16):
        f = make_copy(ng, pb)
        expect(f(stream), f.plain(stream), f"copy PB={pb}", exact=True)
        print(f"copy PB={pb:2d}         : {timeit(f, stream, iters=10)*1e3:7.2f} ms", flush=True)
    f = make_copy(ng, 4, arb=True)
    expect(f(stream), f.plain(stream), "copy PB=4 arbitrary", exact=True)
    print(f"copy PB=4 arbitrary : {timeit(f, stream, iters=10)*1e3:7.2f} ms "
          "(same kernel on Hopper)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
