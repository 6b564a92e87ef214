"""Bulk-copy engine copy against the block copy and the PyTorch copy (port of
``bench/micro_dma.py``).

An identity copy of [4096, 24, 1024] float32 three ways: one PyTorch call
(``out.copy_(x)``), M1 with ``pb`` groups a CTA (``make_pipelined``), and
M2, which streams each CTA's ``chunk`` groups through shared memory with
the bulk-copy engine (``make_manual``, the hand-rolled double-buffered DMA
of the JAX script).  The input is random, not ones, so the bit-equality
check sees a misplaced block.

Usage: python3 -m fluid_tpu_torch.micro.micro_dma
"""

from __future__ import annotations

import argparse

import torch

from ..ops import micro_kernels as mk
from ..utils.platform import card_info, require_cuda
from .micro_sep import check_groups, expect, timeit, with_plain


def _check(x, ng, rows, lanes):
    check_groups(x, ng)
    if tuple(x.shape[1:]) != (rows, lanes):
        raise ValueError(f"x {tuple(x.shape)}, expected [{ng}, {rows}, {lanes}]")


def make_manual(ng: int, rows: int, lanes: int, chunk: int):
    """Copy [ng, rows, lanes] through shared memory by the bulk-copy engine,
    ``chunk`` consecutive groups a CTA."""

    def copy(x):
        _check(x, ng, rows, lanes)
        return mk.bulk_copy(x, chunk)

    return with_plain(copy, mk.bulk_copy_plain)


def make_pipelined(ng: int, rows: int, lanes: int, pb: int):
    def copy(x):
        _check(x, ng, rows, lanes)
        return mk.prefix_copy(x, rows, lanes, pb)

    return with_plain(copy, lambda x: mk.prefix_copy_plain(x, rows, lanes))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ng", type=int, default=4096)
    args = ap.parse_args(argv)
    ng, rows, lanes = args.ng, 24, 1024
    mb = ng * rows * lanes * 4 / 1e6
    device = require_cuda()
    print(f"card: {card_info()}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((ng, rows, lanes), generator=gen, device=device)
    print(f"array {mb:.0f} MB", flush=True)

    out = torch.empty_like(x)
    t = timeit(lambda: out.copy_(x), iters=10)
    print(f"torch copy          : {t*1e3:7.2f} ms  {2*mb/1e3/t:6.0f} GB/s", flush=True)

    for pb in (4, 16):
        f = make_pipelined(ng, rows, lanes, pb)
        expect(f(x), f.plain(x), f"pipelined copy pb={pb}", exact=True)
        t = timeit(f, x, iters=10)
        print(f"pipelined copy pb={pb:2d}: {t*1e3:7.2f} ms  {2*mb/1e3/t:6.0f} GB/s", flush=True)

    for chunk in (8, 32):
        f = make_manual(ng, rows, lanes, chunk)
        expect(f(x), f.plain(x), f"bulk copy chunk={chunk}", exact=True)
        t = timeit(f, x, iters=10)
        print(f"bulk copy chunk={chunk:2d}  : {t*1e3:7.2f} ms  {2*mb/1e3/t:6.0f} GB/s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
