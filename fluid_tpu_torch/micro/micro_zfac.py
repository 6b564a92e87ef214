"""z-factored window contractions against the wide-window ones (port of
``bench/micro_zfac.py``).

The window is a tensor product W0 = wx (x) (wy (x) wz) (axis 0 slowest),
so every contraction against it factors through the pair window W12 = wy
(x) wz [64, cap].  Three contractions, each in its two forms of one
function, on M3 (deposit) and M4 (rho, g2p):

* deposit  ``Y_j[r, e] = sum_p U[r, p] W0[e, p]`` per tile, out [NG, 384, 128];
* rho      ``rho[p] = sum_e m[j, e] W0[e, p]``, out [NG, 8, GL] (8 equal rows);
* g2p      ``X[c, p] = sum_e B[c, e] W0[e, p]``, out [NG, 16, GL].

"cur" builds W0 (the wide form), "zfac" keeps W12 and factors wx out.  The
JAX script's Mosaic constructs (W12 zero-padded to 128 rows, the (kbit, q)
row order of wx, the roll-select merge) answer the TPU's 128-lane tiling;
the Hopper kernels write e = e0*64 + yz directly.

Run: python3 -m fluid_tpu_torch.micro.micro_zfac
"""

from __future__ import annotations

import argparse

import torch

from ..ops import micro_kernels as mk
from ..utils.platform import card_info, require_cuda, resolve_device
from .micro_sep import expect, timeit

G, cap, E, D = mk.G, mk.CAP, mk.E, 3
GL = G * cap
E3 = E**D  # 512
E2 = E * E  # 64
S1 = E3 // 128  # 4
NG = 4096
R = mk.R  # p2g2 channel rows (1+D)*D


def make_inputs(seed: int = 0, ng: int = NG, device=None):
    """wx, wy, wz [ng, E, GL] uniform; U [ng, R, GL] normal; m [ng, G*S1,
    128] uniform (mass windows); B [ng, 16, E3] normal (g2p rows)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    wx, wy, wz = (torch.rand((ng, E, GL), **kw) for _ in range(3))
    U = torch.randn((ng, R, GL), **kw)
    m = torch.rand((ng, G * S1, 128), **kw)
    B = torch.randn((ng, 16, E3), **kw)
    return wx, wy, wz, U, m, B


def _deposit(form):
    return lambda wx, wy, wz, U, m, B: mk.window_deposit(form, U, wx, wy, wz)


def _gather(kind, form):
    return lambda wx, wy, wz, U, m, B: mk.window_gather(kind, form, m if kind == "rho" else B,
                                                        wx, wy, wz)


# each takes (wx, wy, wz, U, m, B), as the JAX script's _mk callables do
dep_cur, dep_z = _deposit("wide"), _deposit("zfac")
rho_cur, rho_z = _gather("rho", "wide"), _gather("rho", "zfac")
g2p_cur, g2p_z = _gather("g2p", "wide"), _gather("g2p", "zfac")
# one plain version a function, against W0, for both of its forms
PLAIN = {
    "deposit": lambda wx, wy, wz, U, m, B: mk.window_deposit_plain("wide", U, wx, wy, wz),
    "rho": lambda wx, wy, wz, U, m, B: mk.window_gather_plain("rho", m, wx, wy, wz),
    "g2p": lambda wx, wy, wz, U, m, B: mk.window_gather_plain("g2p", B, wx, wy, wz),
}
PAIRS = (("deposit", dep_cur, dep_z), ("rho", rho_cur, rho_z), ("g2p", g2p_cur, g2p_z))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ng", type=int, default=NG)
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    device = require_cuda()
    print(f"card: {card_info()}")
    ins = make_inputs(0, args.ng, device)

    for name, cur, fac in PAIRS:
        a, b, want = cur(*ins), fac(*ins), PLAIN[name](*ins)
        expect(a, want, f"{name} cur", exact=False)
        expect(b, want, f"{name} zfac", exact=False)
        del want
        err = float((a - b).abs().max())
        rel = err / max(1e-9, float(a.abs().max()))
        del a, b
        t_c = timeit(cur, *ins, iters=args.reps)
        t_f = timeit(fac, *ins, iters=args.reps)
        print(
            f"{name:8s}: cur {t_c*1e3:7.2f} ms  zfac {t_f*1e3:7.2f} ms  "
            f"({t_c/t_f:4.2f}x)  max|d| {err:.2e} (rel {rel:.1e})"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
