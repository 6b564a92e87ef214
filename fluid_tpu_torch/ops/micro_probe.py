"""The construct-probe kernels M9-M11: wrapper, plain version, count.

Counterparts of the thirteen one-block Pallas kernels p1-p13 of
``bench/micro_zfac_probe.py`` (one ``pl.pallas_call`` site, ``run``), used
by ``fluid_tpu_torch/micro/micro_zfac_probe.py``.  On the v5e each probe
asked whether Mosaic lowers one construct of the z-factored dots; on the
card each construct is index arithmetic:

* ``probe_map`` (M9): p1, p3, p4, p8, p9, p11, p12, each output element
  from at most two inputs through a static index map (the rank-3 broadcast
  build, the reshapes, the sublane-group slices, the lane roll-select, the
  iota coefficient, the row replication);
* ``probe_contract`` (M10): p2, p5, p6, p10, p13, ``out[i, j] = sum_k
  a(i,j,k) b(i,j,k)`` with static operand maps, summed in k order;
* ``probe_roll_merge`` (M11): p7, the eight selector contractions and their
  lane rolls.

``probe(name, *xs)`` checks its tensors (each a contiguous float32 ``[1,
...]`` block of the script's shape), then for CPU tensors runs the plain
PyTorch version below (the script's arithmetic on the block, what the CPU
tests compare with the script in interpret mode, and what ``chip_smoke.py``
and the entry point hold the kernels against on the card), and for CUDA
tensors launches the probe's kernel of ``csrc/micro_probe.cu`` or raises.
``LAUNCHES[name]`` counts each kernel's launches, never the plain
versions'.  ``empty_launch`` launches the file's empty one-thread kernel,
the launch floor; it ports nothing and is not counted.

``Probe.tol`` says how closely a probe agrees, both kernel with plain
version and plain version with the script: M9 bit for bit (each element
one product or sum, rounded alone), and so p13 (one nonzero term a sum);
p10 within 1e-6 x max|reference| (XLA may fuse its products into FMAs);
p2, p5, p6 and p7 within 1e-5, contractions summed in another order (M10
in k order, ``torch.matmul`` and XLA in their own).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .stream_kernels import _check, _launch, _on_cpu, _ptr

GL, E, CAP = 1024, 8, 128  # the script's GL, E, cap

KERNELS = ("micro_probe_map", "micro_probe_contract", "micro_probe_roll_merge")
LAUNCHES = {name: 0 for name in KERNELS}
LIBRARY = cuda_build.Library("micro_probe", ("micro_probe.cu",))


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _iota(shape, dim: int, device) -> torch.Tensor:
    """``lax.broadcasted_iota(int32, shape, dim)``."""
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return torch.arange(shape[dim], dtype=torch.int32, device=device).view(view).expand(shape)


def _dot_t(a, b):
    """``lax.dot_general(a, b, (((1,), (1,)), ((), ())))``: a b^T in float32."""
    return torch.matmul(a, b.T)


def _halves(Y):
    """Y [96, 128] as [12, 2, 4, 128]: rows (r, kbit, q) -> the kbit = 0 and
    kbit = 1 rows, each [48, 128]."""
    Y4 = Y.reshape(12, 2, 4, 128)
    return Y4[:, 0].reshape(48, 128), Y4[:, 1].reshape(48, 128)


# the plain versions: the script's kernels on one block, leading 1 dropped


def _p1(U, wz):
    return (U[:, None, :] * wz[None, :, :]).reshape(12 * E, GL)


def _p2(A, B):
    return _dot_t(A, B)


def _p3(a):
    return a.reshape(12, 512).clone()


def _p4(a):
    return a.reshape(64, 64).clone()


def _p5(A, B):
    return F.pad(_dot_t(A, B), (0, 64))


def _p6(A, B):
    return _dot_t(A, F.pad(B, (0, 0, 0, 64)))


def _p7(Y):
    Yp = F.pad(Y, (0, 512 - 128))
    acc = torch.zeros((12, 512), dtype=torch.float32, device=Y.device)
    rid = _iota((12, 96), 1, Y.device)
    for k in range(8):
        blk = torch.where(rid % 8 == k, 1.0, 0.0)  # [12, 96], the same for every row
        acc = acc + torch.roll(torch.matmul(blk, Yp), 64 * k, 1)
    return acc


def _p8(Y):
    Ya, Yb = _halves(Y)
    return Ya + 2.0 * Yb


def _p9(Y):
    Ya, Yb = _halves(Y)
    return torch.where(_iota((48, 128), 1, Y.device) < 64, Ya, torch.roll(Yb, 64, 1))


def _p10(a, wz):
    X = a.reshape(16, 4, 128)
    acc = X[:, 0] * wz[0][None, :]
    for q in range(1, 4):
        acc = acc + X[:, q] * wz[q][None, :]
    return acc


def _p11(Z):
    r_io, l_io = _iota((16, 128), 0, Z.device), _iota((16, 128), 1, Z.device)
    return Z * (2 * (r_io % 4) + (l_io >= 64).int()).float()


def _p12(g):
    return g[None].expand(16, 4, 128).reshape(64, 128)


def _p13(g):
    rid, cid = _iota((64, 16), 0, g.device), _iota((64, 16), 1, g.device)
    return torch.matmul(torch.where(cid == rid % 16, 1.0, 0.0), g)


@dataclasses.dataclass(frozen=True)
class Probe:
    kernel: str  # the one of KERNELS that serves it
    code: int  # its number, the kernel's instantiation
    ins: Tuple[Tuple[int, ...], ...]  # input block shapes, leading 1 dropped
    out: Tuple[int, ...]
    plain: Callable
    tol: float = 0.0  # max|err| / max|reference| allowed; 0: bit-equal


_MAP, _CONTRACT, _ROLL = KERNELS
PROBES = {
    "p1": Probe(_MAP, 1, ((12, GL), (E, GL)), (96, GL), _p1),
    "p2": Probe(_CONTRACT, 2, ((96, CAP), (64, CAP)), (96, 64), _p2, 1e-5),
    "p3": Probe(_MAP, 3, ((96, 64),), (12, 512), _p3),
    "p4": Probe(_MAP, 4, ((32, 128),), (64, 64), _p4),
    "p5": Probe(_CONTRACT, 5, ((96, CAP), (64, CAP)), (96, 128), _p5, 1e-5),
    "p6": Probe(_CONTRACT, 6, ((96, CAP), (64, CAP)), (96, 128), _p6, 1e-5),
    "p7": Probe(_ROLL, 7, ((96, 128),), (12, 512), _p7, 1e-5),
    "p8": Probe(_MAP, 8, ((96, 128),), (48, 128), _p8),
    "p9": Probe(_MAP, 9, ((96, 128),), (48, 128), _p9),
    "p10": Probe(_CONTRACT, 10, ((64, 128), (8, 128)), (16, 128), _p10, 1e-6),
    "p11": Probe(_MAP, 11, ((16, 128),), (16, 128), _p11),
    "p12": Probe(_MAP, 12, ((4, 128),), (64, 128), _p12),
    "p13": Probe(_CONTRACT, 13, ((16, 128),), (64, 128), _p13),
}


def _spec(name: str) -> Probe:
    if name not in PROBES:
        raise ValueError(f"probe {name!r}: one of {tuple(PROBES)}")
    return PROBES[name]


def plain(name: str, *xs: torch.Tensor) -> torch.Tensor:
    """The plain version of probe ``name`` on its ``[1, ...]`` blocks."""
    return _spec(name).plain(*(x[0] for x in xs))[None]


def probe(name: str, *xs: torch.Tensor) -> torch.Tensor:
    """Probe ``name`` (``"p1"`` ... ``"p13"``) on its ``[1, ...]`` float32
    blocks of the script's shapes; out ``[1, *PROBES[name].out]``."""
    spec = _spec(name)
    if len(xs) != len(spec.ins):
        raise ValueError(f"{name}: {len(xs)} inputs, expected {len(spec.ins)}")
    dev = xs[0].device
    for i, (x, shape) in enumerate(zip(xs, spec.ins)):
        _check(f"{name} input {i}", x, (1, *shape), torch.float32, dev)
    if _on_cpu(dev):
        return plain(name, *xs)
    out = torch.empty((1, *spec.out), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        entry = "fluid_" + spec.kernel
        if spec.kernel == _ROLL:
            _launch(_ROLL, entry, _ptr(xs[0]), _ptr(out), lib=LIBRARY, counts=LAUNCHES)
        else:
            b = xs[1] if len(xs) > 1 else None
            _launch(spec.kernel, entry, spec.code, _ptr(xs[0]), _ptr(b), _ptr(out),
                    lib=LIBRARY, counts=LAUNCHES, what=name)
    return out


def empty_launch(device) -> None:
    """One launch of the empty one-thread kernel on ``device`` (a card): the
    launch floor the probes are read against."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the empty kernel runs on cuda, not {device}")
    with torch.cuda.device(device):
        _launch("micro_probe_empty", "fluid_micro_probe_empty", lib=LIBRARY, counts=None)
