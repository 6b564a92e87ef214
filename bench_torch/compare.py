"""The numbers that decide ``correct``: the program's frame against the reference's.

Both start from the same particles; each number is a gap between the two
results after the frame, taken by the worst particle:

  pos_gap    largest |pos - pos_ref| on any axis, in cells (world units)
  vel_gap    largest |vel - vel_ref| on any axis, over the largest
             |vel_ref| of the frame
  C_gap      largest |C - C_ref| of any entry, over the largest |C_ref|
  rho_gap    largest |density - density_ref|, over the rest density
  nonfinite  values of the program's particles that are not finite

``render_gap`` counts the characters of the app's console lines that differ
from the reference's lines of the program's own positions (exact: the
render bins the positions the frame produced).  The ``*_p99`` numbers are
the 99th percentile of the same particles' gaps: steady where a few
particles in a splash swing the largest.
"""

from __future__ import annotations

import math

import torch


def _gaps(name: str, a: torch.Tensor, b: torch.Tensor, scale: float) -> dict:
    """The largest and the 99th percentile of each particle's largest
    |a - b|, over ``scale``."""
    d = (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(dim=1) / scale
    k = max(1, math.ceil(0.99 * d.numel()))
    return {f"{name}_gap": float(d.max()), f"{name}_p99": float(d.kthvalue(k).values)}


def numbers(got: dict, want: dict, phys: dict) -> dict:
    out = _gaps("pos", got["pos"], want["pos"], 1.0)
    out |= _gaps("vel", got["vel"], want["vel"], max(float(want["vel"].abs().max()), 1e-30))
    out |= _gaps("C", got["C"], want["C"], max(float(want["C"].abs().max()), 1e-30))
    out |= _gaps("rho", got["density"], want["density"], phys["rest_density"])
    out["nonfinite"] = sum(int((~torch.isfinite(got[k])).sum())
                           for k in ("pos", "vel", "C", "density", "pressure"))
    return out


def lines_gap(got: list, want: list) -> int:
    """Characters that differ between two sets of console lines (a line
    missing or of another length counts each of its characters)."""
    gap = abs(len(got) - len(want)) * max((len(x) for x in got + want), default=0)
    for a, b in zip(got, want):
        gap += sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    return gap
