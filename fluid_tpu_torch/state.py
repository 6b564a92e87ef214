"""SoA simulation state as dataclasses of float32 tensors.

Counterpart of ``fluid_tpu/state.py``: the same fields and shapes, held as
``torch.Tensor`` instead of JAX arrays.  ``from_numpy`` / ``to_numpy`` carry
a state across the two packages (the cross-package tests feed one numpy
state to both).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .utils.platform import resolve_device

FIELDS = ("pos", "vel", "C", "mass", "density", "pressure")


@dataclasses.dataclass
class ParticleState:
    """Fixed-capacity SoA particle tensors (all float32, one device).

    pos [N, D], vel [N, D], C [N, D, D] (APIC affine momentum), mass [N],
    density [N], pressure [N] (Tait EOS, written by the substep).
    """

    pos: torch.Tensor
    vel: torch.Tensor
    C: torch.Tensor
    mass: torch.Tensor
    density: torch.Tensor
    pressure: torch.Tensor

    @property
    def n(self) -> int:
        return self.pos.shape[-2]

    @property
    def dim(self) -> int:
        return self.pos.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    @staticmethod
    def zeros(n: int, dim: int, dtype=torch.float32, device=None) -> "ParticleState":
        """All-zero state of ``n`` particles; ``device`` None means
        ``default_device()``, the card."""
        kw = dict(dtype=dtype, device=resolve_device(device))
        return ParticleState(
            pos=torch.zeros((n, dim), **kw),
            vel=torch.zeros((n, dim), **kw),
            C=torch.zeros((n, dim, dim), **kw),
            mass=torch.zeros((n,), **kw),
            density=torch.zeros((n,), **kw),
            pressure=torch.zeros((n,), **kw),
        )

    @staticmethod
    def create(pos, vel=None, C=None, mass=None, device=None) -> "ParticleState":
        """Build from positions [N, D], or a stack [B, N, D] of scenes (what
        JAX gets by vmapping ``create``); the other fields take the
        reference's seeding values (vel=0, C=0, mass=1 —
        ``2d_multi.rs:502-512``).  ``device`` None means
        ``default_device()``, the card."""
        pos = torch.as_tensor(pos, dtype=torch.float32, device=resolve_device(device))
        if pos.ndim not in (2, 3):
            raise ValueError(f"positions [N, D] or [B, N, D], got {tuple(pos.shape)}")
        lead, dim = tuple(pos.shape[:-1]), pos.shape[-1]
        kw = dict(dtype=torch.float32, device=pos.device)

        def _or(x, shape, fill):
            if x is None:
                return torch.full(shape, fill, **kw)
            return torch.as_tensor(x, **kw).reshape(shape)

        return ParticleState(
            pos=pos,
            vel=_or(vel, (*lead, dim), 0.0),
            C=_or(C, (*lead, dim, dim), 0.0),
            mass=_or(mass, lead, 1.0),
            density=torch.zeros(lead, **kw),
            pressure=torch.zeros(lead, **kw),
        )

    def to(self, device) -> "ParticleState":
        return ParticleState(**{f: getattr(self, f).to(device) for f in FIELDS})

    def clone(self) -> "ParticleState":
        return ParticleState(**{f: getattr(self, f).clone() for f in FIELDS})

    def to_numpy(self) -> dict:
        return {f: getattr(self, f).detach().cpu().numpy() for f in FIELDS}


def from_numpy(pos, vel=None, C=None, mass=None, density=None, pressure=None,
               device=None) -> ParticleState:
    """ParticleState from numpy arrays (any float dtype; cast to float32),
    on ``device`` (None: ``default_device()``)."""
    p = ParticleState.create(
        np.asarray(pos, np.float32), vel=vel, C=C, mass=mass, device=device
    )
    for name, x in (("density", density), ("pressure", pressure)):
        if x is not None:
            setattr(p, name, torch.as_tensor(
                np.asarray(x, np.float32), device=p.device
            ))
    return p


@dataclasses.dataclass
class GridState:
    """Dense background grid: mass [*shape], vel [*shape, D] (momentum during
    P2G, velocity after ``grid_update``)."""

    mass: torch.Tensor
    vel: torch.Tensor

    @staticmethod
    def zeros(shape: Tuple[int, ...], device=None) -> "GridState":
        device = resolve_device(device)
        return GridState(
            mass=torch.zeros(shape, dtype=torch.float32, device=device),
            vel=torch.zeros((*shape, len(shape)), dtype=torch.float32, device=device),
        )
