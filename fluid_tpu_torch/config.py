"""Simulation configuration (PyTorch port).

A verbatim copy of ``fluid_tpu/config.py``: that module imports nothing of
JAX, but importing it goes through ``fluid_tpu/__init__.py``, which does.
Field set and defaults must stay equal to ``fluid_tpu.config`` (tested in
``tests/test_torch_core.py``): the reference's ``Config`` struct
(``2d_multi.rs:3-33`` / ``3d_multi.rs:3-33``), one frozen dataclass for 2D
and 3D via the ``dim`` field.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    """All simulation parameters. Frozen + hashable => usable as a jit static arg.

    Defaults must match the reference exactly (see ``default_2d`` /
    ``default_3d``); they are part of the behavioral contract (SURVEY.md §2.2).
    """

    dim: int = 2
    dt: float = 0.032
    # NOTE: the reference computes iterations as ``(1.0 / 0.032) as i32`` in
    # BOTH binaries (2d_multi.rs:21, 3d_multi.rs:21) — i.e. 31 substeps even
    # in 3D where dt=0.066 (quirk Q4 in SURVEY.md §2.3). Replicated as-is.
    iterations: int = int(1.0 / 0.032)
    grid_res: int = 32
    gravity: Tuple[float, ...] = (0.0, 0.3)
    rest_density: float = 4.0
    dynamic_viscosity: float = 0.1
    eos_stiffness: float = 10.0
    eos_power: float = 4.0
    # Pressure floor differs between the binaries: -0.0 in 2D (2d_multi.rs:211)
    # vs -0.1 in 3D (3d_multi.rs:217) — slight cohesion in 3D.
    pressure_floor: float = -0.0
    mouse_radius: float = 10.0
    boundary_clip: Tuple[Tuple[float, ...], Tuple[float, ...]] = (
        (0.0, 0.0),
        (64.0, 64.0),
    )
    boundary_damp_dist: float = 3.0

    def __post_init__(self) -> None:
        if self.dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {self.dim}")
        for name in ("gravity",):
            if len(getattr(self, name)) != self.dim:
                raise ValueError(f"{name} must have length dim={self.dim}")
        lo, hi = self.boundary_clip
        if len(lo) != self.dim or len(hi) != self.dim:
            raise ValueError("boundary_clip bounds must have length dim")

    # ---- convenience -----------------------------------------------------

    @property
    def stencil_size(self) -> int:
        """Number of cells in the quadratic-B-spline stencil (3^dim)."""
        return 3**self.dim

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_2d(**overrides) -> Config:
    """The reference 2D defaults, verbatim (``2d_multi.rs:17-33``)."""
    cfg = Config()
    return cfg.replace(**overrides) if overrides else cfg


def default_3d(**overrides) -> Config:
    """The reference 3D defaults, verbatim (``3d_multi.rs:17-33``)."""
    cfg = Config(
        dim=3,
        dt=0.066,
        iterations=int(1.0 / 0.032),  # quirk Q4: NOT 1/dt
        grid_res=16,
        gravity=(0.0, 0.3, 0.0),
        rest_density=1.0,
        pressure_floor=-0.1,
        boundary_clip=((0.0, 0.0, 0.0), (64.0, 64.0, 64.0)),
    )
    return cfg.replace(**overrides) if overrides else cfg
