"""ctypes binding of the serial C++ engine ``native/libfluid_native.so``
(PyTorch port of ``fluid_tpu/native.py``).

The engine (``native/fluid_native.cpp``, built with ``make -C native``) has
the semantics of the dense substep and runs on the host CPU.  It is the
measured CPU baseline of the JAX package's bench; here it gives the same
state surface as the port: ``NativeSim.state()`` returns a CPU
``ParticleState`` that owns its tensors.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .domain import Domain, make_domain
from .state import FIELDS, ParticleState

_LIB_PATH = Path(__file__).resolve().parent.parent / "native" / "libfluid_native.so"
ABI_VERSION = 1


class _Params(ctypes.Structure):
    _fields_ = [
        ("dt", ctypes.c_float),
        ("rest_density", ctypes.c_float),
        ("dynamic_viscosity", ctypes.c_float),
        ("eos_stiffness", ctypes.c_float),
        ("eos_power", ctypes.c_float),
        ("pressure_floor", ctypes.c_float),
        ("mouse_radius", ctypes.c_float),
        ("boundary_damp_dist", ctypes.c_float),
        ("gravity", ctypes.c_float * 3),
        ("clip_lo", ctypes.c_float * 3),
        ("clip_hi", ctypes.c_float * 3),
        ("grid_origin", ctypes.c_int32 * 3),
        ("grid_shape", ctypes.c_int32 * 3),
    ]


def available() -> bool:
    return _LIB_PATH.exists()


def _load():
    lib = ctypes.CDLL(str(_LIB_PATH))
    fp = ctypes.POINTER(ctypes.c_float)
    lib.fluid_native_step.restype = None
    lib.fluid_native_step.argtypes = [
        ctypes.c_int, ctypes.c_int64, fp, fp, fp, fp, fp, fp,
        ctypes.c_int, ctypes.POINTER(_Params), fp, fp, fp,
    ]
    lib.fluid_native_abi_version.restype = ctypes.c_int64
    lib.fluid_native_abi_version.argtypes = []
    version = lib.fluid_native_abi_version()
    if version != ABI_VERSION:
        raise RuntimeError(f"{_LIB_PATH}: ABI version {version}, expected {ABI_VERSION}")
    return lib


def _params(cfg: Config, domain: Domain) -> _Params:
    p = _Params()
    p.dt = cfg.dt
    p.rest_density = cfg.rest_density
    p.dynamic_viscosity = cfg.dynamic_viscosity
    p.eos_stiffness = cfg.eos_stiffness
    p.eos_power = cfg.eos_power
    p.pressure_floor = cfg.pressure_floor
    p.mouse_radius = cfg.mouse_radius
    p.boundary_damp_dist = cfg.boundary_damp_dist
    for d in range(cfg.dim):
        p.gravity[d] = cfg.gravity[d]
        p.clip_lo[d] = cfg.boundary_clip[0][d]
        p.clip_hi[d] = cfg.boundary_clip[1][d]
        p.grid_origin[d] = domain.origin[d]
        p.grid_shape[d] = domain.shape[d]
    return p


class NativeSim:
    """Host-CPU simulation with the port's state surface.  The engine steps
    its own float32 copies of the particles in place."""

    def __init__(self, cfg: Config, p: ParticleState, domain: Optional[Domain] = None):
        if not available():
            raise RuntimeError(
                f"native engine not built: run `make -C native` (missing {_LIB_PATH})"
            )
        self._lib = _load()
        self.cfg = cfg
        self.domain = domain or make_domain(cfg)
        n, D = p.n, p.dim

        def own(t, shape):
            # a copy the engine may write: never a view of the caller's tensor
            return np.array(t.detach().cpu().numpy(), np.float32, copy=True, order="C").reshape(shape)

        self.pos = own(p.pos, (n, D))
        self.vel = own(p.vel, (n, D))
        self.C = own(p.C, (n, D, D))
        self.mass = own(p.mass, (n,))
        self.density = np.zeros_like(self.mass)
        self.pressure = np.zeros_like(self.mass)
        ncells = self.domain.num_cells
        self._grid_m = np.zeros(ncells, np.float32)
        self._grid_v = np.zeros(ncells * cfg.dim, np.float32)
        self._prm = _params(cfg, self.domain)

    def step(self, substeps: Optional[int] = None, mouse: Optional[Tuple[float, float]] = None):
        """``substeps`` substeps (default ``cfg.iterations``), with the mouse
        at ``mouse`` (world xy) when given."""
        fp = ctypes.POINTER(ctypes.c_float)
        mouse_arr = (ctypes.c_float * 2)(*mouse) if mouse is not None else None
        self._lib.fluid_native_step(
            self.cfg.dim,
            len(self.mass),
            *(getattr(self, f).ctypes.data_as(fp) for f in FIELDS),
            self.cfg.iterations if substeps is None else substeps,
            ctypes.byref(self._prm),
            self._grid_m.ctypes.data_as(fp),
            self._grid_v.ctypes.data_as(fp),
            ctypes.cast(mouse_arr, fp),
        )

    def state(self) -> ParticleState:
        """A CPU copy of the engine's state (later steps do not change it)."""
        return ParticleState(**{f: torch.tensor(getattr(self, f)) for f in FIELDS})
