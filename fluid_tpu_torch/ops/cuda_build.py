"""Build and load the port's CUDA kernels (``csrc/*.cu``) with nvcc and ctypes.

The sources have a plain C interface and include only CUDA toolkit headers,
so one ``nvcc -shared`` call builds them in seconds (PyTorch's extension
builder, which compiles against PyTorch's headers, takes minutes).  The
library goes into ``fluid_tpu_torch/_build/``, named by a hash of the
sources and the flags, and is built at first use: importing this module
builds nothing.

No ``-use_fast_math``: ``powf`` in the EOS and the divisions stay IEEE.
``-fmad=false``: no multiply-add contraction, so each product and sum is
rounded on its own, in the same order as the plain PyTorch versions the
kernels are checked against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every entry point in csrc/stream_kernels.cu
SIGNATURES = {
    "fluid_deposit": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "fluid_collect": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "fluid_halo_axis": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "fluid_halo_gblk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process ran (ptxas -v)


def _nvcc() -> str:
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if Path("/usr/local/cuda/bin/nvcc").exists() else None
    )
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libfluid_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *map(str, sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
