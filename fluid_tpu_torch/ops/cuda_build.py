"""Build and load the port's CUDA kernels (``csrc/*.cu``) with nvcc and ctypes.

The sources have a plain C interface and include only CUDA toolkit headers,
so nvcc builds them in seconds (PyTorch's extension builder, which compiles
against PyTorch's headers, takes minutes): one nvcc per source, all started
together so the build takes as long as its slowest source, then one link
into a shared library.  Device helpers the sources share live in
``csrc/*.cuh``.  The library goes into ``fluid_tpu_torch/_build/``, named by a hash of the
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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# argtypes of every entry point in csrc/*.cu
SIGNATURES = {
    "fluid_graph_if": [_P, _P, _P],
    "fluid_trace_stamp": [_P, _P, _P, _L, _I, _P],
    "fluid_deposit": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "fluid_collect": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "fluid_halo_axes": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "fluid_halo_gblk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    "fluid_rebin_gather": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _F, _P],
    "fluid_rebin_fill": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "fluid_pallas_deposit": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "fluid_pallas_collect": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "fluid_micro_prefix_copy": [_I, _P, _L, _P, _I, _I, _P],
    "fluid_micro_bulk_copy": [_P, _P, _L, _I, _I, _P],
    "fluid_micro_deposit": [_I, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _F, _P, _I, _P],
    "fluid_micro_gather": [_I, _I, _P, _L, _P, _L, _P, _L, _P, _L, _P, _I, _P],
    "fluid_micro_stage_fill": [_I, _P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L, _P, _P],
    "fluid_micro_window_contract": [_I, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "fluid_micro_p2g1": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "fluid_micro_collect": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    "fluid_micro_probe_map": [_I, _P, _P, _P, _P],
    "fluid_micro_probe_contract": [_I, _P, _P, _P, _P],
    "fluid_micro_probe_roll_merge": [_P, _P, _P],
    "fluid_micro_probe_empty": [_P],
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the build this process ran (ptxas -v)
build_seconds: dict[str, float] = {}  # wall seconds of each nvcc of that build


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
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libfluid_kernels_{h.hexdigest()[:16]}.so"


def _timed(name: str, cmd: list[str]):
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    return name, res, time.perf_counter() - t0


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists:
    one nvcc per source, all started together, then one link."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, stem = _nvcc(), BUILD_DIR / f"{out.stem}.{os.getpid()}"
    objs = [f"{stem}.{src.stem}.o" for src in sources()]
    tmp = f"{stem}.tmp"
    jobs = [(src.name, [nvcc, *FLAGS, "-I", str(CSRC), "-c", "-o", obj, str(src)])
            for src, obj in zip(sources(), objs)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        runs = list(pool.map(lambda job: _timed(*job), jobs))
    if all(res.returncode == 0 for _, res, _ in runs):
        runs.append(_timed("link", [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    build_log = "".join(res.stdout + res.stderr for _, res, _ in runs)
    build_seconds = {name: secs for name, _, secs in runs}
    if any(res.returncode != 0 for _, res, _ in runs):
        raise RuntimeError(f"nvcc failed:\n{build_log}")
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
