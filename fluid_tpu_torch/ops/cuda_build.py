"""Build and load the port's CUDA kernels with nvcc and ctypes.

Each module that launches kernels owns one ``Library``: the ``csrc/*.cu``
sources it names, built into a shared library of its own at its first
``load()`` (importing builds nothing).  The sources have a plain C
interface and include only CUDA toolkit headers, so nvcc builds them in
seconds (PyTorch's extension builder, which compiles against PyTorch's
headers, takes minutes): one nvcc per source, all started together, then
one link.  Device helpers the sources share live in ``csrc/*.cuh``.  A
library goes into ``fluid_tpu_torch/_build/``, named by the module's name
and a hash of its sources, the shared headers and the flags, so editing
one module's kernels rebuilds that module's library only.

A library's entry points are the functions its sources define at the start
of a line after ``extern "C" {`` (the block that ends each source), and
their argtypes are read from those prototypes: ``int``, ``float`` and
``long long`` by value, any pointer as ``void*``, each returning ``int``
(a ``cudaError_t``).  A prototype outside those types raises when the
library loads.

No ``-use_fast_math``: ``powf`` in the EOS and the divisions stay IEEE.
``-fmad=false``: no multiply-add contraction, so each product and sum is
rounded on its own, in the same order as the plain PyTorch versions the
kernels are checked against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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

_BY_VALUE = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_ENTRY = re.compile(r"^(\w[\w ]*?)\s+(\w+)\s*\(([^)]*)\)\s*\{", re.M)

LOADED: dict = {}  # name -> path of each library this process has loaded


def _nvcc() -> str:
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if Path("/usr/local/cuda/bin/nvcc").exists() else None
    )
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _argtype(param: str, where: str):
    if "*" in param:
        return ctypes.c_void_p
    words = param.replace("const", " ").split()
    kind = _BY_VALUE.get(" ".join(words[:-1]))
    if kind is None:
        raise ValueError(f"{where}: parameter {param.strip()!r} is not an int, float, "
                         "long long or pointer")
    return kind


def prototypes(paths) -> dict:
    """name -> argtypes of every entry point the sources ``paths`` define;
    raises on one that does not return ``int`` or takes a parameter of
    another type than ``_BY_VALUE``'s or a pointer."""
    out = {}
    for path in map(Path, paths):
        text = _COMMENT.sub("", path.read_text()).partition('extern "C" {')[2]
        for ret, name, params in _ENTRY.findall(text):
            where = f"{path.name}: {name}"
            if ret.split() != ["int"]:
                raise ValueError(f"{where} returns {ret!r}, not int")
            out[name] = [_argtype(p, where) for p in params.split(",")
                         if p.strip() not in ("", "void")]
    return out


def _timed(name: str, cmd: list[str]):
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    return name, res, time.perf_counter() - t0


class Library:
    """The kernels of one launching module: ``sources`` (file names in
    ``csrc``), built and loaded at the first ``load()``.  ``build_log`` is
    nvcc's output (ptxas -v) and ``build_seconds`` the wall seconds of each
    nvcc of the build this process ran."""

    def __init__(self, name: str, sources, csrc: Path = CSRC):
        self.name, self.sources, self.csrc = name, tuple(sources), Path(csrc)
        self.paths = [self.csrc / s for s in self.sources]
        self.build_log = ""
        self.build_seconds: dict = {}
        self._lock = threading.Lock()
        self._lib = None

    def path(self) -> Path:
        h = hashlib.sha256()
        for src in sorted(self.paths) + sorted(self.csrc.glob("*.cuh")):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        h.update(" ".join(FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the sources into the hashed library unless it already
        exists: one nvcc per source, all started together, then one link."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc, stem = _nvcc(), BUILD_DIR / f"{out.stem}.{os.getpid()}"
        objs = [f"{stem}.{src.stem}.o" for src in self.paths]
        tmp = f"{stem}.tmp"
        jobs = [(src.name, [nvcc, *FLAGS, "-I", str(self.csrc), "-c", "-o", obj, str(src)])
                for src, obj in zip(self.paths, objs)]
        with ThreadPoolExecutor(len(jobs)) as pool:
            runs = list(pool.map(lambda job: _timed(*job), jobs))
        if all(res.returncode == 0 for _, res, _ in runs):
            runs.append(_timed("link", [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]))
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
        self.build_log = "".join(res.stdout + res.stderr for _, res, _ in runs)
        self.build_seconds = {name: secs for name, _, secs in runs}
        if any(res.returncode != 0 for _, res, _ in runs):
            raise RuntimeError(f"nvcc failed ({self.name}):\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library, built on first call, each entry point typed
        from its prototype."""
        with self._lock:
            if self._lib is None:
                signatures = prototypes(self.paths)
                path = self.build()
                lib = ctypes.CDLL(str(path))
                for name, argtypes in signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
                LOADED[self.name] = path
            return self._lib
