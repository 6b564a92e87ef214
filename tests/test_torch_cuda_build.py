"""PyTorch port, the kernel libraries (``ops/cuda_build.py``) without nvcc.

Each launching module owns a ``Library`` of its own ``csrc`` sources, whose
entry points are typed from their ``extern "C"`` prototypes.  Here: every
prototype reads, and the entry points a library's modules launch are
exactly its prototypes, each called with as many arguments as it takes;
a library's file name follows its own sources and the shared headers only;
the reader refuses a prototype it cannot type; the CPU path loads nothing.
"""

import ast
import ctypes
import shutil
from pathlib import Path

import pytest

from fluid_tpu_torch import render, scene
from fluid_tpu_torch.ops import cuda_build
from fluid_tpu_torch.ops import micro_kernels, micro_probe, micro_stream, pallas_kernels
from fluid_tpu_torch.ops import stream_kernels
from fluid_tpu_torch.session import Session
from fluid_tpu_torch.utils import graph, timing

# library owner -> the modules that launch its entry points
LAUNCHERS = {
    "graph": (graph, (graph, timing)),
    "stream": (stream_kernels, (stream_kernels, render)),
    "pallas": (pallas_kernels, (pallas_kernels,)),
    "micro_kernels": (micro_kernels, (micro_kernels,)),
    "micro_stream": (micro_stream, (micro_stream,)),
    "micro_probe": (micro_probe, (micro_probe,)),
}
TYPES = {ctypes.c_int, ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p}


def _calls(module):
    """(entry point, arguments it is given or None where unknown) of each
    call in ``module``'s source that names one: ``_launch(name, "fluid_x",
    *args)``, which adds the stream, and ``<library>.fluid_x(*args)``."""
    for node in ast.walk(ast.parse(Path(module.__file__).read_text())):
        if not isinstance(node, ast.Call):
            continue
        starred = any(isinstance(a, ast.Starred) for a in node.args)
        f = node.func
        if isinstance(f, ast.Name) and f.id == "_launch" and isinstance(node.args[1], ast.Constant):
            yield node.args[1].value, None if starred else len(node.args) - 1
        elif isinstance(f, ast.Attribute) and f.attr.startswith("fluid_"):
            yield f.attr, None if starred else len(node.args)


@pytest.mark.parametrize("name", list(LAUNCHERS))
def test_library_prototypes_are_its_launches(name):
    owner, modules = LAUNCHERS[name]
    lib = owner.LIBRARY
    assert lib.name == name and all(p.exists() for p in lib.paths)
    protos = cuda_build.prototypes(lib.paths)
    assert protos and all(set(types) <= TYPES for types in protos.values())
    calls = [c for m in modules for c in _calls(m)]
    if owner is micro_probe:  # the probes' entry points are named from their kernels
        calls += [("fluid_" + k, None) for k in micro_probe.KERNELS]
    assert {fn for fn, _ in calls} == set(protos)
    for fn, nargs in calls:
        assert nargs in (None, len(protos[fn])), (fn, nargs, len(protos[fn]))


def test_library_names_follow_their_own_sources(tmp_path):
    """On a copy of csrc: a pallas or micro source edited renames that
    library and no other; a shared header edited renames every one."""
    shutil.copytree(cuda_build.CSRC, tmp_path, dirs_exist_ok=True)
    libs = {name: cuda_build.Library(name, owner.LIBRARY.sources, tmp_path)
            for name, (owner, _) in LAUNCHERS.items()}
    before = {name: lib.path().name for name, lib in libs.items()}
    assert len(set(before.values())) == len(before)
    for src in ("pallas_kernels.cu", "micro_kernels.cu"):
        with open(tmp_path / src, "a") as fh:
            fh.write("// edited\n")
    after = {name: lib.path().name for name, lib in libs.items()}
    assert [n for n in libs if after[n] != before[n]] == ["pallas", "micro_kernels"]
    with open(next(tmp_path.glob("*.cuh")), "a") as fh:
        fh.write("// edited\n")
    assert all(lib.path().name != after[n] for n, lib in libs.items())


@pytest.mark.parametrize("src, why", [
    ("int fluid_x(double a, void* s) { return 0; }", "double a"),
    ("void fluid_y(int a, void* s) { }", "returns 'void'"),
], ids=["double_parameter", "void_return"])
def test_prototype_reader_refuses_what_it_cannot_type(tmp_path, src, why):
    path = tmp_path / "k.cu"
    path.write_text('extern "C" {\n// an entry point\n' + src + '\n}  // extern "C"\n')
    with pytest.raises(ValueError, match=why):
        cuda_build.prototypes([path])


def test_cpu_session_loads_no_library():
    cfg, p, dom = scene.reference_scene_2d(n=256, device="cpu")
    Session(cfg.replace(iterations=2), dom, p, backend="stream", device="cpu").frame()
    assert cuda_build.LOADED == {}
