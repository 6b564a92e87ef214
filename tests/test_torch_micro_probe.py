"""PyTorch port, the construct probes p1-p13 (M9-M11, ``ops/micro_probe.py``)
against the Pallas kernels of ``bench/micro_zfac_probe.py``, run in
interpret mode on the CPU.

The script runs its thirteen probes on ones when it is loaded and prints
one line each; the fixture loads it once with ``pl.pallas_call`` in
interpret mode and keeps those lines.  Each probe's kernel function is then
run again through a ``pl.pallas_call`` with ``run``'s grid spec on seeded
normal inputs, and held against the port (its plain versions, CPU
tensors), as closely as its ``Probe.tol`` says: the maps and the selector
dot p13 bit-equal; p10 within 1e-6 x max|JAX| (XLA may fuse its products
into FMAs); the dots p2, p5, p6 and p7's selector contractions within 1e-5
x max|JAX|, the repo's tolerance for a contraction summed in another
order.  Nothing in ``bench/`` is edited.
"""

import contextlib
import io
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from fluid_tpu_torch.micro import micro_zfac_probe as zp
from fluid_tpu_torch.ops import micro_probe as mp

from .bench_scripts import interpret_pallas, load

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCRIPT = "micro_zfac_probe"
LINE = re.compile(r"^(?P<label>.+): OK   sum=(?P<sum>[-0-9.e+]+)$")


@pytest.fixture(scope="module")
def script():
    """The script, loaded once in interpret mode, and the lines it printed."""
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mpatch:
        interpret_pallas(mpatch)
        sys.modules.pop(f"_bench_{SCRIPT}", None)  # load anew, so its lines are printed here
        with contextlib.redirect_stdout(buf):
            mod = load(SCRIPT)
    return mod, buf.getvalue().splitlines()


def run_pallas(kernel, in_shapes, out_shape, args):
    """``kernel`` through ``run``'s ``pl.pallas_call`` (grid (1,), every
    operand one [1, ...] VMEM block), in interpret mode, on ``args``."""
    f = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0, grid=(1,),
            in_specs=[pl.BlockSpec((1,) + s, lambda t, sh=s: (0,) * (len(sh) + 1),
                                   memory_space=pltpu.VMEM) for s in in_shapes],
            out_specs=pl.BlockSpec((1,) + out_shape, lambda t: (0,) * (len(out_shape) + 1),
                                   memory_space=pltpu.VMEM),
        ),
        out_shape=jax.ShapeDtypeStruct((1,) + out_shape, jnp.float32),
        interpret=True,
    )
    return np.asarray(jax.jit(f)(*args))


@pytest.mark.parametrize("name", list(zp.NAMES))
def test_probe_matches_jax(script, name):
    mod, _ = script
    spec = mp.PROBES[name]
    rng = np.random.default_rng(int(name[1:]))
    xs = [rng.standard_normal((1,) + s).astype(np.float32) for s in spec.ins]
    want = run_pallas(getattr(mod, name), spec.ins, spec.out, [jnp.asarray(x) for x in xs])
    got = zp.PROBES[name](*(torch.from_numpy(x) for x in xs)).numpy()
    assert got.shape == want.shape == (1, *spec.out)
    if spec.tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        err = float(np.abs(got - want).max())
        assert err <= spec.tol * float(np.abs(want).max()), err


@pytest.mark.parametrize("name", list(zp.NAMES))
def test_script_sums_equal_port_on_ones(script, name):
    """The script's line for the probe reads OK, with the sum the port's
    plain version gives on ones."""
    _, lines = script
    found = [m for m in map(LINE.match, lines) if m and m["label"] == zp.NAMES[name]]
    assert len(found) == 1, lines
    out = zp.PROBES[name].plain(*zp.ones(name, "cpu"))
    assert float(found[0]["sum"]) == float(out.sum())


def test_script_prints_one_ok_line_per_probe(script):
    _, lines = script
    assert [LINE.match(line)["label"] for line in lines] == list(zp.NAMES.values())


def test_probe_modules_import_no_jax_and_launch_nothing():
    """Importing the entry point and its kernels' module pulls in no JAX and
    launches nothing."""
    code = (
        "import sys; import fluid_tpu_torch.micro.micro_zfac_probe as zp; "
        "from fluid_tpu_torch.ops import micro_probe as mp; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'fluid_tpu.'))); "
        "assert not bad, bad; "
        "assert mp.LAUNCHES == {k: 0 for k in mp.KERNELS}, mp.LAUNCHES"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_probe_wrapper_checks_its_arguments():
    a = torch.zeros((1, 96, 128))
    with pytest.raises(ValueError, match="probe 'p14'"):
        mp.probe("p14", a)
    with pytest.raises(ValueError, match="2 inputs, expected 1"):
        mp.probe("p8", a, a)
    with pytest.raises(ValueError, match="shape"):
        mp.probe("p8", torch.zeros((96, 128)))
    with pytest.raises(TypeError, match="dtype"):
        mp.probe("p8", a.double())
    with pytest.raises(ValueError, match="contiguous"):
        mp.probe("p9", torch.zeros((1, 128, 96)).transpose(1, 2))
    with pytest.raises(ValueError, match="runs on cuda"):
        mp.empty_launch("cpu")
    assert mp.LAUNCHES == {k: 0 for k in mp.KERNELS}  # plain versions launch nothing


def test_probe_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: main would run the probes on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zp.main()
    assert mp.LAUNCHES == {k: 0 for k in mp.KERNELS}
