"""The benchmark's general driver: one cell of ``BENCHMARK.json``, from its files.

A cell names a configuration and a traffic mix; everything of either sits
in files of its own, found by name:

  configs/<config>.json   the scene, its physics, the layout, the guarantees;
                          ``scene.builder`` names ``scenes/<builder>.py``
  traffic/<mix>.json      the mix's parameters; ``driver`` names
                          ``drivers/<driver>.py``, which sets the session up
                          for the window, makes one call of it and takes
                          the check frames
  limits/<cell>.json      each compared number's limit
  metrics/<metric>.py     ``read(run)`` of one metric

Nothing here names a cell, a configuration, a mix or a metric.

A run: set-up (scenes from the seed, ``Session``, its frame graph, then
the driver's set-up), the window (calls back to back until ``seconds``
have passed, the last call finished), the check (the driver's check
frames against ``reference.frame`` from the same particles), then the
metrics.  A traced run makes the mix's ``trace_frames`` under the
profiler (``trace.Stretch``), counting re-bins around each call, and then,
only where one of the cell's per-layer metrics reads the host clock,
``seconds`` of untraced calls for it.

The program is driven through its public entry points alone:
``fluid_tpu_torch.scene`` (the scene builders), ``fluid_tpu_torch.step``
(the mouse), ``fluid_tpu_torch.session.Session``, and ``StreamSpec`` for a
configuration that states its layout.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import time
from pathlib import Path

import torch

from . import compare, reference, trace, work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PACKAGE = ROOT / "fluid_tpu_torch"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark, as a module."""
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, cell: dict) -> tuple:
    """(configuration, traffic, limits) of a cell, each from its own file."""
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (load_json(ROOT / conf["file"]), load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
            load_json(HERE / "limits" / f"{cell['name']}.json"))


def cell_metrics(bench: dict, cell: dict, traced: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics untraced,
    its per-layer metrics traced."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def metric_reader(name: str):
    """``read(record)`` of ``metrics/<name>.py``."""
    return load_module("metrics", name).read


def build_scenes(conf: dict, seed: int, count: int, device) -> tuple:
    """(cfg, domain, [particles] * count) by ``scenes/<builder>.py``."""
    return load_module("scenes", conf["scene"]["builder"]).build(conf, seed, count, device)


def check_physics(cfg, phys: dict) -> None:
    """The program's Config has the configuration file's physics."""
    have = {k: getattr(cfg, k) for k in phys if k != "walls"}
    have["walls"] = cfg.boundary_clip
    bad = [k for k in phys
           if json.loads(json.dumps(have[k])) != phys[k]]
    if bad:
        raise ValueError(f"the program's scene differs from the configuration in {bad}")


def make_session(conf: dict, cfg, dom, p, device):
    from fluid_tpu_torch.ops.stream_transfer import StreamSpec
    from fluid_tpu_torch.session import Session

    lay = conf.get("layout")
    spec = None if lay is None else StreamSpec(tile=lay["tile"], cap=lay["cap"],
                                               halo=lay["halo"], active=lay["active"])
    return Session(cfg, dom, p, backend=conf["backend"], spec=spec, device=device)


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------


class Run:
    """One run of a cell: set-up, window, check; the record the metric
    readers take."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf, self.traffic, self.seed, self.device = conf, traffic, seed, device
        self.driver = load_module("drivers", traffic["driver"])
        self.cuda = device.type == "cuda"
        self.span = contextlib.nullcontext
        self.frames = self.jobs = self.failed = 0
        self.latencies, self.render_s = [], []
        self.tracing = False
        self.rebins = 0  # re-bins counted around the traced calls
        self.traced_frames = 0
        self.cells = []  # occupied cells before and after the traced stretch
        self.setup_checks = []  # check frames the driver took at set-up
        self.snaps = []  # snapshots a driver keeps on the card, freed with the session
        self.trace = None
        self.error = None

    def particles(self) -> dict:
        """The session's particles (``Session.particles()``, the un-bin), kept."""
        p = self.sess.particles()
        return {k: getattr(p, k).clone() for k in ("pos", "vel", "C", "mass", "density", "pressure")}

    def session_of(self, p):
        return make_session(self.conf, self.cfg, self.dom, p, self.device)

    def counted(self, fn) -> None:
        """``fn()``, with the re-bins it made added to ``self.rebins`` while
        the traced stretch runs (the counter's read synchronises)."""
        if not self.tracing:
            fn()
            return
        before = self.sess.rebins()
        fn()
        self.rebins += self.sess.rebins() - before

    def _occupied(self) -> int:
        return work.occupied_cells(self.sess.particles().pos, self.conf["physics"]["walls"])

    def setup(self, faults=None) -> None:
        """``faults(session)``, a test's hook, breaks the program's session
        underneath once its graph is captured, before the driver's set-up
        (which may take a check frame)."""
        from fluid_tpu_torch import step

        conf, tr = self.conf, self.traffic
        self.step = step
        self.cfg, self.dom, scenes = build_scenes(conf, self.seed, tr.get("scenes", 1), self.device)
        check_physics(self.cfg, conf["physics"])
        self.n, self.dim = scenes[0].n, scenes[0].dim
        self.substeps = self.cfg.iterations
        self.sess = self.session_of(scenes[0])
        self.sess.compile_run()
        if faults is not None:
            faults(self.sess)
        self.driver.setup(self, scenes)
        del scenes
        self.capture_s = self.sess.frame_graph.capture_s
        self.instantiate_s = self.sess.frame_graph.instantiate_s

    def call(self) -> None:
        """One call of the mix (a job)."""
        done = self.driver.call(self, self.span)
        self.frames += done
        self.jobs += 1
        if self.tracing:
            self.traced_frames += done

    def window(self, seconds: float, traced: bool, t_first: float, host_tail: bool = False) -> None:
        """Calls back to back for ``seconds``; traced: the stretch of
        ``trace_frames``, then ``seconds`` of untraced calls with
        ``host_tail``."""
        try:
            if traced:
                self.cells.append(self._occupied())
                with trace.Stretch(self.device) as st:
                    self.span, self.tracing = st.span, True
                    while self.traced_frames < self.traffic["trace_frames"]:
                        self.call()
                self.span, self.tracing = contextlib.nullcontext, False
                self.stretch = st
                self.cells.append(self._occupied())
            if not traced or host_tail:
                # the profiler's start and stop can take longer than the
                # window: a traced run's untraced calls get ``seconds`` of
                # their own
                t_loop = time.perf_counter() if traced else t_first
                calls = self.jobs
                while self.jobs == calls or time.perf_counter() - t_loop < seconds:
                    self.call()
            if self.cuda:
                torch.cuda.synchronize(self.device)
        except RuntimeError as e:  # a strict check of the program failed
            self.failed += 1
            self.jobs += 1
            self.error = f"window: {e}"
        self.window_s = time.perf_counter() - t_first

    def check(self, limits: dict, control: bool = False) -> dict:
        """The driver's check frames after the window and those it took at
        set-up, each against the reference from the same particles, the
        session freed first.  Returns name -> (number, limit) of the names
        in ``limits``.  With ``control``, ``self.control`` gets the same
        numbers of the reference in TF32 contractions (``reference.tf32``)
        put in the program's place."""
        found, frames = {}, []
        try:
            if self.error is not None:
                raise RuntimeError(self.error)
            frames = self.setup_checks + self.driver.check(self)
            found["lost"] = self.n - self.sess.live_count()
            found["dropped"] = self.sess.shell_drop()
        except RuntimeError as e:
            self.failed += 1
            self.error = self.error or f"check: {e}"
        self.jobs += 1
        self.memory_peak = torch.cuda.max_memory_allocated(self.device) if self.cuda else 0
        del self.sess
        self.snaps = []
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        if self.error is not None:
            return {}
        phys = self.conf["physics"]
        self.control = {}
        for fr in frames:
            start = {k: fr["start"][k] for k in ("pos", "vel", "C", "mass")}
            want = reference.frame(start, phys, mouse=fr["mouse"])
            pre = fr["prefix"]
            found.update({pre + k: v for k, v in compare.numbers(fr["got"], want, phys).items()})
            if control:
                tf = reference.frame(start, phys, mouse=fr["mouse"], contract=reference.tf32)
                self.control.update({pre + k: v
                                     for k, v in compare.numbers(tf, want, phys).items()})
            if "render" in fr:
                lines, viewport, console = fr["render"]
                found[pre + "render_gap"] = compare.lines_gap(
                    lines, reference.ascii_lines(reference.histogram(fr["got"]["pos"], viewport,
                                                                     console)))
        self.numbers = dict(found)
        return {k: (found[k], limits[k]) for k in limits}


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float, faults=None) -> tuple:
    """One run of ``cell``: (the result line's object, the check lines, the
    run).  ``faults``: a test's hook, as ``Run.setup`` takes it."""
    conf, traffic, limits = cell_files(bench, cell)
    run = Run(conf, traffic, seed, device)
    if run.cuda:
        torch.empty(0, device=device)  # the allocator's peak exists from here
        torch.cuda.reset_peak_memory_stats(device)
    run.setup(faults)
    t_first = time.perf_counter()
    run.setup_s = t_first - t_start
    reported = cell_metrics(bench, cell, traced)
    run.window(seconds, traced, t_first,
               host_tail=any(m["source"] == "host_clock" for m in reported))
    checks = run.check(limits)
    own = trace.own_kernel_names(PACKAGE)
    run.trace = run.stretch.read(own) if traced and hasattr(run, "stretch") else None
    correct = (run.failed == 0 and bool(checks)
               and all(v <= lim for v, lim in checks.values()))
    metrics = {}
    for m in reported:
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if run.cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if run.cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": run.memory_peak}
    result = {"correct": correct, "attempted": run.jobs, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if traced and run.trace:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    lines = []
    if run.error:
        lines.append(f"error: {run.error}")
    lines += [f"check {k}: {v!r} (limit {lim!r})" for k, (v, lim) in checks.items()]
    return result, lines, run
