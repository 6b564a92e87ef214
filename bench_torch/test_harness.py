"""CPU self-checks of the benchmark's arithmetic, and of its output check
against a broken program.

Run from the root of the repository (the program's CPU path, no card)::

    python -m pytest bench_torch/test_harness.py -q

The repository's own test suite does not collect this file.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_torch import harness, run, work  # noqa: E402

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    return next(c for c in BENCH["workloads"] if c["name"] == name)


def small_files(particles: int):
    """``harness.cell_files`` with the reference scene cut to ``particles``,
    a call of one frame and one untimed frame: a run the CPU holds."""
    orig = harness.cell_files

    def files(bench, c):
        conf, traffic, limits = orig(bench, c)
        conf = json.loads(json.dumps(conf))
        conf["scene"]["particles"] = particles
        traffic = dict(traffic, trace_frames=1)
        if traffic["driver"] == "batch":
            traffic.update(frames_per_call=1, setup_frames=min(traffic["setup_frames"], 1))
        return conf, traffic, limits

    return files


def test_rate_is_all_work_over_all_time():
    r = SimpleNamespace(n=1000, substeps=31, frames=90, window_s=12.5)
    assert harness.metric_reader("particle_steps_per_s")(r) == 1000 * 31 * 90 / 12.5
    assert harness.metric_reader("frame_ms")(r) == 12.5 / 90 * 1e3


def test_p95_is_over_every_frame():
    lat = [0.001] * 180 + [0.1] * 20  # one frame in ten is slow
    r = SimpleNamespace(latencies=lat)
    assert harness.metric_reader("frame_ms_p95")(r) == pytest.approx(100.0)
    assert harness.metric_reader("frame_ms_p95")(SimpleNamespace(latencies=lat[:180])) == 1.0
    assert (harness.metric_reader("frame_ms_p95")(r)
            == statistics.quantiles(lat, n=100)[94] * 1e3)


def test_work_count_is_independent_of_the_layout():
    """The least time takes particles and occupied cells only, and the
    cells come out the same from two layouts of one scene."""
    assert list(inspect.signature(work.least_seconds).parameters) == ["D", "n", "c"]
    from fluid_tpu_torch.ops.stream_transfer import StreamSpec
    from fluid_tpu_torch.session import Session

    conf = harness.load_json(harness.HERE / "configs" / "dam3d-ref.json")
    cfg, dom, (p,) = harness.build_scenes(conf, 5, 1, torch.device("cpu"))
    cells = []
    for spec in (StreamSpec(tile=4, cap=128, halo=2, active=2048),
                 StreamSpec(tile=8, cap=1024, halo=2, active=512)):
        sess = Session(cfg, dom, p, backend="stream", spec=spec, device="cpu")
        cells.append(work.occupied_cells(sess.particles().pos, conf["physics"]["walls"]))
    assert cells[0] == cells[1] > 0
    a = work.least_seconds(3, p.n, cells[0])
    assert a == work.least_seconds(3, p.n, cells[1]) > 0
    # bytes-bound at these sizes: twice the particles and cells, twice the time
    assert work.least_seconds(3, 2 * p.n, 2 * cells[0]) == pytest.approx(2 * a, rel=1e-12)


def test_the_seed_repeats_the_drags_and_the_dams():
    app = harness.load_module("drivers", "app")
    drag = {"share": 0.5, "frames": [10, 60], "set": 16, "set_seed": 0}
    a = app.drag_schedule(7, drag, [64.0, 64.0], 20_000)
    assert a == app.drag_schedule(7, drag, [64.0, 64.0], 20_000)
    b = app.drag_schedule(8, drag, [64.0, 64.0], 20_000)
    assert a != b
    assert abs(sum(x is not None for x in a) / len(a) - 0.5) < 0.1
    # every seed sends the same set of drags, in another order
    cycle = sum(len(p) for p in app.drag_set(drag, [64.0, 64.0]))
    assert (sorted(filter(None, app.drag_schedule(7, drag, [64.0, 64.0], cycle)))
            == sorted(filter(None, app.drag_schedule(8, drag, [64.0, 64.0], cycle))))
    assert all(0.0 <= x <= 64.0 and 0.0 <= y <= 64.0 for x, y in filter(None, a))
    conf = harness.load_json(harness.HERE / "configs" / "dam3d-1m.json")
    conf["scene"]["particles"] = 2000
    seed = 2**31 + 99  # past 32 signed bits
    _, _, d1 = harness.build_scenes(conf, seed, 4, torch.device("cpu"))
    _, _, d2 = harness.build_scenes(conf, seed, 4, torch.device("cpu"))
    assert all(torch.equal(x.pos, y.pos) for x, y in zip(d1, d2))
    assert not torch.equal(d1[0].pos, d1[1].pos)


def test_no_card_no_result():
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", "dam3d-ref.headless", "--seed", "1", "--seconds", "1"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert rc != 0 and out.getvalue() == ""


def test_last_line_keys(monkeypatch):
    monkeypatch.setattr(harness, "cell_files", small_files(1000))
    result, lines, _ = harness.run_cell(BENCH, cell("dam3d-ref.interactive"), 3, 0.0, False,
                                        torch.device("cpu"), 0.0)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) <= {"setup_s", "frame_ms", "frame_ms_p95"}
    assert {"setup_s", "frame_ms"} <= set(result["metrics"])
    assert result["correct"] is True, lines
    assert set(result["checks"]) == set(harness.load_json(
        harness.HERE / "limits" / "dam3d-ref.interactive.json"))
    assert lines[-1].startswith("check ")
    json.dumps(result)


# -- the output check against a broken program ----------------------------------


def _noop(sess):
    """A frame that returns its state unchanged."""
    sess.frame_graph.run = lambda: None


def _half(sess):
    """Half the particles (those of even id) left where they were."""
    fg, orig = sess.frame_graph, sess.frame_graph.run
    D = sess.dim
    id_row = 2 * D + D * D + 1

    def run_half():
        st = sess.stream_state()
        before = _rows_by_id(st, id_row, sess.n)
        orig()
        A, F, cap = st.stream.shape
        rows = st.stream.permute(0, 2, 1)  # a view: [A, cap, F]
        valid = torch.arange(cap)[None, :] < st.count[:, None]
        ids = rows[..., id_row].to(torch.int64)
        keep = valid & (ids % 2 == 0)
        rows[keep] = before[ids[keep]]

    fg.run = run_half


def _rows_by_id(st, id_row, n):
    A, F, cap = st.stream.shape
    rows = st.stream.permute(0, 2, 1)
    valid = torch.arange(cap)[None, :] < st.count[:, None]
    out = torch.zeros((n, F))
    out[rows[..., id_row][valid].to(torch.int64)] = rows[valid]
    return out


def _one(sess):
    """One particle's position moved by a cell where it is produced."""
    fg, orig = sess.frame_graph, sess.frame_graph.run

    def run_one():
        orig()
        st = sess.stream_state()
        t = int(torch.nonzero(st.count > 0)[0, 0])
        st.stream[t, 0, 0] += 1.0

    fg.run = run_one


def _tail(sign=1.0, scale=1.0, radius=1.0):
    """The stream path's particle tail (``stream_kernels._particle_tail``,
    the CPU's version of K3's) with the mouse impulse's sign, size or
    radius changed."""
    from fluid_tpu_torch.ops import stream_kernels

    orig = stream_kernels._particle_tail

    def tail(newpos, v, params, x_shift):
        mx, my, r = params[8], params[9], params[5] * radius
        dx, dy = newpos[0] - mx, newpos[1] - my
        d2 = dx * dx + dy * dy
        nrm = torch.sqrt(d2)
        inv = torch.where(nrm > 0.0, 1.0 / torch.where(nrm > 0.0, nrm, 1.0), 0.0)
        hit = (params[7] > 0.0) & (d2 < r * r)
        v[0] = v[0] + torch.where(hit, sign * scale * dx * inv, 0.0)
        v[1] = v[1] + torch.where(hit, sign * scale * dy * inv, 0.0)
        off = params.clone()
        off[7] = 0.0  # the walls as the program has them, the mouse done above
        orig(newpos, v, off, x_shift)

    return tail


@pytest.mark.parametrize("change", [dict(sign=-1.0), dict(scale=1.5), dict(radius=0.7)],
                         ids=["sign", "scale", "radius"])
def test_a_wrong_mouse_impulse_is_not_correct(monkeypatch, change):
    """The app cell's mouse check frame sees the impulse's sign, size and
    radius (the same tail with nothing changed passes)."""
    from fluid_tpu_torch.ops import stream_kernels

    monkeypatch.setattr(harness, "cell_files", small_files(1000))
    monkeypatch.setattr(stream_kernels, "_particle_tail", _tail())
    result, lines, _ = harness.run_cell(BENCH, cell("dam3d-ref.interactive"), 13, 0.0, False,
                                        torch.device("cpu"), 0.0)
    assert result["correct"] is True, lines
    monkeypatch.setattr(stream_kernels, "_particle_tail", _tail(**change))
    result, lines, _ = harness.run_cell(BENCH, cell("dam3d-ref.interactive"), 13, 0.0, False,
                                        torch.device("cpu"), 0.0)
    assert result["correct"] is False, lines
    assert any(k.startswith("mouse_") and v["value"] > v["limit"]
               for k, v in result["checks"].items()), lines


@pytest.mark.parametrize("name,fault", [
    ("dam3d-ref.headless", _noop), ("dam3d-ref.headless", _half), ("dam3d-ref.headless", _one),
    ("dam3d-ref.interactive", _noop), ("dam3d-ref.interactive", _half),
], ids=["headless-unchanged", "headless-half", "headless-one", "interactive-unchanged",
        "interactive-half"])
def test_a_broken_program_is_not_correct(monkeypatch, name, fault):
    """Each fault a cell's numbers can see: the interactive cell holds
    percentiles alone (its largest gaps swing with the splashes the drags
    leave), so one altered particle is for the batch cells' largest gaps."""
    monkeypatch.setattr(harness, "cell_files", small_files(1000))
    result, lines, _ = harness.run_cell(BENCH, cell(name), 11, 0.0, False, torch.device("cpu"),
                                        0.0, faults=fault)
    assert result["correct"] is False, lines


def test_a_sound_program_is_correct(monkeypatch):
    monkeypatch.setattr(harness, "cell_files", small_files(1000))
    result, lines, _ = harness.run_cell(BENCH, cell("dam3d-ref.headless"), 11, 0.0, False,
                                        torch.device("cpu"), 0.0)
    assert result["correct"] is True, lines
