#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``fluid_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero:

1. device   require a CUDA device; print the card's name and power limit
2. build    compile csrc/*.cu with nvcc (ptxas report -> chiprun_out/)
3. kernels  bin a 3D dam of 1,000,000 particles; run each of the five
            kernel wrappers and its plain PyTorch version on the same card
            tensors, at the shapes the main path gives them; compare and time
            both with CUDA events
4. goldens  Session(stream, cuda) from tests/data/golden_{2d,3d}.npz against
            the frozen trajectories at 1e-3 (D=2 and D=3 kernels)
5. slice    Session(stream, cuda) of the 1M dam, 2 frames (62 substeps,
            re-bins included) with every launch counter reset just before:
            conservation, shell_drop == 0, finite state, the fluid falls
            (+y is down), every kernel launched; then one substep of stream
            against dense from the same state, max |dpos| <= 1e-4
6. replay   3D reference scene (4096): snapshot, frame, restore, frame ->
            bit-identical; then ms per frame at that scene

The last lines are the kernel table as JSON, the card line, and
{"ok": true, "device": {...}}.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from fluid_tpu_torch import scene, state, step  # noqa: E402
from fluid_tpu_torch.config import default_2d, default_3d  # noqa: E402
from fluid_tpu_torch.domain import make_domain  # noqa: E402
from fluid_tpu_torch.ops import cuda_build  # noqa: E402
from fluid_tpu_torch.ops import stream_kernels as sk  # noqa: E402
from fluid_tpu_torch.ops import stream_transfer as stx  # noqa: E402
from fluid_tpu_torch.session import Session  # noqa: E402
from fluid_tpu_torch.utils.platform import card_info, require_cuda  # noqa: E402

N_1M = 1_000_000
SOURCE = "fluid_tpu_torch/csrc/stream_kernels.cu"
REPLACES = {
    "deposit_p2g1": "fluid_tpu/ops/stream_transfer.py:676",
    "deposit_p2g2": "fluid_tpu/ops/stream_transfer.py:676",
    "collect": "fluid_tpu/ops/stream_transfer.py:1163",
    "halo_axis": "fluid_tpu/ops/stream_transfer.py:2006",
    "halo_gblk": "fluid_tpu/ops/stream_transfer.py:1882",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, reps: int, device) -> float:
    """Mean time of ``fn`` over ``reps`` calls after one warm-up call: CUDA
    events on the card, the host clock (after a synchronize) elsewhere."""
    fn()
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def dam_1m(device, n: int = N_1M, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return scene.scaled_dam_break(gen, n, dim=3, device=device)


def phase_kernels(device, n: int, card: str, reps: int = 10):
    """Each kernel against its plain version on one binned 1M state.  The
    state gets random velocities and APIC matrices (the seeding
    distributions of tests/data) so every channel carries data."""
    cfg, p, dom = dam_1m(device, n)
    gen = torch.Generator(device=device).manual_seed(1)
    p.vel = 0.3 * torch.randn(p.vel.shape, generator=gen, device=device)
    p.C = 0.05 * torch.randn(p.C.shape, generator=gen, device=device)
    spec = stx.default_spec(cfg, dom, p.n)
    check(int(stx.overflow_count(p.pos, dom, spec, vel=p.vel, dt=cfg.dt)) == 0, "1M scene fits the spec")
    st = stx.bin_particles(p, dom, spec, dt=cfg.dt)
    g = stx.tile_geom(dom, spec)
    D, A = 3, spec.A
    nbr = [st.nbr[i] for i in range(2 * D)]
    params6 = torch.tensor([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                            cfg.pressure_floor, cfg.dynamic_viscosity],
                           dtype=torch.float32, device=device)
    params = stx.collect_params(cfg, *step.no_mouse(), spec.scene_stride, device)
    dtg = sk.gravity_step(cfg.dt, cfg.gravity)

    d1 = sk.deposit_p2g1(st.count, st.tid, st.stream, g)
    m = d1[:, :1].contiguous()
    for d in range(D):
        m = sk.halo_axis(m, nbr[2 * d], nbr[2 * d + 1], g, d)
    d2 = sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g)
    x = d2
    for d in range(D - 1):
        x = sk.halo_axis(x, nbr[2 * d], nbr[2 * d + 1], g, d)
    gblk = sk.halo_gblk(x, m, nbr[4], nbr[5], dtg, g, D - 1)
    m1 = d1[:, :1].contiguous()
    print(f"[kernels] n={p.n} A={A} occupied={int((st.count > 0).sum())} "
          f"need={int(st.need_peak[0])} windows={tuple(d1.shape)} stream={tuple(st.stream.shape)}")

    cases = {
        "deposit_p2g1": (lambda: sk.deposit_p2g1(st.count, st.tid, st.stream, g),
                         lambda: sk.deposit_p2g1_plain(st.count, st.tid, st.stream, g)),
        "halo_axis": (lambda: sk.halo_axis(d2, nbr[0], nbr[1], g, 0),
                      lambda: sk.halo_axis_plain(d2, nbr[0], nbr[1], g, 0)),
        "deposit_p2g2": (lambda: sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g),
                         lambda: sk.deposit_p2g2_plain(st.count, st.tid, st.stream, m, params6, d1, g)),
        "halo_gblk": (lambda: sk.halo_gblk(x, m, nbr[4], nbr[5], dtg, g, D - 1),
                      lambda: sk.halo_gblk_plain(x, m, nbr[4], nbr[5], dtg, g, D - 1)),
        "collect": (lambda: sk.collect(st.count, st.tid, params, st.stream, gblk, g, True),
                    lambda: sk.collect_plain(st.count, st.tid, params, st.stream, gblk, g, True)),
    }
    results = {}
    for name, (kern, plain) in cases.items():
        got, want = kern(), plain()
        sync(device)
        if name == "collect":
            err = float((got[0] - want[0]).abs().max())
            check(err <= 1e-5, f"collect rows max|err| {err} <= 1e-5")
            check(torch.equal(got[1], want[1]), "collect drift flag equal")
            scale = float(want[2].abs().max())
            dep_err = float((got[2] - want[2]).abs().max())
            check(dep_err <= 1e-4 * scale, f"fused p2g1 {dep_err} <= 1e-4 * {scale}")
            unf = sk.collect(st.count, st.tid, params, st.stream, gblk, g, False)
            check(torch.equal(unf[0], got[0]) and torch.equal(unf[1], got[1]),
                  "unfused collect equals the fused one's rows and flag")
            # mouse on at the box centre, packed-scene x walls every 64 cells
            centre = cfg.boundary_clip[1][0] / 2
            pw = stx.collect_params(cfg, *step.mouse((centre, centre)), 64.0, device)
            gw = sk.collect(st.count, st.tid, pw, st.stream, gblk, g, True)
            ww = sk.collect_plain(st.count, st.tid, pw, st.stream, gblk, g, True)
            walls_err = float((gw[0] - ww[0]).abs().max())
            check(walls_err <= 1e-5 and torch.equal(gw[1], ww[1]),
                  f"collect with mouse + scene stride: rows {walls_err} <= 1e-5, flag equal")
            extra = (f" flag_equal=True fused_p2g1_err={dep_err:.3e} (scale {scale:.3e})"
                     f" mouse+stride_err={walls_err:.3e}")
        elif name.startswith("deposit"):
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            check(err <= 1e-4 * scale, f"{name} max|err| {err} <= 1e-4 * max|window| {scale}")
            extra = f" max|window|={scale:.4e}"
        elif name == "halo_gblk":
            err = float((got - want).abs().max())
            rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
            check(rel <= 1e-6, f"halo_gblk relative err {rel} <= 1e-6")
            extra = f" max_rel={rel:.3e}"
        else:
            err = float((got - want).abs().max())
            check(torch.equal(got, want), "halo_axis (m+f) bit-equal")
            mass = sk.halo_axis(m1, nbr[0], nbr[1], g, 0)
            check(torch.equal(mass, sk.halo_axis_plain(m1, nbr[0], nbr[1], g, 0)),
                  "halo_axis (mass) bit-equal")
            extra = " bit_equal=True (CH=3 and CH=1)"
        del got, want
        ms = time_ms(kern, reps, device)
        plain_ms = time_ms(plain, max(2, reps // 5), device)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"[kernels] {name}: max_abs_err={err:.3e}{extra} kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms  [{card}]")
    return results


def phase_goldens(device, card: str) -> None:
    for name, make in (("golden_2d", default_2d), ("golden_3d", default_3d)):
        z = np.load(os.path.join(ROOT, "tests", "data", f"{name}.npz"))
        cfg = make(iterations=int(z["substeps"]))
        p = state.from_numpy(z["pos0"], z["vel0"], z["C0"], device=device)
        sess = Session(cfg, make_domain(cfg), p, backend="stream", device=device)
        sess.frame()
        got = sess.particles()
        worst = 0.0
        for f in ("pos", "vel", "C", "density", "pressure"):
            err = float(np.abs(getattr(got, f).cpu().numpy() - z[f]).max())
            check(err <= 1e-3, f"{name} {f} max|err| {err} <= 1e-3")
            worst = max(worst, err)
        print(f"[goldens] {name}: {int(z['substeps'])} substeps, max|err| {worst:.3e} <= 1e-3  [{card}]")


def rebin_check_cost_ms(sess: Session, device, substeps: int = 8, rounds: int = 3) -> float:
    """Per-substep cost of the frame loop's host read of ``needs_rebin``:
    the same substeps from the session's state, timed with and without the
    read (no re-bin is taken either way), in alternating order."""
    cfg, dom, spec = sess.cfg, sess.domain, sess.spec
    stages = stx.substep_stages(cfg, dom, spec, device, fused=True)
    params = stx.collect_params(cfg, *step.no_mouse(), spec.scene_stride, device)
    st0 = sess.stream_state()

    def run(read: bool) -> float:
        sync(device)
        t0 = time.perf_counter()
        st, dep1 = st0, stages.dep1(st0)
        for _ in range(substeps):
            st, dep1 = stx._substep_core(st, dep1, stages, params)
            if read:
                bool(stx.needs_rebin(st))
        sync(device)
        return time.perf_counter() - t0

    run(True)
    total = {True: 0.0, False: 0.0}
    for _ in range(rounds):
        for read in (True, False, False, True):
            total[read] += run(read)
    return (total[True] - total[False]) * 1e3 / (2 * rounds * substeps)


def phase_slice(device, n: int, card: str, frames: int = 2):
    cfg, p, dom = dam_1m(device, n)
    y0 = float(p.pos[:, 1].mean())
    sess = Session(cfg, dom, p, backend="stream", device=device)
    sync(device)
    sk.reset_launches()
    t0 = time.perf_counter()
    sess.run(frames)  # strict: conservation + shell_drop checked per frame
    sync(device)
    dt_run = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    check(all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    check(sess.live_count() == n, "conservation")
    check(sess.shell_drop() == 0, "shell_drop == 0")
    q = sess.particles()
    for f in state.FIELDS:
        check(bool(torch.isfinite(getattr(q, f)).all()), f"finite {f}")
    y1 = float(q.pos[:, 1].mean())
    check(y1 > y0, f"mean y rose ({y0:.4f} -> {y1:.4f}; +y is down)")
    steps = frames * cfg.iterations
    print(f"[slice] n={n} frames={frames} substeps={steps} {dt_run * 1e3 / frames:.1f} ms/frame "
          f"{n * steps / dt_run:.4e} particle-steps/s rebins={sess.rebins()} "
          f"need_peak={sess.need_peak()} of A={sess.spec.A} mean_y {y0:.3f}->{y1:.3f} "
          f"launches={launches}  [{card}]")

    # steady state: the next frames, timed alone, and the host sync share
    t0 = time.perf_counter()
    sess.run(frames)
    sync(device)
    dt2 = time.perf_counter() - t0
    print(f"[slice] steady frames {frames + 1}..{2 * frames}: {dt2 * 1e3 / frames:.1f} ms/frame "
          f"{n * steps / dt2:.4e} particle-steps/s rebins={sess.rebins()}  [{card}]")
    check(sess.live_count() == n and sess.shell_drop() == 0, "conservation after 4 frames")

    sync_ms = rebin_check_cost_ms(sess, device)
    print(f"[slice] host read of needs_rebin: {sync_ms:.3f} ms per substep "
          f"(same substeps with and without it)  [{card}]")

    # one substep from the same state: stream vs dense
    mid = sess.particles()
    mp, ma = step.no_mouse()
    a = stx.frame(mid, cfg, dom, mp, ma, spec=sess.spec, substeps=1)
    b, _ = step.substep(mid, cfg, dom, mp, ma, backend="dense")
    dpos = float((a.pos - b.pos).abs().max())
    dvel = float((a.vel - b.vel).abs().max())
    check(dpos <= 1e-4, f"stream vs dense max|dpos| {dpos} <= 1e-4")
    print(f"[slice] stream vs dense, one substep: max|dpos| {dpos:.3e} max|dvel| {dvel:.3e}  [{card}]")
    return launches


def phase_replay(device, card: str) -> None:
    cfg, p, dom = scene.reference_scene_3d(seed=0, device=device)
    sess = Session(cfg, dom, p, backend="stream", device=device)
    snap = sess.snapshot()
    sess.frame()
    a = sess.particles()
    sess.restore(snap)
    sess.frame()
    b = sess.particles()
    for f in state.FIELDS:
        check(torch.equal(getattr(a, f), getattr(b, f)), f"replay bit-identical: {f}")
    reps = 5
    sync(device)
    t0 = time.perf_counter()
    sess.run(reps)
    sync(device)
    dt = time.perf_counter() - t0
    print(f"[replay] 3D reference scene (n={p.n}): snapshot replay bit-identical; "
          f"{dt * 1e3 / reps:.2f} ms/frame {p.n * cfg.iterations * reps / dt:.4e} "
          f"particle-steps/s rebins={sess.rebins()}  [{card}]")


def main() -> int:
    device = require_cuda()
    card = card_info()
    print(f"[device] {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    print(card)

    t0 = time.perf_counter()
    cuda_build.load()
    build_s = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_ptxas.txt"), "w") as fh:
        fh.write(cuda_build.build_log)
    print(f"[build] {cuda_build.library_path().name} in {build_s:.1f} s "
          f"(ptxas report: chiprun_out/chip_smoke_ptxas.txt)")

    results = phase_kernels(device, N_1M, card)
    phase_goldens(device, card)
    launches = phase_slice(device, N_1M, card)
    phase_replay(device, card)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], **results[name]}
        for name in sk.KERNELS
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
