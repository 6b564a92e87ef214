#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``fluid_tpu_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printing its own line; any failure raises and exits non-zero.
A Session on the card runs each frame as one captured CUDA graph
(``utils/graph.py``), so its replayed frames call no kernel wrapper: the
launches of a replayed frame are counted from the graph's kernel nodes
(those of an IF node's body times the bodies the card fired), witnessed
by torch.profiler's kernel events, and held against the wrappers'
counters over the same frame run eagerly (``replay_launches``).

1. device   require a CUDA device; print the card's name and power limit
2. build    build and load every launching module's kernel library at
            once (ops/cuda_build.py: one nvcc per source, then one link a
            library); prints each library's steps' wall seconds (the ptxas
            report goes to the output directory); then, in a fresh process,
            a stream Session frame loads the graph and stream libraries
            only
3. kernels  bin a 3D dam of 1,000,000 particles (and a 2D dam of
            100,000); run each of the five stream kernel wrappers and its
            plain PyTorch version on the same card tensors, at the shapes
            the main path gives them; compare and time both with CUDA
            events.  The mass halo (CH=1, the D passes) must be bit-equal
            to the gated chain of plain passes, also through the general
            kernel (a window geometry with E != 2T, with 1 and D
            channels); halo_gblk matches its plain version (v rows 1e-6
            relative, the mass row and the zero-count tiles equal), also at
            E != 2T; the deposits and the collect are bit-equal across two
            launches; the collect is timed as the frame launches it, into
            the state's own stream and flag; a copy of the halo output's
            size is timed beside it.  The collect in place on the 1M dam at
            caps 128 and 256 (every tile), the slots past each tile's count
            and every flag seeded with a sentinel: rows within 1e-5 of
            plain, flags equal, the sentinel untouched past the count,
            bit-equal to the out-of-place launch and across two launches.
            The same checks at cap 256 on tiles past one collect chunk (128
            slots), which K3 walks chunk by chunk: the 2D reference scene
            after the app's centroid mouse frame, and a 3D dam packed 2x.
            Then the deposits, halo_gblk and the collect, checked the
            same way, at 3D specs whose blocks need more than 48 KB of
            shared memory (cap 256; tile 8 at caps 128 and 256) and at caps
            past 256, walked in chunks of 256 slots (the collect: 128), on
            the whole 1M dam
            (tile 8 at cap 1024, timed; tile 4 at cap 512)
   rebin    the re-bin's kernels (csrc/rebin_kernels.cu) on the 1M dam at
            the benchmark's layout (T=4, cap 256, A = every tile) after 40
            frames and on the 3D reference scene after 10, each a strict
            captured Session, then eager substeps to one whose drift flags
            ask for a re-bin: rebin_gather's rows and keys bit-equal to its
            plain version's; one re-bin in place through the kernels
            bit-equal to the same re-bin through the plain versions
            (stream, count, tid, flag, nbr, watermarks, counter, and K1's
            p2g_1 written into the frame's windows); every IF body of the
            captured frame one node each of K1, rebin_gather and
            rebin_fill; the next replayed frame bit-equal to the eager
            frame; each kernel, its plain version and the whole body
            (eager, and 20 bodies in one graph) timed beside the byte bounds
   digests  at cap 256 (one chunk) K1, K4, K2, K5 and K3 give the outputs
            recorded from the kernels before the chunked walk, bit for bit,
            and K3's stream and flag those of the unfused collect then
            (tests/data/stream_kernels_cap256.json)
4. pallas kernels
            the four pallas kernels (p2g1 deposit, force deposit, fused
            p2g2, collect) against their plain versions at the 3D 1M dam
            (default TileSpec: T=4, cap=384, A = 32,768) and a 2D dam of
            100,000 particles, and the three deposits at T=8, cap 1024 on
            the 1M dam (tiles walked in several chunks); compared and timed
            the same way, the deposits bit-equal across two launches
   pallas digests
            K6, K6f and K7 give the blocks recorded from the cell-owner-scan
            kernels they replaced, bit for bit, in 3D at T=4 cap 384 and
            T=8 cap 1024 on the 1M dam and in 2D at T=4
            (tests/data/pallas_kernels_digests.json)
5. goldens  Session(stream) and Session(pallas) from
            tests/data/golden_{2d,3d}.npz against the frozen trajectories at
            1e-3 (D=2 and D=3 kernels)
6. slice    Session(stream, cuda) of the 1M dam, captured by compile_run,
            2 replayed frames (62 substeps, re-bins included) calling no
            wrapper: conservation, shell_drop == 0, finite state, the fluid
            falls (+y is down); the launches of replayed frame 3 (graph
            nodes, profiler witnessing) equal those of the same frame run
            eagerly (counters): K2-K5 once per substep, K1, rebin_gather
            and rebin_fill once per re-bin (K1 once more); a steady frame; one
            substep of stream against dense from the same state, max |dpos|
            <= 1e-4
7. pallas slice
            Session(pallas) of the 1M dam built with no device argument (the
            entry points default to the card), captured, 1 replayed frame
            (31 substeps) calling no wrapper: no overflow before and after,
            mass conserved, finite state, the fluid falls; replayed frame
            2's launches (graph nodes, profiler witnessing) equal the eager
            frame's, K6, K7, K8 once per
            substep; then one substep of pallas against dense from the same
            state, max |dpos| <= 1e-4
   graph    the frame as one CUDA graph: a graph with one IF node
            (csrc/graph_if.cu) probed, with the CUDA runtime and NVIDIA
            driver versions; graph against eager (compile_run changes
            nothing; median ms per frame, peak memory, capture and
            instantiation seconds, one profiled frame of each path) for
            stream at the 1M dam (1 + 5 frames, bit-equal), then on the
            same session run(5) equals 5 eager frame_binned frames with
            re-bins fired inside the replays, two frames with the mouse
            moved between replays and no recapture, a replayed frame
            under set_sync_debug_mode("error") (the eager frame syncs);
            stream and pallas (bit-equal) and dense (its first frame
            within 1e-4) at the 3D reference scene (1 + 20 frames), and
            pallas at the 1M dam (1 + 5); each cell's wall seconds
   big tile a strict Session(stream) of the 1M dam at bench.py's
            big-tile spec (T=8, cap=1024), captured: frame 1 profiled
            (every kernel launched), frame 2 timed, one substep from it
            against dense (1e-4), a T=4 session beside it
   backends the tiled and sorted backends (plain PyTorch, no kernel of
            csrc/) on bench.py's tiled cells 2d-ref, 3d-ref, 2d-100k (tiled
            under bench.py's tiled budget) and, sorted only, the 1M dam: no
            overflow before and after, one substep against dense (1e-4,
            grid mass n), the cell's frames through the Session's graph
            against the same frames run eagerly (bit-equal; 20 at 2d-ref
            and 3d-ref, as graph_vs_eager above), finite state, snapshot
            replay bit-identical, no stream or pallas launch; a profiled
            eager substep
8. replay   3D reference scene (4096), stream and pallas: snapshot, frame,
            restore, frame -> bit-identical; then ms per frame at that scene
   render   the console render's kernel (csrc/render_kernels.cu) bit-equal
            to its plain version, histogram_xy, on the same card tensors, at
            the app's view, a (70, 50) viewport at a 60x30 console, a 128x96
            console (the largest shared-memory grid) and a 200x80 console
            (past it), twice into one grid:
            the 2D and 3D reference scenes after the centroid mouse frame
            and 200 drag frames (and the Session's render lines), the 2D
            scene with garbage in its dead slots and with x shifted (the
            sharded render), points on every console cell edge and the
            viewport's far edge, the 1M dam after 40 frames; a replayed
            render's device events counted (one memset, one kernel, one
            copy); then untraced, the host ms of one render and its parts
            (histogram, read, ascii), the launch and read against one replay
            of a captured graph of both, and the kernel's and the plain
            version's ms
9. app      the app through its entry points, no device argument: the 3D
            reference scene on the default (stream) backend for 3 headless
            frames, plain and with the timing overlay, every stream kernel
            launched (profiler), three 40x80 renders, the overlay's labels
            (the frame's device time, its re-bins' device time and count,
            the idle time under render, check and sync, from the
            recorder); then ``app.main`` on the pallas backend in 2D, K6, K7
            and K8 launched (profiler);
            ``app.main --backend tiled`` and ``--backend sorted`` in 2D, 3
            frames, no kernel launched; ``app.main --shards 1`` in 3D, K1-K5
            launched
   trace    the recorder's device stamps (utils/timing.py): on the strict
            1M dam (cap 256) and the 3D reference scene, 2 + 2 x (re-bins
            fired) stamps in every replayed frame and run, against the
            card's rebins counter; in a process of its own, a profiled run
            of the 1M dam: each stamp within 20 us of its kernel's start by
            the profiler (the tightest of a few spins ties the clocks),
            frame and re-bin lengths within 1% or 5 us, the clock fit's
            residual; whether an IF body takes an event record node
10. batch   64 scenes of 4,096 particles (bench.py's batch-64), packed side
            by side into one 4608x72x72 domain (stride 72, 373,248 tiles,
            A = 110,000), each particle in its own scene's coordinates: a
            strict Session(stream) on the packed domain with its default
            spec, one warm frame (the capture) and 3 timed frames,
            conservation, shell_drop 0, need_peak against A, finite state,
            each scene inside its own walls and falling; K1-K3 and the
            re-bin's gather at the packed geometry against their plain
            versions; one substep of 8 scenes against dense on each scene
            alone (x, y and z within 1e-4); then each
            kernel timed on the packed state and on the state cut to the
            entries that hold or relay particles (the share of kernel time
            spent on the unused, zero-count entries); a profiled frame, every
            stream kernel launched in it
11. shards  the sharded stream backend (parallel/stream_shard.py) on the 1M
            dam as s = 1, 2, 4 x-slabs, every shard on this card: the
            ghost-gated K4 mass and K5 launches against their plain versions
            at one shard's shapes after the first exchange (K4 bit-equal, K5
            as halo_gblk above with the gate for the count), one substep
            against the single-device stream path (1e-4), two strict frames
            (conservation, shell_drop 0, re-bins, migrants, finite, one K4
            mass and one K5 launch per shard and substep), ms per frame
            beside the single-device Session's, exchange bytes per substep,
            a profiled frame at each s
12. checkpoint
            a 3D reference-scene Session(stream), 2 frames, saved and loaded
            (no device argument); a Session from the loaded state and one
            from the state in memory run a frame bit-identically;
            diagnostics finite
13. profile one 1M frame of each backend under torch.profiler: wall and
            device time, the largest device entries
14. micro   the micro-benchmark kernels M1-M4 (csrc/micro_kernels.cu) in
            every kind at the bench/micro_*.py scripts' shapes (ng = 4096
            groups of 8 tiles of 128): each against its plain version
            (copies bit-equal, contractions within 1e-5 x max|plain|),
            timed beside its plain version, the one PyTorch call of the
            same function (a copy, or a full-fp32 einsum) and its bound;
            then the main() of each port
            module of fluid_tpu_torch/micro/ once, counters set to 0 just
            before and read just after, every micro kernel launched there
   micro b1 the stream-probe kernels M5-M8 (csrc/micro_stream.cu) in every
            case of bench/micro_kernels.py's CASES and run_tb2/3/4 at its
            n = 1,000,000 (A = 15,625 tiles; row-major, slot-major, block
            and grouped streams): each against its plain version (fills
            bit-equal, contractions within 1e-5 x max|plain|), timed beside
            its plain version, one PyTorch call of the same function (a
            copy_ of the first values over the output, or a full-fp32
            einsum) and its bound; then micro_kernels.main() over every
            group, counters set to 0 just before and read just after, each
            of M5-M8 launched there
   micro b6 the construct-probe kernels M9-M11 (csrc/micro_probe.cu) on each
            probe p1-p13 of bench/micro_zfac_probe.py (one-block [1, ...]
            operands, seeded normal): each against its plain version (M9
            and p13 bit-equal, p10 within 1e-6 x max|plain|, p2, p5, p6
            and p7 within 1e-5: ops/micro_probe.py Probe.tol), timed beside
            its plain version, one PyTorch call of the same function where
            there is one, its bound and the launch of an empty one-thread
            kernel; then micro_zfac_probe.main(), counters set to 0 just
            before and read just after: exit 0, the script's thirteen
            lines with its sums, each of M9-M11 launched there

The last lines are the kernel table as JSON (the five stream kernels, the
re-bin's two and the four pallas kernels, the console histogram (on_path
"app render", its launches a render counted by the profiler), then the
micro kernels: time,
plain time, the least
time the card could take, launches in one replayed frame of the main path
(slice, pallas slice) with how they were counted (launches_from) and the
profiler's kernel events in that frame; K4 and K5 list their
launch kinds, the sharded path's ghost-gated ones with on_path "shards";
K1-K3 their big-tile kind, T=8 at cap 1024, on_path "stream big-tile";
K6, K6f, K7 theirs, on no path; the micro kernels M1-M11 with on_path false,
their launches counted over the micro entry points' run, launches_per_frame
counted over the slice and pallas slice phases (checked 0), and every kind
under kinds),
the card line, and
{"ok": true, "device": {...}}.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from fluid_tpu_torch import app, checkpoint, diagnostics, render, scene, state, step  # noqa: E402
from fluid_tpu_torch.config import default_2d, default_3d  # noqa: E402
from fluid_tpu_torch.domain import make_domain  # noqa: E402
from fluid_tpu_torch.micro import micro_dma, micro_pb, micro_sep, micro_zfac  # noqa: E402
from fluid_tpu_torch.micro import micro_kernels as mkb  # noqa: E402
from fluid_tpu_torch.micro import micro_zfac_probe as zfp  # noqa: E402
from fluid_tpu_torch.ops import cuda_build  # noqa: E402
from fluid_tpu_torch.ops import micro_kernels as mk  # noqa: E402
from fluid_tpu_torch.ops import micro_probe as mp  # noqa: E402
from fluid_tpu_torch.ops import micro_stream as mst  # noqa: E402
from fluid_tpu_torch.ops import pallas_kernels as pk  # noqa: E402
from fluid_tpu_torch.ops import pallas_transfer as tpt  # noqa: E402
from fluid_tpu_torch.ops import stream_kernels as sk  # noqa: E402
from fluid_tpu_torch.ops import stream_transfer as stx  # noqa: E402
from fluid_tpu_torch.ops import tiled_transfer as tt  # noqa: E402
from fluid_tpu_torch.parallel import stream_shard as tsh  # noqa: E402
from fluid_tpu_torch.session import Session  # noqa: E402
from fluid_tpu_torch.utils import graph as graph_mod  # noqa: E402
from fluid_tpu_torch.utils.timing import recorder  # noqa: E402
from fluid_tpu_torch.utils.platform import card_info, require_cuda  # noqa: E402

N_1M = 1_000_000
N_2D = 100_000
# every launching module's kernel library (ops/cuda_build.py)
LIBRARIES = (graph_mod.LIBRARY, sk.LIBRARY, pk.LIBRARY, mk.LIBRARY, mst.LIBRARY, mp.LIBRARY)
REBIN_KERNELS = ("rebin_gather", "rebin_fill")
SOURCE = {name: "fluid_tpu_torch/csrc/stream_kernels.cu" for name in sk.KERNELS}
SOURCE.update({name: "fluid_tpu_torch/csrc/rebin_kernels.cu" for name in REBIN_KERNELS})
SOURCE.update({name: "fluid_tpu_torch/csrc/pallas_kernels.cu" for name in pk.KERNELS})
REPLACES = {
    "deposit_p2g1": "fluid_tpu/ops/stream_transfer.py:676",
    "deposit_p2g2": "fluid_tpu/ops/stream_transfer.py:676",
    "collect": "fluid_tpu/ops/stream_transfer.py:1163",
    "halo_axis": "fluid_tpu/ops/stream_transfer.py:2006",
    "halo_gblk": "fluid_tpu/ops/stream_transfer.py:1882",
    **{name: "none: XLA glue (fluid_tpu/ops/stream_transfer.py:2346 _bin_rows, :2956 _rebin_full)"
       for name in REBIN_KERNELS},
    "pallas_deposit_p2g1": "fluid_tpu/ops/pallas_transfer.py:160",
    "pallas_deposit_force": "fluid_tpu/ops/pallas_transfer.py:160",
    "pallas_p2g2": "fluid_tpu/ops/pallas_transfer.py:428",
    "pallas_collect": "fluid_tpu/ops/pallas_transfer.py:272",
}
PALLAS_ON_PATH = ("pallas_deposit_p2g1", "pallas_p2g2", "pallas_collect")

# The card's peaks (H100 SXM data sheet, at its 700 W limit): HBM bytes/s
# and fp32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
F32 = 4


def bound(nbytes: float, ops: float):
    """The least time the card could take (ms) and what bounds it: bytes
    over the memory rate or fp32 operations over the fp32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def particle_ops(kind: str, D: int, valid: int, taps: int | None = None) -> int:
    """fp32 adds and multiplies of the direct tap form for ``valid``
    particles and ``taps`` window taps (3^D a particle unless given), the
    same count for the stream and the pallas kernel of one function:
    stencil 10 per axis; a tap weight D-1; p2g1
    mass and APIC momentum 2(1+D) + 2D^2; the eq-16 force 2D + 2D^2;
    density gather 2 + (D-1); EOS 10, stress 6D^2; g2p 2 + 2D + 2D^2 and
    the particle tail 8D + 20."""
    stencil, w = 10 * D, D - 1
    per = {  # (per tap, per particle)
        "p2g1": (w + 2 * (1 + D) + 2 * D * D, stencil + 4 * D * D),
        "force": (w + 2 * D + 2 * D * D, stencil),
        "p2g2": (2 * w + 2 + 2 * D + 2 * D * D, stencil + 10 + 6 * D * D),
        "collect": (w + 2 + 2 * D + 2 * D * D, stencil + 10 + 2 * D * D + 8 * D + 20),
    }[kind]
    return (valid * 3**D if taps is None else taps) * per[0] + valid * per[1]


def stream_bounds(st, g, D: int, entries: int) -> dict:
    """(bytes, ops) of each stream kernel on this state, launched over its
    first ``entries`` entries (the state's ``occupied`` as the frame
    launches them, or A with no count): each input read once (only the
    valid slots of the stream, only the windows of occupied tiles where an
    empty tile reads none; the count, the tile id and the face tables of
    the entries launched), each output written once (the windows of the
    entries launched; the collect's stream and flag: only the valid slots,
    in place).  The mass halo (CH = 1, the D passes) reads the occupied
    input windows (the gate) and adds two terms per pass to each output
    value.  halo_gblk reads the occupied m+f and mass windows, writes each
    grid-value window launched, and at occupied tiles adds two terms per
    pass and divides and adds once per v value."""
    n, nc = entries, g.ncell
    valid = int(st.count.sum())
    occ = int((st.count > 0).sum())
    tiles = 2 * n * F32
    return {
        "deposit_p2g1": (valid * (2 * D + D * D + 1) * F32 + tiles + n * (1 + D) * nc * F32,
                         particle_ops("p2g1", D, valid)),
        "deposit_p2g2": (valid * (D + D * D + 1) * F32 + occ * (2 + D) * nc * F32 + tiles
                         + n * D * nc * F32,
                         particle_ops("p2g2", D, valid) + occ * D * nc),
        "collect": (valid * (D + 2) * F32 + occ * (1 + D) * nc * F32 + tiles
                    + (valid * (g.F + 1) + n * (1 + D) * nc) * F32,
                    particle_ops("collect", D, valid) + particle_ops("p2g1", D, valid)),
        "halo_mass": ((occ + n) * nc * F32 + (1 + 2 * D) * n * F32, 2 * D * n * nc),
        "halo_gblk": ((occ * (D + 1) * nc + n * (1 + D) * nc + (1 + 2 * D) * n) * F32,
                      occ * D * nc * (2 * D + 2)),
    }


def pallas_bounds(act_count, g, D: int) -> dict:
    """(bytes, ops) of each pallas kernel on this binning, counted as in
    ``stream_bounds``; stream columns are read for min(count, cap)
    particles of each tile."""
    A, nc = act_count.shape[0], g.ncell
    valid = int(act_count.clamp_max(g.cap).sum())
    occ = int((act_count > 0).sum())
    tiles = 3 * A * F32
    return {
        "pallas_deposit_p2g1": (valid * pk.stream_rows(D) * F32 + tiles + A * nc * (1 + D) * F32,
                                particle_ops("p2g1", D, valid)),
        "pallas_deposit_force": (valid * pk.stream_rows(D, "force") * F32 + tiles + A * nc * D * F32,
                                 particle_ops("force", D, valid)),
        "pallas_p2g2": (valid * (D + D * D + 1) * F32 + occ * nc * F32 + tiles + A * nc * D * F32,
                        particle_ops("p2g2", D, valid)),
        "pallas_collect": (valid * (D + 1) * F32 + occ * (1 + D) * nc * F32 + tiles
                           + A * pk.slot_rows(D) * g.cap * F32,
                           particle_ops("collect", D, valid)),
    }


def load_libraries() -> None:
    """Build (where not built yet) and load every kernel library, all at
    once."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(lambda lib: lib.load(), LIBRARIES))


def session_libraries() -> None:
    """Print the kernel libraries this process has loaded after one frame
    of a stream Session of the 3D reference scene on the card (run in a
    fresh process)."""
    cfg, p, dom = scene.reference_scene_3d(seed=0, device=require_cuda())
    Session(cfg, dom, p, backend="stream").frame()
    torch.cuda.synchronize()
    print(" ".join(sorted(cuda_build.LOADED)))


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


def graph_ms(fn, device, launches: int = 20, reps: int = 10) -> float:
    """Device time of one call of ``fn`` (ms): ``launches`` calls captured in
    one CUDA graph (after a warm-up call on a side stream), the graph
    replayed ``reps`` times after one untimed replay, by CUDA events; no
    host work between the kernels, unlike ``time_ms``'s eager calls."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    sync(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / (reps * launches)


def dam_1m(device, n: int = N_1M, seed: int = 0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return scene.scaled_dam_break(gen, n, dim=3, device=device)


def stream_state(device, n: int, dim: int, tile: int = 0, cap: int = 0, keep: int = 1,
                 rng_device=None, squeeze: float = 1.0):
    """A dam of ``n`` particles with random velocities and APIC matrices
    (the seeding distributions of tests/data, so every channel carries
    data), binned for the stream kernels: by the default spec, or, with
    ``tile`` and ``cap``, by a spec of that tile edge and cap over every
    tile, keeping every ``keep``-th particle so the tiles fit the cap, and
    with ``squeeze`` > 1 packing the dam into 1/squeeze of its height (to
    its bottom, +y), so tiles hold ``squeeze`` times the particles.  The
    random numbers come from generators on ``rng_device`` (default:
    ``device``); "cpu" gives the same particles on any card."""
    rng = device if rng_device is None else torch.device(rng_device)
    gen = torch.Generator(device=rng).manual_seed(0)
    cfg, p, dom = scene.scaled_dam_break(gen, n, dim=dim, device=rng)
    if keep > 1 or squeeze != 1.0:
        pos = p.pos[::keep].clone()
        if squeeze != 1.0:
            bottom = pos[:, 1].max()
            pos[:, 1] = bottom - (bottom - pos[:, 1]) / squeeze
        p = state.ParticleState.create(pos, device=rng)
    gen = torch.Generator(device=rng).manual_seed(1)
    p.vel = 0.3 * torch.randn(p.vel.shape, generator=gen, device=rng)
    p.C = 0.05 * torch.randn(p.C.shape, generator=gen, device=rng)
    p = p.to(device)
    spec = stx.default_spec(cfg, dom, p.n)
    if tile:
        spec = dataclasses.replace(spec, tile=tile, cap=cap,
                                   active=int(np.prod([s // tile for s in dom.shape])))
    check(int(stx.overflow_count(p.pos, dom, spec, vel=p.vel, dt=cfg.dt)) == 0,
          f"{dim}D scene fits the spec")
    return cfg, spec, stx.bin_particles(p, dom, spec, dt=cfg.dt), stx.tile_geom(dom, spec)


def deposit_params(cfg, device) -> torch.Tensor:
    """p2g2's params: [dt, rest_density, eos_stiffness, eos_power, floor, mu]."""
    return torch.tensor([cfg.dt, cfg.rest_density, cfg.eos_stiffness, cfg.eos_power,
                         cfg.pressure_floor, cfg.dynamic_viscosity],
                        dtype=torch.float32, device=device)


def check_gblk(got, want, count, what: str) -> float:
    """halo_gblk against its plain version: the v rows within 1e-6
    relative, the mass row and the zero-count tiles equal; returns the
    largest relative error."""
    D = got.shape[1] - 1
    rel = float(((got[:, :D] - want[:, :D]).abs() / want[:, :D].abs().clamp_min(1e-30)).max())
    check(rel <= 1e-6, f"{what} halo_gblk v rows relative err {rel} <= 1e-6")
    check(torch.equal(got[:, D], want[:, D]), f"{what} halo_gblk mass row equal")
    empty = count == 0
    check(int(torch.count_nonzero(got[empty])) == 0 and torch.equal(got[empty], want[empty]),
          f"{what} halo_gblk zero at the {int(empty.sum())} zero-count tiles")
    return rel


def phase_kernels(device, card: str, reps: int = 10, sizes=((3, N_1M), (2, N_2D))):
    """Each stream kernel against its plain version on one binned state at
    the main path's shapes: the 3D 1M dam (whose times go into the kernel
    table) and a 2D dam of 100,000 (the D=2 instantiations), both as the
    frame launches them, bounded by the state's ``occupied`` and compared
    below it (the windows past it are undefined).  The mass halo is
    bit-equal to the gated chain of plain passes, also through the general
    kernel at E != 2T with 1 and D channels, and halo_gblk matches its
    plain version (check_gblk); the deposits and the collect give bit-equal
    outputs when launched twice on the same inputs."""
    results = {}
    for dim, n in sizes:
        cfg, spec, st, g = stream_state(device, n, dim)
        D = dim
        nbr, o = st.nbr, st.occupied
        occ = int(o[0])
        params6 = deposit_params(cfg, device)
        params = stx.collect_params(cfg, *step.no_mouse(), device)
        dtg = sk.gravity_step(cfg.dt, cfg.gravity)

        d1 = sk.deposit_p2g1(st.count, st.tid, st.stream, g, occupied=o)
        m1 = d1[:, :1].contiguous()
        m = sk.halo_axes(m1, st.count, nbr, g, occupied=o)
        d2 = sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g, occupied=o)
        gblk = sk.halo_gblk(d2, m, st.count, nbr, dtg, g, occupied=o)
        print(f"[kernels] {dim}D n={n} A={spec.A} occupied={occ} "
              f"need={int(st.need_peak[0])} windows={tuple(d1.shape)} stream={tuple(st.stream.shape)}")
        cases = {
            "deposit_p2g1": (lambda: sk.deposit_p2g1(st.count, st.tid, st.stream, g, occupied=o),
                             lambda: sk.deposit_p2g1_plain(st.count, st.tid, st.stream, g, o)),
            "halo_mass": (lambda: sk.halo_axes(m1, st.count, nbr, g, occupied=o),
                          lambda: sk.halo_axes_plain(m1, st.count, nbr, g, occupied=o)),
            "deposit_p2g2": (lambda: sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g,
                                                     occupied=o),
                             lambda: sk.deposit_p2g2_plain(st.count, st.tid, st.stream, m, params6,
                                                           d1, g, o)),
            "halo_gblk": (lambda: sk.halo_gblk(d2, m, st.count, nbr, dtg, g, occupied=o),
                          lambda: sk.halo_gblk_plain(d2, m, st.count, nbr, dtg, g, occupied=o)),
            "collect": (lambda: sk.collect(st.count, st.tid, params, st.stream, gblk, g,
                                           occupied=o),
                        lambda: sk.collect_plain(st.count, st.tid, params, st.stream, gblk, g,
                                                 occupied=o)),
        }
        bounds = stream_bounds(st, g, D, occ)
        # K3 timed as the frame launches it: into the state's own stream and
        # flag, here those of a copy that each launch advances by a substep
        scr = st.clone()
        timed = {"collect": lambda: sk.collect(scr.count, scr.tid, params, scr.stream, gblk, g,
                                               out=(scr.stream, scr.flag), occupied=o)}
        for name, (kern, plain) in cases.items():
            got, want = kern(), plain()
            sync(device)
            # the windows past the count are undefined: compare below it
            if name == "collect":
                got, want = (got[0], got[1], got[2][:occ]), (want[0], want[1], want[2][:occ])
            else:
                got, want = got[:occ], want[:occ]
            if name == "collect":
                err = float((got[0] - want[0]).abs().max())
                check(err <= 1e-5, f"{dim}D collect rows max|err| {err} <= 1e-5")
                check(torch.equal(got[1], want[1]), f"{dim}D collect drift flag equal")
                scale = float(want[2].abs().max())
                dep_err = float((got[2] - want[2]).abs().max())
                check(dep_err <= 1e-4 * scale, f"{dim}D fused p2g1 {dep_err} <= 1e-4 * {scale}")
                again = kern()
                check(all(torch.equal(a[:occ], b[:occ]) for a, b in zip(again, got)),
                      f"{dim}D collect bitwise equal across two launches")
                # mouse on at the box centre
                centre = cfg.boundary_clip[1][0] / 2
                pw = stx.collect_params(cfg, *step.mouse((centre, centre)), device)
                gw = sk.collect(st.count, st.tid, pw, st.stream, gblk, g, occupied=o)
                ww = sk.collect_plain(st.count, st.tid, pw, st.stream, gblk, g, occupied=o)
                walls_err = float((gw[0] - ww[0]).abs().max())
                check(walls_err <= 1e-5 and torch.equal(gw[1], ww[1]),
                      f"{dim}D collect with the mouse: rows {walls_err} <= 1e-5, flag equal")
                extra = (f" flag_equal=True fused_p2g1_err={dep_err:.3e} (scale {scale:.3e})"
                         f" mouse_err={walls_err:.3e} repeat_bit_equal=True"
                         " (timed in place)")
                del again, gw, ww
            elif name.startswith("deposit"):
                scale = float(want.abs().max())
                err = float((got - want).abs().max())
                check(err <= 1e-4 * scale, f"{dim}D {name} max|err| {err} <= 1e-4 * max|window| {scale}")
                check(torch.equal(kern()[:occ], got), f"{dim}D {name} bitwise equal across two launches")
                extra = f" max|window|={scale:.4e} repeat_bit_equal=True"
            elif name == "halo_gblk":
                err = float((got - want).abs().max())
                rel = check_gblk(got, want, st.count[:occ], f"{dim}D")
                extra = f" max_rel={rel:.3e} mass_row_equal=True zero_tiles_equal=True"
            else:
                err = float((got - want).abs().max())
                check(torch.equal(got, want), f"{dim}D {name} (CH=1, the {D} passes) bit-equal to "
                      "the gated chain of plain passes")
                copy_ms = time_ms(lambda: torch.empty_like(got).copy_(got), reps, device)
                extra = f" CH=1 bit_equal=True (a copy of the output's size: {copy_ms:.4f} ms)"
            del got, want
            ms = time_ms(timed.get(name, kern), reps, device)
            plain_ms = time_ms(plain, max(2, reps // 5), device)
            bound_ms, bound_by = bound(*bounds[name])
            if dim == 3:
                results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            print(f"[kernels] {dim}D {name}: max_abs_err={err:.3e}{extra} kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        # the kernel for any other window geometry: E = 10 != 2T (halo 3) on the same tiles
        g3 = dataclasses.replace(g, halo=3)
        gen = torch.Generator(device=device).manual_seed(2)
        for CH in (1, D):
            x3 = torch.randn((spec.A, CH, g3.ncell), generator=gen, device=device)
            check(torch.equal(sk.halo_axes(x3, st.count, nbr, g3),
                              sk.halo_axes_plain(x3, st.count, nbr, g3)),
                  f"{dim}D halo_axes CH={CH} with E={g3.E} != 2T bit-equal to the gated chain of "
                  "plain passes")
            del x3
        x3 = torch.randn((spec.A, D, g3.ncell), generator=gen, device=device)
        m3 = torch.rand((spec.A, 1, g3.ncell), generator=gen, device=device)
        m3 = torch.where(m3 < 0.2, 0.0, m3)  # zero-mass cells mixed in
        rel3 = check_gblk(sk.halo_gblk(x3, m3, st.count, nbr, dtg, g3),
                          sk.halo_gblk_plain(x3, m3, st.count, nbr, dtg, g3), st.count,
                          f"{dim}D E={g3.E}")
        print(f"[kernels] {dim}D halo_axes CH=1 and CH={D} at E={g3.E} != 2T (the general kernel): "
              f"bit_equal=True; halo_gblk there: max_rel={rel3:.3e}, mass row and zero tiles "
              f"equal  [{card}]")
        del st, scr, d1, m1, m, d2, gblk, x3, m3
        torch.cuda.empty_cache()
    for n in [n for dim, n in sizes if dim == 3]:
        kinds = {cap: collect_in_place(device, card, f"3D n={n} T=4 cap={cap}",
                                       stream_state(device, n, 3, tile=4, cap=cap), reps)
                 for cap in (128, 256)}
        results["collect"]["kinds"] = {"T4_cap256": kinds[256]}
    for what, make in two_chunk_states(device).items():
        state = make()
        top = int(state[2].count.max())
        check(state[1].cap == 256 and top > 128, f"{what}: a tile past 128 slots (max count {top})")
        collect_in_place(device, card, what, state, reps)
        del state
    # K4's row is the mass halo, once per substep; it stands under "kinds"
    # beside the sharded path's ghost-gated kind
    mass = results.pop("halo_mass")
    results["halo_axis"] = {**mass, "kinds": {"halo_mass": {
        **{key: mass[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")}, "on_path": True}}}
    return results


SENTINEL = -7.5


def collect_in_place(device, card: str, what: str, state, reps: int = 10) -> dict:
    """K3 as the frame launches it, into the state's own stream and flag, on
    ``state`` = (cfg, spec, st, g) as ``stream_state`` gives it, with the
    slots past each tile's count and every flag seeded with a sentinel:
    against the plain version the live rows within 1e-5, the flags equal
    and the p2g1 windows within 1e-4 of their scale; the slots past the
    count and their flags still the sentinel; the out-of-place launch's
    live rows, flags and windows bit-equal to the in-place one's, and zero
    past the count; bit-equal across two launches.  Returns the in-place
    launch's numbers as a kind of K3's table entry."""
    cfg, spec, st, g = state
    D, cap = g.dim, spec.cap
    what = f"{what} in-place collect"
    params6 = deposit_params(cfg, device)
    params = stx.collect_params(cfg, *step.no_mouse(), device)
    d1 = sk.deposit_p2g1(st.count, st.tid, st.stream, g)
    m = sk.halo_axes(d1[:, :1].contiguous(), st.count, st.nbr, g)
    d2 = sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g)
    gblk = sk.halo_gblk(d2, m, st.count, st.nbr, sk.gravity_step(cfg.dt, cfg.gravity), g)
    want = sk.collect_plain(st.count, st.tid, params, st.stream, gblk, g)
    fresh = sk.collect(st.count, st.tid, params, st.stream, gblk, g)
    live = torch.arange(cap, device=device)[None, :] < st.count[:, None]
    runs = []
    for _ in range(2):
        s = st.clone()
        s.stream.masked_fill_(~live[:, None, :], SENTINEL)
        s.flag.fill_(SENTINEL)
        out = sk.collect(s.count, s.tid, params, s.stream, gblk, g, out=(s.stream, s.flag))
        check(out[0] is s.stream and out[1] is s.flag, f"{what} wrote in place")
        runs.append((s, out[2]))
    sync(device)
    (a, dep), (b, dep_b) = runs
    rows, flags = torch.where(live[:, None, :], a.stream, 0.0), torch.where(live, a.flag, 0.0)
    err = float((rows - want[0]).abs().max())
    scale = float(want[2].abs().max())
    dep_err = float((dep - want[2]).abs().max())
    check(err <= 1e-5 and torch.equal(flags, want[1]) and dep_err <= 1e-4 * scale,
          f"{what}: rows {err} <= 1e-5, flag equal, p2g1 {dep_err} <= 1e-4 * {scale}")
    check(bool((a.stream.permute(0, 2, 1)[~live] == SENTINEL).all())
          and bool((a.flag[~live] == SENTINEL).all()),
          f"{what}: the slots past the count and their flags untouched")
    check(torch.equal(rows, fresh[0]) and torch.equal(flags, fresh[1]) and torch.equal(dep, fresh[2]),
          f"{what}: live rows, flags and p2g1 bit-equal to the out-of-place launch's")
    check(torch.equal(a.stream, b.stream) and torch.equal(a.flag, b.flag) and torch.equal(dep, dep_b),
          f"{what}: bit-equal across two launches")
    dead = int((~live).sum())
    del runs, b, dep_b, fresh, want, rows, flags, d1, m, d2
    ms = time_ms(lambda: sk.collect(a.count, a.tid, params, a.stream, gblk, g,
                                    out=(a.stream, a.flag)), reps, device)
    bound_ms, bound_by = bound(*stream_bounds(st, g, D, spec.A)["collect"])
    top = int(st.count.max())
    print(f"[kernels] {what}: A={spec.A} occupied={int((st.count > 0).sum())} max count="
          f"{top} ({-(-top // 128)} chunk(s) of 128), {dead} slots past the count seeded with {SENTINEL}: rows "
          f"{err:.3e}, flag equal, p2g1 {dep_err:.3e} of {scale:.3e}; dead slots untouched; "
          f"bit-equal to the out-of-place launch and across two launches; kernel {ms:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
    del st, a, dep, gblk
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "on_path": "stream 1M benchmark"}


def two_chunk_states(device) -> dict:
    """Makers of states at cap 256 whose fullest tiles hold more than one
    collect chunk (128 slots), so the collect walks them through
    window_walk: the 2D reference scene after the app's first mouse frame
    (at the fluid's centroid, on the default spec, as the 2D app cell
    drives it) and a 3D dam of N_2D packed into half its height."""
    def scene_2d():
        cfg, p, dom = scene.reference_scene_2d(0, device=device)
        sess = Session(cfg, dom, p, backend="stream", device=device)
        sess.frame(step.mouse([float(v) for v in p.pos[:, :2].mean(dim=0)]))
        return cfg, sess.spec, sess.stream_state().clone(), stx.tile_geom(dom, sess.spec)

    return {"2D reference scene after the centroid mouse frame": scene_2d,
            f"3D n={N_2D} packed 2x T=4 cap=256":
                lambda: stream_state(device, N_2D, 3, tile=4, cap=256, squeeze=2.0)}


def rebin_bounds(count, n: int, g) -> dict:
    """(bytes, ops) of the re-bin's kernels on a state with ``count`` [A] and
    ``n`` live particles: rebin_gather reads the counts, their prefix sum
    and the live slots and writes n rows and keys; rebin_fill reads the
    rows, the sort's n indices and each tile's first rank and count, and
    writes every slot of the stream and the flag.  A few integer
    operations per float moved: bound by bytes (ops counted as 0)."""
    A, F = count.shape[0], g.F
    return {"rebin_gather": ((2 * A + 2 * n * F + n) * F32, 0),
            "rebin_fill": ((n * F + 2 * n + 3 * A + A * (F + 1) * g.cap) * F32, 0)}


@contextlib.contextmanager
def plain_rebin():
    """The re-bin's two wrappers swapped for their plain versions, which
    then run on the card's tensors."""
    saved = sk.rebin_gather, sk.rebin_fill
    sk.rebin_gather, sk.rebin_fill = sk.rebin_gather_plain, sk.rebin_fill_plain
    try:
        yield
    finally:
        sk.rebin_gather, sk.rebin_fill = saved


def phase_rebin(device, card: str, reps: int = 10) -> dict:
    """The re-bin's kernels on the benchmark's two scenes: the 1M dam at
    its layout (T=4, cap 256, A = every tile) after 40 frames, and the 3D
    reference scene (default spec) after 10, each a strict captured
    Session.  From the session's state, eager substeps until a drift flag
    asks for a re-bin; there rebin_gather's rows and keys equal its plain
    version's, and one re-bin in place through the kernels leaves stream,
    count, tid, flag, nbr, the watermarks, the counter and the
    redeposited p2g_1 windows bit-equal to the same re-bin through the
    plain versions (K1 on the plain re-bin's state).  Every IF body of the
    captured frame holds one node of each re-bin kernel and of K1, and
    nothing else of csrc; the next replayed frame equals the same frame
    run eagerly, bit for bit.  Then each kernel, its plain version and the
    whole body (eagerly and as 20 bodies in one graph) timed beside the
    kernels' byte bounds.  On each session's state first, K1-K5 bounded by
    ``occupied`` against the launch over all A (``zero_tile_share``).
    Returns the 1M dam's kernel numbers."""
    results = {}
    gen = torch.Generator(device=device).manual_seed(0)
    cfg1, p1, dom1 = scene.scaled_dam_break(gen, N_1M, dim=3, device=device)
    nt1 = int(np.prod([s // 4 for s in dom1.shape]))
    cfg_r, p_r, dom_r = scene.reference_scene_3d(device=device)
    cases = (("1M dam", cfg1, dom1, p1, stx.StreamSpec(tile=4, cap=256, halo=2, active=nt1), 40),
             ("reference scene", cfg_r, dom_r, p_r, stx.default_spec(cfg_r, dom_r, p_r.n), 10))
    for what, cfg, dom, p, spec, frames in cases:
        n, D = p.n, cfg.dim
        sess = Session(cfg, dom, p, backend="stream", spec=spec, device=device)
        sess.run(frames)
        sync(device)
        check(sess.live_count() == n and sess.shell_drop() == 0, f"rebin {what}: conservation")
        zero_tile_share(what, cfg, spec, dom, sess.stream_state(), device, card)
        fg = sess.frame_graph
        bodies = [graph_kernel_nodes(b.raw_cuda_graph())[0] for b in fg.bodies]
        one = dict.fromkeys((*sk.KERNELS, *pk.KERNELS), 0)
        one.update({"deposit_p2g1": 1, "rebin_gather": 1, "rebin_fill": 1})
        check(len(bodies) == cfg.iterations and all(b == one for b in bodies),
              f"rebin {what}: each of the {len(bodies)} IF bodies holds one node of K1, "
              f"rebin_gather and rebin_fill: {bodies[0] if bodies else None}")
        st0, rb0 = sess.stream_state().clone(), sess.rebins()
        sess.frame()
        sync(device)
        fired = sess.rebins() - rb0
        eager = stx.frame_binned(st0, cfg, dom, spec, *step.no_mouse(), n=n)
        check(differ(sess.stream_state(), eager) == [],
              f"rebin {what}: replayed frame {frames + 1} ({fired} re-bins) bit-equal to the eager "
              f"frame: {differ(sess.stream_state(), eager)}")
        del st0, eager

        tshape, nt = stx._tile_geometry(dom, spec)
        g = stx.tile_geom(dom, spec)
        stages = stx.substep_stages(cfg, dom, spec, device)
        params = stx.collect_params(cfg, *step.no_mouse(), device)
        st = sess.stream_state().clone()
        dep1 = stages.dep1(st)
        subs = 0
        while not bool(stx.needs_rebin(st)):
            check(subs < 4 * cfg.iterations, f"rebin {what}: a drift flag within "
                                             f"{4 * cfg.iterations} substeps")
            dep1 = stx._substep_core(st, dep1, stages, params)
            subs += 1
        st.shell_drop.fill_(0)
        st.need_peak.fill_(1)
        step_t = stx._LOOKAHEAD * cfg.dt
        rows, keys = sk.rebin_gather(st.stream, st.count, n, g, step_t)
        rows_p, keys_p = sk.rebin_gather_plain(st.stream, st.count, n, g, step_t)
        check(torch.equal(rows, rows_p) and torch.equal(keys, keys_p),
              f"rebin {what}: rebin_gather rows and keys bit-equal to its plain version")
        moved = int((keys.long() != stx._keys_from_pos(rows[:, :D], dom, spec, tshape)).sum())
        got, got_d1 = st.clone(), torch.full_like(dep1, float("nan"))
        stx._rebin_into(got, got_d1, cfg, dom, spec, tshape, nt, n, stages)
        want = st.clone()
        with plain_rebin():
            stx._rebin_into(want, torch.empty_like(dep1), cfg, dom, spec, tshape, nt, n, stages)
        want_d1 = sk.deposit_p2g1(want.count, want.tid, want.stream, g)
        sync(device)
        occ = int(got.occupied[0])  # p2g_1 past it is undefined
        d1_equal = torch.equal(got_d1[:occ], want_d1[:occ])
        check(differ(got, want) == [] and d1_equal and occ == int((got.count > 0).sum()),
              f"rebin {what}: the re-bin through the kernels bit-equal to the plain versions' "
              f"(fields that differ: {differ(got, want)}, p2g_1 of the {occ} occupied entries "
              f"equal: {d1_equal})")
        check(int(got.count.sum()) == n and int(got.rebins[0]) == int(st.rebins[0]) + 1,
              f"rebin {what}: every particle binned, the re-bin counted")
        flagged = int((st.flag >= 2.0).sum())
        del got, want, want_d1, rows_p, keys_p

        order = torch.argsort(keys, stable=True)
        sid = keys[order]
        first = torch.searchsorted(sid, torch.arange(nt + 2, dtype=sid.dtype, device=device))
        nxt = st.clone()
        stx._rebin_into(nxt, got_d1, cfg, dom, spec, tshape, nt, n, stages)
        start = first[:-1][nxt.tid.long().clamp(0, nt)].contiguous()
        out_s, out_f = torch.empty_like(st.stream), torch.empty_like(st.flag)
        kernels = {
            "rebin_gather": (lambda: sk.rebin_gather(st.stream, st.count, n, g, step_t),
                             lambda: sk.rebin_gather_plain(st.stream, st.count, n, g, step_t)),
            "rebin_fill": (lambda: sk.rebin_fill(rows, order, start, nxt.count, out_s, out_f),
                           lambda: sk.rebin_fill_plain(rows, order, start, nxt.count, out_s, out_f)),
        }
        sk.rebin_fill(rows, order, start, nxt.count, out_s, out_f)
        check(torch.equal(out_s, nxt.stream) and not out_f.any(),
              f"rebin {what}: rebin_fill alone rebuilds the re-bin's stream")
        bounds = rebin_bounds(st.count, n, g)
        line = []
        for name, (kern, plain) in kernels.items():
            ms = time_ms(kern, reps, device)
            plain_ms = time_ms(plain, max(2, reps // 5), device)
            bound_ms, bound_by = bound(*bounds[name])
            if what == "1M dam":
                results[name] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
            line.append(f"{name} {ms:.4f} ms (plain {plain_ms:.4f}, bound {bound_ms:.4f} by "
                        f"{bound_by}, {bound_ms / ms:.1%} of it)")
        scratch, scratch_d1 = st.clone(), torch.empty_like(dep1)

        def body():
            scratch.stream.copy_(st.stream)
            scratch.count.copy_(st.count)
            stx._rebin_into(scratch, scratch_d1, cfg, dom, spec, tshape, nt, n, stages)

        copy_ms = time_ms(lambda: (scratch.stream.copy_(st.stream), scratch.count.copy_(st.count)),
                          reps, device)
        body_ms = time_ms(body, reps, device) - copy_ms
        body_graph_ms = graph_ms(body, device) - copy_ms
        k1_ms = time_ms(lambda: stages.dep1(scratch, scratch_d1), reps, device)
        print(f"[rebin] {what} (n={n}, A={spec.A}, cap {spec.cap}, stream "
              f"{st.stream.numel() * F32 / 1e6:.0f} MB) after {frames} frames + {subs} substeps, "
              f"{flagged} drift flags, {moved} particles keyed ahead of their cell's tile: "
              f"rebin_gather bit-equal to plain; the re-bin in place bit-equal to the plain "
              f"versions' (stream, count, tid, flag, nbr, occupied, watermarks, counter, p2g_1 "
              f"below occupied); IF bodies "
              f"{len(bodies)} x (K1, rebin_gather, rebin_fill); replayed frame {frames + 1} "
              f"({fired} re-bins) bit-equal to eager; {'; '.join(line)}; whole body "
              f"{body_ms:.4f} ms eager, {body_graph_ms:.4f} ms in a graph (K1 {k1_ms:.4f}; the "
              f"state copies {copy_ms:.4f} taken off)  [{card}]")
        del sess, st, dep1, rows, keys, order, sid, first, nxt, start, out_s, out_f, scratch
        del scratch_d1, got_d1, kernels
        torch.cuda.empty_cache()
    return results


# 3D stream specs beside the main path's (T=4, cap=128), as (tile, cap, keep
# every k-th particle of the dam so the tiles fit the cap, particles): blocks
# past the 48 KB of shared memory a launch gets by default (cap 256; T=8
# keeps halo 2, so E=12 != 2T, the general halo), and caps past 256, whose
# deposit and collect blocks walk the slots in chunks of 256: the whole 1M
# dam at bench.py's big-tile spec (T=8, cap 1024) and at T=4, cap 512
DEPOSIT_GEOMETRIES = ((4, 256, 1, 200_000), (8, 128, 8, 200_000), (8, 256, 4, 200_000),
                      (8, 1024, 1, N_1M), (4, 512, 1, N_1M))
TIMED_GEOMETRY = (8, 1024)  # its K1, K2 and K3 times stand as kinds in the table


def phase_deposit_geometries(device, card: str, reps: int = 10) -> dict:
    """K1, K2, K5 and K3 against their plain versions, at the
    tolerances of phase_kernels, the deposits and K3 bit-equal across two
    launches, at the specs of DEPOSIT_GEOMETRIES: the deposit and collect
    launches opt into the larger block, tile 8 (E = 12 != 2T) takes the
    general halo_gblk kernel, and a cap past 256 walks its slots in
    chunks.  Returns K1, K2 and K3 timed at TIMED_GEOMETRY, as
    kinds of their table entries."""
    kinds = {}
    for tile, cap, keep, n in DEPOSIT_GEOMETRIES:
        cfg, spec, st, g = stream_state(device, n, 3, tile=tile, cap=cap, keep=keep)
        params6 = deposit_params(cfg, device)
        params = stx.collect_params(cfg, *step.no_mouse(), device)
        d1 = sk.deposit_p2g1(st.count, st.tid, st.stream, g)
        m = sk.halo_axes(d1[:, :1].contiguous(), st.count, st.nbr, g)
        d2 = sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g)
        dtg = sk.gravity_step(cfg.dt, cfg.gravity)
        gblk = sk.halo_gblk(d2, m, st.count, st.nbr, dtg, g)
        what = f"3D n={n} T={tile} E={g.E} cap={cap}"
        rel = check_gblk(gblk, sk.halo_gblk_plain(d2, m, st.count, st.nbr, dtg, g), st.count, what)
        errs = {}
        for name, got, want in (
                ("deposit_p2g1", d1, sk.deposit_p2g1_plain(st.count, st.tid, st.stream, g)),
                ("deposit_p2g2", d2, sk.deposit_p2g2_plain(st.count, st.tid, st.stream, m, params6,
                                                           d1, g))):
            scale = float(want.abs().max())
            errs[name] = float((got - want).abs().max())
            check(errs[name] <= 1e-4 * scale, f"{what} {name} max|err| {errs[name]} <= 1e-4 * {scale}")
        check(torch.equal(sk.deposit_p2g1(st.count, st.tid, st.stream, g), d1)
              and torch.equal(sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g), d2),
              f"{what} deposits bitwise equal across two launches")
        got = sk.collect(st.count, st.tid, params, st.stream, gblk, g)
        want = sk.collect_plain(st.count, st.tid, params, st.stream, gblk, g)
        rows = float((got[0] - want[0]).abs().max())
        scale = float(want[2].abs().max())
        dep = float((got[2] - want[2]).abs().max())
        errs["collect"] = rows
        check(rows <= 1e-5 and torch.equal(got[1], want[1]) and dep <= 1e-4 * scale,
              f"{what} collect: rows {rows} <= 1e-5, flag equal, p2g1 {dep} <= 1e-4 * {scale}")
        again = sk.collect(st.count, st.tid, params, st.stream, gblk, g)
        check(all(torch.equal(a, b) for a, b in zip(again, got)),
              f"{what} collect bitwise equal across two launches")
        print(f"[kernels] {what} A={spec.A} occupied={int((st.count > 0).sum())} "
              f"max count={int(st.count.max())} ({-(-int(st.count.max()) // 256)} chunk(s) of "
              f"256 slots, the collect {-(-int(st.count.max()) // 128)} of 128): deposit_p2g1, "
              f"deposit_p2g2 and the collect agree with plain "
              f"(rows {rows:.3e}, p2g1 {dep:.3e} of {scale:.3e}) and repeat bit-equal; "
              f"halo_gblk max_rel={rel:.3e}, mass row and zero tiles equal  [{card}]")
        del got, want, again
        if (tile, cap) == TIMED_GEOMETRY:
            # timed as the frame launches them: in place (K3), bounded by occupied
            o = st.occupied
            bounds = stream_bounds(st, g, 3, int(o[0]))
            scr = st.clone()
            cases = {
                "deposit_p2g1": (lambda: sk.deposit_p2g1(st.count, st.tid, st.stream, g, occupied=o),
                                 lambda: sk.deposit_p2g1_plain(st.count, st.tid, st.stream, g)),
                "deposit_p2g2": (lambda: sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g,
                                                         occupied=o),
                                 lambda: sk.deposit_p2g2_plain(st.count, st.tid, st.stream, m, params6,
                                                               d1, g)),
                "collect": (lambda: sk.collect(scr.count, scr.tid, params, scr.stream, gblk, g,
                                               out=(scr.stream, scr.flag), occupied=o),
                            lambda: sk.collect_plain(st.count, st.tid, params, st.stream, gblk, g)),
            }
            for name, (kern, plain) in cases.items():
                ms = time_ms(kern, reps, device)
                plain_ms = time_ms(plain, max(2, reps // 5), device)
                bound_ms, bound_by = bound(*bounds[name])
                kinds[name] = {f"T{tile}_cap{cap}": {
                    "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "on_path": "stream big-tile"}}
                print(f"[kernels] {what} {name}: kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
                      f"bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        del st, d1, m, d2, gblk
        torch.cuda.empty_cache()
    return kinds


# The stream kernels' outputs at a cap of one chunk (T=4, cap=256, every
# tile; the 200,000-particle dam of DEPOSIT_GEOMETRIES' first row, its
# random numbers drawn on the CPU), as SHA-256 digests recorded from the
# kernels before they walked their slots in chunks
# (``python3 chip_smoke.py --record-digests stream PATH`` run on that tree).
DIGESTS = os.path.join(ROOT, "tests", "data", "stream_kernels_cap256.json")


def _digest(*tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def kernel_digests(device, tile: int, cap: int, n: int) -> dict:
    """SHA-256 of each stream kernel's output on the stream state of
    ``stream_state(device, n, 3, tile, cap, rng_device="cpu")``: K1, the
    mass halo K4, K2, K5 and K3 ("collect"), and K3's stream and flag
    alone ("collect_unfused", as the unfused collect recorded them);
    "inputs" digests the binned state they read."""
    cfg, spec, st, g = stream_state(device, n, 3, tile=tile, cap=cap, rng_device="cpu")
    params6 = deposit_params(cfg, device)
    params = stx.collect_params(cfg, *step.no_mouse(), device)
    d1 = sk.deposit_p2g1(st.count, st.tid, st.stream, g)
    m = sk.halo_axes(d1[:, :1].contiguous(), st.count, st.nbr, g)
    d2 = sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g)
    gblk = sk.halo_gblk(d2, m, st.count, st.nbr, sk.gravity_step(cfg.dt, cfg.gravity), g)
    collect = sk.collect(st.count, st.tid, params, st.stream, gblk, g)
    return {"tile": tile, "cap": cap, "n": n,
            "inputs": _digest(st.stream, st.count, st.tid, st.nbr),
            "deposit_p2g1": _digest(d1), "halo_axis": _digest(m), "deposit_p2g2": _digest(d2),
            "halo_gblk": _digest(gblk),
            "collect": _digest(*collect), "collect_unfused": _digest(*collect[:2])}


def phase_digests(device, card: str) -> None:
    """At a cap of one chunk the chunked K1, K2 and K3 (and K4, K5 on their
    windows) give the recorded outputs of the kernels before chunking bit
    for bit, on the same inputs."""
    with open(DIGESTS) as fh:
        want = json.load(fh)
    got = kernel_digests(device, want["tile"], want["cap"], want["n"])
    check(got["inputs"] == want["inputs"], "digests: the inputs equal the recorded ones")
    differ = [k for k in want if got[k] != want[k]]
    check(not differ, f"digests: bit-equal to the recording, differ: {differ}")
    print(f"[digests] 3D n={want['n']} T={want['tile']} cap={want['cap']}: K1, K4 mass, K2, K5 "
          f"and K3 bit-equal to the kernels before the chunked walk, K3's stream and flag to the "
          f"unfused collect's  [{card}]")


def pallas_state(device, n: int, dim: int, tile: int = 0, cap: int = 0, rng_device=None):
    """A dam of ``n`` particles with random velocities and APIC matrices,
    binned for the pallas kernels by the default TileSpec or, with ``tile``
    and ``cap``, by a spec of that tile edge and cap; returns what each
    kernel is given on the main path (the glue of
    ``pallas_transfer._advance``, K6's blocks halo'd into ``mblocks``) and
    the force stream that ``p2g2`` deposits from, made by the plain path.
    The random numbers come from generators on ``rng_device`` (default:
    ``device``); "cpu" gives the same particles on any card."""
    rng = device if rng_device is None else torch.device(rng_device)
    gen = torch.Generator(device=rng).manual_seed(0)
    cfg, p, dom = scene.scaled_dam_break(gen, n, dim=dim, device=rng)
    gen = torch.Generator(device=rng).manual_seed(1)
    p.vel = 0.3 * torch.randn(p.vel.shape, generator=gen, device=rng)
    p.C = 0.05 * torch.randn(p.C.shape, generator=gen, device=rng)
    p = p.to(device)
    spec = tt.default_spec(cfg, n)
    if tile:
        spec = dataclasses.replace(spec, tile=tile, cap=cap)
    check(int(tt.overflow_count(p.pos, dom, spec)) == 0, f"{dim}D scene fits the tile spec")
    plan = tpt.make_plan(cfg, dom, spec, *step.no_mouse(), device)
    st = tpt.bin_stream(p, dom, plan)
    g = plan.geom
    _, act1 = tpt.halo_blocks(pk.deposit(st.stream, *st.tiles, g, mode="p2g1"), st, plan)
    mblocks = act1[..., 0:1].contiguous()
    _, act2 = tpt.halo_blocks(pk.p2g2(st.stream, mblocks, *st.tiles, plan.params6, g), st, plan)
    vblocks = tpt.grid_velocity(act1[..., 1:] + act2, mblocks, plan.dtg)
    force = pk.force_stream_plain(st.stream, mblocks, *st.tiles, plan.params6, g)
    return cfg, plan, st, mblocks, vblocks, force


def deposit_cases(plan, st, mblocks, force) -> dict:
    """K6, K6f and K7 as (kernel, plain) calls on one pallas state."""
    g, stream, tiles = plan.geom, st.stream, st.tiles
    return {
        "pallas_deposit_p2g1": (lambda: pk.deposit(stream, *tiles, g, mode="p2g1"),
                                lambda: pk.deposit_plain(stream, *tiles, g, mode="p2g1")),
        "pallas_deposit_force": (lambda: pk.deposit(force, *tiles, g, mode="force"),
                                 lambda: pk.deposit_plain(force, *tiles, g, mode="force")),
        "pallas_p2g2": (lambda: pk.p2g2(stream, mblocks, *tiles, plan.params6, g),
                        lambda: pk.p2g2_plain(stream, mblocks, *tiles, plan.params6, g)),
    }


# the pallas deposits beside the main path's spec: T=8, cap 1024 on the
# whole 1M dam (bench.py's big-tile geometry; up to ~590 particles a tile,
# so the kernels walk a tile in several chunks); on no path of the repo
# (pallas Sessions take the default spec), reached by
# ``pallas_transfer.substep(spec=...)``
PALLAS_BIG_TILE = (8, 1024)


def phase_pallas_kernels(device, card: str, reps: int = 10):
    """The four pallas kernels against their plain versions at the 3D 1M
    dam (the main path's shapes, whose times go into the kernel table), at
    a 2D dam of 100,000 (the D=2 instantiations), and, K6, K6f and K7, at
    PALLAS_BIG_TILE on the 1M dam (times as the ``T8_cap1024`` kind); the
    deposits give bit-equal blocks when launched twice on the same inputs."""
    results = {}
    big = "T{}_cap{}".format(*PALLAS_BIG_TILE)
    for dim, n, geometry in ((3, N_1M, (0, 0)), (2, N_2D, (0, 0)), (3, N_1M, PALLAS_BIG_TILE)):
        cfg, plan, st, mblocks, vblocks, force = pallas_state(device, n, dim, *geometry)
        g, stream, tiles = plan.geom, st.stream, st.tiles
        what = f"{dim}D T={g.tile} cap={g.cap}"
        centre = cfg.boundary_clip[1][0] / 2
        params_m = tpt.collect_params(cfg, *step.mouse((centre, centre)), device)
        print(f"[pallas kernels] {what} n={n} A={tiles[1].shape[0]} "
              f"occupied={int((tiles[1] > 0).sum())} max count={int(tiles[1].max())} "
              f"stream={tuple(stream.shape)} blocks={tuple(mblocks.shape[:2])}")
        cases = deposit_cases(plan, st, mblocks, force)
        if not geometry[0]:
            cases["pallas_collect"] = (
                lambda: pk.collect(stream, vblocks, mblocks, *tiles, plan.params_c, g),
                lambda: pk.collect_plain(stream, vblocks, mblocks, *tiles, plan.params_c, g))
        bounds = pallas_bounds(tiles[1], g, dim)
        for name, (kern, plain) in cases.items():
            got, want = kern(), plain()
            sync(device)
            err = float((got - want).abs().max())
            if name == "pallas_collect":
                check(err <= 1e-5, f"{what} {name} rows max|err| {err} <= 1e-5")
                gm = pk.collect(stream, vblocks, mblocks, *tiles, params_m, g)
                wm = pk.collect_plain(stream, vblocks, mblocks, *tiles, params_m, g)
                mouse_err = float((gm - wm).abs().max())
                check(mouse_err <= 1e-5, f"{what} collect with the mouse {mouse_err} <= 1e-5")
                check(bool((gm[:, dim:2 * dim] != got[:, dim:2 * dim]).any()), "the mouse pushed")
                extra = f" mouse_err={mouse_err:.3e}"
                del gm, wm
            else:
                scale = float(want.abs().max())
                check(err <= 1e-4 * scale, f"{what} {name} max|err| {err} <= 1e-4 * max|block| {scale}")
                check(torch.equal(kern(), got), f"{what} {name} bitwise equal across two launches")
                extra = f" max|block|={scale:.4e} repeat_bit_equal=True"
                if name == "pallas_deposit_force":
                    k7 = pk.p2g2(stream, mblocks, *tiles, plan.params6, g)
                    same = float((got - k7).abs().max())
                    check(same <= 1e-4 * scale, f"force deposit of the plain force stream vs p2g2 {same}")
                    extra += f" vs_p2g2={same:.3e}"
                    del k7
            del got, want
            ms = time_ms(kern, reps, device)
            plain_ms = time_ms(plain, max(2, reps // 5), device)
            bound_ms, bound_by = bound(*bounds[name])
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            if geometry[0]:
                results[name]["kinds"] = {big: {**row, "on_path": False}}
            elif dim == 3:
                results[name] = {**row, "library_ms": None}
            print(f"[pallas kernels] {what} {name}: max_abs_err={err:.3e}{extra} kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        del plan, st, mblocks, vblocks, force
        torch.cuda.empty_cache()
    return results


# K6, K6f and K7's outputs (and their inputs) as SHA-256 digests, recorded
# from the cell-owner-scan kernels that the tap-parallel walk replaced
# (``python3 chip_smoke.py --record-digests pallas PATH`` run with that
# tree's package), on the pallas states of PALLAS_DIGEST_CASES, their
# random numbers drawn on the CPU: (dim, n, tile, cap); tile 0 is the
# default spec (T=4, cap 384 in 3D: one chunk).
PALLAS_DIGESTS = os.path.join(ROOT, "tests", "data", "pallas_kernels_digests.json")
PALLAS_DIGEST_CASES = {"3d_T4_cap384": (3, N_1M, 0, 0), "3d_T8_cap1024": (3, N_1M, *PALLAS_BIG_TILE),
                       "2d_T4": (2, N_2D, 0, 0)}


def pallas_digests(device, dim: int, n: int, tile: int, cap: int) -> dict:
    """SHA-256 of K6's, K6f's and K7's blocks on ``pallas_state(device, n,
    dim, tile, cap, rng_device="cpu")``; "inputs" digests what they read
    (mblocks are K6's blocks halo'd, so they equal the recording's only if
    K6 does)."""
    _, plan, st, mblocks, _, force = pallas_state(device, n, dim, tile, cap, rng_device="cpu")
    out = {"dim": dim, "n": n, "tile": plan.geom.tile, "cap": plan.geom.cap,
           "inputs": _digest(st.stream, *st.tiles, mblocks, force, plan.params6)}
    for name, (kern, _) in deposit_cases(plan, st, mblocks, force).items():
        out[name] = _digest(kern())
    return out


def phase_pallas_digests(device, card: str) -> None:
    """K6, K6f and K7 give the recorded blocks of the kernels they replaced
    bit for bit, on the same inputs, in every case of the recording."""
    with open(PALLAS_DIGESTS) as fh:
        record = json.load(fh)
    check(sorted(record) == sorted(PALLAS_DIGEST_CASES), f"digest cases {sorted(record)}")
    for case, want in record.items():
        got = pallas_digests(device, *PALLAS_DIGEST_CASES[case])
        differ = [k for k in want if got[k] != want[k]]
        check(not differ, f"pallas digests {case}: bit-equal to the recording, differ: {differ}")
        print(f"[pallas digests] {case} (n={want['n']} T={want['tile']} cap={want['cap']}): K6, "
              f"K6f and K7 bit-equal to the cell-owner-scan kernels, inputs equal  [{card}]")
        torch.cuda.empty_cache()


MICRO_REPLACES = {
    "micro_prefix_copy": "bench/micro_sep.py:64, bench/micro_pb.py:17, bench/micro_dma.py:85",
    "micro_bulk_copy": "bench/micro_dma.py:33",
    "micro_window_deposit": "bench/micro_zfac.py:143, bench/micro_zfac.py:157, bench/micro_sep.py:88",
    "micro_window_gather": ("bench/micro_zfac.py:176, bench/micro_zfac.py:195, "
                            "bench/micro_zfac.py:225, bench/micro_zfac.py:238"),
    "micro_stage_fill": ("bench/micro_kernels.py:120 (case_dma_only :195), "
                         "bench/micro_kernels.py:349, bench/micro_kernels.py:376 (case_dma_tb :430), "
                         "bench/micro_kernels.py:528 (case_tb2_dma :564), bench/micro_kernels.py:825, "
                         "bench/micro_kernels.py:1198"),
    "micro_window_contract": ("bench/micro_kernels.py:120 (case_window_build :204, "
                              "case_matmul :223)"),
    "micro_p2g1_deposit": ("bench/micro_kernels.py:120 (case_deposit_current :239, "
                           "case_deposit_onewindow :301), bench/micro_kernels.py:376 "
                           "(case_deposit_onewindow_tb :497), bench/micro_kernels.py:528 "
                           "(case_tb2_deposit :571), bench/micro_kernels.py:794, "
                           "bench/micro_kernels.py:1062"),
    "micro_window_collect": ("bench/micro_kernels.py:649, bench/micro_kernels.py:854, "
                             "bench/micro_kernels.py:1127"),
    "micro_probe_map": ("bench/micro_zfac_probe.py:31 (pallas_call :37) over p1 :62, p3 :85, "
                        "p4 :93, p8 :147, p9 :160, p11 :187, p12 :200"),
    "micro_probe_contract": ("bench/micro_zfac_probe.py:31 (pallas_call :37) over p2 :73, "
                             "p5 :101, p6 :113, p10 :174, p13 :210"),
    "micro_probe_roll_merge": "bench/micro_zfac_probe.py:31 (pallas_call :37) over p7 :126",
}
MICRO_SOURCE = {**{name: "fluid_tpu_torch/csrc/micro_kernels.cu" for name in mk.KERNELS},
                **{name: "fluid_tpu_torch/csrc/micro_stream.cu" for name in mst.KERNELS},
                **{name: "fluid_tpu_torch/csrc/micro_probe.cu" for name in mp.KERNELS}}
MICRO_NG = 4096


def deposit_ops_per_tile(kind: str) -> int:
    """fp32 operations (2 a multiply-add) of one tile of an M3 kind, counted
    from the function's own output rows, so both forms of one function get
    one count.  wide / zfac: R rows against the 512-row window.  onewindow
    (4 rows out): V[c, e0, e1] = U[c] + e0 U[4+c] + e1 U[8+c] (4 x 8 rows,
    then 4 x 64), times wx*wy (64 rows) and contracted against wz.  sep (4
    rows out): wx * (U + e0 s part) (12 x 8 rows), V[c, e0, e1] = Ux[c, e0]
    + e1 Ux[4+c, e0] and Ux[8+c, e0], each times wy (4 x 64 rows), two
    contractions against wz and e2 * wz."""
    R, E, E2, E3, CAP = mk.R, mk.E, mk.E2, mk.E3, mk.CAP
    if kind in ("wide", "zfac"):
        return 2 * R * E3 * CAP
    if kind == "onewindow":
        return (2 * 4 * E3 * CAP + 2 * 4 * E * CAP + 2 * 4 * E2 * CAP + E2 * CAP
                + 4 * E2 * CAP)
    return (2 * 2 * 4 * E3 * CAP + 3 * R * E * CAP + 2 * 4 * E2 * CAP + 2 * 4 * E2 * CAP
            + E * CAP)


def micro_library(ng: int, stream, wx, zins, device) -> dict:
    """One PyTorch call (``torch.einsum``, full fp32) computing each M3/M4
    function on the inputs of its kind, keyed by kind; timed only, never
    called by the port.  Operands are taken left to right (opt_einsum off):
    W0 = wx*wy*wz first, then one batched product over the tile's 128
    particles."""
    G, CAP, E = mk.G, mk.CAP, mk.E

    def t(x):  # [ng, rows, GL] -> [ng, rows, G, CAP], a view
        return x.unflatten(-1, (G, CAP))

    zx, zy, zz, U, m, B = zins
    sy, sz = t(stream[:, 0:8]), t(stream[:, 8:16])
    e = torch.arange(E, dtype=torch.float32, device=device)
    one = torch.ones(E, dtype=torch.float32, device=device)
    # onewindow's fix-up [k, e0, e1]: 1, e0, e1; sep's [s, k, e0, e1, e2]:
    # (1 or s e0 for the partner rows) x (1, e1, e2)
    fix1 = torch.stack([torch.outer(one, one), torch.outer(e, one), torch.outer(one, e)])
    kfac = torch.stack([one[:, None] * one, e[:, None] * one, one[:, None] * e])  # [k, e1, e2]
    sfac = torch.stack([one, 0.5 * e])  # [s, e0]
    fix2 = sfac[:, None, :, None, None] * kfac[None, :, None, :, :]
    U5 = t(stream[:, 0:12]).unflatten(1, (3, 4))
    S6 = t(stream).unflatten(1, (2, 3, 4))
    dep = lambda: torch.einsum("gajp,gbjp,gdjp,grjp->gjrabd", t(zx), t(zy), t(zz), t(U))
    rho = lambda: torch.einsum("gajp,gbjp,gdjp,gjabd->gjp", t(zx), t(zy), t(zz),
                               m.view(ng, G, E, E, E))
    g2p = lambda: torch.einsum("gajp,gbjp,gdjp,gcabd->gcjp", t(zx), t(zy), t(zz),
                               B.view(ng, 16, E, E, E))
    return {
        "wide": dep, "zfac": dep,
        "onewindow": lambda: torch.einsum("gajp,gbjp,gdjp,gkcjp,kab->gjcabd",
                                          t(wx), sy, sz, U5, fix1),
        "sep": lambda: torch.einsum("gajp,gbjp,gdjp,gskcjp,skabd->gjcabd",
                                    t(wx), sy, sz, S6, fix2),
        "rho_wide": rho, "rho_zfac": rho, "g2p_wide": g2p, "g2p_zfac": g2p,
    }


def micro_cases(ng: int, device) -> list:
    """(kernel, kind, call, plain, exact, bytes, ops, library call or None)
    of every kind of M1-M4 at the scripts' shapes.  Bytes count each input
    read once and each output written once (a deposit from the stream reads
    the rows it uses); operations count the multiply-adds (2 a term) the
    function needs, the same for both forms of one function."""
    stream, wx = micro_sep.synth(ng, device=device)
    zins = micro_zfac.make_inputs(0, ng, device)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.rand((ng, 24, micro_sep.GL), generator=gen, device=device)
    GL, tiles = micro_sep.GL, ng * micro_sep.G
    library = micro_library(ng, stream, wx, zins, device)
    cases = []

    def copy_case(kind, f, src, rows, lanes):
        k = rows * lanes // GL
        out = torch.empty((ng, k, GL), device=device)
        cases.append(("micro_prefix_copy", kind, lambda: f(src), lambda: f.plain(src), True,
                      2 * ng * rows * lanes * F32, 0, lambda: out.copy_(src[:, :k])))

    for rows, lanes in ((64, 128), (32, 256), (16, 512), (8, 1024)):
        copy_case(f"sep_{rows}x{lanes}", micro_sep.make_copy(ng, rows, lanes), stream, rows, lanes)
    for pb in (2, 4, 8, 16):
        copy_case(f"pb{pb}", micro_pb.make_copy(ng, pb), stream, 64, 128)
    for pb in (4, 16):
        copy_case(f"pipelined_pb{pb}", micro_dma.make_pipelined(ng, 24, GL, pb), x, 24, GL)
    xout = torch.empty_like(x)
    for chunk in (8, 32):
        f = micro_dma.make_manual(ng, 24, GL, chunk)
        cases.append(("micro_bulk_copy", f"chunk{chunk}", lambda f=f: f(x), lambda f=f: f.plain(x),
                      True, 2 * x.numel() * F32, 0, lambda: xout.copy_(x)))

    plain_dep = lambda: micro_zfac.PLAIN["deposit"](*zins)
    for kind, f in (("wide", micro_zfac.dep_cur), ("zfac", micro_zfac.dep_z)):
        cases.append(("micro_window_deposit", kind, lambda f=f: f(*zins), plain_dep, False,
                      (3 * mk.E + mk.R) * ng * GL * F32 + ng * 384 * 128 * F32,
                      deposit_ops_per_tile(kind) * tiles, library[kind]))
    for kind, mode, rows in (("onewindow", "onewindow", 16), ("sep", "sep3", 24)):
        f = micro_sep.make_dep(ng, mode)
        cases.append(("micro_window_deposit", kind, lambda f=f: f(stream, wx),
                      lambda f=f: f.plain(stream, wx), False,
                      (rows + mk.E) * ng * GL * F32 + ng * 128 * 128 * F32,
                      deposit_ops_per_tile(kind) * tiles, library[kind]))
    for kind, f, x_floats, out_rows, ch in (
            ("rho_wide", micro_zfac.rho_cur, 32 * 128, 8, 1),
            ("rho_zfac", micro_zfac.rho_z, 32 * 128, 8, 1),
            ("g2p_wide", micro_zfac.g2p_cur, 16 * mk.E3, 16, 16),
            ("g2p_zfac", micro_zfac.g2p_z, 16 * mk.E3, 16, 16)):
        plain = micro_zfac.PLAIN[kind[:3]]
        cases.append(("micro_window_gather", kind, lambda f=f: f(*zins),
                      lambda plain=plain: plain(*zins), False,
                      (3 * mk.E * GL + x_floats + out_rows * GL) * ng * F32,
                      2 * ch * mk.E3 * mk.CAP * tiles, library[kind]))
    return cases


@contextlib.contextmanager
def full_fp32_einsum():
    """Matrix products in full fp32 (no TF32) and einsum's operands taken
    left to right (opt_einsum off), restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.opt_einsum.enabled
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.opt_einsum.enabled = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.opt_einsum.enabled = saved


def phase_micro(device, card: str, reps: int = 10) -> dict:
    """M1-M4 in every kind against their plain versions and timed (CUDA
    events, mean of ``reps`` launches; the plain version over 2) beside the
    one PyTorch call of the same function (held to the same tolerance),
    then the four micro entry points' main() with the launch counters read
    around them."""
    results = {name: {"kinds": {}} for name in mk.KERNELS}
    with full_fp32_einsum():
        for name, kind, call, plain, exact, nbytes, ops, library in micro_cases(MICRO_NG, device):
            got, want = call(), plain()
            sync(device)
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            if exact:
                check(torch.equal(got, want), f"{name} {kind} bit-equal to its plain version")
            else:
                check(err <= 1e-5 * scale, f"{name} {kind} max|err| {err} <= 1e-5 * {scale}")
            del got
            lib = library()  # the same values (rho's one row against 8 equal ones)
            lib_err = float((lib.reshape(MICRO_NG, -1, micro_sep.GL)
                             - want.reshape(MICRO_NG, -1, micro_sep.GL)).abs().max())
            check(lib_err <= (0.0 if exact else 1e-5 * scale),
                  f"{name} {kind}: the library call agrees, max|err| {lib_err}")
            del want, lib
            ms = time_ms(call, reps, device)
            plain_ms = time_ms(plain, 2, device)
            library_ms = time_ms(library, reps, device)
            bound_ms, bound_by = bound(nbytes, ops)
            results[name]["kinds"][kind] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                            "bound_ms": bound_ms, "bound_by": bound_by,
                                            "library_ms": library_ms}
            print(f"[micro] {name} {kind}: max_abs_err={err:.3e} kernel {ms:.4f} ms plain "
                  f"{plain_ms:.4f} ms library {library_ms:.4f} ms bound {bound_ms:.4f} ms "
                  f"({bound_by})  [{card}]")
            torch.cuda.empty_cache()

    mk.reset_launches()
    for module in (micro_sep, micro_pb, micro_dma, micro_zfac):
        print(f"[micro] python3 -m {module.__name__}:", flush=True)
        check(module.main([]) == 0, f"{module.__name__}.main() exits 0")
        torch.cuda.empty_cache()
    launches = dict(mk.LAUNCHES)
    check(all(n > 0 for n in launches.values()),
          f"every micro kernel launched by the micro entry points: {launches}")
    print(f"[micro] launches over the four entry points: {launches}")
    for name, r in results.items():
        first = next(iter(r["kinds"].values()))
        r.update({**first, "launches": launches[name], "launches_from": "micro entry points",
                  "on_path": False})
    return results


B1_GROUPS = "dma,window,matmul,tb,deposit,tb2,tb3,tb4,glue"


def b1_cases(device):
    """(name, callable, tensors) of every case ``micro_kernels.main`` runs
    with ``--cases`` B1_GROUPS at its n = 1,000,000, one layout at a time."""
    rows = mkb.synth(N_1M, device=device)
    tensors = (rows["act_start"], rows["act_count"], rows["tid"], rows["stream"])
    for group in ("dma", "window", "matmul", "tb", "deposit"):
        for name, fn in mkb.CASES[group](rows):
            yield name, fn, tensors
    del rows, tensors
    yield from mkb.tb2_all(mkb.synth_slotmajor(N_1M, device=device))
    yield from mkb.tb3_all(mkb.synth_blocks(N_1M, device=device))
    for G in (8, 16):
        yield from mkb.tb4_all(mkb.synth_grouped(N_1M, G=G, device=device))


def b1_taps(base, E: int, valid=None) -> int:
    """Window taps of the slots (of the ``valid`` ones where given) from
    their profiles' first window rows ``base`` [t, 3, cap]: 3 an axis, less
    those that fall outside [0, E)."""
    o = torch.arange(3, device=base.device)[:, None, None, None]
    per_axis = ((base[None] + o >= 0) & (base[None] + o < E)).sum(0)
    taps = per_axis.prod(1)
    return int((taps if valid is None else taps * valid).sum())


def b1_contract_ops(slots: int, taps: int, rows: int) -> int:
    """fp32 operations of ``rows`` rows contracted against W0 in tap form
    (2 a multiply-add), as ``particle_ops`` counts p2g1: the stencil 30 a
    slot, then a tap's weight (2) and its 2 ``rows``."""
    return 30 * slots + taps * (2 + 2 * rows)


def rows_read(view, tiles, length: int) -> int:
    """Rows of the row-major stream in the union of [first, first + length)
    over ``tiles``' first rows: neighbouring tiles and programs share half
    their rows, and each input is read once."""
    first = np.sort((view.bases(tiles) // view.sb).cpu().numpy())
    return int(np.minimum(np.diff(first), length).sum() + length) if first.size else 0


def b1_profiles(src, view, tid, w, tiles, shifted=True):
    """The case's stream fields [t, 16, cap] (``w.cap`` slots) and its
    profiles, base rows and dv, as the plain versions make them."""
    pm = mst.gather_tiles(src, view, tiles, 16, w.cap)
    prof, base, dv = mst.profiles(pm[:, :3], mst.tile_coords(tiles, tid, w.tshape), w, shifted)
    return pm, prof, base, dv


def b1_measure(fn, tensors, want, device):
    """(bytes, ops, library call, library check) of one B1 case from its
    kernel's arguments: bytes count each input the function reads once
    (a fill: the programs' whole blocks, as the TPU programs DMA them; the
    others: the fields and slots they use; on the row-major stream the
    union of the rows, ``rows_read``) and each output once;
    operations are the function's own in tap form, over the window taps
    each slot's profiles hold (``b1_taps``): ``b1_contract_ops`` (the
    window build one row: its 8 columns are equal and its V ones, 1 add a
    tap), ``particle_ops`` p2g1 for the deposit (no e_d fix-up: a tap adds
    its own cell's moment), the raw form's 16 rows (57 a slot), the
    collect's 13 rows and its tail (59 a slot).
    The library call is one PyTorch call of the same function on inputs
    made beforehand (a fill: ``copy_`` of the first values over the output;
    a contraction: a full-fp32 ``torch.einsum`` from the profiles),
    checked against the plain version's output ``want``."""
    pos, kw = fn.args(*tensors)
    kernel = fn.kernel
    if kernel == "micro_stage_fill":
        src, view = pos
        nprog, tb, nval, shape = kw["nprog"], kw["tb"], kw["nval"], kw["out_shape"]
        tiles = (torch.arange(nprog, device=device)[:, None] * tb
                 + torch.arange(nval, device=device)).reshape(-1)
        vals = torch.zeros(shape[0], device=device)
        vals[: tiles.numel()] = tiles.float() if kw.get("nodma") else src.reshape(-1)[view.bases(tiles)]
        out = torch.empty(shape, device=device)
        first = vals.view(-1, *(1,) * (len(shape) - 1)).expand(shape)
        if kw.get("nodma"):
            nbytes = 0
        elif view.starts is not None:  # the union of the programs' blocks of tb * cap rows
            nbytes = rows_read(view, tiles[::nval], kw["seg_len"] // view.sb) * view.sb * F32
        else:  # disjoint blocks
            nbytes = nprog * kw.get("nseg", 1) * kw["seg_len"] * F32
        return (nbytes + out.numel() * F32, 0, lambda: out.copy_(first),
                lambda lib: torch.equal(lib, want))
    if kernel == "micro_window_contract":
        src, view, w, A, N = pos
        tiles = torch.arange(A, device=device)
        _, prof, base, _ = b1_profiles(src, view, None, w, tiles)
        V = (torch.ones((8, w.cap), device=device) if N == 0
             else mst.gather_tiles(src, view, tiles, N, w.cap))
        spec = "tap,tbp,tdp,np->tabdn" if N == 0 else "tap,tbp,tdp,tnp->tabdn"
        lib = lambda: torch.einsum(spec, prof[:, 0], prof[:, 1], prof[:, 2], V)  # noqa: E731
        taps = b1_taps(base, w.E)
        ops = b1_contract_ops(A * w.cap, taps, N) if N else 30 * A * w.cap + 3 * taps
        nbytes = rows_read(view, tiles, w.cap) * max(3, N) * F32 + want.numel() * F32
        scale = float(want.abs().max())
        return (nbytes, ops, lib, lambda out: float(
            (out.reshape(want.shape) - want).abs().max()) <= 1e-5 * scale)
    if kernel == "micro_p2g1_deposit":
        src, view, count, tid, w = pos
        form, written = kw["form"], kw["written"]
        tiles = torch.arange(written, device=device)
        pm, prof, base, dv = b1_profiles(src, view, tid, w, tiles, shifted=form != "current")
        valid = torch.arange(w.cap, device=device) < count[:written].long()[:, None]
        U = mst.p2g1_rows(pm, valid, base, dv)
        nvalid, taps = int(valid.sum()), b1_taps(base, w.E, valid)
        E = w.E
        if form == "raw":
            lib = lambda: torch.einsum("tap,tbp,tdp,trp->tabdr",  # noqa: E731
                                       prof[:, 0], prof[:, 1], prof[:, 2], U)
            ops, ch = 57 * nvalid + b1_contract_ops(nvalid, taps, 16), 16
        else:
            e = torch.arange(E, dtype=torch.float32, device=device)
            one = torch.ones(E, device=device)
            fix = torch.stack([torch.einsum("a,b,d->abd", *f) for f in
                               ((one, one, one), (e, one, one), (one, e, one), (one, one, e))])
            Uk = U.view(written, 4, 4, w.cap)
            lib = lambda: torch.einsum("tap,tbp,tdp,tkcp,kabd->tabdc",  # noqa: E731
                                       prof[:, 0], prof[:, 1], prof[:, 2], Uk, fix)
            ops, ch = particle_ops("p2g1", 3, nvalid, taps), 4
        written_out = mst.gather_tiles(want, kw["out_view"], tiles, w.E3, ch)
        nbytes = (nvalid * 16 + written * (1 if tid is None else 2)) * F32 + want.numel() * F32
        scale = float(written_out.abs().max())
        return (nbytes, ops, lib, lambda out: float(
            (out.reshape(written_out.shape) - written_out).abs().max()) <= 1e-5 * scale)
    src, view, v, v_view, m, m_view, w = pos  # micro_window_collect
    written, E, E3 = kw["written"], w.E, w.E3
    tiles = torch.arange(written, device=device)
    pm, prof, base, _ = b1_profiles(src, view, None, w, tiles)
    vb, mb = mst.gather_tiles(v, v_view, tiles, E3, 3), mst.gather_tiles(m, m_view, tiles, E3, 1)
    X, _, _ = mst.collect_x(pm, vb, mb, mst.tile_coords(tiles, None, w.tshape), w)
    Bcat = mst.bcat(vb, mb, E).view(written, E, E, E, 13)
    lib = lambda: torch.einsum("tap,tbp,tdp,tabdc->tcp",  # noqa: E731
                               prof[:, 0], prof[:, 1], prof[:, 2], Bcat)
    ops = b1_contract_ops(written * w.cap, b1_taps(base, E), 13) + 59 * written * w.cap
    nbytes = written * (w.cap * 4 + E3 * 4) * F32 + want.numel() * F32
    scale = float(X.abs().max())
    return nbytes, ops, lib, lambda out: float((out - X).abs().max()) <= 1e-5 * scale


def phase_micro_b1(device, card: str, reps: int = 10) -> dict:
    """M5-M8 in every case of ``micro_kernels.main`` (bench/micro_kernels.py's
    CASES and run_tb2/3/4) at n = 1,000,000 against their plain versions
    (fills bit-equal, contractions within 1e-5 x max|plain|), timed (CUDA
    events, mean of ``reps`` launches; the plain version over 2) beside the
    one PyTorch call of the same function and the bound; then
    ``micro_kernels.main`` over every group with the launch counters set to
    0 just before and read just after."""
    results = {name: {"kinds": {}} for name in mst.KERNELS}
    with full_fp32_einsum():
        for name, fn, tensors in b1_cases(device):
            got, want = fn(*tensors), fn.plain(*tensors)
            sync(device)
            err = float((got - want).abs().max())
            if fn.exact:
                check(torch.equal(got, want), f"{name}: bit-equal to its plain version")
            else:
                scale = float(want.abs().max())
                check(err <= 1e-5 * scale, f"{name}: max|err| {err} <= 1e-5 * {scale}")
            del got
            nbytes, ops, library, lib_ok = b1_measure(fn, tensors, want, device)
            check(lib_ok(library()), f"{name}: the library call agrees with the plain version")
            del want
            ms = time_ms(lambda: fn(*tensors), reps, device)
            plain_ms = time_ms(lambda: fn.plain(*tensors), 2, device)
            library_ms = time_ms(library, reps, device)
            bound_ms, bound_by = bound(nbytes, ops)
            results[fn.kernel]["kinds"][name] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}
            print(f"[micro b1] {fn.kernel} {name}: max_abs_err={err:.3e} kernel {ms:.4f} ms "
                  f"plain {plain_ms:.4f} ms library {library_ms:.4f} ms bound {bound_ms:.4f} ms "
                  f"({bound_by})  [{card}]", flush=True)
            del library, lib_ok
            torch.cuda.empty_cache()

    mst.reset_launches()
    print(f"[micro b1] python3 -m {mkb.__name__} --cases {B1_GROUPS}:", flush=True)
    check(mkb.main(["--cases", B1_GROUPS]) == 0, f"{mkb.__name__}.main() exits 0")
    launches = dict(mst.LAUNCHES)
    check(all(n > 0 for n in launches.values()),
          f"every stream-probe kernel launched by the entry point: {launches}")
    print(f"[micro b1] launches over the entry point: {launches}")
    torch.cuda.empty_cache()
    for name, r in results.items():
        first = next(iter(r["kinds"].values()))
        r.update({**first, "launches": launches[name], "launches_from": "micro_kernels entry point",
                  "on_path": False})
    return results


# fp32 operations each probe's function needs (2 a multiply-add; a selection,
# a copy or a pad none; p7: the 11 adds of each of its 8 x 128 row sums,
# then one add a lane to merge the two rolled parts that reach it; p11's
# coefficient is integer arithmetic)
B6_OPS = {"p1": 96 * 1024, "p2": 2 * 96 * 64 * 128, "p5": 2 * 96 * 64 * 128,
          "p6": 2 * 96 * 64 * 128, "p7": 8 * 11 * 128 + 512, "p8": 2 * 48 * 128,
          "p10": 7 * 16 * 128, "p11": 16 * 128}
B6_READ = {"p10": (64 * 128, 4 * 128)}  # floats read of each input where not all (wz rows 0-3)


def b6_library(name: str, xs):
    """One PyTorch call computing probe ``name``'s function on its inputs (views,
    p11's coefficient and p5's and p6's padded B made beforehand), or None
    where no one call does (p7)."""
    x = [t[0] for t in xs]
    if name == "p1":
        return lambda: torch.mul(x[0][:, None], x[1][None])
    if name == "p2":
        return lambda: torch.matmul(x[0], x[1].mT)
    if name in ("p5", "p6"):  # p6's construct: A [B; 0]^T, 64 zero rows of B read too
        Bp = torch.cat((x[1], torch.zeros_like(x[1])))
        return lambda: torch.matmul(x[0], Bp.mT)
    if name in ("p3", "p4"):
        view = x[0].reshape(mp.PROBES[name].out)
        return lambda: view.clone()
    if name in ("p8", "p9"):
        Y4 = x[0].view(12, 2, 4, 128)
        if name == "p8":
            return lambda: torch.add(Y4[:, 0], Y4[:, 1], alpha=2.0)
        return lambda: torch.cat((Y4[:, 0, :, :64], Y4[:, 1, :, :64]), -1)
    if name == "p10":
        X, w = x[0].view(16, 4, 128), x[1][:4]
        return lambda: torch.einsum("iql,ql->il", X, w)
    if name == "p11":
        r = torch.arange(16, device=x[0].device)[:, None]
        coeff = (2 * (r % 4) + (torch.arange(128, device=x[0].device) >= 64)).float()
        return lambda: torch.mul(x[0], coeff)
    if name == "p12":
        return lambda: x[0].repeat(16, 1)
    if name == "p13":
        return lambda: x[0].repeat(4, 1)
    return None


def phase_micro_b6(device, card: str, reps: int = 20) -> dict:
    """M9-M11 on each construct probe p1-p13 of bench/micro_zfac_probe.py
    against their plain versions on seeded normal inputs, as closely as
    ``Probe.tol`` says (M9 and p13 bit-equal, p10 within 1e-6 x max|plain|,
    the other contractions within 1e-5), timed (CUDA events, mean of ``reps``
    launches) beside the plain version, the one PyTorch call of the same
    function where there is one, the bound and the empty kernel's launch;
    then ``micro_zfac_probe.main`` with the launch counters set to 0 just
    before and read just after: it returns 0, prints the script's thirteen
    lines with the plain versions' sums on ones, and launches M9-M11."""
    results = {name: {"kinds": {}} for name in mp.KERNELS}
    empty = lambda: mp.empty_launch(device)  # noqa: E731
    floor_ms, graph_floor_ms = time_ms(empty, reps, device), graph_ms(empty, device)
    print(f"[micro b6] empty one-thread kernel: {floor_ms * 1e3:.2f} us a launch, "
          f"{graph_floor_ms * 1e3:.2f} us in a graph  [{card}]")
    with full_fp32_einsum():
        for seed, (name, f) in enumerate(zfp.PROBES.items()):
            xs = zfp.make_inputs(name, seed, device)
            got, want = f(*xs), f.plain(*xs)
            sync(device)
            spec = mp.PROBES[name]
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            if spec.tol == 0:
                check(torch.equal(got, want), f"{name}: bit-equal to its plain version")
            else:
                check(err <= spec.tol * scale, f"{name}: max|err| {err} <= {spec.tol} * {scale}")
            library = b6_library(name, xs)
            if library is not None:  # it sums in its own order: 1e-5 where the kernel is not exact
                lib = library().reshape(want.shape)
                lib_ok = (torch.equal(lib, want) if spec.tol == 0
                          else float((lib - want).abs().max()) <= 1e-5 * scale)
                check(lib_ok, f"{name}: the library call agrees with the plain version")
            reads = B6_READ.get(name, [t.numel() for t in xs])
            bound_ms, bound_by = bound((sum(reads) + got.numel()) * F32, B6_OPS.get(name, 0))
            call = lambda: f(*xs)  # noqa: E731
            ms, in_graph_ms = time_ms(call, reps, device), graph_ms(call, device)
            plain_ms = time_ms(lambda: f.plain(*xs), reps, device)
            library_ms = library_graph_ms = None
            if library is not None:
                library_ms, library_graph_ms = time_ms(library, reps, device), graph_ms(library, device)
            results[spec.kernel]["kinds"][name] = {
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "launch_floor_ms": floor_ms,
                "graph_ms": in_graph_ms, "library_graph_ms": library_graph_ms,
                "graph_floor_ms": graph_floor_ms}
            lib_text = ("none" if library is None else
                        f"{library_ms * 1e3:.2f} us (graph {library_graph_ms * 1e3:.2f})")
            print(f"[micro b6] {spec.kernel} {name}: max_abs_err={err:.3e} kernel "
                  f"{ms * 1e3:.2f} us ({ms / floor_ms:.2f}x the empty launch), graph "
                  f"{in_graph_ms * 1e3:.2f} us ({in_graph_ms / graph_floor_ms:.2f}x) plain "
                  f"{plain_ms * 1e3:.2f} us library {lib_text} bound {bound_ms * 1e3:.4f} us "
                  f"({bound_by})  [{card}]", flush=True)

    sums = {name: float(f.plain(*zfp.ones(name, device)).sum()) for name, f in zfp.PROBES.items()}
    mp.reset_launches()
    print(f"[micro b6] python3 -m {zfp.__name__}:", flush=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = zfp.main()
    launches = dict(mp.LAUNCHES)
    print(out.getvalue(), end="", flush=True)
    check(rc == 0, f"{zfp.__name__}.main() exits 0")
    lines = out.getvalue().splitlines()
    missing = [name for name, label in zfp.NAMES.items()
               if f"{label}: OK   sum={sums[name]:.1f}" not in lines]
    check(not missing, f"the script's lines with its sums, missing: {missing}")
    check(all(n > 0 for n in launches.values()),
          f"every probe kernel launched by the entry point: {launches}")
    print(f"[micro b6] launches over the entry point: {launches}")
    for name, r in results.items():
        first = next(iter(r["kinds"].values()))
        r.update({**first, "launches": launches[name],
                  "launches_from": "micro_zfac_probe entry point", "on_path": False})
    return results


def phase_goldens(device, card: str) -> None:
    for backend in ("stream", "pallas"):
        for name, make in (("golden_2d", default_2d), ("golden_3d", default_3d)):
            z = np.load(os.path.join(ROOT, "tests", "data", f"{name}.npz"))
            cfg = make(iterations=int(z["substeps"]))
            p = state.from_numpy(z["pos0"], z["vel0"], z["C0"], device=device)
            sess = Session(cfg, make_domain(cfg), p, backend=backend, device=device)
            sess.frame()
            got = sess.particles()
            worst = 0.0
            for f in ("pos", "vel", "C", "density", "pressure"):
                err = float(np.abs(getattr(got, f).cpu().numpy() - z[f]).max())
                check(err <= 1e-3, f"{backend} {name} {f} max|err| {err} <= 1e-3")
                worst = max(worst, err)
            print(f"[goldens] {backend} {name}: {int(z['substeps'])} substeps, "
                  f"max|err| {worst:.3e} <= 1e-3  [{card}]")


def rebin_check_cost_ms(sess: Session, device, substeps: int = 8, rounds: int = 3) -> float:
    """Per-substep cost of the frame loop's host read of ``needs_rebin``:
    the same substeps from the session's state, timed with and without the
    read (no re-bin is taken either way), in alternating order."""
    cfg, dom, spec = sess.cfg, sess.domain, sess.spec
    stages = stx.substep_stages(cfg, dom, spec, device)
    params = stx.collect_params(cfg, *step.no_mouse(), device)
    st0 = sess.stream_state()

    def run(read: bool) -> float:
        st = st0.clone()  # the substeps update their state in place
        sync(device)
        t0 = time.perf_counter()
        dep1 = stages.dep1(st)
        for _ in range(substeps):
            dep1 = stx._substep_core(st, dep1, stages, params)
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
    sess.compile_run(frames)
    sync(device)
    sk.reset_launches()
    t0 = time.perf_counter()
    sess.run(frames)  # strict: conservation + shell_drop checked after the span
    sync(device)
    dt_run = time.perf_counter() - t0
    check(not any(sk.LAUNCHES.values()), f"replays call no wrapper: {sk.LAUNCHES}")
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
          f"(graph captured in {sess.frame_graph.capture_s:.3f} s, instantiated in "
          f"{sess.frame_graph.instantiate_s:.3f} s)  [{card}]")

    # the launches of one replayed frame (its graph's kernel nodes, the
    # profiler witnessing) against the wrapper counters of the same frame
    # run eagerly from the same state
    st0, rb0 = sess.stream_state().clone(), sess.rebins()
    launches = replay_launches(sess, "slice")
    fired = sess.rebins() - rb0
    held = []
    eager = counted_launches(
        lambda: held.append(stx.frame_binned(st0, cfg, dom, sess.spec, *step.no_mouse(), n=n)))
    check(state_err(sess.stream_state(), held[0]) == 0.0, "replayed frame 3 bit-equal to eager")
    got = {k: v["launches"] for k, v in launches.items()}
    check(got == eager, f"replayed frame's launches {got} == the eager frame's {eager} "
                        f"({fired} re-bins fired in the replay)")
    per_sub = ("deposit_p2g2", "collect", "halo_axis", "halo_gblk")
    check(all(got[k] == cfg.iterations for k in per_sub) and got["deposit_p2g1"] == 1 + fired
          and all(got[k] == fired for k in REBIN_KERNELS),
          f"K2-K5 once per substep, K1 once plus once per re-bin ({fired}), the re-bin's "
          f"kernels once per re-bin: {got}")
    launches = {k: launches[k] for k in sk.KERNELS}
    print(f"[slice] replayed frame {frames + 1}: launches {summary(launches)} == the eager "
          f"frame's (wrapper counters); {fired} re-bins fired in it  [{card}]")
    del st0

    # steady state: one more frame, timed alone (the dam passes 128 slots a
    # tile near its fifth frame), and the host sync share
    t0 = time.perf_counter()
    sess.run(1)
    sync(device)
    dt2 = time.perf_counter() - t0
    print(f"[slice] steady frame {frames + 2}: {dt2 * 1e3:.1f} ms/frame "
          f"{n * cfg.iterations / dt2:.4e} particle-steps/s rebins={sess.rebins()}  [{card}]")
    check(sess.live_count() == n and sess.shell_drop() == 0, f"conservation after {frames + 2} frames")

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


def phase_pallas_slice(card: str, n: int = N_1M, frames: int = 1):
    """The pallas backend's main path through the entry points a user
    calls, with no device argument anywhere: the state lands on the card."""
    cfg, p, dom = scene.scaled_dam_break(torch.Generator().manual_seed(0), n)
    device = p.device
    check(device.type == "cuda", f"the scene defaults to the card, not {device}")
    spec = tt.default_spec(cfg, n)
    check(int(tt.overflow_count(p.pos, dom, spec)) == 0, "no overflow at t=0")
    y0 = float(p.pos[:, 1].mean())
    sess = Session(cfg, dom, p, backend="pallas")
    check(sess.device.type == "cuda", f"Session defaults to the card, not {sess.device}")
    sess.compile_run(frames)
    sync(device)
    pk.reset_launches()
    sk.reset_launches()
    t0 = time.perf_counter()
    sess.run(frames)
    sync(device)
    dt_run = time.perf_counter() - t0
    check(not any(pk.LAUNCHES.values()) and not any(sk.LAUNCHES.values()),
          f"replays call no wrapper: {pk.LAUNCHES} {sk.LAUNCHES}")
    q = sess.particles()
    check(int(tt.overflow_count(q.pos, dom, spec)) == 0, "no overflow after the frame")
    check(q.n == n and float(q.mass.sum()) == float(n), "mass conserved")
    for f in state.FIELDS:
        check(bool(torch.isfinite(getattr(q, f)).all()), f"finite {f}")
    y1 = float(q.pos[:, 1].mean())
    check(y1 > y0, f"mean y rose ({y0:.4f} -> {y1:.4f}; +y is down)")
    steps = frames * cfg.iterations
    print(f"[pallas slice] n={n} frames={frames} substeps={steps} {dt_run * 1e3 / frames:.1f} ms/frame "
          f"{n * steps / dt_run:.4e} particle-steps/s A={tt.bin_particles(q.pos, dom, spec)['n_active']} "
          f"cap={spec.cap} mean_y {y0:.3f}->{y1:.3f}  [{card}]")

    # one replayed frame's launches (graph nodes, the profiler witnessing)
    # against the eager frame's
    launches = replay_launches(sess, "pallas slice")
    eager = counted_launches(lambda: step.frame(q, cfg, dom, *step.no_mouse(), "pallas"))
    got = {k: v["launches"] for k, v in launches.items()}
    check(got == eager, f"replayed frame's launches {got} == the eager frame's {eager}")
    check(all(got[k] == cfg.iterations for k in PALLAS_ON_PATH)
          and got["pallas_deposit_force"] == 0 and not any(got[k] for k in sk.KERNELS),
          f"K6, K7, K8 once per substep, no other csrc kernel: {got}")
    launches = {k: launches[k] for k in pk.KERNELS}
    print(f"[pallas slice] replayed frame {frames + 1}: launches {summary(launches)} == the "
          f"eager frame's (wrapper counters)  [{card}]")

    t0 = time.perf_counter()
    sess.frame()
    sync(device)
    dt2 = time.perf_counter() - t0
    print(f"[pallas slice] steady frame {frames + 2}: {dt2 * 1e3:.1f} ms/frame "
          f"{n * cfg.iterations / dt2:.4e} particle-steps/s  [{card}]")

    # one substep from the same state: pallas vs dense, and the grid mass
    mid = sess.particles()
    mp, ma = step.no_mouse()
    a, ga = step.substep(mid, cfg, dom, mp, ma, backend="pallas")
    b, _ = step.substep(mid, cfg, dom, mp, ma, backend="dense")
    dpos = float((a.pos - b.pos).abs().max())
    dvel = float((a.vel - b.vel).abs().max())
    check(dpos <= 1e-4, f"pallas vs dense max|dpos| {dpos} <= 1e-4")
    grid_mass = float(ga.mass.double().sum())
    check(abs(grid_mass - n) <= 1e-4 * n, f"grid mass {grid_mass} == n within 1e-4")
    print(f"[pallas slice] pallas vs dense, one substep: max|dpos| {dpos:.3e} max|dvel| {dvel:.3e} "
          f"grid mass {grid_mass:.2f} of {n}  [{card}]")
    return launches


def frame_ms(run, frames: int, device) -> list:
    """Host ms of each of ``frames`` calls of ``run()``, each ended by a
    synchronize."""
    out = []
    for _ in range(frames):
        sync(device)
        t0 = time.perf_counter()
        run()
        sync(device)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def state_err(a, b) -> float:
    """Largest |a - b| over the fields of two states of one kind."""
    return max(float((getattr(a, f.name).double() - getattr(b, f.name).double()).abs().max())
               for f in dataclasses.fields(a))


def differ(a, b) -> list:
    """The fields of two states of one kind that are not bit-equal."""
    return [f.name for f in dataclasses.fields(a)
            if not torch.equal(getattr(a, f.name), getattr(b, f.name))]


def graph_vs_eager(sess, eager_step, start, frames: int, what: str, card: str, tol: float = 0.0,
                   profile_eager: bool = True) -> dict:
    """A strict=False ``sess``, its graph not yet captured, against
    ``eager_step(state) -> state`` from ``start``, the session's state
    before: ``compile_run`` leaves the state bit-equal; one frame of each,
    the states bit-equal (tol 0) or within tol; then ``frames`` more frames
    of each, timed one by one, and bit-equal again (tol 0 only: a backend
    whose sums have no fixed order drifts apart over frames); the median
    ms per frame of each path, each path's peak memory (the graph's with
    its warm-up and capture), the capture and instantiation seconds; one
    profiled frame of each path (of the graph's only, without
    ``profile_eager``).  Returns the medians and the eager path's state."""
    device = sess.device
    held = [start]

    def eager():
        held[0] = eager_step(held[0])

    def peak(run):
        torch.cuda.reset_peak_memory_stats(device)
        out = run()
        return out, torch.cuda.max_memory_allocated(device) / 2**30

    torch.cuda.reset_peak_memory_stats(device)
    sess.compile_run()
    check(not differ(sess.frame_graph.state, start),
          f"{what}: compile_run left the state as it was, differ {differ(sess.frame_graph.state, start)}")
    sess.frame()
    g_peak = torch.cuda.max_memory_allocated(device) / 2**30
    _, e_peak = peak(eager)
    err = state_err(sess.frame_graph.state, held[0])
    check(err <= tol, f"{what}: one frame, graph vs eager max|err| {err} <= {tol}")
    g_ms, g_peak2 = peak(lambda: frame_ms(sess.frame, frames, device))
    e_ms, e_peak2 = peak(lambda: frame_ms(eager, frames, device))
    if tol == 0.0:
        check(not differ(sess.frame_graph.state, held[0]),
              f"{what}: {frames + 1} frames, graph bit-equal to eager")
    g_ms, e_ms = float(np.median(g_ms)), float(np.median(e_ms))
    fg = sess.frame_graph
    print(f"[graph] {what}: compile_run left the state bit-equal; {frames + 1} frames "
          f"{'bit-equal' if tol == 0.0 else f'(the first within {tol}: {err:.3e})'}; "
          f"ms/frame median of frames 2-{frames + 1} eager {e_ms:.3f} graph {g_ms:.3f} "
          f"({e_ms / g_ms:.2f}x); peak memory eager {max(e_peak, e_peak2):.3f} GiB, graph "
          f"{max(g_peak, g_peak2):.3f} GiB; capture {fg.capture_s:.3f} s, instantiate "
          f"{fg.instantiate_s:.3f} s  [{card}]")
    profile_frame(sess, f"{what} graph", card, top=3, tag="graph")
    if profile_eager:
        profile_frame(types.SimpleNamespace(device=device, frame=eager), f"{what} eager", card,
                      top=3, tag="graph")
    return {"graph_ms": g_ms, "eager_ms": e_ms, "eager_state": held[0]}


def graph_stream_1m(device, card: str, frames: int = 5) -> None:
    """The stream Session of the 1M dam on its graph against eager
    ``frame_binned`` from the same state, every field compared bit for
    bit: ``graph_vs_eager`` (``compile_run`` changes nothing, 1 + ``frames``
    frames timed on each path); then ``run(frames)`` equals ``frames``
    eager frames, with re-bins fired inside the replays; two frames with
    the mouse on, moved between the replays (a host and a device mouse)
    with no recapture; a replayed frame that makes no synchronizing call,
    where the eager frame makes one."""
    cfg, p, dom = dam_1m(device)
    n, (mp, ma) = p.n, step.no_mouse()
    sess = Session(cfg, dom, p, backend="stream", device=device, strict=False)

    def eager_step(st, mouse=(mp, ma), substeps=None):
        return stx.frame_binned(st, cfg, dom, sess.spec, *mouse, substeps, n=n)

    held = [graph_vs_eager(sess, eager_step, sess.stream_state().clone(), frames,
                           f"stream 1M dam (n={n})", card)["eager_state"]]

    def eager(*args):
        held[0] = eager_step(held[0], *args)

    def same(what):
        check(not differ(sess.stream_state(), held[0]),
              f"graph 1M {what}: bit-equal to eager frame_binned, differ "
              f"{differ(sess.stream_state(), held[0])}")

    rb0 = sess.rebins()
    sync(device)
    t0 = time.perf_counter()
    sess.run(frames)
    sync(device)
    run_ms = (time.perf_counter() - t0) * 1e3 / frames
    for _ in range(frames):
        eager()
    same(f"run({frames})")
    fired = sess.rebins() - rb0
    check(fired >= 1, f"graph 1M: re-bins fired inside the replayed frames of run({frames}) ({fired})")
    print(f"[graph] stream 1M dam (n={n}, A={sess.spec.A}): run({frames}) {run_ms:.2f} ms/frame, "
          f"bit-equal to {frames} eager frame_binned frames, {fired} re-bins fired inside its "
          f"replayed frames  [{card}]")

    graph = sess.frame_graph.graph
    cx, cy = (float(v) for v in p.pos[:, :2].mean(dim=0))
    for k, mouse in enumerate((step.mouse((cx, cy)),
                               tuple(t.to(device) for t in step.mouse((cx + 8.0, cy - 4.0))))):
        sess.frame(mouse)
        eager(mouse)
        same(f"mouse frame {k}")
    check(sess.frame_graph.graph is graph, "graph 1M: the mouse moved with no recapture")

    sync(device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.frame()  # strict=False: no check after it either
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager((mp, ma), 1)
        eager_sync = ""
    except RuntimeError as e:
        eager_sync = str(e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(eager_sync), "graph 1M: the eager frame makes a synchronizing call")
    eager()  # that frame again, in full, without the debug mode
    same("the frame replayed under the sync debug mode")
    print(f"[graph] stream 1M: two mouse frames, the mouse moved between replays (host, then "
          f"device tensors), bit-equal with no recapture; a replayed frame under "
          f"set_sync_debug_mode('error') made no synchronizing call, the eager frame does "
          f"({eager_sync.splitlines()[0][:60]!r}); {sess.rebins()} re-bins in "
          f"{2 * frames + 5} replayed frames, live {sess.live_count()} of {n}  [{card}]")
    del sess, held
    torch.cuda.empty_cache()


def phase_graph(device, card: str, frames: int = 20) -> None:
    """The frame as one CUDA graph: the IF-node probe, the 1M stream dam
    (``graph_stream_1m``), then graph against eager (``graph_vs_eager``) for
    the stream, pallas and dense backends at the 3D reference scene (1 +
    ``frames`` frames; dense's first frame within 1e-4, as ``index_add_``
    sums in no fixed order on the card) and pallas at the 1M dam (1 + 5).
    The tiled and sorted cells run in phase_backends."""
    print(f"[graph] IF-node probe: a graph with one IF node adds only where its predicate "
          f"holds ({probe_if_node(device)})  [{card}]")
    t_cell = time.perf_counter()
    graph_stream_1m(device, card)
    print(f"[time] graph stream 1M dam: {time.perf_counter() - t_cell:.1f} s")
    mp, ma = step.no_mouse()
    for backend, cell, count, tol in (("stream", "3D reference scene", frames, 0.0),
                                      ("pallas", "3D reference scene", frames, 0.0),
                                      ("dense", "3D reference scene", frames, 1e-4),
                                      ("pallas", "1M dam", 5, 0.0)):
        t_cell = time.perf_counter()
        if cell == "1M dam":
            cfg, p, dom = dam_1m(device)
        else:
            cfg, p, dom = scene.reference_scene_3d(seed=0, device=device)
        sess = Session(cfg, dom, p, backend=backend, device=device, strict=False)
        if backend == "stream":
            start = sess.stream_state().clone()
            eager = lambda st: stx.frame_binned(st, cfg, dom, sess.spec, mp, ma, n=p.n)  # noqa: E731
        else:
            start = sess.particles()
            eager = lambda q: step.frame(q, cfg, dom, mp, ma, backend)  # noqa: E731
        graph_vs_eager(sess, eager, start, count, f"{backend} {cell} (n={p.n})", card, tol)
        del sess, start, p
        torch.cuda.empty_cache()
        print(f"[time] graph {backend} {cell}: {time.perf_counter() - t_cell:.1f} s")


def phase_replay(device, card: str) -> None:
    for backend in ("stream", "pallas"):
        cfg, p, dom = scene.reference_scene_3d(seed=0, device=device)
        sess = Session(cfg, dom, p, backend=backend, device=device)
        snap = sess.snapshot()
        sess.frame()
        a = sess.particles()
        sess.restore(snap)
        sess.frame()
        b = sess.particles()
        for f in state.FIELDS:
            check(torch.equal(getattr(a, f), getattr(b, f)), f"{backend} replay bit-identical: {f}")
        reps = 5
        sync(device)
        t0 = time.perf_counter()
        sess.run(reps)
        sync(device)
        dt = time.perf_counter() - t0
        print(f"[replay] {backend} 3D reference scene (n={p.n}): snapshot replay bit-identical; "
              f"{dt * 1e3 / reps:.2f} ms/frame {p.n * cfg.iterations * reps / dt:.4e} "
              f"particle-steps/s rebins={sess.rebins()}  [{card}]")


# (viewport, console) of the render checks: the app's; a viewport whose
# sides are no powers of two, so that a division and a product with the
# reciprocal can bin a point differently; a console of exactly the kernel's
# largest shared-memory grid (SMEM_BINS, csrc/render_kernels.cu: 12,288
# bins, 48 KB) and one past it
RENDER_VIEWS = (((64.0, 64.0), (80, 40)), ((70.0, 50.0), (60, 30)), ((64.0, 64.0), (128, 96)),
                ((64.0, 64.0), (200, 80)))


def render_check(x, y, count, what: str, card: str, x_shift: float = 0.0) -> None:
    """console_histogram against histogram_xy (the plain version) on the
    same card tensors, bit for bit, at each of RENDER_VIEWS, twice into one
    grid (the second call zeroes what the first wrote)."""
    valid = (torch.ones(x.shape, dtype=torch.bool, device=x.device) if count is None
             else torch.arange(x.shape[-1], device=x.device)[None, :] < count[:, None])
    for viewport, console in RENDER_VIEWS:
        out = torch.full((console[1], console[0]), 7, dtype=torch.int32, device=x.device)
        want = render.histogram_xy(x + x_shift if x_shift else x, y, valid, viewport, console)
        for k in range(2):
            got = render.console_histogram(x, y, count, viewport, console, out, x_shift=x_shift)
            check(torch.equal(got, want), f"render {what} {viewport} {console}: launch {k + 1} "
                                          f"bit-equal to histogram_xy ({int((got != want).sum())} bins differ)")
    print(f"[render] {what}: console_histogram bit-equal to histogram_xy at {len(RENDER_VIEWS)} "
          f"views, twice into one grid, {int(want.sum())} points in the last  [{card}]")


def edge_points(viewport, console, device) -> torch.Tensor:
    """[N, 2] points on every console cell edge in x and y (the float32
    value of k * side / cells, k = 0 .. cells, the last on the viewport's
    far edge), each beside its float32 neighbours, and -0.0, all crossed."""
    axes = []
    for side, cells in zip(viewport, console):
        e = np.float32(np.arange(cells + 1)) * np.float32(side) / np.float32(cells)
        axes.append(torch.from_numpy(np.concatenate([
            e, np.nextafter(e, np.float32(-np.inf)), np.nextafter(e, np.float32(np.inf)),
            np.float32([-0.0])])))
    xs, ys = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(device)


def render_parts_ms(sess: Session, viewport, console, frames: int) -> dict:
    """Median host ms of the render and its parts (the recorder's spans
    ``render``, ``histogram``, ``read``, ``ascii``) over ``frames`` renders
    of ``sess``, back to back, untraced."""
    t0 = time.perf_counter_ns()
    for _ in range(frames):
        sess.render(viewport, console)
    spans = recorder().records(t0, time.perf_counter_ns()).spans
    parts = {}
    for name in ("render", "histogram", "read", "ascii"):
        parts[name] = float(np.median([(b - a) * 1e-6 for n, _, a, b in spans if n == name]))
    return parts


def render_device_ops(sess: Session, viewport, console, device, renders: int = 5) -> dict:
    """name -> count of the device events (kernels, copies, memsets) of
    ``renders`` renders of ``sess`` under torch.profiler, the console
    kernel's as "console_histogram"."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(renders):
            sess.render(viewport, console)
        sync(device)
    ops: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = "console_histogram" if "console_histogram_kernel" in e.name else e.name
            ops[name] = ops.get(name, 0) + 1
    return dict(sorted(ops.items()))


def graph_render_ms(sess: Session, viewport, console, device, frames: int) -> tuple:
    """Median host ms of the histogram and the read done two ways, in
    turns: one call of the kernel's entry point (memset and launch), then
    the copy into pinned memory and a wait (the alternative); one replay of
    a CUDA graph of the memset, the launch and the copy, then the wait
    (``Session.render``'s, ``render.ConsoleView``)."""
    grid = torch.empty((console[1], console[0]), dtype=torch.int32, device=device)
    host = torch.empty(grid.shape, dtype=torch.int32, pin_memory=True)
    x, y, count = sess._points
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        render.console_histogram(x, y, count, viewport, console, grid)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        render.console_histogram(x, y, count, viewport, console, grid)
        host.copy_(grid, non_blocking=True)
    stream = torch.cuda.current_stream(device)
    launch, replay = [], []
    for _ in range(frames):
        t0 = time.perf_counter()
        render.console_histogram(x, y, count, viewport, console, grid)
        host.copy_(grid, non_blocking=True)
        stream.synchronize()
        t1 = time.perf_counter()
        graph.replay()
        stream.synchronize()
        t2 = time.perf_counter()
        launch.append(t1 - t0)
        replay.append(t2 - t1)
    want = sess.histogram(viewport, console).cpu()
    check(torch.equal(host, want), "render: the graph's replay reads the kernel's grid")
    return float(np.median(launch)) * 1e3, float(np.median(replay)) * 1e3


def phase_render(device, card: str, frames: int = 200, reps: int = 20) -> dict:
    """The console render's kernel (csrc/render_kernels.cu) against its
    plain version, histogram_xy, bit for bit on the same card tensors: the
    2D and 3D reference scenes (strict stream Sessions) after the centroid
    mouse frame and ``frames`` frames of a drag, the 1M dam at the
    benchmark's layout after 40 frames, the 2D scene with garbage (in-view
    xy and NaN) written into the slots past each tile's count, the sharded
    path's shifted x, and points on every console cell edge and on the
    viewport's far edge, each at RENDER_VIEWS; a Session's render lines
    equal the plain grid's.  Then, untraced, the host ms of a render and of
    its parts (recorder spans) at the reference scenes, the launch-and-read
    against one replay of a captured graph of both, and the kernel's and
    the plain version's device ms beside the byte bound.  Returns the
    kernel's table entry."""
    render.LAUNCHES["console_histogram"] = 0
    viewport, console = RENDER_VIEWS[0]
    out, launches_per_render = {}, {}
    for dim, make in ((2, scene.reference_scene_2d), (3, scene.reference_scene_3d)):
        cfg, p, dom = make(seed=0, device=device)
        sess = Session(cfg, dom, p, backend="stream", device=device)
        sess.frame(step.mouse([float(v) for v in p.pos[:, :2].mean(dim=0)]))
        for k in range(frames):
            t = k / (frames - 1)
            sess.frame(step.mouse((8.0 + 48.0 * t, 56.0 - 40.0 * t)))
        sync(device)
        check(sess.live_count() == p.n, f"render {dim}D: conservation after the drag")
        st = sess.stream_state()
        x, y, _ = sess._points
        what = f"{dim}D reference scene after the mouse frame and {frames} drag frames"
        render_check(x, y, st.count, what, card)
        for vp, con in RENDER_VIEWS:
            valid = torch.arange(x.shape[-1], device=device)[None, :] < st.count[:, None]
            want = render.ascii_frame(render.histogram_xy(x, y, valid, vp, con).cpu())
            check(sess.render(vp, con) == want and sess.render(vp, con) == want,
                  f"render {what}: Session.render's lines at {vp} {con}, eager then replayed")
        if dim == 2:
            render_check(x, y, st.count, f"{what}, x shifted by 3.25", card, x_shift=3.25)
            junk = st.stream.clone()
            dead = torch.arange(junk.shape[-1], device=device)[None, :] >= st.count[:, None]
            gen = torch.Generator(device=device).manual_seed(5)
            junk[:, 0, :][dead] = torch.rand(int(dead.sum()), generator=gen, device=device) * 64.0
            junk[:, 1, :][dead] = torch.rand(int(dead.sum()), generator=gen, device=device) * 64.0
            junk[:, 0, -1][dead[:, -1]] = float("nan")
            render_check(junk[:, 0, :], junk[:, 1, :], st.count,
                         f"{what}, garbage in the {int(dead.sum())} dead slots", card)
            clean = render.console_histogram(junk[:, 0, :], junk[:, 1, :], st.count, viewport, console)
            check(torch.equal(clean, sess.histogram(viewport, console)),
                  "render: the dead slots' garbage adds nothing")
            del junk
        before = render.LAUNCHES["console_histogram"]
        parts = render_parts_ms(sess, viewport, console, 300)
        check(render.LAUNCHES["console_histogram"] == before,
              f"render {dim}D: Session.render replays its graph (no wrapper call)")
        renders = 5
        ops = render_device_ops(sess, viewport, console, device, renders)
        kinds = {"console_histogram": 0, "memcpy": 0, "memset": 0}
        for name, n in ops.items():
            kind = ("console_histogram" if name == "console_histogram" else
                    "memcpy" if name.startswith("Memcpy DtoH") else
                    "memset" if name.lower().startswith("memset") else name)
            kinds[kind] = kinds.get(kind, 0) + n
        check(kinds == {k: renders for k in ("console_histogram", "memcpy", "memset")},
              f"render {dim}D: each of {renders} replayed renders runs one memset, one kernel and "
              f"one copy to pinned memory, nothing else: {ops}")
        launches_per_render[dim] = kinds["console_histogram"] / renders
        print(f"[render] {dim}D: {renders} replayed renders ran {ops} on the card (profiler)  "
              f"[{card}]")
        launch_ms, replay_ms = graph_render_ms(sess, viewport, console, device, 300)
        live, rows = p.n, x.shape[0]
        bound_ms, bound_by = bound(live * 2 * F32 + rows * 4 + console[0] * console[1] * 4, 0)
        grid = torch.empty((console[1], console[0]), dtype=torch.int32, device=device)
        kern = lambda: render.console_histogram(x, y, st.count, viewport, console, grid)  # noqa: E731
        kern_ms, kern_graph_ms = time_ms(kern, reps, device), graph_ms(kern, device)
        plain_ms = time_ms(lambda: render.histogram_xy(  # the valid mask inside, as it was
            x, y, torch.arange(x.shape[-1], device=device)[None, :] < st.count[:, None], viewport,
            console), reps, device)
        print(f"[render] {dim}D reference scene (n={live}, A={rows}, cap={x.shape[-1]}), untraced, "
              f"median of 300 renders: render {parts['render']:.4f} ms = histogram "
              f"{parts['histogram']:.4f} + read {parts['read']:.4f} + ascii {parts['ascii']:.4f}; "
              f"a graph replay of the launch and the copy, then the wait (Session.render's) "
              f"{replay_ms:.4f} ms against launch, copy and wait {launch_ms:.4f} ms; "
              f"kernel {kern_ms:.4f} ms eager, {kern_graph_ms:.4f} ms in a graph, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by})  [{card}]")
        out[f"ref{dim}d"] = {"ms": kern_ms, "graph_ms": kern_graph_ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by, "render_ms": parts,
                             "launch_read_ms": launch_ms, "graph_replay_read_ms": replay_ms}
        del sess, grid
    for vp, con in RENDER_VIEWS[:2]:
        pts = edge_points(vp, con, device)
        render_check(pts[:, 0], pts[:, 1], None, f"{pts.shape[0]} points on the cell edges of {con}",
                     card)
        true_div = torch.floor(pts / torch.tensor(vp, device=device) * torch.tensor(con, device=device))
        plain = torch.floor(torch.stack([pts[:, 0] / vp[0] * con[0], pts[:, 1] / vp[1] * con[1]], -1))
        print(f"[render] {vp} {con}: {int((true_div != plain).any(-1).sum())} of the edge points "
              f"bin otherwise by a true division than by PyTorch's product with the reciprocal  [{card}]")
    cfg1, p1, dom1 = dam_1m(device)
    nt1 = int(np.prod([s // 4 for s in dom1.shape]))
    sess = Session(cfg1, dom1, p1, backend="stream", device=device,
                   spec=stx.StreamSpec(tile=4, cap=256, halo=2, active=nt1))
    sess.run(40)
    sync(device)
    st = sess.stream_state()
    x, y, _ = sess._points
    render_check(x, y, st.count, "1M dam (T=4, cap 256, every tile) after 40 frames", card)
    grid = torch.empty((console[1], console[0]), dtype=torch.int32, device=device)
    kern_ms = time_ms(lambda: render.console_histogram(x, y, st.count, viewport, console, grid), reps,
                      device)
    plain_ms = time_ms(lambda: render.histogram_xy(
        x, y, torch.arange(x.shape[-1], device=device)[None, :] < st.count[:, None], viewport,
        console), reps, device)
    bound_ms, bound_by = bound(N_1M * 2 * F32 + x.shape[0] * 4 + console[0] * console[1] * 4, 0)
    print(f"[render] 1M dam: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by})  [{card}]")
    launches = render.LAUNCHES["console_histogram"]
    check(launches > 0, "render: the kernel launched")
    del sess, st, x, y, grid
    torch.cuda.empty_cache()
    ref = out["ref2d"]
    return {"ms": ref["ms"], "graph_ms": ref["graph_ms"], "plain_ms": ref["plain_ms"],
            "bound_ms": ref["bound_ms"], "bound_by": ref["bound_by"],
            "launches_per_frame": launches_per_render[2],
            "launches_from": "profiler: kernel events over 5 replayed renders (Session.render), "
                             f"2D {launches_per_render[2]:g}, 3D {launches_per_render[3]:g} a render",
            "on_path": "app render",
            "kinds": {"ref3d": out["ref3d"], "1M": {"ms": kern_ms, "plain_ms": plain_ms,
                                                     "bound_ms": bound_ms, "bound_by": bound_by}},
            "render_ms": ref["render_ms"], "launch_read_ms": ref["launch_read_ms"],
            "graph_replay_read_ms": ref["graph_replay_read_ms"]}


def big_tile_spec(cfg, dom, pos):
    """bench.py's big-tile stream spec (``_stream_spec_big``, :231-266), the
    `3d-1m` race candidate: T=8, cap=1024, halo 2, A twice the needed-relay
    closure of the tiles occupied at t=0 (at most nt and 110,000); None when
    the fullest tile at t=0 holds more than 2/3 of the cap."""
    T, cap = 8, 1024
    tshape = tuple(s // T for s in dom.shape)
    nt = int(np.prod(tshape))
    if nt < 8:
        return None
    probe = stx.StreamSpec(tile=T, cap=128, halo=2, active=1)
    cnt = torch.bincount(stx._keys_from_pos(pos, dom, probe, tshape), minlength=nt)
    dil = int(stx._active_set(cnt > 0, tshape).sum())
    if int(cnt.max()) * 3 > cap * 2:
        return None
    return stx.StreamSpec(tile=T, cap=cap, halo=2, active=min(dil * 2, nt, 110_000))


def phase_big_tile(device, card: str, n: int = N_1M) -> None:
    """One strict Session(stream) frame of the 1M dam at the big-tile spec
    (conservation and shell_drop 0 checked by the session), every stream
    kernel launched, then one substep from its state against dense; a
    frame of the default spec (T=4, cap=128) from the same start beside
    it."""
    cfg, p, dom = dam_1m(device, n)
    spec = big_tile_spec(cfg, dom, p.pos)
    check(spec is not None, "big-tile spec feasible for the 1M dam")
    ms = {}
    for name, sp in (("T=8 cap=1024", spec), ("T=4 cap=128", None)):
        sess = Session(cfg, dom, p, backend="stream", spec=sp, device=device)
        torch.cuda.reset_peak_memory_stats(device)
        sess.compile_run()
        launches = replay_launches(sess, f"big tile {name}")
        launches = {k: launches[k]["launches"] for k in sk.KERNELS}
        check(all(v > 0 for v in launches.values()), f"big tile {name}: every kernel launched {launches}")
        sync(device)
        t0 = time.perf_counter()
        sess.frame()  # strict: sum(count) == n and shell_drop == 0
        sync(device)
        ms[name] = (time.perf_counter() - t0) * 1e3
        check(sess.live_count() == n and sess.shell_drop() == 0, f"big tile {name}: strict checks")
        print(f"[big tile] 1M dam, stream {name}: A={sess.spec.A} frame 2 {ms[name]:.1f} ms "
              f"{n * cfg.iterations / ms[name] * 1e3:.4e} particle-steps/s rebins={sess.rebins()} "
              f"need_peak={sess.need_peak()} peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB; frame 1 launches={launches} "
              f"(graph nodes, profiler witnessing)  [{card}]")
        if sp is spec:
            mid = sess.particles()
        del sess
    mp, ma = step.no_mouse()
    a = stx.frame(mid, cfg, dom, mp, ma, spec=spec, substeps=1)
    b, _ = step.substep(mid, cfg, dom, mp, ma, backend="dense")
    dpos = float((a.pos - b.pos).abs().max())
    check(dpos <= 1e-4, f"big tile: one substep vs dense max|dpos| {dpos} <= 1e-4")
    print(f"[big tile] one substep from frame 2 vs dense: max|dpos| {dpos:.3e}; ms of frame 2 "
          f"T=8 cap=1024 {ms['T=8 cap=1024']:.1f} beside T=4 cap=128 {ms['T=4 cap=128']:.1f}  [{card}]")
    del mid, a, b
    torch.cuda.empty_cache()


def tiled_spec(cfg, dom, n: int):
    """bench.py's tiled budget (``_tiled_spec``, :78-103) for one scene:
    T=4, cap 2.5x the rest-density tile rounded up to 32, A 8x (n <= 4,096)
    or 1.8x the rest-density tile count rounded up to 64 (at most nt),
    strict (overflow is checked instead)."""
    T = 4
    per_tile = cfg.rest_density * T**cfg.dim
    cap = max(32, -(-int(per_tile * 2.5) // 32) * 32)
    occupied = max(64, int(n / max(per_tile, 1.0) * (8.0 if n <= 4096 else 1.8)))
    active = min(-(-occupied // 64) * 64, int(np.prod([s // T for s in dom.shape])))
    return tt.TileSpec(tile=T, cap=cap, active=active, strict=True)


# bench.py's CONFIGS that race the tiled backend (name, dim, particles,
# timed frames: bench's, and at least 20 at the reference scenes)
# and the 3D 1M dam, which only the sorted backend runs here
BACKEND_CELLS = (("2d-ref", 2, 4096, 20), ("3d-ref", 3, 4096, 20), ("2d-100k", 2, 100_000, 5),
                 ("3d-1m", 3, N_1M, 3))


def config_scene(dim: int, n: int):
    """bench.py's ``_make_scene`` (:44-75): the reference config with a
    4-cell halo for n <= 4,096, the scaled dam otherwise; on the card."""
    gen = torch.Generator().manual_seed(0)
    if n <= scene.REFERENCE_N:
        cfg = default_2d() if dim == 2 else default_3d()
        p, _ = scene.dam_break(gen, cfg, n)
        return cfg, p, make_domain(cfg, halo_cells=4)
    return scene.scaled_dam_break(gen, n, dim=dim)


def phase_backends(card: str) -> None:
    """The tiled and sorted backends on the card, through the entry points
    (no device argument), on the cells of BACKEND_CELLS (tiled on all but
    the 1M dam, under ``tiled_spec``): no overflow at t=0; one substep
    against dense from the same state (max|dpos| <= 1e-4, grid mass n
    within 1e-4); a Session run of the cell's frames ending in a
    synchronize; no overflow after it, finite fields; a snapshot replay
    bit-identical; no stream or pallas kernel launched; ms per frame,
    particle-steps/s, peak memory; one profiled substep."""
    mp, ma = step.no_mouse()
    for backend in ("tiled", "sorted"):
        for name, dim, n, frames in BACKEND_CELLS:
            if backend == "tiled" and name == "3d-1m":
                continue  # as bench.py: at 1M a contraction's intermediate is ~10 GB
            t_cell = time.perf_counter()
            cfg, p, dom = config_scene(dim, n)
            device = p.device
            check(device.type == "cuda", f"{name}: the scene defaults to the card, not {device}")
            spec = tiled_spec(cfg, dom, n) if backend == "tiled" else None
            if spec is not None:
                check(int(tt.overflow_count(p.pos, dom, spec)) == 0, f"tiled {name}: no overflow at t=0")
            sk.reset_launches()
            pk.reset_launches()
            if spec is not None:
                a, ga = tt.substep(p, cfg, dom, mp, ma, spec)
            else:
                a, ga = step.substep(p, cfg, dom, mp, ma, backend=backend)
            b, _ = step.substep(p, cfg, dom, mp, ma, backend="dense")
            dpos = float((a.pos - b.pos).abs().max())
            grid_mass = float(ga.mass.double().sum())
            check(dpos <= 1e-4, f"{backend} {name}: one substep vs dense max|dpos| {dpos} <= 1e-4")
            check(abs(grid_mass - n) <= 1e-4 * n, f"{backend} {name}: grid mass {grid_mass} == n")
            del a, ga, b
            sess = Session(cfg, dom, p, backend=backend, spec=spec, strict=False)
            if spec is not None:
                eager = lambda q: tt.frame(q, cfg, dom, mp, ma, spec=spec)  # noqa: E731
            else:
                eager = lambda q: step.frame(q, cfg, dom, mp, ma, backend)  # noqa: E731
            t = graph_vs_eager(sess, eager, sess.particles(), frames, f"{backend} {name}", card,
                               profile_eager=False)
            q = sess.particles()
            if spec is not None:
                check(int(tt.overflow_count(q.pos, dom, spec)) == 0, f"tiled {name}: no overflow after the run")
            for f in state.FIELDS:
                check(bool(torch.isfinite(getattr(q, f)).all()), f"{backend} {name}: finite {f}")
            snap = sess.snapshot()
            sess.frame()
            first = sess.particles()
            sess.restore(snap)
            sess.frame()
            for f in state.FIELDS:
                check(torch.equal(getattr(sess.particles(), f), getattr(first, f)),
                      f"{backend} {name}: replay bit-identical: {f}")
            check(not any(sk.LAUNCHES.values()) and not any(pk.LAUNCHES.values()),
                  f"{backend} {name}: no stream or pallas kernel launched {sk.LAUNCHES} {pk.LAUNCHES}")
            print(f"[backends] {backend} {name} (n={n}{f', A={spec.active} cap={spec.cap}' if spec else ''}): "
                  f"one substep vs dense max|dpos| {dpos:.3e}, grid mass {grid_mass:.3f}; graph frames "
                  f"{t['graph_ms']:.2f} ms (median) {n * cfg.iterations / t['graph_ms'] * 1e3:.4e} "
                  f"particle-steps/s; replay bit-identical  [{card}]")
            # one substep under the profiler: a frame's thousands of small ops
            # take the profiler 8-23 s to summarise
            q = sess.particles()
            if spec is not None:
                one = lambda: tt.frame(q, cfg, dom, mp, ma, substeps=1, spec=spec)  # noqa: E731
            else:
                one = lambda: step.frame_body(q, cfg, dom, mp, ma, backend, substeps=1)  # noqa: E731
            profile_frame(types.SimpleNamespace(device=device, frame=one), f"{backend} {name}", card,
                          top=3, tag="backends", span="substep")
            print(f"[time] backends {backend} {name}: {time.perf_counter() - t_cell:.1f} s")
            del sess, q, first, snap, p
            torch.cuda.empty_cache()


def app_frames(text: str, frames: int, labels) -> list:
    """The headless output's frame blocks, checked: ``frames`` blocks in
    order, each a non-empty 40x80 render followed by its timing lines with
    ``labels`` (each a regular expression of one label); returns each
    block's {label: ms}."""
    blocks = text.split("--- frame ")[1:]
    check(len(blocks) == frames, f"{frames} frame blocks, got {len(blocks)}")
    times = []
    for k, block in enumerate(blocks):
        lines = block.splitlines()
        check(lines[0] == f"{k} ---", f"block {k} is frame {k}")
        view = lines[1:41]
        check(len(view) == 40 and all(len(line) == 80 for line in view)
              and any(c != " " for line in view for c in line), f"frame {k}: a non-empty 40x80 render")
        ms = {line.split(": ")[0]: float(line.split(": ")[1][:-2]) for line in lines[41:]}
        check(len(ms) == len(labels) and all(re.fullmatch(want, got) for want, got in zip(labels, ms)),
              f"frame {k} timing labels {tuple(ms)} match {tuple(labels)}")
        times.append(ms)
    return times


# the stream overlay's labels on the card (utils/timing.frame_overlay)
STREAM_OVERLAY = ("frame device", r"rebin device \(\d+\)", "render idle", "check idle", "sync idle")


def phase_app(card: str, frames: int = 3) -> None:
    """The app as a user runs it, with no device argument: the 3D reference
    scene on the default backend (stream on the card), then with the timing
    overlay, which reads the replayed frame's own stamps from the recorder;
    then ``app.main`` on the pallas backend in 2D.  Each run's launch
    counters are reset just before it and read just after."""
    device = require_cuda()
    for timing in (False, True):
        out = io.StringIO()
        launches = profiled_launches(lambda: app.run(dim=3, n=scene.REFERENCE_N, frames=frames,
                                                     headless=True, timing=timing, out=out), device)
        launches = {k: launches[k] for k in sk.KERNELS}
        # the window holds the session's eager warm-up frame as well as its
        # replays: thousands of kernels, of which the profiler can drop
        # many (a chip run counted 96 of K2's 124), so no exact count
        check(all(v > 0 for v in launches.values()),
              f"app: every stream kernel launched (profiler): {launches}")
        times = app_frames(out.getvalue(), frames, (*STREAM_OVERLAY, "frame") if timing else ("frame",))
        frame_ms = ", ".join(f"{t['frame']:.2f}" for t in times)
        print(f"[app] 3D reference scene (n={scene.REFERENCE_N}), stream{' --timing' if timing else ''}: "
              f"ms/frame (render + frame + sync) {frame_ms}; launches={launches}  [{card}]")
        if timing:
            stages = ", ".join(f"{k} {v:.3f}" for k, v in times[-1].items() if k != "frame")
            print(f"[app] timing overlay, frame {frames - 1} ms (recorder): {stages}  [{card}]")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launches = profiled_launches(
            lambda: app.main(["--dim", "2", "--frames", "2", "--headless", "--backend", "pallas"]),
            device)
    check(all(launches[k] > 0 for k in PALLAS_ON_PATH)
          and not any(launches[k] for k in (*sk.KERNELS, "pallas_deposit_force")),
          f"app pallas: K6, K7, K8 launched (profiler), no other csrc kernel: {launches}")
    launches = {k: launches[k] for k in pk.KERNELS}
    frame_ms = ", ".join(f"{t['frame']:.2f}" for t in app_frames(out.getvalue(), 2, ("frame",)))
    print(f"[app] main --dim 2 --backend pallas: ms/frame {frame_ms}; launches={launches}  [{card}]")
    for backend in ("tiled", "sorted"):
        pk.reset_launches()
        sk.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            app.main(["--dim", "2", "--frames", "3", "--headless", "--backend", backend])
        check(not any(sk.LAUNCHES.values()) and not any(pk.LAUNCHES.values()),
              f"app {backend}: no stream or pallas kernel {sk.LAUNCHES} {pk.LAUNCHES}")
        frame_ms = ", ".join(f"{t['frame']:.2f}" for t in app_frames(out.getvalue(), 3, ("frame",)))
        print(f"[app] main --dim 2 --backend {backend}: ms/frame {frame_ms}  [{card}]")
    sk.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        app.main(["--shards", "1", "--dim", "3", "--frames", "2", "--headless"])
    launches = dict(sk.LAUNCHES)
    check(all(v > 0 for v in launches.values()), f"app --shards 1: every stream kernel launched: {launches}")
    frame_ms = ", ".join(f"{t['frame']:.2f}" for t in app_frames(out.getvalue(), 2, ("frame",)))
    print(f"[app] main --dim 3 --shards 1: ms/frame {frame_ms}; launches={launches}  [{card}]")


def zero_tile_share(what: str, cfg, spec, dom, st, device, card: str, reps: int = 10) -> dict:
    """Each stream kernel K1-K5 three ways on one binned state: over all A
    with no count (a zero-count entry writes zero windows), as the frame
    launches it (bounded by the state's ``occupied``), and alone, on the
    inputs cut to their first entries: the occupied ones for the deposits
    and the collect, which read no neighbour, and the occupied and relay
    ones for the halos, whose routes run through relay tiles (the face
    tables then name the cut length for "none"), bounded by ``occupied``.
    The frame's launch gives rows below the count bit-equal to the other
    two and takes at most 1.10x, or 5 us more than, the launch alone.
    Returns each kernel's ms as the frame launches it."""
    g = stx.tile_geom(dom, spec)
    A, occ = spec.A, int(st.occupied[0])
    check(occ == int((st.count > 0).sum()) and bool((st.count[:occ] > 0).all()),
          f"{what}: occupied {occ} counts the entries with particles, which come first")
    nt = int(np.prod([s // spec.tile for s in dom.shape]))
    used = int((st.tid < nt).sum())
    tables = st.nbr[:, :used]
    check(bool((tables[tables != A] < used).all()), f"{what}: face tables name only used entries")
    tables = torch.where(tables == A, used, tables).contiguous()
    o = st.occupied
    params6 = deposit_params(cfg, device)
    params = stx.collect_params(cfg, *step.no_mouse(), device)
    dtg = sk.gravity_step(cfg.dt, cfg.gravity)
    d1 = sk.deposit_p2g1(st.count, st.tid, st.stream, g)
    m1 = d1[:, :1].contiguous()
    hm = sk.halo_axes(m1, st.count, st.nbr, g)
    d2 = sk.deposit_p2g2(st.count, st.tid, st.stream, hm, params6, d1, g)
    gb = sk.halo_gblk(d2, hm, st.count, st.nbr, dtg, g)
    scr = st.clone()

    def kernels(k, nbr, occupied):
        """The five launches on the first ``k`` entries of every input."""
        count, tid, stream, d1k, m1k, hmk, d2k, gbk = (
            t[:k] if k == A else t[:k].contiguous()
            for t in (st.count, st.tid, st.stream, d1, m1, hm, d2, gb))
        return {
            "deposit_p2g1": lambda: sk.deposit_p2g1(count, tid, stream, g, occupied=occupied),
            "halo_axis": lambda: sk.halo_axes(m1k, count, nbr, g, occupied=occupied),
            "deposit_p2g2": lambda: sk.deposit_p2g2(count, tid, stream, hmk, params6, d1k, g,
                                                    occupied=occupied),
            "halo_gblk": lambda: sk.halo_gblk(d2k, hmk, count, nbr, dtg, g, occupied=occupied),
            # in place into a copy's stream and flag, as the frame does
            "collect": lambda: sk.collect(count, tid, params, stream, gbk, g,
                                          out=(scr.stream[:k], scr.flag[:k]),
                                          occupied=occupied)}

    old, new = kernels(A, st.nbr, None), kernels(A, st.nbr, o)
    cut = {"deposit_p2g1": (occ, None), "deposit_p2g2": (occ, None), "collect": (occ, None),
           "halo_axis": (used, o), "halo_gblk": (used, o)}
    alone = {name: kernels(k, tables if k == used else None, bnd)[name]
             for name, (k, bnd) in cut.items()}
    out, over, t = {}, [], dict.fromkeys(("old", "frame", "alone"), 0.0)

    def rows(fn):
        scr.stream.copy_(st.stream)
        scr.flag.copy_(st.flag)
        got = fn()
        return tuple(x.clone() for x in got) if isinstance(got, tuple) else (got.clone(),)

    for name in old:
        want, got, short = rows(old[name]), rows(new[name]), rows(alone[name])
        # the windows below the count; the collect's stream and flag whole
        check(all(torch.equal(a[:occ], b[:occ]) and torch.equal(a[:occ], c[:occ])
                  for a, b, c in zip(got, want, short))
              and all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]) if len(got) == 3),
              f"{what} {name}: rows below occupied={occ} bit-equal to the launch over all A and "
              "to the launch alone")
        del got, want, short
        # device time of each launch, 20 to a graph (no host work between them)
        ms = {"old": graph_ms(old[name], device, reps=reps),
              "frame": graph_ms(new[name], device, reps=reps),
              "alone": graph_ms(alone[name], device, reps=reps)}
        if name != "deposit_p2g1":  # once per frame; the rest once per substep
            t = {k: t[k] + ms[k] for k in t}
        limit = max(1.10 * ms["alone"], ms["alone"] + 0.005)
        if ms["frame"] > limit:
            over.append(f"{name} {ms['frame']:.4f} ms > {limit:.4f} ms")
        out[name] = ms["frame"]
        print(f"[occupied] {what} {name}: over all A={A} {ms['old']:.4f} ms; bounded by "
              f"occupied={occ} {ms['frame']:.4f} ms; alone (the first {cut[name][0]} entries) "
              f"{ms['alone']:.4f} ms: {ms['frame'] / ms['alone']:.3f}x alone, "
              f"{1 - ms['frame'] / ms['old']:.1%} saved; rows below the count bit-equal  [{card}]")
    print(f"[occupied] {what} per substep (halo_axis, deposit_p2g2, halo_gblk, collect): over "
          f"all A {t['old']:.4f} ms, bounded by occupied {t['frame']:.4f} ms, alone "
          f"{t['alone']:.4f} ms; {1 - t['frame'] / t['old']:.1%} of the old launches' time saved "
          f"({A - occ} zero-count entries of A={A}, {used - occ} relays)  [{card}]")
    check(not over, f"{what}: each kernel bounded by occupied within 1.10x, or 5 us, of its "
          f"launch alone: {over}")
    return out


def packed_kernel_check(cfg, spec, dom, st, device, card: str) -> None:
    """K1-K3 and the re-bin's gather at the packed geometry (each tile's
    scene offset folded into its corner) against their plain versions, on
    the Session's binned state: the deposits within 1e-4 of the largest
    window, the collect's rows within 1e-5 with an equal flag, each kernel
    bit-equal across two launches, the gather's rows and keys bit-equal."""
    g = stx.tile_geom(dom, spec)
    check(g.scene_cells == spec.scene_stride > 0, f"batch: the packed geometry's scene "
          f"columns {g.scene_cells} are the spec's stride {spec.scene_stride}")
    params6 = deposit_params(cfg, device)
    params = stx.collect_params(cfg, *step.no_mouse(), device)
    dtg = sk.gravity_step(cfg.dt, cfg.gravity)
    out = []
    d1 = sk.deposit_p2g1(st.count, st.tid, st.stream, g)
    m = sk.halo_axes(d1[:, :1].contiguous(), st.count, st.nbr, g)
    d2 = sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g)
    for name, got, again, want in (
            ("deposit_p2g1", d1, sk.deposit_p2g1(st.count, st.tid, st.stream, g),
             sk.deposit_p2g1_plain(st.count, st.tid, st.stream, g)),
            ("deposit_p2g2", d2, sk.deposit_p2g2(st.count, st.tid, st.stream, m, params6, d1, g),
             sk.deposit_p2g2_plain(st.count, st.tid, st.stream, m, params6, d1, g))):
        scale, err = float(want.abs().max()), float((got - want).abs().max())
        check(err <= 1e-4 * scale and torch.equal(got, again),
              f"batch {name} at the packed geometry: max|err| {err} <= 1e-4 * {scale}, "
              "bit-equal across two launches")
        out.append(f"{name} {err:.3e} (of {scale:.3e})")
    gblk = sk.halo_gblk(d2, m, st.count, st.nbr, dtg, g)
    got = sk.collect(st.count, st.tid, params, st.stream, gblk, g)
    again = sk.collect(st.count, st.tid, params, st.stream, gblk, g)
    want = sk.collect_plain(st.count, st.tid, params, st.stream, gblk, g)
    err = float((got[0] - want[0]).abs().max())
    dep = float((got[2] - want[2]).abs().max())
    check(err <= 1e-5 and torch.equal(got[1], want[1]) and dep <= 1e-4 * float(want[2].abs().max())
          and all(torch.equal(a, b) for a, b in zip(got, again)),
          f"batch collect at the packed geometry: rows {err} <= 1e-5, flag equal, fused p2g1 "
          f"{dep}, bit-equal across two launches")
    out.append(f"collect rows {err:.3e}, fused p2g1 {dep:.3e}, flag equal")
    n = int(st.count.sum())
    step_t = stx._LOOKAHEAD * cfg.dt
    rows, keys = sk.rebin_gather(st.stream, st.count, n, g, step_t, st.tid)
    rows_p, keys_p = sk.rebin_gather_plain(st.stream, st.count, n, g, step_t, st.tid)
    check(torch.equal(rows, rows_p) and torch.equal(keys, keys_p),
          "batch rebin_gather at the packed geometry: rows and keys bit-equal to its plain version")
    out.append("rebin_gather rows and keys bit-equal")
    print(f"[batch] kernels at the packed geometry (scene columns {g.scene_cells}) against their "
          f"plain versions: {'; '.join(out)}  [{card}]")


def phase_batch(device, card: str, batch: int = 64, n: int = scene.REFERENCE_N, frames: int = 3,
                check_scenes: int = 8) -> None:
    """bench.py's batch-64 (``:630``): 64 randomized 3D dam breaks of 4,096
    particles in one packed domain on the Session's own path, with no
    hand-built spec: each scene in its own coordinates against its own
    walls."""
    cfg = default_3d()
    stack, _ = scene.batched_dam_break(torch.Generator().manual_seed(0), cfg, batch, n, device=device)
    _, dom, stride = scene.pack_scenes(stack, cfg)
    rows = scene.batch_rows(stack)
    y0 = stack.pos[..., 1].mean(dim=1)
    sess = Session(cfg, dom, rows, backend="stream")
    spec = sess.spec
    check(spec.scene_stride == stride and spec == stx.default_spec(cfg, dom, rows.n),
          "batch: the Session's default spec takes the packed domain's stride")
    nt = int(np.prod([s // spec.tile for s in dom.shape]))
    print(f"[batch] {batch} scenes x {n} = {rows.n} particles, domain {dom.shape} ({dom.scenes} "
          f"scenes, stride {dom.scene_stride}, {nt} tiles), A={spec.A} cap={spec.cap}  [{card}]")
    sess.frame()  # warm: the capture, and strict checks included
    sync(device)
    sk.reset_launches()
    t0 = time.perf_counter()
    sess.run(frames)
    sync(device)
    wall = time.perf_counter() - t0
    check(not any(sk.LAUNCHES.values()), f"batch: replays call no wrapper: {sk.LAUNCHES}")
    check(sess.live_count() == rows.n and sess.shell_drop() == 0, "batch: conservation, shell_drop 0")
    q = sess.particles()
    for f in state.FIELDS:
        check(bool(torch.isfinite(getattr(q, f)).all()), f"batch: finite {f}")
    u = state.ParticleState(**{f: getattr(q, f).reshape(batch, n, *getattr(q, f).shape[1:])
                               for f in state.FIELDS})
    lo, hi = cfg.boundary_clip
    check(all(bool(((u.pos[..., d] >= lo[d]) & (u.pos[..., d] <= hi[d])).all()) for d in range(3)),
          "batch: every scene inside its own walls, in its own coordinates")
    y1 = u.pos[..., 1].mean(dim=1)
    check(bool((y1 > y0).all()), "batch: every scene's mean y rose (+y is down)")
    steps = (frames + 1) * cfg.iterations
    print(f"[batch] {wall * 1e3 / frames:.1f} ms/frame, "
          f"{rows.n * cfg.iterations * frames / wall:.4e} particle-steps/s over {frames} frames; "
          f"rebins={sess.rebins()} in {steps} substeps, need_peak={sess.need_peak()} of A={spec.A} "
          f"({sess.need_peak() / spec.A:.1%}), fill_peak={sess.fill_peak()} of cap={spec.cap}  "
          f"[{card}]")
    packed_kernel_check(cfg, spec, dom, sess.stream_state(), device, card)

    # one substep of the packed state against dense on each scene alone
    mp, ma = step.no_mouse()
    after = stx.frame(q, cfg, dom, mp, ma, substeps=1)
    sdom = make_domain(cfg, halo_cells=4)
    worst = []
    for k in np.linspace(0, batch - 1, check_scenes).round().astype(int).tolist():
        alone = state.ParticleState(**{f: getattr(u, f)[k].contiguous() for f in state.FIELDS})
        want, _ = step.substep(alone, cfg, sdom, mp, ma, backend="dense")
        d = (after.pos[k * n:(k + 1) * n] - want.pos).abs().amax(dim=0)
        check(float(d.max()) <= 1e-4, f"batch scene {k}: max|dpos| (x, y, z) {d.tolist()} <= 1e-4")
        worst.append(f"{k}: {float(d[0]):.2e}/{float(d[1:].max()):.2e}")
    print(f"[batch] one substep, packed stream vs dense per scene, max|dpos| x/(y,z) by scene: "
          f"{'; '.join(worst)}  [{card}]")
    zero_tile_share("batch", cfg, spec, dom, sess.stream_state(), device, card)
    rb0 = sess.rebins()
    launches = replay_launches(sess, "batch")
    launches = {k: launches[k]["launches"] for k in sk.KERNELS}
    check(all(launches[k] == cfg.iterations for k in ("deposit_p2g2", "collect", "halo_axis",
                                                       "halo_gblk"))
          and launches["deposit_p2g1"] == 1 + sess.rebins() - rb0,
          f"batch: replayed frame {frames + 2} launched K2-K5 once per substep, K1 once plus once "
          f"per re-bin: {launches}")
    print(f"[batch] replayed frame {frames + 2}: launches {launches} (graph nodes, profiler "
          f"witnessing)  [{card}]")
    profile_frame(sess, f"{batch} x {n} packed", card, top=6, tag="batch")


def shard_kernel_check(states, sspec, cfg, card: str, reps: int = 10) -> dict:
    """The ghost-gated K4 mass and K5 launches against their plain versions
    at one shard's shapes after the first exchange (the shard holding the
    most particles; windows from K1 and K2 on every shard, exchanged as
    the sharded substep does): K4 bit-equal, K5 by check_gblk with the gate
    in place of the count.  Returns each kind's times and bound."""
    D = cfg.dim
    stages = tsh._Stages(cfg, sspec, states, *step.no_mouse())
    g = stages.g
    dep1 = stages.dep1(states)
    m1 = tsh._exchange_blocks([d[:, :1].contiguous() for d in dep1], states)
    k = max(range(len(states)), key=lambda i: int(states[i].st.count.sum()))
    ss, mk = states[k], m1[k]
    st, gate = ss.st, ss.gate
    hs_m = [sk.halo_axes(m, s2.st.count, s2.st.nbr, g, gate=s2.gate) for m, s2 in zip(m1, states)]
    d2 = tsh._exchange_blocks(
        [sk.deposit_p2g2(s2.st.count, s2.st.tid, s2.st.stream, h, p6, d1, g)
         for s2, h, p6, d1 in zip(states, hs_m, stages.params6, dep1)], states)
    x2, hk = d2[k], hs_m[k]
    check(bool((x2[gate > st.count] != 0).any()) and bool((mk[gate > st.count] != 0).any()),
          "shards: the exchange filled ghost windows")
    cases = {
        "halo_mass_ghost": (lambda: sk.halo_axes(mk, st.count, st.nbr, g, gate=gate),
                            lambda: sk.halo_axes_plain(mk, st.count, st.nbr, g, gate=gate)),
        "halo_gblk_ghost": (lambda: sk.halo_gblk(x2, hk, st.count, st.nbr, stages.dtg, g, gate=gate),
                            lambda: sk.halo_gblk_plain(x2, hk, st.count, st.nbr, stages.dtg, g,
                                                       gate=gate)),
    }
    # the bounds of K4 mass and K5 with the ghost tiles read as occupied
    bounds = stream_bounds(dataclasses.replace(st, count=gate), g, D, sspec.spec.A)
    bounds = {"halo_mass_ghost": bounds["halo_mass"], "halo_gblk_ghost": bounds["halo_gblk"]}
    out = {}
    for name, (kern, plain) in cases.items():
        got, want = kern(), plain()
        sync(got.device)
        if name == "halo_mass_ghost":
            check(torch.equal(got, want), "shards: ghost-gated K4 mass bit-equal to plain")
            extra = "bit_equal=True"
        else:
            rel = check_gblk(got, want, gate, f"shards s={len(states)} ghost-gated")
            extra = f"max_rel={rel:.3e} mass_row_equal=True gate_zero_tiles_equal=True"
        err = float((got - want).abs().max())
        ms = time_ms(kern, reps, got.device)
        plain_ms = time_ms(plain, max(2, reps // 5), got.device)
        bound_ms, bound_by = bound(*bounds[name])
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "on_path": "shards"}
        print(f"[shards] s={len(states)} shard {k} (A={sspec.spec.A}, {int(st.count.sum())} particles, "
              f"{int((gate > st.count).sum())} ghost tiles) {name}: {extra} max_abs_err={err:.3e} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})  [{card}]")
        del got, want
    return out


def phase_shards(device, card: str, n: int = N_1M, counts=(1, 2, 4), frames: int = 2) -> dict:
    """The sharded stream backend at full width: the 1M dam as s = 1, 2, 4
    x-slabs, every shard on this one card.  For s > 1 the ghost-gated K4
    mass and K5 against their plain versions (shard_kernel_check); for
    each s one substep against the single-device stream path from the
    same particles (1e-4), then a strict ShardedSession of ``frames``
    frames with the launch counters reset just before: conservation,
    shell_drop 0, re-bins, migrants (s > 1), finite positions, one K4 mass
    and one K5 launch per shard and substep; ms per frame beside the
    single-device Session's.  Returns the kinds' kernel numbers (s = 2)."""
    cfg, p, dom = dam_1m(device, n)
    mp, ma = step.no_mouse()
    single = Session(cfg, dom, p, backend="stream", device=device)
    single.frame()
    sync(device)
    t0 = time.perf_counter()
    single.run(frames)
    sync(device)
    single_ms = (time.perf_counter() - t0) * 1e3 / frames
    moving = single.particles()  # the dam after 1 + frames frames: a moving state
    print(f"[shards] single-device Session(stream): {single_ms:.1f} ms/frame (frames 2-{1 + frames}), "
          f"A={single.spec.A}  [{card}]")
    del single
    kinds = {}
    for s in counts:
        sspec = tsh.default_shard_spec(cfg, dom, s, n, pos=p.pos, vel=p.vel)
        devices = [device] * s
        if s > 1:
            got = shard_kernel_check(tsh.shard_stream(moving, cfg, sspec, devices), sspec, cfg, card)
            kinds = kinds or got
        states, _ = tsh.sharded_frame_binned(tsh.shard_stream(moving, cfg, sspec, devices), cfg, sspec,
                                             mp, ma, substeps=1)
        a = tsh.gather_stream(states, cfg, sspec, n)
        b = stx.frame(moving, cfg, dom, mp, ma, substeps=1)
        dpos = float((a.pos - b.pos).abs().max())
        dvel = float((a.vel - b.vel).abs().max())
        check(dpos <= 1e-4, f"shards s={s}: one substep vs single-device max|dpos| {dpos} <= 1e-4")
        del states, a, b

        sess = tsh.ShardedSession(cfg, dom, p, devices=devices, sspec=sspec)
        sync(device)
        sk.reset_launches()
        t0 = time.perf_counter()
        sess.run(frames)  # strict: conservation and shell_drop after every frame
        sync(device)
        wall = time.perf_counter() - t0
        launches = dict(sk.LAUNCHES)
        steps = frames * cfg.iterations
        check(all(v > 0 for v in launches.values()), f"shards s={s}: every stream kernel launched {launches}")
        check(launches["halo_axis"] == s * steps and launches["halo_gblk"] == s * steps,
              f"shards s={s}: one K4 mass and one K5 launch per shard and substep: {launches}")
        check(sess.live_count() == n and sess.shell_drop() == 0, f"shards s={s}: conservation, shell_drop 0")
        check(sess.rebins >= 1, f"shards s={s}: at least one re-bin ({sess.rebins})")
        check(s == 1 or sess.migrated() > 0, f"shards s={s}: particles migrated ({sess.migrated()})")
        q = sess.particles()
        check(bool(torch.isfinite(q.pos).all()), f"shards s={s}: finite positions")
        per = [(int(ss.st.count.sum()), int(ss.st.need_peak.max())) for ss in sess.shard_states()]
        # one more timed frame and a profiled one, no more: the dam meets
        # the floor around its fifth frame, where a strict session found
        # tiles past the spec's 128 slots (particles lost, shell_drop 0)
        t0 = time.perf_counter()
        sess.frame()
        sync(device)
        steady = (time.perf_counter() - t0) * 1e3
        print(f"[shards] s={s} on one card: per-shard (particles, need_peak) {per}, A={sspec.spec.A} "
              f"per shard (nt_local {(sspec.ts + 2) * sspec.ncol}); need_peak {sess.need_peak()}; "
              f"exchange {tsh.exchange_bytes(sspec)} bytes/substep; one substep vs single-device "
              f"max|dpos| {dpos:.3e} max|dvel| {dvel:.3e}; {frames} frames: {wall * 1e3 / frames:.1f} "
              f"ms/frame, frame {frames + 1}: {steady:.1f} ms (single-device {single_ms:.1f}); "
              f"rebins={sess.rebins} migrated={sess.migrated()} launches={launches}  [{card}]")
        profile_frame(types.SimpleNamespace(device=device, frame=sess.frame),
                      f"s={s} on one card, frame {frames + 2}", card, top=8, tag="shards")
        del sess, q
        torch.cuda.empty_cache()
    return kinds


def phase_checkpoint(device, card: str, out_dir: str) -> None:
    """Save and resume on the card: the loaded state and the state in
    memory each start a Session (the same un-binned input bins the same
    way), and their next frames are bit-identical."""
    cfg, p, dom = scene.reference_scene_3d(seed=0)
    sess = Session(cfg, dom, p, backend="stream")
    sess.run(2)
    path = os.path.join(out_dir, "chip_smoke_checkpoint.npz")
    checkpoint.save(path, sess.particles(), cfg, frame=2)
    q, cfg2, frame = checkpoint.load(path)
    check(q.device.type == "cuda" and cfg2 == cfg and frame == 2, "checkpoint: config, frame, on the card")
    a = Session(cfg, dom, sess.particles(), backend="stream")
    b = Session(cfg2, dom, q, backend="stream")
    a.frame()
    b.frame()
    qa, qb = a.particles(), b.particles()
    for f in state.FIELDS:
        check(torch.equal(getattr(qa, f), getattr(qb, f)), f"checkpoint: resumed frame bit-identical: {f}")
    m = diagnostics.metrics(qb)
    check(all(bool(torch.isfinite(v).all()) for v in m.values()) and int(m["n"]) == p.n,
          f"checkpoint: finite diagnostics, n == {p.n}")
    print(f"[checkpoint] 3D reference scene: saved after 2 frames, resumed bit-identical; "
          f"{diagnostics.format_metrics(m)}  [{card}]")


def probe_if_node(device) -> str:
    """A CUDA graph holding one IF node (``utils/graph.if_node``) that adds
    one to x where pred holds, replayed with pred false and true in turns;
    returns the CUDA runtime and NVIDIA driver versions it ran under."""
    x = torch.zeros((), device=device)
    pred = torch.zeros((), dtype=torch.bool, device=device)
    g, bodies = torch.cuda.CUDAGraph(), []
    with torch.cuda.graph(g, stream=graph_mod.capture_streams(device)[0]):
        graph_mod.if_node(bodies)(pred, lambda: x.add_(1.0))
    for flag, want in ((False, 0.0), (True, 1.0), (False, 1.0), (True, 2.0)):
        pred.fill_(flag)
        g.replay()
        check(float(x) == want, f"IF node on pred={flag}: x {float(x)} == {want}")
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    return f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}, NVIDIA driver {driver}"


# a conditional body with an event record node in it (run in a process of
# its own: a capture that fails can leave its stream unusable); prints
# "taken", or "refused" with the error and the call that raised it
EVENT_IN_IF_BODY = """
import sys, traceback, torch
sys.path.insert(0, sys.argv[1])
from fluid_tpu_torch.utils import graph as g
dev = torch.device("cuda", 0)
ev = torch.cuda.Event(enable_timing=True, external=True)
x = torch.zeros((), device=dev)
pred = torch.ones((), dtype=torch.bool, device=dev)
graph, bodies = torch.cuda.CUDAGraph(), []
try:
    with torch.cuda.graph(graph, stream=g.capture_streams(dev)[0]):
        g.if_node(bodies)(pred, lambda: (x.add_(1.0), ev.record()))
    graph.replay()
    torch.cuda.synchronize()
    print("taken, x =", float(x))
except RuntimeError as e:
    where = [f.name + ":" + f.line for f in traceback.extract_tb(e.__traceback__)][-2:]
    print("refused: " + str(e).splitlines()[0][:160] + " at " + " / ".join(where))
"""


def stamp_profile(sess: Session, frames: int, device, tries: int = 8) -> tuple:
    """``sess.run(frames)`` under torch.profiler (the card only), after
    ``tries`` short spins, each launched between two synchronizes, which tie
    the profiler's clock to the host's as ``bench_torch/trace.Stretch``'s
    spin does; the spin that leaves its start the least room (its host
    interval less its length by the profiler) is the anchor.  Returns (the
    stamp kernels' starts by the profiler in host ns, the anchor's start at
    its launch; the same with its start at the middle of its room; the
    room in ns; the recorder's records of the stretch)."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        host = []
        for _ in range(tries):
            sync(device)
            h0 = time.perf_counter_ns()
            torch.cuda._sleep(10_000)
            sync(device)
            host.append((h0, time.perf_counter_ns()))
        t0 = host[-1][1]
        sess.run(frames)
        sync(device)
        t1 = time.perf_counter_ns()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spins = sorted((e.time_range.start, e.time_range.end) for e in events if "spin_kernel" in e.name)
    check(len(spins) == tries, f"the profiler saw {tries} spins ({len(spins)})")
    room = [h1 - h0 - (e - s) * 1e3 for (h0, h1), (s, e) in zip(host, spins)]
    k = int(np.argmin(room))
    (h0, h1), (s, _) = host[k], spins[k]
    starts = np.array(sorted(x.time_range.start for x in events if "trace_stamp" in x.name))
    return (h0 + (starts - s) * 1e3, h0 + room[k] / 2 + (starts - s) * 1e3, room[k],
            recorder().records(t0, t1))


TRACE_SPEC = stx.StreamSpec(tile=4, cap=256, halo=2, active=32_768)  # the benchmark's 1M layout


def trace_witness(frames: int = 3) -> None:
    """The profiler as the witness of the recorder's clock: ``frames``
    replays of the strict 1M dam (``TRACE_SPEC``) profiled with the stamps
    (``stamp_profile``); each stamp the recorder mapped onto the host clock
    within 20 us of the nearest stamp kernel's start by the profiler, each
    frame's and re-bin's length within 1% or 5 us of the profiler's.  Run
    as the process's first profiled stretch (``phase_trace`` starts it in
    a process of its own): a chip run saw a process's third profiled
    stretch place the kernels of IF bodies milliseconds from where they ran
    and its frame stamps drift 14 us a frame from the recorder's."""
    device, card = require_cuda(), card_info()
    cfg, p, dom = dam_1m(device)
    sess = Session(cfg, dom, p, spec=TRACE_SPEC, device=device)
    sess.run(2)
    by_launch, by_middle, room, recs = stamp_profile(sess, frames, device)
    check(len(by_middle) > 0, "the profiler saw stamp kernels")

    def near(t):
        return by_middle[np.argmin(np.abs(by_middle - t))]

    gap = {n: np.array([near(t) - t for m, a, b in recs.device if m == n for t in (a, b)])
           for n in ("frame", "rebin")}
    at_launch = np.array([by_launch[np.argmin(np.abs(by_launch - t))] - t
                          for m, a, b in recs.device if m == "frame" for t in (a, b)])
    spare = {n: -max(abs((b - a) - (near(b) - near(a))) - max(0.01 * (b - a), 5e3)
                     for m, a, b in recs.device if m == n) for n in ("frame", "rebin")}
    stats = ", ".join(f"{n} {v.min() / 1e3:.2f} / {np.median(v) / 1e3:.2f} / {v.max() / 1e3:.2f} us"
                      for n, v in gap.items())
    print(f"[trace] 1M dam, profiled run({frames}): recorder {len(gap['frame']) // 2} frames, "
          f"{len(gap['rebin']) // 2} re-bins, {2 * len(recs.device)} stamps; profiler "
          f"{len(by_middle)} stamp kernels; profiler minus recorder (least / median / most): "
          f"{stats} (the spin's start at the middle of its {room / 1e3:.2f} us of room; at its "
          f"launch, as trace.Stretch puts it, frame stamps {at_launch.min() / 1e3:.2f} / "
          f"{at_launch.max() / 1e3:.2f} us); lengths within 1% or 5 us with {spare['frame'] / 1e3:.2f}"
          f" (frames), {spare['rebin'] / 1e3:.2f} us (re-bins) to spare; clock fit residual "
          f"{recs.residual_ns / 1e3:.3f} us over {recs.anchors} anchors, each within "
          f"{recs.anchor_ns / 1e3:.2f} us  [{card}]")
    check(len(gap["frame"]) == 2 * frames, f"{frames} frames stamped")
    check(all(np.abs(v).max() <= 20e3 for v in gap.values()), "stamps within 20 us of the profiler's")
    check(min(spare.values()) >= 0, "lengths within 1% or 5 us of the profiler's")


def phase_trace(device, card: str, frames: int = 8) -> None:
    """The recorder's device stamps (``utils/timing.py``) on the strict
    stream Session of the 1M dam (``TRACE_SPEC``) and of the 3D reference
    scene: every replayed frame writes 2 + 2 x (re-bins fired) stamps,
    against the card's ``rebins`` counter, frame by frame, mouse on every
    other frame, and over a ``run``; then ``trace_witness`` in a process of
    its own, and whether a conditional body takes an event record node."""
    rec = recorder()
    cases = (("1M dam", dam_1m(device), TRACE_SPEC, frames),
             ("3D reference scene", scene.reference_scene_3d(seed=0, device=device), None,
              8 * frames))
    for what, (cfg, p, dom), spec, n_frames in cases:
        sess = Session(cfg, dom, p, spec=spec, device=device)
        sess.compile_run()
        fired, stamped = [], []
        hi = cfg.boundary_clip[1]
        mouse = step.mouse((hi[0] / 2, hi[1] / 3))
        for k in range(n_frames):
            s0, r0 = rec.stamps(), sess.rebins()
            sess.frame(mouse if k % 2 else None)
            fired.append(sess.rebins() - r0)
            stamped.append(rec.stamps() - s0)
        s0, r0 = rec.stamps(), sess.rebins()
        sess.run(n_frames)
        fired.append(sess.rebins() - r0)
        stamped.append(rec.stamps() - s0)
        print(f"[trace] {what}: stamps a frame {stamped[:-1]}, re-bins fired {fired[:-1]}; "
              f"run({n_frames}) {stamped[-1]} stamps, {fired[-1]} re-bins  [{card}]")
        check(all(s == 2 + 2 * f for s, f in zip(stamped[:-1], fired[:-1])),
              f"{what}: 2 + 2 x re-bins stamps a frame")
        check(stamped[-1] == 2 * n_frames + 2 * fired[-1], f"{what}: run({n_frames}) stamps")
        del sess, p
        torch.cuda.empty_cache()
    for what, code in (("the profiler's witness", "import chip_smoke as c; c.trace_witness()"),
                       ("an event record node in an IF body", EVENT_IN_IF_BODY)):
        out = subprocess.run([sys.executable, "-c", code, ROOT], capture_output=True, text=True,
                             timeout=600, cwd=ROOT)
        print(out.stdout.strip() if out.returncode == 0 and code != EVENT_IN_IF_BODY else
              f"[trace] {what}: {out.stdout.strip()} {out.stderr[-600:]}  [{card}]")
        check(out.returncode == 0, f"{what}: exit 0")


def phase_profile(card: str, n: int = N_1M, top: int = 8) -> None:
    """One frame of the 1M dam per backend under torch.profiler, after a
    warm-up frame (``profile_frame``)."""
    for backend in ("stream", "pallas"):
        cfg, p, dom = scene.scaled_dam_break(torch.Generator().manual_seed(0), n)
        sess = Session(cfg, dom, p, backend=backend)
        sess.frame()
        profile_frame(sess, f"{backend} n={n}", card, top)
        del sess, p


CSRC_KERNELS = tuple(f"(anonymous namespace)::{k}<" for k in
                     ("deposit_kernel", "collect_kernel", "halo_axes_kernel", "halo_axes_any_kernel",
                      "rebin_gather_kernel", "rebin_fill_kernel"))
CSRC_KERNELS += ("(anonymous namespace)::set_condition(",)  # csrc/graph_if.cu, the IF nodes'


def csrc_launch_name(key: str):
    """The wrapper (a key of ``sk.LAUNCHES`` or ``pk.LAUNCHES``) whose kernel
    a profiler kernel event ``key`` is, or None: the stream deposit is
    ``deposit_kernel<D, P2G2, MULTI>`` over a ``Geom``, the pallas one
    ``deposit_kernel<D, MODE>``; the stream collect is ``collect_kernel<D>``
    over a ``Geom``, the pallas one over a ``PGeom``; the halo kernels' last argument is
    GBLK; the re-bin's kernels are ``rebin_gather_kernel<D>`` and
    ``rebin_fill_kernel<D>``."""
    m = re.search(r"\(anonymous namespace\)::(deposit_kernel|collect_kernel|halo_axes_kernel"
                  r"|halo_axes_any_kernel|rebin_gather_kernel|rebin_fill_kernel)<([^>]*)>", key)
    if m is None:
        return None
    kind, args = m.group(1), [a.strip() for a in m.group(2).split(",")]
    if kind.startswith("rebin_"):
        return kind.removesuffix("_kernel")
    if kind == "deposit_kernel":
        if args[1] in ("true", "false"):
            return "deposit_p2g2" if args[1] == "true" else "deposit_p2g1"
        return {"1": "pallas_deposit_p2g1", "2": "pallas_deposit_force", "3": "pallas_p2g2"}[args[1]]
    if kind == "collect_kernel":
        return "pallas_collect" if "PGeom" in key else "collect"
    return "halo_gblk" if args[-1] == "true" else "halo_axis"


def profiled_launches(run, device) -> dict:
    """Launches of each csrc kernel, by wrapper name, among the kernel events
    of torch.profiler while ``run()`` runs: a replayed graph launches no
    wrapper, so the profiler is the witness that its kernels ran.  Chip
    runs saw the profiler lose the first events of a long window (the two
    spins that lead it, most of an app's warm-up frame) with a warning
    that it clears events at the end of each cycle, so events are kept
    across cycles (``acc_events``); the host waits 0.1 s, the card spins
    twice, the second spin after a synchronize, and only kernels that start
    after the last spin the profiler saw count (every kernel, where it saw
    none of the spins, as in some full runs of this script), each (name,
    start) once.  Kernels inside an IF node's body are reported
    unreliably (chip runs saw a body's K1 last 1.2 and 13.6 us where K1
    takes ~300, and body K1 events missing or doubled in a frame):
    ``replay_launches`` counts those from the graph's nodes."""
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        time.sleep(0.1)
        for _ in range(2):
            torch.cuda._sleep(1 << 20)
            sync(device)
        run()
        sync(device)
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    mark = max((e.time_range.end for e in events if "spin_kernel" in e.name), default=None)
    kept = {(csrc_launch_name(e.name), e.time_range.start) for e in events
            if (mark is None or e.time_range.start >= mark) and csrc_launch_name(e.name) is not None}
    counts = dict.fromkeys((*sk.KERNELS, *pk.KERNELS), 0)
    for name, _ in kept:
        counts[name] += 1
    return counts


def demangle(name: bytes) -> str:
    """A C++ symbol's demangled name (libstdc++'s ``__cxa_demangle``); the
    name as it is where it is not a mangled one."""
    cxa = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
    cxa.restype = ctypes.c_void_p
    status = ctypes.c_int()
    out = cxa(ctypes.c_char_p(name), None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        return name.decode()
    text = ctypes.string_at(out).decode()
    libc_free = ctypes.CDLL(None).free
    libc_free.argtypes = [ctypes.c_void_p]
    libc_free(out)
    return text


CU_GRAPH_NODE_TYPE_KERNEL, CU_GRAPH_NODE_TYPE_CONDITIONAL = 0, 13


def graph_kernel_nodes(raw_graph: int) -> tuple:
    """(csrc kernel nodes by wrapper name, conditional nodes) at the top
    level of a CUDA graph (``CUDAGraph.raw_cuda_graph()``), read through the
    driver API: ``cuGraphKernelNodeGetParams`` gives each kernel node's
    function (``func``, or ``kern`` where the node holds a CUkernel, at
    bytes 0 and 56 of ``CUDA_KERNEL_NODE_PARAMS_v2``), ``cuFuncGetName`` /
    ``cuKernelGetName`` its mangled name."""
    drv = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def ok(rc, what):
        check(rc == 0, f"{what}: CUresult {rc}")

    n = ctypes.c_size_t(0)
    ok(drv.cuGraphGetNodes(vp(raw_graph), None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    ok(drv.cuGraphGetNodes(vp(raw_graph), nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kernels = dict.fromkeys((*sk.KERNELS, *pk.KERNELS), 0)
    conditional = 0
    for node in nodes:
        kind = ctypes.c_int()
        ok(drv.cuGraphNodeGetType(vp(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        conditional += kind.value == CU_GRAPH_NODE_TYPE_CONDITIONAL
        if kind.value != CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        params = (vp * 16)()  # CUDA_KERNEL_NODE_PARAMS_v2 is 72 bytes
        ok(drv.cuGraphKernelNodeGetParams_v2(vp(node), params), "cuGraphKernelNodeGetParams")
        func, kern = params[0], params[7]
        name = ctypes.c_char_p()
        if func:
            ok(drv.cuFuncGetName(ctypes.byref(name), vp(func)), "cuFuncGetName")
        else:
            ok(drv.cuKernelGetName(ctypes.byref(name), vp(kern)), "cuKernelGetName")
        wrapper = csrc_launch_name(demangle(name.value))
        if wrapper is not None:
            kernels[wrapper] += 1
    return kernels, conditional


def replay_launches(sess: Session, what: str) -> dict:
    """The launches of one replayed ``sess.frame()``, by wrapper name: each
    kernel's nodes at the frame graph's top level (run at every replay),
    plus its nodes in one IF body (each body alike) times the bodies the
    card fired in the frame (its ``rebins`` counter), so derived from the
    graph, not counted as they ran.  The profiler (``profiled_launches``)
    witnesses the frame: it sees as many events as nodes for each kernel no
    IF body holds, and at least the top-level nodes of one that a body
    holds (K1).  Returns name -> {"launches", "launches_from",
    "profiler_events"}."""
    fg = sess.frame_graph
    fg.capture()
    rb0 = sess.rebins()
    seen = profiled_launches(sess.frame, sess.device)
    fired = sess.rebins() - rb0
    top, conditional = graph_kernel_nodes(fg.graph.raw_cuda_graph())
    bodies = [graph_kernel_nodes(b.raw_cuda_graph()) for b in fg.bodies]
    check(conditional == len(bodies), f"{what}: {conditional} IF nodes == {len(bodies)} bodies")
    check(all(b == bodies[0] for b in bodies), f"{what}: every IF body holds the same kernels")
    body = bodies[0][0] if bodies else dict.fromkeys(top, 0)
    out = {}
    for k in top:
        n = top[k] + fired * body[k]
        witnessed = seen[k] == n if body[k] == 0 else seen[k] >= top[k]
        check(witnessed, f"{what}: {k} profiler events {seen[k]} against {top[k]} nodes a frame "
                         f"+ {body[k]} a re-bin body x {fired} fired")
        out[k] = {"launches": n, "profiler_events": seen[k],
                  "launches_from": f"graph nodes: {top[k]} a frame + {body[k]} a re-bin body "
                                   f"x {fired} fired (card counter)"}
    return out


def summary(launches: dict) -> str:
    """``replay_launches``' counts as "name N (profiler M)", one a kernel."""
    return ", ".join(f"{k} {v['launches']} (profiler {v['profiler_events']})"
                     for k, v in launches.items())


def counted_launches(run) -> dict:
    """The wrappers' launch counters over ``run()``, reset just before."""
    sk.reset_launches()
    pk.reset_launches()
    run()
    return {**sk.LAUNCHES, **pk.LAUNCHES}


def profile_frame(sess: Session, what: str, card: str, top: int = 8, tag: str = "profile",
                  span: str = "frame") -> None:
    """One ``sess.frame()`` (a frame, or the ``span`` it runs) under
    torch.profiler, tracing the card only (tracing the host's ops as well
    took an eager pallas frame's profile 3.1 s where this takes 1.4, chip
    run): host wall time, device time (the sum of every kernel's and
    copy's time), the csrc kernels' share and the largest device
    entries."""
    from torch.profiler import ProfilerActivity, profile

    sync(sess.device)
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        sess.frame()
        sync(sess.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.device_time_total, reverse=True)
    device_ms = sum(e.device_time_total for e in rows) / 1e3
    own_ms = sum(e.device_time_total for e in rows  # csrc/*.cu kernels (PyTorch has
                 if e.key.removeprefix("void ").startswith(CSRC_KERNELS)) / 1e3  # anonymous ones too)
    check(device_ms > 0, f"{what}: the profiler saw device time")
    print(f"[{tag}] {what}, one {span}: wall {wall_ms:.2f} ms (profiler on), device "
          f"{device_ms:.2f} ms, busy {device_ms / wall_ms:.1%}; csrc kernels {own_ms:.2f} ms, "
          f"PyTorch ops {device_ms - own_ms:.2f} ms  [{card}]")
    for e in rows[:top]:
        print(f"[{tag}]   {e.device_time_total / 1e3:9.3f} ms {e.count:5d}x  {e.key[:90]}")


def main() -> int:
    device = require_cuda()
    card = card_info()
    print(f"[device] {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    print(card)

    t0 = time.perf_counter()
    load_libraries()
    build_s = time.perf_counter() - t0
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_ptxas.txt"), "w") as fh:
        fh.write("".join(lib.build_log for lib in LIBRARIES))
    for lib in LIBRARIES:
        steps = ", ".join(f"{name} {secs:.2f} s" for name, secs in lib.build_seconds.items())
        print(f"[build] {lib.name}: {lib.path().name} ({steps or 'cached'})")
    print(f"[build] {len(LIBRARIES)} libraries in {build_s:.2f} s (ptxas report: "
          f"chiprun_out/chip_smoke_ptxas.txt)")
    fresh = subprocess.run([sys.executable, "-c", "import chip_smoke as c; c.session_libraries()"],
                           capture_output=True, text=True, timeout=300, cwd=ROOT)
    check(fresh.returncode == 0 and fresh.stdout.split() == ["graph", "stream"],
          f"a fresh process's stream Session frame loads the graph and stream libraries only: "
          f"{fresh.stdout.strip()!r} {fresh.stderr[-600:]}")
    print(f"[build] a fresh process's stream Session frame loaded: {fresh.stdout.strip()}  "
          f"[{card}]")

    def run(phase, *args):
        """Run one phase and print its wall seconds."""
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"[time] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    results = run(phase_kernels, device, card)
    results.update(run(phase_rebin, device, card))
    big_kinds = run(phase_deposit_geometries, device, card)
    run(phase_digests, device, card)
    results.update(run(phase_pallas_kernels, device, card))
    run(phase_pallas_digests, device, card)
    micro = run(phase_micro, device, card)
    micro.update(run(phase_micro_b1, device, card))
    micro.update(run(phase_micro_b6, device, card))
    run(phase_goldens, device, card)
    mk.reset_launches()
    mst.reset_launches()
    mp.reset_launches()
    launches = run(phase_slice, device, N_1M, card)
    launches.update(run(phase_pallas_slice, card))
    # the stream and pallas frames, eager and replayed
    per_frame = {**mk.LAUNCHES, **mst.LAUNCHES, **mp.LAUNCHES}
    check(not any(per_frame.values()), f"the frames launch no micro kernel: {per_frame}")
    for name in micro:
        micro[name]["launches_per_frame"] = per_frame[name]
    run(phase_graph, device, card)
    run(phase_big_tile, device, card)
    run(phase_backends, card)
    run(phase_replay, device, card)
    render_kernel = run(phase_render, device, card)
    run(phase_app, card)
    run(phase_trace, device, card)
    run(phase_batch, device, card)
    ghost = run(phase_shards, device, card)
    run(phase_checkpoint, device, card, out_dir)
    run(phase_profile, card)

    # the sharded path's ghost-gated launches stand as kinds of K4 and K5
    strip = ("ms", "plain_ms", "bound_ms", "bound_by", "on_path")
    results["halo_axis"]["kinds"]["halo_mass_ghost"] = {k: ghost["halo_mass_ghost"][k] for k in strip}
    results["halo_gblk"]["kinds"] = {"halo_gblk_ghost": {k: ghost["halo_gblk_ghost"][k] for k in strip}}
    for name, kinds in big_kinds.items():  # K1-K3 at T=8, cap=1024
        results[name].setdefault("kinds", {}).update(
            {kind: {k: v[k] for k in strip} for kind, v in kinds.items()})
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         **launches[name], **results[name]}
        for name in (*sk.KERNELS, *pk.KERNELS)
    ]
    kernels.append({"name": "console_histogram", "route": "cuda",
                    "source": "fluid_tpu_torch/csrc/render_kernels.cu",
                    "replaces": "none: an XLA scatter-add (fluid_tpu/render.py:34 histogram)",
                    **render_kernel})
    kernels += [{"name": name, "route": "cuda", "source": MICRO_SOURCE[name],
                 "replaces": MICRO_REPLACES[name], **micro[name]} for name in micro]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--record-digests"]:
        # python3 chip_smoke.py --record-digests stream|pallas PATH: write the
        # record of DIGESTS (stream) or PALLAS_DIGESTS (pallas) from the
        # kernels of the package beside this script
        kind, path = sys.argv[2:4]
        load_libraries()
        dev = require_cuda()
        if kind == "stream":
            record = kernel_digests(dev, 4, 256, 200_000)
        elif kind == "pallas":
            record = {case: pallas_digests(dev, *args) for case, args in PALLAS_DIGEST_CASES.items()}
        else:
            sys.exit(f"--record-digests: unknown kind {kind!r} (stream or pallas)")
        with open(path, "w") as fh:
            json.dump(record, fh, indent=1)
        sys.exit(0)
    sys.exit(main())
