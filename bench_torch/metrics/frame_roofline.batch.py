"""frame_roofline.batch: the least time of the work the traced frames need
(``work.least_seconds`` of the valid particles and the occupied cells, the
mean of the counts before and after the stretch) over the device's busy
time in the stretch (profiler: the union of all device activity), in %."""

from bench_torch import work


def read(run):
    if not run.trace or not run.cells or run.trace["busy_s"] <= 0:
        return None
    c = sum(run.cells) / len(run.cells)
    need = run.traced_frames * run.substeps * work.least_seconds(run.dim, run.n, c)
    return need / run.trace["busy_s"] * 100.0
