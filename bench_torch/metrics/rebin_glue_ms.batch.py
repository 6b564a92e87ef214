"""rebin_glue_ms.batch: device ms a frame in work that is not the program's
own kernels (PyTorch's kernels, copies and fills: the re-bins' sorts,
gathers and scans, the per-substep re-bin test, the frame's final copy,
a restore's copies), over the traced stretch (profiler)."""


def read(run):
    if not run.trace or run.traced_frames == 0:
        return None
    return run.trace["other_s"] / run.traced_frames * 1e3
