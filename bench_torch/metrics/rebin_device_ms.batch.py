"""rebin_device_ms.batch: the device time of the re-bins that fired, ms a
frame: the sum of the ``rebin_begin`` to ``rebin_end`` device spans that
lie in the traced stretch, over its frames (the program's recorder; each
IF body's first and last node).  None where the program keeps no stamps."""

from bench_torch import program_trace


def read(run):
    rec = program_trace.recorder()
    if rec is None or not hasattr(run, "stretch") or run.traced_frames == 0:
        return None
    t0, t1 = int(run.stretch._t0 * 1e9), int(run.stretch._t1 * 1e9)
    device = rec.records(t0, t1).device
    if not any(n == "frame" for n, _, _ in device):
        return None
    rebins = sum(b - a for n, a, b in device if n == "rebin" and a >= t0 and b <= t1)
    return rebins / run.traced_frames * 1e-6
