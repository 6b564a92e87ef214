"""tile_fill_peak.interactive: how full the fullest tile was asked to be, in %
of its slots: the largest ``fill_peak`` counter sample (the program's
recorder; the strict check reads the stream's watermark, the most particles
a binning asked one tile to hold before the clip, beside the cap) taken
inside the traced stretch, over that sample's cap, x100.  Above 100:
particles were lost.  None where the program keeps no such samples."""

from bench_torch import program_trace


def read(run):
    rec = program_trace.recorder()
    if rec is None or not hasattr(run, "stretch"):
        return None
    t0, t1 = int(run.stretch._t0 * 1e9), int(run.stretch._t1 * 1e9)
    shares = [value / limit for name, _, value, limit in getattr(rec.records(t0, t1), "counts", ())
              if name == "fill_peak" and limit > 0]
    return max(shares) * 100.0 if shares else None
