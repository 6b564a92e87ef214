"""active_need_peak.batch: how much of the active budget the fullest
binning needed, in %: the largest ``need_peak`` counter sample (the
program's recorder; the strict check reads the stream's watermark of the
needed-relay closure, the tiles a binning had to make active, beside the
budget A) taken inside the traced stretch, over that sample's budget,
x100.  The rest of the A launched entries are empty windows that the
kernels still walk.  None where the program keeps no such samples."""

from bench_torch import program_trace


def read(run):
    rec = program_trace.recorder()
    if rec is None or not hasattr(run, "stretch"):
        return None
    t0, t1 = int(run.stretch._t0 * 1e9), int(run.stretch._t1 * 1e9)
    shares = [value / limit for name, _, value, limit in getattr(rec.records(t0, t1), "counts", ())
              if name == "need_peak" and limit > 0]
    return max(shares) * 100.0 if shares else None
