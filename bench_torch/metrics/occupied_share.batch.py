"""occupied_share.batch: the share of the launched entries that the stream
kernels still work on, in %: the mean of the ``occupied`` counter samples
(the program's recorder; the strict check reads the binning's count of
entries that hold particles, which come first and bound every launch of
K1-K5, beside the budget A) taken inside the traced stretch, each over its
sample's budget, x100.  None where the program keeps no such samples."""

from bench_torch import program_trace


def read(run):
    rec = program_trace.recorder()
    if rec is None or not hasattr(run, "stretch"):
        return None
    t0, t1 = int(run.stretch._t0 * 1e9), int(run.stretch._t1 * 1e9)
    shares = [value / limit for name, _, value, limit in getattr(rec.records(t0, t1), "counts", ())
              if name == "occupied" and limit > 0]
    return sum(shares) / len(shares) * 100.0 if shares else None
