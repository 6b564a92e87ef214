"""particle_steps_per_s: particles x substeps of every frame completed in
the window, over the window's wall time (host clock; every call's restore,
strict check and synchronise inside)."""


def read(run):
    if run.frames == 0:
        return None
    return run.n * run.substeps * run.frames / run.window_s
