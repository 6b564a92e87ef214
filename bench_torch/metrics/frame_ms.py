"""frame_ms: the window's wall time over the frames completed in it (host
clock)."""


def read(run):
    if run.frames == 0:
        return None
    return run.window_s / run.frames * 1e3
