"""graph_capture_s: the frame graph's capture and instantiation, host
seconds (``FrameGraph.capture_s + instantiate_s``)."""


def read(run):
    return run.capture_s + run.instantiate_s
