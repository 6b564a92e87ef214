"""A frame as one captured CUDA graph: the port's counterpart of ``jax.jit``.

``fluid_tpu`` jits each backend's frame into one device program
(``fluid_tpu/step.py:109``, ``fluid_tpu/session.py:101``), and its stream
frame decides each substep's re-bin on the device with a ``lax.cond``
(``fluid_tpu/ops/stream_transfer.py:2903-2953``).  Here ``FrameGraph``
captures one frame of a body into a ``torch.cuda.CUDAGraph`` and replays
it, and the branch passed to the body stands in for the ``lax.cond``.

A body is ``body(state, branch)``: it advances ``state`` (tensors it
updates in place) by one frame and runs each data-dependent step as
``branch(pred, fn)``, ``pred`` a 0-dim bool tensor on the state's device.
Three branches run a body:

* ``eager_branch``: ``if bool(pred): fn()``, one read of the device (the
  CPU's path, and the functional entries such as ``frame_binned``);
* ``if_node(bodies)``, while capturing: ``fn``'s work goes into a
  conditional (IF) node whose predicate the card reads from ``pred`` at
  each replay (CUDA 12.4 or later).  PyTorch captures ``fn`` as a graph of
  its own, on a side stream with a memory pool of its own, and
  ``csrc/graph_if.cu`` puts a copy of it into an IF node of the graph being
  captured (the CUDAGraph binding of the PyTorch the port runs under has
  no conditional nodes);
* ``warm_branch``: ``fn()`` whatever ``pred`` holds, without reading it
  (the warm-up before a capture runs every path once, on a scratch copy).

A copy from pageable host memory synchronises and cannot be captured, so
constants made from Python data go through ``device_const``: made once,
before the capture (the warm-up makes them), and kept.  A capture that
fails raises; nothing carries on eagerly on the card.
"""

from __future__ import annotations

import ctypes
import gc
import time

import numpy as np
import torch

from ..ops import cuda_build
from . import timing
from .platform import resolve_device

# the IF node and the recorder's trace stamp (csrc/graph_if.cu)
LIBRARY = cuda_build.Library("graph", ("graph_if.cu",))
_CONSTS: dict = {}


def device_const(values, device=None, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(values, dtype=dtype).to(device)``, made once per
    (values, dtype, device) and kept, so a captured frame reads it without a
    host-to-device copy.  Shared between callers: never write to it.
    Raises if a constant is first asked for while a graph is captured."""
    device = resolve_device("cpu" if device is None else device)
    arr = np.asarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(dtype), str(device))
    t = _CONSTS.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device constant {arr.tolist()} first asked for during a CUDA "
                               "graph capture: run the body once before capturing it")
        t = _CONSTS[key] = torch.as_tensor(values, dtype=dtype).to(device)
    return t


def eager_branch(pred: torch.Tensor, fn) -> None:
    """Run ``fn()`` where ``pred`` holds, deciding on the host."""
    if bool(pred):
        fn()


def warm_branch(pred: torch.Tensor, fn) -> None:
    """Run ``fn()`` whatever ``pred`` holds, without reading it."""
    fn()


_STREAMS: dict = {}


def capture_streams(device) -> tuple:
    """(frame, body): the streams a frame and its IF bodies are captured
    on, made once per device.  PyTorch hands out its streams round-robin
    from a pool, so a stream made for each capture could be the very
    stream the frame is being captured on."""
    device = resolve_device(device)
    if device not in _STREAMS:
        _STREAMS[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
    return _STREAMS[device]


def if_node(bodies: list, ring=None):
    """The branch while the current stream captures a graph: ``fn`` is
    captured as a graph of its own (appended to ``bodies``, which must
    outlive the captured graph: their memory pool holds ``fn``'s
    intermediates), then put into an IF node on ``pred``, which runs at a
    replay only where ``pred`` is then true.  The bodies share one pool: a
    frame runs them one after another.  With ``ring`` (the recorder's,
    ``timing.Recorder.ring``) a body's first and last nodes are the
    ``rebin_begin`` and ``rebin_end`` stamps."""
    side = capture_streams(torch.cuda.current_device())[1]

    def branch(pred: torch.Tensor, fn) -> None:
        main = torch.cuda.current_stream()
        body = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.stream(side):
            body.capture_begin(pool=bodies[0].pool() if bodies else None,
                               capture_error_mode="thread_local")
            try:
                if ring is not None:
                    ring.stamp(timing.REBIN_BEGIN)
                fn()
                if ring is not None:
                    ring.stamp(timing.REBIN_END)
            finally:
                body.capture_end()
        bodies.append(body)
        rc = LIBRARY.load().fluid_graph_if(
            ctypes.c_void_p(pred.data_ptr()), ctypes.c_void_p(body.raw_cuda_graph()),
            ctypes.c_void_p(main.cuda_stream))
        if rc != 0:
            raise RuntimeError(f"IF node: CUDA error {rc} adding it to the captured graph")

    return branch


class FrameGraph:
    """One frame of ``body`` over ``state``, replayed as a CUDA graph.

    ``run()`` advances ``state`` by one frame: on the card by replaying the
    graph, captured at the first ``run()`` or by ``capture()``; on the CPU
    by running ``body(state, eager_branch)``; ``state.clone()`` is the
    warm-up's scratch copy.  ``bodies`` are the graphs of the IF nodes'
    bodies, in capture order (``if_node``).  ``capture_s`` and
    ``instantiate_s`` are the host seconds the capture took: the recorder's
    ``capture`` and ``instantiate`` spans (``utils/timing.py``), after
    ``warm``.  With the recorder on, the graph's first and last nodes are
    the ``frame_begin`` and ``frame_end`` stamps."""

    def __init__(self, body, state, device: torch.device):
        self.body, self.state = body, state
        self.device = resolve_device(device)
        self.graph = None
        self.bodies: list = []
        self.capture_s = self.instantiate_s = 0.0

    def capture(self) -> None:
        """Warm the body up on a scratch copy of the state (a side stream,
        every branch taken), then capture it over the state, which it leaves
        as it was: a capture runs nothing.  No-op on the CPU or once done."""
        if self.graph is not None or self.device.type != "cuda":
            return
        # a garbage collection during the capture could destroy an old
        # graph, which the capture cannot take (a chip run lost one so)
        gc.collect()
        gc.disable()
        try:
            self._capture()
        finally:
            gc.enable()

    def _capture(self) -> None:
        rec = timing.recorder()
        LIBRARY.load()  # the IF node's and the stamps' kernels, loaded outside the capture
        with torch.cuda.device(self.device):
            ring = rec.ring(self.device)
            t0 = time.perf_counter_ns()
            main, side = torch.cuda.current_stream(), torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                scratch = self.state.clone()
                self.body(scratch, warm_branch)
                del scratch
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            t1 = time.perf_counter_ns()
            with torch.cuda.graph(graph, stream=capture_streams(self.device)[0],
                                  capture_error_mode="thread_local"):
                if ring is not None:
                    ring.stamp(timing.FRAME_BEGIN)
                self.body(self.state, if_node(self.bodies, ring))
                if ring is not None:
                    ring.stamp(timing.FRAME_END)
            t2 = time.perf_counter_ns()
            graph.instantiate()
            t3 = time.perf_counter_ns()
        for name, a, b in (("warm", t0, t1), ("capture", t1, t2), ("instantiate", t2, t3)):
            rec.record(name, a, b)
        self.capture_s, self.instantiate_s = (t2 - t1) * 1e-9, (t3 - t2) * 1e-9
        self.graph = graph

    def run(self) -> None:
        if self.device.type != "cuda":
            self.body(self.state, eager_branch)
            return
        self.capture()
        self.graph.replay()
