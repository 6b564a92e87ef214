// The IF node of a captured frame (fluid_tpu_torch/utils/graph.py).
//
// The counterpart of the lax.cond in fluid_tpu's stream frame
// (fluid_tpu/ops/stream_transfer.py:2903-2953): a conditional node of a CUDA
// graph, decided on the card at each replay (CUDA 12.4 or later).  The
// CUDAGraph binding of the PyTorch this port runs under cannot capture into
// a conditional node, so the node is added here through the CUDA runtime:
// the body is captured by PyTorch as a graph of its own, and this entry
// point puts a copy of it into an IF node of the graph being captured.
// Plumbing, not a port of a TPU kernel: one kernel sets the node's
// condition from a bool on the card.
//
// Also the recorder's device stamp (fluid_tpu_torch/utils/timing.py): the
// frame graph captures one as its first and last node and one each side of
// every IF body, and the recorder launches it eagerly for its clock
// anchors.  A kernel and not an event record: a conditional body with an
// event record node in it fails the graph's capture (chip_smoke.py's trace
// phase checks this).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// (tag, %globaltimer in ns) into the next slot of a ring of mask + 1 slots,
// taken by an atomic add on its head counter, which never wraps.
__global__ void trace_stamp(unsigned long long* times, int* tags, unsigned long long* head,
                            unsigned long long mask, int tag) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long i = atomicAdd(head, 1ull) & mask;
  times[i] = t;
  tags[i] = tag;
}

cudaError_t capture_info(cudaStream_t st, cudaStreamCaptureStatus* status, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(st, status, nullptr, graph, deps, nullptr, ndeps);
#else
  return cudaStreamGetCaptureInfo(st, status, nullptr, graph, deps, ndeps);
#endif
}

}  // namespace

extern "C" {

// Into the graph `cuda_stream` is capturing: a kernel that sets a new
// conditional handle from *pred, then an IF node on that handle whose body
// is a copy of the captured graph `body`; the capture goes on after the IF
// node.  Returns a cudaError_t.
int fluid_graph_if(const bool* pred, void* body, void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(st, &status, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorIllegalState);
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_condition<<<1, 1, 0, st>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = capture_info(st, &status, &graph, &deps, &ndeps);  // now: the kernel above
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node, child;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return static_cast<int>(err);
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(st, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(st, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  return static_cast<int>(err);
}

// One stamp `tag` on `cuda_stream` into the ring (times, tags, head) of
// mask + 1 slots, a power of two.  Returns a cudaError_t.
int fluid_trace_stamp(unsigned long long* times, int* tags, unsigned long long* head, long long mask,
                      int tag, void* cuda_stream) {
  trace_stamp<<<1, 1, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      times, tags, head, static_cast<unsigned long long>(mask), tag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
