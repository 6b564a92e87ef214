// Hand-written Hopper (sm_90a) kernel of the console render.
//
// It replaces no Pallas kernel: the JAX render (fluid_tpu/render.py:34
// histogram) is an XLA scatter-add over the particles.  As PyTorch
// operations the port's histogram of the stream was about 25 launches over
// every slot, live or dead (render.histogram_xy, now the plain version),
// each paying its host cost.  Here one host call zeroes the count grid and
// bins the live points of a strided layout into it:
//
//   console_histogram_kernel<SHARED>
//       points (x, y) of rows [R, S], the first count[r] slots of row r
//       live (every slot where there is no count) -> counts [H, W] int32
//
// The stream's rows stream[:, 0, :] and stream[:, 1, :] and the columns of
// a [N, D] array (one row of N slots) are both such layouts.
//
// Nothing on the card's scale bounds it: at the app's scenes it reads 4,096
// points and a count per tile and writes 3,200 bins, a few microseconds of
// launch and tail.  Each block bins its share of the slots into a grid in
// shared memory (straight into `counts` where the grid is larger than
// SMEM_BINS) and adds its nonzero bins into `counts`, which the entry point
// zeroes on the same stream first.  Integer sums, so the grid is the same
// whatever order the blocks run in.
//
// A point's bin is PyTorch's on the card, bit for bit (histogram_xy):
// x / viewport_w with a host scalar divisor is computed by PyTorch's CUDA
// division as x times the divisor's float32 reciprocal, which the caller
// passes; then times W, floor, and static_cast to a 64-bit integer as
// .to(torch.int64).  Built with -fmad=false; the products are written as
// __fmul_rn besides.
//
// The C entry point enqueues a memset and the launch on the given stream
// (so a capture takes both), allocates nothing, does not synchronise, and
// returns the first CUDA error.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
// Slots a thread walks, about, before the grid stops growing with the input.
constexpr int SLOTS_PER_THREAD = 8;
// The largest grid a block bins in shared memory: 48 KB of counts, the most
// a block takes without opting in (the kernel has no static shared memory).
constexpr int SMEM_BINS = 12288;

struct Points {
  const float* x;
  const float* y;
  const int* count;        // live slots of each row; null: every slot
  long long row_stride;    // in floats, of x and y alike
  long long slot_stride;
  int rows, slots;
  float inv_w, inv_h;      // float32 reciprocals of the viewport's sides
  float x_shift;           // added to x first (a shard's offset in global x)
  int W, H;                // console columns and rows
};

// floor(v * inv * n) as a 64-bit integer, PyTorch's order of rounding.
__device__ __forceinline__ long long console_cell(float v, float inv, int n) {
  return static_cast<long long>(floorf(__fmul_rn(__fmul_rn(v, inv), static_cast<float>(n))));
}

// Grid-stride walk over the R x S slots, adding into `counts` [H * W],
// zero on entry.
template <bool SHARED>
__global__ void __launch_bounds__(THREADS) console_histogram_kernel(Points p, int* __restrict__ counts) {
  extern __shared__ int grid[];
  const int bins = p.W * p.H;
  int* acc = SHARED ? grid : counts;
  if (SHARED) {
    for (int i = threadIdx.x; i < bins; i += blockDim.x) grid[i] = 0;
    __syncthreads();
  }

  const unsigned int total = static_cast<unsigned int>(p.rows) * static_cast<unsigned int>(p.slots);
  for (unsigned int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int r = static_cast<int>(i / p.slots);
    const int s = static_cast<int>(i - static_cast<unsigned int>(r) * p.slots);
    if (p.count != nullptr && s >= p.count[r]) continue;
    const long long off = r * p.row_stride + s * p.slot_stride;
    const long long cx = console_cell(__fadd_rn(p.x[off], p.x_shift), p.inv_w, p.W);
    const long long cy = console_cell(p.y[off], p.inv_h, p.H);
    if (cx >= 0 && cx < p.W && cy >= 0 && cy < p.H) atomicAdd(acc + cy * p.W + cx, 1);
  }

  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < bins; i += blockDim.x)
      if (grid[i] != 0) atomicAdd(counts + i, grid[i]);
  }
}

}  // namespace

extern "C" {

// Counts [H, W] int32 of the points (x + x_shift, y) of rows [rows, slots]
// (strides in floats, shared by x and y), the first count[r] slots of row r
// live (count null: all), in the console of W x H cells over a viewport
// whose sides' float32 reciprocals are inv_w and inv_h: `counts` zeroed,
// then binned into.
int fluid_console_histogram(const float* x, const float* y, const int* count,
                            long long row_stride, long long slot_stride, int rows, int slots,
                            float inv_w, float inv_h, float x_shift, int W, int H, int* counts,
                            void* cuda_stream) {
  const long long total = static_cast<long long>(rows) * slots;
  if (rows < 0 || slots < 0 || total > INT_MAX || W < 1 || H < 1 ||
      static_cast<long long>(W) * H > INT_MAX / static_cast<long long>(sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  Points p{x, y, count, row_stride, slot_stride, rows, slots, inv_w, inv_h, x_shift, W, H};
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // four blocks an SM at most, fewer where the slots would leave threads idle
  long long blocks = (total + THREADS * SLOTS_PER_THREAD - 1) / (THREADS * SLOTS_PER_THREAD);
  blocks = blocks > 4LL * sms ? 4LL * sms : blocks;
  blocks = blocks < 1 ? 1 : blocks;
  const int bins = W * H;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  err = cudaMemsetAsync(counts, 0, static_cast<size_t>(bins) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bins <= SMEM_BINS)
    console_histogram_kernel<true><<<static_cast<int>(blocks), THREADS, bins * sizeof(int), st>>>(p, counts);
  else
    console_histogram_kernel<false><<<static_cast<int>(blocks), THREADS, 0, st>>>(p, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
