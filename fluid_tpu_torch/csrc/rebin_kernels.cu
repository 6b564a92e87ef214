// Hand-written Hopper (sm_90a) kernels of the stream backend's re-bin.
//
// They replace no Pallas kernel: the JAX re-bin (fluid_tpu/ops/
// stream_transfer.py:2346 _bin_rows, :2956 _rebin_full) is XLA glue, a
// gather of the live slots, a key per particle, a sort, and a gather, mask
// and transpose of the slot rows [A, cap, F].  Done as PyTorch operations
// that glue reads and writes the slot rows in full five times a re-bin.
// Here one kernel compacts and keys the live slots and one writes the
// stream from them; the sort and the tile bookkeeping over the grid's
// tiles stay PyTorch operations (ops/stream_transfer.py _bin_rows):
//
//   rebin_gather_kernel<D>  live slots of stream [A, F, cap] -> rows [n, F]
//                           in slot order, each row's predictive tile key
//                           (stream_transfer._keys_from_pos's arithmetic;
//                           packed scenes: in the tile's scene, below)
//   rebin_fill_kernel<D>    rows in sorted order -> stream [A, F, cap]
//                           (empty slots 0) and a zeroed flag [A, cap]
//
// Both are bound by bytes (a few integer operations per float moved): the
// gather reads the n live slots and writes n rows; the fill reads n rows
// and writes the whole stream and flag.  The design moves each byte once:
// one block per tile stages a chunk of up to 256 slots through shared
// memory, so both sides of the transpose are coalesced, the stream side as
// field rows (neighbouring threads on neighbouring slots) and the row side
// as the chunk's run of rows (neighbouring threads on neighbouring floats).
// The staged rows have an odd stride, so a thread reading its slot's
// fields walks the shared banks without conflicts.
//
// Built with -fmad=false (ops/cuda_build.py); the key's multiply and add
// are written as __fmul_rn and __fadd_rn besides, so they round one at a
// time as PyTorch's do and the keys equal the plain version's bit for bit.
//
// Packed scenes (a grid of scenes of sx cells side by side along x): a
// particle is in its scene's coordinates, so the gather keys it in the
// scene of the tile it sits in, read from tid, as stream_kernels.tile_keys
// does with its scene offset: its x cell is clipped to the scene's sx
// columns and moved by the scene's offset.  The fill copies rows and takes
// no geometry.
//
// Each C entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Slots a block stages at a time, and its most threads.
constexpr int CHUNK = 256;

// Stream rows of a D-dimensional particle: pos D, vel D, C D*D, mass, id,
// rho, prs.
template <int D>
__host__ __device__ constexpr int rows_of() {
  return 2 * D + D * D + 4;
}

// The stride of a staged row: F rounded up to an odd count of floats.
template <int D>
__host__ __device__ constexpr int stage_stride() {
  return rows_of<D>() | 1;
}

struct KeyGeom {
  int tshape[3];   // tiles per axis
  int origin[3];   // domain origin, in cells
  int sx;          // grid cells of one scene along axis 0 (one scene: the grid's)
  int T, h;        // tile edge, halo reach
  int nt;          // tiles in the grid: the key of no tile
  int predictive;  // key by pos + clip(step * vel, +-1) where that keeps the cell in the window
  float step;      // the look-ahead LOOKAHEAD * dt, rounded to float32
};

// min(max(floor(x) - origin, 0), shape - 1) on axis d (axis 0: the
// scene's sx columns), plus the scene's offset xoff on axis 0, floor(x)
// converted to a 64-bit integer as PyTorch's .to(torch.int64) converts it.
__device__ __forceinline__ long long clip_cell(float x, int d, const KeyGeom& k, int xoff) {
  long long c = static_cast<long long>(floorf(x)) - k.origin[d];
  c = c < 0 ? 0 : c;
  const long long hi = (d == 0 ? static_cast<long long>(k.sx) : static_cast<long long>(k.tshape[d]) * k.T) - 1;
  return (c < hi ? c : hi) + (d == 0 ? xoff : 0);
}

// The tile key of one particle of the scene at offset xoff, axis by axis:
// the tile of pos + clip(step * vel, -1, 1) where the particle's current
// cell lies in that tile's drift window, else the tile of the current cell.
template <int D>
__device__ __forceinline__ int tile_key(const float* pos, const float* vel, const KeyGeom& k,
                                        int xoff) {
  int key = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const long long cell = clip_cell(pos[d], d, k, xoff);
    long long kt = cell / k.T;
    if (k.predictive) {
      float s = __fmul_rn(vel[d], k.step);
      s = isnan(s) ? s : fminf(fmaxf(s, -1.0f), 1.0f);  // torch.clamp keeps a NaN
      const long long ct = clip_cell(__fadd_rn(pos[d], s), d, k, xoff) / k.T;
      const long long lc = cell - ct * k.T;
      if (lc >= 1 - k.h && lc <= k.T - 2 + k.h) kt = ct;
    }
    key = key * k.tshape[d] + static_cast<int>(kt);
  }
  return key;
}

// One block per tile a: its count[a] live slots become rows cum[a] -
// count[a] + s of `rows`, s in slot order, each with its key in the scene
// of tile tidv[a] (tidv null: one scene); rows past the live count
// (cum[A - 1]) up to n are zeros with the key nt, written by all blocks
// together.  Rows past n are dropped.
template <int D>
__global__ void __launch_bounds__(CHUNK) rebin_gather_kernel(
    const float* __restrict__ stream, const int* __restrict__ count, const int* __restrict__ cum,
    const int* __restrict__ tidv, float* __restrict__ rows, int* __restrict__ keys, int A,
    int cap, int n, KeyGeom k) {
  constexpr int F = rows_of<D>(), FP = stage_stride<D>();
  __shared__ float stage[CHUNK * FP];
  const int a = blockIdx.x, t = threadIdx.x, chunk = blockDim.x;

  for (int i = cum[A - 1] + a * chunk + t; i < n; i += A * chunk) {
    keys[i] = k.nt;
#pragma unroll
    for (int f = 0; f < F; ++f) rows[static_cast<long long>(i) * F + f] = 0.0f;
  }

  const int cnt = count[a];
  const int start = cum[a] - cnt;
  const float* tile = stream + static_cast<long long>(a) * F * cap;
  int xoff = 0;  // the tile's scene's offset on axis 0
  if (tidv != nullptr && cnt > 0) {
    int div = 1;
    for (int d = 1; d < D; ++d) div *= k.tshape[d];
    const int c = tidv[a] / div % k.tshape[0] * k.T;
    xoff = c / k.sx * k.sx;
  }
  for (int c0 = 0; c0 < cnt && start + c0 < n; c0 += chunk) {
    const int ns = min(chunk, cnt - c0);
    const int row0 = start + c0;
    if (t < ns) {
      float pos[D], vel[D];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float v = tile[static_cast<long long>(f) * cap + c0 + t];
        stage[t * FP + f] = v;
        if (f < D) pos[f] = v;
        else if (f < 2 * D) vel[f - D] = v;
      }
      if (row0 + t < n) keys[row0 + t] = tile_key<D>(pos, vel, k, xoff);
    }
    __syncthreads();
    const int m = min(ns, n - row0) * F;
    float* dst = rows + static_cast<long long>(row0) * F;
    for (int i = t; i < m; i += chunk) {
      const int s = i / F;
      dst[i] = stage[s * FP + (i - s * F)];
    }
    __syncthreads();
  }
}

// One block per tile a: slot s < count[a] of stream [A, F, cap] gets row
// order[start[a] + s] of `rows` (the index clipped to n - 1), every other
// slot 0; flag[a] is zeroed.  Chunk by chunk of slots: the chunk's rows are
// staged, then written field by field.
template <int D>
__global__ void __launch_bounds__(CHUNK) rebin_fill_kernel(
    const float* __restrict__ rows, const long long* __restrict__ order,
    const long long* __restrict__ start, const int* __restrict__ count,
    float* __restrict__ stream, float* __restrict__ flag, int cap, int n) {
  constexpr int F = rows_of<D>(), FP = stage_stride<D>();
  __shared__ float stage[CHUNK * FP];
  __shared__ long long src[CHUNK];
  const int a = blockIdx.x, t = threadIdx.x, chunk = blockDim.x;
  const int cnt = count[a];
  const long long s0 = start[a];
  float* tile = stream + static_cast<long long>(a) * F * cap;

  for (int c0 = 0; c0 < cap; c0 += chunk) {
    const int ns = max(0, min(chunk, cnt - c0));
    if (ns > 0) {
      if (t < ns) {
        const long long j = s0 + c0 + t;
        src[t] = order[j < n - 1 ? j : n - 1] * F;
      }
      __syncthreads();
      for (int i = t; i < ns * F; i += chunk) {
        const int s = i / F;
        stage[s * FP + (i - s * F)] = rows[src[s] + (i - s * F)];
      }
      __syncthreads();
    }
    const int slot = c0 + t;
    if (slot < cap) {
#pragma unroll
      for (int f = 0; f < F; ++f)
        tile[static_cast<long long>(f) * cap + slot] = t < ns ? stage[t * FP + f] : 0.0f;
      flag[static_cast<long long>(a) * cap + slot] = 0.0f;
    }
    __syncthreads();
  }
}

bool bad_cap(int cap) { return cap <= 0 || cap % 32; }

}  // namespace

extern "C" {

// Compact and key the live slots: rows [n, F] and keys [n] int32 from
// stream [A, F, cap], count [A] and its inclusive prefix sum cum [A].
// tshape and origin: host int[3] (dim entries used).  Packed scenes of sx
// grid cells along axis 0: tid [A], each tile's id; one scene: tid null,
// sx = tshape[0] * T.
int fluid_rebin_gather(int dim, const float* stream, const int* count, const int* cum,
                       const int* tid, float* rows, int* keys, int A, int cap, int n, int T,
                       int h, const int* tshape, const int* origin, int sx, int predictive,
                       float step, void* cuda_stream) {
  if (bad_cap(cap) || A < 1 || n < 1 || (dim != 2 && dim != 3) || sx < T || sx % T)
    return static_cast<int>(cudaErrorInvalidValue);
  KeyGeom k{};
  k.nt = 1;
  for (int d = 0; d < dim; ++d) {
    k.tshape[d] = tshape[d];
    k.origin[d] = origin[d];
    k.nt *= tshape[d];
  }
  k.sx = sx;
  k.T = T;
  k.h = h;
  k.predictive = predictive;
  k.step = step;
  const int threads = cap < CHUNK ? cap : CHUNK;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (dim == 2)
    rebin_gather_kernel<2><<<A, threads, 0, st>>>(stream, count, cum, tid, rows, keys, A, cap, n, k);
  else
    rebin_gather_kernel<3><<<A, threads, 0, st>>>(stream, count, cum, tid, rows, keys, A, cap, n, k);
  return static_cast<int>(cudaGetLastError());
}

// Write stream [A, F, cap] (F = 2 dim + dim^2 + 4) and zero flag [A, cap]
// from rows [N, F] taken in the order of order [n] (int64), tile a's run
// starting at start[a] (int64) and count[a] long.
int fluid_rebin_fill(int dim, const float* rows, const long long* order, const long long* start,
                     const int* count, float* stream, float* flag, int A, int cap, int n,
                     void* cuda_stream) {
  if (bad_cap(cap) || A < 1 || n < 1 || (dim != 2 && dim != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = cap < CHUNK ? cap : CHUNK;
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (dim == 2)
    rebin_fill_kernel<2><<<A, threads, 0, st>>>(rows, order, start, count, stream, flag, cap, n);
  else
    rebin_fill_kernel<3><<<A, threads, 0, st>>>(rows, order, start, count, stream, flag, cap, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
