// Hand-written Hopper (sm_90a) kernels of the construct probes
// (fluid_tpu_torch/micro/micro_zfac_probe.py).
//
// Counterparts of bench/micro_zfac_probe.py's one Pallas site, `run` :31
// (pl.pallas_call :37), over its thirteen one-block kernels p1-p13
// (:62-222).  On the v5e each probe asked whether Mosaic lowers one
// construct of the z-factored dots: a rank-3 broadcast build, an N = 64
// dot, sublane-group reshapes, lane pads and rolls, iota selectors.  Here
// each construct is index arithmetic:
//
//   M9  probe_map<P>      p1, p3, p4, p8, p9, p11, p12: each output element
//                         from at most two inputs through a static index map
//                         (the reshapes, pads, rolls and broadcasts are the
//                         map, not data movement of their own)
//   M10 probe_contract<P> p2, p5, p6, p10, p13: out[i, j] = sum_k a(i,j,k) *
//                         b(i,j,k) with static operand maps; f32 products
//                         and sums in k order from the first product (no
//                         tensor cores, no TF32, no library GEMM); p6's zero
//                         rows of B are not read, p13's iota selector is
//                         made in registers
//   M11 probe_roll_merge  p7: the eight selector contractions S_k[j] = sum of
//                         the rows i = k (mod 8) of Y, and their lane rolls by
//                         64 k, accumulated in k order; the selector ignores
//                         the output row, so all 12 rows are equal (the
//                         script's quirk, kept)
//   probe_empty           one thread, no work: the launch floor the probes
//                         are read against (ports nothing)
//
// Shapes are the script's, every operand one [1, ...] f32 block with its
// leading 1 dropped here (GL = 1024, E = 8, cap = 128):
//   p1  U [12, GL], wz [8, GL] -> [96, GL]    out[8r+e, l] = U[r, l] wz[e, l]
//   p2  A [96, 128], B [64, 128] -> [96, 64]  A B^T
//   p3  [96, 64] -> [12, 512]                 row-major reshape
//   p4  [32, 128] -> [64, 64]                 row-major reshape
//   p5  A, B as p2 -> [96, 128]               A B^T in lanes 0-63, zeros after
//   p6  A, B as p2 -> [96, 128]               A [B; 0]^T
//   p7  Y [96, 128] -> [12, 512]              sum_k roll(S_k zero-padded, 64 k)
//   p8  Y [96, 128] -> [48, 128]              Y[8r+q] + 2 Y[8r+4+q] (row 4r+q)
//   p9  Y [96, 128] -> [48, 128]              Y[8r+q, l] (l < 64), Y[8r+4+q, l-64]
//   p10 a [64, 128], wz [8, 128] -> [16, 128] sum_{q<4} a[4i+q, l] wz[q, l]
//   p11 Z [16, 128] -> [16, 128]              Z[r, l] (2 (r mod 4) + [l >= 64])
//   p12 g [4, 128] -> [64, 128]               g[r mod 4]
//   p13 g [16, 128] -> [64, 128]              iota selector [64, 16] times g
//
// Bounds on this card: every probe moves under 0.5 MB (p1's output, 384 KB,
// is the largest) and does at most 1.6 MFLOP (p2), so each bound is under
// 0.2 us, far under a launch.  The kernels are simple and correct: one
// thread an output (p1: 384 CTAs of 256, the others 8-48; p7 one CTA of
// 512), every operand read from global memory through L1.  A first form
// with one CTA for each 4,096 outputs (p2: 2 CTAs) left each thread 12-16
// serial 128-term sums and took 11-14x longer on p2, p5, p6.  p2's threads still read B's rows 512
// bytes apart (32 L1 sectors a warp load, 128 loads a thread), which keeps
// M10's N = 64 dots above torch.matmul; staging B in shared memory k-major
// is the lead for a later change.
//
// With -fmad=false every product and sum is rounded on its own, so M9 is
// bit-equal to its plain PyTorch version and M10 equals p10's and p13's.
//
// Each C entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError(), or cudaErrorInvalidValue
// for a probe number its kernel does not serve.

#include <cuda_runtime.h>

namespace {

constexpr int GL = 1024;
constexpr int THREADS = 256;

__host__ __device__ constexpr int out_rows(int p) {
  switch (p) {
    case 1: case 2: case 5: case 6: return 96;
    case 3: case 7: return 12;
    case 4: case 12: case 13: return 64;
    case 8: case 9: return 48;
    default: return 16;  // p10, p11
  }
}

__host__ __device__ constexpr int out_cols(int p) {
  switch (p) {
    case 1: return GL;
    case 2: case 4: return 64;
    case 3: case 7: return 512;
    default: return 128;
  }
}

constexpr int ctas(int n) { return (n + THREADS - 1) / THREADS; }  // one output a thread

// ---------------------------------------------------------------------------
// M9: out[r, c] through the probe's index map
// ---------------------------------------------------------------------------

template <int P>
__device__ __forceinline__ float map_value(const float* __restrict__ a,
                                           const float* __restrict__ b, int r, int c) {
  if constexpr (P == 1) {  // (U[:, None] * wz[None]).reshape(96, GL)
    return a[(r >> 3) * GL + c] * b[(r & 7) * GL + c];
  } else if constexpr (P == 3 || P == 4) {  // a reshape keeps the flat order
    return a[r * out_cols(P) + c];
  } else if constexpr (P == 8) {  // Y.reshape(12, 2, 4, 128): [:, 0] + 2 [:, 1]
    const int y = ((r >> 2) * 8 + (r & 3)) * 128 + c;
    return a[y] + 2.0f * a[y + 4 * 128];
  } else if constexpr (P == 9) {  // where(l < 64, Ya, roll(Yb, 64, 1))
    const int y = ((r >> 2) * 8 + (r & 3)) * 128;
    return c < 64 ? a[y + c] : a[y + 4 * 128 + c - 64];
  } else if constexpr (P == 11) {  // Z * (2 (row mod 4) + (lane >= 64))
    return a[r * 128 + c] * static_cast<float>(2 * (r & 3) + (c >= 64 ? 1 : 0));
  } else {  // P == 12: broadcast_to(g[None], (16, 4, 128)).reshape(64, 128)
    static_assert(P == 12, "probe_map serves p1, p3, p4, p8, p9, p11, p12");
    return a[(r & 3) * 128 + c];
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
    probe_map(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out) {
  constexpr int cols = out_cols(P);
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t < out_rows(P) * cols) out[t] = map_value<P>(a, b, t / cols, t % cols);
}

// ---------------------------------------------------------------------------
// M10: out[i, j] = sum_k a(i,j,k) b(i,j,k), k in order
// ---------------------------------------------------------------------------

template <int P>
__host__ __device__ constexpr int depth() {
  return P == 10 ? 4 : P == 13 ? 16 : 128;
}

template <int P>
__device__ __forceinline__ float term(const float* __restrict__ a, const float* __restrict__ b,
                                      int i, int j, int k) {
  if constexpr (P == 2 || P == 5) {  // A B^T (p5: j < 64 only)
    return a[i * 128 + k] * b[j * 128 + k];
  } else if constexpr (P == 6) {  // A [B; 0]^T: the zero rows are not read
    return a[i * 128 + k] * (j < 64 ? b[j * 128 + k] : 0.0f);
  } else if constexpr (P == 10) {  // a.reshape(16, 4, 128)[:, k] * wz[k]
    return a[(4 * i + k) * 128 + j] * b[k * 128 + j];
  } else {  // P == 13: sel[i, k] = (k == i mod 16), made in registers, times g[k, j]
    static_assert(P == 13, "probe_contract serves p2, p5, p6, p10, p13");
    return (k == (i & 15) ? 1.0f : 0.0f) * a[k * 128 + j];
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS)
    probe_contract(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ out) {
  constexpr int cols = out_cols(P);
  const int t = blockIdx.x * THREADS + threadIdx.x;
  if (t >= out_rows(P) * cols) return;
  const int i = t / cols, j = t % cols;
  if constexpr (P == 5) {
    if (j >= 64) {  // jnp.pad of the N = 64 product
      out[t] = 0.0f;
      return;
    }
  }
  float acc = term<P>(a, b, i, j, 0);
#pragma unroll 4
  for (int k = 1; k < depth<P>(); ++k) acc = acc + term<P>(a, b, i, j, k);
  out[t] = acc;
}

// ---------------------------------------------------------------------------
// M11: p7's selector contractions and lane rolls
// ---------------------------------------------------------------------------

constexpr int ROLL_LANES = 512, ROLL_ROWS = 12, Y_ROWS = 96, Y_LANES = 128;

// One thread a lane l of the [12, 512] output: for k = 0..7 the rolled
// part's lane l is S_k[(l - 64 k) mod 512], zero past the 128 lanes Y has
// (its pad); S_k[j] sums Y's rows k, k + 8, ..., k + 88 in order.
__global__ void __launch_bounds__(ROLL_LANES)
    probe_roll_merge(const float* __restrict__ y, float* __restrict__ out) {
  const int l = threadIdx.x;
  float acc = 0.0f;
  for (int k = 0; k < 8; ++k) {
    const int j = (l - 64 * k) & (ROLL_LANES - 1);
    if (j >= Y_LANES) continue;
    float s = y[k * Y_LANES + j];
#pragma unroll
    for (int q = 1; q < Y_ROWS / 8; ++q) s = s + y[(8 * q + k) * Y_LANES + j];
    acc = acc + s;
  }
#pragma unroll
  for (int r = 0; r < ROLL_ROWS; ++r) out[r * ROLL_LANES + l] = acc;
}

__global__ void probe_empty() {}

template <int P>
int launch_map(const float* a, const float* b, float* out, cudaStream_t st) {
  probe_map<P><<<ctas(out_rows(P) * out_cols(P)), THREADS, 0, st>>>(a, b, out);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_contract(const float* a, const float* b, float* out, cudaStream_t st) {
  probe_contract<P><<<ctas(out_rows(P) * out_cols(P)), THREADS, 0, st>>>(a, b, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// M9 for probe number `probe` (1, 3, 4, 8, 9, 11 or 12); b is read by p1 only.
int fluid_micro_probe_map(int probe, const float* a, const float* b, float* out,
                          void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  switch (probe) {
    case 1: return launch_map<1>(a, b, out, st);
    case 3: return launch_map<3>(a, b, out, st);
    case 4: return launch_map<4>(a, b, out, st);
    case 8: return launch_map<8>(a, b, out, st);
    case 9: return launch_map<9>(a, b, out, st);
    case 11: return launch_map<11>(a, b, out, st);
    case 12: return launch_map<12>(a, b, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// M10 for probe number `probe` (2, 5, 6, 10 or 13); b is not read by p13.
int fluid_micro_probe_contract(int probe, const float* a, const float* b, float* out,
                               void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  switch (probe) {
    case 2: return launch_contract<2>(a, b, out, st);
    case 5: return launch_contract<5>(a, b, out, st);
    case 6: return launch_contract<6>(a, b, out, st);
    case 10: return launch_contract<10>(a, b, out, st);
    case 13: return launch_contract<13>(a, b, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// M11: p7, y [96, 128] -> out [12, 512].
int fluid_micro_probe_roll_merge(const float* y, float* out, void* cuda_stream) {
  probe_roll_merge<<<1, ROLL_LANES, 0, static_cast<cudaStream_t>(cuda_stream)>>>(y, out);
  return static_cast<int>(cudaGetLastError());
}

// The empty one-thread kernel: the launch floor.
int fluid_micro_probe_empty(void* cuda_stream) {
  probe_empty<<<1, 1, 0, static_cast<cudaStream_t>(cuda_stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
