// Hand-written Hopper (sm_90a) kernels of the stream-probe entry point
// fluid_tpu_torch/micro/micro_kernels.py: counterparts of the Pallas kernels
// of bench/micro_kernels.py (wrappers and plain versions in
// ops/micro_stream.py).
//
//   M5 stage_fill              _case_kernel (:120) over case_dma_only (:195);
//                              case_nodma (:349); _tb_kernel (:376) over
//                              case_dma_tb (:430); _tb2_kernel (:528) over
//                              case_tb2_dma (:564); _tb3_dma (:825); _tb4_dma (:1198)
//   M6 window_contract<E, N>   _case_kernel over case_window_build (:204) and
//                              case_matmul (:223)
//   M7 p2g1_deposit<E, FORM>   _case_kernel over case_deposit_current (:239) and
//                              case_deposit_onewindow (:301); _tb_kernel over
//                              case_deposit_onewindow_tb (:497); _tb2_kernel over
//                              case_tb2_deposit (:571); _tb3_deposit (:794);
//                              _tb4_deposit (:1062)
//   M8 window_collect<E>       case_tb2_collect (:649), _tb3_collect (:854),
//                              _tb4_collect (:1127)
//
// One kernel serves all four of the script's stream layouts: a tile's block
// is a strided view (Strided below: tile base, field stride, slot stride),
// so the row-major stream [n + cap, 128], the slot-major [16, A*cap], the
// blocks [A, 16, cap] and the grouped [NG, 16, G*cap] differ only in three
// numbers.  The row-major base is the script's: tile i of a program of TB
// tiles starts at row starts[i - i % TB] + (i % TB) * cap, the program's
// first row clamped into the stream as dynamic_slice clamps it.  Outputs
// are strided views the same way (tb4 writes [4, EP] a tile, channel-major,
// its lanes past E^3 zero).  Tiles the script's grid (A // TB programs)
// never writes come out zero.
//
// The window is the script's: per axis the particle's cell lc, clipped
// (and shifted by E - T - 2, except in the "current" deposit), gives three
// B-spline weights at profile rows lc + o (rows past E dropped), and
// W0[e0*E*E + e1*E + e2, p] = (prof0[e0,p] * prof1[e1,p]) * prof2[e2,p].
// Each kernel builds the tile's profiles in shared memory (M6, M7: [p][e]
// a axis, each thread forming its window rows' W0 values on the fly; M8:
// axis 0 in shared memory, axes 1 and 2 in the thread's own registers) and
// never W0 in global memory.  The contractions are the script's dense
// forms, over every window row: FP32 FMAs (no tensor cores, no TF32),
// each sum taken over the slots in order from 0.0f; every other product and
// sum is rounded on its own (-fmad=false), in the order of the JAX
// kernels' elementwise arithmetic.
//
// Bounds on this card at the script's 1M shapes (chip_smoke.py computes
// them from each run's inputs):
//   M5  bytes: the programs' blocks read (on the row-major stream the union
//       of their rows) and the output written; nodma writes only.
//   M6  bytes for the row sums (8 equal columns out), operations for the
//       products (2 N E^3 a slot).
//   M7  operations: the valid slots' contraction (16 E^3 a slot in its
//       least order).
//   M8  operations: 2 * 13 * E^3 a slot.
//
// What the TPU blocking becomes: the Pallas kernels' scalar-prefetched
// starts, manual double buffer and BlockSpec pipelining move a program's
// block into VMEM.  Here M5 stages a program's block through a ring of
// shared-memory buffers by the bulk-copy engine (cp.async.bulk completing on
// an mbarrier, as micro_kernels.cu's bulk_copy does), and M6-M8 read the
// tile's entries straight from global memory; TB and G only set the tiles a
// CTA owns.
//
// Each C entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() (or the error of setting
// a launch's shared memory size).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 3, FO = 18;
constexpr int FIELD_VEL = 3, FIELD_C = 6, FIELD_MASS = 15;
constexpr int FORM_CURRENT = 0, FORM_ONEWINDOW = 1, FORM_RAW = 2;

// A tile tensor inside a flat float tensor: tile i's entry (a, b) at
// base(i) + a * sa + b * sb (ops/micro_stream.py Strided).
struct Strided {
  long long group, group_stride, tile_stride, sa, sb, offset, tb, cap, last_row;
  const int* starts;  // row-major stream: each program's first row

  __device__ __forceinline__ long long base(long long i) const {
    if (starts != nullptr) {
      long long first = starts[i - i % tb];
      first = first < 0 ? 0 : (first > last_row ? last_row : first);
      return offset + (first + (i % tb) * cap) * sb;
    }
    return offset + (i / group) * group_stride + (i % group) * tile_stride;
  }
};

Strided strided(const long long* p, const int* starts) {
  return Strided{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8], starts};
}

struct Geom {  // the window's tile size, tile grid and slots a tile
  int T, ts0, ts1, ts2, cap;
};

Geom geom(int T, const int* tshape, int cap) { return Geom{T, tshape[0], tshape[1], tshape[2], cap}; }

__device__ __forceinline__ void tile_coords(int tile, const Geom& g, int (&c)[D]) {
  c[0] = (tile / (g.ts1 * g.ts2)) % g.ts0;
  c[1] = (tile / g.ts2) % g.ts1;
  c[2] = tile % g.ts2;
}

// The window row of the particle's first tap on one axis (lc clipped to
// [lo, hi], plus shift), its dv and its three tap weights.
__device__ __forceinline__ int taps(float pos, int coord, int T, int lo, int hi, int shift,
                                    float& dv, float (&w)[3]) {
  const float cell = floorf(pos);
  const int lc = min(max(static_cast<int>(cell) - coord * T, lo), hi);
  dv = (pos - cell) - 0.5f;
  const float a = 0.5f - dv, b = 0.5f + dv;
  w[0] = 0.5f * (a * a);
  w[1] = 0.75f - dv * dv;
  w[2] = 0.5f * (b * b);
  return lc + shift;
}

__device__ __forceinline__ float tap_at(int e, int first, const float (&w)[3]) {
  return e == first ? w[0] : (e == first + 1 ? w[1] : (e == first + 2 ? w[2] : 0.0f));
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// ---------------------------------------------------------------------------
// M5: stage each program's block through shared memory, fill its outputs
// ---------------------------------------------------------------------------

constexpr int FILL_THREADS = 256, FILL_STAGES = 4, FILL_STAGE_BYTES = 16 * 1024, MAX_VALUES = 16;

struct FillArgs {
  const float* src;
  Strided view;
  long long offs[MAX_VALUES];  // each fill value's float offset in the block's first segment
  long long tb, nval, nprog, nseg, seg_len, seg_stride, out_len, out_total;
  float* out;
  int nodma;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// CTA q is program q (tiles q*tb ... q*tb + tb - 1).  Thread 0 streams the
// program's block (nseg segments of seg_len floats, seg_stride apart, from
// tile q*tb's base) through FILL_STAGES buffers of FILL_STAGE_BYTES and
// keeps the fill values as their chunks land; then every thread writes the
// nval outputs of out_len floats.  The CTA past the last program zeroes the
// outputs no program writes.
__global__ void __launch_bounds__(FILL_THREADS) stage_fill(FillArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[FILL_STAGES];
  __shared__ float vals[MAX_VALUES];
  const long long q = blockIdx.x, done = a.nprog * a.nval * a.out_len;
  if (q >= a.nprog) {
    for (long long k = done + threadIdx.x; k < a.out_total; k += FILL_THREADS) a.out[k] = 0.0f;
    return;
  }
  const long long first = q * a.tb;
  if (a.nodma) {
    if (threadIdx.x < a.nval) vals[threadIdx.x] = static_cast<float>(first + threadIdx.x);
  } else if (threadIdx.x == 0) {
    const char* block = reinterpret_cast<const char*>(a.src + a.view.base(first));
    const long long seg_bytes = a.seg_len * 4;
    const long long per_seg = (seg_bytes + FILL_STAGE_BYTES - 1) / FILL_STAGE_BYTES;
    const long long chunks = a.nseg * per_seg;
    for (int s = 0; s < FILL_STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    auto chunk_bytes = [&](long long k) {
      return static_cast<uint32_t>(
          min(static_cast<long long>(FILL_STAGE_BYTES), seg_bytes - (k % per_seg) * FILL_STAGE_BYTES));
    };
    auto load = [&](long long k) {
      const int s = static_cast<int>(k % FILL_STAGES);
      const uint32_t nb = chunk_bytes(k), bar = smem_u32(&full[s]);
      const char* from = block + (k / per_seg) * a.seg_stride * 4 + (k % per_seg) * FILL_STAGE_BYTES;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(nb)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
          ::"r"(smem_u32(ring + s * FILL_STAGE_BYTES)), "l"(from), "r"(nb), "r"(bar)
          : "memory");
    };
    for (long long k = 0; k < min(static_cast<long long>(FILL_STAGES), chunks); ++k) load(k);
    for (long long k = 0; k < chunks; ++k) {
      const int s = static_cast<int>(k % FILL_STAGES);
      mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((k / FILL_STAGES) & 1));
      if (k < per_seg) {  // the first segment: the fill values in this chunk
        const long long lo = k * (FILL_STAGE_BYTES / 4), hi = lo + chunk_bytes(k) / 4;
        const float* staged = reinterpret_cast<const float*>(ring + s * FILL_STAGE_BYTES);
        for (int j = 0; j < a.nval; ++j)
          if (a.offs[j] >= lo && a.offs[j] < hi) vals[j] = staged[a.offs[j] - lo];
      }
      if (k + FILL_STAGES < chunks) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the reads above first
        load(k + FILL_STAGES);
      }
    }
  }
  __syncthreads();
  for (int j = 0; j < a.nval; ++j) {
    const float v = vals[j];
    float* out = a.out + (q * a.nval + j) * a.out_len;
    if (a.out_len % 4 == 0) {
      for (long long k = threadIdx.x; k < a.out_len / 4; k += FILL_THREADS)
        reinterpret_cast<float4*>(out)[k] = make_float4(v, v, v, v);
    } else {
      for (long long k = threadIdx.x; k < a.out_len; k += FILL_THREADS) out[k] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// M6: out[t, e, n] = sum_p W0[e, p] V[n, p] over all cap slots
// ---------------------------------------------------------------------------

constexpr int TILE_THREADS = 256;

struct ContractArgs {
  const float* src;
  Strided view;
  Geom g;
  float* out;  // [A, E^3, N or 8]
};

template <int E, int N>
constexpr size_t contract_smem(int cap) {
  return sizeof(float) * (static_cast<size_t>(D) * cap * E + static_cast<size_t>(cap) * N);
}

// One CTA a tile (its coordinate from the tile index, the shifted clip).
// Shared memory: the profiles pr[d][p][e], then V[p][n] (the tile's first N
// fields; N = 0: V is ones, nothing staged, 8 equal columns out).  Thread
// item = (e, block of up to 16 columns) walks the slots, forming W0[e, p].
template <int E, int N>
__global__ void __launch_bounds__(TILE_THREADS) window_contract(ContractArgs a) {
  constexpr int E3 = E * E * E, COLS = N == 0 ? 8 : N, NB = N == 0 ? 1 : (N < 16 ? N : 16);
  constexpr int NBLK = N == 0 ? 1 : N / NB;
  extern __shared__ __align__(16) float sm[];
  const int cap = a.g.cap, t = threadIdx.x, i = blockIdx.x;
  const int shift = E - a.g.T - 2;
  float* pr = sm;
  float* V = sm + D * cap * E;
  const float* s = a.src + a.view.base(i);
  int coord[D];
  tile_coords(i, a.g, coord);
  for (int p = t; p < cap; p += TILE_THREADS) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float w[3], dv;
      const int f = taps(s[d * a.view.sa + p * a.view.sb], coord[d], a.g.T, -shift,
                         a.g.T - 1 + shift, shift, dv, w);
#pragma unroll
      for (int e = 0; e < E; ++e) pr[(d * cap + p) * E + e] = tap_at(e, f, w);
    }
  }
  if constexpr (N > 0) {
    for (int k = t; k < cap * N; k += TILE_THREADS)
      V[k] = s[(k % N) * a.view.sa + (k / N) * a.view.sb];
  }
  __syncthreads();
  for (int item = t; item < E3 * NBLK; item += TILE_THREADS) {
    const int e = item % E3, nb = item / E3;
    const int e0 = e / (E * E), e1 = (e / E) % E, e2 = e % E;
    const float* p0 = pr + e0;
    const float* p1 = pr + cap * E + e1;
    const float* p2 = pr + 2 * cap * E + e2;
    float acc[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) acc[n] = 0.0f;
#pragma unroll 4
    for (int p = 0; p < cap; ++p) {
      const float w = (p0[p * E] * p1[p * E]) * p2[p * E];
      if constexpr (N == 0) {
        acc[0] = acc[0] + w;
      } else {
        const float4* v4 = reinterpret_cast<const float4*>(V + p * N + nb * NB);
#pragma unroll
        for (int n4 = 0; n4 < NB / 4; ++n4) {
          const float4 v = v4[n4];
          acc[4 * n4] = __fmaf_rn(w, v.x, acc[4 * n4]);
          acc[4 * n4 + 1] = __fmaf_rn(w, v.y, acc[4 * n4 + 1]);
          acc[4 * n4 + 2] = __fmaf_rn(w, v.z, acc[4 * n4 + 2]);
          acc[4 * n4 + 3] = __fmaf_rn(w, v.w, acc[4 * n4 + 3]);
        }
      }
    }
    float4* o = reinterpret_cast<float4*>(a.out + (static_cast<size_t>(i) * E3 + e) * COLS + nb * NB);
    if constexpr (N == 0) {
      o[0] = o[1] = make_float4(acc[0], acc[0], acc[0], acc[0]);
    } else {
#pragma unroll
      for (int n4 = 0; n4 < NB / 4; ++n4)
        o[n4] = make_float4(acc[4 * n4], acc[4 * n4 + 1], acc[4 * n4 + 2], acc[4 * n4 + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// M7: the p2g1 deposit of the valid slots
// ---------------------------------------------------------------------------

struct DepositArgs {
  const float* src;
  Strided view;
  const int* count;
  const int* tid;  // tile coordinates from tid[i], or (null) from i
  float* out;
  Strided oview;   // entry (e, c) of tile i
  int ep, A, written, tpc;
  Geom g;
};

template <int E, int FORM>
constexpr size_t deposit_smem(int cap) {
  return sizeof(float) * (static_cast<size_t>(FORM == FORM_CURRENT ? 2 * D : D) * cap * E +
                          static_cast<size_t>(cap) * 16);
}

// CTA q takes tiles q*tpc ... q*tpc + tpc - 1.  Shared memory: the
// profiles pr[d][p][e] (FORM_CURRENT: then the moment profiles, the plain
// one times o - 1 at row lc + o) and V[p][16]: FORM_CURRENT [mass, A_i],
// then per axis d [0, m C[i][d]] against the four windows W0, Wv_0..2;
// otherwise the one-window rows [mass, A_i - sum_d (lc_d + 1) m C[i][d]],
// then per axis [0, m C[i][d]] against W0.  Thread e walks the valid slots.
template <int E, int FORM>
__global__ void __launch_bounds__(TILE_THREADS) p2g1_deposit(DepositArgs a) {
  constexpr int E3 = E * E * E, CH = FORM == FORM_RAW ? 16 : 4;
  constexpr int NPROF = FORM == FORM_CURRENT ? 2 * D : D;
  extern __shared__ __align__(16) float sm[];
  const int cap = a.g.cap, t = threadIdx.x, T = a.g.T;
  const int shift = FORM == FORM_CURRENT ? 0 : E - T - 2;
  float* pr = sm;
  float* V = sm + NPROF * cap * E;
  for (int j = 0; j < a.tpc; ++j) {
    const int i = blockIdx.x * a.tpc + j;
    if (i >= a.A) return;
    const long long ob = a.oview.base(i);
    float* out = a.out + ob;
    if (i >= a.written) {
      for (int k = t; k < a.ep * CH; k += TILE_THREADS)
        out[(k / CH) * a.oview.sa + (k % CH) * a.oview.sb] = 0.0f;
      continue;
    }
    const int nvalid = min(max(a.count[i], 0), cap);
    int coord[D];
    tile_coords(a.tid != nullptr ? a.tid[i] : i, a.g, coord);
    const float* s = a.src + a.view.base(i);
    const long long sa = a.view.sa, sb = a.view.sb;
    for (int p = t; p < nvalid; p += TILE_THREADS) {
      float dv[D];
      int f[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float w[3];
        f[d] = taps(s[d * sa + p * sb], coord[d], T, -shift, T - 1 + shift, shift, dv[d], w);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          pr[(d * cap + p) * E + e] = tap_at(e, f[d], w);
          if constexpr (FORM == FORM_CURRENT) {
            const float m[3] = {w[0] * -1.0f, w[1] * 0.0f, w[2] * 1.0f};
            pr[((D + d) * cap + p) * E + e] = tap_at(e, f[d], m);
          }
        }
      }
      const float mass = s[FIELD_MASS * sa + p * sb];
      float vel[D], C[D][D];
#pragma unroll
      for (int k = 0; k < D; ++k) {
        vel[k] = s[(FIELD_VEL + k) * sa + p * sb];
#pragma unroll
        for (int l = 0; l < D; ++l) C[k][l] = s[(FIELD_C + D * k + l) * sa + p * sb];
      }
      float* v = V + p * 16;
      v[0] = mass;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float cd = (C[k][0] * dv[0] + C[k][1] * dv[1]) + C[k][2] * dv[2];
        float acc = mass * (vel[k] - cd);
        if constexpr (FORM != FORM_CURRENT) {
#pragma unroll
          for (int d = 0; d < D; ++d) acc = acc - (static_cast<float>(f[d]) + 1.0f) * (mass * C[k][d]);
        }
        v[1 + k] = acc;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        v[4 + 4 * d] = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) v[5 + 4 * d + k] = mass * C[k][d];
      }
    }
    __syncthreads();
    for (int e = t; e < a.ep; e += TILE_THREADS) {
      float res[CH];
      if (e < E3) {
        const int e0 = e / (E * E), e1 = (e / E) % E, e2 = e % E;
        const float* p0 = pr + e0;
        const float* p1 = pr + cap * E + e1;
        const float* p2 = pr + 2 * cap * E + e2;
        float acc[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) acc[c] = 0.0f;
#pragma unroll 2
        for (int p = 0; p < nvalid; ++p) {
          const float P0 = p0[p * E], P1 = p1[p * E], P2 = p2[p * E];
          float w[4];
          if constexpr (FORM == FORM_CURRENT) {
            const float M0 = p0[(D * cap + p) * E], M1 = p1[(D * cap + p) * E],
                        M2 = p2[(D * cap + p) * E];
            w[0] = (P0 * P1) * P2;
            w[1] = (M0 * P1) * P2;
            w[2] = (P0 * M1) * P2;
            w[3] = (P0 * P1) * M2;
          } else {
            w[0] = w[1] = w[2] = w[3] = (P0 * P1) * P2;
          }
          const float4* v4 = reinterpret_cast<const float4*>(V + p * 16);
#pragma unroll
          for (int r4 = 0; r4 < 4; ++r4) {
            const float4 v = v4[r4];
            acc[4 * r4] = __fmaf_rn(w[r4], v.x, acc[4 * r4]);
            acc[4 * r4 + 1] = __fmaf_rn(w[r4], v.y, acc[4 * r4 + 1]);
            acc[4 * r4 + 2] = __fmaf_rn(w[r4], v.z, acc[4 * r4 + 2]);
            acc[4 * r4 + 3] = __fmaf_rn(w[r4], v.w, acc[4 * r4 + 3]);
          }
        }
        if constexpr (FORM == FORM_RAW) {
#pragma unroll
          for (int c = 0; c < 16; ++c) res[c] = acc[c];
        } else if constexpr (FORM == FORM_CURRENT) {
#pragma unroll
          for (int c = 0; c < 4; ++c) res[c] = ((acc[c] + acc[4 + c]) + acc[8 + c]) + acc[12 + c];
        } else {
          const float e0f = static_cast<float>(e0), e1f = static_cast<float>(e1),
                      e2f = static_cast<float>(e2);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            res[c] = ((acc[c] + e0f * acc[4 + c]) + e1f * acc[8 + c]) + e2f * acc[12 + c];
        }
      } else {  // a padded tile's lanes past E^3
#pragma unroll
        for (int c = 0; c < CH; ++c) res[c] = 0.0f;
      }
#pragma unroll
      for (int c = 0; c < CH; ++c) out[e * a.oview.sa + c * a.oview.sb] = res[c];
    }
    __syncthreads();  // the next tile restages shared memory
  }
}

// ---------------------------------------------------------------------------
// M8: X = W0^T Bcat over all cap slots, then the 18-row particle tail
// ---------------------------------------------------------------------------

constexpr int COLLECT_THREADS = 128;

struct CollectArgs {
  const float* src;
  Strided view;
  const float* v;  // entry (e, i) of tile t
  Strided vview;
  const float* m;  // entry (e, 0)
  Strided mview;
  float* out;      // entry (row, slot)
  Strided oview;
  int A, written, tpc;
  Geom g;
};

template <int E>
constexpr size_t collect_smem() {
  return sizeof(float) * (static_cast<size_t>(E * E * E) * 16 + COLLECT_THREADS * (E + 1));
}

// CTA q takes tiles q*tpc ... q*tpc + tpc - 1, thread t slot p = p0 + t of
// each chunk of 128.  Shared memory: Bcat[e][16] = [v, e0 v, e1 v, e2 v,
// m, 0, 0, 0] (read by every thread at once) and each thread's axis-0
// profile; its axis-1 and axis-2 profiles stay in registers (the e1, e2
// walks unrolled whole, the e0 walk not).
template <int E>
__global__ void __launch_bounds__(COLLECT_THREADS) window_collect(CollectArgs a) {
  constexpr int E3 = E * E * E, PS = E + 1, XC = 4 * D + 1;
  extern __shared__ __align__(16) float sm[];
  float* B = sm;
  float* p0s = sm + E3 * 16 + threadIdx.x * PS;
  const int cap = a.g.cap, t = threadIdx.x, T = a.g.T, shift = E - T - 2;
  for (int j = 0; j < a.tpc; ++j) {
    const int i = blockIdx.x * a.tpc + j;
    if (i >= a.A) return;
    float* out = a.out + a.oview.base(i);
    const long long osa = a.oview.sa, osb = a.oview.sb;
    if (i >= a.written) {
      for (int k = t; k < FO * cap; k += COLLECT_THREADS) out[(k / cap) * osa + (k % cap) * osb] = 0.0f;
      continue;
    }
    const float* vb = a.v + a.vview.base(i);
    const float* mb = a.m + a.mview.base(i);
    for (int e = t; e < E3; e += COLLECT_THREADS) {
      const float ef[D] = {static_cast<float>(e / (E * E)), static_cast<float>((e / E) % E),
                           static_cast<float>(e % E)};
      float* b = B + e * 16;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float v = vb[e * a.vview.sa + k * a.vview.sb];
        b[k] = v;
#pragma unroll
        for (int d = 0; d < D; ++d) b[D * (d + 1) + k] = ef[d] * v;
      }
      b[4 * D] = mb[e * a.mview.sa];
      b[13] = b[14] = b[15] = 0.0f;
    }
    int coord[D];
    tile_coords(i, a.g, coord);
    const float* s = a.src + a.view.base(i);
    const long long sa = a.view.sa, sb = a.view.sb;
    for (int c0 = 0; c0 < cap; c0 += COLLECT_THREADS) {
      const int p = c0 + t;
      const bool live = p < cap;
      float pos[D], dv[D], pr1[E], pr2[E];
      int f[D];
      if (live) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float w[3];
          pos[d] = s[d * sa + p * sb];
          f[d] = taps(pos[d], coord[d], T, -shift, T - 1 + shift, shift, dv[d], w);
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float x = tap_at(e, f[d], w);
            if (d == 0) p0s[e] = x;
            if (d == 1) pr1[e] = x;
            if (d == 2) pr2[e] = x;
          }
        }
      }
      __syncthreads();  // Bcat and the axis-0 profiles staged
      if (live) {
        float acc[XC];
#pragma unroll
        for (int c = 0; c < XC; ++c) acc[c] = 0.0f;
#pragma unroll 1
        for (int e0 = 0; e0 < E; ++e0) {
          const float x0 = p0s[e0];
#pragma unroll
          for (int e1 = 0; e1 < E; ++e1) {
            const float w01 = x0 * pr1[e1];
            const float* row = B + (e0 * E + e1) * E * 16;
#pragma unroll
            for (int e2 = 0; e2 < E; ++e2) {
              const float w = w01 * pr2[e2];
              const float4* b4 = reinterpret_cast<const float4*>(row + e2 * 16);
              const float4 b0 = b4[0], b1 = b4[1], b2 = b4[2];
              const float b[XC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w,
                                   b2.x, b2.y, b2.z, b2.w, row[e2 * 16 + 12]};
#pragma unroll
              for (int c = 0; c < XC; ++c) acc[c] = __fmaf_rn(w, b[c], acc[c]);
            }
          }
        }
        float rows[FO];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          rows[d] = pos[d] + acc[d] * 0.066f;
          rows[D + d] = acc[d];
        }
#pragma unroll
        for (int dd = 0; dd < D; ++dd) {
          const float lcf = static_cast<float>(f[dd]) + 1.0f;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const float Md = acc[D * (dd + 1) + k] - lcf * acc[k];
            rows[2 * D + D * dd + k] = 4.0f * (acc[k] * (-dv[dd]) + Md);
          }
        }
        const float rho = acc[4 * D], r2 = rho * rho, x = 10.0f * (r2 * r2 - 1.0f);
        rows[FO - 3] = rho;
        rows[FO - 2] = x < -0.1f ? -0.1f : x;
        rows[FO - 1] = s[FIELD_MASS * sa + p * sb];
#pragma unroll
        for (int r = 0; r < FO; ++r) out[r * osa + p * osb] = rows[r];
      }
      __syncthreads();  // the profiles (and, at the last chunk, Bcat) are restaged
    }
  }
}

template <int E, int N>
int launch_contract(const ContractArgs& a, int A, cudaStream_t st) {
  const size_t smem = contract_smem<E, N>(a.g.cap);
  if (const int err = set_smem(window_contract<E, N>, smem)) return err;
  window_contract<E, N><<<A, TILE_THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int E, int FORM>
int launch_deposit(const DepositArgs& a, cudaStream_t st) {
  const size_t smem = deposit_smem<E, FORM>(a.g.cap);
  if (const int err = set_smem(p2g1_deposit<E, FORM>, smem)) return err;
  p2g1_deposit<E, FORM><<<(a.A + a.tpc - 1) / a.tpc, TILE_THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int E>
int launch_collect(const CollectArgs& a, cudaStream_t st) {
  constexpr size_t smem = collect_smem<E>();
  if (const int err = set_smem(window_collect<E>, smem)) return err;
  window_collect<E><<<(a.A + a.tpc - 1) / a.tpc, COLLECT_THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// nodma 1: fill with the tile index, read nothing.  view: long long[9]
// (Strided without starts); offs: long long[16], each fill value's offset
// in floats from its program's block start (inside the first segment).
int fluid_micro_stage_fill(int nodma, const float* src, const int* starts, const long long* view,
                           const long long* offs, long long tb, long long nval, long long nprog,
                           long long nseg, long long seg_len, long long seg_stride,
                           long long out_len, long long out_total, float* out, void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (nval <= 0 || nval > MAX_VALUES || out_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  FillArgs a{src, strided(view, starts), {}, tb, nval, nprog, nseg, seg_len, seg_stride,
             out_len, out_total, out, nodma};
  for (int j = 0; j < MAX_VALUES; ++j) a.offs[j] = offs[j];
  const long long grid = nprog + (out_total > nprog * nval * out_len ? 1 : 0);
  if (grid <= 0) return 0;
  const size_t smem = nodma ? 0 : static_cast<size_t>(FILL_STAGES) * FILL_STAGE_BYTES;
  if (const int err = set_smem(stage_fill, smem)) return err;
  stage_fill<<<static_cast<unsigned>(grid), FILL_THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The dispatch chains below instantiate only the shapes the script's cases
// use; any other returns cudaErrorInvalidValue, which the wrapper raises.
// n 0: V = ones (8 equal columns); tshape: host int[3].
int fluid_micro_window_contract(int E, int n, const float* src, const int* starts,
                                const long long* view, int A, int cap, int T, const int* tshape,
                                float* out, void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (A <= 0) return 0;
  const ContractArgs a{src, strided(view, starts), geom(T, tshape, cap), out};
  if (E == 6 && n == 0) return launch_contract<6, 0>(a, A, st);
  if (E == 8 && n == 0) return launch_contract<8, 0>(a, A, st);
  if (E == 6 && n == 16) return launch_contract<6, 16>(a, A, st);
  if (E == 6 && n == 128) return launch_contract<6, 128>(a, A, st);
  if (E == 8 && n == 16) return launch_contract<8, 16>(a, A, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// form 0 current, 1 onewindow (4 channels), 2 raw (16); tid may be null;
// ep >= E^3 window rows a tile of output (rows past E^3 zero).
int fluid_micro_p2g1(int E, int form, const float* src, const int* starts, const long long* view,
                     const int* count, const int* tid, float* out, const long long* oview, int ep,
                     int A, int written, int tpc, int cap, int T, const int* tshape,
                     void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (A <= 0) return 0;
  if (tpc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const DepositArgs a{src, strided(view, starts), count, tid, out, strided(oview, nullptr),
                      ep, A, written, tpc, geom(T, tshape, cap)};
  if (E == 6 && form == FORM_CURRENT) return launch_deposit<6, FORM_CURRENT>(a, st);
  if (E == 6 && form == FORM_ONEWINDOW) return launch_deposit<6, FORM_ONEWINDOW>(a, st);
  if (E == 8 && form == FORM_ONEWINDOW) return launch_deposit<8, FORM_ONEWINDOW>(a, st);
  if (E == 6 && form == FORM_RAW) return launch_deposit<6, FORM_RAW>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

int fluid_micro_collect(int E, const float* src, const int* starts, const long long* view,
                        const float* v, const long long* vview, const float* m,
                        const long long* mview, float* out, const long long* oview, int A,
                        int written, int tpc, int cap, int T, const int* tshape,
                        void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (A <= 0) return 0;
  if (tpc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const CollectArgs a{src, strided(view, starts), v, strided(vview, nullptr), m,
                      strided(mview, nullptr), out, strided(oview, nullptr), A, written, tpc,
                      geom(T, tshape, cap)};
  if (E == 6) return launch_collect<6>(a, st);
  if (E == 8) return launch_collect<8>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
