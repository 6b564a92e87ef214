// Hand-written Hopper (sm_90a) kernels of the micro-benchmark entry points
// (fluid_tpu_torch/micro/).
//
// Counterparts of the Pallas kernels of bench/micro_*.py:
//
//   M1 prefix_copy<PB>          micro_sep.make_copy (:64), micro_pb.make_copy (:17),
//                               micro_dma.make_pipelined (:85)
//   M2 bulk_copy                micro_dma.make_manual (:33)
//   M3 window_deposit<FORM>     micro_zfac dep_cur / dep_z (:143 / :157) over _mk (:73),
//                               micro_sep.make_dep (:88), modes onewindow / sep3 / sepsel
//   M4 window_gather<CH, FORM>  micro_zfac rho_cur / rho_z (:176 / :195) and
//                               g2p_cur / g2p_z (:225 / :238)
//
// Shapes are the scripts' own: groups of G = 8 tiles of CAP = 128 particles
// (GL = 1024 columns), per-axis window profiles wx, wy, wz [ng, 8, GL], the
// tensor-product window W0[e0*64 + e1*8 + e2, p] = wx[e0,p] * (wy[e1,p] *
// wz[e2,p]) (axis 0 slowest, E^3 = 512), R = 12 deposit rows.  A row input
// is row-major inside a group (row stride GL, column stride 1) with any
// group stride, so the deposits read the stream's row slices in place.
//
// Bounds on this card (the wrappers' callers compute them from the shapes):
//   M1, M2   bytes: each copied float read once and written once.
//   M3       operations: 2 R E^3 CAP multiply-adds a tile (0.77 ms at 32,768
//            tiles over 67 TFLOP/s), against 0.42 ms of bytes.
//   M4 rho   bytes (wx, wy, wz, m in, 8 rows out); its operations are 2 E^3
//            CAP a tile.
//   M4 g2p   operations: 2 * 16 * E^3 * CAP a tile.
//
// What the TPU blocking becomes: the Pallas kernels walk PB groups a grid
// step through VMEM and contract on the MXU.  Here a CTA takes one tile
// (M3, M4) or PB groups (M1), and the contractions are FP32 FMAs (no
// tensor cores, no TF32), each output summed over its particles (M3) or
// window cells (M4) in order from 0.0f.  The sums use explicit __fmaf_rn;
// every other product and sum is rounded on its own (-fmad=false), in the
// order of the JAX kernels' elementwise arithmetic.
//
// The forms of one function, as the JAX script has them:
//   WIDE  (dep_cur, onewindow, rho_cur, g2p_cur) builds W0 in shared memory,
//         walking e in 4 slices of 128 rows ([512, 128] f32 is 256 KB and
//         does not fit), and contracts against each slice;
//   ZFAC  (dep_z, rho_z, g2p_z) keeps the pair window W12 = wy (x) wz [64,
//         128] (shared memory in M3, a thread's own column in registers in
//         M4) and factors wx out: M3 forms Uz[(r, e0), p] = U[r,p] * wx[e0,p]
//         in registers and writes e = e0*64 + yz directly; M4 contracts
//         against W12 first, then against wx;
//   SEP   (micro_sep sep3 / sepsel, one function) is ZFAC with the e0-partner
//         rows: Ux = wx * base + (e0 wx) * part, then the (e1, e2) moment
//         fix-up into the [16, 128] block.
// The TPU-only constructs (_w12p's zero padding to 128 rows, _wx_s's (kbit,
// q) row order, _merge_eo's roll, micro_sep's iota-select repeat) answer
// the v5e's 128-lane tiling and have no counterpart here.
//
// Each C entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() (or the error of setting
// a launch's shared memory size).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 8, CAP = 128, GL = G * CAP, E = 8, E2 = E * E, E3 = E2 * E, R = 12;
constexpr int S1 = E3 / CAP;  // 4 slices of 128 window rows
constexpr int W0_STRIDE = CAP + 1;   // a W0 slice row [128 + 1]: row t, column k -> bank (t + k) % 32
constexpr int W12_STRIDE = E2 + 4;   // a W12 row [64 + 4]: float4-aligned, rows 4 banks apart

constexpr int FORM_WIDE = 0, FORM_ZFAC = 1, FORM_ONEWINDOW = 2, FORM_SEP = 3;

// ---------------------------------------------------------------------------
// M1: the first n floats of each group, PB groups a CTA, 16-byte accesses
// ---------------------------------------------------------------------------

constexpr int COPY_THREADS = 256;

template <int PB>
__global__ void __launch_bounds__(COPY_THREADS)
    prefix_copy(const float4* __restrict__ src, long long src_gs4, float4* __restrict__ dst,
                int n4, int ng) {
  for (int b = 0; b < PB; ++b) {
    const int g = blockIdx.x * PB + b;
    if (g >= ng) return;
    const float4* s = src + static_cast<size_t>(g) * src_gs4;
    float4* d = dst + static_cast<size_t>(g) * n4;
    int i = threadIdx.x;
    for (; i + 3 * COPY_THREADS < n4; i += 4 * COPY_THREADS) {
      const float4 a0 = s[i], a1 = s[i + COPY_THREADS], a2 = s[i + 2 * COPY_THREADS],
                   a3 = s[i + 3 * COPY_THREADS];
      d[i] = a0;
      d[i + COPY_THREADS] = a1;
      d[i + 2 * COPY_THREADS] = a2;
      d[i + 3 * COPY_THREADS] = a3;
    }
    for (; i < n4; i += COPY_THREADS) d[i] = s[i];
  }
}

// ---------------------------------------------------------------------------
// M2: the copy through shared memory by the bulk-copy engine
// ---------------------------------------------------------------------------

// A CTA owns `chunk` consecutive groups and streams their bytes through a
// ring of BULK_STAGES buffers: cp.async.bulk global -> shared completing on
// the stage's mbarrier, then cp.async.bulk shared -> global in a bulk group.
// One thread starts every copy; the copy engine moves the bytes.  The JAX
// kernel's stage is `chunk` whole groups (786 KB at chunk 8), more than a
// CTA's 227 KB of shared memory, so the stage here is the kernel's own.
constexpr int BULK_STAGES = 4;
constexpr int BULK_STAGE_BYTES = 24 * 1024;

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

__global__ void __launch_bounds__(32)
    bulk_copy(const char* __restrict__ src, char* __restrict__ dst, long long cta_bytes,
              long long total_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[BULK_STAGES];
  if (threadIdx.x != 0) return;
  const long long base = static_cast<long long>(blockIdx.x) * cta_bytes;
  const long long bytes = min(cta_bytes, total_bytes - base);
  if (bytes <= 0) return;
  const int nst = static_cast<int>((bytes + BULK_STAGE_BYTES - 1) / BULK_STAGE_BYTES);
  for (int s = 0; s < BULK_STAGES; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto stage_bytes = [&](int i) {
    return static_cast<uint32_t>(min(static_cast<long long>(BULK_STAGE_BYTES),
                                     bytes - static_cast<long long>(i) * BULK_STAGE_BYTES));
  };
  auto load = [&](int i) {
    const int s = i % BULK_STAGES;
    const uint32_t nb = stage_bytes(i), bar = smem_u32(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(nb)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(ring + s * BULK_STAGE_BYTES)),
        "l"(src + base + static_cast<long long>(i) * BULK_STAGE_BYTES), "r"(nb), "r"(bar)
        : "memory");
  };

  for (int i = 0; i < min(BULK_STAGES, nst); ++i) load(i);
  for (int i = 0; i < nst; ++i) {
    const int s = i % BULK_STAGES;
    mbar_wait(smem_u32(&full[s]), (i / BULK_STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(dst + base + static_cast<long long>(i) * BULK_STAGE_BYTES),
                 "r"(smem_u32(ring + s * BULK_STAGE_BYTES)), "r"(stage_bytes(i))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the buffer of stage i - 1 once its store has read it, leaving
    // stage i's store in flight
    if (i >= 1 && i - 1 + BULK_STAGES < nst) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(i - 1 + BULK_STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// M3: per-tile deposit contraction Y[r, e] = sum_p U[r, p] W0[e, p]
// ---------------------------------------------------------------------------

struct Rows {  // a [ng, rows, GL] row input: group g, row r at base + g*gs + r*GL
  const float* base;
  long long gs;
  __device__ __forceinline__ float at(int g, int r, int col) const {
    return base[static_cast<size_t>(g) * gs + static_cast<size_t>(r) * GL + col];
  }
};

struct DepArgs {
  Rows U, wx, wy, wz, part;
  float part_scale;
  float* out;
};

constexpr int TILE_THREADS = CAP;  // M3 and M4: one CTA a tile, thread t <-> particle t

template <int FORM>
constexpr size_t deposit_smem() {
  return sizeof(float) * (CAP * R * (FORM == FORM_SEP ? 2 : 1) +
                          ((FORM == FORM_WIDE || FORM == FORM_ONEWINDOW)
                               ? CAP * W0_STRIDE
                               : CAP * E + CAP * W12_STRIDE));
}

// One CTA per tile j of group g.  Shared memory: Us[p][r] (and Ps[p][r],
// the partner rows times part_scale), then W0s [128][129] (WIDE) or wxs[p]
// [e0] and W12s [128][68] (ZFAC, SEP).  Outputs: the raw [R, 512] of each
// tile (WIDE, ZFAC: rows r*4 + e/128 of the [R*4, 128] block) or the [4,
// 512] moment fix-up (ONEWINDOW: Y[c] + e0 Y[4+c] + e1 Y[8+c]; SEP: Y'[c]
// + e1 Y'[4+c] + e2 Y'[8+c] with the partner rows in Y').
template <int FORM>
__global__ void __launch_bounds__(TILE_THREADS) window_deposit(DepArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool WIDE = FORM == FORM_WIDE || FORM == FORM_ONEWINDOW;
  constexpr bool FIXUP = FORM == FORM_ONEWINDOW || FORM == FORM_SEP;
  constexpr int OUT_ROWS = FIXUP ? 4 : R;
  const int g = blockIdx.x / G, j = blockIdx.x % G, t = threadIdx.x;
  const int col = j * CAP + t;
  float* Us = sm;
  float* Ps = sm + CAP * R;  // SEP only
  float* after = sm + CAP * R * (FORM == FORM_SEP ? 2 : 1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    Us[t * R + r] = a.U.at(g, r, col);
    if constexpr (FORM == FORM_SEP) Ps[t * R + r] = a.part_scale * a.part.at(g, r, col);
  }
  float wyr[E], wzr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    wyr[e] = a.wy.at(g, e, col);
    wzr[e] = a.wz.at(g, e, col);
  }
  float* out = a.out + static_cast<size_t>(g * G + j) * OUT_ROWS * E3;

  if constexpr (WIDE) {
    float wxr[E];
#pragma unroll
    for (int e = 0; e < E; ++e) wxr[e] = a.wx.at(g, e, col);
    float* W0s = after;
#pragma unroll
    for (int s = 0; s < S1; ++s) {
      // slice s: window rows e = s*128 + k, e0 = 2s + k/64; thread t builds row p = t
#pragma unroll
      for (int yz = 0; yz < E2; ++yz) {
        const float w12 = wyr[yz / E] * wzr[yz % E];
        W0s[t * W0_STRIDE + yz] = wxr[2 * s] * w12;
        W0s[t * W0_STRIDE + E2 + yz] = wxr[2 * s + 1] * w12;
      }
      __syncthreads();
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 4
      for (int p = 0; p < CAP; ++p) {
        const float w = W0s[p * W0_STRIDE + t];
        const float4* u4 = reinterpret_cast<const float4*>(Us + p * R);
        const float4 u0 = u4[0], u1 = u4[1], u2 = u4[2];
        const float u[R] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w, u2.x, u2.y, u2.z, u2.w};
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = __fmaf_rn(u[r], w, acc[r]);
      }
      const int e = s * CAP + t;
      if constexpr (FIXUP) {
        const float e0f = static_cast<float>(e / E2), e1f = static_cast<float>((e / E) % E);
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c * E3 + e] = (acc[c] + e0f * acc[4 + c]) + e1f * acc[8 + c];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) out[r * E3 + e] = acc[r];
      }
      __syncthreads();  // the slice is rebuilt next
    }
  } else {
    float* wxs = after;              // [p][e0]
    float* W12s = after + CAP * E;   // [p][68]
#pragma unroll
    for (int e = 0; e < E; ++e) wxs[t * E + e] = a.wx.at(g, e, col);
#pragma unroll
    for (int yz = 0; yz < E2; ++yz) W12s[t * W12_STRIDE + yz] = wyr[yz / E] * wzr[yz % E];
    __syncthreads();
    // thread t: window rows e = e0*64 + 4q + k (k < 4) for every r
    const int e0 = t / (E2 / 4), q = t % (E2 / 4);
    const float e0f = static_cast<float>(e0);
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
#pragma unroll 2
    for (int p = 0; p < CAP; ++p) {
      const float x = wxs[p * E + e0];
      const float4 w = reinterpret_cast<const float4*>(W12s + p * W12_STRIDE)[q];
      const float wk[4] = {w.x, w.y, w.z, w.w};
      const float4* u4 = reinterpret_cast<const float4*>(Us + p * R);
      const float4 u0 = u4[0], u1 = u4[1], u2 = u4[2];
      const float u[R] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w, u2.x, u2.y, u2.z, u2.w};
      float uz[R];
      if constexpr (FORM == FORM_SEP) {
        const float xe = e0f * x;
        const float4* p4 = reinterpret_cast<const float4*>(Ps + p * R);
        const float4 v0 = p4[0], v1 = p4[1], v2 = p4[2];
        const float v[R] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w, v2.x, v2.y, v2.z, v2.w};
#pragma unroll
        for (int r = 0; r < R; ++r) uz[r] = x * u[r] + xe * v[r];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) uz[r] = u[r] * x;
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = __fmaf_rn(uz[r], wk[k], acc[r][k]);
    }
    const int e = e0 * E2 + 4 * q;
    if constexpr (FIXUP) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int yz = 4 * q + k;
          const float e1f = static_cast<float>(yz / E), e2f = static_cast<float>(yz % E);
          v[k] = (acc[c][k] + e1f * acc[4 + c][k]) + e2f * acc[8 + c][k];
        }
        reinterpret_cast<float4*>(out + c * E3 + e)[0] = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
        reinterpret_cast<float4*>(out + r * E3 + e)[0] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// M4: per-particle gather X[c, p] = sum_e B[c, e] W0[e, p]
// ---------------------------------------------------------------------------

struct GatherArgs {
  const float* x;  // rho: m [ng, G*4, 128] (tile j's 512 window values at j*512);
                   // g2p: B [ng, 16, 512], one window per channel for the group
  long long x_gs;
  Rows wx, wy, wz;
  float* out;      // rho [ng, 8, GL] (8 equal rows); g2p [ng, 16, GL]
};

// xs row stride of a window cell's CH values: g2p's 16 channels padded to
// 20 floats, so staging e = t + 128k, channel c writes bank (20t + c) % 32
// (4-way, not 16-way) and a row stays four float4 reads
template <int CH>
__host__ __device__ constexpr int xs_stride() { return CH == 1 ? 1 : CH + 4; }

template <int CH, bool WIDE>
constexpr size_t gather_smem() {
  return sizeof(float) * (xs_stride<CH>() * E3 + (WIDE ? CAP * W0_STRIDE : 0));
}

// The CH values of window cell e, broadcast to every thread.
template <int CH>
__device__ __forceinline__ void window_values(const float* xs, int e, float (&v)[CH]) {
  if constexpr (CH % 4 == 0) {
    const float4* v4 = reinterpret_cast<const float4*>(xs + e * xs_stride<CH>());
#pragma unroll
    for (int c4 = 0; c4 < CH / 4; ++c4) {
      const float4 q = v4[c4];
      v[4 * c4] = q.x;
      v[4 * c4 + 1] = q.y;
      v[4 * c4 + 2] = q.z;
      v[4 * c4 + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < CH; ++c) v[c] = xs[e * xs_stride<CH>() + c];
  }
}

// One CTA per tile j of group g, thread t <-> particle p = j*128 + t.
// Shared memory: xs[e][c] (the tile's or the group's window values, each
// e's channels contiguous) and, WIDE, the thread's own W0 row of each slice.
template <int CH, bool WIDE>
__global__ void __launch_bounds__(TILE_THREADS) window_gather(GatherArgs a) {
  extern __shared__ __align__(16) float sm[];
  constexpr int XS = xs_stride<CH>();
  const int g = blockIdx.x / G, j = blockIdx.x % G, t = threadIdx.x;
  const int col = j * CAP + t;
  float* xs = sm;
  const float* x = a.x + static_cast<size_t>(g) * a.x_gs + (CH == 1 ? j * E3 : 0);
#pragma unroll
  for (int c = 0; c < CH; ++c)
    for (int e = t; e < E3; e += TILE_THREADS) xs[e * XS + c] = x[c * E3 + e];
  float wyr[E], wzr[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    wyr[e] = a.wy.at(g, e, col);
    wzr[e] = a.wz.at(g, e, col);
  }
  __syncthreads();

  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
  if constexpr (WIDE) {
    float wxr[E];
#pragma unroll
    for (int e = 0; e < E; ++e) wxr[e] = a.wx.at(g, e, col);
    float* W0r = sm + XS * E3 + t * W0_STRIDE;  // this thread's row of each slice
#pragma unroll
    for (int s = 0; s < S1; ++s) {
#pragma unroll
      for (int yz = 0; yz < E2; ++yz) {
        const float w12 = wyr[yz / E] * wzr[yz % E];
        W0r[yz] = wxr[2 * s] * w12;
        W0r[E2 + yz] = wxr[2 * s + 1] * w12;
      }
#pragma unroll 4
      for (int k = 0; k < CAP; ++k) {
        const float w = W0r[k];
        float v[CH];
        window_values<CH>(xs, s * CAP + k, v);
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c] = __fmaf_rn(v[c], w, acc[c]);
      }
    }
  } else {
    // w12 stays in registers only while every index into it is a constant:
    // the yz walk is unrolled whole, the e0 walk not at all (wx[e0] is read
    // from global memory each step, not from a register array)
    float w12[E2];
#pragma unroll
    for (int yz = 0; yz < E2; ++yz) w12[yz] = wyr[yz / E] * wzr[yz % E];
#pragma unroll 1
    for (int e0 = 0; e0 < E; ++e0) {
      float part[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) part[c] = 0.0f;
#pragma unroll
      for (int yz = 0; yz < E2; ++yz) {
        float v[CH];
        window_values<CH>(xs, e0 * E2 + yz, v);
#pragma unroll
        for (int c = 0; c < CH; ++c) part[c] = __fmaf_rn(v[c], w12[yz], part[c]);
      }
      const float x = a.wx.at(g, e0, col);
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = __fmaf_rn(part[c], x, acc[c]);
    }
  }
  // rho's 8 rows all hold the one value; g2p's 16 rows are its channels
  constexpr int ROWS = CH == 1 ? 8 : CH;
  float* out = a.out + static_cast<size_t>(g) * ROWS * GL + col;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[static_cast<size_t>(r) * GL] = acc[CH == 1 ? 0 : r];
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <int FORM>
int launch_deposit(const DepArgs& a, int ng, cudaStream_t st) {
  constexpr size_t smem = deposit_smem<FORM>();
  if (const int err = set_smem(window_deposit<FORM>, smem)) return err;
  window_deposit<FORM><<<ng * G, TILE_THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int CH, bool WIDE>
int launch_gather(const GatherArgs& a, int ng, cudaStream_t st) {
  constexpr size_t smem = gather_smem<CH, WIDE>();
  if (const int err = set_smem(window_gather<CH, WIDE>, smem)) return err;
  window_gather<CH, WIDE><<<ng * G, TILE_THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dst[g, :n] = src[g*src_gs : g*src_gs + n] for g < ng; n and src_gs in
// floats, multiples of 4, both pointers 16-byte aligned.
int fluid_micro_prefix_copy(int pb, const float* src, long long src_gs, float* dst, int n, int ng,
                            void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (ng <= 0 || n <= 0) return 0;
  const int grid = (ng + pb - 1) / pb;
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
#define FLUID_COPY(PB)                                                        \
  if (pb == PB) {                                                             \
    prefix_copy<PB><<<grid, COPY_THREADS, 0, st>>>(s, src_gs / 4, d, n / 4, ng); \
    return static_cast<int>(cudaGetLastError());                              \
  }
  FLUID_COPY(2)
  FLUID_COPY(4)
  FLUID_COPY(8)
  FLUID_COPY(16)
#undef FLUID_COPY
  return static_cast<int>(cudaErrorInvalidValue);
}

// dst = src, ng groups of group_bytes each (a multiple of 16, both pointers
// 16-byte aligned), `chunk` consecutive groups a CTA.
int fluid_micro_bulk_copy(const float* src, float* dst, long long group_bytes, int ng, int chunk,
                          void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (ng <= 0 || chunk <= 0 || group_bytes % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = static_cast<size_t>(BULK_STAGES) * BULK_STAGE_BYTES;
  if (const int err = set_smem(bulk_copy, smem)) return err;
  const int grid = (ng + chunk - 1) / chunk;
  bulk_copy<<<grid, 32, smem, st>>>(reinterpret_cast<const char*>(src), reinterpret_cast<char*>(dst),
                                    group_bytes * chunk, group_bytes * ng);
  return static_cast<int>(cudaGetLastError());
}

// form 0 wide, 1 zfac (out [ng, G*R*4, 128]); 2 onewindow, 3 sep (out [ng,
// G*16, 128]); part (sep only) may be null otherwise.  *_gs: group strides
// in floats.
int fluid_micro_deposit(int form, const float* U, long long u_gs, const float* wx, long long wx_gs,
                        const float* wy, long long wy_gs, const float* wz, long long wz_gs,
                        const float* part, long long part_gs, float part_scale, float* out,
                        int ng, void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (ng <= 0) return 0;
  const DepArgs a{{U, u_gs}, {wx, wx_gs}, {wy, wy_gs}, {wz, wz_gs}, {part, part_gs},
                  part_scale, out};
  switch (form) {
    case FORM_WIDE: return launch_deposit<FORM_WIDE>(a, ng, st);
    case FORM_ZFAC: return launch_deposit<FORM_ZFAC>(a, ng, st);
    case FORM_ONEWINDOW: return launch_deposit<FORM_ONEWINDOW>(a, ng, st);
    case FORM_SEP: return launch_deposit<FORM_SEP>(a, ng, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ch 1: rho (x = m [ng, G*4, 128]); ch 16: g2p (x = B [ng, 16, 512]);
// form 0 wide, 1 zfac.
int fluid_micro_gather(int ch, int form, const float* x, long long x_gs, const float* wx,
                       long long wx_gs, const float* wy, long long wy_gs, const float* wz,
                       long long wz_gs, float* out, int ng, void* cuda_stream) {
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (ng <= 0) return 0;
  const GatherArgs a{x, x_gs, {wx, wx_gs}, {wy, wy_gs}, {wz, wz_gs}, out};
  if (ch == 1 && form == FORM_WIDE) return launch_gather<1, true>(a, ng, st);
  if (ch == 1 && form == FORM_ZFAC) return launch_gather<1, false>(a, ng, st);
  if (ch == 16 && form == FORM_WIDE) return launch_gather<16, true>(a, ng, st);
  if (ch == 16 && form == FORM_ZFAC) return launch_gather<16, false>(a, ng, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
