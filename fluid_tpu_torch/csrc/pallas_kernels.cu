// Hand-written Hopper (sm_90a) kernels of the "pallas" backend's substep.
//
// Counterparts of the Pallas kernels in fluid_tpu/ops/pallas_transfer.py:
//
//   deposit_kernel<D, MODE_P2G1>   _deposit_kernel, deposit(mode="p2g1")  (:160, call :259)
//   deposit_kernel<D, MODE_FORCE>  _deposit_kernel, deposit(mode="p2g2")  (:160, call :259)
//   deposit_kernel<D, MODE_P2G2>   _p2g2_kernel, p2g2                     (:428, call :543)
//   collect_kernel<D>              _collect_kernel, collect               (:272, call :415)
//
// Layouts (A active tiles, cap slots per tile, window E = T + 2 = 6):
//   stream  [FP, n]   field-major and tile-sorted, so tile a's particles are
//                     the columns [act_start[a], act_start[a] + count) and
//                     thread s reading column start + s of a field is a
//                     coalesced load.  p2g1 layout: pos D, vel D, C D*D
//                     (row-major), mass; force layout: A2 D, term D*D
//                     (row D + j*D + i = term[i][j]), pos D.
//   blocks  [A, E^D, CH] flat cell order (e_0, ..., e_{D-1}), e_{D-1}
//                     fastest, channels innermost (the JAX layout)
//   slots   [A, FO, cap] FO = 2D + D*D + 3 rows: pos, vel, C, rho, p, mass
//   act_start, act_count, tid [A] int32
//
// The TPU kernels DMA a fixed cap-row slice of a zero-padded, lane-padded
// stream, build a one-hot window matrix W[E^D, cap] and contract it on the
// MXU.  Here a tile reads only its min(count, cap) particles (no padding,
// no double-buffered DMA), and the contraction is a gather: each thread
// owns window cells and walks the tile's particles in slot order, adding a
// particle's contribution to the cells its 3^D stencil covers.  Sums are
// deterministic (no float atomics; a replayed snapshot is bit-identical).
// A tile whose count is 0, an unused entry included (act_start = n), reads
// nothing and writes zeros, so no output is left uninitialized and the host
// never reads a count to size a grid.
//
// Stencil of a particle: local cell clip(floor(pos) - (origin + coord*T),
// 0, T-1) from the UNCLIPPED floor (pallas_transfer.py:190), dvec = pos -
// floor(pos) - 0.5, per-axis weights [0.5(0.5-dv)^2, 0.75-dv^2,
// 0.5(0.5+dv)^2] at window index local cell + o, o = 0..2.  The weights,
// the pressure and the particle tail come from mpm_common.cuh, shared with
// the stream backend's kernels.  The moment
// window of axis d is the plain one times (o_d - 1), which is exact in
// float (a sign or a zero), so it is formed from the plain tap weight.
//
// Build with -fmad=false and no fast math: every product and sum is rounded
// on its own, in the order of the plain PyTorch versions in
// ops/pallas_kernels.py that the on-card check compares against.
//
// Each C entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mpm_common.cuh"

namespace {

constexpr int MODE_P2G1 = 1;   // K6: mass + APIC momentum from the particle stream
constexpr int MODE_FORCE = 2;  // K6f: force from a precomputed force stream
constexpr int MODE_P2G2 = 3;   // K7: density, EOS, stress, force (fused)

constexpr int DEPOSIT_THREADS = 256;

struct PGeom {
  int A;          // active tiles (grid size)
  int n;          // stream columns (row stride)
  int T, E;       // tile edge, window edge (T + 2)
  int cap;        // slots per tile
  int ncell;      // E^D
  int tshape[3];  // tiles per axis
  int origin[3];  // domain origin, cells
};

// Local stencil of one particle: window base (local cell), dvec and the
// three per-axis weights.  floorf before the int conversion: positions and
// local cells can be negative.
template <int D>
__device__ __forceinline__ void stencil(const PGeom& g, int tid, const float* pos,
                                        int* base, float* dvec, float (*w)[D]) {
  for (int d = 0; d < D; ++d) {
    const float cf = floorf(pos[d]);
    const int lc = mpm::local_cell(cf, d, D, tid, g.T, g.tshape, g.origin);
    const float dv = (pos[d] - cf) - 0.5f;
    base[d] = lc < 0 ? 0 : (lc > g.T - 1 ? g.T - 1 : lc);
    dvec[d] = dv;
    mpm::bspline_weights(dv, w[0][d], w[1][d], w[2][d]);
  }
}

// Shared staging of a tile's particles, [field][slot] so that the staging
// threads write distinct banks and the cell loop reads one broadcast word:
//   base [D][cap] int, w [3][D][cap], g0 [CH][cap], gd [D][D][cap]
// A particle's contribution to a covered cell with tap offsets o is
//   ch c:            w * g0[c]
//   ch CH-D+i also:  + sum_d (o_d - 1) w * gd[d][i]
// p2g1: g0 = (m, m(v - C dvec)), gd[d][i] = m C[i][d]   (the APIC momentum)
// force / p2g2: g0 = A2 = term (-dvec), gd[d][i] = term[i][d]   (eq. 16)
template <int D, int CH>
struct Stage {
  int* base;
  float* w;
  float* g0;
  float* gd;
  __device__ Stage(float* smem, int cap) {
    base = reinterpret_cast<int*>(smem);
    w = smem + D * cap;
    g0 = w + 3 * D * cap;
    gd = g0 + CH * cap;
  }
  static constexpr int words_per_slot() { return D + 3 * D + CH + D * D; }
};

template <int D, int CH>
__device__ __forceinline__ void stage_stencil(const Stage<D, CH>& sh, int cap, int s,
                                              const int* base, float (*w)[D]) {
  for (int d = 0; d < D; ++d) {
    sh.base[d * cap + s] = base[d];
    for (int o = 0; o < 3; ++o) sh.w[(o * D + d) * cap + s] = w[o][d];
  }
}

// deposit_kernel — replaces _deposit_kernel (pallas_transfer.py:160) in its
// two modes and the fused _p2g2_kernel (:428).
//
// Bound on this card: at the 1M-particle shape (32,768 tiles, about 17,500
// occupied, ~57 particles each) the kernel reads 64 B per particle and, for
// p2g2, a 0.9 KB mass window per tile, and writes the [E^D, CH] block of
// every tile (3.5 KB for p2g1): ~0.2 GB, 0.06 ms at the card's bandwidth.
// The cell-owner scan costs E^D x count stencil tests per tile (216 x 57)
// out of shared memory, a few hundred million in all, and it is the limit:
// on an H100 (700 W) p2g1 and p2g2 take ~0.5 ms against that 0.05 ms.  The
// design keeps every intermediate (weights, bases, channel values) in
// shared memory and writes each output cell once.
//
// MODE_P2G2 first gathers each particle's density from its tile's halo'd,
// edge-masked mass block (3^D taps, flat cell order), then the Tait
// pressure with its floor, the volume m / rho, the eq-16 term
// -4 V dt (-p I + mu (C + C^T)) and A2 = term (-dvec).
// params: [dt, rest_density, eos_stiffness, eos_power, pressure_floor, mu].
template <int D, int MODE>
__global__ void __launch_bounds__(DEPOSIT_THREADS)
deposit_kernel(PGeom g, const int* __restrict__ act_start,
               const int* __restrict__ act_count, const int* __restrict__ tidv,
               const float* __restrict__ stream, const float* __restrict__ mblk,
               const float* __restrict__ params, float* __restrict__ out) {
  constexpr int CH = MODE == MODE_P2G1 ? 1 + D : D;
  extern __shared__ float smem[];
  const int a = blockIdx.x;
  const int cap = g.cap;
  const int cnt = min(act_count[a], cap);
  float* tile_out = out + static_cast<int64_t>(a) * g.ncell * CH;
  if (cnt <= 0) {
    for (int i = threadIdx.x; i < g.ncell * CH; i += blockDim.x) tile_out[i] = 0.0f;
    return;
  }
  const int tid = tidv[a];
  const int64_t start = act_start[a];
  const int64_t n = g.n;
  Stage<D, CH> sh(smem, cap);
  for (int s = threadIdx.x; s < cnt; s += blockDim.x) {
    const float* col = stream + start + s;  // field f at col[f * n]
    constexpr int pos_row = MODE == MODE_FORCE ? D + D * D : 0;
    float pos[D];
    for (int d = 0; d < D; ++d) pos[d] = col[(pos_row + d) * n];
    int base[D];
    float dvec[D];
    float w[3][D];
    stencil<D>(g, tid, pos, base, dvec, w);
    stage_stencil<D, CH>(sh, cap, s, base, w);
    if (MODE == MODE_P2G1) {
      const float m = col[(2 * D + D * D) * n];
      sh.g0[s] = m;
      for (int i = 0; i < D; ++i) {
        float cd = col[(2 * D + i * D) * n] * dvec[0];
        for (int j = 1; j < D; ++j) cd = cd + col[(2 * D + i * D + j) * n] * dvec[j];
        sh.g0[(1 + i) * cap + s] = m * (col[(D + i) * n] - cd);
        for (int d = 0; d < D; ++d) sh.gd[(d * D + i) * cap + s] = m * col[(2 * D + i * D + d) * n];
      }
    } else if (MODE == MODE_FORCE) {
      for (int i = 0; i < D; ++i) {
        sh.g0[i * cap + s] = col[i * n];
        for (int d = 0; d < D; ++d) sh.gd[(d * D + i) * cap + s] = col[(D + d * D + i) * n];
      }
    } else {
      // density from the mass block, taps in flat cell order
      const float* mw = mblk + static_cast<int64_t>(a) * g.ncell;
      float rho = 0.0f;
      int nk = 1;
      for (int d = 0; d < D; ++d) nk *= 3;
      for (int k = 0; k < nk; ++k) {
        int o[D];
        int r = k;
        for (int d = D - 1; d >= 0; --d) {
          o[d] = r % 3;
          r /= 3;
        }
        float wk = w[o[0]][0];
        for (int d = 1; d < D; ++d) wk = wk * w[o[d]][d];
        int e = 0;
        for (int d = 0; d < D; ++d) e = e * g.E + base[d] + o[d];
        rho = rho + wk * mw[e];
      }
      const float dt = params[0], rest = params[1], k_eos = params[2];
      const float gamma = params[3], floor_p = params[4], mu = params[5];
      const float m = col[(2 * D + D * D) * n];
      const float volume = rho > 0.0f ? m / rho : 0.0f;
      const float pressure = mpm::tait_pressure(rho, rest, k_eos, gamma, floor_p);
      const float scale = (-4.0f * volume) * dt;
      float term[D][D];
      for (int i = 0; i < D; ++i) {
        for (int j = 0; j < D; ++j) {
          const float visc = mu * (col[(2 * D + i * D + j) * n] + col[(2 * D + j * D + i) * n]);
          term[i][j] = scale * ((i == j ? -pressure : 0.0f) + visc);
        }
      }
      for (int i = 0; i < D; ++i) {
        float a2 = term[i][0] * (-dvec[0]);
        for (int j = 1; j < D; ++j) a2 = a2 + term[i][j] * (-dvec[j]);
        sh.g0[i * cap + s] = a2;
        for (int d = 0; d < D; ++d) sh.gd[(d * D + i) * cap + s] = term[i][d];
      }
    }
  }
  __syncthreads();

  const int E = g.E;
  for (int e = threadIdx.x; e < g.ncell; e += blockDim.x) {
    int ec[D];
    int rem = e;
    for (int d = D - 1; d >= 0; --d) {
      ec[d] = rem % E;
      rem /= E;
    }
    float acc[CH];
    for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
    for (int s = 0; s < cnt; ++s) {
      int o[D];
      bool in = true;
      for (int d = 0; d < D; ++d) {
        o[d] = ec[d] - sh.base[d * cap + s];
        in = in && (o[d] >= 0) && (o[d] <= 2);
      }
      if (!in) continue;
      float w = sh.w[(o[0] * D + 0) * cap + s];
      for (int d = 1; d < D; ++d) w = w * sh.w[(o[d] * D + d) * cap + s];
      for (int c = 0; c < CH; ++c) {
        float val = w * sh.g0[c * cap + s];
        if (c >= CH - D) {
          const int i = c - (CH - D);
          for (int d = 0; d < D; ++d) {
            const float wd = o[d] == 0 ? -w : (o[d] == 2 ? w : 0.0f);
            val = val + wd * sh.gd[(d * D + i) * cap + s];
          }
        }
        acc[c] = acc[c] + val;
      }
    }
    for (int c = 0; c < CH; ++c) tile_out[e * CH + c] = acc[c];
  }
}

// collect_kernel — replaces _collect_kernel (pallas_transfer.py:272).
//
// One thread per slot: g2p from the tile's grid velocity block vblk
// [E^D, D] and mass block mblk [E^D]: rho = sum w m, v = sum w gv,
// new C[i][j] = 4 (v_i (-dvec_j) + sum (o_j - 1) w gv_i); the Tait pressure;
// then the particle tail: advect, the mouse impulse after advection (quirk
// Q3), clamp and the un-scaled soft wall (quirk Q2).  Mass comes from the
// stream unmasked; slots past count write zero rows.
//
// Bound on this card: the slot-major output is the whole cost by bytes,
// A x FO x cap floats (0.91 GB at the 1M-particle shape: 32,768 tiles x
// 18 rows x 384 slots), most of it the zero rows past count that the
// layout asks for; the reads (stream 16 B and 27 taps of 16 B per
// particle, within one 3.5 KB block per tile, so L1/L2 hits) are small
// beside it.  Stores of one row are coalesced across the block's threads,
// and on an H100 (700 W) the kernel runs within 1.6x of that byte bound.
//
// params: [dt, rest, k, gamma, floor, mouse_radius, damp, mouse_active,
//          mouse_x, mouse_y, lo[D], hi[D]].
template <int D>
__global__ void collect_kernel(PGeom g, const int* __restrict__ act_start,
                               const int* __restrict__ act_count,
                               const int* __restrict__ tidv,
                               const float* __restrict__ params,
                               const float* __restrict__ stream,
                               const float* __restrict__ vblk,
                               const float* __restrict__ mblk,
                               float* __restrict__ out) {
  constexpr int FO = 2 * D + D * D + 3;
  const int a = blockIdx.x;
  const int cap = g.cap;
  const int cnt = min(act_count[a], cap);
  float* oblk = out + static_cast<int64_t>(a) * FO * cap;
  const int64_t n = g.n;
  for (int s = threadIdx.x; s < cap; s += blockDim.x) {
    if (s >= cnt) {
      for (int f = 0; f < FO; ++f) oblk[f * cap + s] = 0.0f;
      continue;
    }
    const int tid = tidv[a];
    const float* col = stream + act_start[a] + s;
    float pos[D];
    for (int d = 0; d < D; ++d) pos[d] = col[d * n];
    int base[D];
    float dvec[D];
    float w[3][D];
    stencil<D>(g, tid, pos, base, dvec, w);

    const float* mw = mblk + static_cast<int64_t>(a) * g.ncell;
    const float* vw = vblk + static_cast<int64_t>(a) * g.ncell * D;
    float rho = 0.0f;
    float v[D], Md[D][D];
    for (int i = 0; i < D; ++i) {
      v[i] = 0.0f;
      for (int j = 0; j < D; ++j) Md[j][i] = 0.0f;
    }
    int nk = 1;
    for (int d = 0; d < D; ++d) nk *= 3;
    for (int k = 0; k < nk; ++k) {
      int o[D];
      int r = k;
      for (int d = D - 1; d >= 0; --d) {
        o[d] = r % 3;
        r /= 3;
      }
      float wk = w[o[0]][0];
      for (int d = 1; d < D; ++d) wk = wk * w[o[d]][d];
      int e = 0;
      for (int d = 0; d < D; ++d) e = e * g.E + base[d] + o[d];
      rho = rho + wk * mw[e];
      for (int i = 0; i < D; ++i) {
        const float gv = vw[e * D + i];
        v[i] = v[i] + wk * gv;
        for (int j = 0; j < D; ++j) {
          const float wd = o[j] == 0 ? -wk : (o[j] == 2 ? wk : 0.0f);
          Md[j][i] = Md[j][i] + wd * gv;
        }
      }
    }
    const float dt = params[0];
    float newpos[D], newC[D * D];
    for (int d = 0; d < D; ++d) newpos[d] = pos[d] + v[d] * dt;
    const float pressure = mpm::tait_pressure(rho, params[1], params[2], params[3], params[4]);
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) newC[i * D + j] = 4.0f * (v[i] * (-dvec[j]) + Md[j][i]);
    mpm::particle_tail<D>(newpos, v, params, 0.0f);

    for (int d = 0; d < D; ++d) oblk[d * cap + s] = newpos[d];
    for (int d = 0; d < D; ++d) oblk[(D + d) * cap + s] = v[d];
    for (int ij = 0; ij < D * D; ++ij) oblk[(2 * D + ij) * cap + s] = newC[ij];
    oblk[(FO - 3) * cap + s] = rho;
    oblk[(FO - 2) * cap + s] = pressure;
    oblk[(FO - 1) * cap + s] = col[(2 * D + D * D) * n];
  }
}

PGeom make_geom(int dim, int A, int n, int T, int cap, const int* tshape, const int* origin) {
  PGeom g;
  g.A = A;
  g.n = n;
  g.T = T;
  g.E = T + 2;
  g.cap = cap;
  g.ncell = 1;
  for (int d = 0; d < dim; ++d) g.ncell *= g.E;
  for (int d = 0; d < 3; ++d) {
    g.tshape[d] = d < dim ? tshape[d] : 1;
    g.origin[d] = d < dim ? origin[d] : 0;
  }
  return g;
}

template <int D, int MODE>
int launch_deposit(const PGeom& g, const int* act_start, const int* act_count, const int* tid,
                   const float* stream, const float* mblk, const float* params, float* out,
                   cudaStream_t st) {
  constexpr int CH = MODE == MODE_P2G1 ? 1 + D : D;
  const size_t smem = static_cast<size_t>(Stage<D, CH>::words_per_slot()) * g.cap * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        deposit_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  deposit_kernel<D, MODE><<<g.A, DEPOSIT_THREADS, smem, st>>>(g, act_start, act_count, tid, stream,
                                                              mblk, params, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// mode 1: p2g1 (mblk, params unused); 2: force stream (mblk, params
// unused); 3: fused p2g2.
int fluid_pallas_deposit(int dim, int mode, const int* act_start, const int* act_count,
                         const int* tid, const float* stream, const float* mblk,
                         const float* params, float* out, int A, int n, int T, int cap,
                         const int* tshape, const int* origin, void* cuda_stream) {
  const PGeom g = make_geom(dim, A, n, T, cap, tshape, origin);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (A <= 0) return 0;
#define FLUID_DEPOSIT(D, M)                                                                 \
  if (dim == D && mode == M)                                                                \
    return launch_deposit<D, M>(g, act_start, act_count, tid, stream, mblk, params, out, st);
  FLUID_DEPOSIT(2, MODE_P2G1)
  FLUID_DEPOSIT(2, MODE_FORCE)
  FLUID_DEPOSIT(2, MODE_P2G2)
  FLUID_DEPOSIT(3, MODE_P2G1)
  FLUID_DEPOSIT(3, MODE_FORCE)
  FLUID_DEPOSIT(3, MODE_P2G2)
#undef FLUID_DEPOSIT
  return static_cast<int>(cudaErrorInvalidValue);
}

int fluid_pallas_collect(int dim, const int* act_start, const int* act_count, const int* tid,
                         const float* params, const float* stream, const float* vblk,
                         const float* mblk, float* out, int A, int n, int T, int cap,
                         const int* tshape, const int* origin, void* cuda_stream) {
  const PGeom g = make_geom(dim, A, n, T, cap, tshape, origin);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (A <= 0) return 0;
  const int threads = cap < 1024 ? ((cap + 31) / 32) * 32 : 1024;
  if (dim == 2)
    collect_kernel<2><<<A, threads, 0, st>>>(g, act_start, act_count, tid, params, stream, vblk, mblk, out);
  else if (dim == 3)
    collect_kernel<3><<<A, threads, 0, st>>>(g, act_start, act_count, tid, params, stream, vblk, mblk, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
