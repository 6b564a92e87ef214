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
// no double-buffered DMA), and the contraction is a scatter into a tile
// window in shared memory: lane k of a warp owns stencil tap k and the
// warp walks the tile's particles in slot order, adding each particle's
// value to its tap's cell.  Every cell sums its particles in slot order
// from 0.0f (no float atomics; a replayed snapshot is bit-identical).
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

// Slots a deposit block stages and walks at a time: its thread count.
constexpr int DEPOSIT_CHUNK = 128;

// n / d for 0 <= n < 2^32 / d, as one multiply-high with m = ceil(2^32 / d)
// (Granlund-Montgomery) in place of a runtime division; d = 1 is n itself.
struct FastDiv {
  unsigned int m;
  int d;
};

FastDiv fast_div(int d) {
  return FastDiv{d > 1 ? static_cast<unsigned int>(0xFFFFFFFFull / static_cast<unsigned int>(d) + 1)
                       : 0u,
                 d};
}

__device__ __forceinline__ int div_by(int n, FastDiv f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<unsigned int>(n), f.m));
}

struct PGeom {
  int A;          // active tiles (grid size)
  int n;          // stream columns (row stride)
  int T, E;       // tile edge, window edge (T + 2)
  int cap;        // slots per tile
  int ncell;      // E^D
  int tshape[3];  // tiles per axis
  int origin[3];  // domain origin, cells
  FastDiv divE;   // / E
  int wstride[3]; // shared deposit window: cell stride of each axis
  int wch;        // shared deposit window: floats per channel
};

// Local stencil of one particle: window base (local cell), dvec and the
// three per-axis weights.  floorf before the int conversion: positions and
// local cells can be negative.
template <int D>
__device__ __forceinline__ void stencil(const PGeom& g, int tid, const float* pos,
                                        int* base, float* dvec, float (*w)[D]) {
  for (int d = 0; d < D; ++d) {
    const float cf = floorf(pos[d]);
    const int lc = mpm::local_cell(cf, mpm::tile_corner(tid, d, D, g.T, g.tshape, g.origin));
    const float dv = (pos[d] - cf) - 0.5f;
    base[d] = lc < 0 ? 0 : (lc > g.T - 1 ? g.T - 1 : lc);
    dvec[d] = dv;
    mpm::bspline_weights(dv, w[0][d], w[1][d], w[2][d]);
  }
}

__device__ __forceinline__ float comp(const float4& q, int k) {
  return k == 0 ? q.x : (k == 1 ? q.y : (k == 2 ? q.z : q.w));
}

// Per-slot staging record of a deposit in shared memory, RQ float4s (RQ
// odd, so one thread per slot storing its record and a warp reading one
// record are both free of bank conflicts):
//   q[c]        channel c < CH: (g0[c], gd[0][i], .., gd[D-1][i]), i = c -
//               (CH - D), for the last D channels; (g0[c], 0, 0, 0) else
//   q[CH] ..    the tap weights, w[o][d] at word 3d + o, then the base's
//               offset in the window, in bytes (int), at word 3D
// A particle's value in the cell of its tap with offsets o is
//   ch c:            w * g0[c],  w = w[o_0][0] * w[o_1][1] * ..
//   ch CH-D+i also:  + sum_d wd_d * gd[d][i],  wd_d = -w, 0 or w for o_d = 0, 1, 2
// p2g1: g0 = (m, m(v - C dvec)), gd[d][i] = m C[i][d]   (the APIC momentum)
// force / p2g2: g0 = A2 = term (-dvec), gd[d][i] = term[i][d]   (eq. 16)
template <int D, int CH>
struct Record {
  static constexpr int WQ = (3 * D + 4) / 4;  // float4s of the weights and the cell
  static constexpr int RQ = (CH + WQ) | 1;
};

// Stages slot s of the tile (stream column start + s) as record r: its
// stencil, and its channel values formed as the plain versions form them.
// MODE_P2G2 first gathers the particle's density from the tile's mass block
// mw [E^D] in shared memory (3^D taps, flat cell order), then the Tait
// pressure with its floor, the volume m / rho, the eq-16 term
// -4 V dt (-p I + mu (C + C^T)) and A2 = term (-dvec).
template <int D, int MODE, int CH>
__device__ __forceinline__ void stage_slot(const PGeom& g, int tid, const float* col, int64_t n,
                                           const float* mw, const float* params, float4* rec) {
  constexpr int pos_row = MODE == MODE_FORCE ? D + D * D : 0;
  float pos[D];
  for (int d = 0; d < D; ++d) pos[d] = col[(pos_row + d) * n];
  int base[D];
  float dvec[D];
  float w[3][D];
  stencil<D>(g, tid, pos, base, dvec, w);
  float q[CH][4];
  for (int c = 0; c < CH; ++c)
    for (int j = 0; j < 4; ++j) q[c][j] = 0.0f;
  constexpr int M = CH - D;  // the first channel with moment terms
  if (MODE == MODE_P2G1) {
    const float m = col[(2 * D + D * D) * n];
    q[0][0] = m;
    for (int i = 0; i < D; ++i) {
      float cd = col[(2 * D + i * D) * n] * dvec[0];
      for (int j = 1; j < D; ++j) cd = cd + col[(2 * D + i * D + j) * n] * dvec[j];
      q[M + i][0] = m * (col[(D + i) * n] - cd);
      for (int d = 0; d < D; ++d) q[M + i][1 + d] = m * col[(2 * D + i * D + d) * n];
    }
  } else if (MODE == MODE_FORCE) {
    for (int i = 0; i < D; ++i) {
      q[i][0] = col[i * n];
      for (int d = 0; d < D; ++d) q[i][1 + d] = col[(D + d * D + i) * n];
    }
  } else {
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
      q[i][0] = a2;
      for (int d = 0; d < D; ++d) q[i][1 + d] = term[i][d];
    }
  }
  for (int c = 0; c < CH; ++c) rec[c] = make_float4(q[c][0], q[c][1], q[c][2], q[c][3]);
  constexpr int WQ = Record<D, CH>::WQ;
  float t[4 * WQ];
  for (int j = 0; j < 4 * WQ; ++j) t[j] = 0.0f;
  int cell = 0;
  for (int d = 0; d < D; ++d) {
    for (int o = 0; o < 3; ++o) t[3 * d + o] = w[o][d];
    cell += base[d] * g.wstride[d];
  }
  t[3 * D] = __int_as_float(4 * cell);
  for (int j = 0; j < WQ; ++j)
    rec[CH + j] = make_float4(t[4 * j], t[4 * j + 1], t[4 * j + 2], t[4 * j + 3]);
}

// win[addr] += val for the float at 32-bit shared-memory byte address addr.
// Through the address, so that the walk keeps one register per lane for
// its window cell's base: the compiled walk otherwise recomputed the
// window's shared-memory base before each add.
__device__ __forceinline__ void shared_add(unsigned int addr, float val) {
  asm volatile(
      "{\n\t.reg .f32 t;\n\tld.shared.f32 t, [%0];\n\tadd.rn.f32 t, t, %1;\n\t"
      "st.shared.f32 [%0], t;\n\t}" ::"r"(addr),
      "f"(val)
      : "memory");
}

// Tap-parallel deposit of the staged records [0, cn) into the tile window
// `win` (channels g.wch floats apart, cells at the padded strides
// g.wstride, so the 3^D taps of one particle fall in distinct banks).
// Lane k < 3^D of a warp owns stencil tap k, and a warp owns one channel
// (3D) or three (2D, 9 taps each); the warp walks the records in slot order
// and each lane adds its tap's value to its cell, computing two particles'
// values before their two adds.  One particle's taps land in distinct
// cells and __syncwarp orders one particle's adds before the next's, so
// every cell sums its particles in slot order, each chunk after the last,
// with no atomics.  Every thread of the block calls it after the
// __syncthreads that follows the chunk's staging.
template <int D, int CH>
__device__ __forceinline__ void window_walk(const float4* stage, const PGeom& g, int cn,
                                            float* win) {
  constexpr int K = D == 3 ? 27 : 9;  // taps
  constexpr int G = 32 / K;           // channels per warp
  constexpr int RQ = Record<D, CH>::RQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  const int k = lane % K, sub = lane / K;
  int o[D];
  float sgn[D];  // o_d - 1: wd_d = sgn_d w is exact (-w, +0 as w >= +0, or w)
  int tap = 0;
  {
    int r = k;
    for (int d = D - 1; d >= 0; --d) {  // flat tap order, axis D-1 fastest
      o[d] = r % 3;
      r /= 3;
      sgn[d] = static_cast<float>(o[d] - 1);
      tap += o[d] * g.wstride[d];
    }
  }
  for (int v0 = warp * G; v0 < CH; v0 += nwarp * G) {  // uniform over the warp
    const int c = v0 + sub;
    const bool on = sub < G && c < CH;
    const bool mom = c >= CH - D;  // this lane's channel has moment terms
    // this lane's window cell at the particle's base, a shared byte address
    const unsigned int wc = static_cast<unsigned int>(__cvta_generic_to_shared(win + c * g.wch + tap));
    // this lane's value of record s and the byte offset of its cell
    auto tap_value = [&](int s, int* cell) {
      const float4* r = stage + s * RQ;
      const float* rw = reinterpret_cast<const float*>(r + CH);
      float w = rw[o[0]];
      for (int d = 1; d < D; ++d) w = w * rw[3 * d + o[d]];
      *cell = __float_as_int(rw[3 * D]);
      const float4 q = r[c];
      float val = w * q.x;
      if (mom) {
        for (int d = 0; d < D; ++d) val = val + (sgn[d] * w) * comp(q, 1 + d);
      }
      return val;
    };
    int s = 0;
    for (; s + 1 < cn; s += 2) {
      int cell0 = 0, cell1 = 0;
      float val0 = 0.0f, val1 = 0.0f;
      if (on) {
        val0 = tap_value(s, &cell0);
        val1 = tap_value(s + 1, &cell1);
        shared_add(wc + cell0, val0);
      }
      __syncwarp();
      if (on) shared_add(wc + cell1, val1);
      __syncwarp();
    }
    if (s < cn) {
      if (on) {
        int cell;
        const float val = tap_value(s, &cell);
        shared_add(wc + cell, val);
      }
      __syncwarp();
    }
  }
}

// deposit_kernel — replaces _deposit_kernel (pallas_transfer.py:160) in its
// two modes and the fused _p2g2_kernel (:428).
//
// Bound on this card: at the 1M-particle shape (32,768 tiles, about 17,500
// occupied, ~57 particles each) the kernel reads 64 B per particle and, for
// p2g2, a 0.9 KB mass block per occupied tile, and writes the [E^D, CH]
// block of every tile (3.5 KB for p2g1): ~0.2 GB, ~0.05 ms at the card's
// bandwidth.  A cell-owner scan (each of the E^D cells testing every
// particle of its tile, 87.5% of the tests finding nothing) took 0.45-0.51
// ms on an NVIDIA H100 80GB HBM3 (700 W); here every lane's step is a tap
// that deposits, and the limit is the instructions the SM issues in the
// walk: 28 a tap-step (p2g2, force; 33 on p2g1's momentum channels, 24 on
// its mass channel), 0.15-0.19 ms on the same card, 3.5-3.9x the bound.
//
// A block has DEPOSIT_CHUNK threads and stages and walks its tile's slots
// one chunk of DEPOSIT_CHUNK at a time (window_walk), so any cap launches
// and its shared memory holds one chunk's records, the window and (p2g2)
// the tile's mass block, whatever the cap: the window is cleared before
// the first chunk and written out after the last, each output cell once,
// in the [E^D, CH] layout.
// params: [dt, rest_density, eos_stiffness, eos_power, pressure_floor, mu].
template <int D, int MODE>
__global__ void __launch_bounds__(DEPOSIT_CHUNK)
deposit_kernel(PGeom g, const int* __restrict__ act_start,
               const int* __restrict__ act_count, const int* __restrict__ tidv,
               const float* __restrict__ stream, const float* __restrict__ mblk,
               const float* __restrict__ params, float* __restrict__ out) {
  constexpr int CH = MODE == MODE_P2G1 ? 1 + D : D;
  constexpr int RQ = Record<D, CH>::RQ;
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.x;
  const int cnt = min(act_count[a], g.cap);
  float* tile_out = out + static_cast<int64_t>(a) * g.ncell * CH;
  if (cnt <= 0) {
    for (int i = threadIdx.x; i < g.ncell * CH; i += blockDim.x) tile_out[i] = 0.0f;
    return;
  }
  const int tid = tidv[a];
  const int64_t start = act_start[a];
  float4* stage = reinterpret_cast<float4*>(smem);
  float* win = smem + 4 * RQ * DEPOSIT_CHUNK;
  float* mw = win + CH * g.wch;  // p2g2: the tile's mass block
  for (int i = threadIdx.x; i < CH * g.wch; i += blockDim.x) win[i] = 0.0f;
  if (MODE == MODE_P2G2) {
    const float* src = mblk + static_cast<int64_t>(a) * g.ncell;
    for (int i = threadIdx.x; i < g.ncell; i += blockDim.x) mw[i] = src[i];
    __syncthreads();
  }
  for (int c0 = 0; c0 < cnt; c0 += DEPOSIT_CHUNK) {
    const int cn = min(DEPOSIT_CHUNK, cnt - c0);
    if (threadIdx.x < cn)
      stage_slot<D, MODE, CH>(g, tid, stream + start + c0 + threadIdx.x, g.n, mw, params,
                              stage + threadIdx.x * RQ);
    __syncthreads();
    window_walk<D, CH>(stage, g, cn, win);
    __syncthreads();  // the walk has read the records before the next chunk
  }
  for (int i = threadIdx.x; i < CH * g.ncell; i += blockDim.x) {
    int e = i / CH;
    int cell = (i - e * CH) * g.wch;
    for (int d = D - 1; d > 0; --d) {
      const int q = div_by(e, g.divE);
      cell += (e - q * g.E) * g.wstride[d];
      e = q;
    }
    tile_out[i] = win[cell + e * g.wstride[0]];
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
    mpm::particle_tail<D>(newpos, v, params);

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
  g.divE = fast_div(g.E);
  if (dim < 2 || dim > 3) return g;  // refused by the entry points
  // padded window strides: the line stride a >= E and the outer stride b
  // >= E a (3D: of planes; 2D: of the three channels a warp owns) are the
  // first pair, a then b ascending, that put the 27 taps a warp adds at
  // once (offsets o0 b + o1 a + o2) in distinct banks; a = 9 and b = 3
  // modulo 32 always do, so the search ends within 32 x 32 pairs
  auto distinct_banks = [](int b, int a) {
    unsigned int seen = 0u;
    for (int k = 0; k < 27; ++k) {
      const int bank = ((k / 9) * b + (k / 3 % 3) * a + k % 3) % 32;
      if (seen >> bank & 1u) return false;
      seen |= 1u << bank;
    }
    return true;
  };
  int a = g.E, b = 0;
  for (;; ++a) {
    for (b = g.E * a; b < g.E * a + 32 && !distinct_banks(b, a); ++b) {
    }
    if (b < g.E * a + 32) break;
  }
  for (int d = 0; d < 3; ++d) g.wstride[d] = 0;
  g.wstride[dim - 1] = 1;
  g.wstride[dim - 2] = a;
  if (dim == 3) g.wstride[0] = b;
  g.wch = dim == 3 ? g.E * b : b;
  return g;
}

template <int D, int MODE>
int launch_deposit(const PGeom& g, const int* act_start, const int* act_count, const int* tid,
                   const float* stream, const float* mblk, const float* params, float* out,
                   cudaStream_t st) {
  constexpr int CH = MODE == MODE_P2G1 ? 1 + D : D;
  // one chunk's records, the window and (p2g2) the tile's mass block
  const size_t smem = (static_cast<size_t>(4 * Record<D, CH>::RQ) * DEPOSIT_CHUNK + CH * g.wch +
                       (MODE == MODE_P2G2 ? g.ncell : 0)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        deposit_kernel<D, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  deposit_kernel<D, MODE><<<g.A, DEPOSIT_CHUNK, smem, st>>>(g, act_start, act_count, tid, stream,
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
