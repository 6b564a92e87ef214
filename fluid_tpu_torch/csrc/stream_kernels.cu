// Hand-written Hopper (sm_90a) kernels of the stream backend's substep.
//
// Counterparts of the Pallas kernels in fluid_tpu/ops/stream_transfer.py:
//
//   deposit_kernel<D, P2G2=false>  make_deposit_kernel(mode="p2g1")   (:676)
//   deposit_kernel<D, P2G2=true>   make_deposit_kernel(mode="p2g2")   (:676)
//   collect_kernel<D, FUSED>       make_collect_kernel(fused_p2g1)    (:1163)
//   halo_axis_kernel               _make_halo_axis                    (:2006)
//   halo_gblk_kernel               _make_halo_gblk                    (:1882)
//
// Layouts (tile-major; A active tiles, slots per tile cap, window E = T+2h):
//   stream [A, F, cap]  fields as rows, so thread j reading slot j of a field
//                       is a coalesced load; F = 2D + D*D + 4 rows
//                       (pos D, vel D, C D*D row-major, mass, id, rho, prs)
//   window [A, CH, E^D] flat cell order (e_0, ..., e_{D-1}), e_{D-1} fastest
//   flag   [A, cap]
//   count, tid [A] int32; nbr rows [A] int32 with A = "no neighbour"
//
// Every kernel launches one block per active tile (or a flat grid for the
// halo passes) over all A tiles: a tile whose count is 0 writes zeros and
// returns, so no output is ever left uninitialized and the host never reads
// a count to size a grid.  Deposits use the cell-owner (gather) form: each
// thread owns window cells and walks the tile's particles in slot order, so
// sums are deterministic (no float atomics) and a replayed snapshot is
// bit-identical.  Build with -fmad=false: every product and sum is rounded
// on its own, in the same order as the plain PyTorch versions in
// ops/stream_kernels.py, which the on-card check compares against.
//
// The B-spline weights, the Tait pressure and the particle tail come from
// mpm_common.cuh, shared with the pallas backend's kernels.
//
// Each C entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mpm_common.cuh"

namespace {

struct Geom {
  int A;          // active tiles (grid size)
  int T, h, E;    // tile edge, halo reach, window edge
  int cap;        // slots per tile (== blockDim.x of deposit/collect)
  int ncell;      // E^D
  int F;          // stream rows
  int tshape[3];  // tiles per axis
  int origin[3];  // domain origin, cells
};

// Per-slot stencil staging shared by the deposit and fused-collect paths.
// Shared layout, [field][slot] so that staging threads write distinct banks
// and the cell loop reads one broadcast word per field:
//   s_base [D][cap] int, s_w [3][D][cap], s_dvec [D][cap],
//   s_m [cap], s_v [D][cap], s_C [D*D][cap]  (p2g2 keeps the eq-16 term in s_C)
template <int D>
struct Stage {
  int* base;
  float* w;
  float* dvec;
  float* m;
  float* v;
  float* C;
  __device__ Stage(float* smem, int cap) {
    base = reinterpret_cast<int*>(smem);
    w = smem + D * cap;
    dvec = w + 3 * D * cap;
    m = dvec + D * cap;
    v = m + cap;
    C = v + D * cap;
  }
  static constexpr int words_per_slot() { return D + 3 * D + D + 1 + D + D * D; }
};

// Local stencil of slot s: the window row base (local cell + h - 1, clipped
// to the drift window exactly like _kernel_profiles_from), dvec and the three
// per-axis quadratic B-spline weights.  floorf before the int conversion:
// positions and local cells can be negative.
template <int D>
__device__ __forceinline__ void stage_stencil(const Stage<D>& sh, const Geom& g,
                                              int tid, const float* pos, int s) {
  const int cap = g.cap;
  for (int d = 0; d < D; ++d) {
    const float cf = floorf(pos[d]);
    const int lc = mpm::local_cell(cf, d, D, tid, g.T, g.tshape, g.origin);
    int b = lc + g.h - 1;
    b = b < 0 ? 0 : (b > g.E - 3 ? g.E - 3 : b);
    const float dv = (pos[d] - cf) - 0.5f;
    sh.base[d * cap + s] = b;
    sh.dvec[d * cap + s] = dv;
    mpm::bspline_weights(dv, sh.w[(0 * D + d) * cap + s], sh.w[(1 * D + d) * cap + s],
                         sh.w[(2 * D + d) * cap + s]);
  }
}

// Cell-owner deposit of the staged particles [0, cnt) into one tile window.
// p2g1: CH = 1 + D channels, mass w*m and APIC momentum w*m*(v + C dpos).
// p2g2: CH = D force channels w*(term dpos), plus the tile's p2g1 momentum
//       rows d1[1..D] (the fused m+f add).
// dpos = (o - 1) - dvec is the tap's cell centre minus the particle.
template <int D, bool P2G2>
__device__ void deposit_window(const Stage<D>& sh, const Geom& g, int cnt,
                               float* __restrict__ out, const float* __restrict__ d1) {
  constexpr int CH = P2G2 ? D : 1 + D;
  const int cap = g.cap, E = g.E, ncell = g.ncell;
  for (int e = threadIdx.x; e < ncell; e += blockDim.x) {
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
      float dpos[D];
      for (int j = 0; j < D; ++j) dpos[j] = static_cast<float>(o[j] - 1) - sh.dvec[j * cap + s];
      if (!P2G2) {
        const float mc = w * sh.m[s];
        acc[0] = acc[0] + mc;
        for (int i = 0; i < D; ++i) {
          float q = sh.C[(i * D + 0) * cap + s] * dpos[0];
          for (int j = 1; j < D; ++j) q = q + sh.C[(i * D + j) * cap + s] * dpos[j];
          acc[1 + i] = acc[1 + i] + mc * (sh.v[i * cap + s] + q);
        }
      } else {
        for (int i = 0; i < D; ++i) {
          float f = sh.C[(i * D + 0) * cap + s] * dpos[0];
          for (int j = 1; j < D; ++j) f = f + sh.C[(i * D + j) * cap + s] * dpos[j];
          acc[i] = acc[i] + w * f;
        }
      }
    }
    for (int c = 0; c < CH; ++c) {
      out[c * ncell + e] = P2G2 ? acc[c] + d1[(1 + c) * ncell + e] : acc[c];
    }
  }
}

// deposit_kernel — replaces make_deposit_kernel (stream_transfer.py:676),
// modes p2g1 and p2g2.
//
// Bound: by the layout, an occupied 3D tile reads its stream block
// (F*cap*4 = 9.7 KB) and, for p2g2, the halo'd mass and p2g1 windows
// (10 KB), and writes (1+D) or D windows of E^3 = 512 cells (8 KB / 6 KB);
// an empty tile only writes zeros.  Measured on an NVIDIA H100 80GB HBM3
// (700 W) at the 1M-particle shape (32,768 tiles, 17,554 occupied): 0.71 ms
// for p2g1 and for p2g2, several times what those bytes take at the card's
// peak bandwidth, so the cell-owner scan is the limit: every thread tests
// its E^D/cap = 4 cells against each of the tile's particles (512 x count
// tap tests per tile), out of shared memory.  The design keeps every intermediate
// (weights, bases, values) in shared memory and writes each output cell
// once, with no atomics.
//
// p2g2 additionally gathers each particle's density from the halo'd mass
// window (3^D taps), then its Tait pressure (with the floor), volume and
// eq-16 term -4 dt V (-p I + mu (C + C^T)), which it stages in s_C.
// params: [dt, rest_density, eos_stiffness, eos_power, pressure_floor, mu].
template <int D, bool P2G2>
__global__ void deposit_kernel(Geom g, const int* __restrict__ count,
                               const int* __restrict__ tidv,
                               const float* __restrict__ stream,
                               const float* __restrict__ hs_m,
                               const float* __restrict__ d1,
                               const float* __restrict__ params,
                               float* __restrict__ out) {
  constexpr int CH = P2G2 ? D : 1 + D;
  extern __shared__ float smem[];
  const int a = blockIdx.x;
  const int s = threadIdx.x;
  const int cap = g.cap;
  const int cnt = count[a];
  float* tile_out = out + static_cast<int64_t>(a) * CH * g.ncell;
  if (cnt == 0) {
    for (int i = threadIdx.x; i < CH * g.ncell; i += blockDim.x) tile_out[i] = 0.0f;
    return;
  }
  const int tid = tidv[a];
  Stage<D> sh(smem, cap);
  const float* blk = stream + static_cast<int64_t>(a) * g.F * cap;
  if (s < cnt) {
    float pos[D];
    for (int d = 0; d < D; ++d) pos[d] = blk[d * cap + s];
    stage_stencil<D>(sh, g, tid, pos, s);
    const float mass = blk[(2 * D + D * D) * cap + s];
    if (!P2G2) {
      sh.m[s] = mass;
      for (int i = 0; i < D; ++i) sh.v[i * cap + s] = blk[(D + i) * cap + s];
      for (int ij = 0; ij < D * D; ++ij) sh.C[ij * cap + s] = blk[(2 * D + ij) * cap + s];
    } else {
      // density gather from the halo'd mass window, taps in stencil order
      // (axis 0 fastest)
      const float* mw = hs_m + static_cast<int64_t>(a) * g.ncell;
      float rho = 0.0f;
      int nk = 1;
      for (int d = 0; d < D; ++d) nk *= 3;
      for (int k = 0; k < nk; ++k) {
        int o[D];
        int r = k;
        for (int d = 0; d < D; ++d) {
          o[d] = r % 3;
          r /= 3;
        }
        float w = sh.w[(o[0] * D + 0) * cap + s];
        for (int d = 1; d < D; ++d) w = w * sh.w[(o[d] * D + d) * cap + s];
        int e = 0;
        for (int d = 0; d < D; ++d) e = e * g.E + sh.base[d * cap + s] + o[d];
        rho = rho + w * mw[e];
      }
      const float dt = params[0], rest = params[1], k_eos = params[2];
      const float gamma = params[3], floor_p = params[4], mu = params[5];
      const float volume = rho > 0.0f ? mass / rho : 0.0f;
      const float pressure = mpm::tait_pressure(rho, rest, k_eos, gamma, floor_p);
      const float scale = (-4.0f * dt) * volume;
      for (int i = 0; i < D; ++i) {
        for (int j = 0; j < D; ++j) {
          const float cij = blk[(2 * D + i * D + j) * cap + s];
          const float cji = blk[(2 * D + j * D + i) * cap + s];
          const float visc = mu * (cij + cji);
          sh.C[(i * D + j) * cap + s] = scale * (i == j ? -pressure + visc : visc);
        }
      }
    }
  }
  __syncthreads();
  deposit_window<D, P2G2>(sh, g, cnt, tile_out,
                          P2G2 ? d1 + static_cast<int64_t>(a) * (1 + D) * g.ncell : nullptr);
}

// collect_kernel — replaces make_collect_kernel (stream_transfer.py:1163).
//
// One thread per slot: g2p from the tile's grid-value window gblk
// [1+D, E^D] (v rows, then mass): v = sum w gv, B = sum w gv (x) dpos,
// C = 4B, rho = sum w m; pressure; then the particle tail: advect, the mouse
// impulse after advection (quirk Q3), clamp and the un-scaled soft wall
// (quirk Q2) with x walls shifted by the packed-scene stride, and the drift
// flag (2.0 when the new cell leaves [1-h, T-2+h]).  Writes a NEW stream
// buffer (out of place); invalid slots write zero rows and a zero flag.
// FUSED also deposits the next substep's p2g1 windows from the updated
// particles (same device function as deposit_kernel<D, false>).
//
// Bound: by the layout, per tile it reads the stream block (9.7 KB) and the
// gblk window (8 KB, 27 taps per particle, within one 8 KB block so they hit
// L1/L2) and writes the new block (9.7 KB), the flag (0.5 KB) and, fused,
// 8 KB of windows: ~36 KB per tile, ~1.2 GB per call at 32,768 tiles.
// Measured fused, at that shape on an NVIDIA H100 80GB HBM3 (700 W):
// 0.88 ms, of which the fused deposit's cell-owner scan is the larger part.
//
// params: [dt, rest, k, gamma, floor, mouse_radius, damp, mouse_active,
//          mouse_x, mouse_y, lo[D], hi[D], scene_stride].
template <int D, bool FUSED>
__global__ void collect_kernel(Geom g, const int* __restrict__ count,
                               const int* __restrict__ tidv,
                               const float* __restrict__ params,
                               const float* __restrict__ stream,
                               const float* __restrict__ gblk,
                               float* __restrict__ out_stream,
                               float* __restrict__ flag,
                               float* __restrict__ dep) {
  extern __shared__ float smem[];
  const int a = blockIdx.x;
  const int s = threadIdx.x;
  const int cap = g.cap, F = g.F;
  const int cnt = count[a];
  const float* blk = stream + static_cast<int64_t>(a) * F * cap;
  float* oblk = out_stream + static_cast<int64_t>(a) * F * cap;
  float* tile_dep = FUSED ? dep + static_cast<int64_t>(a) * (1 + D) * g.ncell : nullptr;
  if (cnt == 0) {
    for (int i = threadIdx.x; i < F * cap; i += blockDim.x) oblk[i] = 0.0f;
    for (int i = threadIdx.x; i < cap; i += blockDim.x) flag[static_cast<int64_t>(a) * cap + i] = 0.0f;
    if (FUSED) {
      for (int i = threadIdx.x; i < (1 + D) * g.ncell; i += blockDim.x) tile_dep[i] = 0.0f;
    }
    return;
  }
  const int tid = tidv[a];
  Stage<D> sh(smem, cap);
  const bool valid = s < cnt;
  float newpos[D], v[D], newC[D * D];
  float mass = 0.0f;
  if (valid) {
    float pos[D];
    for (int d = 0; d < D; ++d) pos[d] = blk[d * cap + s];
    stage_stencil<D>(sh, g, tid, pos, s);  // own slot only: no barrier needed
    const float* gw = gblk + static_cast<int64_t>(a) * (1 + D) * g.ncell;
    float B[D][D];
    for (int i = 0; i < D; ++i) {
      v[i] = 0.0f;
      for (int j = 0; j < D; ++j) B[i][j] = 0.0f;
    }
    float rho = 0.0f;
    int nk = 1;
    for (int d = 0; d < D; ++d) nk *= 3;
    for (int k = 0; k < nk; ++k) {
      int o[D];
      int r = k;
      for (int d = 0; d < D; ++d) {
        o[d] = r % 3;
        r /= 3;
      }
      float w = sh.w[(o[0] * D + 0) * cap + s];
      for (int d = 1; d < D; ++d) w = w * sh.w[(o[d] * D + d) * cap + s];
      int e = 0;
      for (int d = 0; d < D; ++d) e = e * g.E + sh.base[d * cap + s] + o[d];
      float dpos[D];
      for (int j = 0; j < D; ++j) dpos[j] = static_cast<float>(o[j] - 1) - sh.dvec[j * cap + s];
      for (int i = 0; i < D; ++i) {
        const float wv = w * gw[i * g.ncell + e];
        v[i] = v[i] + wv;
        for (int j = 0; j < D; ++j) B[i][j] = B[i][j] + wv * dpos[j];
      }
      rho = rho + w * gw[D * g.ncell + e];
    }
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) newC[i * D + j] = 4.0f * B[i][j];

    const float dt = params[0];
    const float stride = params[10 + 2 * D];
    const float pressure = mpm::tait_pressure(rho, params[1], params[2], params[3], params[4]);
    for (int d = 0; d < D; ++d) newpos[d] = pos[d] + v[d] * dt;
    // packed scenes shift the x walls by the owning scene's offset
    const float sbase = stride > 0.0f ? floorf(newpos[0] / fmaxf(stride, 1.0f)) * stride : 0.0f;
    mpm::particle_tail<D>(newpos, v, params, sbase);

    // drift flag: the next deposit must stay inside the tile's window
    float fl = 0.0f;
    for (int d = 0; d < D; ++d) {
      const int lcn = mpm::local_cell(floorf(newpos[d]), d, D, tid, g.T, g.tshape, g.origin);
      if (lcn < 1 - g.h || lcn > g.T - 2 + g.h) fl = 2.0f;
    }
    mass = blk[(2 * D + D * D) * cap + s];
    const float pid = blk[(2 * D + D * D + 1) * cap + s];
    for (int d = 0; d < D; ++d) oblk[d * cap + s] = newpos[d];
    for (int d = 0; d < D; ++d) oblk[(D + d) * cap + s] = v[d];
    for (int ij = 0; ij < D * D; ++ij) oblk[(2 * D + ij) * cap + s] = newC[ij];
    oblk[(2 * D + D * D) * cap + s] = mass;
    oblk[(2 * D + D * D + 1) * cap + s] = pid;
    oblk[(2 * D + D * D + 2) * cap + s] = rho;
    oblk[(2 * D + D * D + 3) * cap + s] = pressure;
    flag[static_cast<int64_t>(a) * cap + s] = fl;
  } else if (s < cap) {
    for (int f = 0; f < F; ++f) oblk[f * cap + s] = 0.0f;
    flag[static_cast<int64_t>(a) * cap + s] = 0.0f;
  }
  if (FUSED) {
    __syncthreads();  // every thread is done reading the old stencil
    if (valid) {
      stage_stencil<D>(sh, g, tid, newpos, s);
      sh.m[s] = mass;
      for (int i = 0; i < D; ++i) sh.v[i * cap + s] = v[i];
      for (int ij = 0; ij < D * D; ++ij) sh.C[ij * cap + s] = newC[ij];
    }
    __syncthreads();
    deposit_window<D, false>(sh, g, cnt, tile_dep, nullptr);
  }
}

// Halo windows overlap by E - T = 2h cells along each axis.  One pass along
// axis d adds the +1 neighbour's window shifted by -T*stride_d into the
// cells e_d >= T, and the -1 neighbour's shifted by +T*stride_d into the
// cells e_d < E - T; a neighbour index == A reads as zero.  Both directions
// read the pass input, so the output is a separate buffer.  The sum order
// (own + plus) + minus, with 0.0f where masked, is halo_pull's, so the pass
// is bit-identical to the XLA gather form.
__device__ __forceinline__ float halo_sum(const float* __restrict__ x,
                                          const int* __restrict__ nbp,
                                          const int* __restrict__ nbm,
                                          int64_t i, int A, int L, int ncell,
                                          int E, int T, int lstride) {
  const int a = static_cast<int>(i / L);
  const int l = static_cast<int>(i - static_cast<int64_t>(a) * L);
  const int e_d = ((l % ncell) / lstride) % E;
  const int shift = T * lstride;
  const int p = nbp[a];
  const int m = nbm[a];
  float acc = x[i];
  const float yp = (e_d >= T && p < A) ? x[static_cast<int64_t>(p) * L + l - shift] : 0.0f;
  acc = acc + yp;
  const float ym = (e_d < E - T && m < A) ? x[static_cast<int64_t>(m) * L + l + shift] : 0.0f;
  acc = acc + ym;
  return acc;
}

// halo_axis_kernel — replaces _make_halo_axis (stream_transfer.py:2006).
// Bound: pure data movement, one output float per thread from up to three
// reads (own + two neighbour rows): by the layout 3 reads + 1 write of
// A*CH*E^D floats, ~0.8 GB per m+f pass at 32,768 tiles; measured 0.31 ms
// for that pass on an NVIDIA H100 80GB HBM3 (700 W).  Threads of a warp
// read consecutive cells of one row, so every read is coalesced; the
// per-row neighbour DMA of the TPU kernel is the row index nbp/nbm here.
__global__ void halo_axis_kernel(const float* __restrict__ x,
                                 const int* __restrict__ nbp,
                                 const int* __restrict__ nbm,
                                 float* __restrict__ out, int A, int CH,
                                 int ncell, int E, int T, int lstride) {
  const int L = CH * ncell;
  const int64_t total = static_cast<int64_t>(A) * L;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  out[i] = halo_sum(x, nbp, nbm, i, A, L, ncell, E, T, lstride);
}

// halo_gblk_kernel — replaces _make_halo_gblk (stream_transfer.py:1882):
// the last m+f halo pass fused with the grid update, v = mf/m + dt g where
// m > 0, else 0; emits the grid-value window [A, 1+D, E^D] (v rows, then the
// halo'd mass).  Bound: like a halo pass plus one mass read and the mass
// row written again, ~1 GB per call at 32,768 tiles in 3D by the layout;
// measured 0.40 ms there on an NVIDIA H100 80GB HBM3 (700 W).  The fusion
// saves the separate grid-update pass over the windows.
__global__ void halo_gblk_kernel(const float* __restrict__ x,
                                 const float* __restrict__ hs_m,
                                 const int* __restrict__ nbp,
                                 const int* __restrict__ nbm,
                                 float* __restrict__ out, int A, int D,
                                 int ncell, int E, int T, int lstride,
                                 float dtg0, float dtg1, float dtg2) {
  const int L = D * ncell;
  const int64_t total = static_cast<int64_t>(A) * L;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float mf = halo_sum(x, nbp, nbm, i, A, L, ncell, E, T, lstride);
  const int a = static_cast<int>(i / L);
  const int l = static_cast<int>(i - static_cast<int64_t>(a) * L);
  const int c = l / ncell;
  const int e = l - c * ncell;
  const float m = hs_m[static_cast<int64_t>(a) * ncell + e];
  const float dtg = c == 0 ? dtg0 : (c == 1 ? dtg1 : dtg2);
  float* tile = out + static_cast<int64_t>(a) * (1 + D) * ncell;
  tile[c * ncell + e] = m > 0.0f ? mf / m + dtg : 0.0f;
  if (c == 0) tile[D * ncell + e] = m;
}

Geom make_geom(int dim, int A, int T, int h, int cap, const int* tshape, const int* origin) {
  Geom g;
  g.A = A;
  g.T = T;
  g.h = h;
  g.E = T + 2 * h;
  g.cap = cap;
  g.ncell = 1;
  for (int d = 0; d < dim; ++d) g.ncell *= g.E;
  g.F = 2 * dim + dim * dim + 4;
  for (int d = 0; d < 3; ++d) {
    g.tshape[d] = d < dim ? tshape[d] : 1;
    g.origin[d] = d < dim ? origin[d] : 0;
  }
  return g;
}

template <int D>
size_t stage_bytes(int cap) {
  return static_cast<size_t>(Stage<D>::words_per_slot()) * cap * sizeof(float);
}

unsigned int flat_blocks(int64_t total, int threads) {
  return static_cast<unsigned int>((total + threads - 1) / threads);
}

}  // namespace

extern "C" {

// mode 1: p2g1 (hs_m, d1, params unused); mode 2: p2g2.
int fluid_deposit(int dim, int mode, const int* count, const int* tid,
                  const float* stream, const float* hs_m, const float* d1,
                  const float* params, float* out, int A, int T, int h, int cap,
                  const int* tshape, const int* origin, void* cuda_stream) {
  const Geom g = make_geom(dim, A, T, h, cap, tshape, origin);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (dim == 2 && mode == 1)
    deposit_kernel<2, false><<<A, cap, stage_bytes<2>(cap), st>>>(g, count, tid, stream, hs_m, d1, params, out);
  else if (dim == 2 && mode == 2)
    deposit_kernel<2, true><<<A, cap, stage_bytes<2>(cap), st>>>(g, count, tid, stream, hs_m, d1, params, out);
  else if (dim == 3 && mode == 1)
    deposit_kernel<3, false><<<A, cap, stage_bytes<3>(cap), st>>>(g, count, tid, stream, hs_m, d1, params, out);
  else if (dim == 3 && mode == 2)
    deposit_kernel<3, true><<<A, cap, stage_bytes<3>(cap), st>>>(g, count, tid, stream, hs_m, d1, params, out);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int fluid_collect(int dim, int fused, const int* count, const int* tid,
                  const float* params, const float* stream, const float* gblk,
                  float* out_stream, float* flag, float* dep, int A, int T, int h,
                  int cap, const int* tshape, const int* origin, void* cuda_stream) {
  const Geom g = make_geom(dim, A, T, h, cap, tshape, origin);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (dim == 2 && !fused)
    collect_kernel<2, false><<<A, cap, stage_bytes<2>(cap), st>>>(g, count, tid, params, stream, gblk, out_stream, flag, dep);
  else if (dim == 2 && fused)
    collect_kernel<2, true><<<A, cap, stage_bytes<2>(cap), st>>>(g, count, tid, params, stream, gblk, out_stream, flag, dep);
  else if (dim == 3 && !fused)
    collect_kernel<3, false><<<A, cap, stage_bytes<3>(cap), st>>>(g, count, tid, params, stream, gblk, out_stream, flag, dep);
  else if (dim == 3 && fused)
    collect_kernel<3, true><<<A, cap, stage_bytes<3>(cap), st>>>(g, count, tid, params, stream, gblk, out_stream, flag, dep);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int fluid_halo_axis(const float* x, const int* nbp, const int* nbm, float* out,
                    int A, int CH, int ncell, int E, int T, int lstride,
                    void* cuda_stream) {
  const int threads = 256;
  const int64_t total = static_cast<int64_t>(A) * CH * ncell;
  halo_axis_kernel<<<flat_blocks(total, threads), threads, 0,
                     static_cast<cudaStream_t>(cuda_stream)>>>(x, nbp, nbm, out, A, CH, ncell, E, T, lstride);
  return static_cast<int>(cudaGetLastError());
}

int fluid_halo_gblk(const float* x, const float* hs_m, const int* nbp,
                    const int* nbm, float* out, int A, int D, int ncell, int E,
                    int T, int lstride, float dtg0, float dtg1, float dtg2,
                    void* cuda_stream) {
  const int threads = 256;
  const int64_t total = static_cast<int64_t>(A) * D * ncell;
  halo_gblk_kernel<<<flat_blocks(total, threads), threads, 0,
                     static_cast<cudaStream_t>(cuda_stream)>>>(x, hs_m, nbp, nbm, out, A, D, ncell, E, T, lstride,
                                                               dtg0, dtg1, dtg2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
