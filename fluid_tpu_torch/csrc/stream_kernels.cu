// Hand-written Hopper (sm_90a) kernels of the stream backend's substep.
//
// Counterparts of the Pallas kernels in fluid_tpu/ops/stream_transfer.py:
//
//   deposit_kernel<D, P2G2=false>  make_deposit_kernel(mode="p2g1")   (:676)
//   deposit_kernel<D, P2G2=true>   make_deposit_kernel(mode="p2g2")   (:676)
//   collect_kernel<D>              make_collect_kernel(fused_p2g1=True) (:1163)
//   halo_axes_kernel<D, 1, false>  _make_halo_axis, all D passes chained (:2006)
//   halo_axes_kernel<D, D, true>   _make_halo_gblk (:1882) with the D - 1
//                                  _make_halo_axis passes ahead of it
//     (halo_axes_any_kernel<D, GBLK> for E != 2T and other channel counts)
//
// Layouts (tile-major; A active tiles, slots per tile cap, window E = T+2h):
//   stream [A, F, cap]  fields as rows, so thread j reading slot j of a field
//                       is a coalesced load; F = 2D + D*D + 4 rows
//                       (pos D, vel D, C D*D row-major, mass, id, rho, prs)
//   window [A, CH, E^D] flat cell order (e_0, ..., e_{D-1}), e_{D-1} fastest
//   flag   [A, cap]
//   count, tid [A] int32; nbr rows [A] int32 with A = "no neighbour"
//
// Every kernel works on the entries below `occupied`, a [1] int32 count
// that the binning keeps on the device (StreamState.occupied): it orders the
// entries occupied first, then the relays, then the unused ones, so the
// entries with count > 0 are exactly those below it.  A tile is one block's
// work (the halo packs several).  A deposit or collect launch takes
// ceil(A / TILES_PER_BLOCK) blocks, and block b the tiles b, b + gridDim.x
// that lie below the count; a halo launch takes one block per halo block of
// entries, and a block past the count returns at once.  The host never
// reads the count to size a grid.  The
// windows of the entries at or past `occupied` are undefined: no stage
// reads them (a deposit or collect reads only its own occupied tile's, a
// halo gates each leaf of a route on count > 0, and a relay is only a row
// of the face tables that a route walks through).  A caller that passes no
// `occupied` (null: the sharded path, whose ghost entries hold no particle
// but windows that the exchange fills) gets every entry of A, and there a
// tile whose count is 0 writes zero windows.  The collect writes only a
// tile's live slots of the stream and flag, in place: the slots past the
// count hold zeros, as every writer that sets a count leaves them.  A
// deposit block has one thread per slot of a chunk of min(cap, 256) slots,
// a collect block of min(cap, 128), and walks the tile's slots chunk by
// chunk, so any cap that is a multiple of 32 launches and its shared memory
// holds one chunk's stage, not cap's.  Deposits
// scatter each particle's 3^D taps, one lane per tap, into a tile window in
// shared memory, one particle after the other in slot order: no float
// atomics, every cell sums its particles in slot order (p2g2: two slot
// ranges, each in slot order, then added in a fixed order), so every launch
// sums alike and a replayed snapshot is bit-identical.  Build with
// -fmad=false: every product and sum is rounded on its own, in the order
// of the plain PyTorch versions in ops/stream_kernels.py, which the
// on-card check compares against (the plain deposits' index_add_ sums
// particles in its own order).
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

__host__ __device__ constexpr int pow3(int n) { return n == 0 ? 1 : 3 * pow3(n - 1); }

// Widest chunk of slots a deposit block takes at a time (its thread count,
// p2g2 aside), and a collect block (see collect_kernel).
constexpr int CHUNK_MAX = 256;
constexpr int COLLECT_CHUNK = 128;
// Tiles a deposit or collect block takes in turn (see deposit_kernel).
constexpr int TILES_PER_BLOCK = 2;

// The entries a launch works on: those below *occupied, or all A where the
// caller passes no count.
__device__ __forceinline__ int entry_bound(const int* occupied, int A) {
  if (occupied == nullptr) return A;
  const int n = *occupied;
  return n < A ? n : A;
}

struct Geom {
  int A;          // active tiles (grid size)
  int T, h, E;    // tile edge, halo reach, window edge
  int cap;        // slots per tile, a multiple of 32
  int chunk;      // slots staged and walked at a time: min(cap, CHUNK_MAX),
                  // a collect's min(cap, COLLECT_CHUNK)
  int ncell;      // E^D
  int F;          // stream rows
  int tshape[3];  // tiles per axis
  int origin[3];  // domain origin, cells
  int sx;         // grid cells of one scene along axis 0 (one scene: the grid's)
  FastDiv divE, divN;  // / E, / ncell
  int wstride[3];      // shared deposit window: cell stride of each axis
  int wch;             // shared deposit window: floats per channel
};

// Local stencil of one particle of a tile with corner `corner` (the tile's
// scene_corner): the window row base per axis (local cell + h - 1, clipped
// to the drift window exactly like _kernel_profiles_from), dvec, the three
// per-axis quadratic B-spline weights w[o][d], and the base's offset in the
// shared deposit window.  floorf before the int conversion: positions and
// local cells can be negative.
template <int D>
struct Stencil {
  int base[D];
  float dvec[D];
  float w[3][D];
  int cell;
};

template <int D>
__device__ __forceinline__ Stencil<D> stencil_of(const Geom& g, const int* corner,
                                                 const float* pos) {
  Stencil<D> st;
  st.cell = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float cf = floorf(pos[d]);
    const int lc = mpm::local_cell(cf, corner[d]);
    int b = lc + g.h - 1;
    b = b < 0 ? 0 : (b > g.E - 3 ? g.E - 3 : b);
    st.base[d] = b;
    st.dvec[d] = (pos[d] - cf) - 0.5f;
    mpm::bspline_weights(st.dvec[d], st.w[0][d], st.w[1][d], st.w[2][d]);
    st.cell += b * g.wstride[d];
  }
  return st;
}

// Calls f(w, e, dpos) for each tap of a stencil in stencil order (axis 0
// fastest): w = w_0 w_1 .. in axis order, e the flat window cell, dpos =
// (o - 1) - dvec the tap's cell centre minus the particle.  The last axis
// runs in a loop and the others are unrolled, so the weights stay in
// registers at a register count that keeps several blocks on an SM.
template <int D, typename F>
__device__ __forceinline__ void for_taps(const Stencil<D>& st, const Geom& g, F&& f) {
  constexpr int L = D - 1;
#pragma unroll 1
  for (int ol = 0; ol < 3; ++ol) {
    const float wl = ol == 0 ? st.w[0][L] : (ol == 1 ? st.w[1][L] : st.w[2][L]);
#pragma unroll
    for (int k = 0; k < pow3(L); ++k) {
      int o[D];
      int r = k;
      for (int d = 0; d < L; ++d) {
        o[d] = r % 3;
        r /= 3;
      }
      o[L] = ol;
      float w = st.w[o[0]][0];
      for (int d = 1; d < L; ++d) w = w * st.w[o[d]][d];
      w = w * wl;
      int e = 0;
      float dpos[D];
      for (int d = 0; d < D; ++d) {
        e = e * g.E + st.base[d] + o[d];
        dpos[d] = static_cast<float>(o[d] - 1) - st.dvec[d];
      }
      f(w, e, dpos);
    }
  }
}

__device__ __forceinline__ float comp(const float4& q, int k) {
  return k == 0 ? q.x : (k == 1 ? q.y : (k == 2 ? q.z : q.w));
}

// Per-slot staging record in shared memory for the deposit, RQ float4s per
// slot (RQ odd, so one thread per slot writing its own record and a warp
// reading one slot are both free of bank conflicts):
//   q[0]          dvec[0..D-1], mass
//   q[1 + i]      row i of C (p2g2: of the eq-16 term), then v_i   (i < D)
//   q[1 + D]      the base's window offset (int)
//   q[2 + D] ..   the tap weights, w[o][d] at word 3d + o
template <int D>
struct Stage {
  static constexpr int WQ = (3 * D + 3) / 4;
  static constexpr int RQ = (2 + D + WQ) | 1;
  static constexpr int W = 4 * (2 + D);  // word of the first weight
  float4* q;
  __device__ explicit Stage(float* smem) : q(reinterpret_cast<float4*>(smem)) {}
  __host__ __device__ static constexpr int words_per_slot() { return 4 * RQ; }

  __device__ __forceinline__ void store(int s, const Stencil<D>& st, float mass, const float* v,
                                        const float* C) const {
    float4* r = q + s * RQ;
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int d = 0; d < D; ++d) t[d] = st.dvec[d];
    t[D] = mass;
    r[0] = make_float4(t[0], t[1], t[2], t[3]);
    for (int i = 0; i < D; ++i) {
      for (int j = 0; j < D; ++j) t[j] = C[i * D + j];
      t[D] = v ? v[i] : 0.0f;
      r[1 + i] = make_float4(t[0], t[1], t[2], t[3]);
    }
    reinterpret_cast<int*>(r + 1 + D)[0] = st.cell;
    float* w = reinterpret_cast<float*>(r) + W;
    for (int d = 0; d < D; ++d)
      for (int o = 0; o < 3; ++o) w[3 * d + o] = st.w[o][d];
  }
};

// Cell (e_0, .., e_{D-1}) of flat window index e, e_{D-1} fastest.
template <int D>
__device__ __forceinline__ void window_coords(int e, const Geom& g, int* ec) {
  for (int d = D - 1; d > 0; --d) {
    const int q = div_by(e, g.divE);
    ec[d] = e - q * g.E;
    e = q;
  }
  ec[0] = e;
}

// Tap-parallel deposit of the staged particles [0, cnt) into one tile
// window.  The window lives in shared memory (`win`, channels g.wch floats
// apart, cells at the padded strides g.wstride, so the 3^D taps of one
// particle fall in distinct banks).  Lane k < 3^D of a warp owns stencil
// tap k, and a warp owns one channel (3D) or three (2D, 9 taps each); the
// warp walks the particles in slot order and each lane adds its tap's value
// to its cell, computing two particles' values before their two adds.  One
// particle's taps land in distinct cells and __syncwarp orders one
// particle's adds before the next's, so every cell sums its particles in
// slot order from 0.0f, with no atomics, and every lane's work is a tap
// that deposits (a cell-owner scan, each cell testing every particle of the
// tile, hits ~5% of its tests).  Then the window is written out, each
// output cell once.
// SPLIT > 1 cuts the walk into SPLIT consecutive slot ranges of
// ceil(cnt / SPLIT) particles, each with its own partial window (SPLIT x CH
// virtual channels, part-major, one warp each in 3D), and the write-out
// sums a cell's parts in part order: ((part 0 + part 1) + ..) + d1.  The
// order is fixed, so every launch still sums alike.
// p2g1: CH = 1 + D channels, mass w*m and APIC momentum w*m*(v + C dpos).
// p2g2: CH = D force channels w*(term dpos), plus the tile's p2g1 momentum
//       rows d1[1..D] (the fused m+f add).
// dpos = (o - 1) - dvec is the tap's cell centre minus the particle.
template <int D, bool P2G2, int SPLIT = 1>
__device__ void deposit_window(const Stage<D>& sh, const Geom& g, int cnt, float* win,
                               float* __restrict__ out, const float* __restrict__ d1) {
  constexpr int CH = P2G2 ? D : 1 + D;
  constexpr int NV = SPLIT * CH;      // (part, channel) windows
  constexpr int K = D == 3 ? 27 : 9;  // taps
  constexpr int G = 32 / K;           // channels per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int i = threadIdx.x; i < NV * g.wch; i += blockDim.x) win[i] = 0.0f;
  __syncthreads();

  const int k = lane % K, sub = lane / K;
  int o[D];
  int tap = 0;
  {
    int r = k;
    for (int d = 0; d < D; ++d) {  // stencil order, axis 0 fastest
      o[d] = r % 3;
      r /= 3;
      tap += o[d] * g.wstride[d];
    }
  }
  const int steps = (cnt + SPLIT - 1) / SPLIT;  // particles per part
  for (int v0 = warp * G; v0 < NV; v0 += nwarp * G) {  // uniform over the warp
    const int vc = v0 + sub;
    const bool on = sub < G && vc < NV;
    const int c = vc % CH, first = vc / CH * steps;
    const int len = cnt - first < steps ? cnt - first : steps;  // this part's particles
    float* wc = win + vc * g.wch + tap;
    const int i = P2G2 ? c : c - 1;  // the row of C (and v) this lane's channel reads
    // this lane's value of particle first + s and the cell it lands in
    auto tap_value = [&](int s, int* cell) {
      const float4* r = sh.q + (first + s) * Stage<D>::RQ;
      const float* rw = reinterpret_cast<const float*>(r) + Stage<D>::W;
      const float4 q0 = r[0];
      float w = rw[o[0]];
      for (int d = 1; d < D; ++d) w = w * rw[3 * d + o[d]];
      float dpos[D];
      for (int d = 0; d < D; ++d) dpos[d] = static_cast<float>(o[d] - 1) - comp(q0, d);
      *cell = reinterpret_cast<const int*>(r + 1 + D)[0];
      if (!P2G2 && c == 0) return w * comp(q0, D);
      const float4 qi = r[1 + i];
      float f = comp(qi, 0) * dpos[0];
      for (int j = 1; j < D; ++j) f = f + comp(qi, j) * dpos[j];
      return P2G2 ? w * f : (w * comp(q0, D)) * (comp(qi, D) + f);
    };
    // two particles' values at a time, their adds in slot order; the parts
    // differ in length by at most one, so the warp steps together
    int s = 0;
    for (; s + 1 < steps; s += 2) {
      const bool on0 = on && (SPLIT == 1 || s < len);
      const bool on1 = on && (SPLIT == 1 || s + 1 < len);
      int cell0 = 0, cell1 = 0;
      float val0 = 0.0f, val1 = 0.0f;
      if (on0) val0 = tap_value(s, &cell0);
      if (on1) val1 = tap_value(s + 1, &cell1);
      if (on0) wc[cell0] = wc[cell0] + val0;
      __syncwarp();
      if (on1) wc[cell1] = wc[cell1] + val1;
      __syncwarp();
    }
    if (s < steps) {
      if (on && (SPLIT == 1 || s < len)) {
        int cell;
        const float val = tap_value(s, &cell);
        wc[cell] = wc[cell] + val;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < CH * g.ncell; i += blockDim.x) {
    const int c = div_by(i, g.divN);
    int ec[D];
    window_coords<D>(i - c * g.ncell, g, ec);
    int cell = c * g.wch;
    for (int d = 0; d < D; ++d) cell += ec[d] * g.wstride[d];
    float acc = win[cell];
    for (int p = 1; p < SPLIT; ++p) acc = acc + win[p * CH * g.wch + cell];
    out[i] = P2G2 ? acc + d1[g.ncell + i] : acc;
  }
}

// The same deposit for a tile of more than one chunk (cap > CHUNK_MAX):
// window_clear after the first chunk's staging, window_walk for each chunk
// in slot order, window_store after the last.  A chunk's walk takes each
// part's slots that the chunk holds, so every (part, channel) window sums
// its particles in slot order from 0.0f, as deposit_window's walk does.
// deposit_window stays the one-chunk path: at the 1M shape, cap 128, K2
// through window_walk measured 0.324-0.341 ms against 0.309-0.317 ms
// through deposit_window (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py's
// kernels phase, the two in turns in each call): the compiled walk
// recomputed the window's shared-memory base before every add.
template <int NV>
__device__ __forceinline__ void window_clear(const Geom& g, float* win) {
  for (int i = threadIdx.x; i < NV * g.wch; i += blockDim.x) win[i] = 0.0f;
}

// Deposits the chunk of slots [c0, c0 + cn) of the tile's cnt, staged as
// records 0 .. cn - 1.  Every thread of the block calls it after the
// __syncthreads that follows the chunk's staging and window_clear.
template <int D, bool P2G2, int SPLIT>
__device__ void window_walk(const Stage<D>& sh, const Geom& g, int cnt, int c0, int cn,
                            float* win) {
  constexpr int CH = P2G2 ? D : 1 + D;
  constexpr int NV = SPLIT * CH;      // (part, channel) windows
  constexpr int K = D == 3 ? 27 : 9;  // taps
  constexpr int G = 32 / K;           // channels per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;

  const int k = lane % K, sub = lane / K;
  int o[D];
  int tap = 0;
  {
    int r = k;
    for (int d = 0; d < D; ++d) {  // stencil order, axis 0 fastest
      o[d] = r % 3;
      r /= 3;
      tap += o[d] * g.wstride[d];
    }
  }
  const int steps = (cnt + SPLIT - 1) / SPLIT;  // particles per part
  // the walk's length, the same for every warp: the longest part's share
  // of this chunk (one part: the chunk)
  int walk = cn;
  if (SPLIT > 1) {
    walk = 0;
    for (int p = 0; p < SPLIT; ++p) {
      const int lo = max(p * steps, c0), hi = min(min((p + 1) * steps, cnt), c0 + cn);
      walk = max(walk, hi - lo);
    }
  }
  for (int v0 = warp * G; v0 < NV; v0 += nwarp * G) {  // uniform over the warp
    const int vc = v0 + sub;
    const bool on = sub < G && vc < NV;
    const int c = vc % CH;
    // this lane's part's slots in the chunk: records first .. first + len - 1
    // (one part: every record of the chunk, len == walk)
    const int lo = max(vc / CH * steps, c0);
    const int len = min(min(vc / CH * steps + steps, cnt), c0 + cn) - lo;
    const int first = lo - c0;
    float* wc = win + vc * g.wch + tap;
    const int i = P2G2 ? c : c - 1;  // the row of C (and v) this lane's channel reads
    // this lane's value of record first + s and the cell it lands in
    auto tap_value = [&](int s, int* cell) {
      const float4* r = sh.q + (first + s) * Stage<D>::RQ;
      const float* rw = reinterpret_cast<const float*>(r) + Stage<D>::W;
      const float4 q0 = r[0];
      float w = rw[o[0]];
      for (int d = 1; d < D; ++d) w = w * rw[3 * d + o[d]];
      float dpos[D];
      for (int d = 0; d < D; ++d) dpos[d] = static_cast<float>(o[d] - 1) - comp(q0, d);
      *cell = reinterpret_cast<const int*>(r + 1 + D)[0];
      if (!P2G2 && c == 0) return w * comp(q0, D);
      const float4 qi = r[1 + i];
      float f = comp(qi, 0) * dpos[0];
      for (int j = 1; j < D; ++j) f = f + comp(qi, j) * dpos[j];
      return P2G2 ? w * f : (w * comp(q0, D)) * (comp(qi, D) + f);
    };
    // two particles' values at a time, their adds in slot order; the parts'
    // shares differ in length, so the warp steps to the longest and a lane
    // past its own share adds nothing
    int s = 0;
    for (; s + 1 < walk; s += 2) {
      const bool on0 = on && (SPLIT == 1 || s < len);
      const bool on1 = on && (SPLIT == 1 || s + 1 < len);
      int cell0 = 0, cell1 = 0;
      float val0 = 0.0f, val1 = 0.0f;
      if (on0) val0 = tap_value(s, &cell0);
      if (on1) val1 = tap_value(s + 1, &cell1);
      if (on0) wc[cell0] = wc[cell0] + val0;
      __syncwarp();
      if (on1) wc[cell1] = wc[cell1] + val1;
      __syncwarp();
    }
    if (s < walk) {
      if (on && (SPLIT == 1 || s < len)) {
        int cell;
        const float val = tap_value(s, &cell);
        wc[cell] = wc[cell] + val;
      }
      __syncwarp();
    }
  }
}

// Writes the windows out after the last walk (and a __syncthreads).
template <int D, bool P2G2, int SPLIT = 1>
__device__ void window_store(const Geom& g, const float* win, float* __restrict__ out,
                             const float* __restrict__ d1) {
  constexpr int CH = P2G2 ? D : 1 + D;
  for (int i = threadIdx.x; i < CH * g.ncell; i += blockDim.x) {
    const int c = div_by(i, g.divN);
    int ec[D];
    window_coords<D>(i - c * g.ncell, g, ec);
    int cell = c * g.wch;
    for (int d = 0; d < D; ++d) cell += ec[d] * g.wstride[d];
    float acc = win[cell];
    for (int p = 1; p < SPLIT; ++p) acc = acc + win[p * CH * g.wch + cell];
    out[i] = P2G2 ? acc + d1[g.ncell + i] : acc;
  }
}

// deposit_kernel — replaces make_deposit_kernel (stream_transfer.py:676),
// modes p2g1 and p2g2.
//
// Bound: by the layout, an occupied 3D tile reads its stream block
// (F*cap*4 = 9.7 KB) and, for p2g2, the halo'd mass and p2g1 windows
// (10 KB), and writes (1+D) or D windows of E^3 = 512 cells (8 KB / 6 KB).
// At the 1M-particle shape (32,768 entries, 17,554 occupied) on an NVIDIA
// H100 80GB HBM3 (700 W), chip_smoke.py measured 0.27 ms (p2g1) and 0.30
// ms (p2g2), ~4.3x and ~2.9x the byte bound of the occupied tiles: the
// limit is the serial walk over a tile's ~57 particles in each warp (a
// cell-owner scan as the deposit was over twice as slow).
// Every intermediate (stencils, values, the window) stays in shared memory
// and each output cell is written once, with no atomics.
//
// p2g2 additionally gathers each particle's density from the halo'd mass
// window (3^D taps), then its Tait pressure (with the floor), volume and
// eq-16 term -4 dt V (-p I + mu (C + C^T)), which it stages as the
// record's C rows.  Its walk is split in two (P2G2_SPLIT): a warp per
// channel and half of the tile's particles, six warps in 3D (192 threads,
// block_threads), each into its own partial window.  Measured at the 1M
// shape (same card, chip_smoke.py): 0.311-0.313 ms against 0.318-0.320 ms
// for one warp per channel, not the halving a walk of half the length
// would give: the walk is bound by the instructions the SM issues, not by
// the length of one warp's walk, and the split issues as many.  A lane
// depositing its tap into all D channels, with one warp per half, issues
// fewer but hides less latency (0.37-0.39 ms); a copy of the mass window
// in shared memory for the gather was slower with the split.
// params: [dt, rest_density, eos_stiffness, eos_power, pressure_floor, mu].
constexpr int P2G2_SPLIT = 2;
//
// MULTI: the instantiation for cap > CHUNK_MAX, which stages and walks one
// chunk of slots after the other (window_walk); a launch at cap <=
// CHUNK_MAX takes the one-chunk instantiation, which stages every slot and
// runs deposit_window.  At bench.py's big-tile spec on the 1M dam (T=8,
// cap 1024, A = 4,096, 2,197 occupied tiles of up to 590 particles, three
// chunks) K1 took 0.351-0.378 ms and K2 0.526-0.548 ms (same card,
// chip_smoke.py), 6.6x and 8.3x their byte bounds: each walking warp
// steps through ~450 particles of its tile, and three blocks fit an SM
// (68.7 KB of shared memory for p2g1) where seven fit at T=4, cap 128.
template <int D, bool P2G2, bool MULTI>
__device__ __forceinline__ void deposit_tile(const Geom& g, int a, const int* __restrict__ count,
                                             const int* __restrict__ tidv,
                                             const float* __restrict__ stream,
                                             const float* __restrict__ hs_m,
                                             const float* __restrict__ d1,
                                             const float* __restrict__ params,
                                             float* __restrict__ out, float* smem) {
  constexpr int CH = P2G2 ? D : 1 + D;
  constexpr int SPLIT = P2G2 ? P2G2_SPLIT : 1;
  const int cap = g.cap;
  const int cnt = count[a];
  float* tile_out = out + static_cast<int64_t>(a) * CH * g.ncell;
  if (cnt == 0) {
    for (int i = threadIdx.x; i < CH * g.ncell; i += blockDim.x) tile_out[i] = 0.0f;
    return;
  }
  int corner[D];
  mpm::scene_corner<D>(tidv[a], g.T, g.tshape, g.origin, g.sx, corner);
  const Stage<D> sh(smem);
  float* win = smem + Stage<D>::words_per_slot() * g.chunk;
  const float* blk = stream + static_cast<int64_t>(a) * g.F * cap;
  // stages the chunk of slots [c0, c0 + cn) as records 0 .. cn - 1
  auto stage = [&](int c0, int cn) {
    const int r = threadIdx.x, s = c0 + r;  // record, slot
    if (r < cn) {
      float pos[D], C[D * D];
      for (int d = 0; d < D; ++d) pos[d] = blk[d * cap + s];
      for (int ij = 0; ij < D * D; ++ij) C[ij] = blk[(2 * D + ij) * cap + s];
      const Stencil<D> st = stencil_of<D>(g, corner, pos);
      const float mass = blk[(2 * D + D * D) * cap + s];
      if (!P2G2) {
        float v[D];
        for (int i = 0; i < D; ++i) v[i] = blk[(D + i) * cap + s];
        sh.store(r, st, mass, v, C);
      } else {
        // density gather from the halo'd mass window, taps in stencil order
        const float* mw = hs_m + static_cast<int64_t>(a) * g.ncell;
        float rho = 0.0f;
        for_taps<D>(st, g, [&](float w, int e, const float*) { rho = rho + w * mw[e]; });
        const float dt = params[0], rest = params[1], k_eos = params[2];
        const float gamma = params[3], floor_p = params[4], mu = params[5];
        const float volume = rho > 0.0f ? mass / rho : 0.0f;
        const float pressure = mpm::tait_pressure(rho, rest, k_eos, gamma, floor_p);
        const float scale = (-4.0f * dt) * volume;
        float term[D * D];
        for (int i = 0; i < D; ++i) {
          for (int j = 0; j < D; ++j) {
            const float visc = mu * (C[i * D + j] + C[j * D + i]);
            term[i * D + j] = scale * (i == j ? -pressure + visc : visc);
          }
        }
        sh.store(r, st, mass, nullptr, term);
      }
    }
  };
  const float* d1a = P2G2 ? d1 + static_cast<int64_t>(a) * (1 + D) * g.ncell : nullptr;
  if constexpr (!MULTI) {
    stage(0, cnt);
    __syncthreads();
    deposit_window<D, P2G2, SPLIT>(sh, g, cnt, win, tile_out, d1a);
  } else {
    for (int c0 = 0; c0 < cnt; c0 += g.chunk) {
      const int cn = min(g.chunk, cnt - c0);
      stage(c0, cn);
      __syncthreads();
      if (c0 == 0) {
        window_clear<SPLIT * CH>(g, win);
        __syncthreads();
      }
      window_walk<D, P2G2, SPLIT>(sh, g, cnt, c0, cn, win);
      __syncthreads();  // the walk has read the stage before the next chunk
    }
    window_store<D, P2G2, SPLIT>(g, win, tile_out, d1a);
  }
}

// Block b deposits the tiles b and b + gridDim.x that lie below `occupied`
// (entry_bound), one after the other, over a grid of ceil(A /
// TILES_PER_BLOCK) blocks.  At the batch shape (A = 110,000, 22k occupied)
// on an NVIDIA H100 80GB HBM3 (700 W) one block per entry spent 47 us of
// K2's 0.31 ms on the 88k blocks past the count (chip_smoke.py); two tiles
// a block take K2 to 0.26 ms, within 4% of the launch over the occupied
// entries alone, and cost nothing on the 1M dam.  The two bodies are
// inlined one after the other: as a loop K2 takes 64 registers to 56 and
// is 4% slower at 1M.  The grid of blocks the card holds, each striding
// over every tile below the count, was 6-13% slower at 1M: a block's
// fixed share of tiles leaves the tail unbalanced.
template <int D, bool P2G2, bool MULTI>
__global__ void deposit_kernel(Geom g, const int* __restrict__ occupied,
                               const int* __restrict__ count,
                               const int* __restrict__ tidv,
                               const float* __restrict__ stream,
                               const float* __restrict__ hs_m,
                               const float* __restrict__ d1,
                               const float* __restrict__ params,
                               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int bound = entry_bound(occupied, g.A), grid = gridDim.x;
#pragma unroll
  for (int i = 0; i < TILES_PER_BLOCK; ++i) {
    const int a = blockIdx.x + i * grid;
    if (a >= bound) break;
    if (i > 0) __syncthreads();  // the next tile reuses the shared memory
    deposit_tile<D, P2G2, MULTI>(g, a, count, tidv, stream, hs_m, d1, params, out, smem);
  }
}

// collect_kernel — replaces make_collect_kernel (stream_transfer.py:1163).
//
// One thread per live slot of a chunk, chunk after chunk up to the tile's
// count: g2p from the tile's grid-value window gblk [1+D, E^D] (v rows,
// then mass): v = sum w gv, B = sum w gv (x) dpos, C = 4B, rho = sum w m;
// pressure; then the particle tail: advect, the mouse impulse after
// advection (quirk Q3), clamp and the un-scaled soft wall (quirk Q2) at the
// configuration's walls, and the drift flag (2.0 when the new cell leaves
// [1-h, T-2+h]).  A packed scene's particles are in its own coordinates:
// its walls are the configuration's, and its offset is in the tile's
// corner (scene_corner).  A live slot's thread reads its
// slot's fields, then writes the new ones and the flag into out_stream and
// flag.  out_stream may be stream itself: the frame updates its state in
// place, and no other thread touches the slot.  Slots past the count are
// not touched (they hold zeros in every stream the port keeps), so a
// caller that wants a new buffer passes one filled with zeros.  A tile of
// count 0 below the bound (a launch with no `occupied`) writes only its
// zero p2g1 windows.
// It also deposits the next substep's p2g1 windows from the updated
// particles (the walk of deposit_kernel<D, false>): a tile of one chunk
// through deposit_window, a longer one chunk by chunk through window_walk,
// both in slot order, so the windows do not depend on the chunking.
//
// The chunk is COLLECT_CHUNK slots at most, whatever the cap, so a block's
// threads and stage do not grow with the cap: at cap 256 a block takes
// 128 threads and 31.3 KB (3D), seven blocks and 28 walking warps an SM,
// where a chunk of 256 took 256 threads and 49.7 KB, three blocks (by
// registers) and 12 walking warps.
//
// Bound: by the layout, per occupied tile it reads the live slots' position,
// mass and id (20 B a particle in 3D) and the gblk window (8 KB, 27 taps
// per particle, within one 8 KB block so they hit L1/L2) and writes the
// live rows (76 B a particle) and flags and 8 KB of windows: ~0.36 GB per
// call on the 1M dam after 40 frames (15,872 occupied of 32,768 entries),
// where writing every slot at cap 256 would make it ~1.1 GB.  Measured
// there on an NVIDIA H100 80GB HBM3 (700 W), in a graph: 0.37 ms at cap
// 256, ~3.5x the byte bound.  Writing every slot through a chunk of
// min(cap, 256) was 16% slower at cap 128 and twice as slow at cap 256
// (seven and three blocks an SM); at cap 256 a chunk of 64 (ten blocks of
// two warps) and window_walk for every tile were ~10% slower.  One
// instantiation serves every cap: a second one for cap <= COLLECT_CHUNK,
// without the chunk-by-chunk branch (64 registers, not 72), was ~4% slower
// at cap 128.  What is left is the walk, bound by the instructions the SM
// issues, as in deposit_kernel.
//
// params: [dt, rest, k, gamma, floor, mouse_radius, damp, mouse_active,
//          mouse_x, mouse_y, lo[D], hi[D]].
template <int D>
__device__ __forceinline__ void collect_tile(const Geom& g, int a, const int* __restrict__ count,
                                             const int* __restrict__ tidv,
                                             const float* __restrict__ params,
                                             const float* stream,
                                             const float* __restrict__ gblk,
                                             float* out_stream,
                                             float* __restrict__ flag,
                                             float* __restrict__ dep, float* smem) {
  const int cap = g.cap, F = g.F;
  const int cnt = count[a];
  float* tile_dep = dep + static_cast<int64_t>(a) * (1 + D) * g.ncell;
  if (cnt == 0) {
    for (int i = threadIdx.x; i < (1 + D) * g.ncell; i += blockDim.x) tile_dep[i] = 0.0f;
    return;
  }
  const float* blk = stream + static_cast<int64_t>(a) * F * cap;
  float* oblk = out_stream + static_cast<int64_t>(a) * F * cap;
  float* tflag = flag + static_cast<int64_t>(a) * cap;
  int corner[D];
  mpm::scene_corner<D>(tidv[a], g.T, g.tshape, g.origin, g.sx, corner);
  const Stage<D> sh(smem);
  float* win = smem + Stage<D>::words_per_slot() * g.chunk;
  for (int c0 = 0; c0 < cnt; c0 += g.chunk) {  // blockDim.x == g.chunk
    const int s = c0 + threadIdx.x;
    const bool valid = s < cnt;
    float newpos[D], v[D], newC[D * D];
    float mass = 0.0f;
    if (valid) {
      float pos[D];
      for (int d = 0; d < D; ++d) pos[d] = blk[d * cap + s];
      const Stencil<D> st = stencil_of<D>(g, corner, pos);
      const float* gw = gblk + static_cast<int64_t>(a) * (1 + D) * g.ncell;
      float B[D][D];
      for (int i = 0; i < D; ++i) {
        v[i] = 0.0f;
        for (int j = 0; j < D; ++j) B[i][j] = 0.0f;
      }
      float rho = 0.0f;
      for_taps<D>(st, g, [&](float w, int e, const float* dpos) {
        for (int i = 0; i < D; ++i) {
          const float wv = w * gw[i * g.ncell + e];
          v[i] = v[i] + wv;
          for (int j = 0; j < D; ++j) B[i][j] = B[i][j] + wv * dpos[j];
        }
        rho = rho + w * gw[D * g.ncell + e];
      });
      for (int i = 0; i < D; ++i)
        for (int j = 0; j < D; ++j) newC[i * D + j] = 4.0f * B[i][j];

      const float dt = params[0];
      const float pressure = mpm::tait_pressure(rho, params[1], params[2], params[3], params[4]);
      for (int d = 0; d < D; ++d) newpos[d] = pos[d] + v[d] * dt;
      mpm::particle_tail<D>(newpos, v, params);

      // drift flag: the next deposit must stay inside the tile's window
      float fl = 0.0f;
      for (int d = 0; d < D; ++d) {
        const int lcn = mpm::local_cell(floorf(newpos[d]), corner[d]);
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
      tflag[s] = fl;
    }
    // stage the chunk's updated particles, then walk them
    if (valid) sh.store(threadIdx.x, stencil_of<D>(g, corner, newpos), mass, v, newC);
    __syncthreads();
    if (cnt <= g.chunk) {  // the whole tile in one chunk
      deposit_window<D, false>(sh, g, cnt, win, tile_dep, nullptr);
      return;
    }
    if (c0 == 0) {
      window_clear<1 + D>(g, win);
      __syncthreads();
    }
    window_walk<D, false, 1>(sh, g, cnt, c0, min(g.chunk, cnt - c0), win);
    __syncthreads();  // the walk has read the stage before the next chunk
  }
  window_store<D, false>(g, win, tile_dep, nullptr);
}

// Block b takes the tiles b and b + gridDim.x below `occupied`, as
// deposit_kernel's, in a loop: its two bodies inlined took 96 registers to
// 64 and were 10% slower at 1M.
template <int D>
__global__ void collect_kernel(Geom g, const int* __restrict__ occupied,
                               const int* __restrict__ count,
                               const int* __restrict__ tidv,
                               const float* __restrict__ params,
                               const float* stream,
                               const float* __restrict__ gblk,
                               float* out_stream,
                               float* __restrict__ flag,
                               float* __restrict__ dep) {
  extern __shared__ __align__(16) float smem[];
  const int bound = entry_bound(occupied, g.A), grid = gridDim.x;
#pragma unroll 1
  for (int a = blockIdx.x; a < bound; a += grid) {
    collect_tile<D>(g, a, count, tidv, params, stream, gblk, out_stream, flag, dep, smem);
    __syncthreads();  // the next tile reuses the shared memory
  }
}

// Halo windows overlap by E - T = 2h cells along each axis.  One pass along
// axis k adds the +1 neighbour's window shifted by -T*stride_k into the
// cells e_k >= T, and the -1 neighbour's shifted by +T*stride_k into the
// cells e_k < E - T; a neighbour index == A reads as zero.  Both
// directions read the pass input.
//
// The NP = D passes chained, as one tree per output cell.  The value
// after pass k at (tile t, cell c) is
//   (v_k(t, c) + [c_k >= T] v_k(p_k(t), c - T s_k)) + [c_k < E-T] v_k(m_k(t), c + T s_k)
// with v_0 the gated input; a masked term and a tile A add 0.0f.  Its
// leaves are raw input reads at the end of a route of neighbour tiles; a
// thread evaluates the tree in the passes' order, so the result is
// bit-identical to the chained passes.  Node n's children are 3n (own),
// 3n+1 (+ neighbour) and 3n+2 (- neighbour), the top level is the last
// pass: leaf n's base-3 digit l (level 0 = the first pass, least
// significant) names the neighbour taken at level l.

struct HaloLevels {
  FastDiv stride[3];  // per level, first pass first: / the axis's cell stride
  int sh[3];          // per level: T * that stride
};

// The grid update that halo_gblk applies to the m+f halo sums of a cell:
// v_c = mf_c / m + dtg_c where m > 0, else 0, then the mass row m.
struct GridUpdate {
  const float* hs_m;  // halo'd mass windows [A, 1, E^D]
  float dtg[3];       // dt * gravity, per axis
};

// Resolves the leaf routes of tiles [a0, a0 + tpb) through the face tables
// nbr [2D, A] into shared memory, [tpb][3^NP]: a route through a missing
// neighbour, or ending at a zero-count tile (the occupancy gate), is A, and
// so is every route of a tile at or past `bound` (entry_bound).  Leaf 0 is
// the tile itself: A there means the tile holds no particle.
template <int NP>
__device__ __forceinline__ void halo_routes(int* route, const int* __restrict__ count,
                                            const int* __restrict__ nbr, int A, int bound,
                                            int tpb, int a0) {
  constexpr int K = pow3(NP);
  for (int i = threadIdx.x; i < tpb * K; i += blockDim.x) {
    const int j = i / K, leaf = i - j * K;
    int t = a0 + j < bound ? a0 + j : A;
    int digit_of = K;
    for (int l = NP - 1; l >= 0; --l) {  // the top level (last pass) first
      digit_of /= 3;
      const int digit = (leaf / digit_of) % 3;
      if (digit != 0 && t < A) t = nbr[static_cast<int64_t>(2 * l + digit - 1) * A + t];
    }
    route[i] = t < A && count[t] > 0 ? t : A;
  }
}

// halo_axes_kernel — replaces _make_halo_axis (stream_transfer.py:2006),
// all NP = D of its passes chained in one launch, for the window geometry
// of every stream spec the port builds, E = 2T (h = T/2).  There one of a level's
// two masks is always on: a cell's tree has 2^NP leaves, leaf b taking the
// neighbour at level l where bit l is set, and a level sums as
// (own + nb) + 0.0f or (own + 0.0f) + nb.  The input is read as
// where(count > 0, x, 0), the occupancy gate of the JAX stages, so no
// zero-count tile's window is read.
//
// Layout: 128 threads per block over `tpb` tiles of 2048 cells in all (3D:
// four tiles, 2D: thirty-two), in rounds of CPT cells per thread (four; two
// where CH x 2^NP passes 16), CH channels: a thread issues the
// CPT x CH x 2^NP leaf loads of a round before its first add, so it waits
// on memory once per round.  The block first
// resolves its tiles' routes into shared memory (halo_routes), so no
// thread walks the tables, and the dependent table reads of four tiles
// overlap (with fewer tiles per block the route reads stay exposed, with
// more the rounds serialise); cell coordinates come from multiply-high
// divisions.  Own leaves are coalesced
// reads of the tile's window; neighbour leaves read windows that nearby
// blocks read too, mostly from L2.
//
// Bound: bytes, each occupied input window read once and each output
// window below the count written once: at the 1M shape (32,768 entries,
// 17,554 occupied) 36 + 36 MB for the mass launch.  Measured there on an
// NVIDIA H100 80GB HBM3 (700 W) by chip_smoke.py: 0.07 ms (mass, 3
// passes), ~3.4x that bound; one separate launch per pass was three times
// slower.  It waits on its routes (three dependent table reads per tile)
// more than on bytes.
//
// halo_axes_kernel<D, D, true> (GBLK) — replaces _make_halo_gblk
// (stream_transfer.py:1882) with the D - 1 _make_halo_axis passes ahead of
// it, as the port's halo_gblk: all D
// passes of the m+f halo (NP = CH = D) and the grid update as an epilogue
// before the one write, grid-value windows [A, 1+D, E^D] (the D v rows,
// then the halo'd mass).  A tile with count 0 below the bound (a launch
// with no `occupied`: the sharded path) writes zeros and reads no window;
// a block of such tiles writes its zeros and returns before resolving
// routes.  On the frame's path those tiles lie past `occupied`.  Bound:
// bytes, the occupied m+f and mass windows read once and each output
// window below the count written once: 108 + 36 + 144 MB at the 1M shape,
// 0.086 ms; measured 0.19 ms (same card, chip_smoke.py), ~2.2x.  The two
// launches it replaces (the D-1-pass m+f halo, then the last pass fused
// with the update by one thread per output value, 64-bit index divisions
// and every tile) wrote and read back the m+f windows in between, and took
// 2.5 times as long.
// A block's tiles at or past the bound (entry_bound) are not written, and
// a block with none below it returns at once.
template <int NP, int CH, bool GBLK>
__global__ void __launch_bounds__(128) halo_axes_kernel(
    const float* __restrict__ x, const int* __restrict__ occupied, const int* __restrict__ count,
    const int* __restrict__ nbr, float* __restrict__ out, int A, int ncell, int E, int T, int tpb,
    FastDiv divN, FastDiv divE, HaloLevels lv, GridUpdate up) {
  extern __shared__ int route[];  // [tpb][3^NP]
  constexpr int K = pow3(NP), B = 1 << NP, CPT = CH * B > 16 ? 2 : 4;
  const int a0 = blockIdx.x * tpb, bound = entry_bound(occupied, A);
  if (a0 >= bound) return;
  const int row = CH * ncell;  // element offsets fit 32 bits (checked at launch)
  const int orow = GBLK ? row + ncell : row;
  if (GBLK) {
    bool live = false;
    for (int j = threadIdx.x; j < tpb; j += blockDim.x) live |= a0 + j < bound && count[a0 + j] > 0;
    if (!__syncthreads_or(live)) {
      const int n = (bound - a0 < tpb ? bound - a0 : tpb) * orow;
      for (int i = threadIdx.x; i < n; i += blockDim.x) out[a0 * orow + i] = 0.0f;
      return;
    }
  }
  halo_routes<NP>(route, count, nbr, A, bound, tpb, a0);
  __syncthreads();
  for (int base = 0; base < tpb * ncell; base += CPT * 128) {
    float v[CPT][CH][B];
    float m[CPT];    // GBLK: the cell's halo'd mass
    int minus[CPT];  // bit l: the level-l neighbour is the - one
    bool ok[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      const int it = base + u * 128 + threadIdx.x;
      const int j = div_by(it, divN), e = it - j * ncell;
      ok[u] = it < tpb * ncell && a0 + j < bound;
      int off[B], leaf[B];
#pragma unroll
      for (int b = 0; b < B; ++b) off[b] = leaf[b] = 0;
      int mbits = 0, digit = 1;
#pragma unroll
      for (int l = 0; l < NP; ++l) {
        const int q = div_by(e, lv.stride[l]);
        const bool mk = q - div_by(q, divE) * E < E - T;
        mbits |= mk ? 1 << l : 0;
#pragma unroll
        for (int b = 0; b < B; ++b) {
          if (b & (1 << l)) {
            off[b] += mk ? lv.sh[l] : -lv.sh[l];
            leaf[b] += (mk ? 2 : 1) * digit;
          }
        }
        digit *= 3;
      }
      minus[u] = mbits;
      const int* rt = route + (ok[u] ? j : 0) * K;
      // GBLK: a zero-count tile reads nothing (its own route is A)
      const bool live = ok[u] && (!GBLK || rt[0] < A);
      if (GBLK) m[u] = live ? up.hs_m[(a0 + j) * ncell + e] : 0.0f;
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int t = rt[leaf[b]];
        const bool on = live && t < A;
#pragma unroll
        for (int c = 0; c < CH; ++c) v[u][c][b] = on ? x[t * row + c * ncell + e + off[b]] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
#pragma unroll
        for (int l = 0; l < NP; ++l) {  // first pass first; pairs differ in bit l
          const bool mk = minus[u] & (1 << l);
#pragma unroll
          for (int b = 0; b < (B >> (l + 1)); ++b) {
            const float own = v[u][c][2 * b], nb = v[u][c][2 * b + 1];
            v[u][c][b] = mk ? (own + 0.0f) + nb : (own + nb) + 0.0f;
          }
        }
        if (ok[u]) {
          const int it = base + u * 128 + threadIdx.x;
          const int j = div_by(it, divN);
          const int o = (a0 + j) * orow + c * ncell + it - j * ncell;
          if (GBLK) {
            out[o] = m[u] > 0.0f ? v[u][c][0] / m[u] + up.dtg[c] : 0.0f;
            if (c == CH - 1) out[o + ncell] = m[u];  // the mass row
          } else {
            out[o] = v[u][c][0];
          }
        }
      }
    }
  }
}

// The same passes for any other window geometry (E != 2T, where a level
// may add both neighbours or neither) or channel count: one cell at a time,
// the tree walked recursively over all 3^NP leaves; GBLK as above.
struct HaloCell {
  const float* x;    // input rows at this thread's channel
  const int* route;  // the tile's leaf tiles [3^NP] (shared), A = reads 0
  int64_t row;       // floats per tile (CH * E^D)
  int A, T, E;
  int ek[3];  // per level: the cell's coordinate on the level's axis
  int sh[3];  // per level: T * the axis's cell stride
};

template <int LV>
__device__ __forceinline__ float halo_tree(const HaloCell& c, int node, int e) {
  if constexpr (LV == 0) {
    const int t = c.route[node];
    return t < c.A ? c.x[t * c.row + e] : 0.0f;
  } else {
    constexpr int lv = LV - 1;
    float acc = halo_tree<LV - 1>(c, 3 * node, e);
    const float yp = c.ek[lv] >= c.T ? halo_tree<LV - 1>(c, 3 * node + 1, e - c.sh[lv]) : 0.0f;
    acc = acc + yp;
    const float ym = c.ek[lv] < c.E - c.T ? halo_tree<LV - 1>(c, 3 * node + 2, e + c.sh[lv]) : 0.0f;
    return acc + ym;
  }
}

template <int NP, bool GBLK>
__global__ void __launch_bounds__(128) halo_axes_any_kernel(
    const float* __restrict__ x, const int* __restrict__ occupied, const int* __restrict__ count,
    const int* __restrict__ nbr, float* __restrict__ out, int A, int CH, int ncell, int E, int T,
    int tpb, FastDiv divN, FastDiv divE, HaloLevels lv, GridUpdate up) {
  extern __shared__ int route[];  // [tpb][3^NP]
  constexpr int K = pow3(NP);
  const int a0 = blockIdx.x * tpb, bound = entry_bound(occupied, A);
  if (a0 >= bound) return;
  halo_routes<NP>(route, count, nbr, A, bound, tpb, a0);
  __syncthreads();
  for (int it = threadIdx.x; it < tpb * ncell; it += blockDim.x) {
    const int j = div_by(it, divN), e = it - j * ncell;
    const int a = a0 + j;
    if (a >= bound) break;
    HaloCell c;
    c.route = route + j * K;
    c.row = static_cast<int64_t>(CH) * ncell;
    c.A = A;
    c.T = T;
    c.E = E;
#pragma unroll
    for (int l = 0; l < NP; ++l) {
      const int q = div_by(e, lv.stride[l]);
      c.ek[l] = q - div_by(q, divE) * E;
      c.sh[l] = lv.sh[l];
    }
    const bool live = !GBLK || c.route[0] < A;
    const float m = GBLK && live ? up.hs_m[static_cast<int64_t>(a) * ncell + e] : 0.0f;
    float* o = out + a * (c.row + (GBLK ? ncell : 0)) + e;
    for (int ch = 0; ch < CH; ++ch) {
      c.x = x + ch * ncell;
      const float mf = live ? halo_tree<NP>(c, 0, e) : 0.0f;
      o[ch * ncell] = GBLK ? (m > 0.0f ? mf / m + up.dtg[ch] : 0.0f) : mf;
    }
    if (GBLK) o[CH * ncell] = m;
  }
}

Geom make_geom(int dim, int A, int T, int h, int cap, const int* tshape, const int* origin,
               int sx) {
  Geom g;
  g.A = A;
  g.T = T;
  g.h = h;
  g.E = T + 2 * h;
  g.cap = cap;
  g.chunk = cap < CHUNK_MAX ? cap : CHUNK_MAX;
  g.ncell = 1;
  for (int d = 0; d < dim; ++d) g.ncell *= g.E;
  g.F = 2 * dim + dim * dim + 4;
  for (int d = 0; d < 3; ++d) {
    g.tshape[d] = d < dim ? tshape[d] : 1;
    g.origin[d] = d < dim ? origin[d] : 0;
  }
  g.sx = sx;
  g.divE = fast_div(g.E);
  g.divN = fast_div(g.ncell);
  // padded window strides: lines E + 1 apart, planes and channels 3 banks
  // apart modulo 32, so the 27 (or 3 x 9) taps of a warp hit distinct banks
  auto pad3 = [](int x) { return x + ((3 - x) % 32 + 32) % 32; };
  for (int d = 0; d < 3; ++d) g.wstride[d] = 0;
  g.wstride[dim - 1] = 1;
  if (dim >= 2) g.wstride[dim - 2] = g.E + 1;
  if (dim >= 3) g.wstride[0] = pad3(g.E * g.wstride[1]);
  g.wch = pad3(g.E * g.wstride[0]);
  return g;
}

// Dynamic shared memory of a deposit or collect block: one chunk's stage,
// then the deposit window of `nwin` channels (p2g2: its P2G2_SPLIT partial
// windows).
template <int D>
size_t block_bytes(const Geom& g, int nwin) {
  return (static_cast<size_t>(Stage<D>::words_per_slot()) * g.chunk + nwin * g.wch) *
         sizeof(float);
}

// Threads of a deposit or collect block: one per slot of a chunk, and for
// p2g2 at least one warp per (part, channel) window of its walk.
template <int D>
int block_threads(const Geom& g, bool p2g2) {
  constexpr int G = 32 / (D == 3 ? 27 : 9);  // channels per warp
  const int warps = (P2G2_SPLIT * D + G - 1) / G;
  return p2g2 && 32 * warps > g.chunk ? 32 * warps : g.chunk;
}

// Launches `kernel` on `blocks` blocks.  Past the 48 KB of shared memory a
// launch gets by default the kernel is first opted into `smem`; a size the
// card cannot give returns that call's error.
template <typename... P, typename... Args>
int launch_blocks(void (*kernel)(P...), unsigned int blocks, int threads, size_t smem,
                  cudaStream_t st, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, threads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Launches a deposit or collect kernel, TILES_PER_BLOCK tiles a block, with
// `smem` bytes of dynamic shared memory (3D at a chunk of 256 slots, or
// wider windows, past 48 KB); a cap that is not a positive multiple of 32
// returns an error.
template <typename... P, typename... Args>
int launch_tiles(void (*kernel)(Geom, P...), const Geom& g, int threads, size_t smem,
                 cudaStream_t st, Args... args) {
  if (g.cap <= 0 || g.cap % 32) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = static_cast<unsigned int>((g.A + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK);
  return launch_blocks(kernel, blocks, threads, smem, st, g, args...);
}

// The dim halo passes over windows [A, CH, E^dim] in one launch of
// halo_axes_kernel (E = 2T, the substep's channel counts) or
// halo_axes_any_kernel (every other call); GBLK with the grid update.
template <bool GBLK>
int launch_halo(const float* x, const int* occupied, const int* count, const int* nbr,
                float* out, int A, int CH, int dim, int E, int T, GridUpdate up,
                cudaStream_t st) {
  if (dim < 2 || dim > 3 || CH < 1) return static_cast<int>(cudaErrorInvalidValue);
  int ncell = 1;
  for (int d = 0; d < dim; ++d) ncell *= E;
  if (static_cast<int64_t>(A) * (GBLK ? CH + 1 : CH) * ncell >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpb = ncell >= 2048 ? 1 : 2048 / ncell;  // tiles per block
  const int threads = 128;
  const unsigned int blocks = static_cast<unsigned int>((A + tpb - 1) / tpb);
  HaloLevels lv;
  for (int l = 0; l < 3; ++l) {
    int stride = 1;
    for (int d = l + 1; d < dim; ++d) stride *= E;
    lv.stride[l] = fast_div(stride);
    lv.sh[l] = T * stride;
  }
  const FastDiv divN = fast_div(ncell), divE = fast_div(E);
  const size_t smem = static_cast<size_t>(tpb) * pow3(dim) * sizeof(int);
#define HALO_AXES(np, ch)                                                                   \
  if (E == 2 * T && dim == np && CH == ch) {                                                \
    halo_axes_kernel<np, ch, GBLK><<<blocks, threads, smem, st>>>(                          \
        x, occupied, count, nbr, out, A, ncell, E, T, tpb, divN, divE, lv, up);             \
    return static_cast<int>(cudaGetLastError());                                            \
  }
#define HALO_ANY(np)                                                                        \
  if (dim == np)                                                                            \
    halo_axes_any_kernel<np, GBLK><<<blocks, threads, smem, st>>>(                          \
        x, occupied, count, nbr, out, A, CH, ncell, E, T, tpb, divN, divE, lv, up);
  if constexpr (GBLK) {
    HALO_AXES(3, 3) HALO_AXES(2, 2)  // the m+f halo (CH = D)
  } else {
    HALO_AXES(3, 1) HALO_AXES(2, 1)  // the mass halo (CH = 1)
  }
  HALO_ANY(2) HALO_ANY(3)
#undef HALO_AXES
#undef HALO_ANY
  return static_cast<int>(cudaGetLastError());
}

// A deposit launch: the one-chunk or the MULTI instantiation by cap.
template <int D, bool P2G2, typename... Args>
int launch_deposit(const Geom& g, cudaStream_t st, Args... args) {
  const int threads = P2G2 ? block_threads<D>(g, true) : g.chunk;
  const size_t smem = block_bytes<D>(g, P2G2 ? P2G2_SPLIT * D : 1 + D);
  return g.cap > CHUNK_MAX ? launch_tiles(deposit_kernel<D, P2G2, true>, g, threads, smem, st, args...)
                           : launch_tiles(deposit_kernel<D, P2G2, false>, g, threads, smem, st, args...);
}

// A collect launch, in chunks of COLLECT_CHUNK slots.
template <int D, typename... Args>
int launch_collect(Geom g, cudaStream_t st, Args... args) {
  g.chunk = g.cap < COLLECT_CHUNK ? g.cap : COLLECT_CHUNK;
  return launch_tiles(collect_kernel<D>, g, g.chunk, block_bytes<D>(g, 1 + D), st, args...);
}

}  // namespace

extern "C" {

// Every entry point takes `occupied`: a device [1] int32, or null for
// every entry of A (see the top of this file).

// mode 1: p2g1 (hs_m, d1, params unused); mode 2: p2g2.  sx: grid cells
// of one scene along axis 0 (one scene: tshape[0] * T).
int fluid_deposit(int dim, int mode, const int* occupied, const int* count, const int* tid,
                  const float* stream, const float* hs_m, const float* d1,
                  const float* params, float* out, int A, int T, int h, int cap,
                  const int* tshape, const int* origin, int sx, void* cuda_stream) {
  if (sx < T || sx % T) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(dim, A, T, h, cap, tshape, origin, sx);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (dim == 2 && mode == 1) return launch_deposit<2, false>(g, st, occupied, count, tid, stream, hs_m, d1, params, out);
  if (dim == 2 && mode == 2) return launch_deposit<2, true>(g, st, occupied, count, tid, stream, hs_m, d1, params, out);
  if (dim == 3 && mode == 1) return launch_deposit<3, false>(g, st, occupied, count, tid, stream, hs_m, d1, params, out);
  if (dim == 3 && mode == 2) return launch_deposit<3, true>(g, st, occupied, count, tid, stream, hs_m, d1, params, out);
  return static_cast<int>(cudaErrorInvalidValue);
}

int fluid_collect(int dim, const int* occupied, const int* count, const int* tid,
                  const float* params, const float* stream, const float* gblk,
                  float* out_stream, float* flag, float* dep, int A, int T, int h, int cap,
                  const int* tshape, const int* origin, int sx, void* cuda_stream) {
  if (sx < T || sx % T) return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = make_geom(dim, A, T, h, cap, tshape, origin, sx);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (dim == 2) return launch_collect<2>(g, st, occupied, count, tid, params, stream, gblk, out_stream, flag, dep);
  if (dim == 3) return launch_collect<3>(g, st, occupied, count, tid, params, stream, gblk, out_stream, flag, dep);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dim halo passes over windows [A, CH, E^dim], in one launch.
int fluid_halo_axes(const float* x, const int* occupied, const int* count, const int* nbr,
                    float* out, int A, int CH, int dim, int E, int T, void* cuda_stream) {
  return launch_halo<false>(x, occupied, count, nbr, out, A, CH, dim, E, T,
                            GridUpdate{nullptr, {0.0f, 0.0f, 0.0f}},
                            static_cast<cudaStream_t>(cuda_stream));
}

// The whole m+f halo (passes [0, dim), CH = dim) and the grid update, in
// one launch: grid-value windows [A, 1 + dim, E^dim].
int fluid_halo_gblk(const float* x, const float* hs_m, const int* occupied, const int* count,
                    const int* nbr, float* out, int A, int dim, int E, int T, float dtg0,
                    float dtg1, float dtg2, void* cuda_stream) {
  return launch_halo<true>(x, occupied, count, nbr, out, A, dim, dim, E, T,
                           GridUpdate{hs_m, {dtg0, dtg1, dtg2}},
                           static_cast<cudaStream_t>(cuda_stream));
}

}  // extern "C"
