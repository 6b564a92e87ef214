// Device helpers shared by stream_kernels.cu and pallas_kernels.cu: the
// per-axis stencil of a particle, the Tait pressure and the particle tail.
// Each has one plain PyTorch counterpart in ops/stream_kernels.py
// (bspline.quadratic_weights, _pressure, _particle_tail) that both backends'
// plain versions use, so a change here is made once on each side.

#pragma once

#include <cuda_runtime.h>

namespace mpm {

// Coordinate along axis d of tile `tid` in a row-major grid of tiles.
__device__ __forceinline__ int tile_coord(int tid, int d, int D, const int* tshape) {
  int div = 1;
  for (int k = d + 1; k < D; ++k) div *= tshape[k];
  return (tid / div) % tshape[d];
}

// Cell of the corner of tile `tid` on axis d: origin + coord * T.
__device__ __forceinline__ int tile_corner(int tid, int d, int D, int T, const int* tshape,
                                           const int* origin) {
  return origin[d] + tile_coord(tid, d, D, tshape) * T;
}

// The corner of tile `tid` on every axis in its scene's coordinates: a
// packed domain lays scenes of sx grid cells side by side along x, and a
// tile of scene k = (coord_0 * T) / sx holds its particles in that scene's
// coordinates, so its corner on axis 0 drops the scene's offset k * sx.
// One scene: sx spans the grid, the offset is 0 and the corner is
// tile_corner's.  Taken once a tile, not once a particle.
template <int D>
__device__ __forceinline__ void scene_corner(int tid, int T, const int* tshape, const int* origin,
                                             int sx, int* corner) {
  for (int d = 0; d < D; ++d) {
    const int c = tile_coord(tid, d, D, tshape) * T;
    corner[d] = origin[d] + c - (d == 0 ? c / sx * sx : 0);
  }
}

// Cell of floor(x) (cf) relative to a tile's corner on the same axis,
// unclipped.
__device__ __forceinline__ int local_cell(float cf, int corner) {
  return static_cast<int>(cf) - corner;
}

// Quadratic B-spline weights of the three taps at offset dv = x - floor(x)
// - 0.5, in the order of bspline.quadratic_weights.
__device__ __forceinline__ void bspline_weights(float dv, float& w0, float& w1, float& w2) {
  w0 = 0.5f * (0.5f - dv) * (0.5f - dv);
  w1 = 0.75f - dv * dv;
  w2 = 0.5f * (0.5f + dv) * (0.5f + dv);
}

// Tait equation of state with the pressure floor.
__device__ __forceinline__ float tait_pressure(float rho, float rest, float k_eos, float gamma,
                                               float floor_p) {
  return fmaxf(k_eos * (powf(rho / rest, gamma) - 1.0f), floor_p);
}

// Particle tail after advection, in place on the advected position and the
// grid velocity: the mouse impulse in the xy plane after advection (quirk
// Q3), then the clamp and the soft wall with the un-scaled lookahead (quirk
// Q2).  A packed scene's particles are in its own coordinates, so its walls
// are the configuration's.
// params: [.., mouse_radius (5), damp (6), mouse_active (7), mouse_x (8),
//          mouse_y (9), lo[D] (10..), hi[D] (10+D..)].
template <int D>
__device__ __forceinline__ void particle_tail(float* pos, float* v, const float* params) {
  const float mouse_r = params[5], damp = params[6], m_active = params[7];
  const float dx = pos[0] - params[8];
  const float dy = pos[1] - params[9];
  const float d2 = dx * dx + dy * dy;
  const float nrm = sqrtf(d2);
  const float inv = nrm > 0.0f ? 1.0f / nrm : 0.0f;
  const bool hit = (m_active > 0.0f) && (d2 < mouse_r * mouse_r);
  v[0] = v[0] + (hit ? dx * inv : 0.0f);
  v[1] = v[1] + (hit ? dy * inv : 0.0f);

  for (int d = 0; d < D; ++d) {
    const float lo = params[10 + d];
    const float hi = params[10 + D + d];
    const float p_cl = fminf(fmaxf(pos[d], lo), hi);
    const float nxt = p_cl + v[d];
    const float wmin = lo + damp;
    const float wmax = hi - damp;
    float vv = v[d] + (nxt < wmin ? wmin - nxt : 0.0f);
    vv = vv + (nxt > wmax ? wmax - nxt : 0.0f);
    pos[d] = p_cl;
    v[d] = vv;
  }
}

}  // namespace mpm
