// Shared by the MSDA forward (msda.cu) and backward (msda_bwd.cu) kernels:
// the level table, value loads and the bilinear corner rule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_WARPS 8

struct Levels {
  int n;
  int H[MSDA_MAX_LEVELS], W[MSDA_MAX_LEVELS], start[MSDA_MAX_LEVELS], P[MSDA_MAX_LEVELS];
};

__device__ __forceinline__ float load_val(const float* v, long i) { return __ldg(v + i); }
__device__ __forceinline__ float load_val(const __nv_bfloat16* v, long i) {
  return __bfloat162float(v[i]);
}

// The four bilinear corners of a point at (lx, ly) in [0,1] on an H x W map
// (grid_sample, align_corners=False, padding_mode=zeros): the top-left corner
// (x0, y0), the fractions (tx, ty) and which corners lie inside the map.
struct Corners {
  int x0, y0;
  float tx, ty;
  bool vx0, vx1, vy0, vy1;
};

__device__ __forceinline__ Corners corners(float lx, float ly, int H, int W) {
  Corners k;
  const float x = lx * W - 0.5f, y = ly * H - 0.5f;
  const float x0f = floorf(x), y0f = floorf(y);  // floor, not truncation
  k.tx = x - x0f;
  k.ty = y - y0f;
  // clamp before the int cast: a far-out point only has to stay out of range
  k.x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  k.y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  k.vx0 = k.x0 >= 0 && k.x0 < W;
  k.vx1 = k.x0 + 1 >= 0 && k.x0 + 1 < W;
  k.vy0 = k.y0 >= 0 && k.y0 < H;
  k.vy1 = k.y0 + 1 >= 0 && k.y0 + 1 < H;
  return k;
}

// level_info: host array of n_levels x (H, W, start, P). Returns the total
// point count, or -1 when n_levels is out of range.
inline int read_levels(int n_levels, const int* level_info, Levels* lv) {
  if (n_levels < 1 || n_levels > MSDA_MAX_LEVELS) return -1;
  lv->n = n_levels;
  int Ptot = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv->H[l] = level_info[4 * l];
    lv->W[l] = level_info[4 * l + 1];
    lv->start[l] = level_info[4 * l + 2];
    lv->P[l] = level_info[4 * l + 3];
    Ptot += lv->P[l];
  }
  return Ptot;
}
