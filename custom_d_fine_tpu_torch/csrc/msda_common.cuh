// Shared by the MSDA forward (msda.cu) and backward (msda_bwd.cu) kernels:
// the level table, value loads and the bilinear corner rule.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// V consecutive channels as loaded: one 16-byte vector (V = 8 bf16 or 4 f32),
// or for V = 1 one channel, already widened. load_raw issues the load and
// unpack widens it to f32, so a kernel can issue many loads before it uses
// any and keep them in 4 registers each meanwhile. A value-initialised Raw
// unpacks to zeros.
template <typename T, int V>
struct Raw {
  uint4 u;
};
template <typename T>
struct Raw<T, 1> {
  float x;
};

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  Raw<T, V> r;
  if constexpr (V == 1) {
    r.x = load_val(p, 0);
  } else {
    static_assert(V * sizeof(T) == 16, "a Raw vector is 16 bytes");
    r.u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void unpack(const Raw<T, 1>& r, float* o) { o[0] = r.x; }
__device__ __forceinline__ void unpack(const Raw<float, 4>& r, float* o) {
  o[0] = __uint_as_float(r.u.x);
  o[1] = __uint_as_float(r.u.y);
  o[2] = __uint_as_float(r.u.z);
  o[3] = __uint_as_float(r.u.w);
}
__device__ __forceinline__ void unpack(const Raw<__nv_bfloat16, 8>& r, float* o) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its f32
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// V consecutive channels as f32: 16-byte loads for V = 8 (bf16) or 4 and 8 (f32)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) unpack(load_raw<float, 4>(p + i), o + i);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __ldg(p + i);
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[V]) {
  if constexpr (V == 8) {
    unpack(load_raw<__nv_bfloat16, 8>(p), o);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __bfloat162float(p[i]);
  }
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
