// Multi-scale deformable attention backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   custom_d_fine_tpu/ops/pallas/msda_sep.py:_sep_bwd_kernel  (levels >= 1024 positions:
//     dV, dSy, dSx per (b*head, W-tile); XLA then chains dSy/dSx to dloc, dattn)
//   custom_d_fine_tpu/ops/pallas/msda.py:_level_bwd_kernel    (small levels:
//     dV = S^T g and the per-corner dW[e]; XLA then chains dW to dloc, dattn)
// Those kernels rebuild the bilinear sampling as one-hot and separable matrix
// products because the TPU gathers and scatters badly. An H100 does both
// well: both kernels below recompute each point's four corners with the
// forward's border rule (msda_common.cuh), over all levels.
//
// Function, for out = msda_fwd(value, loc, attn) and its cotangent g [B,Lq,h*c]:
//   dvalue[b, start_l + y*W + x, h, ch] = sum over points of attn * w_corner * g[b,q,h*c+ch]
//   dattn[b,q,h,p]  = sum_ch g * sample_p                     (sample = sum_corners w v)
//   dloc[b,q,h,p,0] = attn * W * sum_ch g * d sample / d tx   (tx = frac(loc_x*W - 0.5))
//   dloc[b,q,h,p,1] = attn * H * sum_ch g * d sample / d ty
// with zero contribution from corners outside the map, in dvalue and in dloc.
// value is f32 or bf16 and dvalue comes out in value's dtype; every sum is f32.
//
// Bound on the H100: at D-FINE-m 640^2 training (500 queries, bs16, bf16
// value) one call must read the value rows that valid corners touch (~41 MB),
// g (8 MB) and loc/attn, and write dvalue (69 MB in bf16, every position)
// and dloc/dattn: ~137 MB, 41 us at 3.35 TB/s; ~12 flops per sampled channel
// is far below the f32 roof. So bytes bound it. A scatter of dvalue into
// device memory adds an f32 buffer to zero (138 MB) and a cast (207 MB).
//
// Design: two kernels of this library, launched one after the other.
// 1. msda_bwd_dloc_kernel: one warp per (b, q, head). Its lanes are slots of
//    16-byte channel vectors (8 bf16 or 4 f32), so a warp loads the corner
//    rows of several points at once; each slot sums <g, v> terms over its
//    lanes with a few shuffles, and one lane writes dattn and dloc. Each warp
//    owns its rows of dloc and dattn: no atomics, deterministic.
// 2. msda_bwd_dvalue_kernel gathers dvalue per CTA instead of scattering it.
//    A CTA owns one rectangle of one (b, head, level) map and <= 256 of its
//    channels, and keeps that slab of dvalue in f32 in shared memory (100 KB:
//    two CTAs on an SM; at 640^2 with c = 32, bands of 10 rows of the 80^2
//    level, 20 of the 40^2 and the whole 20^2, 11 CTAs per (b, head)). The
//    rectangle is the whole width where a row fits the slab, else part of a
//    row. The CTA walks all Lq x P_l points of its map: one lane per point
//    computes the corners, a ballot keeps the points with a corner in the
//    rectangle, and the warp (one lane per channel) adds attn * w_corner * g
//    into the slab for the corners inside the rectangle, a few points at a
//    time so that their g loads overlap. A point that straddles two
//    rectangles is added by both, each its own corners. The slab is then
//    stored once, in value's dtype, with coalesced vector stores; positions
//    that no point touches are written as zeros. No f32 buffer in device
//    memory, no fill, no cast, no global atomic.
//    On sm_90 a shared-memory f32 atomicAdd compiles to a compare-and-swap
//    loop (ATOMS.CAST.SPIN). Tried on the card and dropped, each slower:
//    fixed-point int32 sums with native ATOMS.ADD (they need a bound on
//    every sum, and its extra pass cost more than the CAS loops), one warp
//    per owned range of positions with plain adds (every warp rescans the
//    point list), two points per warp step (one per half-warp), 8 warps a
//    CTA, and 50 KB slabs. The time goes to the per-point work: the walk is
//    repeated by every CTA of a map, and each touching point costs shuffles,
//    weights and offsets besides its four atomics. A thread-block cluster sharing
//    one map's slabs through distributed shared memory would walk each
//    point once; not tried. The shared-memory atomics sum in an order that
//    varies from run to run, so dvalue's last bits do too.

#include <stdint.h>

#include "msda_common.cuh"

#define SLAB_FLOATS 25600  // 102,400 B of f32 dvalue per CTA: two CTAs on an SM
#define SLAB_CHANNELS 256  // channels per CTA at most, so a slab holds >= 100 positions
#define DV_WARPS 16        // warps of a dvalue CTA: 32 on an SM with two CTAs
#define DV_ILP 4           // points a dvalue warp adds at once

// Per level: the rectangle (tw x th positions), rectangles per row of them,
// and the index of the level's first rectangle in the grid.
struct Tiles {
  int tw[MSDA_MAX_LEVELS], th[MSDA_MAX_LEVELS], nx[MSDA_MAX_LEVELS];
  int first[MSDA_MAX_LEVELS + 1];
};

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// grid: (rectangles of all levels, B * nh, channel chunks of cc); DV_WARPS warps.
// The slab holds nc f32 per position of the rectangle, row-major.
template <typename T>
__global__ void __launch_bounds__(32 * DV_WARPS, 2) msda_bwd_dvalue_kernel(
    const float* __restrict__ loc, const float* __restrict__ attn,
    const float* __restrict__ grad, T* __restrict__ dvalue,
    int Lv, int nh, int c, int cc, int Lq, int Ptot, Levels lv, Tiles tl) {
  extern __shared__ float4 slab4[];
  float* slab = reinterpret_cast<float*>(slab4);
  const int tile = blockIdx.x;
  int l = 0;
  while (tile >= tl.first[l + 1]) ++l;
  int p_off = 0;
  for (int i = 0; i < l; ++i) p_off += lv.P[i];
  const int H = lv.H[l], W = lv.W[l], P = lv.P[l];
  const int ti = tile - tl.first[l];
  const int rx0 = (ti % tl.nx[l]) * tl.tw[l], ry0 = (ti / tl.nx[l]) * tl.th[l];
  const int rw = min(tl.tw[l], W - rx0), rh = min(tl.th[l], H - ry0);
  const int b = blockIdx.y / nh, h = blockIdx.y % nh;
  const int c_lo = blockIdx.z * cc, nc = min(cc, c - c_lo), npos = rw * rh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long vrow = (long)nh * c;  // elements between two positions of one level
  const float* gb = grad + (long)b * Lq * vrow + (long)h * c + c_lo;

  for (int i = threadIdx.x; i < (npos * nc + 3) / 4; i += blockDim.x)
    slab4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int npts = Lq * P;
  for (int base = warp * 32; base < npts; base += DV_WARPS * 32) {
    const int idx = base + lane;
    int q = 0, x0 = 0, y0 = 0;
    float a = 0.f, tx = 0.f, ty = 0.f;
    bool touch = false;
    if (idx < npts) {
      q = idx / P;
      const long pp = (((long)b * Lq + q) * nh + h) * Ptot + p_off + (idx - q * P);
      const Corners k = corners(loc[2 * pp], loc[2 * pp + 1], H, W);
      x0 = k.x0 - rx0;  // corners in rectangle coordinates
      y0 = k.y0 - ry0;
      tx = k.tx;
      ty = k.ty;
      touch = x0 + 1 >= 0 && x0 < rw && y0 + 1 >= 0 && y0 < rh;
      if (touch) a = attn[pp];
    }
    // the points of this warp with a corner in the rectangle, DV_ILP at a
    // time (one lane per channel): their g loads and slab adds are independent
    unsigned todo = __ballot_sync(0xffffffffu, touch);
    while (todo) {
      int off[DV_ILP][4];  // slab row of each corner, -1 outside the rectangle
      float w[DV_ILP][4];
      const float* gq[DV_ILP];
#pragma unroll
      for (int u = 0; u < DV_ILP; ++u) {
        const bool has = todo != 0u;
        const int src = has ? __ffs(todo) - 1 : 0;
        todo &= todo - 1u;
        const int qs = __shfl_sync(0xffffffffu, q, src);
        const int xs = __shfl_sync(0xffffffffu, x0, src), ys = __shfl_sync(0xffffffffu, y0, src);
        const float as = __shfl_sync(0xffffffffu, a, src);
        const float txs = __shfl_sync(0xffffffffu, tx, src);
        const float tys = __shfl_sync(0xffffffffu, ty, src);
        w[u][0] = as * (1.f - txs) * (1.f - tys);
        w[u][1] = as * txs * (1.f - tys);
        w[u][2] = as * (1.f - txs) * tys;
        w[u][3] = as * txs * tys;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = xs + (e & 1), y = ys + (e >> 1);
          off[u][e] = (has && x >= 0 && x < rw && y >= 0 && y < rh) ? (y * rw + x) * nc : -1;
        }
        gq[u] = gb + (long)qs * vrow;
      }
      for (int ch = lane; ch < nc; ch += 32) {
        float g[DV_ILP];
#pragma unroll
        for (int u = 0; u < DV_ILP; ++u)
          g[u] = (off[u][0] & off[u][1] & off[u][2] & off[u][3]) == -1  // none inside
                     ? 0.f : __ldg(gq[u] + ch);
#pragma unroll
        for (int u = 0; u < DV_ILP; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (off[u][e] >= 0) atomicAdd(slab + off[u][e] + ch, w[u][e] * g[u]);
      }
    }
  }
  __syncthreads();

  // ---- store once, in value's dtype: 4 channels a thread where rows allow
  T* dst = dvalue + ((long)b * Lv + lv.start[l]) * vrow + (long)h * c + c_lo;
  const int nel = npos * nc;
  if (nc % 4 == 0 && c % 4 == 0) {
    const int n4 = nc / 4;
    for (int i = threadIdx.x; i < nel / 4; i += blockDim.x) {
      const int pos = i / n4, ch = (i - pos * n4) * 4;
      const int y = ry0 + pos / rw, x = rx0 + pos % rw;
      store4(dst + ((long)y * W + x) * vrow + ch, slab4[i]);
    }
  } else {
    for (int i = threadIdx.x; i < nel; i += blockDim.x) {
      const int pos = i / nc, ch = i - pos * nc;
      const int y = ry0 + pos / rw, x = rx0 + pos % rw;
      store1(dst + ((long)y * W + x) * vrow + ch, slab[i]);
    }
  }
}

// V consecutive channels as f32: one 16-byte load for V = 8 (bf16) or 4 (f32)
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
  } else if constexpr (V == 8) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    const float4 e = __ldg(reinterpret_cast<const float4*>(p) + 1);
    o[0] = f.x; o[1] = f.y; o[2] = f.z; o[3] = f.w;
    o[4] = e.x; o[5] = e.y; o[6] = e.z; o[7] = e.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __ldg(p + i);
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&o)[V]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __bfloat162float(p[i]);
  }
}

// One warp per (b, q, head). Its 32 lanes are 32 >> lg slots of 1 << lg
// lanes: a slot takes one point at a time, each of its lanes V channels of
// the point's four corner rows (16-byte loads where V > 1), and the slot's
// lanes sum their partials with lg shuffle steps.
template <typename T, int V>
__global__ void __launch_bounds__(32 * MSDA_WARPS) msda_bwd_dloc_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const float* __restrict__ grad,
    float* __restrict__ dloc, float* __restrict__ dattn,
    int B, int Lv, int nh, int c, int Lq, int Ptot, Levels lv, int lg) {
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * MSDA_WARPS + (threadIdx.x >> 5);  // (b*Lq + q)*nh + h
  if (item >= (long)B * Lq * nh) return;  // whole warps leave together
  const int h = (int)(item % nh);
  const long bq = item / nh;
  const int b = (int)(bq / Lq);
  const long vrow = (long)nh * c;
  const int lpp = 1 << lg, sub = lane & (lpp - 1), nchunk = c / V;
  const float* g_p = grad + bq * vrow + (long)h * c;
  const T* v_p = value + (long)b * Lv * vrow + (long)h * c;

  for (int p0 = 0; p0 < Ptot; p0 += 32 >> lg) {
    const int p = p0 + (lane >> lg);
    const bool on = p < Ptot;
    int l = 0, k = p;
    while (on && l < lv.n - 1 && k >= lv.P[l]) k -= lv.P[l++];
    const int H = lv.H[l], W = lv.W[l];
    const long pp = item * Ptot + (on ? p : 0);
    const Corners q = corners(loc[2 * pp], loc[2 * pp + 1], H, W);
    const float tx = q.tx, ty = q.ty;
    const long r00 = (lv.start[l] + (long)q.y0 * W + q.x0) * vrow, r01 = r00 + vrow;
    const long r10 = r00 + W * vrow, r11 = r10 + vrow;
    float pa = 0.f, px = 0.f, py = 0.f;
    for (int j = sub; on && j < nchunk; j += lpp) {
      float g[V], v00[V], v01[V], v10[V], v11[V];
      load_vec<V>(g_p + j * V, g);
#pragma unroll
      for (int i = 0; i < V; ++i) v00[i] = v01[i] = v10[i] = v11[i] = 0.f;
      if (q.vy0 && q.vx0) load_vec<V>(v_p + r00 + j * V, v00);
      if (q.vy0 && q.vx1) load_vec<V>(v_p + r01 + j * V, v01);
      if (q.vy1 && q.vx0) load_vec<V>(v_p + r10 + j * V, v10);
      if (q.vy1 && q.vx1) load_vec<V>(v_p + r11 + j * V, v11);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        pa += g[i] * ((1.f - tx) * (1.f - ty) * v00[i] + tx * (1.f - ty) * v01[i] +
                      (1.f - tx) * ty * v10[i] + tx * ty * v11[i]);
        px += g[i] * ((1.f - ty) * (v01[i] - v00[i]) + ty * (v11[i] - v10[i]));
        py += g[i] * ((1.f - tx) * (v10[i] - v00[i]) + tx * (v11[i] - v01[i]));
      }
    }
    for (int o = lpp >> 1; o > 0; o >>= 1) {
      pa += __shfl_xor_sync(0xffffffffu, pa, o);
      px += __shfl_xor_sync(0xffffffffu, px, o);
      py += __shfl_xor_sync(0xffffffffu, py, o);
    }
    if (on && sub == 0) {
      const float a = attn[pp];
      dattn[pp] = pa;
      dloc[2 * pp] = a * W * px;
      dloc[2 * pp + 1] = a * H * py;
    }
  }
}

template <typename T>
static int launch(const T* value, const float* loc, const float* attn, const float* grad,
                  T* dvalue, float* dloc, float* dattn, int B, int Lv, int nh, int c, int Lq,
                  int Ptot, const Levels& lv, cudaStream_t s) {
  if ((long)B * nh > 65535) return (int)cudaErrorInvalidValue;
  const long items = (long)B * Lq * nh;
  if (items > 0) {  // dloc and dattn
    const unsigned blocks = (unsigned)((items + MSDA_WARPS - 1) / MSDA_WARPS);
    // 16 bytes of channels per lane where c and the pointers allow it
    constexpr int V = 16 / sizeof(T);
    const bool vec = c % V == 0 && (uintptr_t)value % 16 == 0 && (uintptr_t)grad % 16 == 0;
    const int nchunk = vec ? c / V : c;
    int lg = 0;
    while (lg < 5 && (1 << lg) < nchunk) ++lg;
    if (vec)
      msda_bwd_dloc_kernel<T, V><<<blocks, 32 * MSDA_WARPS, 0, s>>>(
          value, loc, attn, grad, dloc, dattn, B, Lv, nh, c, Lq, Ptot, lv, lg);
    else
      msda_bwd_dloc_kernel<T, 1><<<blocks, 32 * MSDA_WARPS, 0, s>>>(
          value, loc, attn, grad, dloc, dattn, B, Lv, nh, c, Lq, Ptot, lv, lg);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // dvalue: rectangles of <= SLAB_FLOATS / cc positions, whole rows where one fits
  const int cc = c < SLAB_CHANNELS ? c : SLAB_CHANNELS;
  const int npos = SLAB_FLOATS / cc;
  Tiles tl;
  tl.first[0] = 0;
  int slab = 0;
  for (int l = 0; l < lv.n; ++l) {
    const int tw = lv.W[l] < npos ? lv.W[l] : npos;
    const int th = tw == 0 ? 0 : (lv.H[l] < npos / tw ? lv.H[l] : npos / tw);
    tl.tw[l] = tw;
    tl.th[l] = th;
    tl.nx[l] = tw == 0 ? 0 : (lv.W[l] + tw - 1) / tw;
    tl.first[l + 1] = tl.first[l] + (th == 0 ? 0 : tl.nx[l] * ((lv.H[l] + th - 1) / th));
    if (tw * th * cc > slab) slab = tw * th * cc;
  }
  if (tl.first[lv.n] == 0 || B * nh == 0 || c == 0) return 0;
  const size_t smem = sizeof(float) * (size_t)((slab + 3) / 4 * 4);
  cudaError_t e = cudaFuncSetAttribute(msda_bwd_dvalue_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(tl.first[lv.n], B * nh, (c + cc - 1) / cc);
  msda_bwd_dvalue_kernel<T><<<grid, 32 * DV_WARPS, smem, s>>>(
      loc, attn, grad, dvalue, Lv, nh, c, cc, Lq, Ptot, lv, tl);
  return (int)cudaGetLastError();
}

// level_info: host array of n_levels x (H, W, start, P). dvalue: [B, Lv, nh, c]
// in value's dtype, every element written here; dloc f32 [B, Lq, nh, P, 2];
// dattn f32 [B, Lq, nh, P]; grad f32 [B, Lq, nh*c].
extern "C" int msda_bwd(const void* value, int value_bf16, const void* loc, const void* attn,
                        const void* grad, void* dvalue, void* dloc, void* dattn, int B, int Lv,
                        int nh, int c, int Lq, int n_levels, const int* level_info,
                        void* stream) {
  Levels lv;
  const int Ptot = read_levels(n_levels, level_info, &lv);
  if (Ptot < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16)
    return launch((const __nv_bfloat16*)value, (const float*)loc, (const float*)attn,
                  (const float*)grad, (__nv_bfloat16*)dvalue, (float*)dloc, (float*)dattn, B,
                  Lv, nh, c, Lq, Ptot, lv, s);
  return launch((const float*)value, (const float*)loc, (const float*)attn, (const float*)grad,
                (float*)dvalue, (float*)dloc, (float*)dattn, B, Lv, nh, c, Lq, Ptot, lv, s);
}
