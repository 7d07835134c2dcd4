// Multi-scale deformable attention backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package, which compute one function:
//   custom_d_fine_tpu/ops/pallas/msda_sep.py:_sep_bwd_kernel  (levels >= 1024 positions:
//     dV, dSy, dSx per (b*head, W-tile); XLA then chains dSy/dSx to dloc, dattn)
//   custom_d_fine_tpu/ops/pallas/msda.py:_level_bwd_kernel    (small levels:
//     dV = S^T g and the per-corner dW[e]; XLA then chains dW to dloc, dattn)
// Those kernels rebuild the bilinear sampling as one-hot and separable matrix
// products because the TPU gathers and scatters badly. An H100 does both well:
// this kernel recomputes each point's four corners (the forward's border rule,
// msda_common.cuh), scatters dvalue with f32 atomics and forms dloc and dattn
// in registers, over all levels in one launch.
//
// Function, for out = msda_fwd(value, loc, attn) and its cotangent g [B,Lq,h*c]:
//   dvalue[b, start_l + y*W + x, h, ch] += attn * w_corner * g[b,q,h*c+ch]
//   dattn[b,q,h,p]  = sum_ch g * sample_p                     (sample = sum_corners w v)
//   dloc[b,q,h,p,0] = attn * W * sum_ch g * d sample / d tx   (tx = frac(loc_x*W - 0.5))
//   dloc[b,q,h,p,1] = attn * H * sum_ch g * d sample / d ty
// with zero contribution from corners outside the map, in dvalue and in dloc.
// value is f32 or bf16; everything else, and every sum, is f32. dvalue goes to
// an f32 buffer that the caller zeroes and casts to value's dtype.
//
// Bound on the H100: at D-FINE-m 640^2 training (500 queries, bs16, bf16
// value) one call must read the value rows that valid corners touch (~41 MB),
// g (8 MB) and loc/attn, and write dvalue (69 MB in bf16) and dloc/dattn:
// ~137 MB, 41 us at 3.35 TB/s; ~12 flops per sampled channel is far below
// the f32 roof. So it is bound by bytes, and in practice by the scattered
// reduction into dvalue. Design: one warp per (b, q, head), one lane per
// channel, as in the forward: each corner is one coalesced row load of value
// and one coalesced 32-lane f32 atomic add (RED) into dvalue. The three sums
// over channels (dattn, d/dtx, d/dty) are warp shuffles; lane 0 writes them.
// Channel counts above 32 loop over groups of 32; each warp owns its
// (b, q, head) rows of dloc and dattn, so those need no atomics and are
// deterministic. dvalue's atomics make its summation order vary run to run.

#include <stdint.h>

#include "msda_common.cuh"

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * MSDA_WARPS) msda_bwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, const float* __restrict__ grad,
    float* __restrict__ dvalue, float* __restrict__ dloc, float* __restrict__ dattn,
    int B, int Lv, int nh, int c, int Lq, int Ptot, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * MSDA_WARPS + (threadIdx.x >> 5);  // (b*Lq + q)*nh + h
  if (item >= (long)B * Lq * nh) return;  // whole warps leave together
  const int h = (int)(item % nh);
  const long bq = item / nh;
  const int b = (int)(bq / Lq);
  const long vrow = (long)nh * c;  // elements between two positions of one level
  const float* loc_p = loc + item * Ptot * 2;
  const float* attn_p = attn + item * Ptot;
  float* dloc_p = dloc + item * Ptot * 2;
  float* dattn_p = dattn + item * Ptot;
  const long base = (long)b * Lv * vrow + (long)h * c;

  for (int c0 = 0; c0 < c; c0 += 32) {
    const int ch = c0 + lane;
    const bool active = ch < c;
    const float g = active ? grad[bq * vrow + (long)h * c + ch] : 0.f;
    int p = 0;
    for (int l = 0; l < lv.n; ++l) {
      const int H = lv.H[l], W = lv.W[l];
      const long lbase = base + (long)lv.start[l] * vrow + ch;
      const T* vl = value + lbase;
      float* dvl = dvalue + lbase;
      for (int k = 0; k < lv.P[l]; ++k, ++p) {
        const Corners q = corners(loc_p[2 * p], loc_p[2 * p + 1], H, W);
        const float tx = q.tx, ty = q.ty, a = attn_p[p];
        const bool in00 = q.vy0 && q.vx0, in01 = q.vy0 && q.vx1;
        const bool in10 = q.vy1 && q.vx0, in11 = q.vy1 && q.vx1;
        const float w00 = (1.f - tx) * (1.f - ty), w01 = tx * (1.f - ty);
        const float w10 = (1.f - tx) * ty, w11 = tx * ty;
        const long r00 = ((long)q.y0 * W + q.x0) * vrow, r01 = r00 + vrow;
        const long r10 = r00 + W * vrow, r11 = r10 + vrow;
        float pa = 0.f, px = 0.f, py = 0.f;
        if (active) {
          const float v00 = in00 ? load_val(vl, r00) : 0.f;
          const float v01 = in01 ? load_val(vl, r01) : 0.f;
          const float v10 = in10 ? load_val(vl, r10) : 0.f;
          const float v11 = in11 ? load_val(vl, r11) : 0.f;
          pa = g * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
          px = g * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
          py = g * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01));
          const float ag = a * g;
          if (in00) atomicAdd(dvl + r00, ag * w00);
          if (in01) atomicAdd(dvl + r01, ag * w01);
          if (in10) atomicAdd(dvl + r10, ag * w10);
          if (in11) atomicAdd(dvl + r11, ag * w11);
        }
        pa = warp_sum(pa);
        px = warp_sum(px);
        py = warp_sum(py);
        if (lane == 0) {
          const bool first = c0 == 0;
          dattn_p[p] = (first ? 0.f : dattn_p[p]) + pa;
          dloc_p[2 * p] = (first ? 0.f : dloc_p[2 * p]) + a * W * px;
          dloc_p[2 * p + 1] = (first ? 0.f : dloc_p[2 * p + 1]) + a * H * py;
        }
      }
    }
  }
}

// level_info: host array of n_levels x (H, W, start, P). dvalue: f32
// [B, Lv, nh, c], zeroed by the caller; dloc f32 [B, Lq, nh, P, 2]; dattn f32
// [B, Lq, nh, P]; grad f32 [B, Lq, nh*c].
extern "C" int msda_bwd(const void* value, int value_bf16, const void* loc, const void* attn,
                        const void* grad, void* dvalue, void* dloc, void* dattn, int B, int Lv,
                        int nh, int c, int Lq, int n_levels, const int* level_info,
                        void* stream) {
  Levels lv;
  const int Ptot = read_levels(n_levels, level_info, &lv);
  if (Ptot < 0) return (int)cudaErrorInvalidValue;
  const long items = (long)B * Lq * nh;
  if (items == 0) return 0;
  const unsigned grid = (unsigned)((items + MSDA_WARPS - 1) / MSDA_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16)
    msda_bwd_kernel<__nv_bfloat16><<<grid, 32 * MSDA_WARPS, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const float*)attn,
        (const float*)grad, (float*)dvalue, (float*)dloc, (float*)dattn,
        B, Lv, nh, c, Lq, Ptot, lv);
  else
    msda_bwd_kernel<float><<<grid, 32 * MSDA_WARPS, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)attn,
        (const float*)grad, (float*)dvalue, (float*)dloc, (float*)dattn,
        B, Lv, nh, c, Lq, Ptot, lv);
  return (int)cudaGetLastError();
}
