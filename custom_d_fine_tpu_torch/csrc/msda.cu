// Multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package, which compute one function:
//   custom_d_fine_tpu/ops/pallas/msda_sep.py:_sep_kernel       (levels >= 1024 positions)
//   custom_d_fine_tpu/ops/pallas/msda.py:_level_kernel         (small levels)
//   custom_d_fine_tpu/ops/pallas/msda_sep.py:_sep_kernel_psum  (the P-sum in the kernel)
// The TPU gathers badly, so those kernels rebuild the bilinear sampling as
// one-hot matrix products. An H100 gathers well: this kernel samples the four
// corners of each point directly, over all levels in one launch, and sums
// levels x points in registers (which also covers _sep_kernel_psum).
//
// Function: out[b,q,h*c+ch] = sum_l sum_p attn[b,q,h,p] * bilinear(V_l[b,:,:,h,ch],
// loc[b,q,h,p]*(W_l,H_l) - 0.5), zero outside [0,W_l) x [0,H_l) (grid_sample,
// align_corners=False, padding_mode=zeros). Accumulation is f32; value is f32
// or bf16, everything else f32.
//
// Bound on the H100: at D-FINE-m 640^2, bs1, a launch reads at most
// 300 queries x 8 heads x 12 points x 4 corner rows of 32 channels (~1.5 MB in
// f32, half in bf16) plus loc/attn/out (~0.5 MB), and does ~10 flops per
// sampled channel: far below both roofs, so the launch is latency-bound
// (dependent loads of scattered rows). Design: one warp per (b, q, head), one
// lane per channel, so each corner is one coalesced 128-byte (f32) or 64-byte
// (bf16) row load; all lanes compute the same corner weights (no shuffles,
// no divergence); 8 warps per block give the SM many independent rows in
// flight. Channel counts above 32 loop over groups of 32.

#include <stdint.h>

#include "msda_common.cuh"

template <typename T>
__global__ void __launch_bounds__(32 * MSDA_WARPS) msda_fwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, float* __restrict__ out,
    int B, int Lv, int nh, int c, int Lq, int Ptot, Levels lv) {
  const int lane = threadIdx.x & 31;
  const long item = (long)blockIdx.x * MSDA_WARPS + (threadIdx.x >> 5);  // (b*Lq + q)*nh + h
  if (item >= (long)B * Lq * nh) return;
  const int h = (int)(item % nh);
  const long bq = item / nh;
  const int b = (int)(bq / Lq);
  const long vrow = (long)nh * c;  // elements between two positions of one level
  const float* loc_p = loc + item * Ptot * 2;
  const float* attn_p = attn + item * Ptot;
  const T* vbase = value + (long)b * Lv * vrow + (long)h * c;
  float* out_p = out + bq * vrow + (long)h * c;

  for (int c0 = 0; c0 < c; c0 += 32) {
    const int ch = c0 + lane;
    const bool active = ch < c;
    float acc = 0.f;
    int p = 0;
    for (int l = 0; l < lv.n; ++l) {
      const int H = lv.H[l], W = lv.W[l];
      const T* vl = vbase + (long)lv.start[l] * vrow + ch;
      for (int k = 0; k < lv.P[l]; ++k, ++p) {
        const Corners q = corners(loc_p[2 * p], loc_p[2 * p + 1], H, W);
        const float tx = q.tx, ty = q.ty;
        float s = 0.f;
        if (active) {
          const long r0 = ((long)q.y0 * W + q.x0) * vrow;
          if (q.vy0 && q.vx0) s += load_val(vl, r0) * ((1.f - tx) * (1.f - ty));
          if (q.vy0 && q.vx1) s += load_val(vl, r0 + vrow) * (tx * (1.f - ty));
          if (q.vy1 && q.vx0) s += load_val(vl, r0 + W * vrow) * ((1.f - tx) * ty);
          if (q.vy1 && q.vx1) s += load_val(vl, r0 + (W + 1) * vrow) * (tx * ty);
        }
        acc += s * attn_p[p];
      }
    }
    if (active) out_p[ch] = acc;
  }
}

// level_info: host array of n_levels x (H, W, start, P).
extern "C" int msda_fwd(const void* value, int value_bf16, const void* loc, const void* attn,
                        void* out, int B, int Lv, int nh, int c, int Lq, int n_levels,
                        const int* level_info, void* stream) {
  Levels lv;
  const int Ptot = read_levels(n_levels, level_info, &lv);
  if (Ptot < 0) return (int)cudaErrorInvalidValue;
  const long items = (long)B * Lq * nh;
  if (items == 0) return 0;
  const unsigned grid = (unsigned)((items + MSDA_WARPS - 1) / MSDA_WARPS);
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16)
    msda_fwd_kernel<__nv_bfloat16><<<grid, 32 * MSDA_WARPS, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc, (const float*)attn, (float*)out,
        B, Lv, nh, c, Lq, Ptot, lv);
  else
    msda_fwd_kernel<float><<<grid, 32 * MSDA_WARPS, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)attn, (float*)out,
        B, Lv, nh, c, Lq, Ptot, lv);
  return (int)cudaGetLastError();
}
