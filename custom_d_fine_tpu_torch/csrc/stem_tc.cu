// The eval-mode HGNetv2 StemBlock in its fast mode, on bf16 tensor cores,
// for Hopper (sm_90a).
//
// Replaces custom_d_fine_tpu/ops/pallas/stem.py:_stem_kernel with fast=True,
// which the JAX package's serving graph runs on the TPU. Function, with every
// BatchNorm folded into its conv and 1/255 folded into w1
// (ops/stem.py:fold_stem_weights):
//   stem1 3x3/s2 pad 1 -> pad (0,1) -> { stem2a 2x2 -> pad (0,1) -> stem2b 2x2
//   | maxpool 2x2/s1 } -> concat [pool, stem2b] -> stem3 3x3/s2 pad 1 -> stem4 1x1,
// each conv followed by ReLU and then the LAB affine. Each conv's operands
// (the activation and the folded weight) are rounded to bf16 and its products
// summed in f32; bias, ReLU, LAB and the maxpool are f32 (the maxpool of
// bf16-rounded values is the rounding of the f32 maxpool, so it runs on the
// stored bf16 map). In: uint8 [B,H,W,3] raw pixels (exact in bf16;
// H % 4 == 0, W % 4 == 0). Out: f32 [B,H/4,W/4,O].
//
// Bound on the H100: per 640^2 image ~1.17 GFLOP, ~1.2 us at 989 TFLOP/s in
// bf16, and 1.2 MB in + 3.3 MB out, ~1.3 us at 3.35 TB/s: bytes bound it. The
// exact kernel (stem.cu) runs the same work in f32 FMAs on CUDA cores,
// bound at ~17 us and limited by load issue.
//
// Design: csrc/stem.cu's fused, halo'd structure, one CTA (12 warps) per
// (image, 10x10 tile of the stride-4 output), with all five convs as implicit GEMMs on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate): output pixels are the M side,
// output channels the N side (stem2a's M2 padded to a multiple of 8), and
// taps x Cin the K side (27 -> 32 for stem1, 4M, 4*M2p, 18M, M -> 16k). Each
// warp takes (16-pixel, <= NTI x 8-channel) items in turn; its k-loop loads
// step k+1's operands before step k's products.
// - A operands: ldmatrix.x4 straight from the bf16 activation tile in shared
//   memory. Each lane gives one pixel row of 8 channels of one tap; a table
//   per conv holds the shared-memory offset of each 8-channel k-chunk, so a
//   k-step costs one table read and one ldmatrix. Channel strides are padded
//   to an odd number of 16-byte chunks, so 8 neighbouring pixels of a
//   stride-1 conv hit distinct banks. stem1 (3 input channels) builds its A
//   fragments from a zero-padded bf16 copy of the input tile, 8 reads a step.
// - B operands: the weights in fragment order (ops/stem.py:
//   pack_fast_weights), one 8-byte load per lane per (k-step, n-tile),
//   through L1. Staging them in shared memory was tried: faster at bs1,
//   slower at bs16 (fewer CTAs fit on an SM), and B6's stem (117 KB of
//   weights) would not fit beside its activations.
// - Epilogues in f32 registers: bias (staged in shared memory), ReLU, LAB,
//   the border masks (zero padding), rounding to bf16 into the next conv's
//   tile; stem4 writes f32 float2 pairs to device memory.
// - The input tile (47 rows x 141 bytes) arrives by cp.async, 4-byte words.
// Shared memory (B2: M=24, M2=12): input/stem2a 23,232 B + stem1/stem3
// 25,392 B + concat 49,392 B + tables and biases: ~97 KB, two CTAs on an SM
// (B6's stem: ~175 KB, one). Only the stride-4 output reaches device memory.
// What bounds it in practice: instruction issue. A CTA runs ~1,500 mma but
// many times that in address, epilogue and layout instructions, and every
// phase between two barriers takes a similar share of the CTA's time. At
// 640^2 bs1, 10x10 tiles (256 CTAs, one wave) were faster than 8x8 (400
// CTAs, 1.5 waves) and as fast at bs16; 12 warps a CTA beat 8 and 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TY 10             // stride-4 outputs per tile: at 640^2, 256 CTAs, one wave at bs1
#define TX 10
#define NT 384            // threads of a CTA: 12 warps (8 and 16 were slower)
#define NWARPS (NT / 32)
#define F1H (2 * TY + 3)  // stem1 rows per tile (incl. halo)
#define F1W (2 * TX + 3)
#define XH (2 * F1H + 1)  // input rows per tile
#define XW (2 * F1W + 1)
#define AH (2 * TY + 2)   // stem2a rows per tile
#define AW (2 * TX + 2)
#define CH (2 * TY + 1)   // concat rows per tile
#define CW (2 * TX + 1)
#define WPR (3 * XW / 4 + 2)  // 4-byte words an input row's span may touch
#define RS (16 * ((4 * WPR + 15) / 16))  // bytes per staged input row

typedef __nv_bfloat16 bf16;

struct TcArgs {
  const uint8_t* img;
  float* out;
  const uint2* wf;  // pack_fast_weights: bf16 fragments, 4 per uint2
  const float *b1, *b2a, *b2b, *b3, *b4, *lab;
  int B, H, W, M, M2, O;
};

__host__ __device__ __forceinline__ int rup(int x, int m) { return (x + m - 1) / m * m; }
// channels per pixel in shared memory: an odd number of 16-byte chunks
__host__ __device__ __forceinline__ int cstride(int c) { return (c / 8) % 2 ? c : c + 8; }
__host__ __device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Sizes (elements or bytes) shared by the host and the kernel.
struct Layout {
  int M2p, cs1, cs2, cs3, cs4;           // channel strides: stem1, stem2a, concat, stem3
  int k2a, k2b, k3, k4;                  // padded K of stem2a, stem2b, stem3, stem4
  int w2a, w2b, w3, w4;                  // offsets (uint2) of each conv's fragments
  int t2a, t2b, t3, t4, ntab;            // offsets of each conv's k-chunk table
  int s_a, s_f1, s_cat, s_tab, s_zero, s_bias, bytes;  // shared-memory byte offsets
};

__host__ __device__ __forceinline__ Layout make_layout(int M, int M2, int O) {
  Layout L;
  L.M2p = rup(M2, 8);
  L.cs1 = cstride(M);
  L.cs2 = cstride(L.M2p);
  L.cs3 = cstride(2 * M);
  L.cs4 = cstride(M);
  L.k2a = 4 * M;  // multiples of 16 since M % 8 == 0
  L.k2b = 4 * L.M2p;
  L.k3 = 18 * M;
  L.k4 = rup(M, 16);
  L.w2a = 32 * M / 4;
  L.w2b = L.w2a + L.M2p * L.k2a / 4;
  L.w3 = L.w2b + M * L.k2b / 4;
  L.w4 = L.w3 + M * L.k3 / 4;
  L.t2a = 0;
  L.t2b = L.t2a + L.k2a / 8;
  L.t3 = L.t2b + L.k2b / 8;
  L.t4 = L.t3 + L.k3 / 8;
  L.ntab = L.t4 + L.k4 / 8;
  int off = 0;
  L.s_a = off;  // staged input bytes and their bf16 tile, then stem2a
  off += rup(imax(XH * RS + XH * XW * 3 * 2, AH * AW * L.cs2 * 2), 16);
  L.s_f1 = off;  // stem1, then stem3
  off += rup(imax(F1H * F1W * L.cs1 * 2, TY * TX * L.cs4 * 2), 16);
  L.s_cat = off;
  off += rup(CH * CW * L.cs3 * 2, 16);
  L.s_tab = off;
  off += rup(L.ntab * 4, 16);
  L.s_zero = off;  // one zero row of 8 bf16 for k-chunks past K
  off += 16;
  L.s_bias = off;  // b1, b2a (M2p), b2b, b3, b4 as f32
  off += rup(4 * (4 * M + L.M2p + O), 16);
  L.bytes = off;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lab_relu(float v, float s, float b) {
  return s * fmaxf(v, 0.f) + b;
}

// A operands of a conv on a bf16 tile in shared memory: lane l gives the row
// of pixel (mt*16 + l%16) and k-chunk 2*ks + l/16.
template <int S>
struct SmemA {
  uint32_t in, zero;
  const int* tab;
  int IW, cs, OW, NP, pix;
  __device__ __forceinline__ void begin(int mt) {
    int m = mt * 16 + (threadIdx.x & 15);
    if (m >= NP) m = NP - 1;  // rows past the tile repeat its last pixel; dropped
    const int oy = m / OW, ox = m - oy * OW;
    pix = (S * oy * IW + S * ox) * cs;
  }
  __device__ __forceinline__ void load(int ks, uint32_t (&a)[4]) const {
    const int off = tab[2 * ks + ((threadIdx.x >> 4) & 1)];
    ldsm_x4(off < 0 ? zero : in + 2 * (pix + off), a);
  }
};

// stem1's A operands from the zero-padded bf16 input tile [XH][XW*3]:
// k = (ky*3 + kx)*3 + ci, 27 taps padded to 32 (the weights of k >= 27 are
// zero, so those lanes read any finite value: the pixel's own first byte).
struct Stem1A {
  const unsigned short* xs;  // bf16 bits
  int off0[4], off1[4];      // this lane's k = 2t, 2t+1, 2t+8, 2t+9 of k-steps 0 and 1
  int base[2];               // this lane's two pixel rows
  __device__ __forceinline__ void init() {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 2 * t + (i & 1) + 8 * (i >> 1);
      off0[i] = koff(d);
      off1[i] = koff(16 + d);
    }
  }
  __device__ __forceinline__ static int koff(int k) {
    return k < 27 ? (k / 9) * (3 * XW) + ((k / 3) % 3) * 3 + k % 3 : 0;
  }
  __device__ __forceinline__ void begin(int mt) {
    const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      int m = mt * 16 + g + 8 * r;
      if (m >= F1H * F1W) m = F1H * F1W - 1;
      const int i = m / F1W;
      base[r] = 2 * i * (3 * XW) + 6 * (m - i * F1W);
    }
  }
  __device__ __forceinline__ uint32_t pair(int r, int o0, int o1) const {
    return (uint32_t)xs[base[r] + o0] | ((uint32_t)xs[base[r] + o1] << 16);
  }
  __device__ __forceinline__ void load(int ks, uint32_t (&a)[4]) const {
    int o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = ks ? off1[i] : off0[i];
    a[0] = pair(0, o[0], o[1]);
    a[1] = pair(1, o[0], o[1]);
    a[2] = pair(0, o[2], o[3]);
    a[3] = pair(1, o[2], o[3]);
  }
};

// One conv as an implicit GEMM: NP output pixels x N channels, nks k-steps
// of 16. wf: its fragments, [N/8][nks][32 lanes]. epi(m, n, v0, v1) gets the
// f32 sums of pixel m, channels n and n+1.
template <int NTI, class A, class Epi>
__device__ __forceinline__ void conv_mma(A& ld, int NP, int N, int nks, const uint2* wf,
                                         Epi epi) {
  const int lane = threadIdx.x & 31;
  const int nmt = (NP + 15) / 16, nnt = N / 8, ngr = (nnt + NTI - 1) / NTI;
  for (int item = threadIdx.x >> 5; item < nmt * ngr; item += NWARPS) {
    const int mt = item / ngr, j0 = (item - mt * ngr) * NTI;
    ld.begin(mt);
    float acc[NTI][4];
#pragma unroll
    for (int j = 0; j < NTI; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // two stages: step ks + 1's operands are loaded before step ks's products
    uint32_t a0[4], a1[4];
    uint2 b0[NTI], b1[NTI];
    auto fetch = [&](int ks, uint32_t (&a)[4], uint2 (&bf)[NTI]) {
      ld.load(ks, a);
#pragma unroll
      for (int j = 0; j < NTI; ++j)
        bf[j] = j0 + j < nnt ? wf[((j0 + j) * nks + ks) * 32 + lane] : make_uint2(0u, 0u);
    };
    fetch(0, a0, b0);
    for (int ks = 0; ks < nks; ks += 2) {
      if (ks + 1 < nks) fetch(ks + 1, a1, b1);
#pragma unroll
      for (int j = 0; j < NTI; ++j)
        if (j0 + j < nnt) mma_bf16(acc[j], a0, b0[j]);
      if (ks + 1 < nks) {
        if (ks + 2 < nks) fetch(ks + 2, a0, b0);
#pragma unroll
        for (int j = 0; j < NTI; ++j)
          if (j0 + j < nnt) mma_bf16(acc[j], a1, b1[j]);
      }
    }
    const int m = mt * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NTI; ++j) {
      if (j0 + j >= nnt) continue;
      const int n = (j0 + j) * 8 + 2 * (lane & 3);
      if (m < NP) epi(m, n, acc[j][0], acc[j][1]);
      if (m + 8 < NP) epi(m + 8, n, acc[j][2], acc[j][3]);
    }
  }
}

__global__ void __launch_bounds__(NT) stem_tc_kernel(TcArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int M = a.M, M2 = a.M2, O = a.O;
  const Layout L = make_layout(M, M2, O);
  const int H2 = a.H / 2, W2 = a.W / 2, H4 = a.H / 4, W4 = a.W / 4;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TY, ox0 = blockIdx.x * TX;
  const int r0 = 2 * oy0 - 1, s0 = 2 * ox0 - 1;  // tile origin in stem1 coordinates
  const int y0 = 2 * r0 - 1, x0 = 2 * s0 - 1;    // and in input coordinates
  uint8_t* stage = smem + L.s_a;
  bf16* s2a = reinterpret_cast<bf16*>(smem + L.s_a);
  bf16* f1 = reinterpret_cast<bf16*>(smem + L.s_f1);
  bf16* s3 = f1;
  bf16* cat = reinterpret_cast<bf16*>(smem + L.s_cat);
  int* tab = reinterpret_cast<int*>(smem + L.s_tab);
  const uint32_t zero = smem_u32(smem + L.s_zero);

  // ---- input rows by cp.async: the 4-byte words covering this tile's
  // columns of each row inside the image (W % 4 == 0 keeps rows word-aligned)
  const int lo = imax(x0, 0) * 3, hi = min(x0 + XW, a.W) * 3;
  const int wlo = lo / 4, nw = (hi + 3) / 4 - wlo;
  const int sx = 4 * wlo;  // image byte of stage column 0
  for (int i = threadIdx.x; i < XH * WPR; i += NT) {
    const int yy = i / WPR, w = i % WPR, gy = y0 + yy;
    if (w < nw && gy >= 0 && gy < a.H) {
      const uint8_t* src = a.img + ((long)b * a.H + gy) * a.W * 3 + 4 * (wlo + w);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(stage + yy * RS + 4 * w)),
                   "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // ---- k-chunk tables: offset (elements) of each 8-channel chunk from a
  // pixel's first tap, -1 past K
  for (int i = threadIdx.x; i < L.ntab; i += NT) {
    int kc, KW, Cin, IW, cs;
    if (i < L.t2b) {
      kc = i - L.t2a; KW = 2; Cin = M; IW = F1W; cs = L.cs1;
    } else if (i < L.t3) {
      kc = i - L.t2b; KW = 2; Cin = L.M2p; IW = AW; cs = L.cs2;
    } else if (i < L.t4) {
      kc = i - L.t3; KW = 3; Cin = 2 * M; IW = CW; cs = L.cs3;
    } else {
      kc = i - L.t4; KW = 1; Cin = M; IW = TX; cs = L.cs4;
    }
    const int k = kc * 8, tap = k / Cin, ci = k - tap * Cin;
    tab[i] = tap < KW * KW ? ((tap / KW) * IW + tap % KW) * cs + ci : -1;
  }
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem + L.s_zero)[threadIdx.x] = 0u;
  float* bias = reinterpret_cast<float*>(smem + L.s_bias);
  float* const bs1 = bias;
  float* const bs2a = bs1 + M;
  float* const bs2b = bs2a + L.M2p;
  float* const bs3 = bs2b + M;
  float* const bs4 = bs3 + M;
  for (int i = threadIdx.x; i < 4 * M + L.M2p + O; i += NT) {
    float v;
    if (i < M) v = __ldg(a.b1 + i);
    else if (i < M + L.M2p) v = i - M < M2 ? __ldg(a.b2a + i - M) : 0.f;
    else if (i < 2 * M + L.M2p) v = __ldg(a.b2b + i - M - L.M2p);
    else if (i < 3 * M + L.M2p) v = __ldg(a.b3 + i - 2 * M - L.M2p);
    else v = __ldg(a.b4 + i - 3 * M - L.M2p);
    bias[i] = v;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // ---- the input tile as bf16 (raw bytes are exact), zero outside the image
  // (stem1's padding)
  unsigned short* xs = reinterpret_cast<unsigned short*>(stage + XH * RS);
  for (int i = threadIdx.x; i < XH * XW * 3; i += NT) {
    const int yy = i / (3 * XW), r = i - yy * (3 * XW), gy = y0 + yy, gx = x0 + r / 3;
    float v = 0.f;
    if (gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) v = stage[yy * RS + 3 * x0 + r - sx];
    xs[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __syncthreads();

  const float* lab = a.lab;
  const uint2* __restrict__ wf = a.wf;
  // ---- stem1 3x3/s2 -> f1 [F1H x F1W][cs1]; outside [0,H2) x [0,W2) is the
  // padding of the next convs -> 0
  {
    Stem1A ld;
    ld.xs = xs;
    ld.init();
    const float ls = __ldg(lab), lb = __ldg(lab + 1);
    conv_mma<3>(ld, F1H * F1W, M, 2, wf, [&](int m, int n, float v0, float v1) {
      const int i = m / F1W, j = m - i * F1W;
      const bool ok = r0 + i >= 0 && r0 + i < H2 && s0 + j >= 0 && s0 + j < W2;
      v0 = ok ? lab_relu(v0 + bs1[n], ls, lb) : 0.f;
      v1 = ok ? lab_relu(v1 + bs1[n + 1], ls, lb) : 0.f;
      *reinterpret_cast<uint32_t*>(f1 + m * L.cs1 + n) = pack_bf16(v0, v1);
    });
  }
  __syncthreads();
  // ---- stem2a 2x2 -> s2a [AH x AW][cs2] (channels M2..M2p-1 zero), and the
  // maxpool half of the concat
  {
    SmemA<1> ld{smem_u32(f1), zero, tab + L.t2a, F1W, L.cs1, AW, AH * AW, 0};
    const float ls = __ldg(lab + 2), lb = __ldg(lab + 3);
    conv_mma<2>(ld, AH * AW, L.M2p, L.k2a / 16, wf + L.w2a,
                [&](int m, int n, float v0, float v1) {
      const int i = m / AW, j = m - i * AW;
      const bool ok = n < M2 && r0 + i >= 0 && r0 + i < H2 && s0 + j >= 0 && s0 + j < W2;
      v0 = ok ? lab_relu(v0 + bs2a[n], ls, lb) : 0.f;
      v1 = ok ? lab_relu(v1 + bs2a[n + 1], ls, lb) : 0.f;
      *reinterpret_cast<uint32_t*>(s2a + m * L.cs2 + n) = pack_bf16(v0, v1);
    });
    const int n8 = M / 8;
    for (int i = threadIdx.x; i < CH * CW * n8; i += NT) {
      const int c8 = i % n8, p = i / n8, cy = p / CW, cx = p - cy * CW;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + cy >= 0 && r0 + cy < H2 && s0 + cx >= 0 && s0 + cx < W2) {
        const bf16* f = f1 + (cy * F1W + cx) * L.cs1 + 8 * c8;
        const uint4 p00 = *reinterpret_cast<const uint4*>(f);
        const uint4 p01 = *reinterpret_cast<const uint4*>(f + L.cs1);
        const uint4 p10 = *reinterpret_cast<const uint4*>(f + F1W * L.cs1);
        const uint4 p11 = *reinterpret_cast<const uint4*>(f + (F1W + 1) * L.cs1);
        const __nv_bfloat162* q00 = reinterpret_cast<const __nv_bfloat162*>(&p00);
        const __nv_bfloat162* q01 = reinterpret_cast<const __nv_bfloat162*>(&p01);
        const __nv_bfloat162* q10 = reinterpret_cast<const __nv_bfloat162*>(&p10);
        const __nv_bfloat162* q11 = reinterpret_cast<const __nv_bfloat162*>(&p11);
        __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int e = 0; e < 4; ++e) r[e] = __hmax2(__hmax2(q00[e], q01[e]), __hmax2(q10[e], q11[e]));
      }
      *reinterpret_cast<uint4*>(cat + p * L.cs3 + 8 * c8) = v;
    }
  }
  __syncthreads();
  // ---- stem2b 2x2 -> the second half of the concat [CH x CW][cs3]
  {
    SmemA<1> ld{smem_u32(s2a), zero, tab + L.t2b, AW, L.cs2, CW, CH * CW, 0};
    const float ls = __ldg(lab + 4), lb = __ldg(lab + 5);
    conv_mma<3>(ld, CH * CW, M, L.k2b / 16, wf + L.w2b,
                [&](int m, int n, float v0, float v1) {
      const int i = m / CW, j = m - i * CW;
      const bool ok = r0 + i >= 0 && r0 + i < H2 && s0 + j >= 0 && s0 + j < W2;
      v0 = ok ? lab_relu(v0 + bs2b[n], ls, lb) : 0.f;
      v1 = ok ? lab_relu(v1 + bs2b[n + 1], ls, lb) : 0.f;
      *reinterpret_cast<uint32_t*>(cat + m * L.cs3 + M + n) = pack_bf16(v0, v1);
    });
  }
  __syncthreads();
  // ---- stem3 3x3/s2 -> s3 [TY x TX][cs4] (in stem1's buffer, free by now)
  {
    SmemA<2> ld{smem_u32(cat), zero, tab + L.t3, CW, L.cs3, TX, TY * TX, 0};
    const float ls = __ldg(lab + 6), lb = __ldg(lab + 7);
    conv_mma<1>(ld, TY * TX, M, L.k3 / 16, wf + L.w3, [&](int m, int n, float v0, float v1) {
      v0 = lab_relu(v0 + bs3[n], ls, lb);
      v1 = lab_relu(v1 + bs3[n + 1], ls, lb);
      *reinterpret_cast<uint32_t*>(s3 + m * L.cs4 + n) = pack_bf16(v0, v1);
    });
  }
  __syncthreads();
  // ---- stem4 1x1 -> f32 NHWC in device memory
  {
    SmemA<1> ld{smem_u32(s3), zero, tab + L.t4, TX, L.cs4, TX, TY * TX, 0};
    const float ls = __ldg(lab + 8), lb = __ldg(lab + 9);
    conv_mma<2>(ld, TY * TX, O, L.k4 / 16, wf + L.w4, [&](int m, int n, float v0, float v1) {
      const int oy = oy0 + m / TX, ox = ox0 + m % TX;
      if (oy >= H4 || ox >= W4) return;
      float2 v;
      v.x = lab_relu(v0 + bs4[n], ls, lb);
      v.y = lab_relu(v1 + bs4[n + 1], ls, lb);
      *reinterpret_cast<float2*>(a.out + (((long)b * H4 + oy) * W4 + ox) * O + n) = v;
    });
  }
}

extern "C" size_t stem_tc_smem_bytes(int M, int M2, int O) {
  return (size_t)make_layout(M, M2, O).bytes;
}

// Pointers are device pointers: img uint8, out f32, wf bf16 (pack_fast_weights),
// biases f32, lab f32 [5][2] (scale, bias) per conv.
extern "C" int stem_tc_fwd(const void* img, void* out, const void* wf, const void* b1,
                           const void* b2a, const void* b2b, const void* b3, const void* b4,
                           const void* lab, int B, int H, int W, int M, int M2, int O,
                           void* stream) {
  if (H % 4 || W % 4 || M % 8 || O % 8 || M2 % 2 || M2 < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const size_t smem = stem_tc_smem_bytes(M, M2, O);
  cudaError_t e = cudaFuncSetAttribute(stem_tc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  TcArgs a;
  a.img = (const uint8_t*)img;
  a.out = (float*)out;
  a.wf = (const uint2*)wf;
  a.b1 = (const float*)b1;  a.b2a = (const float*)b2a; a.b2b = (const float*)b2b;
  a.b3 = (const float*)b3;  a.b4 = (const float*)b4;  a.lab = (const float*)lab;
  a.B = B; a.H = H; a.W = W; a.M = M; a.M2 = M2; a.O = O;
  dim3 grid((W / 4 + TX - 1) / TX, (H / 4 + TY - 1) / TY, B);
  stem_tc_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
