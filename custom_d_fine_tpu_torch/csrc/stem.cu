// The whole eval-mode HGNetv2 StemBlock in one kernel, exact f32, for Hopper
// (sm_90a).
//
// Replaces custom_d_fine_tpu/ops/pallas/stem.py:_stem_kernel with fast=False
// (Precision.HIGHEST). Function, with every BatchNorm folded into its conv
// (ops/stem.py:fold_stem_weights) and the 1/255 input normalisation folded
// into w1:
//   stem1 3x3/s2 pad 1 -> pad (0,1) -> { stem2a 2x2 -> pad (0,1) -> stem2b 2x2
//   | maxpool 2x2/s1 } -> concat [pool, stem2b] -> stem3 3x3/s2 pad 1 -> stem4 1x1,
// each conv followed by ReLU and then the LAB affine (scale 1, bias 0 without LAB).
// In: uint8 [B,H,W,3] raw pixels (H%4 == 0, W%4 == 0). Out: f32 [B,H/4,W/4,O].
// Every product and sum is an f32 FMA on the CUDA cores (no tensor cores, no
// TF32): the reference's exact mode. csrc/stem_tc.cu is the fast one.
//
// Bound on the H100: per 640^2 image the function does ~1.17 GFLOP
// (stem1 0.13, stem2a 0.24, stem2b 0.24, stem3 0.53, stem4 0.04) and moves
// 1.2 MB in + 3.3 MB out, so it is bound by f32 operations (~17.5 us at the
// 67 TFLOP/s non-tensor-core f32 rate), not by bytes (~1.4 us).
//
// Design. One CTA (8 warps) per (image, 10x10 tile of the stride-4 output):
// at 640^2, 256 CTAs, one wave at two CTAs an SM. The CTA stages its halo'd
// 47x47x3 input tile in shared memory and runs the five convs and the maxpool
// there; only the stride-4 output reaches device memory. The halo costs
// ~1.10x the stem's work (stem1 at 23x23, stem2a 22x22, concat 21x21 for
// 20x20 useful positions).
// - Register blocking: a thread computes P pixels x G output channels of a
//   conv (stem1 7x8, stem2a 4x12, stem2b 4x12, stem3 5x12, stem4 2x8).
// - Layouts: every map in shared memory holds pixels of 4 channels
//   ([C/4][pixel][4]), so one 16-byte read gives 4 input channels of a pixel
//   and feeds 4*G FMAs, and one 16-byte weight read (4 output channels of one
//   input channel, the same for all lanes of a channel group) feeds 4*P. The
//   maps that a stride-2 conv reads (the input tile, both halves of the
//   concat) are stored as four polyphase sub-images (row parity, column
//   parity), so a stride-2 tap reads consecutive pixels in consecutive lanes,
//   as a stride-1 tap does: no bank conflicts. The taps are unrolled and the
//   channels run in an inner loop, so every shared-memory offset is an
//   immediate on one base register.
// - Weights stay in device memory and are read through the read-only cache.
// - Balance: each conv's items fill one round of the 256 threads at B2
//   (stem1 237, stem2a 254, stem2b 232, stem4 200). stem2a splits its input
//   channels in two halves, which meet in its output map. stem3 (45% of the
//   FLOPs) is split into its pool half, run while stem1's map is still alive
//   (before stem2a), and its stem2b half, each over input channels into KS
//   parts (6 at B2: 240 items), whose partial sums meet in shared memory in a
//   fixed order.
// - Shared memory per CTA, floats: Y = max(9216 (input), 484*M (pool),
//   100*KS*M (partial sums), 100*M + 484*M2 (stem3's pool half, stem2a)) and
//   X = 529*M (stem1, then stem2b), plus slack: 108.9 KB for B2 (M=24,
//   M2=12; two CTAs an SM), 71.2 KB for B0, 130.2 KB for B4/B5 and 195.0 KB
//   for B6 (one CTA an SM). Any M, M2, O that are multiples of 4 and fit.
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3 at 700.00 W), B2
// widths at 640^2: bs1 0.0617 ms device time (19.0 TFLOP/s, 3.5x the bound),
// bs16 1.0035 ms (3.6x the 0.28 ms bound). The previous design (one 8x8 tile
// a CTA, 400 CTAs at 640^2, one pixel x 4-8 channels a thread, channel-major
// maps with 2-way bank conflicts on the stride-2 reads, 2 FFMA per load in
// its SASS) ran 0.2019-0.2036 ms and 2.564 ms in the same call.
// What sets the pace: the FFMA stream, at 28% of the f32 peak. Variants
// timed and dropped: every activation and weight load of the convs replaced
// by register values (as slow: the loads are not the limit), the weights
// prefetched into L1, the taps rolled, 12 warps a CTA (spills), one CTA an
// SM without the register cap (all as slow or slower). ptxas gives ~64% of
// the FFMAs two source registers of the same parity, one register bank
// (chip_smoke.py counts them in the SASS); a variant that moved some of
// stem3's accumulators to the other parity (60%) ran no faster, so what holds
// the FFMA issue rate near half is not settled.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256  // threads of a CTA
#define TY 10   // stride-4 outputs per tile
#define TX 10

namespace {

// ---- tile geometry, in pixels. Tile origin in stem1 coordinates: r0 = 2*oy0 - 1.
constexpr int F1H = 2 * TY + 3, F1W = 2 * TX + 3;  // stem1 23 x 23
constexpr int XH = 2 * F1H + 1, XW = 2 * F1W + 1;  // input 47 x 47
constexpr int AH = 2 * TY + 2, AW = 2 * TX + 2;    // stem2a 22 x 22
constexpr int CH = 2 * TY + 1, CW = 2 * TX + 1;    // concat 21 x 21
constexpr int NPIX = TY * TX;                      // stem3 / stem4 outputs
// input tile: 4 polyphase sub-images XSH x XSW of (r, g, b, 0) pixels
constexpr int XSH = (XH + 1) / 2, XSW = (XW + 1) / 2, XSUB = XSH * XSW, XPLANE = 4 * XSUB;
constexpr int RS1 = F1W, PL1 = F1H * RS1;  // stem1, natural
constexpr int RSA = AW, PLA = AH * RSA;    // stem2a, natural
// concat halves (pool, stem2b): 4 polyphase sub-images CSH x CSW
constexpr int CSH = (CH + 1) / 2, CSW = (CW + 1) / 2, CSUB = CSH * CSW, CPLANE = 4 * CSUB;
constexpr int SLACK = 64;  // floats after a region: spare pixels of the last block read there

// ---- register blocking of each conv: P pixels x G channels a thread.
// stem1, stem2a, stem2b and stem4 walk their output rows at the input map's
// row stride (the columns past the output's width are spare, not stored),
// pixel p of block b at b + p*NB; stem3 walks the 10x10 tile in column
// strips, pixel p of block b at row b/TX + 2p, column b%TX.
constexpr int P1 = 7, G1 = 8, NB1 = (F1H * XSW + P1 - 1) / P1;       // 79
constexpr int P2A = 4, G2A = 12, NB2A = (AH * RS1 + P2A - 1) / P2A;  // 127
constexpr int P2B = 4, G2B = 12, NB2B = (CH * RSA + P2B - 1) / P2B;  // 116
constexpr int P3 = 5, G3 = 12, NB3 = NPIX / P3;                      // 20
constexpr int P4 = 2, G4 = 8, NB4 = NPIX / P4;                       // 50
static_assert(P3 * 2 == TY && NB3 == 2 * TX, "stem3's strips cover the tile");
static_assert(NPIX % P4 == 0, "stem4's blocks cover the tile");

struct StemArgs {
  const uint8_t* img;
  float* out;
  const float *w1, *b1, *w2a, *b2a, *w2b, *b2b, *w3, *b3, *w4, *b4, *lab;
  int B, H, W, M, M2, O, ks;  // ks: stem3's parts over input channels
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// stem3's channel group size for M outputs, and its parts over input
// channels: as many (up to 6) as keep its items within one round of the CTA
__host__ __device__ inline int stem3_group(int M) { return M >= G3 ? G3 : 4; }
__host__ __device__ inline int stem3_parts(int M) {
  const int ncg = (M + stem3_group(M) - 1) / stem3_group(M);
  return imax(1, imin(imin(6, M / 4), NT / (NB3 * ncg)));
}

// Float offsets of the two regions in shared memory; host and device agree.
// Y: input tile, pool, partial sums, stem3's pool half + stem2a. X: stem1, then stem2b.
struct Layout {
  int x, floats;
};
__host__ __device__ inline Layout make_layout(int M, int M2) {
  const int ks = stem3_parts(M);
  int y = imax(4 * XPLANE, M * CPLANE);
  y = imax(y, ks * M * NPIX);
  y = imax(y, M * NPIX + M2 * PLA);
  Layout L;
  L.x = y + SLACK;
  // stem3's second-half partial sums follow its first half's sums
  L.floats = imax(L.x + M * PL1 + SLACK, (1 + ks) * M * NPIX);
  return L;
}

// tap t = ky*K + kx of each conv, as an offset in pixels from the pixel's base
struct TapsIn {  // 3x3/s2 on the polyphase input tile
  static constexpr int n = 9;
  __host__ __device__ static constexpr int off(int t) {
    return (((t / 3) & 1) * 2 + ((t % 3) & 1)) * XSUB + ((t / 3) >> 1) * XSW + ((t % 3) >> 1);
  }
};
struct TapsCat {  // 3x3/s2 on a polyphase concat half
  static constexpr int n = 9;
  __host__ __device__ static constexpr int off(int t) {
    return (((t / 3) & 1) * 2 + ((t % 3) & 1)) * CSUB + ((t / 3) >> 1) * CSW + ((t % 3) >> 1);
  }
};
template <int RS>
struct Taps2 {  // 2x2/s1 on a natural map with row stride RS
  static constexpr int n = 4;
  __host__ __device__ static constexpr int off(int t) { return (t >> 1) * RS + (t & 1); }
};
struct Taps1 {
  static constexpr int n = 1;
  __host__ __device__ static constexpr int off(int) { return 0; }
};

__device__ __forceinline__ float part_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// acc[p][g] += sum over taps t and input channels c = 4*c4 + cc (c4 < n4, cc < CPG) of
//   in[c4*PLANE + p*JSTEP + Taps::off(t)] (channel cc) * w[t*wtap + c*cout + g],
// with `in` at the block's first pixel and `w` at (first input channel,
// first output channel). The taps are unrolled inside the loop over input
// channels, so that the loads of one tap can be issued under the FMAs of the
// one before.
template <int P, int G, int PLANE, int JSTEP, class Taps, int CPG = 4>
__device__ __forceinline__ void mac(float (&acc)[P][G], const float4* in,
                                    const float* __restrict__ w, int wtap, int cout, int n4) {
  auto step = [&](const float4* ip, const float* wp) {
    float4 a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) a[p] = ip[p * JSTEP];
#pragma unroll
    for (int cc = 0; cc < CPG; ++cc) {
      const float4* wr = reinterpret_cast<const float4*>(wp + cc * cout);
#pragma unroll
      for (int v = 0; v < G / 4; ++v) {
        const float4 wv = __ldg(wr + v);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float x = part_of(a[p], cc);
          acc[p][4 * v] = fmaf(x, wv.x, acc[p][4 * v]);
          acc[p][4 * v + 1] = fmaf(x, wv.y, acc[p][4 * v + 1]);
          acc[p][4 * v + 2] = fmaf(x, wv.z, acc[p][4 * v + 2]);
          acc[p][4 * v + 3] = fmaf(x, wv.w, acc[p][4 * v + 3]);
        }
      }
    }
  };
  if constexpr (Taps::n == 1) {
#pragma unroll 4
    for (int c4 = 0; c4 < n4; ++c4) step(in + c4 * PLANE, w + 4 * c4 * cout);
  } else {
#pragma unroll 1
    for (int c4 = 0; c4 < n4; ++c4) {
#pragma unroll
      for (int t = 0; t < Taps::n; ++t)
        step(in + c4 * PLANE + Taps::off(t), w + t * wtap + 4 * c4 * cout);
    }
  }
}

template <int P, int G>
__device__ __forceinline__ void zero(float (&acc)[P][G]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int g = 0; g < G; ++g) acc[p][g] = 0.f;
}

template <int P, int G>
__device__ __forceinline__ float4 acc4(const float (&acc)[P][G], int p, int v) {
  return make_float4(acc[p][4 * v], acc[p][4 * v + 1], acc[p][4 * v + 2], acc[p][4 * v + 3]);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float act(float v, float ls, float lb) {
  return ls * fmaxf(v, 0.f) + lb;
}

// LAB(relu(v + bias)) of 4 channels, or 0 (the next map's zero padding)
__device__ __forceinline__ float4 act4(float4 v, const float* __restrict__ bias, float ls,
                                       float lb, bool valid) {
  if (!valid) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 b = __ldg(reinterpret_cast<const float4*>(bias));
  return make_float4(act(v.x + b.x, ls, lb), act(v.y + b.y, ls, lb), act(v.z + b.z, ls, lb),
                     act(v.w + b.w, ls, lb));
}

__device__ __forceinline__ bool inside(int r, int s, int h, int w) {
  return r >= 0 && r < h && s >= 0 && s < w;
}

// Channel group cg of a conv with `cout` outputs (cout % 4 == 0, cout >= G):
// the first channel it stores and the first it computes. The last group, if
// partial, is shifted left so that its weight reads stay inside the row; the
// channels it shares with the group before are computed twice, stored once.
// A conv with fewer outputs than its G runs with G = 4 instead.
struct Group {
  int store0, co;
};
template <int G>
__device__ __forceinline__ Group group(int cg, int cout) {
  Group r;
  r.store0 = cg * G;
  r.co = r.store0 + G <= cout ? r.store0 : cout - G;
  return r;
}

// ---- a conv whose blocks of P pixels walk the OH x OW output at the input
// map's row stride RS_IN (pixel p of block b at b + p*NB; the columns from OW
// to RS_IN are spare and not stored), from `in` (maps of PLANE_IN pixels)
// into `dst(c4, row, col)`. Outputs whose global position (r0+row, s0+col)
// lies outside [0,H2) x [0,W2) are the next map's zero padding. With KS = 2
// the input channels are split in two halves, one item a thread (NB * groups
// * 2 <= NT): after a barrier the second half's items store their sums into
// the output, after another the first half's add theirs there.
template <int P, int G, int KS, int RS_IN, int PLANE_IN, int NB, int OH, int OW, class Taps,
          int CPG, class Dst>
__device__ __forceinline__ void conv_rows(const float4* in, int cin, int cout,
                                          const float* __restrict__ w,
                                          const float* __restrict__ bias, float ls, float lb,
                                          int r0, int s0, int H2, int W2, Dst dst) {
  const int ncg = (cout + G - 1) / G;
  const int n4 = (cin + 3) / 4, h4 = (n4 + KS - 1) / KS;
  for (int it0 = 0; it0 < NB * ncg * KS; it0 += NT) {
    const int it = it0 + threadIdx.x;
    const bool busy = it < NB * ncg * KS;
    const int b = it % NB, k = it / (NB * ncg);
    const Group gr = group<G>((it / NB) % ncg, cout);
    float acc[P][G];
    zero(acc);
    if (busy) {
      const int c4 = k * h4;
      mac<P, G, PLANE_IN, NB, Taps, CPG>(acc, in + c4 * PLANE_IN + b, w + 4 * c4 * cout + gr.co,
                                         cin * cout, cout, imax(0, imin(h4, n4 - c4)));
    }
    for (int half = KS - 1; half >= 0; --half) {
      if (KS > 1) __syncthreads();
      if (!busy || k != half) continue;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int q = b + p * NB;
        const int row = q / RS_IN, col = q % RS_IN;
        if (row >= OH || col >= OW) continue;
        const bool valid = inside(r0 + row, s0 + col, H2, W2);
#pragma unroll
        for (int v = 0; v < G / 4; ++v) {
          const int co = gr.co + 4 * v;
          if (co < gr.store0) continue;
          float4& d = dst(co / 4, row, col);
          const float4 s = acc4(acc, p, v);
          d = half ? s : act4(KS > 1 ? add4(d, s) : s, bias + co, ls, lb, valid);
        }
      }
    }
  }
}

// ---- stem3, one concat half (`half` 0: pool, 1: stem2b) into partial sums
// part[(k*M/4 + c4)*NPIX + pix] (4 channels each) of its KS parts over the
// half's input channels. At most one item a thread (KS is chosen so). The
// partial sums are written after a barrier, so they may overwrite `in`.
template <int G>
__device__ __forceinline__ void stem3_half(const float4* in, float4* part, int half, int M,
                                           int ks, const float* __restrict__ w3) {
  const int ncg = (M + G - 1) / G;
  const int n4 = M / 4, per = (n4 + ks - 1) / ks;
  const int it = threadIdx.x;
  const bool busy = it < NB3 * ncg * ks;
  const int b = it % NB3, k = it / (NB3 * ncg);
  const Group gr = group<G>((it / NB3) % ncg, M);
  float acc[P3][G];
  zero(acc);
  if (busy) {
    const int c4 = k * per;
    mac<P3, G, CPLANE, 2 * CSW, TapsCat>(acc, in + c4 * CPLANE + (b / TX) * CSW + b % TX,
                                          w3 + (half * M + 4 * c4) * M + gr.co, 2 * M * M, M,
                                          imax(0, imin(per, n4 - c4)));
  }
  __syncthreads();
  if (busy) {
#pragma unroll
    for (int p = 0; p < P3; ++p) {
      const int pix = (b / TX + 2 * p) * TX + b % TX;
#pragma unroll
      for (int v = 0; v < G / 4; ++v)
        if (gr.co + 4 * v >= gr.store0)
          part[(k * n4 + (gr.co + 4 * v) / 4) * NPIX + pix] = acc4(acc, p, v);
    }
  }
  __syncthreads();
}

// ---- stem4 1x1 from F [M/4][NPIX] into device memory, NHWC
template <int G>
__device__ __forceinline__ void stem4(const float4* F, const StemArgs& a, int bimg, int oy0,
                                      int ox0, int H4, int W4) {
  const int O = a.O;
  const float ls = __ldg(a.lab + 8), lb = __ldg(a.lab + 9);
  const int ncg = (O + G - 1) / G;
  for (int it = threadIdx.x; it < NB4 * ncg; it += NT) {
    const int b = it % NB4;
    const Group gr = group<G>(it / NB4, O);
    float acc[P4][G];
    zero(acc);
    mac<P4, G, NPIX, NB4, Taps1>(acc, F + b, a.w4 + gr.co, 0, O, a.M / 4);
#pragma unroll
    for (int p = 0; p < P4; ++p) {
      const int pix = b + p * NB4;
      const int oy = oy0 + pix / TX, ox = ox0 + pix % TX;
      if (oy >= H4 || ox >= W4) continue;
      float4* o = reinterpret_cast<float4*>(a.out + (((size_t)bimg * H4 + oy) * W4 + ox) * O);
#pragma unroll
      for (int v = 0; v < G / 4; ++v) {
        const int co = gr.co + 4 * v;
        if (co >= gr.store0) o[co / 4] = act4(acc4(acc, p, v), a.b4 + co, ls, lb, true);
      }
    }
  }
}

__global__ void __launch_bounds__(NT, 2) stem_kernel(StemArgs a) {
  extern __shared__ float4 smem[];
  const int M = a.M, M2 = a.M2, ks = a.ks;
  const int H2 = a.H / 2, W2 = a.W / 2, H4 = a.H / 4, W4 = a.W / 4;
  const int bimg = blockIdx.z;
  const int oy0 = blockIdx.y * TY, ox0 = blockIdx.x * TX;
  const int r0 = 2 * oy0 - 1, s0 = 2 * ox0 - 1;
  float4* Y = smem;
  float4* X = smem + make_layout(M, M2).x / 4;
  const int tid = threadIdx.x;

  // ---- input tile (rows 2*r0-1 ..), zero outside the image (stem1's padding),
  // as (r, g, b, 0) pixels in polyphase sub-images; all loads in flight at once
  {
    const int y0 = 2 * r0 - 1, x0 = 2 * s0 - 1;
    const uint8_t* img = a.img + (size_t)bimg * a.H * a.W * 3;
#pragma unroll
    for (int k = 0; k < (XH * XW + NT - 1) / NT; ++k) {
      const int i = tid + k * NT;
      const int xx = i % XW, yy = i / XW;
      const int gy = y0 + yy, gx = x0 + xx;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < XH * XW && inside(gy, gx, a.H, a.W)) {
        const uint8_t* px = img + ((size_t)gy * a.W + gx) * 3;
        v.x = __ldg(px);
        v.y = __ldg(px + 1);
        v.z = __ldg(px + 2);
      }
      if (i < XH * XW) Y[((yy & 1) * 2 + (xx & 1)) * XSUB + (yy >> 1) * XSW + (xx >> 1)] = v;
    }
  }
  __syncthreads();

  // ---- stem1 3x3/s2 -> X (natural 23x23); rows/cols >= H2/W2 are the
  // asymmetric (0,1) pad and rows/cols < 0 lie outside the map: both 0
  {
    auto dst = [&](int c4, int row, int col) -> float4& { return X[c4 * PL1 + row * RS1 + col]; };
    const float ls = __ldg(a.lab), lb = __ldg(a.lab + 1);
    if (M >= G1)
      conv_rows<P1, G1, 1, XSW, XPLANE, NB1, F1H, F1W, TapsIn, 3>(Y, 3, M, a.w1, a.b1, ls, lb,
                                                                  r0, s0, H2, W2, dst);
    else
      conv_rows<P1, 4, 1, XSW, XPLANE, NB1, F1H, F1W, TapsIn, 3>(Y, 3, M, a.w1, a.b1, ls, lb, r0,
                                                                 s0, H2, W2, dst);
  }
  __syncthreads();

  // ---- maxpool 2x2/s1 of the padded stem1 map -> Y (concat half 0,
  // polyphase); positions outside [0,H2) x [0,W2) are stem3's zero padding
#pragma unroll 4
  for (int i = tid; i < CH * CW * (M / 4); i += NT) {
    const int pos = i % (CH * CW), c4 = i / (CH * CW);
    const int cy = pos / CW, cx = pos % CW;
    const float4* s = X + c4 * PL1 + cy * RS1 + cx;
    const float4 u = s[0], v = s[1], w = s[RS1], z = s[RS1 + 1];
    float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
    if (inside(r0 + cy, s0 + cx, H2, W2))
      m = make_float4(fmaxf(fmaxf(u.x, v.x), fmaxf(w.x, z.x)), fmaxf(fmaxf(u.y, v.y), fmaxf(w.y, z.y)),
                      fmaxf(fmaxf(u.z, v.z), fmaxf(w.z, z.z)), fmaxf(fmaxf(u.w, v.w), fmaxf(w.w, z.w)));
    Y[c4 * CPLANE + ((cy & 1) * 2 + (cx & 1)) * CSUB + (cy >> 1) * CSW + (cx >> 1)] = m;
  }
  __syncthreads();

  // ---- stem3 over the pool half: partial sums over Y, then summed in place
  // into Y[0, M/4*NPIX), which holds them until stem3's end
  if (M >= G3)
    stem3_half<G3>(Y, Y, 0, M, ks, a.w3);
  else
    stem3_half<4>(Y, Y, 0, M, ks, a.w3);
  for (int i = tid; i < M / 4 * NPIX; i += NT) {
    float4 s = Y[i];
    for (int k = 1; k < ks; ++k) s = add4(s, Y[k * (M / 4) * NPIX + i]);
    Y[i] = s;
  }
  __syncthreads();

  // ---- stem2a 2x2 on the padded stem1 map -> A (natural 22x22); its own
  // (0,1) pad -> 0. With 12 outputs or fewer groups than fill the CTA twice,
  // its input channels are split in two halves.
  float4* A = Y + M / 4 * NPIX;
  {
    auto dst = [&](int c4, int row, int col) -> float4& { return A[c4 * PLA + row * RSA + col]; };
    const float ls = __ldg(a.lab + 2), lb = __ldg(a.lab + 3);
    if (M2 < G2A)
      conv_rows<P2A, 4, 1, RS1, PL1, NB2A, AH, AW, Taps2<RS1>, 4>(X, M, M2, a.w2a, a.b2a, ls,
                                                                  lb, r0, s0, H2, W2, dst);
    else if (NB2A * ((M2 + G2A - 1) / G2A) * 2 <= NT)
      conv_rows<P2A, G2A, 2, RS1, PL1, NB2A, AH, AW, Taps2<RS1>, 4>(X, M, M2, a.w2a, a.b2a, ls,
                                                                    lb, r0, s0, H2, W2, dst);
    else
      conv_rows<P2A, G2A, 1, RS1, PL1, NB2A, AH, AW, Taps2<RS1>, 4>(X, M, M2, a.w2a, a.b2a, ls,
                                                                    lb, r0, s0, H2, W2, dst);
  }
  __syncthreads();

  // ---- stem2b 2x2 on the padded stem2a map -> X (concat half 1,
  // polyphase); positions outside [0,H2) x [0,W2) are stem3's zero padding
  {
    auto dst = [&](int c4, int row, int col) -> float4& {
      return X[c4 * CPLANE + ((row & 1) * 2 + (col & 1)) * CSUB + (row >> 1) * CSW + (col >> 1)];
    };
    const float ls = __ldg(a.lab + 4), lb = __ldg(a.lab + 5);
    if (M >= G2B)
      conv_rows<P2B, G2B, 1, RSA, PLA, NB2B, CH, CW, Taps2<RSA>, 4>(A, M2, M, a.w2b, a.b2b, ls,
                                                                    lb, r0, s0, H2, W2, dst);
    else
      conv_rows<P2B, 4, 1, RSA, PLA, NB2B, CH, CW, Taps2<RSA>, 4>(A, M2, M, a.w2b, a.b2b, ls, lb,
                                                                  r0, s0, H2, W2, dst);
  }
  __syncthreads();

  // ---- stem3 over the stem2b half: partial sums after the pool half's sums;
  // then F = LAB(relu(both halves + bias)), in place of part 0
  float4* part = Y + M / 4 * NPIX;
  if (M >= G3)
    stem3_half<G3>(X, part, 1, M, ks, a.w3);
  else
    stem3_half<4>(X, part, 1, M, ks, a.w3);
  {
    const float ls = __ldg(a.lab + 6), lb = __ldg(a.lab + 7);
    for (int i = tid; i < M / 4 * NPIX; i += NT) {
      float4 s = Y[i];
      for (int k = 0; k < ks; ++k) s = add4(s, part[k * (M / 4) * NPIX + i]);
      part[i] = act4(s, a.b3 + 4 * (i / NPIX), ls, lb, true);
    }
  }
  __syncthreads();

  // ---- stem4 1x1 -> device memory
  if (a.O >= G4)
    stem4<G4>(part, a, bimg, oy0, ox0, H4, W4);
  else
    stem4<4>(part, a, bimg, oy0, ox0, H4, W4);
}

}  // namespace

extern "C" size_t stem_smem_bytes(int M, int M2) {
  return sizeof(float) * (size_t)make_layout(M, M2).floats;
}

// Pointers are device pointers; lab is [5][2] (scale, bias) per conv.
extern "C" int stem_fwd(const void* img, void* out, const void* w1, const void* b1,
                        const void* w2a, const void* b2a, const void* w2b, const void* b2b,
                        const void* w3, const void* b3, const void* w4, const void* b4,
                        const void* lab, int B, int H, int W, int M, int M2, int O,
                        void* stream) {
  if (H % 4 || W % 4 || M % 4 || M2 % 4 || O % 4) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return 0;
  const size_t smem = stem_smem_bytes(M, M2);
  cudaError_t e = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(stem_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  StemArgs a;
  a.img = (const uint8_t*)img;
  a.out = (float*)out;
  a.w1 = (const float*)w1;  a.b1 = (const float*)b1;
  a.w2a = (const float*)w2a; a.b2a = (const float*)b2a;
  a.w2b = (const float*)w2b; a.b2b = (const float*)b2b;
  a.w3 = (const float*)w3;  a.b3 = (const float*)b3;
  a.w4 = (const float*)w4;  a.b4 = (const float*)b4;
  a.lab = (const float*)lab;
  a.B = B; a.H = H; a.W = W; a.M = M; a.M2 = M2; a.O = O;
  a.ks = stem3_parts(M);
  dim3 grid((W / 4 + TX - 1) / TX, (H / 4 + TY - 1) / TY, B);
  stem_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
