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
// Bound on the H100: bytes. A call must read the value rows that valid
// corners touch, loc and attn, and write out; ~10 flops per sampled channel
// is far below the f32 roof. At D-FINE-m 640^2 (8 heads x 32 channels,
// levels 80^2/40^2/20^2, points 3/6/3) that is ~2.7 MB at bs1 (0.8 us at
// 3.35 TB/s) and ~58.8 MB for the training step's bs16 x 500 queries with a
// bf16 value map (17.5 us), on chip_smoke.py's data.
//
// The first design: one warp per (b, q, head), one lane per channel,
// a loop over the points with runtime trip counts. Every lane loaded the same
// loc pair and attn value, recomputed the same corners, then issued up to four
// 2-byte (bf16) or 4-byte loads whose addresses came from the loc load: two
// dependent memory round trips per point, ~24 in series per warp, and 64 B
// per load instruction at c = 32 in bf16. It took 0.1169 ms at the training
// shapes (6.7x the bound), 0.0079 ms at bs1 with a bf16 value map and
// 0.0108 ms with an f32 one (H100 80GB HBM3, 700 W).
//
// This design: a warp serves G items (b, q, head) at once; its lanes are
// slots of S = 2^lg lanes, SPI = 32 / (S * G) slots per item.
// 1. Points are prepared once, one lane per point: the lanes load loc (as
//    float2) and attn coalesced, find the point's level, and compute its
//    top-left corner's row offset, which corners lie inside the map, and the
//    four bilinear weights times attn.
// 2. A slot takes one point per round and fetches the point's offset, mask
//    and weights from the preparing lane with __shfl_sync. Its lanes each
//    hold V channels: 16 bytes (8 bf16 or 4 f32), so at c = 32 in bf16 a
//    slot is 4 lanes and a warp serves 8 points per round. Each slot issues
//    the four corner loads of RU = 2 rounds before it uses any of them.
// 3. G is the smallest count of items per warp that leaves no slot idle in
//    the last round: G = 2 at 12 points in bf16 (two items of 4 slots, 3
//    rounds), G = 1 in f32 (4 slots of 8 lanes, 3 rounds).
// 4. The slots of an item are summed by halving exchanges over the slot bits
//    (each step a lane sends half of its channels to its partner and keeps
//    the sum of the other half), so a lane ends with V / SPI channels (more
//    xor steps where SPI > V), and each item's row of out is one coalesced
//    128-byte segment of one store instruction (8 B a lane in bf16, 4 B in
//    f32, at c = 32).
// 5. Where c is not a multiple of V or a pointer is not 16-byte aligned, the
//    same kernel runs with V = 1 (one channel a lane); c > 32 V loops over
//    groups of 32 V channels; more than 32 points are prepared 32 at a time.
// Items of one image are neighbours in the grid, so its value map stays in L2.
//
// Measured on one H100 80GB HBM3 at 700 W (chip_smoke.py; the variants below
// were built from this source with other constants and timed in one call
// beside the first design): 0.0034 ms at bs1 bf16, 0.0038 f32, 0.0454 at the
// training shapes (first design 0.0078, 0.0103, 0.1163). A clock64 probe in a
// diagnostic build (since removed) split a warp's time:
// at bs1 all 1,200 warps start within 0.1 us and each takes 2.4 us, ~1,860
// cycles until its loc/attn arrive and ~2,480 until its corner rows are
// summed; the launch and those two dependent round trips are the bs1 time,
// 4x the byte bound. At the training shapes 32,000 warps of 3.4 us each
// (2,430 + 3,700 cycles) run in waves of ~20 warps an SM (94 registers).
// Tried and dropped (training / bs1 bf16 / bs1 f32, ms):
// - RU = 3 or 4 (all rounds in flight): 0.0462 / 0.0034 / 0.0049-0.0050;
//   109-128 registers leave 16 warps an SM, too few for bs1 f32's 2,400.
// - capping registers (launch bounds) at 64 or 80: spills, 0.050-0.23.
// - 2 or 8 warps a block: 0.0450 / 0.0034 / 0.0040 and 0.0524 / 0.0036 / 0.0040.
// - one item a warp (no packing): 0.0673 at training.
// - a grid of resident warps that loop over groups, loading the next group's
//   loc/attn while this group's rows arrive: 105 registers, 0.0482 / 0.0037 / 0.0053.
// - asking L2 for the loc/attn of the groups one wave ahead
//   (prefetch.global.L2): 0.0441 against 0.0454, not worth its code.
// - one block per (b, head) that first copies the 40^2 and 20^2 levels of its
//   head into shared memory (128 KB in bf16): 0.0493 with 24 warps, 0.0585
//   with 16, 0.0971 with 8, against 0.0456. One block an SM is too few warps
//   to hide the loads, and all 16 images run at once, so the 80^2 level's
//   rows no longer stay in L2.

#include <stdint.h>

#include "msda_common.cuh"

constexpr int kWarps = 4;  // warps of a block
constexpr int kRU = 2;     // rounds of points whose corner loads a slot issues before any use

// The lanes of a warp: G items x (1 << lgs) slots x (1 << lg) lanes, and
// the points of each item that one preparation covers (pb; lane = g * pb + point).
struct FwdLayout {
  int lg, lgs, G, pb, nchunk;
};

template <typename T, int V>
__global__ void __launch_bounds__(32 * kWarps) msda_fwd_kernel(
    const T* __restrict__ value, const float* __restrict__ loc,
    const float* __restrict__ attn, float* __restrict__ out,
    int Lv, int nh, int c, int Lq, int Ptot, long items, Levels lv, FwdLayout ly) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long item0 = ((long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * ly.G;
  if (item0 >= items) return;  // whole warps leave together
  const int S = 1 << ly.lg, SPI = 1 << ly.lgs;
  const int sub = lane & (S - 1), si = (lane >> ly.lg) & (SPI - 1);
  const int g = lane >> (ly.lg + ly.lgs);
  const long item = item0 + g;  // this lane's item as a slot lane
  const bool item_on = item < items;
  const int vrow = nh * c;  // elements between two positions of one level
  const T* vb = value + (item / ((long)Lq * nh)) * Lv * (long)vrow + (long)(item % nh) * c;
  // this lane's point as a preparing lane
  const int gp = lane / ly.pb, lp = lane - gp * ly.pb;
  const long pitem = item0 + gp;
  const bool prep_on = gp < ly.G && pitem < items;
  const bool loc8 = ((uintptr_t)loc & 7) == 0;

  for (int j0 = 0; j0 < ly.nchunk; j0 += S) {  // more than one pass only where c > 32 V
    const int j = j0 + sub;
    const bool ch_on = item_on && j < ly.nchunk;
    const T* vj = vb + j * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;

    for (int p0 = 0; p0 < Ptot; p0 += ly.pb) {
      const int pend = min(p0 + ly.pb, Ptot);
      // ---- one lane per point
      int o00 = 0, pk = 0;  // top-left corner's offset; W << 4 | mask of corners inside
      float w0 = 0.f, w1 = 0.f, w2 = 0.f, w3 = 0.f;
      const int pi = p0 + lp;
      if (prep_on && pi < pend) {
        const long pp = pitem * Ptot + pi;
        float2 xy;
        if (loc8) {
          xy = __ldg(reinterpret_cast<const float2*>(loc) + pp);
        } else {
          xy.x = __ldg(loc + 2 * pp);
          xy.y = __ldg(loc + 2 * pp + 1);
        }
        const float a = __ldg(attn + pp);
        int l = 0, k = pi;
        while (l < lv.n - 1 && k >= lv.P[l]) k -= lv.P[l++];
        const int H = lv.H[l], W = lv.W[l];
        const Corners q = corners(xy.x, xy.y, H, W);
        o00 = (lv.start[l] + q.y0 * W + q.x0) * vrow;
        pk = W << 4 | (int)(q.vy0 && q.vx0) | (int)(q.vy0 && q.vx1) << 1 |
             (int)(q.vy1 && q.vx0) << 2 | (int)(q.vy1 && q.vx1) << 3;
        w0 = a * (1.f - q.tx) * (1.f - q.ty);
        w1 = a * q.tx * (1.f - q.ty);
        w2 = a * (1.f - q.tx) * q.ty;
        w3 = a * q.tx * q.ty;
      }
      // ---- one point per slot and round: all corner loads first, then the sums
      for (int r0 = p0; r0 < pend; r0 += kRU * SPI) {
        Raw<T, V> v[kRU][4];
        float w[kRU][4];
#pragma unroll
        for (int u = 0; u < kRU; ++u) {
          if (r0 + u * SPI >= pend) break;  // uniform over the warp
          const int pu = r0 + u * SPI + si;
          const bool on = ch_on && pu < pend;
          const int src = (g * ly.pb + pu - p0) & 31;
          const int o = __shfl_sync(FULL, o00, src);
          const int m = __shfl_sync(FULL, pk, src);
          w[u][0] = __shfl_sync(FULL, w0, src);
          w[u][1] = __shfl_sync(FULL, w1, src);
          w[u][2] = __shfl_sync(FULL, w2, src);
          w[u][3] = __shfl_sync(FULL, w3, src);
          const int mask = on ? m & 15 : 0;
          const int down = (m >> 4) * vrow;
          const int off[4] = {o, o + vrow, o + down, o + down + vrow};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            v[u][e] = Raw<T, V>{};
            if (mask >> e & 1) v[u][e] = load_raw<T, V>(vj + off[e]);
          }
        }
#pragma unroll
        for (int u = 0; u < kRU; ++u) {
          if (r0 + u * SPI >= pend) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x[V];
            unpack(v[u][e], x);
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(w[u][e], x[i], acc[i]);
          }
        }
      }
    }

    // ---- sum over the item's slots: halving exchanges, then xor steps
    int m = ly.lgs > 0 ? S << (ly.lgs - 1) : 0;  // the item's highest slot bit
    int kept = V, pos = 0;
#pragma unroll
    for (int k = V / 2; k >= 1; k >>= 1) {
      if (m < S) break;  // uniform
      const bool up = (lane & m) != 0;
#pragma unroll
      for (int i = 0; i < k; ++i) {
        const float send = up ? acc[i] : acc[i + k];
        const float keep = up ? acc[i + k] : acc[i];
        acc[i] = keep + __shfl_xor_sync(FULL, send, m);
      }
      if (up) pos += k;
      kept = k;
      m >>= 1;
    }
    bool writer = ch_on;
    for (; m >= S; m >>= 1) {
      acc[0] += __shfl_xor_sync(FULL, acc[0], m);
      writer = writer && !(lane & m);
    }
    if (writer) {  // out[item, j*V + pos + i] for i < kept
      float* o = out + item * c + j * V + pos;
      if constexpr (V >= 4) {
        if (kept % 4 == 0) {
#pragma unroll
          for (int i = 0; i < V; i += 4)
            if (i < kept)
              *reinterpret_cast<float4*>(o + i) =
                  make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
        } else if (kept == 2) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
        } else {
          o[0] = acc[0];
        }
      } else {
        o[0] = acc[0];
      }
    }
  }
}

template <typename T>
static int launch(const T* value, const float* loc, const float* attn, float* out, int B,
                  int Lv, int nh, int c, int Lq, int Ptot, const Levels& lv, cudaStream_t s) {
  const long items = (long)B * Lq * nh;
  if (items == 0 || c == 0) return 0;
  // offsets inside one image's value map are int32 (corners reach 2 W + 2
  // positions past it), and W is packed above 4 mask bits
  int wmax = 0;
  for (int l = 0; l < lv.n; ++l) wmax = lv.W[l] > wmax ? lv.W[l] : wmax;
  if (wmax >= (1 << 26) || ((long)Lv + 2L * wmax + 2) * nh * c >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  // 16 bytes of channels per lane where c and the pointers allow it
  constexpr int V = 16 / sizeof(T);
  const bool vec = c % V == 0 && (uintptr_t)value % 16 == 0 && (uintptr_t)out % 16 == 0;
  FwdLayout ly;
  ly.nchunk = vec ? c / V : c;
  ly.lg = 0;
  while (ly.lg < 5 && (1 << ly.lg) < ly.nchunk) ++ly.lg;
  const int ns = 32 >> ly.lg;  // slots of a warp
  // items per warp: the fewest that leave the fewest slots idle in an item's
  // last round; more than one only where all their points fit one preparation
  int G = 1, idle = 1 << 30;
  for (int gi = 1; gi <= ns; gi *= 2) {
    if (gi > 1 && gi * Ptot > 32) break;
    const int spi = ns / gi, waste = (Ptot + spi - 1) / spi * spi - Ptot;
    if (waste < idle) {
      idle = waste;
      G = gi;
    }
  }
  ly.G = G;
  ly.lgs = 0;
  while ((1 << ly.lgs) * G < ns) ++ly.lgs;
  ly.pb = G > 1 ? Ptot : (Ptot < 32 ? (Ptot > 0 ? Ptot : 1) : 32);
  const long warps = (items + G - 1) / G;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  if (vec)
    msda_fwd_kernel<T, V><<<grid, 32 * kWarps, 0, s>>>(value, loc, attn, out, Lv, nh, c, Lq,
                                                        Ptot, items, lv, ly);
  else
    msda_fwd_kernel<T, 1><<<grid, 32 * kWarps, 0, s>>>(value, loc, attn, out, Lv, nh, c, Lq,
                                                        Ptot, items, lv, ly);
  return (int)cudaGetLastError();
}

// level_info: host array of n_levels x (H, W, start, P).
extern "C" int msda_fwd(const void* value, int value_bf16, const void* loc, const void* attn,
                        void* out, int B, int Lv, int nh, int c, int Lq, int n_levels,
                        const int* level_info, void* stream) {
  Levels lv;
  const int Ptot = read_levels(n_levels, level_info, &lv);
  if (Ptot < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (value_bf16)
    return launch((const __nv_bfloat16*)value, (const float*)loc, (const float*)attn,
                  (float*)out, B, Lv, nh, c, Lq, Ptot, lv, s);
  return launch((const float*)value, (const float*)loc, (const float*)attn, (float*)out, B,
                Lv, nh, c, Lq, Ptot, lv, s);
}

