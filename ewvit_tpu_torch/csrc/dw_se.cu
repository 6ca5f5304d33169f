// K2: stride-1 SAME depthwise k x k conv with BN folded in, SiLU, and the
// fp32 spatial mean of the result, in one pass. NCHW.
//
// Replaces the Pallas kernel ewvit_tpu/ops/dw_se.py:dw_bn_silu_mean. In the
// V2-S backbone it sits in every stride-1 squeeze-excite MBConv (28 per
// chunk at 224px, planes of 14x14 and 7x7, 512-1536 channels); B0 adds
// planes from 112x112 down to 7x7 at k = 3 and 5. The SE mean rides the
// pass that writes y, so y is never read back for the squeeze.
//
// Bound: memory. Per output it does k*k fused multiply-adds and one exp
// against 2 bytes read and 2 written (bf16), ~5 operations per byte, far
// under the card's ~20 fp32 operations per byte of memory rate. So the
// design keeps device memory streaming:
//
// - Units. Consecutive (n, c) planes are contiguous in NCHW. A unit is a
//   group of G whole planes, or, for a large plane (G = 1), one band of
//   output rows with its k/2 halo rows above and below. Either way the
//   unit's input is one contiguous run of bytes, and so is its output.
// - A persistent grid: each block walks its units (unit = block, block +
//   grid, ...; the bands of a plane in order), so one block owns a whole
//   plane and the mean needs no cross-block reduction.
// - A ring of S stages in shared memory. Thread 0 fills a stage with one
//   cp.async.bulk (1-D TMA) of the unit's input in its storage type, plus
//   one or two of the unit's packed weights ([C, WS] fp32, channel-major,
//   taps then shift, 16 bytes aligned per channel), onto the stage's
//   mbarrier; the loads run S units ahead of the compute. A unit whose run
//   is not 16-byte aligned or sized (only the ragged last group of a
//   launch, or rows of an odd width) is loaded and stored by ordinary
//   loads and stores instead.
// - No padded copy: the SAME zero ring is a predicate on row and column.
// - Register sliding window, three compute paths:
//   * 14 x 14 (V2-S, the size compiled in): a thread per two output rows at
//     k = 3 (one at k = 5) holds them in fp32 accumulators and reads each
//     input row it needs once, 2 elements at a time;
//   * 7 x 7 (V2-S, compiled in): a thread per plane, all in registers;
//   * strips (any plane): a thread per SW adjacent outputs of one row reads
//     SW + k - 1 inputs per kernel row ((SW + k - 1) k / SW reads per
//     output instead of k*k).
//   On the compiled-in paths every SAME test but the row's is decided at
//   compile time.
//   Taps go in the TPU kernel's order (dh-major, then dw) into an fp32
//   accumulator, then the shift, then SiLU in fp32, then one rounding to
//   the storage type.
// - y goes into a double-buffered tile in shared memory and leaves by one
//   cp.async.bulk store per unit (16-byte transactions), which overlaps
//   the next unit's compute. One barrier a step.
// - The mean, of the ROUNDED outputs, in one fixed order, so two runs
//   agree bit for bit (no atomics): at 14 x 14 a plane's rows sit in 8 or
//   16 neighbouring lanes and their sums meet by shuffles; at 7 x 7 a
//   thread sums its plane; on the strip path each strip's sum goes to a
//   slot of shared memory and a plane's slots are summed in order (one
//   thread per plane, or one warp per band and then the bands in order).
//
// What holds it back (csrc-level ablation, ewvit_tpu_torch/dwse_ablation.py,
// numbers in PERF.md): the load and store pipeline alone runs at ~66% of
// the bytes bound on V2-S's shapes with a cold L2, and the taps and SiLU (two MUFU
// operations per output) add time that overlaps the memory traffic only
// in part.
//
//   x [N, C, H, W]  wpk [C, WS] f32 (ops/dw_se.py pack_dwse)
//   y [N, C, H, W]  mean [N, C] f32
//
// The host-side plan (G, band rows, stages, strip width, grid) is chosen
// by ops/dw_se.py:dwse_plan and passed in; the shared-memory layout below
// is mirrored there (dwse_plan.smem_bytes) and checked against
// ewvit_dw_se_smem_bytes on the card.
//
// EWVIT_DWSE_ABLATE (timing only; the result is wrong): 1 = the loads and
// the pipeline only (no compute, no y store); 2 = loads and stores (y = x,
// no taps); 3 = no SiLU (y = the rounded pre-activation).
#include "common.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 224;       // 7 warps: 7 divides the row tasks of a 14 x 14 plane
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;  // 227 KB a block can use on an H100

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int packed_width(int k) { return round_up(k * k + 1, 4); }

// One launch's geometry; all offsets in bytes from the dynamic shared memory.
struct Geo {
  int planes, c, h, w;
  int group, band_rows, bands, units, stages;
  int x_stage, stage, y_off, y_tile, part_off, part_bytes, bar_off, smem;
};

// Fills g; false if the parameters are not a valid plan.
bool make_geo(int n, int c, int h, int w, int k, int es, int group, int band_rows,
              int stages, int strip, Geo& g) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || group <= 0) return false;
  if (band_rows <= 0 || band_rows > h || (band_rows < h && group != 1)) return false;
  if (stages < 1 || stages > kMaxStages || (strip != 4 && strip != 7 && strip != 8 && strip != 14)) return false;
  const long long planes = (long long)n * c;
  if (planes > (1LL << 30)) return false;
  g.planes = (int)planes; g.c = c; g.h = h; g.w = w;
  g.group = group; g.band_rows = band_rows;
  g.bands = (h + band_rows - 1) / band_rows;
  g.units = (g.planes + group - 1) / group;
  g.stages = stages;
  const int p = k / 2;
  const int src_rows = g.bands == 1 ? h : (band_rows + 2 * p < h ? band_rows + 2 * p : h);
  const long long xb = (long long)group * src_rows * w * es;
  const long long yb = (long long)group * band_rows * w * es;
  const int nw = group < c ? group : c;
  // the compiled-in 14 x 14 and 7 x 7 paths keep no strip sums
  const bool whole = g.bands == 1 && h == w;
  if (strip == 14 && !(whole && h == 14)) return false;
  const bool fixed = whole && (h == 14 || h == 7) && strip == h;
  const long long tasks = fixed ? 0 : (long long)group * band_rows * ((w + strip - 1) / strip);
  if (xb > kSmemLimit || yb > kSmemLimit || tasks * 4 > kSmemLimit) return false;
  g.x_stage = round_up((int)xb, 128);
  g.stage = g.x_stage + round_up(nw * packed_width(k) * 4, 128);
  g.y_off = stages * g.stage;
  g.y_tile = round_up((int)yb, 128);
  g.part_off = g.y_off + 2 * g.y_tile;
  g.part_bytes = round_up((int)tasks * 4, 128);
  g.bar_off = g.part_off + 2 * g.part_bytes;
  const long long smem = (long long)g.bar_off + 8 * stages;
  if (smem > kSmemLimit) return false;
  g.smem = (int)smem;
  return true;
}

using ewvit::bulk_g2s;
using ewvit::mbar_expect_tx;
using ewvit::mbar_arrive;
using ewvit::mbar_init;
using ewvit::mbar_wait;
using ewvit::smem_u32;

__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Where unit step j of this block reads and writes.
struct Step {
  int plane0, np;        // first plane, planes in the unit
  int band, r0, nr;      // band index, first output row, output rows
  int sr0, sr1;          // input rows held in the stage: [sr0, sr1)
  long long x_off, y_off;  // bytes from x and y
  int x_bytes, y_bytes;
  bool x_bulk, y_bulk;
};

template <int P>
__device__ __forceinline__ Step decode(const Geo& g, int j, int es) {
  Step s;
  const int u = blockIdx.x + (j / g.bands) * gridDim.x;
  s.band = j - (j / g.bands) * g.bands;
  s.plane0 = u * g.group;
  s.np = min(g.group, g.planes - s.plane0);
  s.r0 = s.band * g.band_rows;
  s.nr = min(g.band_rows, g.h - s.r0);
  s.sr0 = max(0, s.r0 - P);
  s.sr1 = min(g.h, s.r0 + s.nr + P);
  // a unit is either whole planes (band 0 of 1) or one band of one plane
  s.x_off = ((long long)s.plane0 * g.h + s.sr0) * g.w * es;
  s.y_off = ((long long)s.plane0 * g.h + s.r0) * g.w * es;
  s.x_bytes = s.np * (s.sr1 - s.sr0) * g.w * es;
  s.y_bytes = s.np * s.nr * g.w * es;
  s.x_bulk = ((s.x_off | (long long)s.x_bytes) & 15) == 0;
  s.y_bulk = ((s.y_off | (long long)s.y_bytes) & 15) == 0;
  return s;
}

// Thread 0: fill stage j % S with unit step j (input run, then the packed
// weights of its channels: a window of min(np, C) channels from
// plane0 % C, wrapping at C, in at most two runs).
template <int P, int WS>
__device__ __forceinline__ void issue(const Geo& g, int j, const unsigned char* x,
                                      const float* wpk, uint32_t sbase, int es) {
  const Step s = decode<P>(g, j, es);
  const int stage = j % g.stages;
  const uint32_t bar = sbase + g.bar_off + 8 * stage;
  if (!s.x_bulk) {       // loaded by ordinary loads when consumed
    mbar_arrive(bar);
    return;
  }
  const uint32_t dst = sbase + stage * g.stage;
  const int c0 = s.plane0 % g.c, nw = min(s.np, g.c), n1 = min(nw, g.c - c0);
  mbar_expect_tx(bar, s.x_bytes + nw * WS * 4);
  bulk_g2s(dst, x + s.x_off, s.x_bytes, bar);
  bulk_g2s(dst + g.x_stage, wpk + (long long)c0 * WS, n1 * WS * 4, bar);
  if (nw > n1) bulk_g2s(dst + g.x_stage + n1 * WS * 4, wpk, (nw - n1) * WS * 4, bar);
}

// SiLU of the fp32 pre-activation, a / (1 + 2^(-a log2 e)), by the
// hardware's approximate exp2 and reciprocal (a few ulp, far inside the
// fp32 tolerance of 1e-5), flushing denormals so that each is one
// instruction; a < -88 gives 2^+inf = inf, 1 / inf = 0 and y = -0.
__device__ __forceinline__ float silu(float a) {
#if EWVIT_DWSE_ABLATE == 3
  return a;
#else
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(a * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return a * r;
#endif
}
// ... rounded once to the storage type
template <typename T>
__device__ __forceinline__ T silu_round(float a) {
  return ewvit::from_f32<T>(silu(a));
}
// Two neighbouring outputs, rounded and stored together (p 2-element
// aligned); adds their rounded values to sum in order.
__device__ __forceinline__ void silu_store2(float* p, float a, float b, float& sum) {
  const float2 v = make_float2(silu(a), silu(b));
  *reinterpret_cast<float2*>(p) = v;
  sum += v.x;
  sum += v.y;
}
__device__ __forceinline__ void silu_store2(__nv_bfloat16* p, float a, float b, float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(silu(a), silu(b));
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
  sum += __low2float(v);
  sum += __high2float(v);
}

// One channel's taps and shift from the stage's weight window.
template <int WS>
__device__ __forceinline__ void load_weights(const float* p, float (&wk)[WS]) {
  const float4* wp = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < WS / 4; ++q) {
    const float4 v = wp[q];
    wk[4 * q] = v.x; wk[4 * q + 1] = v.y; wk[4 * q + 2] = v.z; wk[4 * q + 3] = v.w;
  }
}

// Any plane (HW = 0): tasks of SW adjacent outputs of one row; each task's
// sum of its rounded outputs goes to part[task].
template <typename T, int K, int SW>
__device__ __forceinline__ void unit_strips(const Geo& g, const Step& s, const T* xs,
                                            const float* ws, T* yt, float* part, int tid) {
  constexpr int P = K / 2, KK = K * K, WS = packed_width(K);
  const int h = g.h, w = g.w, strips = (w + SW - 1) / SW;
  const int per_plane = s.nr * strips, ntasks = s.np * per_plane;
  const int src_rows = s.sr1 - s.sr0;
  for (int t = tid; t < ntasks; t += kThreads) {
    const int gp = t / per_plane, rem = t - gp * per_plane;
    const int rr = rem / strips, col0 = (rem - rr * strips) * SW;
    const int r = s.r0 + rr;
    const T* xp = xs + gp * src_rows * w;
    T* yrow = yt + (gp * s.nr + rr) * w;
    float wk[WS];
    load_weights(ws + (gp % g.c) * WS, wk);
    float acc[SW];
#pragma unroll
    for (int q = 0; q < SW; ++q) acc[q] = 0.f;
#pragma unroll
    for (int dh = 0; dh < K; ++dh) {
      const int ir = r + dh - P;
      if (ir < 0 || ir >= h) continue;          // the SAME zero rows
      const T* row = xp + (ir - s.sr0) * w;
      float v[SW + K - 1];
#pragma unroll
      for (int i = 0; i < SW + K - 1; ++i) {
        const int col = col0 - P + i;
        v[i] = 0.f;                              // the SAME zero columns
        if (col >= 0 && col < w) v[i] = ewvit::to_f32(row[col]);
      }
#pragma unroll
      for (int dw = 0; dw < K; ++dw)
#pragma unroll
        for (int q = 0; q < SW; ++q) acc[q] += v[q + dw] * wk[dh * K + dw];
    }
    float psum = 0.f;
#pragma unroll
    for (int q = 0; q < SW; ++q) {
      if (col0 + q < w) {
        const T yc = silu_round<T>(acc[q] + wk[KK]);
        yrow[col0 + q] = yc;
        psum += ewvit::to_f32(yc);
      }
    }
    part[t] = psum;
  }
}

// 14 x 14 planes (V2-S's 512-960 channels): a thread per RT output rows
// (two at k = 3, so each input row read serves two output rows; one at
// k = 5), the rows of a plane in LP consecutive lanes (8 or 16); a row is
// read 2 elements at a time. The plane's sum goes through shuffles within
// its LP lanes, in a fixed order, and the lane of row 0 writes the mean.
// Every lane runs the same number of passes.
__host__ __device__ constexpr int rows14_rt(int k) { return k == 3 ? 2 : 1; }
__host__ __device__ constexpr int rows14_lanes(int k) { return k == 3 ? 8 : 16; }

template <typename T, int K>
__device__ __forceinline__ void unit_rows14(const Geo& g, const Step& s, const T* xs,
                                            const float* ws, T* yt, float* mean, int tid) {
  constexpr int HW = 14, P = K / 2, KK = K * K, WS = packed_width(K);
  constexpr int RT = rows14_rt(K), LP = rows14_lanes(K);
  const int slots = round_up(s.np * LP, kThreads);
  for (int sl = tid; sl < slots; sl += kThreads) {
    const int gp = sl / LP, r0 = (sl % LP) * RT;
    const bool live = gp < s.np && r0 < HW;
    float psum = 0.f;
    if (live) {
      float wk[WS];
      load_weights(ws + (gp % g.c) * WS, wk);
      float acc[RT][HW];
#pragma unroll
      for (int o = 0; o < RT; ++o)
#pragma unroll
        for (int q = 0; q < HW; ++q) acc[o][q] = 0.f;
      const T* xp = xs + gp * HW * HW;
      // input rows in order, so each output row takes its taps dh-major
#pragma unroll
      for (int i = 0; i < RT + K - 1; ++i) {
        const int ir = r0 + i - P;
        if (ir < 0 || ir >= HW) continue;        // the SAME zero rows
        float v[HW + 2 * P];
#pragma unroll
        for (int e = 0; e < P; ++e) v[e] = v[HW + P + e] = 0.f;
#pragma unroll
        for (int e = 0; e < HW; e += 2) ewvit::load2(xp + ir * HW + e, v[P + e], v[P + e + 1]);
#pragma unroll
        for (int o = 0; o < RT; ++o) {
          const int dh = i - o;
          if (dh < 0 || dh >= K) continue;
#pragma unroll
          for (int dw = 0; dw < K; ++dw)
#pragma unroll
            for (int q = 0; q < HW; ++q) acc[o][q] += v[q + dw] * wk[dh * K + dw];
        }
      }
#pragma unroll
      for (int o = 0; o < RT; ++o) {
        T* yr = yt + (gp * HW + r0 + o) * HW;
#pragma unroll
        for (int q = 0; q < HW; q += 2)
          silu_store2(yr + q, acc[o][q] + wk[KK], acc[o][q + 1] + wk[KK], psum);
      }
    }
#pragma unroll
    for (int off = LP / 2; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    if (live && r0 == 0) mean[s.plane0 + gp] = psum * (1.f / (HW * HW));
  }
}

// 7 x 7 planes (V2-S's 1536 channels): a thread per plane, 224 planes a
// unit. The plane sits in registers (each input read from shared memory
// once) and every tap's SAME test is decided at compile time; the mean
// needs no exchange.
template <typename T, int K>
__device__ __forceinline__ void unit_planes7(const Geo& g, const Step& s, const T* xs,
                                             const float* ws, T* yt, float* mean, int tid) {
  constexpr int HW = 7, P = K / 2, KK = K * K, WS = packed_width(K);
  for (int gp = tid; gp < s.np; gp += kThreads) {
    float wk[WS];
    load_weights(ws + (gp % g.c) * WS, wk);
    const T* xp = xs + gp * HW * HW;
    float xv[HW * HW];
#pragma unroll
    for (int i = 0; i < HW * HW; ++i) xv[i] = ewvit::to_f32(xp[i]);
    T* yp = yt + gp * HW * HW;
    float psum = 0.f;
#pragma unroll
    for (int r = 0; r < HW; ++r) {
#pragma unroll
      for (int c = 0; c < HW; ++c) {
        float acc = 0.f;
#pragma unroll
        for (int dh = 0; dh < K; ++dh)
#pragma unroll
          for (int dw = 0; dw < K; ++dw) {
            const int ir = r + dh - P, ic = c + dw - P;
            if (ir >= 0 && ir < HW && ic >= 0 && ic < HW) acc += xv[ir * HW + ic] * wk[dh * K + dw];
          }
        const T yc = silu_round<T>(acc + wk[KK]);
        yp[r * HW + c] = yc;
        psum += ewvit::to_f32(yc);
      }
    }
    mean[s.plane0 + gp] = psum * (1.f / (HW * HW));
  }
}

// HW = 14 or 7: the plane size compiled in (group mode only); 0: any plane,
// strips of SW outputs. Blocks an SM in __launch_bounds__ (ops/dw_se.py
// BLOCKS_PER_SM mirrors them): 4 for 14 x 14 (ptxas then allows 72
// registers), 2 for 7 x 7, whose 49 inputs sit in registers (128; at 3 it
// spills), 3 for the rest (80).
template <typename T, int K, int SW, int HW>
__global__ void __launch_bounds__(kThreads, HW == 14 ? 4 : HW == 7 ? 2 : 3)
dw_bn_silu_mean_kernel(const T* __restrict__ x, const float* __restrict__ wpk,
                       T* __restrict__ y, float* __restrict__ mean,
                       const __grid_constant__ Geo g) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int P = K / 2, WS = packed_width(K), ES = sizeof(T);
  const int tid = threadIdx.x;
  const uint32_t sbase = smem_u32(smem);
  const int nsteps = (g.units - blockIdx.x + gridDim.x - 1) / gridDim.x * g.bands;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) mbar_init(sbase + g.bar_off + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < g.stages && j < nsteps; ++j) issue<P, WS>(g, j, xb, wpk, sbase, ES);

  float band_sum = 0.f;                   // warp 0, band mode: the plane's bands so far
  for (int j = 0; j < nsteps; ++j) {
    const int stage = j % g.stages;
    const Step s = decode<P>(g, j, ES);
    T* xs = reinterpret_cast<T*>(smem + stage * g.stage);
    float* ws = reinterpret_cast<float*>(smem + stage * g.stage + g.x_stage);
    // y tiles and strip sums are double-buffered, so one barrier a step does
    T* yt = reinterpret_cast<T*>(smem + g.y_off + (j & 1) * g.y_tile);
    float* part = reinterpret_cast<float*>(smem + g.part_off + (j & 1) * g.part_bytes);
    mbar_wait(sbase + g.bar_off + 8 * stage, (j / g.stages) & 1);
    if (!s.x_bulk) {
      const T* src = reinterpret_cast<const T*>(xb + s.x_off);
      for (int i = tid; i < s.x_bytes / ES; i += kThreads) xs[i] = src[i];
      const int c0 = s.plane0 % g.c, nw = min(s.np, g.c);
      for (int i = tid; i < nw * WS; i += kThreads)
        ws[i] = wpk[(long long)((c0 + i / WS) % g.c) * WS + i % WS];
      __syncthreads();
    }
#if EWVIT_DWSE_ABLATE == 2
    for (int i = tid; i < s.y_bytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(yt)[i] = reinterpret_cast<const uint4*>(xs)[i];
#elif EWVIT_DWSE_ABLATE != 1
    if constexpr (HW == 14) unit_rows14<T, K>(g, s, xs, ws, yt, mean, tid);
    else if constexpr (HW == 7) unit_planes7<T, K>(g, s, xs, ws, yt, mean, tid);
    else unit_strips<T, K, SW>(g, s, xs, ws, yt, part, tid);
#endif
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // yt -> bulk store
    // step j + 1 writes the y tile that step j - 1's store reads
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();   // stage free, y tile and strip sums complete

    if (tid == 0) {
      if (j + g.stages < nsteps) issue<P, WS>(g, j + g.stages, xb, wpk, sbase, ES);
#if EWVIT_DWSE_ABLATE != 1
      if (s.y_bulk) bulk_s2g(reinterpret_cast<unsigned char*>(y) + s.y_off, smem_u32(yt), s.y_bytes);
#endif
    }
#if EWVIT_DWSE_ABLATE != 1
    if (!s.y_bulk) {
      T* dst = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(y) + s.y_off);
      for (int i = tid; i < s.y_bytes / ES; i += kThreads) dst[i] = yt[i];
    }
    if constexpr (HW == 0) {
      const int per_plane = s.nr * ((g.w + SW - 1) / SW);
      const float inv = 1.f / (float)(g.h * g.w);
      if (g.bands == 1) {
        for (int gp = tid; gp < s.np; gp += kThreads) {
          const float* pp = part + gp * per_plane;
          float sum = 0.f;
          for (int i = 0; i < per_plane; ++i) sum += pp[i];
          mean[s.plane0 + gp] = sum * inv;
        }
      } else if (tid < 32) {
        float sum = 0.f;
        for (int i = tid; i < per_plane; i += 32) sum += part[i];
        band_sum += ewvit::warp_sum(sum);
        if (s.band == g.bands - 1) {
          if (tid == 0) mean[s.plane0] = band_sum * inv;
          band_sum = 0.f;
        }
      }
    }
#endif
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T, int K, int SW, int HW>
int launch(const void* x, const float* wpk, void* y, float* mean, const Geo& g, int grid,
           cudaStream_t stream) {
  auto kernel = dw_bn_silu_mean_kernel<T, K, SW, HW>;
  static int smem_set = 48 * 1024;   // the most dynamic shared memory allowed so far
  if (g.smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = g.smem;
  }
  kernel<<<grid, kThreads, g.smem, stream>>>(static_cast<const T*>(x), wpk,
                                              static_cast<T*>(y), mean, g);
  return (int)cudaGetLastError();
}

// strip == 14 (14 x 14 planes) and strip == 7 on 7 x 7 planes take the
// compiled-in paths; any other plane goes by strips of 4, 7 or 8.
template <typename T, int K>
int launch_sw(int strip, const void* x, const float* wpk, void* y, float* mean,
              const Geo& g, int grid, cudaStream_t s) {
  const bool whole = g.bands == 1 && g.h == g.w;
  if (strip == 14) return launch<T, K, 14, 14>(x, wpk, y, mean, g, grid, s);   // make_geo checked
  if (strip == 7 && whole && g.h == 7) return launch<T, K, 7, 7>(x, wpk, y, mean, g, grid, s);
  switch (strip) {
    case 4: return launch<T, K, 4, 0>(x, wpk, y, mean, g, grid, s);
    case 7: return launch<T, K, 7, 0>(x, wpk, y, mean, g, grid, s);
    case 8: return launch<T, K, 8, 0>(x, wpk, y, mean, g, grid, s);
  }
  return (int)cudaErrorInvalidValue;
}

int elem_size(int dtype) {
  return dtype == ewvit::kF32 ? 4 : dtype == ewvit::kBF16 ? 2 : 0;
}

}  // namespace

// Dynamic shared memory of a plan in bytes, or -1 if the plan is invalid.
extern "C" int ewvit_dw_se_smem_bytes(int n, int c, int h, int w, int k, int dtype,
                                      int group, int band_rows, int stages, int strip) {
  Geo g;
  const int es = elem_size(dtype);
  if (es == 0 || (k != 3 && k != 5) ||
      !make_geo(n, c, h, w, k, es, group, band_rows, stages, strip, g))
    return -1;
  return g.smem;
}

extern "C" int ewvit_dw_bn_silu_mean(const void* x, const void* wpk, void* y, void* mean,
                                     int n, int c, int h, int w, int k, int dtype,
                                     int group, int band_rows, int stages, int strip,
                                     int grid, void* stream) {
  Geo g;
  const int es = elem_size(dtype);
  if (es == 0 || (k != 3 && k != 5) ||
      !make_geo(n, c, h, w, k, es, group, band_rows, stages, strip, g))
    return (int)cudaErrorInvalidValue;
  if (grid < 1 || grid > g.units) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)wpk | (uintptr_t)y) & 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(wpk);
  float* mf = static_cast<float*>(mean);
  if (k == 3) {
    EWVIT_DISPATCH(dtype, T, return launch_sw<T, 3>(strip, x, wf, y, mf, g, grid, s));
  } else {
    EWVIT_DISPATCH(dtype, T, return launch_sw<T, 5>(strip, x, wf, y, mf, g, grid, s));
  }
  return (int)cudaErrorInvalidValue;
}
