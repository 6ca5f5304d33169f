// K4: DAMA's whole bidirectional cross-attention stack over one token per
// branch, in one launch.
//
// Replaces the Pallas kernel ewvit_tpu/ops/fused_attention.py:
// fused_bidirectional_cross_attention (_kernel, _cross_1tok). For each of
// the 2*depth attention blocks (layer-major; space attends freq, then freq
// attends the UPDATED space):
//
//   xn   = LayerNorm(x; eps 1e-6)
//   q    = xn @ Wq ;  [k_s|v_s] = xn @ Wkv ;  [k_c|v_c] = ctx @ Wkv
//   g_h  = softmax([q.k_s, q.k_c]_h * dh^-0.5)_0      (per head h)
//   x   += (g_h v_s + (1 - g_h) v_c) @ Wo + bo
//
// With one token, attention per head is a scalar gate between the self and
// the context values (kv_include_self). All math is fp32; tokens are fp32 or
// bf16 in and out.
//
// Bound: operations. At N rows and D = 128 the stack does 48*N*D^2
// multiply-adds against 1 MiB of fp32 weights; everything else is O(N*D).
// The projections are computed here with fp32 FMAs, not by a library GEMM.
//
// Two kernels:
//
// * The cluster kernel (D = 128, the one width the models serve; head width
//   a multiple of 16). What held the first design back was that every block
//   streamed all 1 MiB of weights through its own SM. Here the weights are
//   split over SMs instead: a cluster of kC = 8 CTAs owns kR = 8 token rows,
//   and CTA c owns the 16-column slice c of every projection (q, k, v, out).
//   Its weights for one attention block are one contiguous run of 33,856
//   bytes (ops/fused_attention.py pack_xattn: rows k of
//   [Wq|Wk|Wv|Wo][k, 16c:16c+16], then the LayerNorm scale and bias and its
//   16 out-bias columns), copied by one cp.async.bulk onto its own mbarrier;
//   block 0's run goes first, alone. Each SM takes in 128 KB instead of
//   1 MiB. Every CTA keeps both token matrices whole (8 x 128 fp32), so
//   LayerNorm and the context projection are local; a thread computes whole
//   outputs over the full k = 128 in a fixed order (2 x 4 tiles in the q/k/v
//   projections, one output in the out projection), the loops unrolled with
//   operands loaded two steps ahead. Per block the CTAs exchange (1) their
//   per-head partial dots over their 16 columns, summed in rank order
//   (deterministic), (2) their gated attention slices (the out projection
//   needs whole rows) and (3) their slices of the updated x (the next
//   block's LayerNorm and context need whole rows). Each exchange is a push:
//   st.async writes the slice into the other CTAs' shared memory and
//   completes on the receiver's mbarrier, which counts the bytes, so a CTA
//   waits only for the data it needs. A cluster barrier (barrier.cluster,
//   with a GPU-wide fence, ~430 ns on an H100) is taken twice, at entry and
//   at exit, not three times a block. One buffer of each kind suffices:
//   what a CTA sends into a buffer for block j+1 depends on data that each
//   receiver sent only after it had read that buffer for block j; the same
//   chain keeps each mbarrier's phases apart.
//   What bounds it now is the shared-memory operand rate of the products.
// * The general kernel (any D % 4 == 0, e.g. 256), the first design: a block
//   owns kRows rows for the whole stack and streams the weights through its
//   SM, each projection split over (4-column group, k segment) with partial
//   sums added in segment order.
//
// Weights of the general kernel: mats [2*depth, D, 4D] = Wq | Wkv | Wo with
// [in, out] layout; smalls [2*depth, 3, D] = (ln scale, ln bias, out bias).
//
//   space, freq [N, D] (f32/bf16) -> so, fo [N, D] same dtype; math fp32.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int kRows = 2;
constexpr int kThreads = 384;

// Work split of a projection with `groups` 4-column groups over d inputs.
struct Split {
  int segs, seg_len;
  __host__ __device__ Split(int groups, int d) {
    segs = groups >= kThreads ? 1 : kThreads / groups;
    seg_len = (d + segs - 1) / segs;
  }
};

__host__ __device__ inline size_t smem_floats(int d, int heads) {
  const Split a(3 * d / 4, d), o(d / 4, d);
  const int pa = a.segs * kRows * 5 * d, po = o.segs * kRows * d;
  const int part = pa > po ? pa : po;
  return (size_t)kRows * 8 * d + kRows * heads + part;
}

__device__ void layer_norm_rows(const float* x, float* xn, const float* scale,
                                const float* bias, int rows, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const float* xr = x + r * d;
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s += xr[i];
    const float mu = ewvit::warp_sum(s) / d;
    float v = 0.f;
    for (int i = lane; i < d; i += 32) { const float t = xr[i] - mu; v += t * t; }
    const float rstd = rsqrtf(ewvit::warp_sum(v) / d + 1e-6f);
    for (int i = lane; i < d; i += 32) xn[r * d + i] = (xr[i] - mu) * rstd * scale[i] + bias[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xattn_general_kernel(const T* __restrict__ space, const T* __restrict__ freq,
                     const float* __restrict__ mats, const float* __restrict__ smalls,
                     T* __restrict__ so, T* __restrict__ fo,
                     int n, int d, int depth, int heads) {
  extern __shared__ float sm[];
  float* sp = sm;                   // [kRows, D]   space tokens
  float* fr = sp + kRows * d;       // [kRows, D]   freq tokens
  float* xn = fr + kRows * d;       // [kRows, D]   normed x, later attn
  float* pj = xn + kRows * d;       // [kRows, 5D]  q | k_s | v_s | k_c | v_c
  float* gt = pj + kRows * 5 * d;   // [kRows, heads]
  float* part = gt + kRows * heads; // split-k partial sums
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n - row0);
  const int dh = d / heads;
  const float scale = rsqrtf((float)dh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ga = 3 * d / 4, go = d / 4;       // 4-column groups per projection
  const Split sa(ga, d), so_(go, d);
  const int w4 = d;                           // row stride of mats in float4

  for (int t = threadIdx.x; t < kRows * d; t += kThreads) {
    const bool ok = t / d < rows;
    sp[t] = ok ? ewvit::to_f32(space[(long long)row0 * d + t]) : 0.f;
    fr[t] = ok ? ewvit::to_f32(freq[(long long)row0 * d + t]) : 0.f;
  }
  __syncthreads();

  for (int blk = 0; blk < 2 * depth; ++blk) {
    float* x = (blk & 1) ? fr : sp;
    const float* ctx = (blk & 1) ? sp : fr;
    const float4* W = reinterpret_cast<const float4*>(mats + (long long)blk * d * 4 * d);
    const float* S = smalls + (long long)blk * 3 * d;

    layer_norm_rows(x, xn, S, S + d, kRows, d);
    __syncthreads();

    // q (cols [0, D)) from xn; kv (cols [D, 3D)) from xn AND ctx, one weight read.
    for (int item = threadIdx.x; item < ga * sa.segs; item += kThreads) {
      const int g = item % ga, seg = item / ga;
      const bool kv = g >= d / 4;
      const int k0 = seg * sa.seg_len, k1 = min(d, k0 + sa.seg_len);
      float a[kRows][4], c[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) { a[r][j] = 0.f; c[r][j] = 0.f; }
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float4 wv = W[(long long)k * w4 + g];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xn[r * d + k];
          a[r][0] = fmaf(xv, wv.x, a[r][0]); a[r][1] = fmaf(xv, wv.y, a[r][1]);
          a[r][2] = fmaf(xv, wv.z, a[r][2]); a[r][3] = fmaf(xv, wv.w, a[r][3]);
          if (kv) {
            const float cv = ctx[r * d + k];
            c[r][0] = fmaf(cv, wv.x, c[r][0]); c[r][1] = fmaf(cv, wv.y, c[r][1]);
            c[r][2] = fmaf(cv, wv.z, c[r][2]); c[r][3] = fmaf(cv, wv.w, c[r][3]);
          }
        }
      }
      float* pp = part + (long long)seg * kRows * 5 * d;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pp[r * 5 * d + 4 * g + j] = a[r][j];                        // q | k_s | v_s
          if (kv) pp[r * 5 * d + 2 * d + 4 * g + j] = c[r][j];        // k_c | v_c
        }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kRows * 5 * d; t += kThreads) {
      float acc = 0.f;
      for (int seg = 0; seg < sa.segs; ++seg) acc += part[(long long)seg * kRows * 5 * d + t];
      pj[t] = acc;
    }
    __syncthreads();

    // per (row, head): the 2-way softmax gate
    for (int p = warp; p < kRows * heads; p += kThreads / 32) {
      const int r = p / heads, hh = p - r * heads;
      const float* pr = pj + r * 5 * d;
      float ds = 0.f, dc = 0.f;
      for (int i = lane; i < dh; i += 32) {
        const int e = hh * dh + i;
        ds += pr[e] * pr[d + e];
        dc += pr[e] * pr[3 * d + e];
      }
      ds = ewvit::warp_sum(ds) * scale;
      dc = ewvit::warp_sum(dc) * scale;
      if (lane == 0) {
        const float m = fmaxf(ds, dc);
        const float es = expf(ds - m), ec = expf(dc - m);
        gt[p] = es / (es + ec);
      }
    }
    __syncthreads();

    for (int t = threadIdx.x; t < kRows * d; t += kThreads) {
      const int r = t / d, i = t - r * d;
      const float g = gt[r * heads + i / dh];
      const float* pr = pj + r * 5 * d;
      xn[t] = g * pr[2 * d + i] + (1.f - g) * pr[4 * d + i];
    }
    __syncthreads();

    // out projection (cols [3D, 4D) of mats), split over k like the above
    for (int item = threadIdx.x; item < go * so_.segs; item += kThreads) {
      const int g = item % go, seg = item / go;
      const int k0 = seg * so_.seg_len, k1 = min(d, k0 + so_.seg_len);
      float a[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[r][j] = 0.f;
#pragma unroll 8
      for (int k = k0; k < k1; ++k) {
        const float4 wv = W[(long long)k * w4 + 3 * d / 4 + g];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float av = xn[r * d + k];
          a[r][0] = fmaf(av, wv.x, a[r][0]); a[r][1] = fmaf(av, wv.y, a[r][1]);
          a[r][2] = fmaf(av, wv.z, a[r][2]); a[r][3] = fmaf(av, wv.w, a[r][3]);
        }
      }
      float* pp = part + (long long)seg * kRows * d;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) pp[r * d + 4 * g + j] = a[r][j];
    }
    __syncthreads();
    // bias + residual
    for (int t = threadIdx.x; t < kRows * d; t += kThreads) {
      float acc = 0.f;
      for (int seg = 0; seg < so_.segs; ++seg) acc += part[(long long)seg * kRows * d + t];
      x[t] += acc + S[2 * d + t % d];
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < rows * d; t += kThreads) {
    so[(long long)row0 * d + t] = ewvit::from_f32<T>(sp[t]);
    fo[(long long)row0 * d + t] = ewvit::from_f32<T>(fr[t]);
  }
}


// ---------------------------------------------------------------- cluster

namespace cl {

namespace cg = cooperative_groups;

constexpr int kD = 128;                            // the compiled-in width
constexpr int kC = 8;                              // CTAs per cluster
constexpr int kW = kD / kC;                        // columns a CTA owns (16)
// Token rows per cluster: a 64-row chunk is 8 clusters (64 SMs). At 4 rows
// it would be 16, but only 15 clusters of 8 CTAs fit at once
// (cudaOccupancyMaxActiveClusters); 6 rows (11 clusters) ran no faster, since
// a thread's work does not shrink with the rows, and moved more weight bytes.
constexpr int kR = 8;
constexpr int kThreads = kR * kW;                  // a thread per (row, owned column)
constexpr int kRowW = 4 * kW;                      // [q|k|v|o] of one input row
constexpr int kRun = kD * kRowW + 2 * kD + kW;     // floats of one (block, CTA) run
constexpr int kSlots = 4;                          // weight runs in flight
constexpr int kXS = kD + 4;                        // row stride of the row matrices
constexpr int kTiles = 10 * kR;                    // projection threads (2 x 4 tiles)
constexpr int kSliceBytes = kR * kW * 4;           // one CTA's columns of one matrix
constexpr int kDotV = 2 * kR / 4;                  // float4s of one CTA's partial dots

// shared memory, in floats; every region 16-byte aligned
constexpr int kWts = 0;                            // [kSlots][kRun] weight runs
constexpr int kSp = kWts + kSlots * kRun;          // [kR][kXS] space tokens
constexpr int kFr = kSp + kR * kXS;                // [kR][kXS] freq tokens
constexpr int kXn = kFr + kR * kXS;                // [kR][kXS] LayerNorm of x
constexpr int kAtt = kXn + kR * kXS;               // [kR][kXS] gated attention
constexpr int kPj = kAtt + kR * kXS;               // [5][kR][kW] q, ks, vs, kc, vc
constexpr int kXd = kPj + 5 * kR * kW;             // [kC][kR][2] partial dots by rank
constexpr int kGt = kXd + kC * kR * 2;             // [kR] gates
constexpr int kBar = kGt + kR;                     // mbarriers, 8 bytes each:
constexpr int kBarDots = kSlots, kBarAtt = kSlots + 1, kBarX = kSlots + 2;  // after the slots
constexpr int kBytes = 4 * (kBar + 2 * (kSlots + 3));

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// 16 bytes into CTA `rank`'s shared memory at the address of `local` there,
// completing on that CTA's mbarrier at the address of `bar` there.
__device__ __forceinline__ void push16(uint32_t local, int rank, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(mapa(local, rank)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mapa(bar, rank))
      : "memory");
}

// Thread 0: the run of block `blk` for this CTA into weight slot `slot`.
__device__ __forceinline__ void load_run(const float* packed, int blk, int rank, float* sm,
                                         uint32_t bars, int slot) {
  const uint32_t bar = bars + 8 * slot;
  ewvit::mbar_expect_tx(bar, kRun * 4);
  ewvit::bulk_g2s(ewvit::smem_u32(sm + slot * kRun),
                  packed + ((long long)blk * kC + rank) * kRun, kRun * 4, bar);
}

// 16 bytes of tokens (4 floats or 8 bf16; the pointer selects the type) -> fp32.
__device__ __forceinline__ void to_f32x(uint4 v, const float*, float* dst) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void to_f32x(uint4 v, const __nv_bfloat16*, float* dst) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
    dst[2 * j] = f.x;
    dst[2 * j + 1] = f.y;
  }
}

// Lanes with c % 4 == 0 (c = lane % 16) get their row's values of columns
// c..c+3 (whole warp).
__device__ __forceinline__ float4 gather4(float v) {
  float4 r;
  r.x = v;
  r.y = __shfl_down_sync(0xffffffffu, v, 1);
  r.z = __shfl_down_sync(0xffffffffu, v, 2);
  r.w = __shfl_down_sync(0xffffffffu, v, 3);
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xattn_cluster_kernel(const T* __restrict__ space, const T* __restrict__ freq,
                     const float* __restrict__ packed, T* __restrict__ so,
                     T* __restrict__ fo, int n, int nblk, int heads) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) float cl_smem[];   // (named apart from the general kernel's)
  float* const sm = cl_smem;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int tr = tid / kW, tc = tid % kW;          // this thread's (row, owned column)
  const int row0 = (int)(blockIdx.x / kC) * kR;
  float* const xn = sm + kXn;
  float* const att = sm + kAtt;
  float* const pj = sm + kPj;
  float* const xd = sm + kXd;
  float* const gt = sm + kGt;
  const uint32_t bars = ewvit::smem_u32(sm + kBar);
  const uint32_t bar_dots = bars + 8 * kBarDots, bar_att = bars + 8 * kBarAtt,
                 bar_x = bars + 8 * kBarX;

  if (tid == 0) {      // block 0's run first; the next runs once it has landed
    for (int s = 0; s < kSlots + 3; ++s) ewvit::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    load_run(packed, 0, rank, sm, bars, 0);
  }
  // every CTA's mbarriers must be initialised before the first push: arrive
  // now, wait just before that push, so the barrier's latency hides behind
  // the token loads and block 0's LayerNorm and projection
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  {                    // tokens: all of a thread's 16-byte loads in flight at once;
                       // rows past n are zeros and never stored
    constexpr int kLoads = 2 * kR * kD / V / kThreads;
    uint4 raw[kLoads];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads, m = i / (kR * kD / V), e = (i % (kR * kD / V)) * V;
      raw[j] = row0 + e / kD < n ? *reinterpret_cast<const uint4*>(
                                       (m ? freq : space) + (long long)row0 * kD + e)
                                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads, m = i / (kR * kD / V), e = (i % (kR * kD / V)) * V;
      to_f32x(raw[j], reinterpret_cast<const T*>(&raw[j]),
              sm + (m ? kFr : kSp) + e / kD * kXS + e % kD);
    }
  }
  __syncthreads();

  // this CTA's columns lie in one head; the head's CTAs are [first, first + span)
  const int dh = kD / heads, span = dh / kW, first = rank / span * span;
  const float scale = rsqrtf((float)dh);

  // this thread's 2 x 4 tile in the projections: rows pr, pr + 1 of A (xn,
  // or the context for the rows kR..2kR-1 of k and v), weight-row columns
  // pc..pc+3 (q 0-15, k 16-31, v 32-47); output pj[(po + pr % kR) * kW + pc % kW]
  int pr = 0, pc = 0, po = 0;
  if (tid < 2 * kR) {                              // q: kR rows of xn
    pr = 2 * (tid % (kR / 2));
    pc = 4 * (tid / (kR / 2));
  } else if (tid < kTiles) {                       // k, v: 2kR rows (xn, then ctx)
    const int u = tid - 2 * kR, p = u / (4 * kR), v = u % (4 * kR);
    pr = 2 * (v % kR);
    pc = kW * (1 + p) + 4 * (v / kR);
    po = (pr < kR ? 1 + p : 3 + p) * kR;           // ks/vs, or kc/vc
  }

  for (int blk = 0; blk < nblk; ++blk) {
    const int slot = blk % kSlots;
    float* const x = sm + ((blk & 1) ? kFr : kSp);
    const float* const ctx = sm + ((blk & 1) ? kSp : kFr);
    const float* const W = sm + slot * kRun;       // [kD][kRowW]
    const float* const ln_s = W + kD * kRowW;
    const float* const ln_b = ln_s + kD;
    const float* const bo = ln_b + kD;
    ewvit::mbar_wait(bars + 8 * slot, (blk / kSlots) & 1);
    if (blk == 0 && tid == 0)
      for (int b = 1; b < kSlots && b < nblk; ++b) load_run(packed, b, rank, sm, bars, b);

    // LayerNorm of x (completed a block ago), a half-warp per row: a lane
    // takes columns 4h..4h+3 and 64+4h..64+4h+3
    {
      const int r = tid / 16, h = tid % 16;
      float v[8];
      *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(x + r * kXS + 4 * h);
      *reinterpret_cast<float4*>(v + 4) =
          *reinterpret_cast<const float4*>(x + r * kXS + kD / 2 + 4 * h);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float mu = s / kD;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) { v[j] -= mu; q += v[j] * v[j]; }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) q += __shfl_xor_sync(0xffffffffu, q, off);
      const float rstd = rsqrtf(q / kD + 1e-6f);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int k = half * kD / 2 + 4 * h;
        const float4 g = *reinterpret_cast<const float4*>(ln_s + k);
        const float4 b = *reinterpret_cast<const float4*>(ln_b + k);
        const float* u = v + 4 * half;
        *reinterpret_cast<float4*>(xn + r * kXS + k) =
            make_float4(u[0] * rstd * g.x + b.x, u[1] * rstd * g.y + b.y,
                        u[2] * rstd * g.z + b.z, u[3] * rstd * g.w + b.w);
      }
    }
    if (blk > 0) {                                 // the context: block blk-1's x slices
      if (tid == 0) ewvit::mbar_expect_tx(bar_x, (kC - 1) * kSliceBytes);
      ewvit::mbar_wait(bar_x, (blk - 1) & 1);
    }
    __syncthreads();
    if (tid == 0 && blk > 0 && blk - 1 + kSlots < nblk) {   // slot of block blk-1 is free
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_run(packed, blk - 1 + kSlots, rank, sm, bars, (blk - 1) % kSlots);
    }

    // q | k | v over the full k = 128 in order, a 2 x 4 tile a thread; the
    // loop is unrolled whole, loading two groups of 4 k ahead of their use
    if (tid < kTiles) {
      const float* a0 = (pr < kR ? xn + pr * kXS : ctx + (pr - kR) * kXS);
      const float* a1 = a0 + kXS;
      const float* w_col = W + pc;
      float acc[2][4] = {};
      float4 a[3][2], w[3][4];                     // a ring of three groups of 4 k
      auto load = [&](int g, int b) {
        a[b][0] = *reinterpret_cast<const float4*>(a0 + 4 * g);
        a[b][1] = *reinterpret_cast<const float4*>(a1 + 4 * g);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[b][j] = *reinterpret_cast<const float4*>(w_col + (4 * g + j) * kRowW);
      };
      load(0, 0);
      load(1, 1);
#pragma unroll
      for (int g = 0; g < kD / 4; ++g) {
        if (g + 2 < kD / 4) load(g + 2, (g + 2) % 3);
        const int b = g % 3;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float av[4] = {a[b][i].x, a[b][i].y, a[b][i].z, a[b][i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][0] = fmaf(av[j], w[b][j].x, acc[i][0]);
            acc[i][1] = fmaf(av[j], w[b][j].y, acc[i][1]);
            acc[i][2] = fmaf(av[j], w[b][j].z, acc[i][2]);
            acc[i][3] = fmaf(av[j], w[b][j].w, acc[i][3]);
          }
        }
      }
      float* o = pj + (po + pr % kR) * kW + pc % kW;
      *reinterpret_cast<float4*>(o) = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      *reinterpret_cast<float4*>(o + kW) =
          make_float4(acc[1][0], acc[1][1], acc[1][2], acc[1][3]);
    }
    __syncthreads();

    if (blk == 0) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    // partial dots q.k_s, q.k_c over this CTA's 16 columns, to the head's CTAs
    if (tid < 2 * kR) {
      const int r = tid >> 1;
      const float* q = pj + r * kW;
      const float* kk = pj + ((tid & 1 ? 3 : 1) * kR + r) * kW;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kW; ++c) s = fmaf(q[c], kk[c], s);
      xd[rank * 2 * kR + tid] = s;
    }
    if (span > 1) {
      __syncthreads();
      if (tid < kDotV * span && first + tid / kDotV != rank) {
        const float* src = xd + rank * 2 * kR + 4 * (tid % kDotV);
        push16(ewvit::smem_u32(src), first + tid / kDotV,
               *reinterpret_cast<const float4*>(src), bar_dots);
      }
      if (tid == 0) ewvit::mbar_expect_tx(bar_dots, (span - 1) * 2 * kR * 4);
      ewvit::mbar_wait(bar_dots, blk & 1);
    }
    __syncthreads();
    if (tid < kR) {                                // rank order: every CTA of the head agrees
      float ds = 0.f, dc = 0.f;
      for (int c = first; c < first + span; ++c) {
        ds += xd[c * 2 * kR + 2 * tid];
        dc += xd[c * 2 * kR + 2 * tid + 1];
      }
      ds *= scale;
      dc *= scale;
      const float m = fmaxf(ds, dc), es = expf(ds - m), ec = expf(dc - m);
      gt[tid] = es / (es + ec);
    }
    __syncthreads();
    {                                              // the gated slice, to every CTA
      const float g = gt[tr];
      const float a = g * pj[(2 * kR + tr) * kW + tc] + (1.f - g) * pj[(4 * kR + tr) * kW + tc];
      float* dst = att + tr * kXS + rank * kW + tc;
      *dst = a;
      const float4 a4 = gather4(a);
      if (tc % 4 == 0)
        for (int d = 1; d < kC; ++d)
          push16(ewvit::smem_u32(dst), (rank + d) % kC, a4, bar_att);
      if (tid == 0) ewvit::mbar_expect_tx(bar_att, (kC - 1) * kSliceBytes);
      ewvit::mbar_wait(bar_att, blk & 1);
    }
    __syncthreads();
    {  // out projection of this CTA's columns (four accumulators over k mod 4,
       // added in a fixed order), bias, residual; the slice to every CTA
      const float* a_row = att + tr * kXS;
      const float* w_col = W + 3 * kW + tc;
      float o[4] = {};
      float4 a[3];
      float w[3][4];
      auto load = [&](int g, int b) {
        a[b] = *reinterpret_cast<const float4*>(a_row + 4 * g);
#pragma unroll
        for (int j = 0; j < 4; ++j) w[b][j] = w_col[(4 * g + j) * kRowW];
      };
      load(0, 0);
      load(1, 1);
#pragma unroll
      for (int g = 0; g < kD / 4; ++g) {
        if (g + 2 < kD / 4) load(g + 2, (g + 2) % 3);
        const int b = g % 3;
        o[0] = fmaf(a[b].x, w[b][0], o[0]);
        o[1] = fmaf(a[b].y, w[b][1], o[1]);
        o[2] = fmaf(a[b].z, w[b][2], o[2]);
        o[3] = fmaf(a[b].w, w[b][3], o[3]);
      }
      float* dst = x + tr * kXS + rank * kW + tc;
      const float v = *dst + (((o[0] + o[1]) + (o[2] + o[3])) + bo[tc]);
      *dst = v;
      if (blk + 1 < nblk) {
        const float4 v4 = gather4(v);
        if (tc % 4 == 0)
          for (int d = 1; d < kC; ++d)
            push16(ewvit::smem_u32(dst), (rank + d) % kC, v4, bar_x);
      }
    }
  }

  __syncthreads();
  if (row0 + tr < n) {                             // this CTA's columns of both outputs
    const long long at = (long long)(row0 + tr) * kD + rank * kW + tc;
    so[at] = ewvit::from_f32<T>(sm[kSp + tr * kXS + rank * kW + tc]);
    fo[at] = ewvit::from_f32<T>(sm[kFr + tr * kXS + rank * kW + tc]);
  }
  cluster.sync();      // no CTA leaves while a push from it may still be in flight
}

void launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int n,
                   cudaStream_t stream) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)((n + kR - 1) / kR * kC));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kC;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <typename T>
cudaError_t prepare() {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        xattn_cluster_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  return cudaSuccess;
}

template <typename T>
int launch(const void* space, const void* freq, const float* packed, void* so, void* fo,
           int n, int nblk, int heads, cudaStream_t stream) {
  cudaError_t e = prepare<T>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, n, stream);
  e = cudaLaunchKernelEx(&cfg, xattn_cluster_kernel<T>, static_cast<const T*>(space),
                         static_cast<const T*>(freq), packed, static_cast<T*>(so),
                         static_cast<T*>(fo), n, nblk, heads);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int max_active_clusters() {
  cudaError_t e = prepare<__nv_bfloat16>();
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(cfg, attr, 64, 0);   // the count does not depend on the grid
  int count = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&count, xattn_cluster_kernel<__nv_bfloat16>, &cfg);
  return e == cudaSuccess ? count : -(int)e;
}

}  // namespace cl

}  // namespace

extern "C" int ewvit_fused_bidir_xattn_general(const void* space, const void* freq,
                                               const void* mats, const void* smalls,
                                               void* so, void* fo, int n, int d,
                                               int depth, int heads, int dtype,
                                               void* stream) {
  if (n <= 0 || d <= 0 || depth <= 0 || heads <= 0 || d % heads || d % 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(d, heads);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EWVIT_DISPATCH(dtype, T,
    xattn_general_kernel<T><<<blocks, kThreads, smem, s>>>(
        static_cast<const T*>(space), static_cast<const T*>(freq),
        static_cast<const float*>(mats), static_cast<const float*>(smalls),
        static_cast<T*>(so), static_cast<T*>(fo), n, d, depth, heads));
  return (int)cudaGetLastError();
}

extern "C" int ewvit_fused_bidir_xattn_cluster(const void* space, const void* freq,
                                               const void* packed, void* so, void* fo,
                                               int n, int depth, int heads, int dtype,
                                               void* stream) {
  if (n <= 0 || depth <= 0 || heads <= 0 || cl::kD % heads || (cl::kD / heads) % cl::kW)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(space) | reinterpret_cast<uintptr_t>(freq) |
       reinterpret_cast<uintptr_t>(packed)) & 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EWVIT_DISPATCH(dtype, T, return cl::launch<T>(space, freq, static_cast<const float*>(packed),
                                                 so, fo, n, 2 * depth, heads, s));
  return (int)cudaErrorInvalidValue;
}

// How many clusters of the bf16 kernel can be resident at once
// (cudaOccupancyMaxActiveClusters), or -cudaError_t.
extern "C" int ewvit_xattn_cluster_max_active() { return cl::max_active_clusters(); }
