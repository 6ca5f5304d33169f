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
// the context values (kv_include_self).
//
// Bound: operations. At N rows and D = 128 the stack does 48*N*D^2
// multiply-adds against ~1 MB of fp32 weights; everything else is O(N*D).
// The projections are computed here, with fp32 FMAs, not by a library GEMM.
// A block owns kRows rows for the whole stack and keeps both token matrices,
// the normed rows and the projections in shared memory; what limits it is
// streaming the 1 MB of weights through the SM. So each projection is split
// over the block's threads by (4-column group, k segment): a thread issues
// all its 16-byte weight loads of one segment back to back (coalesced along
// the output axis, from L2 after the first block), applies each to all kRows
// rows, and leaves a partial sum in shared memory; the partials are then
// added in segment order. Weights: mats [2*depth, D, 4D] = Wq | Wkv | Wo with
// [in, out] layout; smalls [2*depth, 3, D] = (ln scale, ln bias, out bias).
// D must be a multiple of 4.
//
//   space, freq [N, D] (f32/bf16) -> so, fo [N, D] same dtype; math fp32.
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
fused_bidir_xattn_kernel(const T* __restrict__ space, const T* __restrict__ freq,
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

}  // namespace

extern "C" int ewvit_fused_bidir_xattn(const void* space, const void* freq,
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
    fused_bidir_xattn_kernel<T><<<blocks, kThreads, smem, s>>>(
        static_cast<const T*>(space), static_cast<const T*>(freq),
        static_cast<const float*>(mats), static_cast<const float*>(smalls),
        static_cast<T*>(so), static_cast<T*>(fo), n, d, depth, heads));
  return (int)cudaGetLastError();
}
