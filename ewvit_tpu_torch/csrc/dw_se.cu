// K2: stride-1 SAME depthwise k x k conv with BN folded in, SiLU, and the
// fp32 spatial mean of the result, in one pass. NCHW.
//
// Replaces the Pallas kernel ewvit_tpu/ops/dw_se.py:dw_bn_silu_mean. In the
// V2-S backbone it sits in every stride-1 squeeze-excite MBConv (28 per
// chunk at 224px, planes of 14x14 and 7x7, 512-1536 channels); the SE mean
// rides the pass that writes y, so y is never read back for the squeeze.
//
// Bound: memory. Per output it does k*k fused multiply-adds and one exp
// against 2 bytes read and 2 written (bf16), ~5 operations per byte, far
// under the card's ~20 fp32 operations per byte of memory rate. Design:
// one warp per (n, c) plane. The warp stages the plane with its zero halo in
// shared memory (every tap then reads shared memory, never device memory
// twice), applies the taps in fp32 in the TPU kernel's order (dh-major),
// adds the shift, applies SiLU, rounds to the storage type and stores y; the
// mean sums the ROUNDED y (as the TPU kernel does) with a warp reduction and
// writes mean[n, c]. No cross-block reduction is needed because a plane
// belongs to one warp.
//
//   x [N, C, H, W]  w_eff [k*k, C] f32  shift [C] f32
//   y [N, C, H, W]  mean [N, C] f32
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

// HC, WC > 0 fix the plane size at compile time (the main path's 14x14 and
// 7x7), so the index arithmetic below is multiply-shift and the loops
// unroll; 0 means the size comes at run time (any other plane).
template <typename T, int K, int HC, int WC>
__global__ void __launch_bounds__(kWarps * 32)
dw_bn_silu_mean_kernel(const T* __restrict__ x, const float* __restrict__ w_eff,
                       const float* __restrict__ shift, T* __restrict__ y,
                       float* __restrict__ mean, int planes, int c, int h_rt, int w_rt) {
  extern __shared__ float smem[];
  constexpr int P = K / 2;
  const int h = HC > 0 ? HC : h_rt, w = WC > 0 ? WC : w_rt;
  const int hp = h + 2 * P, wp = w + 2 * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int plane = blockIdx.x * kWarps + warp;
  if (plane >= planes) return;  // no block-wide barrier below
  const int ch = plane % c;
  float* s = smem + warp * hp * wp;
  const long long base = (long long)plane * h * w;
  const T* xp = x + base;

  // stage the plane with its zero halo: zero everything, then the interior
  for (int t = lane; t < hp * wp; t += 32) s[t] = 0.f;
  __syncwarp();
  for (int t = lane; t < h * w; t += 32) {
    const int r = t / w, q = t - r * w;
    s[(r + P) * wp + q + P] = ewvit::to_f32(xp[t]);
  }
  float wk[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) wk[t] = w_eff[t * c + ch];
  const float b = shift[ch];
  __syncwarp();

  float sum = 0.f;
  for (int pix = lane; pix < h * w; pix += 32) {
    const int r = pix / w, q = pix - r * w;
    const float* sp = s + r * wp + q;
    float acc = 0.f;
#pragma unroll
    for (int dh = 0; dh < K; ++dh)
#pragma unroll
      for (int dw = 0; dw < K; ++dw)
        acc += sp[dh * wp + dw] * wk[dh * K + dw];
    acc += b;
    const T yc = ewvit::from_f32<T>(acc * (1.f / (1.f + expf(-acc))));
    y[base + pix] = yc;
    sum += ewvit::to_f32(yc);
  }
  sum = ewvit::warp_sum(sum);
  if (lane == 0) mean[plane] = sum * (1.f / (float)(h * w));
}

template <typename T, int K, int HC, int WC>
int launch(const void* x, const float* w_eff, const float* shift, void* y,
           float* mean, int n, int c, int h, int w, cudaStream_t s) {
  const int planes = n * c;
  const int blocks = (planes + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * (h + K - 1) * (w + K - 1);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dw_bn_silu_mean_kernel<T, K, HC, WC><<<blocks, kWarps * 32, smem, s>>>(
      static_cast<const T*>(x), w_eff, shift, static_cast<T*>(y), mean,
      planes, c, h, w);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_any(const void* x, const float* w_eff, const float* shift, void* y,
               float* mean, int n, int c, int h, int w, cudaStream_t s) {
  if (h == 14 && w == 14) return launch<T, K, 14, 14>(x, w_eff, shift, y, mean, n, c, h, w, s);
  if (h == 7 && w == 7) return launch<T, K, 7, 7>(x, w_eff, shift, y, mean, n, c, h, w, s);
  return launch<T, K, 0, 0>(x, w_eff, shift, y, mean, n, c, h, w, s);
}

}  // namespace

extern "C" int ewvit_dw_bn_silu_mean(const void* x, const void* w_eff,
                                     const void* shift, void* y, void* mean,
                                     int n, int c, int h, int w, int k,
                                     int dtype, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w_eff);
  const float* sf = static_cast<const float*>(shift);
  float* mf = static_cast<float*>(mean);
  if (k == 3) {
    EWVIT_DISPATCH(dtype, T, return launch_any<T, 3>(x, wf, sf, y, mf, n, c, h, w, s));
  } else if (k == 5) {
    EWVIT_DISPATCH(dtype, T, return launch_any<T, 5>(x, wf, sf, y, mf, n, c, h, w, s));
  }
  return (int)cudaErrorInvalidValue;
}
