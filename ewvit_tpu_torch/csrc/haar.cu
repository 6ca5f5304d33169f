// K1: one-level 2-D Haar DWT, NCHW.
//
// Replaces the Pallas kernel ewvit_tpu/ops/haar.py:haar_dwt2d_pallas (body
// _haar_matmul_kernel), which computes Z = R.X.C^T on the TPU's matrix unit
// because Mosaic cannot lower stride-2 lane reads. On Hopper the transform is
// what it is: a 2x2 butterfly with 4 adds per output, far below one operation
// per byte, so the bound is memory (read x once, write ll and hf once). The
// kernel is one pass: each thread reads its 2x2 block as two 2-element vector
// loads, does the butterfly in fp32 (as the TPU kernel's fp32 matmul does),
// rounds once to the storage type, and writes LL to ll[n, c] and (LH, HL, HH)
// straight into hf's interleaved channels c*3 + band, so no stack or
// transpose pass follows.
//
//   x  [N, C, H, W]      ll [N, C, H/2, W/2]      hf [N, 3C, H/2, W/2]
//
// grid.x tiles the H/2 x W/2 output plane, grid.y walks the N*C planes.
#include "common.cuh"

namespace {

template <typename T>
__global__ void haar_dwt2d_kernel(const T* __restrict__ x, T* __restrict__ ll,
                                  T* __restrict__ hf, int planes, int h, int w) {
  const int h2 = h >> 1, w2 = w >> 1;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= h2 * w2) return;
  const int i = pix / w2, j = pix - i * w2;
  const long long plane_out = (long long)h2 * w2;
  for (int nc = blockIdx.y; nc < planes; nc += gridDim.y) {
    const T* p = x + ((long long)nc * h + 2 * i) * w + 2 * j;
    float a, b, c, d;
    ewvit::load2(p, a, b);
    ewvit::load2(p + w, c, d);
    ll[nc * plane_out + pix] = ewvit::from_f32<T>((((a + b) + c) + d) * 0.5f);
    T* o = hf + 3LL * nc * plane_out + pix;  // channel (n*C + c)*3 + band
    o[0] = ewvit::from_f32<T>((((a + b) - c) - d) * 0.5f);               // LH
    o[plane_out] = ewvit::from_f32<T>((((a - b) + c) - d) * 0.5f);       // HL
    o[2 * plane_out] = ewvit::from_f32<T>((((a - b) - c) + d) * 0.5f);   // HH
  }
}

}  // namespace

extern "C" int ewvit_haar_dwt2d(const void* x, void* ll, void* hf, int n, int c,
                                int h, int w, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || (h & 1) || (w & 1))
    return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int out_pix = (h / 2) * (w / 2);
  const int planes = n * c;
  dim3 grid((out_pix + threads - 1) / threads, planes < 65535 ? planes : 65535);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EWVIT_DISPATCH(dtype, T,
    haar_dwt2d_kernel<T><<<grid, threads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(ll), static_cast<T*>(hf),
        planes, h, w));
  return (int)cudaGetLastError();
}
