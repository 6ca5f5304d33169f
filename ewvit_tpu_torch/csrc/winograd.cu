// K3 and K5: 3x3 stride-1 SAME convolution by Winograd F(2x2,3x3), NCHW.
//
// One device core, two entry points:
//
//   ewvit_fused_multiscale_winograd (K3) replaces the Pallas kernel
//     ewvit_tpu/ops/mwt_tail.py:fused_multiscale_winograd, the MWT's
//     multiscale_fusion: relu(conv3x3(concat_l y_l) . bn_scale + bias) over
//     L level maps, with the BN scale folded into U and the conv bias and BN
//     shift folded into one fp32 bias;
//   ewvit_conv3x3_winograd (K5) replaces the Pallas kernel
//     ewvit_tpu/ops/winograd_pallas.py:conv3x3_winograd_pallas: one map, no
//     bias, no ReLU.
//
// Per 2x2 output tile, Y = A^T [ sum_c (G g_c G^T) . (B^T d_c B) ] A: an
// input transform of +-1 adds (V, fp32, rounded to the storage type as the
// TPU kernels round it before their matmuls), 16 transform-domain products
// contracting over input channels (fp32 accumulation), and the inverse
// transform A^T M A (signs of mwt_tail.py:66-73). The 16 products are the
// work: 2*16*T*Cin*Cout operations for T tiles, against 9*2*4*T*Cin*Cout for
// the direct conv. Bound: for K3 at the MWT's full-width shape (T = 64*56*56
// tiles, Cin = 3*128, Cout = 128, bf16) 3.16e11 operations against 0.82 GB
// moved, ~380 operations per byte: above the H100's ~295 bf16 tensor-core
// operations per byte, so the tensor cores bound it (0.32 ms), not memory
// (0.25 ms). In fp32, without tensor cores, the bound is 4.7 ms of FMAs.
//
// Design:
// - The TPU kernels take phase-split arrays because Mosaic cannot read
//   stride-2 lanes; here the inputs are read dense (NCHW, like the rest of
//   the port) and the output written dense. The SAME zero ring is produced
//   while staging (zero-filled copies), which is where the TPU kernel's VMEM
//   ring came from.
// - K3 takes the L level maps as separate pointers: concat(y_0..y_2) is never
//   materialised (616.6 MB written and read again per 64-row chunk).
// - A block owns 4 x 8 = 32 output tiles (8 x 16 output pixels) of one image
//   and 128 output channels. It walks the levels and, inside each, chunks of
//   32 input channels. A chunk's 10 x 20 halo is copied with cp.async into
//   one of two shared-memory buffers while the previous chunk multiplies,
//   so the loads' latency hides behind the products (staged synchronously,
//   it left the SM idle). The block then forms the 16 V planes per (tile,
//   channel) and stores them, rounded, in shared memory; each of its 8 warps
//   (2 tile groups of 16 x 4 channel groups of 32) forms, for each of the 16
//   transform positions, the partial product M over the chunk and folds it
//   straight into its 4 output-phase accumulators with the A^T signs. The
//   accumulators are thus 4 x (tiles x channels) fp32 registers rather than
//   16 x: the inverse transform is linear, so it commutes with the sum over
//   chunks (the TPU kernel folds per level the same way). Registers are
//   capped at 128 so that two blocks share an SM.
// - bf16: the products run on the tensor cores as mma.sync m16n8k16 (bf16
//   inputs, fp32 accumulate). fp32: plain fp32 FMAs with the same fragment
//   ownership (no TF32, which would lose the fp32 tolerance).
// - U is read from device memory (L2-resident: 1.5 MB for K3) in the layout
//   [L][16][Cout_pad][Cin_pad] (Cout padded to 128 and Cin to 32 with zeros
//   by the wrapper's pack_u), input channels permuted within each 16 so that
//   a lane's B fragment is one 8-byte load (kperm below). A block reuses
//   each U element for 32 tiles only, so the warps stream U from L2 (9.6 GB
//   per full-width K3 call, more where L1 misses): staging U in shared
//   memory over more tiles per block is the next version's work.
// - Epilogue: bias, ReLU (K3), one rounding, dense stores.
//
// The C functions return cudaGetLastError(); cudaErrorInvalidValue refuses a
// shape the kernel does not take (odd H or W, L outside 1..4), and
// cudaErrorMisalignedAddress an input not aligned to 4 bytes.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kTR = 4, kTC = 8;            // tile rows x tile cols per block
constexpr int kTiles = kTR * kTC;           // GEMM rows per block
constexpr int kNB = 128;                    // output channels per block
constexpr int kKC = 32;                     // input channels per step
constexpr int kHR = 2 * kTR + 2;            // staged halo rows
constexpr int kHW = 2 * kTC + 4;            // staged halo cols, from an even column
constexpr int kStages = 2;                  // halo buffers: chunk i+1 loads while i multiplies
constexpr int kThreads = 256;               // 8 warps: 2 tile groups x 4 channel groups

struct Levels {
  const void* p[kMaxLevels];
};

// V row stride (elements) per storage type: bf16 rows of 40 halves (20
// words) and fp32 rows of 34 floats keep the fragment loads free of bank
// conflicts.
template <typename T> struct VStride;
template <> struct VStride<__nv_bfloat16> { static constexpr int value = kKC + 8; };
template <> struct VStride<float> { static constexpr int value = kKC + 2; };

__host__ __device__ constexpr size_t smem_bytes(size_t elem, int kcp) {
  return elem * kStages * kKC * kHR * kHW + elem * 16 * kTiles * kcp;
}

// Input channels of U are stored permuted within each group of 16 (the
// wrapper's pack_u): logical pairs (2j, 2j+1) at position 4j for j < 4 and
// 4(j-4) + 2 for j >= 4, so a lane's two B-fragment pairs (k = 2*t4 and
// 2*t4 + 8) are one 8-byte load. Logical channel of stored position p:
__device__ __forceinline__ constexpr int kperm(int p) {
  return (p & ~15) + ((p & 3) >= 2 ? 8 : 0) + 2 * ((p & 15) >> 2) + (p & 1);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {  // all but the newest group landed
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// A^T of F(2x2,3x3): [[1, 1, 1, 0], [0, 1, -1, -1]].
__device__ __forceinline__ constexpr float at(int r, int u) {
  return r == 0 ? (u < 3 ? 1.f : 0.f) : (u == 0 ? 0.f : (u == 1 ? 1.f : -1.f));
}

// B^T combination along one axis: (r0 - r2, r1 + r2, r2 - r1, r1 - r3).
__device__ __forceinline__ void bt4(float a, float b, float c, float d, float (&o)[4]) {
  o[0] = a - c; o[1] = b + c; o[2] = c - b; o[3] = b - d;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// m[nf][i] += sum over the chunk's kKC channels of V[row][k] * U[col][k], for
// this lane's fragment of a warp's 16 x 32 block: rows g and g + 8
// (i = 0, 1 and 2, 3), columns nf*8 + 2*t4 + (i & 1). va points at the warp's
// first V row (row stride kcp); ub at the warp's first U row (stride cin_pad),
// both at the chunk's first channel.
template <typename T>
__device__ __forceinline__ void products(float (&m)[4][4], const T* va, const T* ub,
                                         int cin_pad, int g, int t4);

template <>
__device__ __forceinline__ void products<__nv_bfloat16>(
    float (&m)[4][4], const __nv_bfloat16* va, const __nv_bfloat16* ub, int cin_pad,
    int g, int t4) {
  constexpr int kcp = VStride<__nv_bfloat16>::value;
#pragma unroll
  for (int ks = 0; ks < kKC; ks += 16) {
    uint32_t a[4];
    a[0] = ld32(va + g * kcp + ks + 2 * t4);
    a[1] = ld32(va + (g + 8) * kcp + ks + 2 * t4);
    a[2] = ld32(va + g * kcp + ks + 8 + 2 * t4);
    a[3] = ld32(va + (g + 8) * kcp + ks + 8 + 2 * t4);
    uint2 b[4];
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
      b[nf] = __ldg(reinterpret_cast<const uint2*>(ub + (nf * 8 + g) * cin_pad + ks + 4 * t4));
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) mma_bf16(m[nf], a, b[nf].x, b[nf].y);
  }
}

template <>
__device__ __forceinline__ void products<float>(float (&m)[4][4], const float* va,
                                                const float* ub, int cin_pad, int g,
                                                int t4) {
  constexpr int kcp = VStride<float>::value;
  const float* a0p = va + g * kcp;
  const float* a1p = va + (g + 8) * kcp;
#pragma unroll
  for (int p = 0; p < kKC; p += 2) {
    const int k = kperm(p);
    const float2 a0 = *reinterpret_cast<const float2*>(a0p + k);
    const float2 a1 = *reinterpret_cast<const float2*>(a1p + k);
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(
            ub + (nf * 8 + 2 * t4 + j) * cin_pad + p));
        m[nf][j] = fmaf(a0.y, b.y, fmaf(a0.x, b.x, m[nf][j]));
        m[nf][2 + j] = fmaf(a1.y, b.y, fmaf(a1.x, b.x, m[nf][2 + j]));
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
winograd_kernel(Levels ys, const T* __restrict__ u, const float* __restrict__ bias,
                T* __restrict__ out, int levels, int cin, int cin_pad, int cout,
                int cout_pad, int h, int w, int relu, int col_blocks) {
  constexpr int kcp = VStride<T>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* halo = reinterpret_cast<T*>(smem_raw);                 // [kStages][kKC][kHR][kHW]
  T* vs = halo + kStages * kKC * kHR * kHW;                 // [16][kTiles][kcp]

  const int n = blockIdx.z;
  const int tr0 = (blockIdx.x / col_blocks) * kTR;   // first tile row / col of the block
  const int tc0 = (blockIdx.x % col_blocks) * kTC;
  const int co0 = blockIdx.y * kNB;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int tg = warp & 1, ng = warp >> 1;            // tiles tg*16.., channels ng*32..
  const long long plane = (long long)h * w;

  float acc[4][4][4];                                 // [2r + s][nf][i]
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[q][nf][i] = 0.f;

  // Chunks run level-major: step -> (level, first channel). Each thread
  // copies its 4-byte units of a chunk's halo (one bf16 pair or one fp32
  // element, from the even column 2*tc0 - 2) straight into shared memory;
  // units outside the map or past cin are zero-filled.
  const int steps_per_level = (cin + kKC - 1) / kKC, steps = levels * steps_per_level;
  constexpr int kPer = 4 / sizeof(T);                       // elements per unit
  constexpr int kUnitsRow = kHW / kPer, kUnits = kKC * kHR * kUnitsRow;
  auto stage_chunk = [&](int step, int buf) {
    const int l = step / steps_per_level, k0 = (step - l * steps_per_level) * kKC;
    const T* x = static_cast<const T*>(ys.p[l]) + (long long)n * cin * plane;
    T* dst = halo + buf * kKC * kHR * kHW;
    for (int e = tid; e < kUnits; e += kThreads) {
      const int kc = e / (kHR * kUnitsRow), rem = e - kc * (kHR * kUnitsRow);
      const int i = rem / kUnitsRow, jj = (rem - i * kUnitsRow) * kPer;
      const int c = k0 + kc, row = 2 * tr0 - 1 + i, col = 2 * tc0 - 2 + jj;
      const bool ok = c < cin && row >= 0 && row < h && col >= 0 && col < w;
      cp_async4(dst + (kc * kHR + i) * kHW + jj,
                ok ? x + c * plane + (long long)row * w + col : x, ok);
    }
  };
  stage_chunk(0, 0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    const int l = step / steps_per_level, k0 = (step - l * steps_per_level) * kKC;
    const T* ul = u + ((long long)l * 16 * cout_pad + co0 + ng * 32) * cin_pad;
    if (step + 1 < steps) stage_chunk(step + 1, (step + 1) & 1);
    cp_async_commit();
    cp_async_wait1();   // this thread's copies of `step` have landed
    __syncthreads();    // everyone's have; everyone is done with the previous V
    {
      // 2. input transform V = B^T d B per (tile, channel), rounded to T
      const T* hb = halo + (step & 1) * kKC * kHR * kHW;
      for (int e = tid; e < kTiles * kKC; e += kThreads) {
        const int kc = e / kTiles, t = e - kc * kTiles;
        const int tr = t / kTC, tc = t - tr * kTC;
        const T* d = hb + (kc * kHR + 2 * tr) * kHW + 2 * tc + 1;
        float r[4][4];                                  // r[i][v]: along columns
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bt4(ewvit::to_f32(d[i * kHW]), ewvit::to_f32(d[i * kHW + 1]),
              ewvit::to_f32(d[i * kHW + 2]), ewvit::to_f32(d[i * kHW + 3]), r[i]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float col[4];                                 // col[u]: along rows
          bt4(r[0][v], r[1][v], r[2][v], r[3][v], col);
#pragma unroll
          for (int uu = 0; uu < 4; ++uu)
            vs[((4 * uu + v) * kTiles + t) * kcp + kc] = ewvit::from_f32<T>(col[uu]);
        }
      }
      __syncthreads();
      // 3. the 16 transform-domain products over the chunk, folded by A^T
#pragma unroll
      for (int uv = 0; uv < 16; ++uv) {
        float m[4][4];
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) m[nf][i] = 0.f;
        products<T>(m, vs + (uv * kTiles + tg * 16) * kcp,
                    ul + (long long)uv * cout_pad * cin_pad + k0, cin_pad, g, t4);
        const int uu = uv >> 2, v = uv & 3;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (at(r, uu) == 0.f) continue;
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (at(s, v) == 0.f) continue;
            const float sign = at(r, uu) * at(s, v);
#pragma unroll
            for (int nf = 0; nf < 4; ++nf)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[2 * r + s][nf][i] += sign * m[nf][i];
          }
        }
      }
    }
  }

  // 4. epilogue: bias, ReLU, one rounding, dense stores
  const int h2 = h >> 1, w2 = w >> 1;
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = tg * 16 + g + (i >= 2 ? 8 : 0);
      const int co = co0 + ng * 32 + nf * 8 + 2 * t4 + (i & 1);
      const int tr = tr0 + t / kTC, tc = tc0 + t % kTC;
      if (tr >= h2 || tc >= w2 || co >= cout) continue;
      const float b = bias != nullptr ? bias[co] : 0.f;
      T* o = out + ((long long)n * cout + co) * plane + (long long)(2 * tr) * w + 2 * tc;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float val = acc[2 * r + s][nf][i] + b;
          if (relu) val = fmaxf(val, 0.f);
          o[r * w + s] = ewvit::from_f32<T>(val);
        }
    }
  }
}

template <typename T>
int launch(const Levels& ys, const void* u, const float* bias, void* out, int n,
           int levels, int cin, int cout, int h, int w, int relu, cudaStream_t s) {
  constexpr size_t smem = smem_bytes(sizeof(T), VStride<T>::value);
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        winograd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int h2 = h / 2, w2 = w / 2;
  const int col_blocks = (w2 + kTC - 1) / kTC, row_blocks = (h2 + kTR - 1) / kTR;
  const int cin_pad = (cin + kKC - 1) / kKC * kKC;
  const int cout_pad = (cout + kNB - 1) / kNB * kNB;
  const dim3 grid(row_blocks * col_blocks, cout_pad / kNB, n);
  winograd_kernel<T><<<grid, kThreads, smem, s>>>(
      ys, static_cast<const T*>(u), bias, static_cast<T*>(out), levels, cin, cin_pad,
      cout, cout_pad, h, w, relu, col_blocks);
  return (int)cudaGetLastError();
}

int run(const Levels& ys, const void* u, const float* bias, void* out, int n,
        int levels, int cin, int cout, int h, int w, int relu, int dtype, void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || (h & 1) || (w & 1) ||
      levels < 1 || levels > kMaxLevels || n > 65535)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l)
    if (reinterpret_cast<uintptr_t>(ys.p[l]) & 3) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EWVIT_DISPATCH(dtype, T,
                 return launch<T>(ys, u, bias, out, n, levels, cin, cout, h, w, relu, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3: out = relu(sum_l conv3x3(ys[l], U_l) + bias). ys: `levels` pointers to
// [N, C, H, W]; u: [levels][16][C_pad128][C_pad32] (BN scale folded in);
// bias: [C] fp32; out: [N, C, H, W].
extern "C" int ewvit_fused_multiscale_winograd(const void* const* ys, const void* u,
                                               const void* bias, void* out, int n,
                                               int levels, int c, int h, int w,
                                               int dtype, void* stream) {
  if (levels < 1 || levels > kMaxLevels || ys == nullptr || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  for (int l = 0; l < levels; ++l) lv.p[l] = ys[l];
  return run(lv, u, static_cast<const float*>(bias), out, n, levels, c, c, h, w, 1,
             dtype, stream);
}

// K5: out = conv3x3(x, U), no bias. x: [N, Cin, H, W]; u: [1][16][Cout_pad128]
// [Cin_pad32]; out: [N, Cout, H, W].
extern "C" int ewvit_conv3x3_winograd(const void* x, const void* u, void* out, int n,
                                      int cin, int cout, int h, int w, int dtype,
                                      void* stream) {
  Levels lv{};
  lv.p[0] = x;
  return run(lv, u, nullptr, out, n, 1, cin, cout, h, w, 0, dtype, stream);
}
