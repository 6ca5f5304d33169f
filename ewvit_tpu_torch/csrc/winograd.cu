// K3 and K5: 3x3 stride-1 SAME convolution by Winograd F(2x2,3x3), NCHW.
//
// One core, two entry points:
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
// input transform of +-1 adds (V, fp32, rounded to the storage type before
// the products, as the TPU kernels round it before their matmuls), 16
// transform-domain products contracting over input channels (fp32
// accumulation), and the inverse transform A^T M A. The 16 products are the
// work: 2*16*T*Cin*Cout operations for T tiles. Bound: for K3 at the MWT's
// full-width shape (T = 64*56*56, Cin = 3*128, Cout = 128, bf16) 3.16e11
// operations against 0.82 GB moved, ~380 operations per byte: above the
// H100's ~295 bf16 tensor-core operations per byte, so the tensor cores bound
// it (0.32 ms), not memory (0.25 ms). In fp32, without tensor cores, the
// bound is 4.7 ms of FMAs.
//
// Both read the maps dense (NCHW) and write the output dense: the TPU
// kernels take phase-split arrays only because Mosaic cannot read stride-2
// lanes. The SAME ring is produced while staging (zero-filled copies). K3
// takes the L level maps as separate pointers: concat(y_0..y_2) is never
// materialised. The inverse transform is linear, so it commutes with the sum
// over input channels: each partial product is folded into four output-phase
// accumulators as soon as it is formed, and a thread never holds 16.
//
// bf16 (the served type): a warp-specialised Hopper kernel.
// - A block owns 8 x 8 output tiles (16 x 16 output pixels: the 56 x 56 tile
//   grid of the served shape divides by 8) and 128 output channels, and walks
//   the levels and, in each, chunks of kKC = 64 input channels. 3,136 blocks
//   at the served shape, ~24 waves over 132 SMs, so no persistent loop: a
//   block's prologue and epilogue overlap its neighbours' main loops on the
//   same SM only through the other resident warps, which is what the next
//   version would win back. 384 threads, three warpgroups:
//   - warpgroup 2, the transform, also stages the halo. The chunk's 64 x 18
//     x 24 halo (55,296 bytes; columns from 2*tc0 - 4) goes into one of two
//     stages, two chunks ahead, by cp.async with zero fill (which gives the
//     SAME ring and the channels past Cin) from its 128 threads: the 16
//     interior columns of a row as 8-byte copies where W % 4 == 0, else as
//     4-byte copies, and the two edge pairs as 4-byte copies. Each thread's
//     copies arrive on the stage's mbarrier (cp.async.mbarrier.arrive). Not
//     TMA: the H100 faults (illegal instruction) on a tiled TMA load whose
//     innermost start coordinate is not 16-byte aligned, and the halo starts
//     at column 2*tc0 - 1; an aligned box would be 32 columns wide, and two
//     stages of it (147 KB) do not fit beside V and U. The transform turns
//     the halo into V = B^T d B (+-1 adds in fp32, in the plain version's
//     order, rounded to bf16) four transform positions at a time (one row u
//     of the 4 x 4 transform: two halo rows per channel) into a ring of 2 x 4
//     V slots of 64 tiles x 64 channels, in the 128-byte-swizzled K-major
//     layout of the wgmma A operand. A lane forms 8 tiles x 2 channels so
//     that its shared-memory reads and 4-byte stores are free of bank
//     conflicts; the channels within each 8 are stored permuted to that end,
//     and pack_u permutes U alike;
//   - warpgroups 0 and 1, the consumers, 64 output channels each. Each keeps
//     its own ring of 3 U slots full: its thread 0 issues one cp.async.bulk
//     of 8 KB (its half of a 128 x 64 U tile) per (level, chunk, transform
//     position) onto an mbarrier as soon as its four warps have freed the
//     slot. (A 2-CTA cluster that multicast each tile into both CTAs, which
//     halves U's L2 reads, measured slower: the two CTAs' rings advance in
//     lock step through remote arrivals; PERF.md.) The wrapper's
//     pack_u stores each U tile contiguously, already in the swizzled K-major
//     layout that the wgmma B descriptor reads. The inverse transform is
//     done by the tensor cores: per transform position (u, v) and output
//     phase (r, s) with A^T[r][u] A^T[s][v] != 0, 4 x wgmma m64n64k16 (bf16
//     in, fp32 out, A = V_uv and B = U_uv from shared memory through
//     descriptors, imm-scale-a = the sign) accumulate straight into that
//     phase's 32 registers: 36 products of 64 x 64 x 64 per chunk where the
//     transform needs 16, and no fp32 fold, no partial registers and no
//     wait per position (each position is one wgmma group; wait_group 1
//     retires the previous one and frees its U slot). A first version that
//     formed the 16 products into a partial and folded it with fp32 adds
//     needed 4 x 32 + 32 live accumulator registers and spilled at both
//     setmaxnreg splits tried (216/72, 224/56; PERF.md).
//   setmaxnreg gives the consumers 208 registers (4 x 32 accumulators; no
//   spills) and the transform 88 (4 items in flight per lane).
//   Shared memory: halo 2 x 55,296 + V 8 x 8,192 + U 2 x 3 x 8,192 + 18
//   mbarriers = 225,424 bytes (+1 KB for alignment) of 227 KB.
//   Per block and chunk it reads 256 KB of U from L2 (64 tiles reuse each
//   element; 4.8 GB per full-width K3 call) and moves ~2 MB through shared
//   memory (the 36 products read 1.2 MB of V and U; U and V written; halo
//   read three words per tile row), so shared-memory and L2 bandwidth, not
//   the tensor cores, are the expected limits.
// - Epilogue: bias, ReLU (K3), one rounding, dense bf16x2 stores; tiles past
//   H/2 x W/2 and channels past Cout are masked.
//
// fp32: FMAs, no TF32 (which would lose the fp32 tolerance). A block owns
// 4 x 8 tiles and 128 output channels in 8 warps; chunks of 32 channels are
// staged by cp.async into a double buffer, the block forms V in shared memory
// and each warp forms, per transform position, the partial product over the
// chunk and folds it into its 4 output-phase accumulators. U is read from L2
// in the layout [L][16][Cout_pad128][Cin_pad32], channels permuted in 16s
// (pack_u's fp32 layout).
//
// Switches for an ablation build (winograd_ablation.py sets them through
// EWVIT_NVCC_EXTRA; the served build sets none): EWVIT_WINOGRAD_ABLATE_MMA
// and EWVIT_WINOGRAD_ABLATE_TRANSFORM drop the wgmmas or the V transform,
// for timing only (the results are then wrong).
//
// The C functions return cudaGetLastError(); cudaErrorInvalidValue refuses a
// shape the kernel does not take (odd H or W, L outside 1..4), and
// cudaErrorMisalignedAddress an input not aligned to 4 bytes (U to 16).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxLevels = 4;

struct Levels {
  const void* p[kMaxLevels];
};

// A^T of F(2x2,3x3): [[1, 1, 1, 0], [0, 1, -1, -1]].
__device__ __forceinline__ constexpr float at(int r, int u) {
  return r == 0 ? (u < 3 ? 1.f : 0.f) : (u == 0 ? 0.f : (u == 1 ? 1.f : -1.f));
}

// B^T combination along one axis: (r0 - r2, r1 + r2, r2 - r1, r1 - r3).
__device__ __forceinline__ void bt4(float a, float b, float c, float d, float (&o)[4]) {
  o[0] = a - c; o[1] = b + c; o[2] = c - b; o[3] = b - d;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t s, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async8(uint32_t s, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 8 : 0));
}

// ------------------------------------------------------------------ fp32

namespace f32 {

constexpr int kTR = 4, kTC = 8;            // tile rows x tile cols per block
constexpr int kTiles = kTR * kTC;           // GEMM rows per block
constexpr int kNB = 128;                    // output channels per block
constexpr int kKC = 32;                     // input channels per step
constexpr int kHR = 2 * kTR + 2;            // staged halo rows
constexpr int kHW = 2 * kTC + 4;            // staged halo cols, from an even column
constexpr int kStages = 2;                  // halo buffers: chunk i+1 loads while i multiplies
constexpr int kThreads = 256;               // 8 warps: 2 tile groups x 4 channel groups
constexpr int kcp = kKC + 2;                // V row stride: conflict-free float2 reads
constexpr size_t kSmem = sizeof(float) * (kStages * kKC * kHR * kHW + 16 * kTiles * kcp);

// Input channels of U are stored permuted within each group of 16 (pack_u's
// fp32 layout): logical pairs (2j, 2j+1) at position 4j for j < 4 and
// 4(j-4) + 2 for j >= 4. Logical channel of stored position p:
__device__ __forceinline__ constexpr int kperm(int p) {
  return (p & ~15) + ((p & 3) >= 2 ? 8 : 0) + 2 * ((p & 15) >> 2) + (p & 1);
}

// m[nf][i] += sum over the chunk's kKC channels of V[row][k] * U[col][k], for
// this lane's fragment of a warp's 16 x 32 block: rows g and g + 8
// (i = 0, 1 and 2, 3), columns nf*8 + 2*t4 + (i & 1).
__device__ __forceinline__ void products(float (&m)[4][4], const float* va, const float* ub,
                                         int cin_pad, int g, int t4) {
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

__global__ void __launch_bounds__(kThreads, 2)
winograd_kernel(Levels ys, const float* __restrict__ u, const float* __restrict__ bias,
                float* __restrict__ out, int levels, int cin, int cin_pad, int cout,
                int cout_pad, int h, int w, int relu, int col_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* halo = reinterpret_cast<float*>(smem_raw);        // [kStages][kKC][kHR][kHW]
  float* vs = halo + kStages * kKC * kHR * kHW;             // [16][kTiles][kcp]

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
  // copies its elements of a chunk's halo (from the even column 2*tc0 - 2)
  // straight into shared memory; elements outside the map or past cin are
  // zero-filled.
  const int steps_per_level = (cin + kKC - 1) / kKC, steps = levels * steps_per_level;
  constexpr int kUnits = kKC * kHR * kHW;
  auto stage_chunk = [&](int step, int buf) {
    const int l = step / steps_per_level, k0 = (step - l * steps_per_level) * kKC;
    const float* x = static_cast<const float*>(ys.p[l]) + (long long)n * cin * plane;
    float* dst = halo + buf * kKC * kHR * kHW;
    for (int e = tid; e < kUnits; e += kThreads) {
      const int kc = e / (kHR * kHW), rem = e - kc * (kHR * kHW);
      const int i = rem / kHW, jj = rem - i * kHW;
      const int c = k0 + kc, row = 2 * tr0 - 1 + i, col = 2 * tc0 - 2 + jj;
      const bool ok = c < cin && row >= 0 && row < h && col >= 0 && col < w;
      cp_async4(smem_u32(dst + (kc * kHR + i) * kHW + jj),
                ok ? x + c * plane + (long long)row * w + col : x, ok);
    }
  };
  stage_chunk(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int step = 0; step < steps; ++step) {
    const int l = step / steps_per_level, k0 = (step - l * steps_per_level) * kKC;
    const float* ul = u + ((long long)l * 16 * cout_pad + co0 + ng * 32) * cin_pad;
    if (step + 1 < steps) stage_chunk(step + 1, (step + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);   // this thread's copies of `step` landed
    __syncthreads();    // everyone's have; everyone is done with the previous V
    {
      // input transform V = B^T d B per (tile, channel)
      const float* hb = halo + (step & 1) * kKC * kHR * kHW;
      for (int e = tid; e < kTiles * kKC; e += kThreads) {
        const int kc = e / kTiles, t = e - kc * kTiles;
        const int tr = t / kTC, tc = t - tr * kTC;
        const float* d = hb + (kc * kHR + 2 * tr) * kHW + 2 * tc + 1;
        float r[4][4];                                  // r[i][v]: along columns
#pragma unroll
        for (int i = 0; i < 4; ++i)
          bt4(d[i * kHW], d[i * kHW + 1], d[i * kHW + 2], d[i * kHW + 3], r[i]);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float col[4];                                 // col[u]: along rows
          bt4(r[0][v], r[1][v], r[2][v], r[3][v], col);
#pragma unroll
          for (int uu = 0; uu < 4; ++uu) vs[((4 * uu + v) * kTiles + t) * kcp + kc] = col[uu];
        }
      }
      __syncthreads();
      // the 16 transform-domain products over the chunk, folded by A^T
#pragma unroll
      for (int uv = 0; uv < 16; ++uv) {
        float m[4][4];
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int i = 0; i < 4; ++i) m[nf][i] = 0.f;
        products(m, vs + (uv * kTiles + tg * 16) * kcp,
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

  // epilogue: bias, ReLU, dense stores
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
      float* o = out + ((long long)n * cout + co) * plane + (long long)(2 * tr) * w + 2 * tc;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          float val = acc[2 * r + s][nf][i] + b;
          if (relu) val = fmaxf(val, 0.f);
          o[r * w + s] = val;
        }
    }
  }
}

int launch(const Levels& ys, const float* u, const float* bias, float* out, int n,
           int levels, int cin, int cout, int h, int w, int relu, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        winograd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int h2 = h / 2, w2 = w / 2;
  const int col_blocks = (w2 + kTC - 1) / kTC, row_blocks = (h2 + kTR - 1) / kTR;
  const int cin_pad = (cin + kKC - 1) / kKC * kKC;
  const int cout_pad = (cout + kNB - 1) / kNB * kNB;
  const dim3 grid(row_blocks * col_blocks, cout_pad / kNB, n);
  winograd_kernel<<<grid, kThreads, kSmem, s>>>(ys, u, bias, out, levels, cin, cin_pad, cout,
                                                cout_pad, h, w, relu, col_blocks);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------------------------ bf16

namespace hop {

using bf16 = __nv_bfloat16;

constexpr int kTR = 8, kTC = 8, kTiles = kTR * kTC;  // tiles per block: wgmma's M
constexpr int kNB = 128;                      // output channels per block
constexpr int kNW = 64;                       // output channels per consumer warpgroup
constexpr int kKC = 64;                       // input channels per chunk: 128-byte rows
constexpr int kHR = 2 * kTR + 2;              // halo rows, from row 2*tr0 - 1
constexpr int kHW = 24;                       // halo cols, from col 2*tc0 - 4 (cols 2..21 used)
constexpr int kHaloPlane = kHR * kHW;         // elements per channel
constexpr int kHaloBytes = kKC * kHaloPlane * 2;
constexpr int kVBytes = kTiles * kKC * 2;     // one transform position's A tile
constexpr int kUBytes = kNB * kKC * 2;        // one transform position's B tile
constexpr int kUHalf = kUBytes / 2;           // a consumer warpgroup's 64 rows of it
constexpr int kUSlots = 3;                    // U ring slots per consumer warpgroup
constexpr int kThreads = 384;                 // 2 consumer warpgroups, 1 transform warpgroup
// setmaxnreg: the 384 x 168 registers of the launch, redistributed (the
// consumers hold 4 x 32 accumulators; the transform unrolls 4 items)
constexpr int kConsumerRegs = 208, kTransformRegs = 88;

constexpr int kOffV = 2 * kHaloBytes;                  // 2 halo stages
constexpr int kOffU = kOffV + 8 * kVBytes;             // 2 sets of 4 V slots
constexpr int kOffBar = kOffU + 2 * kUSlots * kUHalf;
// mbarriers: halo full [2], V set full/empty [2], U full/empty [2 warpgroups][kUSlots]
enum { kHF = 0, kVF = 2, kVE = 4, kUF = 6, kUE = 6 + 2 * kUSlots, kNumBars = 6 + 4 * kUSlots };
constexpr int kSmem = kOffBar + 8 * kNumBars + 1024;   // + alignment slack
static_assert(kOffV % 1024 == 0 && kOffU % 1024 == 0, "swizzled tiles need 1 KB alignment");
static_assert(kSmem <= 232448, "shared memory");


__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits for the phase of `parity` to complete. The transform's waits are
// bounded: one that never ends (a pipeline fault) traps, so the launch fails
// instead of hanging the card. The consumers' waits are not (a trap path
// there costs the accumulators registers): a stuck consumer stops releasing
// V, so the transform's bounded wait traps for it.
template <bool kBounded>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0; !mbar_try(bar, parity); ++tries) {
    if (kBounded && tries > (1u << 24)) __trap();
  }
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
// 64-bit wgmma descriptor of a K-major tile with 128-byte rows, 128-byte
// swizzle, 8-row groups 1 KB apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += sign * A[64 x 16] . B[16 x 64]^T, both K-major in shared memory
// (imm-scale-a = sign).
template <int kSign>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  static_assert(kSign == 1 || kSign == -1, "wgmma scales by +1 or -1");
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, %34, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "n"(kSign));
}

__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One channel's contribution to transform row u (compile time) of a tile:
// the two halo rows B^T combines for u, each first transformed along its
// columns (the plain version's order, so V is bit-identical to it). `row`
// points at the tile's first halo row, 4-byte aligned, image column
// 2*(tc0 + tc) - 2.
template <int U>
__device__ __forceinline__ void vrow(const uint32_t* row, float (&o)[4]) {
  constexpr int ra = U == 0 ? 0 : (U == 3 ? 1 : 1);   // B^T row u: (r0 - r2, r1 + r2,
  constexpr int rb = U == 0 ? 2 : (U == 3 ? 3 : 2);   //   r2 - r1, r1 - r3)
  constexpr int kw = kHW / 2;                           // words per halo row
  float a[4], b[4];
  {
    const uint32_t w0 = row[ra * kw], w1 = row[ra * kw + 1], w2 = row[ra * kw + 2];
    bt4(hi_f32(w0), lo_f32(w1), hi_f32(w1), lo_f32(w2), a);   // cols 2tc+1 .. 2tc+4
  }
  {
    const uint32_t w0 = row[rb * kw], w1 = row[rb * kw + 1], w2 = row[rb * kw + 2];
    bt4(hi_f32(w0), lo_f32(w1), hi_f32(w1), lo_f32(w2), b);
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    if (U == 0) o[v] = a[v] - b[v];
    else if (U == 1) o[v] = a[v] + b[v];
    else if (U == 2) o[v] = b[v] - a[v];
    else o[v] = a[v] - b[v];
  }
}

// The transform warpgroup's rows u of the 4 x 4 transform for one chunk:
// this lane's 8 x 2 (tile, channel) items of the 64 x 64 block, written as
// bf16 pairs into the 4 V slots (transform positions 4u .. 4u + 3) at vset.
// Lane (tt, q) of warp wt, iteration it: tile row tr = combo >> 3, tile col
// tt, channel pair p = 8 * (combo & 7) / 2 + q holding channels c0 and c0 + 4
// (stored K positions 2p, 2p + 1): so the 32 lanes' halo reads fall on 32
// banks (a channel plane is 216 words) and so do their swizzled stores.
template <int U>
__device__ __forceinline__ void transform_row(const bf16* hb, unsigned char* vset, int wt,
                                              int tt, int q) {
#pragma unroll 4
  for (int it = 0; it < 16; ++it) {
    const int combo = wt * 16 + it, tr = combo >> 3, pj = combo & 7;
    const int c0 = 8 * pj + q, t = tr * 8 + tt;
    const uint32_t* r0 = reinterpret_cast<const uint32_t*>(
        hb + c0 * kHaloPlane + 2 * tr * kHW + 2 * tt + 2);
    float v0[4], v1[4];
    vrow<U>(r0, v0);
    vrow<U>(r0 + 4 * kHaloPlane / 2, v1);
    const int off = t * 128 + ((pj ^ (t & 7)) << 4) + q * 4;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v0[v], v1[v]);   // .x = c0
      *reinterpret_cast<__nv_bfloat162*>(vset + v * kVBytes + off) = pair;
    }
  }
}

// One consumer warpgroup's U ring: slot i % kUSlots holds this warpgroup's
// 64 output channels of U tile i (8 KB). Thread 0 refills a slot as soon as
// the warpgroup's four warps are done with it.
struct URing {
  const bf16* src;     // this block's and warpgroup's first tile: tile i at src + i * stride
  long long stride;    // elements between consecutive tiles
  uint32_t smem;       // slot 0
  uint32_t full, empty;  // barrier addresses of slot 0 (8 bytes apart)
  int total;           // tiles in all
};

__device__ __forceinline__ void u_issue(const URing& r, int i) {
  const int slot = i % kUSlots;
  mbar_expect_tx(r.full + 8 * slot, kUHalf);
  bulk_g2s(r.smem + slot * kUHalf, r.src + i * r.stride, kUHalf, r.full + 8 * slot);
}

// Pins d's registers at this point of the program: nothing reads or writes
// them across it, so no access moves into a wgmma's flight.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc[2r + s] += A^T[r][u] A^T[s][v] * V_uv . U_uv over the chunk's 64
// channels, for the output phases (r, s) whose sign is not 0.
template <int U, int V, int PH>
__device__ __forceinline__ void phase_mma(float (&acc)[4][32], uint64_t da, uint64_t db) {
  constexpr float sign = at(PH >> 1, U) * at(PH & 1, V);
  if constexpr (sign != 0.f) {
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk)
      wgmma_m64n64k16<(sign < 0.f ? -1 : 1)>(acc[PH], da + 2 * kk, db + 2 * kk);
  }
}

// Consumer state between transform positions.
struct Pipe {
  int i = 0;        // transform positions issued so far (U tile index)
  int gcount = 0;   // V sets (rows u) started so far
};

// Transform position (U, V) of the current V set: wait for its U tile,
// issue its signed products as one wgmma group, then retire the previous
// position's group (wait_group 1) and hand its U slot back for refilling,
// and, at a row's first position, the previous row's V set.
template <int U, int V>
__device__ __forceinline__ void consume(float (&acc)[4][32], uint32_t vslot, const URing& r,
                                        Pipe& pp, uint32_t bars, int tid_wg) {
  const int slot = pp.i % kUSlots;
  mbar_wait<false>(r.full + 8 * slot, (pp.i / kUSlots) & 1);
  __syncwarp();   // thread 0 may come from refilling a slot: wgmma needs the warp converged
#ifndef EWVIT_WINOGRAD_ABLATE_MMA
  const uint64_t db = sw128_desc(r.smem + slot * kUHalf);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const uint64_t da = sw128_desc(vslot);
  phase_mma<U, V, 0>(acc, da, db);
  phase_mma<U, V, 1>(acc, da, db);
  phase_mma<U, V, 2>(acc, da, db);
  phase_mma<U, V, 3>(acc, da, db);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#endif
  if (pp.i > 0) {
    const int prev = (pp.i - 1) % kUSlots;
    if ((tid_wg & 31) == 0) mbar_arrive(r.empty + 8 * prev);
    if (tid_wg == 0 && pp.i + 2 < r.total) {
      mbar_wait<false>(r.empty + 8 * prev, ((pp.i - 1) / kUSlots) & 1);   // all four warps are done
      u_issue(r, pp.i + 2);
    }
    if (V == 0 && (tid_wg & 31) == 0) mbar_arrive(bars + 8 * (kVE + ((pp.gcount - 2) & 1)));
  }
  ++pp.i;
}

template <int U>
__device__ __forceinline__ void consume_row(float (&acc)[4][32], uint32_t vset, const URing& r,
                                            Pipe& pp, uint32_t bars, int tid_wg) {
  consume<U, 0>(acc, vset, r, pp, bars, tid_wg);
  consume<U, 1>(acc, vset + kVBytes, r, pp, bars, tid_wg);
  consume<U, 2>(acc, vset + 2 * kVBytes, r, pp, bars, tid_wg);
  consume<U, 3>(acc, vset + 3 * kVBytes, r, pp, bars, tid_wg);
}

__global__ void __launch_bounds__(kThreads, 1)
winograd_kernel(Levels ys, const bf16* __restrict__ u, const float* __restrict__ bias,
                bf16* __restrict__ out, int levels, int cin, int kchunks, int cout, int h,
                int w, int relu, int col_blocks, int vec8) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* sm = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t s0 = smem_u32(sm);
  const uint32_t bars = s0 + kOffBar;       // barrier i at bars + 8 * i

  const int n = blockIdx.z;
  const int tr0 = (blockIdx.x / col_blocks) * kTR, tc0 = (blockIdx.x % col_blocks) * kTC;
  const int cob = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int steps = levels * kchunks;
  const long long plane = (long long)h * w;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bars + 8 * (kHF + i), 128);      // cp.async arrivals of the transform
      mbar_init(bars + 8 * (kVF + i), 128);      // the transform warpgroup
      mbar_init(bars + 8 * (kVE + i), 8);        // one lane per consumer warp
    }
    for (int i = 0; i < 2 * kUSlots; ++i) {
      mbar_init(bars + 8 * (kUF + i), 1);
      mbar_init(bars + 8 * (kUE + i), 4);        // one lane per warp of the warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---------------- transform warpgroup; it also stages the halo
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTransformRegs));
    const int tt = tid - 256, wt = tt >> 5, lane = tid & 31;
    // chunk s's halo [kKC][kHR][kHW] into stage s & 1, row i = image row
    // 2*tr0 - 1 + i, col j = image col 2*tc0 - 4 + j, by cp.async from all
    // 128 threads, one (channel, row) at a time: with vec8 (W % 4 == 0) the
    // 16 interior columns as 8-byte copies and the two edge pairs as 4-byte
    // copies, else ten 4-byte copies (column pairs from an even column);
    // zero-filled outside the map and past cin. Each thread's copies arrive
    // on the stage's mbarrier when they land.
    auto stage_halo = [&](int s) {
      const int stage = s & 1, l = s / kchunks, k0 = (s - l * kchunks) * kKC;
      const uint32_t full = bars + 8 * (kHF + stage), dst0 = s0 + stage * kHaloBytes;
      const bf16* base = static_cast<const bf16*>(ys.p[l]);
      const bf16* x = base + (long long)n * cin * plane;
      const int c2 = 2 * tc0;
      for (int pr = tt; pr < kKC * kHR; pr += 128) {
        const int kc = pr / kHR, i = pr - kc * kHR;
        const int c = k0 + kc, row = 2 * tr0 - 1 + i;
        const bool rok = c < cin && row >= 0 && row < h;
        const bf16* src = rok ? x + c * plane + (long long)row * w : base;
        const uint32_t dst = dst0 + 2 * (kc * kHaloPlane + i * kHW);
        if (vec8) {
          cp_async4(dst + 4, src + (c2 - 2), rok && c2 >= 2);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            cp_async8(dst + 8 + 8 * q, src + c2 + 4 * q, rok && c2 + 4 * q < w);
          cp_async4(dst + 40, src + c2 + 16, rok && c2 + 16 < w);
        } else {
#pragma unroll
          for (int q = 0; q < 10; ++q) {
            const int col = c2 - 2 + 2 * q;
            cp_async4(dst + 4 + 4 * q, src + col, rok && col >= 0 && col < w);
          }
        }
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(full)
                   : "memory");
    };
    stage_halo(0);
    if (steps > 1) stage_halo(1);
    int gcount = 0;
    for (int s = 0; s < steps; ++s) {
      const int stage = s & 1;
      mbar_wait<true>(bars + 8 * (kHF + stage), (s >> 1) & 1);
      const bf16* hb = reinterpret_cast<const bf16*>(sm + stage * kHaloBytes);
#pragma unroll
      for (int uu = 0; uu < 4; ++uu, ++gcount) {
        const int set = gcount & 1;
        mbar_wait<true>(bars + 8 * (kVE + set), ((gcount >> 1) & 1) ^ 1);
        unsigned char* vset = sm + kOffV + set * 4 * kVBytes;
#ifdef EWVIT_WINOGRAD_ABLATE_TRANSFORM
        if (false)
#endif
        if (uu == 0) transform_row<0>(hb, vset, wt, lane & 7, lane >> 3);
        else if (uu == 1) transform_row<1>(hb, vset, wt, lane & 7, lane >> 3);
        else if (uu == 2) transform_row<2>(hb, vset, wt, lane & 7, lane >> 3);
        else transform_row<3>(hb, vset, wt, lane & 7, lane >> 3);
        // generic-proxy stores -> wgmma's async-proxy reads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(bars + 8 * (kVF + set));
      }
      if (s + 2 < steps) {
        // every transform thread is done reading this stage: refill it
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        stage_halo(s + 2);
      }
    }
  } else {
    // ---------------- consumer warpgroups: output channels wg*64 ..
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp >> 2, tid_wg = tid & 127, lane = tid & 31;
    // U tiles [levels * kchunks][16][Cout_pad / 128][128 x 64]; this
    // warpgroup reads rows wg*64 .. of each, 8 KB
    URing ring;
    ring.src = u + (long long)cob * (kUBytes / 2) + wg * (kUHalf / 2);
    ring.stride = (long long)gridDim.y * (kUBytes / 2);
    ring.smem = s0 + kOffU + wg * kUSlots * kUHalf;
    ring.full = bars + 8 * (kUF + wg * kUSlots);
    ring.empty = bars + 8 * (kUE + wg * kUSlots);
    ring.total = steps * 16;
    if (tid_wg == 0)
      for (int i = 0; i < kUSlots && i < ring.total; ++i) u_issue(ring, i);
    float acc[4][32];
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[ph][i] = 0.f;
      fence_regs(acc[ph]);
    }
    Pipe pp;
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int uu = 0; uu < 4; ++uu) {
        const int set = pp.gcount & 1;
        mbar_wait<false>(bars + 8 * (kVF + set), (pp.gcount >> 1) & 1);
        ++pp.gcount;
        const uint32_t vset = s0 + kOffV + set * 4 * kVBytes;
        if (uu == 0) consume_row<0>(acc, vset, ring, pp, bars, tid_wg);
        else if (uu == 1) consume_row<1>(acc, vset, ring, pp, bars, tid_wg);
        else if (uu == 2) consume_row<2>(acc, vset, ring, pp, bars, tid_wg);
        else consume_row<3>(acc, vset, ring, pp, bars, tid_wg);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) fence_regs(acc[ph]);

    // epilogue: register i of the m64n64 accumulator is tile row
    // 16*(warp%4) + lane/4 + 8*((i>>1)&1), channel 8*(i>>2) + 2*(lane%4) + (i&1)
    const int h2 = h >> 1, w2 = w >> 1;
    const int wr = warp & 3;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int t = 16 * wr + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int co = cob * kNB + wg * kNW + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int tr = tr0 + (t >> 3), tc = tc0 + (t & 7);
      if (tr >= h2 || tc >= w2 || co >= cout) continue;
      const float b = bias != nullptr ? bias[co] : 0.f;
      bf16* o = out + ((long long)n * cout + co) * plane + (long long)(2 * tr) * w + 2 * tc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float y0 = acc[2 * r][i] + b, y1 = acc[2 * r + 1][i] + b;
        if (relu) { y0 = fmaxf(y0, 0.f); y1 = fmaxf(y1, 0.f); }
        *reinterpret_cast<__nv_bfloat162*>(o + r * w) = __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

// 1 where the halo's interior columns can move as 8-byte copies: W % 4 == 0
// and every map 8-byte aligned.
int halo_vec8(const Levels& ys, int levels, int w) {
  int ok = (w % 4) == 0;
  for (int l = 0; l < levels; ++l) ok &= (reinterpret_cast<uintptr_t>(ys.p[l]) & 7) == 0;
  return ok;
}

int launch(const Levels& ys, const bf16* u, const float* bias, bf16* out, int n, int levels,
           int cin, int cout, int h, int w, int relu, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        winograd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    // setmaxnreg redistributes the registers allocated at launch: refuse to
    // launch (rather than wait forever) if the build gave the kernel fewer
    cudaFuncAttributes a;
    const cudaError_t e2 = cudaFuncGetAttributes(&a, winograd_kernel);
    if (e2 != cudaSuccess) return (int)e2;
    if (a.numRegs * kThreads < 128 * (2 * kConsumerRegs + kTransformRegs))
      return (int)cudaErrorInvalidConfiguration;
    attr_set = true;
  }
  if (reinterpret_cast<uintptr_t>(u) & 15) return (int)cudaErrorMisalignedAddress;
  const int h2 = h / 2, w2 = w / 2;
  const int col_blocks = (w2 + kTC - 1) / kTC, row_blocks = (h2 + kTR - 1) / kTR;
  const int kchunks = (cin + kKC - 1) / kKC, coblocks = (cout + kNB - 1) / kNB;
  const dim3 grid(row_blocks * col_blocks, coblocks, n);
  winograd_kernel<<<grid, kThreads, kSmem, s>>>(ys, u, bias, out, levels, cin, kchunks, cout,
                                                h, w, relu, col_blocks,
                                                halo_vec8(ys, levels, w));
  return (int)cudaGetLastError();
}

}  // namespace hop

int run(const Levels& ys, const void* u, const float* bias, void* out, int n, int levels,
        int cin, int cout, int h, int w, int relu, int dtype, void* stream) {
  if (n <= 0 || cin <= 0 || cout <= 0 || h <= 0 || w <= 0 || (h & 1) || (w & 1) ||
      levels < 1 || levels > kMaxLevels || n > 65535)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l)
    if (reinterpret_cast<uintptr_t>(ys.p[l]) & 3) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ewvit::kBF16)
    return hop::launch(ys, static_cast<const __nv_bfloat16*>(u), bias,
                       static_cast<__nv_bfloat16*>(out), n, levels, cin, cout, h, w, relu, s);
  if (dtype == ewvit::kF32)
    return f32::launch(ys, static_cast<const float*>(u), bias, static_cast<float*>(out), n,
                       levels, cin, cout, h, w, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3: out = relu(sum_l conv3x3(ys[l], U_l) + bias). ys: `levels` pointers to
// [N, C, H, W]; u: pack_u's layout for the dtype (BN scale folded in); bias:
// [C] fp32; out: [N, C, H, W].
extern "C" int ewvit_fused_multiscale_winograd(const void* const* ys, const void* u,
                                               const void* bias, void* out, int n,
                                               int levels, int c, int h, int w,
                                               int dtype, void* stream) {
  if (levels < 1 || levels > kMaxLevels || ys == nullptr || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  for (int l = 0; l < levels; ++l) lv.p[l] = ys[l];
  return run(lv, u, static_cast<const float*>(bias), out, n, levels, c, c, h, w, 1, dtype,
             stream);
}

// K5: out = conv3x3(x, U), no bias. x: [N, Cin, H, W]; u: pack_u's layout
// for the dtype, one level; out: [N, Cout, H, W].
extern "C" int ewvit_conv3x3_winograd(const void* x, const void* u, void* out, int n,
                                      int cin, int cout, int h, int w, int dtype,
                                      void* stream) {
  Levels lv{};
  lv.p[0] = x;
  return run(lv, u, nullptr, out, n, 1, cin, cout, h, w, 0, dtype, stream);
}

// Bytes per copy of the bf16 kernel's halo interior for this map: 8 (W % 4
// == 0, 8-byte aligned) or 4 (the kernel decides the same way per call).
extern "C" int ewvit_winograd_halo_copy_bytes(const void* x, int w) {
  Levels lv{};
  lv.p[0] = x;
  return hop::halo_vec8(lv, 1, w) ? 8 : 4;
}
