"""Where K4's cluster kernel spends its time, phase by phase, on the GPU.

    python3 -m ewvit_tpu_torch.xattn_phases

Builds a copy of ``csrc/fused_attention.cu`` in which thread 0 of every CTA
records ``clock64()`` after each phase of the cluster kernel (and the
global timer at entry and exit), into ``_build/`` under its own name. Runs
the bf16 kernel at the served shape (64 rows, D = 128, 4 heads, depth 2,
seeded weights) and prints, over the chunk's CTAs:

- the median cycles of each phase of each attention block (the weight
  run's wait, LayerNorm, the wait for the context's slices, the q/k/v
  projections, the dot exchange, the gate, the attention exchange, the out
  projection and its push), and of the start (token loads);
- a CTA's life from the global timer, and one launch's device time from
  CUDA events over back-to-back launches (the difference is launch cost);
- an empty kernel with the same cluster launch, with 0 and with 12
  ``cluster.sync()``: the launch's floor and what 12 cluster barriers cost.

The stamps cost a few cycles each. Needs a CUDA GPU and nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.fused_attention import CLUSTER_ROWS, pack_xattn

PHASES = ("wait W", "LayerNorm", "wait ctx", "projection", "dots", "gate",
          "attention", "out proj")

# (anchor in the kernel source, code inserted before it); thread 0 stamps
_STAMPS = (
    ("  // this CTA's columns lie in one head", "  STAMP(1);\n"),
    ("    if (blk == 0 && tid == 0)\n", "    const int sb = 2 + blk * 10;\n    STAMP(sb);\n"),
    ("    if (blk > 0) {                                 // the context",
     "    STAMP(sb + 1);\n"),
    ("    if (tid == 0 && blk > 0 && blk - 1 + kSlots < nblk)", "    STAMP(sb + 2);\n"),
    ("    if (blk == 0) asm volatile(\"barrier.cluster.wait", "    STAMP(sb + 3);\n"),
    ("    if (tid < kR) {                                // rank order", "    STAMP(sb + 4);\n"),
    ("    {                                              // the gated slice",
     "    STAMP(sb + 5);\n"),
    ("    {  // out projection of this CTA", "    STAMP(sb + 6);\n"),
    ("  }\n\n  __syncthreads();\n  if (row0 + tr < n)", "    STAMP(sb + 7);\n"),
    ("  cluster.sync();      // no CTA leaves", "  STAMP(46);\n  GTIME(1);\n"),
)

_HEADER = """__device__ long long g_clk[512][48];
__device__ unsigned long long g_gt[512][2];
#define STAMP(i) do { if (threadIdx.x == 0) g_clk[blockIdx.x][i] = clock64(); } while (0)
#define GTIME(i) do { if (threadIdx.x == 0) { unsigned long long t; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); g_gt[blockIdx.x][i] = t; } } while (0)
template <int NS>
__global__ void empty_kernel(int never) {
  extern __shared__ __align__(128) float e_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < NS; ++i) cluster.sync();
  if (never == 12345) e_smem[threadIdx.x] = 1.f;
}
"""

_FOOTER = """
extern "C" int phases_read(void* clk, void* gt) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, cl::g_clk, sizeof(cl::g_clk));
  return e ? (int)e : (int)cudaMemcpyFromSymbol(gt, cl::g_gt, sizeof(cl::g_gt));
}
extern "C" int phases_empty(int nsync, int n, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cl::launch_config(cfg, attr, n, (cudaStream_t)stream);
  cudaError_t e = cudaFuncSetAttribute(cl::empty_kernel<0>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, cl::kBytes);
  if (!e) e = cudaFuncSetAttribute(cl::empty_kernel<12>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, cl::kBytes);
  if (!e) e = nsync ? cudaLaunchKernelEx(&cfg, cl::empty_kernel<12>, 0)
                    : cudaLaunchKernelEx(&cfg, cl::empty_kernel<0>, 0);
  return e ? (int)e : (int)cudaGetLastError();
}
"""


def instrumented_source() -> str:
    """The kernel source with the stamps in (raises if an anchor moved)."""
    with open(os.path.join(extension.CSRC_DIR, "fused_attention.cu")) as f:
        src = f.read()
    for anchor, code in (("namespace cg = cooperative_groups;\n", None),
                         ("  const uint32_t bar_dots", "  GTIME(0);\n  STAMP(0);\n"),
                         *_STAMPS):
        if anchor not in src:
            raise RuntimeError(f"phase anchor not found in fused_attention.cu: {anchor!r}")
        # the header goes right after the cluster namespace declares cg
        src = src.replace(anchor, anchor + _HEADER if code is None else code + anchor, 1)
    return src + _FOOTER


def build() -> ctypes.CDLL:
    src = instrumented_source()
    tag = hashlib.sha256((src + " ".join(extension.NVCC_FLAGS)).encode()).hexdigest()[:16]
    os.makedirs(extension.BUILD_DIR, exist_ok=True)
    cu = os.path.join(extension.BUILD_DIR, f"xattn_phases-{tag}.cu")
    lib = cu[:-3] + ".so"
    if not os.path.exists(lib):
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([extension.find_nvcc(), *extension.NVCC_FLAGS, "-I",
                        extension.CSRC_DIR, "-o", lib, cu], check=True,
                       capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.ewvit_fused_bidir_xattn_cluster.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    so.phases_read.argtypes = [vp, vp]
    so.phases_empty.argtypes = [ci, ci, vp]
    return so


def _event_ms(fn, iters=50):
    """Device ms per call: the stream is held (a spin of ~0.1 s) while the
    calls are queued, so the host's launch cost does not show."""
    for _ in range(5):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("xattn_phases needs a CUDA GPU")
    lib = build()
    n, d, heads, depth = 64, 128, 4, 2
    g = torch.Generator(device="cuda").manual_seed(0)
    mats = torch.randn(2 * depth, d, 4 * d, device="cuda", generator=g) / d ** 0.5
    smalls = torch.stack([1 + 0.1 * torch.randn(2 * depth, d, device="cuda", generator=g),
                          0.1 * torch.randn(2 * depth, d, device="cuda", generator=g),
                          0.1 * torch.randn(2 * depth, d, device="cuda", generator=g)], 1)
    packed = pack_xattn(mats, smalls)
    s, f = (torch.randn(n, d, device="cuda", generator=g).bfloat16() for _ in range(2))
    so, fo = torch.empty_like(s), torch.empty_like(f)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def kernel():
        rc = lib.ewvit_fused_bidir_xattn_cluster(s.data_ptr(), f.data_ptr(), packed.data_ptr(),
                                                  so.data_ptr(), fo.data_ptr(), n, depth,
                                                  heads, 1, stream())
        if rc:
            raise RuntimeError(f"cluster kernel: cudaError_t {rc}")

    launch_ms = _event_ms(kernel)
    clk = np.zeros((512, 48), np.int64)
    gt = np.zeros((512, 2), np.uint64)
    if lib.phases_read(clk.ctypes.data, gt.ctypes.data):
        raise RuntimeError("reading the stamps failed")
    ctas = -(-n // CLUSTER_ROWS) * 8
    c, life = clk[:ctas].astype(np.float64), gt[:ctas].astype(np.float64)
    print(f"[phases] {torch.cuda.get_device_name(0)}; cycles, median over {ctas} CTAs")
    print(f"[phases] start (tokens): {np.median(c[:, 1] - c[:, 0]):.0f}")
    prev = 1
    for blk in range(2 * depth):
        row = []
        for p, name in enumerate(PHASES):
            i = 2 + blk * 10 + p
            row.append(f"{name} {np.median(c[:, i] - c[:, prev]):.0f}")
            prev = i
        print(f"[phases] block {blk}: " + ", ".join(row))
    print(f"[phases] end: {np.median(c[:, 46] - c[:, prev]):.0f}; entry to end "
          f"{np.median(c[:, 46] - c[:, 0]):.0f} cycles; CTA life {np.median(life[:, 1] - life[:, 0]):.0f} ns")
    print(f"[phases] one launch (events, back to back): {launch_ms * 1e3:.1f} us")
    for nsync in (0, 12):
        ms = _event_ms(lambda: lib.phases_empty(nsync, n, stream()))
        print(f"[phases] empty cluster launch with {nsync} cluster.sync: {ms * 1e3:.1f} us")


if __name__ == "__main__":
    main()
