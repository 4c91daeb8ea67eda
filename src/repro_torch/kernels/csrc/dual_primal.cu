// Fused primal step for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/dual_primal.py::dual_primal_kernel_body
// (its tile fused_primal_tile).  For one bucket slab it computes
//
//   x [n, L] = Pi_simplex( -(sum_k coeff_k * lam[k, idx] + cost) * (1/gamma) )
//
// and nothing else: no A x histogram and no partials, so unlike the one-pass
// oracle (dual_oracle.cu) its blocks share nothing and write only x.  fp32,
// bf16 and int8 slabs are widened on load (int8 times its per-bucket scales);
// all arithmetic is fp32 and x is written at the storage width (fp32 for
// int8).  The primal candidate and the projection are the __device__
// functions of primal_common.cuh that the oracle calls, so on the same
// inputs this kernel's x is bitwise the oracle's.
//
// What bounds it: HBM bytes.  Each slab slot reads 4 B of idx and m + 2
// slab words and writes x: 20 B at fp32 and m = 1, for a few dozen fp32
// operations.  What the design does about it:
//   * the slab is read once and x written once; a row of L <= 32 is a
//     segment of one warp (shuffle sort and scan in registers), a wider row
//     (64 <= L <= 8192) sorts and scans in the warp's two shared-memory rows;
//   * lam [m, J] is staged in shared memory when it fits beside the rows,
//     else read through L1/L2;
//   * a persistent grid walks the slab, each warp issuing the loads of
//     kUnroll 32-slot groups before computing them, so lam is staged once
//     per block, not once per tile.

#include "primal_common.cuh"

namespace {

constexpr int kMaxWarps = 8;  // dual_primal.py MAX_WARPS
constexpr int kUnroll = 4;    // dual_primal.py UNROLL

struct Params {
  const int32_t* idx;        // [n, L]
  const void* coeff;         // [m, n, L] storage dtype
  const void* cost;          // [n, L] storage dtype
  const void* mask;          // [n, L] storage dtype
  const float* lam;          // [m, J]
  const float* coeff_scale;  // [m] (int8 only, else null)
  const float* cost_scale;   // [1] (int8 only, else null)
  void* x;                   // [n, L] storage dtype (fp32 for int8)
  long long n;
  int L, m, J;
  float ginv, radius;  // 1/gamma rounded to fp32
  int inequality, lam_in_smem;
  int scan_chunk;      // wide rows: chunk of the cumsum order, <= L
};

// Stages lam at the start of shared memory when the plan says so; returns
// where the kernel reads lam.
__device__ __forceinline__ const float* lam_view(const Params& p, float* smem) {
  if (!p.lam_in_smem) return p.lam;
  stage_lam(p.lam, p.m * p.J, smem);
  __syncthreads();
  return smem;
}

// Rows of width L = 2^LOGL <= 32: a warp step covers 32 consecutive slots,
// i.e. 32 / L whole rows, one per segment of L lanes.
template <typename T, int LOGL>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
dual_primal_narrow(Params p) {
  using TO = typename OutType<T>::type;
  constexpr int L = 1 << LOGL;
  extern __shared__ __align__(16) float smem[];
  const float* lam = lam_view(p, smem);
  float scale[kMaxFamilies], cost_scale;
  load_scales(p, scale, cost_scale);

  const int lane = threadIdx.x & 31;
  const int pos = lane & (L - 1);
  const long long slots = p.n * L;
  const long long groups = (slots + 31) >> 5;
  const long long warp0 = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long g0 = warp0 * kUnroll; g0 < groups; g0 += stride * kUnroll) {
    Slot slot[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = (g0 + u) * 32 + lane;
      valid[u] = s < slots;
      load_slot<T>(p, scale, cost_scale, s, slots, valid[u], slot[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float v = primal_candidate(slot[u], lam, p.m, p.J, p.ginv);
      const float x = simplex_segment<LOGL>(v, slot[u].mask, pos, p.radius, p.inequality != 0);
      if (valid[u]) store(static_cast<TO*>(p.x) + (g0 + u) * 32 + lane, x);
    }
  }
}

// Rows of width 64 <= L <= 8192: one warp per row, the row's candidates
// sorted and scanned in the warp's two shared-memory rows, then computed
// again for x.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
dual_primal_wide(Params p) {
  using TO = typename OutType<T>::type;
  extern __shared__ __align__(16) float smem[];
  const float* lam = lam_view(p, smem);
  float scale[kMaxFamilies], cost_scale;
  load_scales(p, scale, cost_scale);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int L = p.L;
  float* A = smem + (p.lam_in_smem ? p.m * p.J : 0) + 2 * warp * L;  // the sorted row
  float* C = A + L;                                                  // its scan
  const long long slots = p.n * L;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  for (long long row = static_cast<long long>(blockIdx.x) * warps + warp; row < p.n;
       row += stride) {
    const long long base = row * L;
    auto candidate = [&](int q, float& v, float& maskf) {
      Slot s;
      load_slot<T>(p, scale, cost_scale, base + q, slots, true, s);
      v = primal_candidate(s, lam, p.m, p.J, p.ginv);
      maskf = s.mask;
    };
    const RowCut cut = simplex_wide_cut(candidate, A, C, L, p.scan_chunk, p.radius,
                                        p.inequality != 0);
    for (int q = lane; q < L; q += 32) {
      float v, maskf;
      candidate(q, v, maskf);
      store(static_cast<TO*>(p.x) + base + q, simplex_wide_apply(v, maskf, cut));
    }
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int grid, int warps, size_t smem, cudaStream_t st) {
  switch (p.L) {
    case 1: return launch_kernel(dual_primal_narrow<T, 0>, p, grid, warps, smem, st);
    case 2: return launch_kernel(dual_primal_narrow<T, 1>, p, grid, warps, smem, st);
    case 4: return launch_kernel(dual_primal_narrow<T, 2>, p, grid, warps, smem, st);
    case 8: return launch_kernel(dual_primal_narrow<T, 3>, p, grid, warps, smem, st);
    case 16: return launch_kernel(dual_primal_narrow<T, 4>, p, grid, warps, smem, st);
    case 32: return launch_kernel(dual_primal_narrow<T, 5>, p, grid, warps, smem, st);
    default: return launch_kernel(dual_primal_wide<T>, p, grid, warps, smem, st);
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
// dtype: 0 fp32, 1 bf16, 2 int8 (which requires both scale pointers).
extern "C" int dual_primal_launch(const void* idx, const void* coeff, const void* cost,
                                  const void* mask, const void* lam,
                                  const void* coeff_scale, const void* cost_scale,
                                  void* x, long long n, int L, int m, int J, float ginv,
                                  float radius, int inequality, int dtype, int grid,
                                  int warps, int lam_in_smem, int scan_chunk,
                                  void* stream) {
  const bool pow2 = L >= 1 && (L & (L - 1)) == 0;
  if (!pow2 || L > 8192 || m < 1 || m > kMaxFamilies || J < 1 || n < 0 || grid < 1 ||
      warps < 1 || warps > kMaxWarps || dtype < 0 || dtype > 2 ||
      (dtype == 2) != (coeff_scale != nullptr && cost_scale != nullptr) ||
      (L > 32 && (scan_chunk < 32 || scan_chunk > L || (scan_chunk & (scan_chunk - 1))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // lam (when staged), and for wide rows two scratch rows per warp
  const long long floats = (lam_in_smem ? static_cast<long long>(m) * J : 0) +
                           (L > 32 ? 2LL * warps * L : 0);
  if (floats * 4 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.idx = static_cast<const int32_t*>(idx);
  p.coeff = coeff;
  p.cost = cost;
  p.mask = mask;
  p.lam = static_cast<const float*>(lam);
  p.coeff_scale = static_cast<const float*>(coeff_scale);
  p.cost_scale = static_cast<const float*>(cost_scale);
  p.x = x;
  p.n = n;
  p.L = L;
  p.m = m;
  p.J = J;
  p.ginv = ginv;
  p.radius = radius;
  p.inequality = inequality;
  p.lam_in_smem = lam_in_smem;
  p.scan_chunk = scan_chunk;
  const size_t smem = static_cast<size_t>(floats) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(dispatch<float>(p, grid, warps, smem, st));
    case 1: return static_cast<int>(dispatch<__nv_bfloat16>(p, grid, warps, smem, st));
    default: return static_cast<int>(dispatch<int8_t>(p, grid, warps, smem, st));
  }
}
