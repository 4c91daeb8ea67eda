// Fused masked simplex projection for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/simplex_proj.py::simplex_kernel_body
// (with its lane-roll bitonic_sort_desc and Hillis-Steele inclusive_scan).
// Each row of v [n, L] is projected onto {w >= 0, sum(w) <= radius}
// (inequality; rows whose clamp already fits, sum(max(v, 0) * mask) <=
// radius, take the clamp only) or onto {w >= 0, sum(w) == radius}.  Slots
// with mask 0 enter as kNeg and come out exactly 0.  fp32 and bf16 rows are
// widened on load, projected in fp32, and written in v's dtype.
//
// The projection is the one the two other kernels run (primal_common.cuh),
// here on an arbitrary v instead of the primal candidate: a row of L <= 32
// is a segment of one warp (shuffle sort and scan), a wider row (64 <= L <=
// 8192) sorts and scans in the warp's two shared-memory rows in the order
// of PyTorch's CUDA cumsum.
//
// What bounds it: HBM bytes.  Each slot reads v and mask and writes out:
// 12 B at fp32, 6 B at bf16, against a few dozen fp32 operations.  The row
// is read once for rows of L <= 32 (twice, the second time mostly from L2,
// for wider rows) and written once; a persistent grid of warps walks the
// slab, each issuing the loads of kUnroll 32-slot groups before computing.

#include "primal_common.cuh"

namespace {

constexpr int kMaxWarps = 8;  // simplex_proj.py MAX_WARPS
constexpr int kUnroll = 4;    // simplex_proj.py UNROLL

struct Params {
  const void* v;     // [n, L]
  const void* mask;  // [n, L], v's dtype
  void* out;         // [n, L], v's dtype
  long long n;
  int L;
  float radius;
  int inequality;
  int scan_chunk;    // wide rows: chunk of the cumsum order, <= L
};

// Rows of width L = 2^LOGL <= 32: a warp step covers 32 consecutive slots,
// i.e. 32 / L whole rows, one per segment of L lanes.
template <typename T, int LOGL>
__global__ void __launch_bounds__(kMaxWarps * 32)
simplex_narrow(Params p) {
  constexpr int L = 1 << LOGL;
  const T* v = static_cast<const T*>(p.v);
  const T* mask = static_cast<const T*>(p.mask);
  const int lane = threadIdx.x & 31;
  const int pos = lane & (L - 1);
  const long long slots = p.n * L;
  const long long groups = (slots + 31) >> 5;
  const long long warp0 = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long g0 = warp0 * kUnroll; g0 < groups; g0 += stride * kUnroll) {
    float vv[kUnroll], mk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = (g0 + u) * 32 + lane;
      const bool valid = s < slots;
      vv[u] = valid ? widen(v[s]) : 0.f;
      mk[u] = valid ? widen(mask[s]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float w = simplex_segment<LOGL>(vv[u], mk[u], pos, p.radius, p.inequality != 0);
      const long long s = (g0 + u) * 32 + lane;
      if (s < slots) store(static_cast<T*>(p.out) + s, w);
    }
  }
}

// Rows of width 64 <= L <= 8192: one warp per row, sorted and scanned in
// the warp's two shared-memory rows, then read again for the output.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
simplex_wide(Params p) {
  extern __shared__ __align__(16) float smem[];
  const T* v = static_cast<const T*>(p.v);
  const T* mask = static_cast<const T*>(p.mask);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int L = p.L;
  float* A = smem + 2 * warp * L;  // the sorted row
  float* C = A + L;                // its inclusive scan
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  for (long long row = static_cast<long long>(blockIdx.x) * warps + warp; row < p.n;
       row += stride) {
    const long long base = row * L;
    auto slot = [&](int q, float& vq, float& maskf) {
      vq = widen(v[base + q]);
      maskf = widen(mask[base + q]);
    };
    const RowCut cut = simplex_wide_cut(slot, A, C, L, p.scan_chunk, p.radius,
                                        p.inequality != 0);
    for (int q = lane; q < L; q += 32) {
      float vq, maskf;
      slot(q, vq, maskf);
      store(static_cast<T*>(p.out) + base + q, simplex_wide_apply(vq, maskf, cut));
    }
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int grid, int warps, size_t smem, cudaStream_t st) {
  switch (p.L) {
    case 1: return launch_kernel(simplex_narrow<T, 0>, p, grid, warps, smem, st);
    case 2: return launch_kernel(simplex_narrow<T, 1>, p, grid, warps, smem, st);
    case 4: return launch_kernel(simplex_narrow<T, 2>, p, grid, warps, smem, st);
    case 8: return launch_kernel(simplex_narrow<T, 3>, p, grid, warps, smem, st);
    case 16: return launch_kernel(simplex_narrow<T, 4>, p, grid, warps, smem, st);
    case 32: return launch_kernel(simplex_narrow<T, 5>, p, grid, warps, smem, st);
    default: return launch_kernel(simplex_wide<T>, p, grid, warps, smem, st);
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
// dtype: 0 fp32, 1 bf16.
extern "C" int simplex_proj_launch(const void* v, const void* mask, void* out, long long n,
                                   int L, float radius, int inequality, int dtype, int grid,
                                   int warps, int scan_chunk, void* stream) {
  const bool pow2 = L >= 1 && (L & (L - 1)) == 0;
  if (!pow2 || L > 8192 || n < 0 || grid < 1 || warps < 1 || warps > kMaxWarps ||
      dtype < 0 || dtype > 1 ||
      (L > 32 && (scan_chunk < 32 || scan_chunk > L || (scan_chunk & (scan_chunk - 1))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long floats = L > 32 ? 2LL * warps * L : 0;  // two rows per warp
  if (floats * 4 > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.v = v;
  p.mask = mask;
  p.out = out;
  p.n = n;
  p.L = L;
  p.radius = radius;
  p.inequality = inequality;
  p.scan_chunk = scan_chunk;
  const size_t smem = static_cast<size_t>(floats) * 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? dispatch<float>(p, grid, warps, smem, st)
                                     : dispatch<__nv_bfloat16>(p, grid, warps, smem, st));
}
