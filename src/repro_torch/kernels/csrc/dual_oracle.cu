// One-pass fused dual oracle for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/dual_oracle.py::dual_oracle_kernel_body
// (with its helpers dual_primal.py::fused_primal_tile and the bitonic
// sort / scan of simplex_proj.py).  For one bucket slab it computes
//
//   x    [n, L] = Pi_simplex( -(sum_k coeff_k * lam[k, idx] + cost) * (1/gamma) )
//   hist [grid, m, J]  per-block partials of A x, binned by idx
//   scal [grid, 2]     per-block partials of (c'x, ||x||^2)
//
// from ONE read of the slab.  All arithmetic is fp32: fp32, bf16 and int8
// slabs are widened on load (int8 times its per-bucket scales); x is written
// at the storage width (fp32 for int8); hist / c'x / ||x||^2 reduce the fp32
// x before any cast.  The caller tree-sums the partials over the grid axis.
//
// What bounds it: HBM bytes.  Each slab slot costs oracle_slab_slot_bytes
// (kernels/ops.py): 4 B idx + (m + 2) slab words + the x write, 20 B at fp32
// and m = 1, for a few dozen fp32 operations, far below the card's
// operations-per-byte balance.  What the design does about it:
//   * the slab is read exactly once and x written once; the projection's
//     intermediates live in registers (rows of L <= 32 lanes: a segment of
//     one warp, sorted by __shfl_xor_sync, scanned by __shfl_up_sync) or in a
//     per-warp shared-memory row (64 <= L <= 8192, the slow-but-right path);
//   * lam [m, J] is staged in shared memory when it fits (else read through
//     L1/L2), and the A x histogram is accumulated in shared memory, so the
//     only other HBM traffic is one [m, J] partial per block;
//   * a persistent grid of a fixed number of blocks walks the rows; each
//     warp issues the loads of kUnroll 32-slot groups before computing them.
//
// Determinism (the reference gives every partial a fixed slot): every bin of
// a block's histogram has exactly one writer warp and a fixed order of
// additions.  Narrow rows (the main path) share one block histogram: after
// each tile the warps stage their nonzero contributions and warp w adds
// those of destinations j = w (mod warps) in staging order.  Wide rows give
// every warp a private histogram, summed in warp order at the end.  Lanes of
// one step that hit the same bin are grouped with __match_any_sync and
// summed in ascending lane order by the group's lowest lane, and c'x /
// ||x||^2 reduce in a fixed shuffle tree.  No float atomics anywhere: the
// same inputs on the same card give bitwise the same outputs.  Mask-zero
// (padded) slots produce x == 0 exactly and add nothing.
//
// The primal step and the projection are the __device__ functions of
// primal_common.cuh, shared with the standalone primal kernel
// (dual_primal.cu) and simplex kernel (simplex_proj.cu).

#include "primal_common.cuh"

namespace {

constexpr int kMaxWarps = 8;      // dual_oracle.py MAX_WARPS
constexpr int kUnroll = 4;        // dual_oracle.py UNROLL

struct Params {
  const int32_t* idx;        // [n, L]
  const void* coeff;         // [m, n, L] storage dtype
  const void* cost;          // [n, L] storage dtype
  const void* mask;          // [n, L] storage dtype
  const float* lam;          // [m, J]
  const float* coeff_scale;  // [m] (int8 only, else null)
  const float* cost_scale;   // [1] (int8 only, else null)
  void* x;                   // [n, L] storage dtype (fp32 for int8)
  float* hist;               // [grid, m, J]
  float* scal;               // [grid, 2]
  long long n;
  int L, m, J;
  float ginv, radius;  // 1/gamma rounded to fp32
  int inequality, lam_in_smem;
  int scan_chunk;      // wide rows: chunk of the cumsum order, <= L
};

// Deterministic add of one warp step into a histogram that only this warp
// writes (its private one, or the bins it owns in the block's).  Lanes with
// `active` add c[k] into bin k*J + key; lanes of the step that share a bin
// are summed in ascending lane order by the lowest one, so the order of
// every bin's additions is fixed.  All 32 lanes must call it.
__device__ __forceinline__ void hist_add(float* h, bool active, int key,
                                         const float (&c)[kMaxFamilies], int m, int J) {
  if (__ballot_sync(kFull, active) == 0) return;
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, active ? key : -1 - lane);
  const bool collide = __any_sync(kFull, active && __popc(peers) > 1);
  const bool leader = active && (__ffs(peers) - 1 == lane);
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k) {
    if (k >= m) break;
    float v = active ? c[k] : 0.f;
    if (collide) {
      float acc = 0.f;
      for (int i = 0; i < 32; ++i) {
        const float vi = __shfl_sync(kFull, v, i);
        if ((peers >> i) & 1u) acc += vi;
      }
      v = acc;
    }
    if (leader) h[k * J + key] += v;
  }
  __syncwarp();
}

struct Smem {
  const float* lam;  // shared copy or the global vector
  float* hist;       // [copies][m*J]
  float* red;        // [2 * kMaxWarps]
  float* tail;       // narrow: the staging area; wide: [warps][2][L] scratch
};

__device__ __forceinline__ Smem prologue(const Params& p, float* smem, int copies) {
  const int mJ = p.m * p.J;
  Smem s;
  float* base = smem;
  if (p.lam_in_smem) {
    stage_lam(p.lam, mJ, base);
    s.lam = base;
    base += mJ;
  } else {
    s.lam = p.lam;
  }
  s.hist = base;
  for (int e = threadIdx.x; e < copies * mJ; e += blockDim.x) s.hist[e] = 0.f;
  s.red = s.hist + copies * mJ;
  s.tail = s.red + 2 * kMaxWarps;
  __syncthreads();
  return s;
}

// Writes this block's partials: the sum of its `copies` histograms (in copy
// order) and its (c'x, ||x||^2) reduced over the block in a fixed tree.
__device__ __forceinline__ void epilogue(const Params& p, const Smem& s, int copies,
                                         float lin, float sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lin += __shfl_xor_sync(kFull, lin, o);
    sq += __shfl_xor_sync(kFull, sq, o);
  }
  if (lane == 0) {
    s.red[2 * warp] = lin;
    s.red[2 * warp + 1] = sq;
  }
  __syncthreads();
  const int mJ = p.m * p.J;
  float* out = p.hist + static_cast<long long>(blockIdx.x) * mJ;
  for (int e = threadIdx.x; e < mJ; e += blockDim.x) {
    float acc = s.hist[e];
    for (int w = 1; w < copies; ++w) acc += s.hist[w * mJ + e];
    out[e] = acc;
  }
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < warps; ++w) {
      a += s.red[2 * w];
      b += s.red[2 * w + 1];
    }
    p.scal[2 * blockIdx.x] = a;
    p.scal[2 * blockIdx.x + 1] = b;
  }
}

// Rows of width L = 2^LOGL <= 32.  A warp step covers 32 consecutive slots,
// i.e. 32 / L whole rows, one per segment of L lanes; a block of `warps`
// warps (a power of two) takes tiles of warps * kUnroll such steps.  The
// block keeps ONE [m, J] histogram: after each tile every warp stages its
// nonzero contributions (in lane order, compacted), and then warp w adds
// those of the destinations j with j % warps == w, reading the staging area
// in warp order, so every bin has one writer and a fixed order of additions.
template <typename T, int LOGL>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
dual_oracle_narrow(Params p) {
  using TO = typename OutType<T>::type;
  constexpr int L = 1 << LOGL;
  constexpr int kSeg = kUnroll * 32;  // staging entries per warp and tile
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const Smem sm = prologue(p, smem, 1);
  int* skey = reinterpret_cast<int*>(sm.tail);           // [warps][kSeg]
  float* sval = sm.tail + warps * kSeg;                   // [m][warps][kSeg]
  int* scnt = reinterpret_cast<int*>(sval + p.m * warps * kSeg);  // [warps]
  float scale[kMaxFamilies], cost_scale;
  load_scales(p, scale, cost_scale);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pos = lane & (L - 1);
  const long long slots = p.n * L;
  const long long groups = (slots + 31) >> 5;
  const long long tiles = (groups + warps * kUnroll - 1) / (warps * kUnroll);
  float lin = 0.f, sq = 0.f;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long g0 = (tile * warps + warp) * kUnroll;
    Slot slot[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long s = (g0 + u) * 32 + lane;
      valid[u] = s < slots;
      load_slot<T>(p, scale, cost_scale, s, slots, valid[u], slot[u]);
    }
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float v = primal_candidate(slot[u], sm.lam, p.m, p.J, p.ginv);
      x[u] = simplex_segment<LOGL>(v, slot[u].mask, pos, p.radius, p.inequality != 0);
    }
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (valid[u]) {
        store(static_cast<TO*>(p.x) + (g0 + u) * 32 + lane, x[u]);
        lin += slot[u].cost * x[u];
        sq += x[u] * x[u];
      }
      const bool active = valid[u] && x[u] != 0.f;  // zeros add nothing
      const unsigned bal = __ballot_sync(kFull, active);
      if (active) {
        const int at = warp * kSeg + cnt + __popc(bal & ((1u << lane) - 1u));
        skey[at] = slot[u].idx;
#pragma unroll
        for (int k = 0; k < kMaxFamilies; ++k)
          if (k < p.m) sval[k * warps * kSeg + at] = slot[u].coeff[k] * x[u];
      }
      cnt += __popc(bal);
    }
    if (lane == 0) scnt[warp] = cnt;
    __syncthreads();
    for (int src = 0; src < warps; ++src) {
      const int n = scnt[src];
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int at = src * kSeg + c0 + lane;
        const int key = c0 + lane < n ? skey[at] : -1;
        const bool own = key >= 0 && (key & (warps - 1)) == warp;
        float c[kMaxFamilies];
#pragma unroll
        for (int k = 0; k < kMaxFamilies; ++k)
          c[k] = (own && k < p.m) ? sval[k * warps * kSeg + at] : 0.f;
        hist_add(sm.hist, own, key, c, p.m, p.J);
      }
    }
    __syncthreads();
  }
  epilogue(p, sm, 1, lin, sq);
}

// Rows of width 64 <= L <= 8192: one warp per row, the row's candidates
// sorted and scanned in the warp's two shared-memory scratch rows
// (simplex_wide_cut), then computed again for x and the partials.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
dual_oracle_wide(Params p) {
  using TO = typename OutType<T>::type;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const Smem sm = prologue(p, smem, warps);  // one histogram per warp
  float scale[kMaxFamilies], cost_scale;
  load_scales(p, scale, cost_scale);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = p.L;
  float* h = sm.hist + warp * p.m * p.J;
  float* A = sm.tail + 2 * warp * L;  // the sorted row
  float* C = A + L;                      // its inclusive scan
  const long long slots = p.n * L;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  float lin = 0.f, sq = 0.f;
  for (long long row = static_cast<long long>(blockIdx.x) * warps + warp; row < p.n;
       row += stride) {
    const long long base = row * L;
    const RowCut cut = simplex_wide_cut(
        [&](int q, float& v, float& maskf) {
          Slot s;
          load_slot<T>(p, scale, cost_scale, base + q, slots, true, s);
          v = primal_candidate(s, sm.lam, p.m, p.J, p.ginv);
          maskf = s.mask;
        },
        A, C, L, p.scan_chunk, p.radius, p.inequality != 0);
    for (int q = lane; q < L; q += 32) {
      Slot s;
      load_slot<T>(p, scale, cost_scale, base + q, slots, true, s);
      const float v = primal_candidate(s, sm.lam, p.m, p.J, p.ginv);
      const float x = simplex_wide_apply(v, s.mask, cut);
      store(static_cast<TO*>(p.x) + base + q, x);
      lin += s.cost * x;
      sq += x * x;
      float c[kMaxFamilies];
#pragma unroll
      for (int k = 0; k < kMaxFamilies; ++k) c[k] = s.coeff[k] * x;
      hist_add(h, x != 0.f, s.idx, c, p.m, p.J);
    }
  }
  epilogue(p, sm, warps, lin, sq);
}

template <typename T>
cudaError_t dispatch(const Params& p, int grid, int warps, size_t smem, cudaStream_t st) {
  switch (p.L) {
    case 1: return launch_kernel(dual_oracle_narrow<T, 0>, p, grid, warps, smem, st);
    case 2: return launch_kernel(dual_oracle_narrow<T, 1>, p, grid, warps, smem, st);
    case 4: return launch_kernel(dual_oracle_narrow<T, 2>, p, grid, warps, smem, st);
    case 8: return launch_kernel(dual_oracle_narrow<T, 3>, p, grid, warps, smem, st);
    case 16: return launch_kernel(dual_oracle_narrow<T, 4>, p, grid, warps, smem, st);
    case 32: return launch_kernel(dual_oracle_narrow<T, 5>, p, grid, warps, smem, st);
    default: return launch_kernel(dual_oracle_wide<T>, p, grid, warps, smem, st);
  }
}

}  // namespace

// Plain C entry point, bound from Python with ctypes.  Launches on `stream`
// without synchronising and returns cudaGetLastError() (0 on success).
// dtype: 0 fp32, 1 bf16, 2 int8 (which requires both scale pointers).
extern "C" int dual_oracle_launch(const void* idx, const void* coeff, const void* cost,
                                  const void* mask, const void* lam,
                                  const void* coeff_scale, const void* cost_scale,
                                  void* x, void* hist, void* scal, long long n, int L,
                                  int m, int J, float ginv, float radius, int inequality,
                                  int dtype, int grid, int warps, int lam_in_smem,
                                  int scan_chunk, void* stream) {
  const bool pow2 = L >= 1 && (L & (L - 1)) == 0;
  if (!pow2 || L > 8192 || m < 1 || m > kMaxFamilies || J < 1 || n < 0 || grid < 1 ||
      warps < 1 || warps > kMaxWarps || dtype < 0 || dtype > 2 ||
      (dtype == 2) != (coeff_scale != nullptr && cost_scale != nullptr) ||
      (L > 32 && (scan_chunk < 32 || scan_chunk > L || (scan_chunk & (scan_chunk - 1))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long mJ = static_cast<long long>(m) * J;
  // narrow rows: one block histogram and the staging area (keys, m value
  // rows, counts); wide rows: one histogram and two scratch rows per warp
  const long long seg = static_cast<long long>(warps) * kUnroll * 32;
  const long long floats =
      (lam_in_smem ? mJ : 0) + 2 * kMaxWarps +
      (L <= 32 ? mJ + (1 + m) * seg + warps : warps * mJ + 2LL * warps * L);
  if (L <= 32 && (warps & (warps - 1))) return static_cast<int>(cudaErrorInvalidValue);
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
  p.hist = static_cast<float*>(hist);
  p.scal = static_cast<float*>(scal);
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
  cudaError_t err;
  switch (dtype) {
    case 0: err = dispatch<float>(p, grid, warps, smem, st); break;
    case 1: err = dispatch<__nv_bfloat16>(p, grid, warps, smem, st); break;
    default: err = dispatch<int8_t>(p, grid, warps, smem, st); break;
  }
  return static_cast<int>(err);
}
