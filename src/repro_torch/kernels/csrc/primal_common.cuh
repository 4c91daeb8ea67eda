// Device functions shared by the port's hand-written Hopper kernels:
//
//   dual_oracle.cu   replaces repro/kernels/dual_oracle.py::dual_oracle_kernel_body
//   dual_primal.cu   replaces repro/kernels/dual_primal.py::dual_primal_kernel_body
//   simplex_proj.cu  replaces repro/kernels/simplex_proj.py::simplex_kernel_body
//
// One rounding contract for all three, so that their x agree bit for bit with
// each other and with the plain PyTorch versions on the card:
//   * slabs are widened to fp32 on load (int8 times its per-bucket scales);
//   * the primal candidate -(A^T lam + c) * (1/gamma) sums the family
//     products in family order without fused multiply-adds;
//   * the Duchi projection sorts descending, then scans in the order of
//     PyTorch's CUDA cumsum (Sklansky within a warp for rows of <= 32, ATen's
//     chunking for wider rows), so the cutoff sums round as the plain
//     version's do.  Padded slots enter as kNeg and come out exactly 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1.0e30f;  // finite stand-in for -inf, as the reference
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxFamilies = 8;   // MAX_FAMILIES of the Python wrappers
constexpr int kMaxSmem = 232448;  // 227 KB opt-in shared memory per block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x is written at the storage width for float slabs, in fp32 for int8.
template <typename T> struct OutType { using type = T; };
template <> struct OutType<int8_t> { using type = float; };

// One slab slot, widened to fp32.
struct Slot {
  int idx;
  float coeff[kMaxFamilies];
  float cost, mask;
};

// `P` holds the slab: idx, coeff [m, n, L], cost, mask and m.
template <typename T, typename P>
__device__ __forceinline__ void load_slot(const P& p, const float* scale,
                                          float cost_scale, long long s,
                                          long long slots, bool valid, Slot& out) {
  const T* coeff = static_cast<const T*>(p.coeff);
  out.idx = valid ? p.idx[s] : 0;
  out.cost = valid ? widen(static_cast<const T*>(p.cost)[s]) * cost_scale : 0.f;
  out.mask = valid ? widen(static_cast<const T*>(p.mask)[s]) : 0.f;
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k) {
    out.coeff[k] = (k < p.m && valid) ? widen(coeff[k * slots + s]) * scale[k] : 0.f;
  }
}

// The int8 dequantization scales (1 for float slabs).
template <typename P>
__device__ __forceinline__ void load_scales(const P& p, float (&scale)[kMaxFamilies],
                                            float& cost_scale) {
#pragma unroll
  for (int k = 0; k < kMaxFamilies; ++k)
    scale[k] = (p.coeff_scale != nullptr && k < p.m) ? p.coeff_scale[k] : 1.f;
  cost_scale = p.cost_scale != nullptr ? p.cost_scale[0] : 1.f;
}

// Copies lam [mJ] into shared memory with the whole block.  16-byte loads,
// several in flight per thread: staging lam is a fixed cost of every block
// and dominates the small buckets' launches.  The caller synchronises.
__device__ __forceinline__ void stage_lam(const float* lam, int mJ, float* dst) {
  if ((mJ & 3) == 0 && (reinterpret_cast<uintptr_t>(lam) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(lam);
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll 4
    for (int e = threadIdx.x; e < mJ / 4; e += blockDim.x) d4[e] = src[e];
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < mJ; e += blockDim.x) dst[e] = lam[e];
  }
}

// Primal candidate v = -(A^T lam + c) * (1/gamma) at one slot (eq. 3 before
// the projection), rounded exactly as the plain version computes it: the
// family products summed in order without fused multiply-adds, then one
// multiply by the fp32 reciprocal of gamma.  `lam` is generic: shared memory
// or global.
__device__ __forceinline__ float primal_candidate(const Slot& s, const float* lam,
                                                  int m, int J, float ginv) {
  float atl = __fmul_rn(s.coeff[0], lam[s.idx]);
#pragma unroll
  for (int k = 1; k < kMaxFamilies; ++k) {
    if (k < m) atl = __fadd_rn(atl, __fmul_rn(s.coeff[k], lam[k * J + s.idx]));
  }
  return __fmul_rn(-__fadd_rn(atl, s.cost), ginv);
}

// Masked Duchi projection of a row held by a segment of 2^LOGL lanes of one
// warp (lane `pos` of the segment holds entry `pos`).  Same pipeline as the
// reference: descending bitonic sort, inclusive scan, cutoff rho from the
// monotone condition, threshold theta, subtract-and-clamp; the inequality
// variant returns feasible rows clamped only.  All 32 lanes must call it.
template <int LOGL>
__device__ __forceinline__ float simplex_segment(float v, float maskf, int pos,
                                                 float radius, bool inequality) {
  constexpr int L = 1 << LOGL;
  const float vm = maskf > 0.f ? v : kNeg;
  float u = vm;
#pragma unroll
  for (int k = 2; k <= L; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float other = __shfl_xor_sync(kFull, u, j);
      const bool asc = (pos & k) != 0;
      const bool lower = (pos & j) == 0;
      u = (lower == asc) ? fminf(u, other) : fmaxf(u, other);
    }
  }
  // inclusive scan in Sklansky order (the order of PyTorch's CUDA cumsum
  // along rows of up to 32, so the cutoff sums round as the plain version's)
  const int base = (threadIdx.x & 31) & ~(L - 1);
  float css = u;
#pragma unroll
  for (int s = 1; s < L; s <<= 1) {
    const float t = __shfl_sync(kFull, css, base + (pos & ~(2 * s - 1)) + s - 1);
    if (pos & s) css += t;
  }
  int cnt = (u * static_cast<float>(pos + 1) > css - radius) ? 1 : 0;
#pragma unroll
  for (int o = 1; o < L; o <<= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  const int rho = max(cnt, 1);
  const float css_rho = __shfl_sync(kFull, css, base + rho - 1);
  const float theta = (css_rho - radius) / static_cast<float>(rho);
  const float w_eq = fmaxf(vm - theta, 0.f) * maskf;
  if (!inequality) return w_eq;
  const float w0 = fmaxf(v, 0.f) * maskf;
  float s0 = w0;
#pragma unroll
  for (int o = 1; o < L; o <<= 1) s0 += __shfl_xor_sync(kFull, s0, o);
  return s0 <= radius ? w0 : w_eq;
}

// What the projection of one wide row needs besides the row itself.
struct RowCut {
  float theta;    // threshold of the equality projection
  bool feasible;  // inequality variant: the clamped row already fits
};

// Cutoff of one row of width L (64 <= L <= 8192, a power of two) held by one
// warp, the slow-but-right path: `load(q, v, maskf)` gives the candidate and
// mask of slot q; the masked candidates are sorted descending in the warp's
// shared-memory row A and scanned into its row C, chunk by chunk in the order
// of PyTorch's CUDA cumsum (`scan_chunk`, see kernels/dual_oracle.py).  All
// 32 lanes must call it; A and C are free again when it returns.
template <typename Load>
__device__ __forceinline__ RowCut simplex_wide_cut(Load load, float* A, float* C, int L,
                                                   int scan_chunk, float radius,
                                                   bool inequality) {
  const int lane = threadIdx.x & 31;
  float s0 = 0.f;
  for (int q = lane; q < L; q += 32) {
    float v, maskf;
    load(q, v, maskf);
    A[q] = maskf > 0.f ? v : kNeg;
    s0 += fmaxf(v, 0.f) * maskf;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s0 += __shfl_xor_sync(kFull, s0, o);
  __syncwarp();
  // descending bitonic sort of A: pair (q, q ^ j), q the lower index
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = lane; q < L; q += 32) {
        const int r = q ^ j;
        if (r > q) {
          const float a = A[q], b = A[r];
          const bool asc = (q & k) != 0;
          A[q] = asc ? fminf(a, b) : fmaxf(a, b);
          A[r] = asc ? fmaxf(a, b) : fminf(a, b);
        }
      }
      __syncwarp();
    }
  }
  // inclusive scan into C, chunk by chunk in the order of PyTorch's CUDA
  // cumsum: the previous chunks' total enters the chunk's first element,
  // then a Sklansky scan within the chunk
  for (int q = lane; q < L; q += 32) C[q] = A[q];
  __syncwarp();
  for (int c0 = 0; c0 < L; c0 += scan_chunk) {
    if (c0 > 0 && lane == 0) C[c0] += C[c0 - 1];
    __syncwarp();
    for (int s = 1; s < scan_chunk; s <<= 1) {
      for (int q = lane; q < scan_chunk; q += 32) {
        if (q & s) C[c0 + q] += C[c0 + (q & ~(2 * s - 1)) + s - 1];
      }
      __syncwarp();
    }
  }
  // cutoff: count the monotone Duchi condition over the sorted row
  int cnt = 0;
  for (int q = lane; q < L; q += 32) {
    const bool cond = A[q] * static_cast<float>(q + 1) > C[q] - radius;
    cnt += __popc(__ballot_sync(kFull, cond));
  }
  const int rho = max(cnt, 1);
  RowCut cut;
  cut.theta = (C[rho - 1] - radius) / static_cast<float>(rho);
  cut.feasible = inequality && s0 <= radius;
  __syncwarp();
  return cut;
}

// The projected value of one slot of a wide row, given the row's cut.
__device__ __forceinline__ float simplex_wide_apply(float v, float maskf, const RowCut& cut) {
  const float vm = maskf > 0.f ? v : kNeg;
  return cut.feasible ? fmaxf(v, 0.f) * maskf : fmaxf(vm - cut.theta, 0.f) * maskf;
}

// Sets the dynamic shared memory a launch needs, launches, and returns the
// launch's error (0 on success).
template <typename K, typename P>
cudaError_t launch_kernel(K kernel, const P& p, int grid, int warps, size_t smem,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
