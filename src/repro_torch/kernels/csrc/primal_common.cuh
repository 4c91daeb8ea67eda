// Device functions and launch scaffolding shared by the port's hand-written
// Hopper kernels:
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
//
// The oracle and the primal step walk the slabs with the same code
// (walk_narrow, walk_wide): one launch covers every bucket of width <= 32,
// and a `Sink` receives each slot with its x (the oracle bins A x there, the
// primal step does nothing), so the two kernels' x are the same by
// construction.  The family count is a template parameter M (1, 2, 4 or 8)
// with the runtime m <= M, so a slot holds M coefficients, not eight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNeg = -1.0e30f;  // finite stand-in for -inf, as the reference
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // 227 KB opt-in shared memory per block
constexpr int kMaxSlabs = 16;     // buckets one launch walks (MAX_SLABS in Python)
constexpr int kUnroll = 4;        // 32-slot groups a warp loads together (UNROLL)
constexpr int kWideWarps = 8;     // most warps of a wide-row block (WIDE_WARPS)
constexpr int kSlabWords = 12;    // int64 words per bucket from Python (SLAB_WORDS)
constexpr int kLaunchWords = 9 + kMaxSlabs;  // int64 words per launch (LAUNCH_WORDS)

// Threads of a narrow-row block: the most that fit the registers a slot of
// M families needs (1024 threads leave 64 registers a thread).
template <int M> constexpr int narrow_threads() { return M <= 2 ? 1024 : 512; }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// x is written at the storage width for float slabs, in fp32 for int8.
template <typename T> struct OutType { using type = T; };
template <> struct OutType<int8_t> { using type = float; };

// One bucket slab of a launch.  A launch over a stack of B same-shape
// instances (the tenant axis, gridDim.y = B) reads lane b's slab at b times
// the lane's own size past these pointers: the stacked tensors are
// contiguous [B, ...].  A row list (`rows`, the serving query) makes output
// row r read source row rows[r]; the output then has `n` rows, the source
// `src_n`.
struct Slab {
  const int32_t* idx;        // [src_n, L]
  const void* coeff;         // [m, src_n, L] storage dtype
  const void* cost;          // [src_n, L] storage dtype
  const void* mask;          // [src_n, L] storage dtype
  const float* coeff_scale;  // [m] (int8 only, else null)
  const float* cost_scale;   // [1] (int8 only, else null)
  void* x;                   // [n, L] output dtype
  long long n;               // rows of the output (and of the task space)
  long long task0;           // narrow rows: first warp task of this slab
  int logl;                  // log2 of the width L
  int scan_chunk;            // wide rows: chunk of the cumsum order, <= L
  const long long* rows;     // [n] source row of each output row, or null
  long long src_n;           // rows of the source slab (== n without rows)
};

// Everything one launch computes, passed by value (__grid_constant__).
struct Launch {
  Slab slab[kMaxSlabs];
  int nslab;
  long long tasks;  // narrow: warp tasks over all slabs; wide: rows of slab[0]
  const float* lam;  // [m, J]
  int m, J;
  float ginv, radius;  // 1/gamma rounded to fp32
  int inequality, lam_in_smem;
  // the oracle only
  unsigned long long* acc;  // int64 A x accumulator [m*J], zeroed by the caller
  float* scal;              // per-block (c'x, ||x||^2) rows [rows][2]
  int hist_mode;            // kHistShared / kHistGlobal
  int scal_row;             // this launch's first scal row
  float qscale;             // 2^shift of the fixed-point A x
  // the tenant axis (gridDim.y lanes): lam, acc and scal advance by one
  // lane's size per lane; each lane has its own 2^shift (lane_q) and its
  // own 1/gamma (lane_ginv, the batched PDHG step's 1/gamma_b) when given
  const float* lane_q;      // [lanes] qscale per lane, or null (qscale)
  const float* lane_ginv;   // [lanes] 1/gamma per lane, or null (ginv)
  int scal_lane_rows;       // scal rows of one lane
  // row-list outputs: a slot's mask (fp32) and idx (int32) are written
  // `plane` and 2 * `plane` floats past its x
  long long plane;
};

// Where the oracle's int64 A x histogram lives.
constexpr int kHistShared = 0;  // shared memory, added into `acc` at block end
constexpr int kHistGlobal = 1;  // past shared memory: `acc` itself

// One slab slot, widened to fp32.
template <int M>
struct Slot {
  int idx;
  float coeff[M];
  float cost, mask;
};

// The int8 dequantization scales (1 for float slabs).
template <int M>
__device__ __forceinline__ void load_scales(const Slab& b, int m, float (&scale)[M],
                                            float& cost_scale) {
#pragma unroll
  const long long lane = blockIdx.y;
  for (int k = 0; k < M; ++k)
    scale[k] = (b.coeff_scale != nullptr && k < m) ? b.coeff_scale[lane * m + k] : 1.f;
  cost_scale = b.cost_scale != nullptr ? b.cost_scale[lane] : 1.f;
}

// One lane's view of a slab: its typed pointers, already offset to the lane.
template <typename T, typename TO>
struct LaneSlab {
  const int32_t* idx;
  const T* coeff;
  const T* cost;
  const T* mask;
  TO* x;
  long long src_slots;  // slots of the source slab (the coeff family stride)
};

template <typename T, typename TO>
__device__ __forceinline__ LaneSlab<T, TO> lane_slab(const Slab& b, int m) {
  const long long lane = blockIdx.y;
  const long long src_slots = b.src_n << b.logl;
  LaneSlab<T, TO> v;
  v.idx = b.idx + lane * src_slots;
  v.coeff = static_cast<const T*>(b.coeff) + lane * m * src_slots;
  v.cost = static_cast<const T*>(b.cost) + lane * src_slots;
  v.mask = static_cast<const T*>(b.mask) + lane * src_slots;
  v.x = static_cast<TO*>(b.x) + lane * (b.n << b.logl);
  v.src_slots = src_slots;
  return v;
}

template <typename T, typename TO, int M>
__device__ __forceinline__ void load_slot(const LaneSlab<T, TO>& v, int m,
                                          const float (&scale)[M], float cost_scale,
                                          long long s, bool valid, Slot<M>& out) {
  out.idx = valid ? v.idx[s] : 0;
  out.cost = valid ? widen(v.cost[s]) * cost_scale : 0.f;
  out.mask = valid ? widen(v.mask[s]) : 0.f;
#pragma unroll
  for (int k = 0; k < M; ++k) {
    out.coeff[k] = (k < m && valid) ? widen(v.coeff[k * v.src_slots + s]) * scale[k] : 0.f;
  }
}

// Copies lam [mJ] into shared memory with the whole block.  16-byte loads,
// several in flight per thread.  The caller synchronises.
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
template <int M>
__device__ __forceinline__ float primal_candidate(const Slot<M>& s, const float* lam,
                                                  int m, int J, float ginv) {
  float atl = __fmul_rn(s.coeff[0], lam[s.idx]);
#pragma unroll
  for (int k = 1; k < M; ++k) {
    if (k < m) atl = __fadd_rn(atl, __fmul_rn(s.coeff[k], lam[k * J + s.idx]));
  }
  return __fmul_rn(-__fadd_rn(atl, s.cost), ginv);
}

// 1/gamma of this block's lane: the lane's entry of the per-lane table
// when the launch has one (the batched PDHG prox step), else the scalar.
__device__ __forceinline__ float block_ginv(const Launch& p) {
  return p.lane_ginv != nullptr ? p.lane_ginv[blockIdx.y] : p.ginv;
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

// One warp task of a narrow slab (L = 2^LOGL <= 32): kUnroll groups of 32
// consecutive output slots starting at group g0, i.e. whole rows, one per
// segment of L lanes.  The loads of all groups are issued before any is
// computed.  With ROWS, output row r reads source row b.rows[r].  x is
// written as TO; the sink receives each slot, its x and where x went.
template <typename T, typename TO, int M, int LOGL, bool ROWS, typename Sink>
__device__ __forceinline__ void narrow_task(const Launch& p, const Slab& b, long long g0,
                                            const float* lam, Sink& sink) {
  constexpr int L = 1 << LOGL;
  const int lane = threadIdx.x & 31;
  const int pos = lane & (L - 1);
  const long long slots = b.n << LOGL;
  const LaneSlab<T, TO> v = lane_slab<T, TO>(b, p.m);
  float scale[M], cost_scale;
  load_scales<M>(b, p.m, scale, cost_scale);
  Slot<M> slot[kUnroll];
  bool valid[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long s = (g0 + u) * 32 + lane;
    valid[u] = s < slots;
    long long src = s;
    if (ROWS) src = valid[u] ? (b.rows[s >> LOGL] << LOGL) + pos : 0;
    load_slot<T, TO, M>(v, p.m, scale, cost_scale, src, valid[u], slot[u]);
  }
  const float ginv = block_ginv(p);
  float x[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float c = primal_candidate<M>(slot[u], lam, p.m, p.J, ginv);
    x[u] = simplex_segment<LOGL>(c, slot[u].mask, pos, p.radius, p.inequality != 0);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (valid[u]) {
      TO* xp = v.x + (g0 + u) * 32 + lane;
      store(xp, x[u]);
      sink(slot[u], x[u], xp);
    }
  }
}

// The narrow rows of a launch: every warp takes warp tasks (kUnroll groups
// of 32 slots) of all its slabs in turn, the slabs one after another in
// task space (Slab::task0, computed by the Python plan).
template <typename T, typename TO, int M, bool ROWS, typename Sink>
__device__ __forceinline__ void walk_narrow(const Launch& p, const float* lam, Sink& sink) {
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long t = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       t < p.tasks; t += warps) {
    int i = 0;
    while (i + 1 < p.nslab && t >= p.slab[i + 1].task0) ++i;
    const Slab& b = p.slab[i];
    const long long g0 = (t - b.task0) * kUnroll;
    switch (b.logl) {
      case 0: narrow_task<T, TO, M, 0, ROWS>(p, b, g0, lam, sink); break;
      case 1: narrow_task<T, TO, M, 1, ROWS>(p, b, g0, lam, sink); break;
      case 2: narrow_task<T, TO, M, 2, ROWS>(p, b, g0, lam, sink); break;
      case 3: narrow_task<T, TO, M, 3, ROWS>(p, b, g0, lam, sink); break;
      case 4: narrow_task<T, TO, M, 4, ROWS>(p, b, g0, lam, sink); break;
      default: narrow_task<T, TO, M, 5, ROWS>(p, b, g0, lam, sink); break;
    }
  }
}

// The rows of one wide slab (64 <= L <= 8192, slab[0] of the launch): one
// warp per row, its candidates sorted and scanned in the warp's two
// shared-memory rows A and C (simplex_wide_cut), then computed again for x.
template <typename T, typename TO, int M, bool ROWS, typename Sink>
__device__ __forceinline__ void walk_wide(const Launch& p, const float* lam, float* rows,
                                          Sink& sink) {
  const Slab& b = p.slab[0];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int L = 1 << b.logl;
  float* A = rows + 2 * warp * L;  // the sorted row
  float* C = A + L;                // its inclusive scan
  const LaneSlab<T, TO> v = lane_slab<T, TO>(b, p.m);
  float scale[M], cost_scale;
  load_scales<M>(b, p.m, scale, cost_scale);
  const float ginv = block_ginv(p);
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  for (long long row = static_cast<long long>(blockIdx.x) * warps + warp; row < b.n;
       row += stride) {
    const long long base = (ROWS ? b.rows[row] : row) * L;
    auto candidate = [&](int q, Slot<M>& s) {
      load_slot<T, TO, M>(v, p.m, scale, cost_scale, base + q, true, s);
      return primal_candidate<M>(s, lam, p.m, p.J, ginv);
    };
    const RowCut cut = simplex_wide_cut(
        [&](int q, float& val, float& maskf) {
          Slot<M> s;
          val = candidate(q, s);
          maskf = s.mask;
        },
        A, C, L, b.scan_chunk, p.radius, p.inequality != 0);
    for (int q = lane; q < L; q += 32) {
      Slot<M> s;
      const float x = simplex_wide_apply(candidate(q, s), s.mask, cut);
      TO* xp = v.x + row * L + q;
      store(xp, x);
      sink(s, x, xp);
    }
  }
}

// The sink of the primal step: x is all it computes.
struct NoSink {
  template <int M, typename TO>
  __device__ __forceinline__ void operator()(const Slot<M>&, float, TO*) {}
};

// The sink of a row-list call: the slot's mask (fp32) and idx (int32) go
// `plane` and 2 * `plane` floats past its fp32 x.
struct RowsSink {
  long long plane;
  template <int M>
  __device__ __forceinline__ void operator()(const Slot<M>& s, float, float* xp) {
    xp[plane] = s.mask;
    reinterpret_cast<int32_t*>(xp)[2 * plane] = s.idx;
  }
};

// lam of this block's lane (the tenant axis: lane b's duals at b * m * J).
__device__ __forceinline__ const float* lane_lam(const Launch& p) {
  return p.lam + static_cast<long long>(blockIdx.y) * p.m * p.J;
}

// -- host side --------------------------------------------------------------

// The template family count M (1, 2, 4 or 8) takes the runtime m.
inline bool valid_families(int M, int m) {
  return (M == 1 || M == 2 || M == 4 || M == 8) && m >= 1 && m <= M;
}

// How one launch of the Python plan runs.
struct LaunchShape {
  bool wide;
  int grid, threads;
  size_t smem;
  int lanes = 1;  // gridDim.y: the tenant axis
};

// Decodes launch word block `lw` of the Python plan (kLaunchWords int64:
// wide, grid, threads, smem, lam_in_smem, hist_mode, scal_row, tasks,
// nslab, then the slab ids) into `p` and `shape`, with its slabs from
// `words` (kSlabWords int64 per slab: idx, coeff, cost, mask, coeff_scale,
// cost_scale, n, L, task0, scan_chunk, rows, src_n) and one x pointer each.
// Returns false on what the kernels do not take.
inline bool decode_launch(const long long* lw, const long long* words, int nslabs,
                          const long long* x, Launch& p, LaunchShape& shape) {
  shape.wide = lw[0] != 0;
  shape.grid = static_cast<int>(lw[1]);
  shape.threads = static_cast<int>(lw[2]);
  shape.smem = static_cast<size_t>(lw[3]);
  p.lam_in_smem = static_cast<int>(lw[4]);
  p.hist_mode = static_cast<int>(lw[5]);
  p.scal_row = static_cast<int>(lw[6]);
  p.tasks = lw[7];
  p.nslab = static_cast<int>(lw[8]);
  if (shape.grid < 1 || shape.threads < 32 || shape.threads > 1024 || shape.threads % 32 ||
      lw[3] < 0 || lw[3] > kMaxSmem || p.hist_mode < kHistShared || p.hist_mode > kHistGlobal ||
      p.nslab < 1 || p.nslab > kMaxSlabs || (shape.wide && p.nslab != 1) || p.tasks < 0) {
    return false;
  }
  for (int i = 0; i < p.nslab; ++i) {
    const long long id = lw[9 + i];
    if (id < 0 || id >= nslabs) return false;
    const long long* w = words + id * kSlabWords;
    const long long L = w[7];
    if (L < 1 || (L & (L - 1)) || L > 8192 || (L > 32) != shape.wide || w[6] < 0) return false;
    Slab& s = p.slab[i];
    s.idx = reinterpret_cast<const int32_t*>(w[0]);
    s.coeff = reinterpret_cast<const void*>(w[1]);
    s.cost = reinterpret_cast<const void*>(w[2]);
    s.mask = reinterpret_cast<const void*>(w[3]);
    s.coeff_scale = reinterpret_cast<const float*>(w[4]);
    s.cost_scale = reinterpret_cast<const float*>(w[5]);
    s.x = reinterpret_cast<void*>(x[id]);
    s.n = w[6];
    s.logl = 0;
    while ((1LL << s.logl) < L) ++s.logl;
    s.task0 = w[8];
    s.scan_chunk = static_cast<int>(w[9]);
    s.rows = reinterpret_cast<const long long*>(w[10]);
    s.src_n = w[11];
    if (shape.wide && (s.scan_chunk < 32 || s.scan_chunk > L ||
                       (s.scan_chunk & (s.scan_chunk - 1)))) {
      return false;
    }
    if (s.src_n < 0 || (s.rows == nullptr && s.src_n != s.n)) return false;
  }
  return true;
}

// Lets kernel K use all of a block's opt-in shared memory: once per kernel
// instantiation and device, not once per launch.
template <auto K>
cudaError_t allow_max_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// Launches kernel K and returns the launch's error (0 on success).
template <auto K, typename P>
cudaError_t launch_kernel(const P& p, const LaunchShape& shape, cudaStream_t stream) {
  cudaError_t err = allow_max_smem<K>();
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<P*>(&p)};
  return cudaLaunchKernel(reinterpret_cast<const void*>(K), dim3(shape.grid, shape.lanes),
                          dim3(shape.threads), args, shape.smem, stream);
}

// What the compiler made of kernel K and how many of its blocks of
// `threads` threads and `smem` bytes fit on one SM:
// out = {max threads per block, registers per thread, local (spill) bytes
// per thread, resident blocks per SM}.
template <auto K>
cudaError_t kernel_info(int threads, size_t smem, int* out) {
  cudaError_t err = allow_max_smem<K>();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, K);
  if (err != cudaSuccess) return err;
  out[0] = a.maxThreadsPerBlock;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], K, threads, smem);
}

// Calls f.template run<T, M>() for a slab dtype code (0 fp32, 1 bf16, 2 int8)
// and a template family count M in {1, 2, 4, 8}.
template <typename F>
cudaError_t visit(int dtype, int M, F& f) {
  switch (dtype * 16 + M) {
    case 0 * 16 + 1: return f.template run<float, 1>();
    case 0 * 16 + 2: return f.template run<float, 2>();
    case 0 * 16 + 4: return f.template run<float, 4>();
    case 0 * 16 + 8: return f.template run<float, 8>();
    case 1 * 16 + 1: return f.template run<__nv_bfloat16, 1>();
    case 1 * 16 + 2: return f.template run<__nv_bfloat16, 2>();
    case 1 * 16 + 4: return f.template run<__nv_bfloat16, 4>();
    case 1 * 16 + 8: return f.template run<__nv_bfloat16, 8>();
    case 2 * 16 + 1: return f.template run<int8_t, 1>();
    case 2 * 16 + 2: return f.template run<int8_t, 2>();
    case 2 * 16 + 4: return f.template run<int8_t, 4>();
    case 2 * 16 + 8: return f.template run<int8_t, 8>();
    default: return cudaErrorInvalidValue;
  }
}

// visit() for the float storage dtypes only (0 fp32, 1 bf16).
template <typename F>
cudaError_t visit_float(int dtype, int M, F& f) {
  switch (dtype * 16 + M) {
    case 0 * 16 + 1: return f.template run<float, 1>();
    case 0 * 16 + 2: return f.template run<float, 2>();
    case 0 * 16 + 4: return f.template run<float, 4>();
    case 0 * 16 + 8: return f.template run<float, 8>();
    case 1 * 16 + 1: return f.template run<__nv_bfloat16, 1>();
    case 1 * 16 + 2: return f.template run<__nv_bfloat16, 2>();
    case 1 * 16 + 4: return f.template run<__nv_bfloat16, 4>();
    case 1 * 16 + 8: return f.template run<__nv_bfloat16, 8>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
