// One-pass fused dual oracle for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/dual_oracle.py::dual_oracle_kernel_body
// (with its helpers dual_primal.py::fused_primal_tile and the bitonic
// sort / scan of simplex_proj.py) and the tree-sum of its partials
// (repro/kernels/ops.py:317).  For all bucket slabs of one objective it
// computes, in one oracle call,
//
//   x    [n, L] per bucket = Pi_simplex( -(sum_k coeff_k * lam[k, idx] + cost) * (1/gamma) )
//   A x  [m, J]            summed over every slot of every bucket
//   c'x, ||x||^2
//
// from ONE read of the slabs.  fp32, bf16 and int8 slabs are widened on
// load (int8 times its per-bucket scales); x is written at the storage width
// (fp32 for int8); A x, c'x and ||x||^2 reduce the fp32 x before any cast.
//
// Launches per call: one `oracle_narrow` for every bucket of width <= 32
// (the main path has only those), one `oracle_wide` per wider bucket, then
// one `oracle_finalize`.
//
// The tenant axis (the batched multi-tenant solve): a call over B stacked
// instances of one shape is the same launches with gridDim.y = B.  Block
// (x, b) does what block x of lane b's own call does, on lane b's slabs,
// lam, int64 row, partial rows and fixed-point shift (each lane has its own:
// the shift depends on the lane's coefficients), and the finalize runs one
// block row per lane.  Each lane's x, A x, c'x and ||x||^2 are therefore
// bitwise its solo call's at the same grid.x, and a batched call is still
// one narrow launch (plus one per wider bucket) and one finalize, whatever B.
// A batched call may also give each lane its own 1/gamma (`lane_ginv`, [B]
// fp32 on the card): the batched PDHG prox step, whose gamma_b = 1/tau_b
// comes from each lane's own sigma_max(A)^2.  A block reads its lane's entry
// once; lane b at gamma_b is then bitwise its solo call at gamma_b.
//
// A x in fixed point, so its sums are exact and order-free.  Each nonzero
// contribution coeff_k * x (fp32, rounded as the plain version rounds it)
// is scaled by 2^shift (exact), rounded to the nearest int64 (ties to even)
// and added with an integer atomicAdd into an int64 [m, J] histogram in
// shared memory.  Integer addition is associative, so every bin has the
// same bits whatever the grid, the number of SMs or the order in which the
// blocks run.  `shift` is fixed per objective from the static slab (Python:
// fixed_point_shift) so that max|coeff| * radius * (most slots of any bin)
// * 2^shift <= 2^62; as 0 <= x <= radius, no partial or total can overflow.
// The finalize converts each bin of the row to fp32 once and scales it by
// 2^-shift (exact): A x is the fp32 rounding of the
// (almost always exact) sum of the fp32 contributions.
//
// Where the histogram lives (hist_mode, chosen by the Python plan):
// shared memory when it fits, each block then adding its nonzero bins into
// one zeroed int64 row in global memory (red.global.add.u64; faster on the
// card than a row per block summed by the finalize); else that global row
// itself, which every contribution adds into (L2 atomics), so no m*J is
// too large.  c'x and ||x||^2 are per-block fp32 partials summed
// in a fixed tree and, by the finalize, in block order: the same bits for
// the same grid.  No float atomics anywhere.
//
// What bounds it: HBM bytes.  Each slab slot costs oracle_slab_slot_bytes
// (kernels/ops.py): 4 B idx + (m + 2) slab words + the x write, 20 B at fp32
// and m = 1, for a few dozen fp32 operations.  The slabs are read once and
// x written once; the projection's intermediates live in registers (rows of
// L <= 32: a segment of one warp) or in a per-warp shared-memory row (64 <=
// L <= 8192); lam is staged in shared memory when it fits beside the
// histogram, else read through L1/L2; a persistent grid (its size from the
// occupancy API) stages lam and zeroes the histogram once per block per
// call, and each warp issues the loads of kUnroll 32-slot groups before
// computing them.  Mask-zero (padded) slots produce x == 0 exactly and add
// nothing.

#include <cmath>

#include "primal_common.cuh"

namespace {

// Shared-memory layout of an oracle block: the int64 histogram (unless
// global), lam (when staged), the reduction slots, then for wide rows two
// fp32 rows per warp; each part 16-byte aligned (kernels/dual_oracle.py
// smem_bytes mirrors it).
// This block's lane's int64 row and 2^shift.
__device__ __forceinline__ unsigned long long* lane_acc(const Launch& p) {
  return p.acc + static_cast<long long>(blockIdx.y) * p.m * p.J;
}
__device__ __forceinline__ float lane_qscale(const Launch& p) {
  return p.lane_q != nullptr ? p.lane_q[blockIdx.y] : p.qscale;
}

struct OracleBlock {
  unsigned long long* hist;  // shared histogram, or null (kHistGlobal)
  const float* lam;          // shared copy or the global vector
  float* red;                // [2 * warps]
  float* rows;               // wide rows: [warps][2][L]
};

__device__ __forceinline__ size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

__device__ __forceinline__ OracleBlock oracle_prologue(const Launch& p, unsigned char* smem) {
  const int mJ = p.m * p.J;
  OracleBlock blk;
  unsigned char* at = smem;
  blk.hist = nullptr;
  if (p.hist_mode != kHistGlobal) {
    blk.hist = reinterpret_cast<unsigned long long*>(at);
    for (int e = threadIdx.x; e < mJ; e += blockDim.x) blk.hist[e] = 0ull;
    at += align16(8 * static_cast<size_t>(mJ));
  }
  blk.lam = lane_lam(p);
  if (p.lam_in_smem) {
    stage_lam(blk.lam, mJ, reinterpret_cast<float*>(at));
    blk.lam = reinterpret_cast<const float*>(at);
    at += align16(4 * static_cast<size_t>(mJ));
  }
  blk.red = reinterpret_cast<float*>(at);
  blk.rows = blk.red + 64;
  __syncthreads();
  return blk;
}

// Receives every slot with its x: (c'x, ||x||^2) in registers, each nonzero
// contribution coeff_k * x into the int64 histogram.
struct OracleSink {
  unsigned long long* shist;  // the block's shared histogram, or null
  unsigned long long* ghist;  // the global row (kHistGlobal)
  int m, J;
  float qscale;
  float lin, sq;

  template <int M, typename TO>
  __device__ __forceinline__ void operator()(const Slot<M>& s, float x, TO*) {
    lin += s.cost * x;
    sq += x * x;
    if (x == 0.f) return;  // zeros add nothing
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (k >= m) break;
      const long long q = __float2ll_rn(__fmul_rn(__fmul_rn(s.coeff[k], x), qscale));
      const unsigned long long u = static_cast<unsigned long long>(q);
      const int bin = k * J + s.idx;
      if (shist != nullptr) {
        atomicAdd(shist + bin, u);
      } else {
        atomicAdd(ghist + bin, u);
      }
    }
  }
};

// Writes this block's (c'x, ||x||^2), reduced in a fixed tree, and adds
// the nonzero bins of its shared histogram into the global row.
__device__ __forceinline__ void oracle_epilogue(const Launch& p, const OracleBlock& blk,
                                                float lin, float sq) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lin += __shfl_xor_sync(kFull, lin, o);
    sq += __shfl_xor_sync(kFull, sq, o);
  }
  if (lane == 0) {
    blk.red[2 * warp] = lin;
    blk.red[2 * warp + 1] = sq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < warps; ++w) {
      a += blk.red[2 * w];
      b += blk.red[2 * w + 1];
    }
    const long long row =
        static_cast<long long>(blockIdx.y) * p.scal_lane_rows + p.scal_row + blockIdx.x;
    float* out = p.scal + 2 * row;
    out[0] = a;
    out[1] = b;
  }
  const int mJ = p.m * p.J;
  if (p.hist_mode == kHistShared) {
    unsigned long long* acc = lane_acc(p);
    for (int e = threadIdx.x; e < mJ; e += blockDim.x) {
      const unsigned long long v = blk.hist[e];
      if (v != 0ull) atomicAdd(acc + e, v);
    }
  }
}

// Every bucket of width L <= 32 of the call, in one launch.
template <typename T, int M>
__global__ void __launch_bounds__(narrow_threads<M>(), 1)
oracle_narrow(const __grid_constant__ Launch p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const OracleBlock blk = oracle_prologue(p, smem);
  OracleSink sink{blk.hist, lane_acc(p), p.m, p.J, lane_qscale(p), 0.f, 0.f};
  walk_narrow<T, typename OutType<T>::type, M, false>(p, blk.lam, sink);
  oracle_epilogue(p, blk, sink.lin, sink.sq);
}

// One bucket of width 64 <= L <= 8192: a warp per row.
template <typename T, int M>
__global__ void __launch_bounds__(kWideWarps * 32)
oracle_wide(const __grid_constant__ Launch p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const OracleBlock blk = oracle_prologue(p, smem);
  OracleSink sink{blk.hist, lane_acc(p), p.m, p.J, lane_qscale(p), 0.f, 0.f};
  walk_wide<T, typename OutType<T>::type, M, false>(p, blk.lam, blk.rows, sink);
  oracle_epilogue(p, blk, sink.lin, sink.sq);
}

// A x [m*J] = fp32(the int64 row) * 2^-shift; (c'x, ||x||^2) = the
// blocks' partials summed by one warp in a fixed order.  Block row y is
// lane y of a batched call (its row, partials, outputs and 2^-shift).
__global__ void __launch_bounds__(256)
oracle_finalize(const unsigned long long* acc, int mJ, const float* scal, int scal_rows,
                float inv_q, const float* lane_inv_q, float* ax, float* lin_sq) {
  const long long lane = blockIdx.y;
  acc += lane * mJ;
  scal += 2 * lane * scal_rows;
  ax += lane * mJ;
  lin_sq += 2 * lane;
  if (lane_inv_q != nullptr) inv_q = lane_inv_q[lane];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < mJ; e += gridDim.x * blockDim.x) {
    ax[e] = __fmul_rn(__ll2float_rn(static_cast<long long>(acc[e])), inv_q);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float a = 0.f, b = 0.f;
    for (int r = threadIdx.x; r < scal_rows; r += 32) {
      a += scal[2 * r];
      b += scal[2 * r + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(kFull, a, o);
      b += __shfl_xor_sync(kFull, b, o);
    }
    if (threadIdx.x == 0) {
      lin_sq[0] = a;
      lin_sq[1] = b;
    }
  }
}

struct RunOracle {
  const Launch* p;
  LaunchShape shape;
  cudaStream_t stream;
  template <typename T, int M>
  cudaError_t run() {
    return shape.wide ? launch_kernel<oracle_wide<T, M>>(*p, shape, stream)
                      : launch_kernel<oracle_narrow<T, M>>(*p, shape, stream);
  }
};

struct InfoOracle {
  bool wide;
  int threads;
  size_t smem;
  int* out;
  template <typename T, int M>
  cudaError_t run() {
    return wide ? kernel_info<oracle_wide<T, M>>(threads, smem, out)
                : kernel_info<oracle_narrow<T, M>>(threads, smem, out);
  }
};

}  // namespace

// What the compiler made of the oracle kernel for slab dtype `dtype` (0 fp32,
// 1 bf16, 2 int8), M families, narrow or wide rows, and how many blocks of
// `threads` threads and `smem` bytes are resident per SM:
// out = {max threads per block, registers, local bytes, blocks per SM}.
extern "C" int dual_oracle_info(int dtype, int M, int wide, int threads, long long smem,
                                int* out) {
  InfoOracle f{wide != 0, threads, static_cast<size_t>(smem), out};
  return static_cast<int>(visit(dtype, M, f));
}

// Runs one oracle call of a Python plan (kernels/dual_oracle.py): every
// launch of `launches` (kLaunchWords int64 each) over the slabs of `slabs`
// (kSlabWords int64 each, x pointers in `x`), then the finalize, which
// writes A x [m*J] to `ax` and (c'x, ||x||^2) to `lin_sq`.  `acc` is the
// int64 row of m*J, zeroed by the caller; `scal` holds `scal_rows` fp32
// pairs, one per block.  With `lanes` > 1 every one of these is per lane
// (lane b's at b times its size; the slabs are stacked), and `lane_q` holds
// 2^shift then 2^-shift of each lane ([2, lanes] fp32 on the card) in
// place of `shift`; `lane_ginv`, when not null, holds each lane's 1/gamma
// ([lanes] fp32 on the card) in place of `ginv`.  Launches on `stream`
// without synchronising; returns the first CUDA error (0 on success).
extern "C" int dual_oracle_run(const long long* slabs, int nslabs, const long long* launches,
                               int nlaunch, int dtype, int M, int m, int J, const void* lam,
                               const long long* x, void* acc, void* scal, int scal_rows,
                               void* ax, void* lin_sq, float ginv, float radius,
                               int inequality, int shift, int finalize_grid, int lanes,
                               const void* lane_q, const void* lane_ginv, void* stream) {
  if (!valid_families(M, m) || J < 1 || nlaunch < 0 || scal_rows < 0 ||
      shift < -100 || shift > 100 || finalize_grid < 1 || lanes < 1 || lanes > 65535 ||
      (lanes > 1 && lane_q == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Launch p;
  p.lam = static_cast<const float*>(lam);
  p.m = m;
  p.J = J;
  p.ginv = ginv;
  p.radius = radius;
  p.inequality = inequality;
  p.acc = static_cast<unsigned long long*>(acc);
  p.scal = static_cast<float*>(scal);
  p.qscale = std::ldexp(1.f, shift);
  const float* lq = static_cast<const float*>(lane_q);
  p.lane_q = lq;
  p.lane_ginv = static_cast<const float*>(lane_ginv);
  p.scal_lane_rows = scal_rows;
  p.plane = 0;
  for (int l = 0; l < nlaunch; ++l) {
    RunOracle f{&p, {}, st};
    if (!decode_launch(launches + static_cast<long long>(l) * kLaunchWords, slabs, nslabs, x,
                       p, f.shape) ||
        p.scal_row + f.shape.grid > scal_rows) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    f.shape.lanes = lanes;
    for (int i = 0; i < p.nslab; ++i) {
      if (p.slab[i].rows != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = visit(dtype, M, f);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  oracle_finalize<<<dim3(finalize_grid, lanes), 256, 0, st>>>(
      static_cast<const unsigned long long*>(acc), m * J,
      static_cast<const float*>(scal), scal_rows, std::ldexp(1.f, -shift),
      lq == nullptr ? nullptr : lq + lanes, static_cast<float*>(ax),
      static_cast<float*>(lin_sq));
  return static_cast<int>(cudaGetLastError());
}

// The finalize alone, on the row and partials an earlier call left
// (chip_smoke.py holds it against its plain version and times it).
extern "C" int dual_oracle_finalize(const void* acc, int mJ, const void* scal, int scal_rows,
                                    int shift, void* ax, void* lin_sq, int finalize_grid,
                                    void* stream) {
  if (mJ < 1 || scal_rows < 0 || shift < -100 || shift > 100 || finalize_grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  oracle_finalize<<<finalize_grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(acc), mJ,
      static_cast<const float*>(scal), scal_rows, std::ldexp(1.f, -shift), nullptr,
      static_cast<float*>(ax), static_cast<float*>(lin_sq));
  return static_cast<int>(cudaGetLastError());
}
