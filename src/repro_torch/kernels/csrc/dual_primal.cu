// Fused primal step for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   repro/kernels/dual_primal.py::dual_primal_kernel_body
// (its tile fused_primal_tile).  For all bucket slabs of one objective it
// computes, in one call,
//
//   x [n, L] per bucket = Pi_simplex( -(sum_k coeff_k * lam[k, idx] + cost) * (1/gamma) )
//
// and nothing else: no A x and no partials, so its blocks share nothing and
// write only x.  fp32, bf16 and int8 slabs are widened on load (int8 times
// its per-bucket scales); all arithmetic is fp32 and x is written at the
// storage width (fp32 for int8).  The slabs are walked by the oracle's own
// code (primal_common.cuh: walk_narrow, walk_wide) with a sink that does
// nothing, so on the same inputs this kernel's x is bitwise the oracle's.
//
// Launches per call: one `primal_narrow` for every bucket of width <= 32
// (the main path has only those) and one `primal_wide` per wider bucket.
//
// The row-list form (the serving query): `rows_narrow` / `rows_wide` compute
// x for a list of requested rows of each bucket only, output row r from
// source row rows[r], so a query reads O(q * L) slots, never the slab.  One
// launch covers every requested bucket of width <= 32 (one more per wider
// bucket).  x is always written in fp32 (a bf16 slab's x is the fp32 value
// before the storage cast, which is what the unfused direct projection over
// the widened slab returns), followed by the slots' mask (fp32) and idx
// (int32), each a plane of the one output buffer.
//
// What bounds it: HBM bytes.  Each slab slot reads 4 B of idx and m + 2
// slab words and writes x: 20 B at fp32 and m = 1, for a few dozen fp32
// operations.  The slab is read once and x written once; a row of L <= 32 is
// a segment of one warp (shuffle sort and scan in registers), a wider row
// sorts and scans in the warp's two shared-memory rows; lam [m, J] is staged
// in shared memory when it fits, else read through L1/L2; the persistent
// grid is sized by the occupancy API for the instantiated kernel (the family
// count M a template parameter, so m = 1 holds one coefficient a slot), and
// each warp issues the loads of kUnroll 32-slot groups before computing.

#include "primal_common.cuh"

namespace {

// Stages lam at the start of shared memory when the plan says so; returns
// where the kernel reads lam.
__device__ __forceinline__ const float* lam_view(const Launch& p, float* smem) {
  if (!p.lam_in_smem) return lane_lam(p);
  stage_lam(lane_lam(p), p.m * p.J, smem);
  __syncthreads();
  return smem;
}

// Every bucket of width L <= 32 of the call, in one launch.
template <typename T, int M>
__global__ void __launch_bounds__(narrow_threads<M>(), 1)
primal_narrow(const __grid_constant__ Launch p) {
  extern __shared__ __align__(16) float smem[];
  NoSink sink;
  walk_narrow<T, typename OutType<T>::type, M, false>(p, lam_view(p, smem), sink);
}

// One bucket of width 64 <= L <= 8192: a warp per row, its two scratch rows
// after lam (16-byte aligned, as kernels/dual_primal.py lays it out).
template <typename T, int M>
__global__ void __launch_bounds__(kWideWarps * 32)
primal_wide(const __grid_constant__ Launch p) {
  extern __shared__ __align__(16) float smem[];
  const float* lam = lam_view(p, smem);
  const int lam_floats = p.lam_in_smem ? ((p.m * p.J + 3) & ~3) : 0;
  NoSink sink;
  walk_wide<T, typename OutType<T>::type, M, false>(p, lam, smem + lam_floats, sink);
}

// The requested rows of every bucket of width L <= 32, in one launch.
template <typename T, int M>
__global__ void __launch_bounds__(narrow_threads<M>(), 1)
rows_narrow(const __grid_constant__ Launch p) {
  extern __shared__ __align__(16) float smem[];
  RowsSink sink{p.plane};
  walk_narrow<T, float, M, true>(p, lam_view(p, smem), sink);
}

// The requested rows of one bucket of width 64 <= L <= 8192.
template <typename T, int M>
__global__ void __launch_bounds__(kWideWarps * 32)
rows_wide(const __grid_constant__ Launch p) {
  extern __shared__ __align__(16) float smem[];
  const float* lam = lam_view(p, smem);
  const int lam_floats = p.lam_in_smem ? ((p.m * p.J + 3) & ~3) : 0;
  RowsSink sink{p.plane};
  walk_wide<T, float, M, true>(p, lam, smem + lam_floats, sink);
}

struct RunPrimal {
  const Launch* p;
  LaunchShape shape;
  cudaStream_t stream;
  template <typename T, int M>
  cudaError_t run() {
    return shape.wide ? launch_kernel<primal_wide<T, M>>(*p, shape, stream)
                      : launch_kernel<primal_narrow<T, M>>(*p, shape, stream);
  }
};

struct RunRows {
  const Launch* p;
  LaunchShape shape;
  cudaStream_t stream;
  template <typename T, int M>
  cudaError_t run() {
    return shape.wide ? launch_kernel<rows_wide<T, M>>(*p, shape, stream)
                      : launch_kernel<rows_narrow<T, M>>(*p, shape, stream);
  }
};

struct InfoPrimal {
  bool wide;
  int threads;
  size_t smem;
  int* out;
  template <typename T, int M>
  cudaError_t run() {
    return wide ? kernel_info<primal_wide<T, M>>(threads, smem, out)
                : kernel_info<primal_narrow<T, M>>(threads, smem, out);
  }
};

struct InfoRows {
  bool wide;
  int threads;
  size_t smem;
  int* out;
  template <typename T, int M>
  cudaError_t run() {
    return wide ? kernel_info<rows_wide<T, M>>(threads, smem, out)
                : kernel_info<rows_narrow<T, M>>(threads, smem, out);
  }
};

// Launch fields the slab walk reads and the primal kernels set alike.
void primal_launch(Launch& p, const void* lam, int m, int J, float ginv, float radius,
                   int inequality) {
  p.lam = static_cast<const float*>(lam);
  p.m = m;
  p.J = J;
  p.ginv = ginv;
  p.radius = radius;
  p.inequality = inequality;
  p.acc = nullptr;
  p.scal = nullptr;
  p.qscale = 1.f;
  p.lane_q = nullptr;
  p.lane_ginv = nullptr;
  p.scal_lane_rows = 0;
  p.plane = 0;
}

}  // namespace

// What the compiler made of the primal kernel (see dual_oracle_info).
extern "C" int dual_primal_info(int dtype, int M, int wide, int threads, long long smem,
                                int* out) {
  InfoPrimal f{wide != 0, threads, static_cast<size_t>(smem), out};
  return static_cast<int>(visit(dtype, M, f));
}

// Runs one primal call of a Python plan (kernels/dual_primal.py): every
// launch of `launches` over the slabs of `slabs`, x written through `x`.
// Launches on `stream` without synchronising; returns the first CUDA error
// (0 on success).
extern "C" int dual_primal_run(const long long* slabs, int nslabs, const long long* launches,
                               int nlaunch, int dtype, int M, int m, int J, const void* lam,
                               const long long* x, float ginv, float radius, int inequality,
                               void* stream) {
  if (!valid_families(M, m) || J < 1 || nlaunch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch p;
  primal_launch(p, lam, m, J, ginv, radius, inequality);
  for (int l = 0; l < nlaunch; ++l) {
    RunPrimal f{&p, {}, static_cast<cudaStream_t>(stream)};
    if (!decode_launch(launches + static_cast<long long>(l) * kLaunchWords, slabs, nslabs, x,
                       p, f.shape)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int i = 0; i < p.nslab; ++i) {
      if (p.slab[i].rows != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = visit(dtype, M, f);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// What the compiler made of the row-list kernel (fp32 or bf16 slabs).
extern "C" int dual_primal_rows_info(int dtype, int M, int wide, int threads, long long smem,
                                     int* out) {
  InfoRows f{wide != 0, threads, static_cast<size_t>(smem), out};
  return static_cast<int>(visit_float(dtype, M, f));
}

// Runs one row-list call (kernels/dual_primal.py rows_call): every launch of
// `launches` over the slabs of `slabs`, each with its row list (word 10) and
// its output row count n (word 6); x (fp32) written through `x`, each slot's
// mask and idx `plane` and 2 * `plane` floats past its x.  fp32 and bf16
// slabs.  Launches on `stream` without synchronising; returns the first
// CUDA error (0 on success).
extern "C" int dual_primal_rows_run(const long long* slabs, int nslabs,
                                    const long long* launches, int nlaunch, int dtype, int M,
                                    int m, int J, const void* lam, const long long* x,
                                    long long plane, float ginv, float radius, int inequality,
                                    void* stream) {
  if (!valid_families(M, m) || J < 1 || nlaunch < 0 || plane < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Launch p;
  primal_launch(p, lam, m, J, ginv, radius, inequality);
  p.plane = plane;
  for (int l = 0; l < nlaunch; ++l) {
    RunRows f{&p, {}, static_cast<cudaStream_t>(stream)};
    if (!decode_launch(launches + static_cast<long long>(l) * kLaunchWords, slabs, nslabs, x,
                       p, f.shape)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int i = 0; i < p.nslab; ++i) {
      if (p.slab[i].rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err = visit_float(dtype, M, f);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
