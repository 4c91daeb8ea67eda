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
// One call projects every slab (bucket) of the unfused oracle's primal
// candidates: one `simplex_narrow` launch for every slab of width <= 32, one
// `simplex_wide` launch per wider slab, from a plan the Python side builds
// once per objective (kernels/simplex_proj.py).  The per-call v, mask and
// output pointers of up to kMaxSlabs slabs ride in the launch's by-value
// parameter block (__grid_constant__).
//
// Three forms of a row, one rounding contract (primal_common.cuh): the
// projection's x is bitwise the plain version's (kernels/ref.py simplex_ref)
// on the card, whatever form computes it.
//   * rows of L <= 16 (kRegLogL): one row per thread, in registers.  A row
//     of at most 16 bytes is read and written with one vector access; a
//     wider one passes through a per-warp stage in shared memory, so the
//     warp's global accesses stay contiguous 16-byte vectors.  The row is
//     sorted by a compare-exchange network with no shuffles (a sort's
//     output does not depend on its network), scanned in the Sklansky order
//     of simplex_segment (the order of PyTorch's CUDA cumsum along rows of
//     up to 32), and its feasibility sum taken in simplex_segment's
//     xor-butterfly pairwise tree, every product and sum rounded on its own
//     (no fused multiply-adds);
//   * rows of L = 32: a segment of one warp (simplex_segment: shuffle sort
//     and scan), which measured faster on the card than a 32-float row in
//     registers;
//   * rows of 64 <= L <= 8192: one warp per row, sorted and scanned in the
//     warp's two shared-memory rows (simplex_wide_cut / simplex_wide_apply).
//
// What bounds it: HBM bytes.  Each slot reads v and mask and writes out:
// 12 B at fp32, 6 B at bf16, against a few dozen fp32 operations.  Rows of
// L <= 32 are read once and written once; a register task issues the loads
// of its 32 rows before computing them, a warp-segment task those of
// kUnroll 32-slot groups.  The shuffle sort and scan of a warp segment cost
// about 23 warp shuffles per 32 slots, on the order of the byte bound at
// the main path's widths (8 and 16), which is why those widths take the
// register form.  The persistent grid is sized by the occupancy API for
// the instantiated kernel.

#include "primal_common.cuh"

namespace {

constexpr int kMaxWarps = 8;  // simplex_proj.py MAX_WARPS
constexpr int kRegLogL = 4;   // rows of L <= 16 in registers (REGISTER_MAX_WIDTH)
constexpr int kSlabWords3 = 4;                  // simplex_proj.py SLAB_WORDS
constexpr int kLaunchWords3 = 7 + kMaxSlabs;    // simplex_proj.py LAUNCH_WORDS

// One slab of a launch: the plan's shape and task offset, the call's
// pointers.
struct ProjSlab {
  const void* v;     // [n, L]
  const void* mask;  // [n, L], v's dtype
  void* out;         // [n, L], v's dtype
  long long n;       // rows
  long long task0;   // narrow: first warp task of this slab
  int logl;          // log2 of the width L
  int scan_chunk;    // wide rows: chunk of the cumsum order, <= L
};

// Everything one launch computes, passed by value (__grid_constant__).
struct ProjLaunch {
  ProjSlab slab[kMaxSlabs];
  int nslab;
  long long tasks;  // narrow: warp tasks over all slabs; wide: rows of slab[0]
  int stage_bytes;  // narrow: each warp's stage in shared memory
  float radius;
  int inequality;
};

// -- rows in registers -------------------------------------------------------

// A row of L elements of T as 32-bit words (rows of at least 4 bytes).
template <typename T, int L>
__host__ __device__ constexpr int row_words() {
  return L * static_cast<int>(sizeof(T)) / 4;
}

// Widens the words of a row to fp32: fp32 bits as they are, bf16 two a word
// with element 0 in the low half.
template <typename T, int L>
__device__ __forceinline__ void unpack_row(const uint32_t* w, float (&f)[L]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < L; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The words of a row of T from fp32, as unpack_row reads them.
template <typename T, int L>
__device__ __forceinline__ void pack_row(const float (&f)[L], uint32_t* w) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < L; ++i) w[i] = __float_as_uint(f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < L / 2; ++i) w[i] = bf16_bits(f[2 * i]) | (bf16_bits(f[2 * i + 1]) << 16);
  }
}

// The 16 bytes of a chunk as fp32 elements of T (4 fp32 or 8 bf16).
template <typename T>
__device__ __forceinline__ void chunk_floats(const uint4& q,
                                             float (&f)[16 / sizeof(T)]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  unpack_row<T, 16 / sizeof(T)>(w, f);
}

// A chunk of 16 bytes of T from fp32 elements, as chunk_floats reads it.
template <typename T>
__device__ __forceinline__ uint4 chunk_bits(const float (&f)[16 / sizeof(T)]) {
  uint32_t w[4];
  pack_row<T, 16 / sizeof(T)>(f, w);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Loads a row of at most 16 bytes from global memory with one vector load
// (16, 8 or 4 bytes; a single bf16 alone), widened to fp32.  The plan
// checks that every slab is aligned to min(16, L * sizeof(T)) bytes.
template <typename T, int L>
__device__ __forceinline__ void load_row(const T* src, float (&f)[L]) {
  constexpr int W = row_words<T, L>();
  if constexpr (W == 0) {
    f[0] = widen(src[0]);
  } else {
    uint32_t w[W];
    if constexpr (W == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(src));
      w[0] = q.x;
      w[1] = q.y;
      w[2] = q.z;
      w[3] = q.w;
    } else if constexpr (W == 2) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(src));
      w[0] = q.x;
      w[1] = q.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
    }
    unpack_row<T, L>(w, f);
  }
}

// Writes a row of at most 16 bytes as load_row reads it.
template <typename T, int L>
__device__ __forceinline__ void store_row(T* dst, const float (&f)[L]) {
  constexpr int W = row_words<T, L>();
  if constexpr (W == 0) {
    store(dst, f[0]);
  } else {
    uint32_t w[W];
    pack_row<T, L>(f, w);
    if constexpr (W == 4) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (W == 2) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<unsigned int*>(dst) = w[0];
    }
  }
}

// c[i] for a runtime i in [0, L), as a chain of selects over constant
// indices (no loop, so the compiler cannot turn it into an indexed load
// and move c out of registers).
template <int Q, int L>
__device__ __forceinline__ float pick(const float (&c)[L], int i, float r) {
  if constexpr (Q == L) {
    return r;
  } else {
    return pick<Q + 1, L>(c, i, i == Q ? c[Q] : r);
  }
}

// The cut of one row of L = 2^LOGL held in one thread's registers: u holds
// the masked candidates (kNeg where the mask is 0) and is sorted in place;
// t holds max(v, 0) * mask and is summed in place.  The pipeline of
// simplex_segment, each step in the same rounding order: a descending sort
// (compare-exchange network; its output does not depend on the network),
// the inclusive scan in Sklansky order, the count of the Duchi condition,
// theta, and the feasibility sum in the xor butterfly's pairwise tree.
// Every loop has a constant trip count and is unrolled, so every array
// index is a constant and the arrays stay in registers.
template <int LOGL>
__device__ __forceinline__ RowCut cut_registers(float (&u)[1 << LOGL], float (&t)[1 << LOGL],
                                                float radius, bool inequality) {
  constexpr int L = 1 << LOGL;
  RowCut cut;
  cut.feasible = false;
  if (inequality) {
#pragma unroll
    for (int b = LOGL - 1; b >= 0; --b) {
#pragma unroll
      for (int q = 0; q < (1 << b); ++q) t[q] = __fadd_rn(t[2 * q], t[2 * q + 1]);
    }
    cut.feasible = t[0] <= radius;
  }
#pragma unroll
  for (int a = 1; a <= LOGL; ++a) {
#pragma unroll
    for (int b = a - 1; b >= 0; --b) {
#pragma unroll
      for (int q = 0; q < L; ++q) {
        const int r = q ^ (1 << b);
        if (r > q) {
          const float x = u[q], y = u[r];
          const bool asc = (q & (1 << a)) != 0;
          u[q] = asc ? fminf(x, y) : fmaxf(x, y);
          u[r] = asc ? fmaxf(x, y) : fminf(x, y);
        }
      }
    }
  }
  // at step s each slot of the upper half of its 2s-block adds the last slot
  // of the lower half
  float css[L];
#pragma unroll
  for (int q = 0; q < L; ++q) css[q] = u[q];
#pragma unroll
  for (int b = 0; b < LOGL; ++b) {
    const int s = 1 << b;
#pragma unroll
    for (int q = 0; q < L; ++q) {
      if (q & s) css[q] = __fadd_rn(css[q], css[(q & ~(2 * s - 1)) + s - 1]);
    }
  }
  int cnt = 0;
#pragma unroll
  for (int q = 0; q < L; ++q) {
    cnt += __fmul_rn(u[q], static_cast<float>(q + 1)) > __fsub_rn(css[q], radius) ? 1 : 0;
  }
  const int rho = max(cnt, 1);
  cut.theta = __fdiv_rn(__fsub_rn(pick<1, L>(css, rho - 1, css[0]), radius),
                        static_cast<float>(rho));
  return cut;
}

// u and t of cut_registers from a row's candidates v and mask.
template <int L>
__device__ __forceinline__ void cut_inputs(const float (&v)[L], const float (&mk)[L],
                                           float (&u)[L], float (&t)[L]) {
#pragma unroll
  for (int q = 0; q < L; ++q) {
    u[q] = mk[q] > 0.f ? v[q] : kNeg;
    t[q] = __fmul_rn(fmaxf(v[q], 0.f), mk[q]);
  }
}

// One warp task of a register-form slab: 32 consecutive rows, one a
// thread, each projected in its thread's registers.  A row of at most 16
// bytes is read and written by its thread with one vector access (the
// warp's accesses are contiguous).  A wider row would make each of its
// thread's vector accesses skip the other rows, so the warp copies its 32
// rows of v and mask into its stage with contiguous 16-byte accesses, each
// thread reads its row from there (rows padded by 16 bytes: no bank
// conflicts), writes its projected row back over v's, and the warp copies
// the rows out with contiguous accesses.  A warp's stage holds v and mask,
// each [32 rows][row + 16 bytes] (simplex_proj.py stage_bytes).
template <typename T, int LOGL>
__device__ __forceinline__ void register_task(const ProjLaunch& p, const ProjSlab& b,
                                              long long task, unsigned char* stage) {
  constexpr int L = 1 << LOGL;
  constexpr int kRowBytes = L * static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31;
  const long long row0 = task * 32;
  const int rows = static_cast<int>(b.n - row0 < 32 ? b.n - row0 : 32);
  const T* v = static_cast<const T*>(b.v) + row0 * L;
  const T* mask = static_cast<const T*>(b.mask) + row0 * L;
  T* out = static_cast<T*>(b.out) + row0 * L;
  if constexpr (kRowBytes <= 16) {
    if (lane < rows) {
      float x[L], mk[L], u[L], t[L], w[L];
      load_row<T, L>(v + lane * L, x);
      load_row<T, L>(mask + lane * L, mk);
      cut_inputs<L>(x, mk, u, t);
      const RowCut cut = cut_registers<LOGL>(u, t, p.radius, p.inequality != 0);
#pragma unroll
      for (int q = 0; q < L; ++q) w[q] = simplex_wide_apply(x[q], mk[q], cut);
      store_row<T, L>(out + lane * L, w);
    }
  } else {
    constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks a row
    constexpr int kStride = kChunks + 1;     // a staged row, padded
    uint4* sv = reinterpret_cast<uint4*>(stage);
    uint4* sm = sv + 32 * kStride;
    const int chunks = rows * kChunks;
    uint4 qv[kChunks], qm[kChunks];
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = i * 32 + lane;
      if (c < chunks) {
        qv[i] = __ldg(reinterpret_cast<const uint4*>(v) + c);
        qm[i] = __ldg(reinterpret_cast<const uint4*>(mask) + c);
      }
    }
    __syncwarp();  // the warp's previous task is done with the stage
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = i * 32 + lane;
      if (c < chunks) {
        const int at = (c / kChunks) * kStride + c % kChunks;
        sv[at] = qv[i];
        sm[at] = qm[i];
      }
    }
    __syncwarp();
    // the cut from the staged row; then, past a warp barrier (which the
    // compiler does not move loads across), the row is read again for the
    // output, so v and mask need no registers while the row is sorted
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements a chunk
    RowCut cut;
    if (lane < rows) {
      float u[L], t[L];
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        float x[kPer], mk[kPer], ui[kPer], ti[kPer];
        chunk_floats<T>(sv[lane * kStride + i], x);
        chunk_floats<T>(sm[lane * kStride + i], mk);
        cut_inputs<kPer>(x, mk, ui, ti);
#pragma unroll
        for (int e = 0; e < kPer; ++e) u[i * kPer + e] = ui[e], t[i * kPer + e] = ti[e];
      }
      cut = cut_registers<LOGL>(u, t, p.radius, p.inequality != 0);
    }
    __syncwarp();
    if (lane < rows) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        float x[kPer], mk[kPer], w[kPer];
        chunk_floats<T>(sv[lane * kStride + i], x);
        chunk_floats<T>(sm[lane * kStride + i], mk);
#pragma unroll
        for (int e = 0; e < kPer; ++e) w[e] = simplex_wide_apply(x[e], mk[e], cut);
        sv[lane * kStride + i] = chunk_bits<T>(w);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = i * 32 + lane;
      if (c < chunks) {
        reinterpret_cast<uint4*>(out)[c] = sv[(c / kChunks) * kStride + c % kChunks];
      }
    }
  }
}

// One warp task of a segment-form slab: kUnroll groups of 32 consecutive
// slots, i.e. 32 / L whole rows a group, one per segment of L lanes.  All
// 32 lanes run it.
template <typename T, int LOGL>
__device__ __forceinline__ void segment_task(const ProjLaunch& p, const ProjSlab& b,
                                             long long task) {
  constexpr int L = 1 << LOGL;
  const T* v = static_cast<const T*>(b.v);
  const T* mask = static_cast<const T*>(b.mask);
  const int lane = threadIdx.x & 31;
  const int pos = lane & (L - 1);
  const long long slots = b.n << LOGL;
  const long long g0 = task * kUnroll;
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
    if (s < slots) store(static_cast<T*>(b.out) + s, w);
  }
}

// A slab of width 2^LOGL takes the register form up to 2^kRegLogL.
template <typename T, int LOGL>
__device__ __forceinline__ void proj_task(const ProjLaunch& p, const ProjSlab& b,
                                          long long task, unsigned char* stage) {
  if constexpr (LOGL <= kRegLogL) {
    register_task<T, LOGL>(p, b, task, stage);
  } else {
    segment_task<T, LOGL>(p, b, task);
  }
}

// Every slab of width L <= 32 of the call, in one launch: each warp takes
// warp tasks of all slabs in turn, the slabs one after another in task
// space (ProjSlab::task0, from the Python plan).
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
simplex_narrow(const __grid_constant__ ProjLaunch p) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem + (threadIdx.x >> 5) * p.stage_bytes;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long t = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
       t < p.tasks; t += warps) {
    int i = 0;
    while (i + 1 < p.nslab && t >= p.slab[i + 1].task0) ++i;
    const ProjSlab& b = p.slab[i];
    const long long task = t - b.task0;
    switch (b.logl) {
      case 0: proj_task<T, 0>(p, b, task, stage); break;
      case 1: proj_task<T, 1>(p, b, task, stage); break;
      case 2: proj_task<T, 2>(p, b, task, stage); break;
      case 3: proj_task<T, 3>(p, b, task, stage); break;
      case 4: proj_task<T, 4>(p, b, task, stage); break;
      default: proj_task<T, 5>(p, b, task, stage); break;
    }
  }
}

// One slab of width 64 <= L <= 8192: one warp per row, sorted and scanned
// in the warp's two shared-memory rows, then read again for the output.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
simplex_wide(const __grid_constant__ ProjLaunch p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ProjSlab& b = p.slab[0];
  const T* v = static_cast<const T*>(b.v);
  const T* mask = static_cast<const T*>(b.mask);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int L = 1 << b.logl;
  float* A = reinterpret_cast<float*>(smem) + 2 * warp * L;  // the sorted row
  float* C = A + L;                // its inclusive scan
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  for (long long row = static_cast<long long>(blockIdx.x) * warps + warp; row < b.n;
       row += stride) {
    const long long base = row * L;
    auto slot = [&](int q, float& vq, float& maskf) {
      vq = widen(v[base + q]);
      maskf = widen(mask[base + q]);
    };
    const RowCut cut = simplex_wide_cut(slot, A, C, L, b.scan_chunk, p.radius,
                                        p.inequality != 0);
    for (int q = lane; q < L; q += 32) {
      float vq, maskf;
      slot(q, vq, maskf);
      store(static_cast<T*>(b.out) + base + q, simplex_wide_apply(vq, maskf, cut));
    }
  }
}

// Calls f.template run<K>() for the instantiation of a dtype code (0 fp32,
// 1 bf16) and a wide flag.
template <typename F>
cudaError_t visit3(int dtype, bool wide, F& f) {
  if (dtype == 0) {
    return wide ? f.template run<simplex_wide<float>>() : f.template run<simplex_narrow<float>>();
  }
  if (dtype == 1) {
    return wide ? f.template run<simplex_wide<__nv_bfloat16>>()
                : f.template run<simplex_narrow<__nv_bfloat16>>();
  }
  return cudaErrorInvalidValue;
}

struct RunProj {
  const ProjLaunch* p;
  int grid, threads;
  size_t smem;
  cudaStream_t stream;
  template <auto K>
  cudaError_t run() {
    LaunchShape shape{false, grid, threads, smem};
    return launch_kernel<K>(*p, shape, stream);
  }
};

struct InfoProj {
  int threads;
  size_t smem;
  int* out;
  template <auto K>
  cudaError_t run() {
    return kernel_info<K>(threads, smem, out);
  }
};

}  // namespace

// What the compiler made of one instantiation and how many of its blocks
// fit on an SM: out = {max threads, registers, spill bytes, blocks per SM}.
extern "C" int simplex_proj_info(int dtype, int wide, int threads, long long smem, int* out) {
  InfoProj f{threads, static_cast<size_t>(smem), out};
  return static_cast<int>(visit3(dtype, wide != 0, f));
}

// Runs one call of a Python plan (kernels/simplex_proj.py): every launch of
// `launches` (kLaunchWords3 int64 each: wide, grid, threads, smem, tasks,
// stage bytes a warp, nslab, then the slab ids) over the slabs of `slabs` (kSlabWords3 int64
// each: n, L, task0, scan_chunk), with the call's v, mask and out pointers
// of each slab in `ptrs` (three a slab).  dtype: 0 fp32, 1 bf16.  Launches
// on `stream` without synchronising; returns the first CUDA error (0 on
// success).
extern "C" int simplex_proj_run(const long long* slabs, int nslabs, const long long* launches,
                                int nlaunch, const long long* ptrs, int dtype, float radius,
                                int inequality, void* stream) {
  if (nslabs < 0 || nlaunch < 0 || dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ProjLaunch p;
  p.radius = radius;
  p.inequality = inequality;
  for (int l = 0; l < nlaunch; ++l) {
    const long long* lw = launches + static_cast<long long>(l) * kLaunchWords3;
    const bool wide = lw[0] != 0;
    RunProj f{&p, static_cast<int>(lw[1]), static_cast<int>(lw[2]),
              static_cast<size_t>(lw[3]), static_cast<cudaStream_t>(stream)};
    p.tasks = lw[4];
    p.stage_bytes = static_cast<int>(lw[5]);
    p.nslab = static_cast<int>(lw[6]);
    if (f.grid < 1 || f.threads < 32 || f.threads > kMaxWarps * 32 || f.threads % 32 ||
        lw[3] < 0 || lw[3] > kMaxSmem || p.tasks < 0 || p.nslab < 1 || p.nslab > kMaxSlabs ||
        (wide && p.nslab != 1) || lw[5] < 0 || lw[5] % 16 ||
        lw[5] * (f.threads / 32) > lw[3]) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int i = 0; i < p.nslab; ++i) {
      const long long id = lw[7 + i];
      if (id < 0 || id >= nslabs) return static_cast<int>(cudaErrorInvalidValue);
      const long long* w = slabs + id * kSlabWords3;
      const long long L = w[1];
      if (w[0] < 0 || L < 1 || (L & (L - 1)) || L > 8192 || (L > 32) != wide) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      ProjSlab& s = p.slab[i];
      s.v = reinterpret_cast<const void*>(ptrs[3 * id]);
      s.mask = reinterpret_cast<const void*>(ptrs[3 * id + 1]);
      s.out = reinterpret_cast<void*>(ptrs[3 * id + 2]);
      s.n = w[0];
      s.task0 = w[2];
      s.scan_chunk = static_cast<int>(w[3]);
      s.logl = 0;
      while ((1LL << s.logl) < L) ++s.logl;
      if (wide && (s.scan_chunk < 32 || s.scan_chunk > L ||
                   (s.scan_chunk & (s.scan_chunk - 1)))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (wide && 2LL * (f.threads / 32) * L * 4 > static_cast<long long>(f.smem)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      const long long row_bytes = L * (dtype == 0 ? 4 : 2);  // a staged register row
      if (!wide && s.logl <= kRegLogL && row_bytes > 16 && 2 * 32 * (row_bytes + 16) > lw[5]) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    const cudaError_t err = visit3(dtype, wide, f);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}
