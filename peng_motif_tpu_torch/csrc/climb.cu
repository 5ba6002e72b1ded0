// The climb's mutant aggregates (ops/climb.walks_program on a CUDA device):
// for every active walk s and every candidate c = p * 10 + j (position p,
// the j-th letter similar to the walk's letter there), the sums of the
// count, expected and background tables over the k-mers the mutant's IUPAC
// mask set matches.  One launch a lockstep step.
//
// 1. What it replaces.  No Pallas kernel: the JAX package's
//    ops/climb.walks_program leaves the step to XLA, and the port ran it as
//    torch code (kept as the CPU path): a dense bilinear contraction of the
//    whole [3, 4**W] table against S * 26 mask vectors a step (131 GFLOP
//    at W = 12 and 50 walks, stopped walks included) and ~350 small
//    kernels, most of the step's time and of its CUDA graph's capture.
//
// 2. What bounds it on this card.  A mutant's aggregate reads only the ids
//    its mask set matches: S(M) + S(rc M) - S(M & rc M) over the table
//    masked to canonical ids (id <= revcomp(id)) under both strands, S(M)
//    on the plus strand.  On MafK the walks' sets hold 1 to 131,072 ids
//    (|M| at W = 12; a step's candidates read ~300 |M| ids), so a step
//    reads from ~10^4 to ~4 x 10^7 table rows of 16 B (32 B wide): the
//    heavy steps are bound by gathers from HBM (the 4**12 table, 268 MB,
//    does not fit the 50-MB L2), the light ones by the launch and the
//    block set-up.
//
// 3. What the design does about it.
//      * One block a candidate (grid: 10 W candidates x S walks).  A set of
//        size 2**b is enumerated by index: IUPAC masks hold 1, 2 or 4
//        letters and their intersections 0, 1, 2 or 4, so an index's bits
//        map to id steps linearly (a 2-letter position one bit, an N two),
//        and a thread's ids follow a Gray code over the high index bits:
//        one add a k-mer, four gathers in flight a thread.
//      * The table is one [4**W, 4] row array (count, expected, bg, 0):
//        one 16-B load a k-mer.  The canonical mask is tested in the
//        kernel (revcomp by bit reversal), so no mask table is uploaded.
//      * A walk that stopped (its device flag is 0) is skipped and its rows
//        are left as they are: its digits no longer change, so they hold
//        its aggregates already.  Shapes, grid and buffers are fixed, no
//        allocation and no host sync: the step stays one CUDA graph.
//      * Sums in a tree order fixed by W alone: each thread folds its
//        ids in Gray order, warps reduce by butterfly, then the warps in
//        index order; no float atomics, so two calls give the same bits.
//        Upstream's order (a sequential fold in ascending canonical id)
//        drifts ~4e-6 relative from the exact sum on sets of thousands;
//        this order stays ~1e-7 from it, as the torch contraction does.
//        Counts are exact integers (f32 below 2**24, f64 when wide).
//
// C interface (bound with ctypes): peng_climb_aggregates launches the
// kernel on `stream` and returns the CUDA error of the launch; it does not
// synchronise and allocates nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // a block: one candidate
constexpr int kWarps = kThreads / 32;
constexpr int kThreadBits = 8;         // log2(kThreads)
constexpr int kMaxW = 16;              // ids fit 32 bits
constexpr int kSim = 10;               // candidate slots a position
constexpr int kLetterCols = 1 + kSim;  // letters[l]: mask, similar letters
constexpr int kUnroll = 4;             // gathers in flight a thread

constexpr unsigned kAll = 0xffffffffu;

// A product set of ids: index i (b bits) maps to base + sum of step[k] over
// the set bits k of i.  bits < 0: the set is empty.
struct Set {
  uint32_t base;
  int bits;
  uint32_t step[2 * kMaxW];
};

template <typename T>
struct Row {
  T c, e, b;
};

__device__ __forceinline__ Row<float> load(const float* t, uint32_t id) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(t) + id);
  return {v.x, v.y, v.z};
}

__device__ __forceinline__ Row<double> load(const double* t, uint32_t id) {
  const double2* p = reinterpret_cast<const double2*>(t) + 2 * size_t{id};
  const double2 a = __ldg(p), b = __ldg(p + 1);
  return {a.x, a.y, b.x};
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// the complement of a 4-bit letter mask (base d -> 3 - d)
__device__ __forceinline__ int complement(int m) {
  return ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3);
}

// the reverse complement of a width-digit id (2 bits a digit, digit 0 low)
__device__ __forceinline__ uint32_t revcomp(uint32_t id, int width) {
  uint32_t y = __brev(~id);
  y = ((y >> 1) & 0x55555555u) | ((y & 0x55555555u) << 1);
  return y >> (32 - 2 * width);
}

__device__ void make_set(const int* masks, int width, Set& s) {
  s.base = 0;
  s.bits = 0;
  for (int p = 0; p < width; ++p) {
    const uint32_t m = masks[p], pw = 1u << (2 * p);
    const int n = __popc(m);
    if (n == 0) {
      s.bits = -1;
      return;
    }
    const int lo = __ffs(m) - 1;
    s.base += lo * pw;
    if (n == 2) {
      s.step[s.bits++] = (31 - __clz(m) - lo) * pw;
    } else if (n == 4) {
      s.step[s.bits++] = pw;
      s.step[s.bits++] = 2 * pw;
    }
  }
}

// This thread's share of the set's sums: index tid + kThreads * gray(i)
// for every i (tid < 2**bits where the set is smaller than the block);
// under both strands only canonical ids count.  Returns the rows read.
template <typename T>
__device__ uint32_t sum_set(const T* __restrict__ table, const Set& s,
                            int width, bool canonical, int tid, T* acc) {
  acc[0] = acc[1] = acc[2] = T(0);
  if (s.bits < 0) return 0;
  const int lb = min(s.bits, kThreadBits);
  if (tid >= (1 << lb)) return 0;
  uint32_t reads = 0;
  uint32_t id = s.base;
  for (int k = 0; k < lb; ++k)
    if ((tid >> k) & 1) id += s.step[k];
  const uint32_t* hi = s.step + lb;
  const int64_t n = int64_t{1} << (s.bits - lb);
  for (int64_t i0 = 0; i0 < n; i0 += kUnroll) {
    uint32_t ids[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u;
      in[u] = i < n;
      if (i > 0 && in[u]) {
        // gray(i) and gray(i - 1) differ in bit k = ctz(i), which turns on
        // where bit k + 1 of i is 0
        const int k = __ffsll(i) - 1;
        id = ((i >> (k + 1)) & 1) ? id - hi[k] : id + hi[k];
      }
      ids[u] = id;
      in[u] = in[u] && (!canonical || id <= revcomp(id, width));
    }
    Row<T> r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (in[u]) r[u] = load(table, ids[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (in[u]) {
        acc[0] = add(acc[0], r[u].c);
        acc[1] = add(acc[1], r[u].e);
        acc[2] = add(acc[2], r[u].b);
        ++reads;
      }
    }
  }
  return reads;
}

// grid (10 W candidates, S walks), one block a candidate.  agg[s][g][c]:
// g = 0 counts, 1 expected, 2 background.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    climb_agg_kernel(const T* __restrict__ table,
                     const int64_t* __restrict__ digits,
                     const uint8_t* __restrict__ active,
                     const int32_t* __restrict__ letters, T* __restrict__ agg,
                     unsigned long long* __restrict__ ids, int width,
                     bool both) {
  __shared__ int masks[3][kMaxW];
  __shared__ Set sets[3];
  __shared__ T part[kWarps][9];
  const int c = blockIdx.x, s = blockIdx.y, n_cand = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (!active[s]) return;  // uniform
  const int p = c / kSim;
  const int64_t* dg = digits + static_cast<int64_t>(s) * width;
  const int letter = letters[dg[p] * kLetterCols + 1 + c % kSim];
  T* out = agg + static_cast<int64_t>(s) * 3 * n_cand + c;
  if (letter < 0) {  // uniform: a padding slot, never a candidate
    if (tid < 3) out[tid * n_cand] = T(0);
    return;
  }
  // the mutant's masks (set 0), their reverse complement (set 1) and the
  // intersection of the two (set 2)
  if (tid < width)
    masks[0][tid] = letters[(tid == p ? letter : dg[tid]) * kLetterCols];
  __syncthreads();
  if (both && tid < width) {
    const int rc = complement(masks[0][width - 1 - tid]);
    masks[1][tid] = rc;
    masks[2][tid] = masks[0][tid] & rc;
  }
  __syncthreads();
  const int n_sets = both ? 3 : 1;
  if (tid < n_sets) make_set(masks[tid], width, sets[tid]);
  __syncthreads();

  T v[9];
  uint32_t reads = 0;
  for (int k = 0; k < n_sets; ++k)
    reads += sum_set(table, sets[k], width, both, tid, v + 3 * k);
  reads = __reduce_add_sync(kAll, reads);
  if (lane == 0 && reads)
    atomicAdd(ids, static_cast<unsigned long long>(reads));
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if (k < 3 * n_sets) {
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1)
        v[k] = add(v[k], __shfl_xor_sync(kAll, v[k], m));
      if (lane == 0) part[warp][k] = v[k];
    }
  }
  __syncthreads();
  if (tid < 3) {
    T tot[3];
    for (int k = 0; k < n_sets; ++k) {
      T x = part[0][3 * k + tid];
      for (int w = 1; w < kWarps; ++w) x = add(x, part[w][3 * k + tid]);
      tot[k] = x;
    }
    out[tid * n_cand] = both ? sub(add(tot[0], tot[1]), tot[2]) : tot[0];
  }
}

}  // namespace

// The aggregates of every active walk's candidates: table [4**width, 4]
// rows (count, expected, background, 0), f32 or f64 (wide), 16-byte
// aligned; digits int64 [n_walks, width]; active uint8 [n_walks]; letters
// int32 [11, 11] (each letter's 4-bit base mask, then its similar letters,
// -1 padded); agg [n_walks, 3, 10 * width] in the table's type (rows of
// inactive walks untouched); ids uint64 [1] (adds the rows read).
extern "C" int peng_climb_aggregates(const void* table, const int64_t* digits,
                                     const uint8_t* active,
                                     const int32_t* letters, void* agg,
                                     unsigned long long* ids,
                                     int32_t n_walks, int32_t width,
                                     int32_t both, int32_t wide,
                                     void* stream) {
  if (n_walks <= 0) return static_cast<int>(cudaSuccess);
  if (width < 1 || width > kMaxW || n_walks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(width * kSim),
                  static_cast<unsigned>(n_walks));
  if (wide)
    climb_agg_kernel<double><<<grid, kThreads, 0, st>>>(
        static_cast<const double*>(table), digits, active, letters,
        static_cast<double*>(agg), ids, width, both != 0);
  else
    climb_agg_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(table), digits, active, letters,
        static_cast<float*>(agg), ids, width, both != 0);
  return static_cast<int>(cudaGetLastError());
}
