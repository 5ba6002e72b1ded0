// One round of saturated EM over the full 4**W count table, for every
// still-active motif at once (ops/em.py::em_optimize_flat on a CUDA
// device).  Two launches a round: em_round_kernel (the product, the odds,
// the responsibilities and their per-block marginals) and em_tail_kernel
// (the sum over blocks, the normalisation, the change, the freeze and the
// round's "any motif still active" flag).
//
// 1. What it replaces.  No Pallas kernel: the JAX package's
//    ops/em.py::em_optimize_flat leaves the round to XLA, and the port ran
//    it as torch code (ops/em.py::em_optimize_flat_plain, kept as the
//    plain version): W broadcast multiplies, three divisions and the
//    all-ones marginals (ops/flat_tables.all_marginals) over [A, 4**W]
//    f32 tables, A the active motifs.  That is W + 6 passes over A full
//    tables a round (at W = 12, A = 16: ~2 GB of device traffic), and
//    ~130 small launches plus a compaction of the active motifs at W = 10.
//
// 2. What bounds it on this card.  The bytes are 8 B an id (the count and
//    the background, read once for every motif), 134 MB at W = 12: 40 us
//    at 3.35 TB/s.  The arithmetic is larger: per id and motif W
//    multiplies, three IEEE divisions (each a reciprocal, its refinement
//    and a check) and the adds of the marginal, ~45 instructions, so at W
//    = 12 and 16 motifs ~1.2e10 instructions, ~0.4 ms at the card's
//    instruction rate.  At W = 10 the round is short enough that its two
//    launches and the host's read of the flag are most of it.
//
// 3. What the design does about it.
//      * One pass over the ids.  A block owns a tile of 4**6 consecutive
//        ids, a thread 16 of them (4**2), loaded once as float4 and kept
//        in registers while the block walks its group of (up to 32)
//        motifs; the group's PWMs sit in shared memory.  An inactive
//        motif is skipped by its flag: the shapes stay fixed from round
//        to round and nothing is compacted.
//      * The same arithmetic as the torch round, entry for entry: the
//        product is the left-to-right f32 multiply chain over positions
//        0..W-1 (the reference's recursive descent), then odds = prob /
//        bg and r = (count * s) / (s / odds + 1), each a correctly
//        rounded __fmul_rn / __fdiv_rn / __fadd_rn (no fast math, no
//        contraction), so every r is the torch round's bit for bit.
//      * Marginals without a [W, 4] array indexed per id.  Digits 0-1 of
//        an id vary inside a thread's 16 ids in a fixed pattern (register
//        accumulators with constant indices), digits 2-5 are the thread's
//        index within the tile and digits 6.. the tile's index: each
//        thread adds its 16 r into 8 accumulators, and the rest follows
//        from the thread's total by which lane, warp and block hold it.
//        Warp shuffles reduce each motif's values (17 a warp), warps
//        combine in shared memory, and every block writes 25 partials a
//        motif (positions 0-5, and its tile total).
//      * No float atomics.  The tail sums the blocks' partials in an order
//        fixed by W and the number of motifs alone (one block a motif),
//        so the same call gives the same bits on every run and card;
//        the sums run in another order than the torch round's, so the
//        PWMs agree with it within rounding (5e-6), not bit for bit.
//      * The tail keeps the torch round's sequential f32 semantics: the
//        row sum ((a0 + a1) + a2) + a3, the normalisation by division,
//        the change as a fold in (p, a) order, the freeze of finished
//        motifs, active = (change > thr) & (iters < max_iterations); a 0/0
//        row gives NaN, which stops the motif.  The flag "any motif still
//        active" is an integer OR (exact in any order); the host reads
//        it once a round.
//
// C interface (bound with ctypes): peng_em_round launches both kernels on
// `stream` and returns the first CUDA error met (cudaGetLastError() right
// after each launch); it does not synchronise and allocates nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 4**4 threads a tile
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;         // 4**2 ids a thread
constexpr int kTileDigits = 6;     // 4**6 ids a tile
constexpr int kGroup = 32;         // motifs a block walks
constexpr int kMaxW = 16;
constexpr int kPart = 25;          // a block's partials a motif
constexpr int kWarpVals = 18;      // a warp's values a motif, see below
constexpr int kMaxHi = kMaxW - 10; // tail: positions held in the loop index

constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float shfl(float x, int mask) {
  return __shfl_xor_sync(kAll, x, mask);
}

// x[0..7] on every lane; returns, on lane l, the warp's total of x[v]
// with v = (l >> 2) & 7: three halving exchanges, then two plain ones.
__device__ __forceinline__ float warp_sum8(const float (&x)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    y[i] = __fadd_rn(b4 ? x[4 + i] : x[i], shfl(b4 ? x[i] : x[4 + i], 16));
  float z[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    z[i] = __fadd_rn(b3 ? y[2 + i] : y[i], shfl(b3 ? y[i] : y[2 + i], 8));
  float w = __fadd_rn(b2 ? z[1] : z[0], shfl(b2 ? z[0] : z[1], 4));
  w = __fadd_rn(w, shfl(w, 2));
  return __fadd_rn(w, shfl(w, 1));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) x = __fadd_rn(x, shfl(x, m));
  return x;
}

// grid (tiles, motif groups).  part[(m * tiles + tile) * kPart + c]: c =
// 4 p + d for positions p < 6 (sum of r over the tile's ids with digit_p
// == d), c = 24 the tile's total.  Full: every id of the tile exists (W >=
// 6); else ids >= n count nothing.
template <bool Full>
__global__ void __launch_bounds__(kThreads, 2)
    em_round_kernel(const float* __restrict__ counts,
                    const float* __restrict__ bg,
                    const float* __restrict__ pwm,
                    const uint8_t* __restrict__ active, int32_t n_motifs,
                    int32_t width, float s, float* __restrict__ part,
                    int32_t* __restrict__ any) {
  __shared__ float spwm[kGroup][kMaxW * 4];
  __shared__ float swarp[kWarps][kGroup][kWarpVals];
  __shared__ uint8_t sact[kGroup];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kGroup;
  const int nm = min(kGroup, n_motifs - m0);
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) *any = 0;
  for (int i = tid; i < nm * width * 4; i += kThreads)
    spwm[i / (width * 4)][i % (width * 4)] =
        pwm[static_cast<int64_t>(m0) * width * 4 + i];
  int live = 0;
  for (int a = 0; a < nm; ++a) live |= active[m0 + a];
  if (tid < nm) sact[tid] = active[m0 + tid];
  if (!live) return;  // uniform: every thread read the same flags
  __syncthreads();

  const int64_t n = int64_t{1} << (2 * width);
  const int ci = blockIdx.x * kThreads + tid;  // id >> 4 of the chunk
  const int64_t base = static_cast<int64_t>(ci) * kChunk;
  float cs[kChunk], bgv[kChunk];
  if (Full) {
    const float4* c4 = reinterpret_cast<const float4*>(counts + base);
    const float4* b4 = reinterpret_cast<const float4*>(bg + base);
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const float4 c = __ldg(c4 + q), b = __ldg(b4 + q);
      cs[4 * q] = c.x; cs[4 * q + 1] = c.y; cs[4 * q + 2] = c.z;
      cs[4 * q + 3] = c.w;
      bgv[4 * q] = b.x; bgv[4 * q + 1] = b.y; bgv[4 * q + 2] = b.z;
      bgv[4 * q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool in = base + j < n;
      cs[j] = in ? counts[base + j] : 0.f;
      bgv[j] = in ? bg[base + j] : 1.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kChunk; ++j) cs[j] = __fmul_rn(cs[j], s);

  for (int a = 0; a < nm; ++a) {
    if (!sact[a]) continue;  // uniform
    const float* P = spwm[a];
    float prob[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) prob[j] = P[j & 3];  // 1 * pwm[0][d0]
    if (width > 1) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        prob[j] = __fmul_rn(prob[j], P[4 + (j >> 2)]);
    }
    for (int p = 2; p < width; ++p) {
      const float h = P[4 * p + ((ci >> (2 * p - 4)) & 3)];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) prob[j] = __fmul_rn(prob[j], h);
    }
    // x[d] += r of the ids with digit_0 == d, x[4 + d] with digit_1 == d
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const float odds = __fdiv_rn(prob[j], bgv[j]);
      float r = __fdiv_rn(cs[j], __fadd_rn(__fdiv_rn(s, odds), 1.f));
      if (!Full && base + j >= n) r = 0.f;
      x[j & 3] = __fadd_rn(x[j & 3], r);
      x[4 + (j >> 2)] = __fadd_rn(x[4 + (j >> 2)], r);
    }
    const float v = __fadd_rn(__fadd_rn(__fadd_rn(x[0], x[1]), x[2]), x[3]);
    const float t8 = warp_sum8(x, lane);
    // lanes sharing bits 0-1 (digit 2), bits 2-3 (digit 3), bit 4 (the
    // low bit of digit 4)
    float s2 = __fadd_rn(v, shfl(v, 4));
    s2 = __fadd_rn(s2, shfl(s2, 8));
    s2 = __fadd_rn(s2, shfl(s2, 16));
    float t12 = __fadd_rn(v, shfl(v, 1));
    t12 = __fadd_rn(t12, shfl(t12, 2));
    const float s3 = __fadd_rn(t12, shfl(t12, 16));
    float h = __fadd_rn(t12, shfl(t12, 4));
    h = __fadd_rn(h, shfl(h, 8));
    // swarp: [0, 8) the totals of x, [8, 12) digit 2, [12, 16) digit 3,
    // [16, 18) the two halves of the warp (bit 4 of the lane)
    float* out = swarp[warp][a];
    if ((lane & 3) == 0) out[lane >> 2] = t8;
    if (lane < 4) out[8 + lane] = s2;
    if ((lane & 3) == 0 && lane < 16) out[12 + (lane >> 2)] = s3;
    if ((lane & 15) == 0) out[16 + (lane >> 4)] = h;
  }
  __syncthreads();

  // digits 4 and 5 of the thread index: digit 4 = lane bit 4 + 2 * (warp
  // bit 0), digit 5 = warp >> 1
  const int64_t tiles = gridDim.x;
  for (int i = tid; i < nm * kPart; i += kThreads) {
    const int a = i / kPart, c = i % kPart;
    if (!sact[a]) continue;
    float acc = 0.f;
    if (c < 16) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, swarp[w][a][c]);
    } else if (c < 20) {
      const int d = c - 16;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if ((w & 1) == (d >> 1))
          acc = __fadd_rn(acc, swarp[w][a][16 + (d & 1)]);
    } else {
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (c == 24 || (w >> 1) == c - 20)
          acc = __fadd_rn(acc, __fadd_rn(swarp[w][a][16], swarp[w][a][17]));
    }
    part[(static_cast<int64_t>(m0 + a) * tiles + blockIdx.x) * kPart + c] =
        acc;
  }
}

// One block a motif slot.  Sums the tiles' partials into the new [W, 4]
// marginal, normalises it, and updates the motif's pwm, change, iters and
// active; ORs 1 into *any while the motif goes on.  Tile b's thread is b
// % kThreads, so digits 6-9 of the ids (digits 0-3 of b) are the thread's
// own, and digits 10.. (of b / kThreads) vary along its loop.
__global__ void __launch_bounds__(kThreads)
    em_tail_kernel(const float* __restrict__ part, float* __restrict__ pwm,
                   float* __restrict__ change, int32_t* __restrict__ iters,
                   uint8_t* __restrict__ active, int32_t width, float thr,
                   int32_t max_iterations, int64_t tiles,
                   int32_t* __restrict__ any) {
  __shared__ float swarp[kWarps][24 + 4 * kMaxHi];
  __shared__ float stot[kThreads];
  __shared__ float snew[kMaxW * 4];
  const int m = blockIdx.x;
  if (!active[m]) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* P = part + static_cast<int64_t>(m) * tiles * kPart;

  float lo[24], hi[kMaxHi][4], tot = 0.f;
#pragma unroll
  for (int c = 0; c < 24; ++c) lo[c] = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxHi; ++q)
#pragma unroll
    for (int d = 0; d < 4; ++d) hi[q][d] = 0.f;
  int64_t i = 0;
  for (int64_t b = tid; b < tiles; b += kThreads, ++i) {
    const float* q = P + b * kPart;
#pragma unroll
    for (int c = 0; c < 24; ++c) lo[c] = __fadd_rn(lo[c], q[c]);
    const float t = q[24];
    tot = __fadd_rn(tot, t);
#pragma unroll
    for (int h = 0; h < kMaxHi; ++h) {
      if (10 + h < width) {
        const int dig = static_cast<int>((i >> (2 * h)) & 3);
#pragma unroll
        for (int d = 0; d < 4; ++d)
          hi[h][d] = __fadd_rn(hi[h][d], dig == d ? t : 0.f);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 24; ++c) {
    const float x = warp_sum(lo[c]);
    if (lane == 0) swarp[warp][c] = x;
  }
#pragma unroll
  for (int h = 0; h < kMaxHi; ++h) {
    if (10 + h < width) {
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const float x = warp_sum(hi[h][d]);
        if (lane == 0) swarp[warp][24 + 4 * h + d] = x;
      }
    }
  }
  stot[tid] = tot;
  __syncthreads();

  if (tid < 4 * width) {
    const int p = tid >> 2, d = tid & 3;
    float acc = 0.f;
    if (p < kTileDigits) {
      for (int w = 0; w < kWarps; ++w) acc = __fadd_rn(acc, swarp[w][tid]);
    } else if (p < 10) {
      const int sh = 2 * (p - kTileDigits);
      for (int t = 0; t < kThreads; ++t)
        if (((t >> sh) & 3) == d) acc = __fadd_rn(acc, stot[t]);
    } else {
      for (int w = 0; w < kWarps; ++w)
        acc = __fadd_rn(acc, swarp[w][24 + 4 * (p - 10) + d]);
    }
    snew[tid] = acc;
  }
  __syncthreads();

  if (tid == 0) {
    float* row = pwm + static_cast<int64_t>(m) * width * 4;
    float ch = 0.f;
    for (int p = 0; p < width; ++p) {
      const float* n4 = snew + 4 * p;
      const float rs =
          __fadd_rn(__fadd_rn(__fadd_rn(n4[0], n4[1]), n4[2]), n4[3]);
      for (int d = 0; d < 4; ++d) {
        const float nv = __fdiv_rn(n4[d], rs);
        ch = __fadd_rn(ch, fabsf(__fsub_rn(nv, row[4 * p + d])));
        row[4 * p + d] = nv;
      }
    }
    const int32_t it = iters[m] + 1;
    const bool go = ch > thr && it < max_iterations;
    change[m] = ch;
    iters[m] = it;
    active[m] = go;
    if (go) atomicOr(any, 1);
  }
}

}  // namespace

// One EM round over the motif slots [0, n_motifs): counts and bg are f32
// [4**width] (16-byte aligned), pwm f32 [n_motifs, width, 4], change f32
// and iters int32 [n_motifs], active uint8 [n_motifs] (updated in place),
// any int32 [1] (1 after the round iff a motif goes on), part f32 scratch
// of n_motifs * max(1, 4**(width - 6)) * 25.
extern "C" int peng_em_round(const float* counts, const float* bg,
                             float* pwm, float* change, int32_t* iters,
                             uint8_t* active, int32_t* any, float* part,
                             int32_t n_motifs, int32_t width, float s,
                             float thr, int32_t max_iterations,
                             void* stream) {
  if (n_motifs <= 0) return static_cast<int>(cudaSuccess);
  if (width < 1 || width > kMaxW)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool full = width >= kTileDigits;
  const int64_t tiles =
      full ? int64_t{1} << (2 * (width - kTileDigits)) : 1;
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((n_motifs + kGroup - 1) / kGroup));
  if (full)
    em_round_kernel<true><<<grid, kThreads, 0, st>>>(
        counts, bg, pwm, active, n_motifs, width, s, part, any);
  else
    em_round_kernel<false><<<grid, kThreads, 0, st>>>(
        counts, bg, pwm, active, n_motifs, width, s, part, any);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  em_tail_kernel<<<n_motifs, kThreads, 0, st>>>(
      part, pwm, change, iters, active, width, thr, max_iterations, tiles,
      any);
  return static_cast<int>(cudaGetLastError());
}
