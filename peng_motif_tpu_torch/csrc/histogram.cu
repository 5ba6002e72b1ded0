// Exact int32 histogram for Hopper (sm_90a): out[ids[i]] += 1 for every
// i with inc[i] != 0.
//
// Replaces peng_motif_tpu/ops/pallas_hist.py::histogram (the dispatcher)
// and its three Pallas kernels, mxu_histogram (_hist_kernel),
// mxu_histogram_sq (_hist_kernel_sq) and mxu_histogram_blocked
// (_hist_kernel_blocked).  Those recast the histogram as one-hot int8
// matmuls because the TPU vector unit has no scatter; their MACs scale
// with n_bins x N, which is why the TPU needed three table-size variants
// and lost to a plain scatter at 4**12.  Hopper has native integer
// atomics in shared memory and in L2, so one kernel serves every size:
//
//   * n_bins <= kSharedMaxBins (64 KB of int32: the background table,
//     <= 384 bins, and 4**W tables up to W = 7): each block keeps a
//     sub-histogram in dynamic shared memory, walks the input with a
//     grid-stride loop, atomically increments its sub-histogram, then
//     adds each non-zero bin to the output with one global atomic.
//   * larger tables (4**8 .. 4**12): one global atomicAdd per counted
//     id, grid-stride.  The 256 KB and 4 MB tables stay resident in the
//     50 MB L2; the 64 MB 4**12 table does not.
//
// What bounds it is atomic throughput and contention on hot bins, not
// arithmetic: the work is one 4-byte id and one 1-byte flag read per
// input (coalesced) plus one atomic per counted input.  Integer atomics
// commute, so the result is bit-identical to a bincount in any order.
// Ids of counted inputs must lie in [0, n_bins); a counted id outside
// that range is dropped rather than written out of bounds.  Counts are
// exact below 2**31.
//
// C interface (bound with ctypes): returns cudaGetLastError() right after
// the launch; the launch runs on `stream` and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kSharedMaxBins = 16384;

__global__ void hist_shared_kernel(const int32_t* __restrict__ ids,
                                   const uint8_t* __restrict__ inc,
                                   int64_t n, int32_t* __restrict__ out,
                                   int32_t n_bins) {
  extern __shared__ int32_t sub[];
  for (int32_t b = threadIdx.x; b < n_bins; b += blockDim.x) sub[b] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (inc[i]) {
      const uint32_t id = static_cast<uint32_t>(ids[i]);
      if (id < static_cast<uint32_t>(n_bins)) atomicAdd(&sub[id], 1);
    }
  }
  __syncthreads();
  for (int32_t b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const int32_t v = sub[b];
    if (v) atomicAdd(&out[b], v);
  }
}

__global__ void hist_global_kernel(const int32_t* __restrict__ ids,
                                   const uint8_t* __restrict__ inc,
                                   int64_t n, int32_t* __restrict__ out,
                                   int32_t n_bins) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (inc[i]) {
      const uint32_t id = static_cast<uint32_t>(ids[i]);
      if (id < static_cast<uint32_t>(n_bins)) atomicAdd(&out[id], 1);
    }
  }
}

}  // namespace

extern "C" int peng_histogram(const int32_t* ids, const uint8_t* inc,
                              int64_t n, int32_t* out, int32_t n_bins,
                              void* stream) {
  if (n <= 0 || n_bins <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (n + kThreads - 1) / kThreads;
  if (n_bins <= kSharedMaxBins) {
    const int smem = n_bins * static_cast<int>(sizeof(int32_t));
    err = cudaFuncSetAttribute(hist_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    // every block zeroes and flushes its whole sub-histogram: fewer,
    // longer-lived blocks for the larger tables
    const int64_t per_sm = smem <= 16384 ? 8 : 2;
    const int blocks = static_cast<int>(need < sms * per_sm ? need
                                                            : sms * per_sm);
    hist_shared_kernel<<<blocks, kThreads, smem, s>>>(ids, inc, n, out,
                                                      n_bins);
  } else {
    const int64_t cap = static_cast<int64_t>(sms) * 32;
    const int blocks = static_cast<int>(need < cap ? need : cap);
    hist_global_kernel<<<blocks, kThreads, 0, s>>>(ids, inc, n, out, n_bins);
  }
  return static_cast<int>(cudaGetLastError());
}
