// Exact int32 histogram for Hopper (sm_90a): out[ids[i]] += 1 for every
// i with inc[i] != 0.  The kernels add into `out`; the caller zeroes it
// (or hands in a running table).
//
// 1. What it replaces.  peng_motif_tpu/ops/pallas_hist.py::histogram (the
//    dispatcher) and its three Pallas kernels: mxu_histogram
//    (_hist_kernel; background table and 4**W tables held in VMEM),
//    mxu_histogram_sq (_hist_kernel_sq; 4**9 and 4**10 as a square of
//    hi/lo digits) and mxu_histogram_blocked (_hist_kernel_blocked; any
//    128-aligned table, 4**12).  Those recast the histogram as one-hot
//    int8 matmuls because the TPU vector unit has no scatter.  Tensor
//    cores are not used here: the one-hot products cost n_bins x N MACs,
//    which at 384 bins is inside the card's int8 rate but needs a one-hot
//    operand built per input, dearer than the shared-memory atomic it
//    would replace, and at 4**8 bins and up is hopeless.
//
// 2. What bounds it on this card.  Bytes: 4 B of id and 1 B of flag per
//    input, read once, plus 4 B per bin written once; no arithmetic to
//    speak of.  On top of the bytes, one integer atomic per counted
//    input, and where that atomic lands decides the tier:
//      * in shared memory (232,448 B a block, 58,112 bins) the atomics
//        keep up with the loads, also when every input hits one bin, and
//        only the non-zero bins of each block reach L2, once, at the
//        flush: such a launch runs at the memory rate;
//      * in L2 (50 MB) one reduction per counted input is what the L2
//        atomic units take, not what the bytes allow: the pace is theirs
//        whatever the loads do, and atomics on one address serialise;
//      * a table larger than L2 (4**12: 64 MB) turns every atomic into a
//        read-modify-write of a DRAM sector, several times the input's
//        bytes.
//
// 3. What the design does about it.
//      * Loads (both tiers): a persistent grid of 1,024-thread blocks,
//        one per SM.  Each thread loads 16 B of ids (int4) and 4 B of
//        flags per step and starts the loads of kUnroll steps before the
//        first atomic, so kUnroll x 20 B are in flight per thread.  The
//        loads carry the streaming hint (ld.global.cs), so the input
//        does not push the table out of L2.  The host aligns: a scalar
//        head brings `ids` to 16 B; the flags then sit on 4 B only if
//        both pointers share their element offset modulo 4, else the
//        whole input takes the scalar loop (nothing is copied).  The
//        ragged tail is scalar too.  Ids of masked inputs are loaded but
//        never compared or used as an address.
//      * Shared tier (hist_shared_kernel): a sub-histogram per block in
//        dynamic shared memory.  A table over the shared limit (4**8,
//        4**9) is cut into slices: block b holds slice b % slices, and
//        the blocks of one slice read the whole input between them.  The
//        input is read once per slice, but neighbouring blocks read the
//        same part at the same time, so all but the first read come from
//        L2, and no atomic leaves the SM.  The dispatcher
//        (ops/histogram.py) stops at the slice count where the SMs'
//        own load rate would cost more than the L2 atomics.
//      * L2 tier (hist_l2_kernel): one reduction (the atomic's result is
//        unused) per counted id of the launch's bin range.  A table over
//        the L2 budget is counted in bin-range passes, one launch each,
//        chosen by the dispatcher: the input is read once per pass and
//        the pass's slice of the table stays in L2.
//    Integer sums commute, so every tier and any split into slices or
//    passes is bit-identical to a bincount.  A counted id outside
//    [0, n_bins) is dropped, never written out of bounds.  Counts are
//    exact below 2**31.
//
// C interface (bound with ctypes): peng_histogram launches one kernel on
// `stream` and returns the first CUDA error met (cudaGetLastError()
// right after the launch); it does not synchronise and allocates
// nothing.  The attributes of the device and of the kernels are read
// once per process and device.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kSharedLimit = 232448;     // bytes a block may have on sm_90
constexpr int kMaxDevices = 64;

enum Tier : int32_t { kTierShared = 0, kTierL2 = 1 };

template <typename Emit>
__device__ __forceinline__ void emit4(const int4& a, uint32_t m,
                                      const Emit& emit) {
  if (m & 0x000000ffu) emit(a.x);
  if (m & 0x0000ff00u) emit(a.y);
  if (m & 0x00ff0000u) emit(a.z);
  if (m & 0xff000000u) emit(a.w);
}

// Calls emit(id) for every counted input, `parts` blocks sharing the
// input (this block is number `part` of them).  [head, head + 4 * nvec)
// goes in 16-byte steps; [0, head) and the last (n - head) % 4 inputs go
// one by one.  head == n (set by the host where the flags cannot be read
// as words) makes everything scalar.
template <typename Emit>
__device__ __forceinline__ void walk(const int32_t* __restrict__ ids,
                                     const uint8_t* __restrict__ inc,
                                     int64_t n, int64_t head, unsigned part,
                                     unsigned parts, const Emit& emit) {
  const int64_t nt = static_cast<int64_t>(parts) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(part) * blockDim.x + threadIdx.x;
  const int64_t nvec = (n - head) >> 2;
  const int4* idv = reinterpret_cast<const int4*>(ids + head);
  const uint32_t* incv = reinterpret_cast<const uint32_t*>(inc + head);
  int64_t g = tid;
  for (; g + (kUnroll - 1) * nt < nvec; g += kUnroll * nt) {
    int4 a[kUnroll];
    uint32_t m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = __ldcs(idv + g + u * nt);
      m[u] = __ldcs(incv + g + u * nt);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) emit4(a[u], m[u], emit);
  }
  for (; g < nvec; g += nt) emit4(__ldcs(idv + g), __ldcs(incv + g), emit);
  const int64_t tail = n - head - (nvec << 2);
  for (int64_t j = tid; j < head + tail; j += nt) {
    const int64_t i = j < head ? j : n - tail + (j - head);
    if (inc[i]) emit(ids[i]);
  }
}

// id counts iff bin_lo <= id < bin_lo + width, into base[id - bin_lo]; in
// unsigned arithmetic a negative id lands far above any width.
struct EmitRange {
  int32_t* base;
  uint32_t bin_lo, width;
  __device__ __forceinline__ void operator()(int32_t id) const {
    const uint32_t u = static_cast<uint32_t>(id) - bin_lo;
    if (u < width) atomicAdd(base + u, 1);
  }
};

// The bin range [bin_lo, bin_hi) is cut into `slices` equal slices; block
// b holds slice b % slices, and the blocks of one slice share the input
// among them, so every slice sees every input.
__global__ void __launch_bounds__(kThreads, 1)
    hist_shared_kernel(const int32_t* __restrict__ ids,
                       const uint8_t* __restrict__ inc, int64_t n,
                       int64_t head, int32_t* __restrict__ out,
                       int32_t bin_lo, int32_t bin_hi, int32_t slices) {
  extern __shared__ int32_t sub[];
  const int32_t step = (bin_hi - bin_lo + slices - 1) / slices;
  const int32_t lo = bin_lo + static_cast<int32_t>(blockIdx.x % slices) * step;
  const int32_t width = max(0, min(step, bin_hi - lo));
  for (int32_t b = threadIdx.x; b < width; b += kThreads) sub[b] = 0;
  __syncthreads();
  walk(ids, inc, n, head, blockIdx.x / slices, gridDim.x / slices,
       EmitRange{sub, static_cast<uint32_t>(lo),
                 static_cast<uint32_t>(width)});
  __syncthreads();
  for (int32_t b = threadIdx.x; b < width; b += kThreads) {
    const int32_t v = sub[b];
    if (v) atomicAdd(out + lo + b, v);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    hist_l2_kernel(const int32_t* __restrict__ ids,
                   const uint8_t* __restrict__ inc, int64_t n, int64_t head,
                   int32_t* __restrict__ out, int32_t bin_lo,
                   int32_t width) {
  walk(ids, inc, n, head, blockIdx.x, gridDim.x,
       EmitRange{out + bin_lo, static_cast<uint32_t>(bin_lo),
                 static_cast<uint32_t>(width)});
}

// What is read once per device: the SM count, and the shared kernel's
// opt-in to the card's full shared memory.
struct DeviceInfo {
  bool ready = false;
  int sms = 0;
};

std::mutex g_mutex;
DeviceInfo g_info[kMaxDevices];

cudaError_t device_info(const DeviceInfo** info) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_mutex);
  DeviceInfo& d = g_info[dev];
  if (!d.ready) {
    err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(hist_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSharedLimit);
    if (err != cudaSuccess) return err;
    d.ready = true;
  }
  *info = &d;
  return cudaSuccess;
}

}  // namespace

// Counts the ids of [bin_lo, bin_hi) into out[bin_lo .. bin_hi).  tier:
// 0 shared (`slices` slices of the bin range, each within the shared
// limit), 1 L2 (`slices` unused).
extern "C" int peng_histogram(const int32_t* ids, const uint8_t* inc,
                              int64_t n, int32_t* out, int32_t n_bins,
                              int32_t tier, int32_t slices, int32_t bin_lo,
                              int32_t bin_hi, void* stream) {
  if (n <= 0 || n_bins <= 0) return static_cast<int>(cudaSuccess);
  if (bin_lo < 0 || bin_hi > n_bins || bin_lo >= bin_hi)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DeviceInfo* info = nullptr;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return static_cast<int>(err);

  // scalar head up to the ids' 16-byte alignment; the flags are read as
  // words from there only if that lands them on 4 bytes
  int64_t head =
      static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(ids) & 15)) &
                           15) >> 2;
  if (head > n) head = n;
  if ((reinterpret_cast<uintptr_t>(inc + head) & 3) != 0) head = n;

  const int64_t need = ((n >> 2) + kThreads) / kThreads;  // >= 1
  const int32_t width = bin_hi - bin_lo;
  if (tier == kTierShared) {
    if (slices < 1 || slices > width)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t smem =
        static_cast<int64_t>((width + slices - 1) / slices) * 4;
    if (smem > kSharedLimit) return static_cast<int>(cudaErrorInvalidValue);
    int64_t per = info->sms / slices;  // blocks a slice
    if (per > need) per = need;
    if (per < 1) per = 1;
    hist_shared_kernel<<<static_cast<unsigned>(per * slices), kThreads,
                         static_cast<size_t>(smem), s>>>(
        ids, inc, n, head, out, bin_lo, bin_hi, slices);
  } else if (tier == kTierL2) {
    const int blocks = static_cast<int>(need < info->sms ? need : info->sms);
    hist_l2_kernel<<<blocks, kThreads, 0, s>>>(ids, inc, n, head, out,
                                               bin_lo, width);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
