// The port's host count of a [B, L] code batch: the exact scan of
// pengnative.cpp's count_rows_exact (window validity, the post-N skip,
// greedy non-overlap on canonical ids, ltot over processed windows;
// reference: src/base_pattern.cpp:331-392), with a cost that follows the
// corpus instead of threads x 4^W.
//
//  * host_count_scan zeroes the table and scans row ranges on every
//    thread.  A thread keeps a private replica of the 4^W table only
//    where its windows pay for zeroing the replica and adding it back:
//    from (windows / threads) >= 4^W / 4 on.  Below that every thread
//    adds into the one output table with relaxed atomic increments,
//    whose order cannot change an integer sum.  Measured on 8 cores
//    (MafK, 1.0M windows, 8 threads; replicas / atomic): W = 8 4.7 /
//    7.8 ms, W = 10 8.8 / 8.7 ms, W = 12 119.9 / 12.2 ms; 15.7M windows
//    at W = 10 75.4 / 113.1 ms.  The replicas also stay under 512 MiB.
//  * host_count_mirror copies each canonical count to its reverse
//    complement's id in place, in parallel over tiles of the middle
//    digits.  A pair reads its smaller id and writes its larger one, and
//    palindromes are not touched, so no element is read by one thread
//    and written by another.  A tile goes through a small buffer so
//    that both its reads and its writes run along contiguous rows (the
//    plain id loop writes with a 4^(W-1) stride: 400 ms at W = 12, 16 ms
//    tiled on 8 threads).
//
// The table and ltot are integer-identical to count_rows_exact's for
// every W, strand choice and thread count.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int resolve_threads(int n_threads) {
  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  return n_threads < 1 ? 1 : n_threads;
}

// fn(t) for t in [0, n_threads), t = 0 on the calling thread
template <typename F>
void on_threads(int n_threads, F fn) {
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; t++) pool.emplace_back([=]() { fn(t); });
  fn(0);
  for (auto& th : pool) th.join();
}

// [lo, hi) of part t of n split into `parts`
inline int64_t part_lo(int64_t n, int t, int parts) {
  return (int64_t)((__int128)n * t / parts);
}

// count_rows_range of pengnative.cpp, adding into `table` with atomic
// increments when other threads add into it too
template <bool kAtomic>
int64_t scan_rows(const uint8_t* codes, int64_t row_lo, int64_t row_hi,
                  int64_t row_len, int w, int both_strands, int32_t* table) {
  const int64_t n_win = row_len - w + 1;
  if (n_win <= 0 || row_lo >= row_hi) return 0;
  const int64_t mask = ((int64_t)1 << (2 * w)) - 1;
  const int shift_hi = 2 * (w - 1);
  const int64_t d = w + 1;
  int64_t ltot = 0;
  // rings for the post-N skip recurrence (indexed by s % d)
  std::vector<uint8_t> clean_ring(d), skip_ring(d);
  // open-address map id -> last accepted window start, rebuilt per row
  struct Slot { int64_t id; int64_t pos; };
  size_t cap = 1;
  while (cap < (size_t)n_win * 2) cap <<= 1;
  std::vector<Slot> map(cap);
  for (int64_t r = row_lo; r < row_hi; r++) {
    const uint8_t* row = codes + r * row_len;
    for (size_t i = 0; i < cap; i++) map[i] = {-1, -1};
    int64_t fwd = 0, rc = 0;
    int64_t last_n = -1;  // most recent N position seen so far
    // prime the first w-1 bases; an N (c == 0) gets a masked dummy
    // digit, so that it cannot carry into the digits of later windows
    for (int64_t t = 0; t < w - 1; t++) {
      const int c = row[t];
      if (c == 0) last_n = t;
      fwd = (fwd >> 2) + ((int64_t)((c - 1) & 3) << shift_hi);
      rc = ((rc << 2) & mask) + ((4 - c) & 3);
    }
    for (int64_t s = 0; s < n_win; s++) {
      const int c = row[s + w - 1];
      if (c == 0) last_n = s + w - 1;
      fwd = (fwd >> 2) + ((int64_t)((c - 1) & 3) << shift_hi);
      rc = ((rc << 2) & mask) + ((4 - c) & 3);
      const bool clean = last_n < s;
      bool skip = false;
      if (s >= d) {
        skip = (row[s - 1] == 0) && clean_ring[s % d] && !skip_ring[s % d];
      }
      clean_ring[s % d] = clean;
      skip_ring[s % d] = skip;
      if (!clean || skip) continue;
      ltot++;
      const int64_t id = both_strands ? std::min(fwd, rc) : fwd;
      size_t h = ((uint64_t)id * 0x9E3779B97F4A7C15ull) & (cap - 1);
      while (map[h].id != -1 && map[h].id != id) h = (h + 1) & (cap - 1);
      if (map[h].id == -1 || s - map[h].pos >= w) {
        if (kAtomic)
          __atomic_fetch_add(&table[id], 1, __ATOMIC_RELAXED);
        else
          table[id]++;
        map[h].id = id;
        map[h].pos = s;
      }
    }
  }
  return ltot;
}

// reverse complement of a k-digit id
inline int64_t rc_digits(int64_t x, int k) {
  int64_t r = 0;
  for (int p = 0; p < k; p++) {
    r = r * 4 + (3 - (x & 3));
    x >>= 2;
  }
  return r;
}

}  // namespace

extern "C" {

// Zeroes table_out [4^w] and counts every window of the batch into it
// (canonical ids only for both strands: host_count_mirror completes the
// table).  n_threads < 1 takes the hardware's.  Returns ltot.
int64_t host_count_scan(const uint8_t* codes, int64_t n_rows,
                        int64_t row_len, int w, int both_strands,
                        int n_threads, int32_t* table_out) {
  const int64_t n = (int64_t)1 << (2 * w);
  const int64_t n_win = std::max<int64_t>(0, row_len - w + 1);
  const int64_t windows = n_rows * n_win;
  n_threads = resolve_threads(n_threads);
  if (n_threads > n_rows) n_threads = (int)std::max<int64_t>(1, n_rows);
  // a small table and few windows: one thread is faster than starting more
  if (n < (1 << 16) && windows < (1 << 16)) n_threads = 1;
  const int T = n_threads;
  on_threads(T, [=](int t) {
    const int64_t lo = part_lo(n, t, T), hi = part_lo(n, t + 1, T);
    memset(table_out + lo, 0, sizeof(int32_t) * (hi - lo));
  });
  if (windows == 0) return 0;
  std::vector<int64_t> ltots(T, 0);
  int64_t* lt = ltots.data();
  const bool replicas =
      T > 1 && (windows / T) * 4 >= n
      && (int64_t)(T - 1) * n * (int64_t)sizeof(int32_t) <= ((int64_t)512 << 20);
  if (T == 1) {
    lt[0] = scan_rows<false>(codes, 0, n_rows, row_len, w, both_strands,
                             table_out);
  } else if (!replicas) {
    on_threads(T, [=](int t) {
      lt[t] = scan_rows<true>(codes, part_lo(n_rows, t, T),
                              part_lo(n_rows, t + 1, T), row_len, w,
                              both_strands, table_out);
    });
  } else {
    // thread 0 counts into the output table, thread t > 0 into replica t-1
    std::vector<std::vector<int32_t>> reps(T - 1);
    std::vector<int32_t>* rp = reps.data();
    on_threads(T, [=](int t) {
      int32_t* table = table_out;
      if (t > 0) {
        rp[t - 1].assign(n, 0);
        table = rp[t - 1].data();
      }
      lt[t] = scan_rows<false>(codes, part_lo(n_rows, t, T),
                               part_lo(n_rows, t + 1, T), row_len, w,
                               both_strands, table);
    });
    on_threads(T, [=](int t) {
      const int64_t lo = part_lo(n, t, T), hi = part_lo(n, t + 1, T);
      for (int k = 0; k < T - 1; k++) {
        const int32_t* src = rp[k].data();
        for (int64_t i = lo; i < hi; i++) table_out[i] += src[i];
      }
    });
  }
  int64_t ltot = 0;
  for (int t = 0; t < T; t++) ltot += lt[t];
  return ltot;
}

// table[rc(id)] = table[id] for every canonical id < rc(id), in place
// (reference mirror step: src/base_pattern.cpp:386-392).  An id is split
// into its top a digits h, middle digits m and low a digits l; its
// reverse complement is (rc(l), rc(m), rc(h)).  A tile holds one m: it
// reads rows of 4^a ids that run along l and writes rows that run along
// h, through a 4^a x 4^a buffer.
void host_count_mirror(int32_t* table, int w, int n_threads) {
  const int a = std::min(4, w / 2);
  const int mdig = w - 2 * a;
  const int64_t na = (int64_t)1 << (2 * a);
  const int64_t nm = (int64_t)1 << (2 * mdig);
  const int hs = 2 * (a + mdig);  // shift of the top a digits
  std::vector<int64_t> rca(na);
  for (int64_t x = 0; x < na; x++) rca[x] = rc_digits(x, a);
  const int64_t* rc_a = rca.data();
  n_threads = resolve_threads(n_threads);
  if (((int64_t)1 << (2 * w)) < (1 << 16)) n_threads = 1;
  if (n_threads > nm) n_threads = (int)nm;
  const int T = n_threads;
  on_threads(T, [=](int t) {
    std::vector<int32_t> buf(na * na);
    int32_t* b = buf.data();
    for (int64_t m = part_lo(nm, t, T); m < part_lo(nm, t + 1, T); m++) {
      const int64_t mid = m << (2 * a);
      const int64_t rc_mid = rc_digits(m, mdig) << (2 * a);
      for (int64_t h = 0; h < na; h++) {
        const int64_t row = (h << hs) + mid;
        const int64_t rc_row = rc_mid + rc_a[h];
        for (int64_t l = 0; l < na; l++)
          if (row + l < rc_row + (rc_a[l] << hs)) b[l * na + h] = table[row + l];
      }
      for (int64_t l = 0; l < na; l++) {
        const int64_t rc_row = (rc_a[l] << hs) + rc_mid;
        for (int64_t h = 0; h < na; h++) {
          const int64_t id = (h << hs) + mid + l;
          const int64_t rc = rc_row + rc_a[h];
          if (id < rc) table[rc] = b[l * na + h];
        }
      }
    }
  });
}

}  // extern "C"
