// The host's part of the device engine's climb (ops/climb.py): the
// sequential seen-set replay over the lockstep walks' trace, and the climb
// section's text (reference: src/peng.cpp:437-541).
//
// climb_replay walks the seeds in order.  For each it prints the seed's
// row and every row its walk accepted at each step it reached, moves along
// the walk's chosen mutants, and stops where a step did not improve or
// where the chosen mutant was already in the seen set.  A pattern is a
// base-11 IUPAC key (digit p times 11^p) in an int64_t.  Each step puts
// the mother's single-position mutants (position-major, similar-letter
// order) into the seen set, all but the one it moves to.  A walk's end is
// emitted when it is not in the seen set; it then enters the seen set.
// (The reference also keeps the emitted keys in a set of their own, and
// asks both: every key put there is put into the seen set at once, so the
// seen set alone decides.)
//
// A row prints as Peng._print_climb_row does:
//   "\t{iupac:>15}\t{n_sites:>10}\t{enr:>5.2f}\t{score:>10.6f}\n"
// with enr = float(n_sites) / expected in float32, inf where expected is
// 0, and each float formatted from its double value, as Python formats a
// numpy float32.  Python spells every NaN "nan"; printf may print "-nan",
// so a NaN is written by hand.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// open-addressing set of non-negative int64 keys (-1 marks a free slot)
class KeySet {
 public:
  KeySet() : slots_(1 << 12, -1), n_(0) {}

  bool contains(int64_t key) const {
    const size_t mask = slots_.size() - 1;
    for (size_t i = hash(key) & mask;; i = (i + 1) & mask) {
      if (slots_[i] == key) return true;
      if (slots_[i] < 0) return false;
    }
  }

  void insert(int64_t key) {
    if (2 * (n_ + 1) > slots_.size()) grow();
    if (place(slots_, key)) n_++;
  }

 private:
  static size_t hash(int64_t key) {  // splitmix64's finaliser
    uint64_t x = (uint64_t)key + 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return (size_t)(x ^ (x >> 31));
  }

  static bool place(std::vector<int64_t>& slots, int64_t key) {
    const size_t mask = slots.size() - 1;
    for (size_t i = hash(key) & mask;; i = (i + 1) & mask) {
      if (slots[i] == key) return false;
      if (slots[i] < 0) {
        slots[i] = key;
        return true;
      }
    }
  }

  void grow() {
    std::vector<int64_t> bigger(2 * slots_.size(), -1);
    for (int64_t key : slots_)
      if (key >= 0) place(bigger, key);
    slots_.swap(bigger);
  }

  std::vector<int64_t> slots_;
  size_t n_;
};

// appends to a fixed buffer; ok() turns false once a write does not fit
class Text {
 public:
  Text(char* buf, int64_t cap) : buf_(buf), cap_(cap), len_(0) {}

  void put(const char* s, size_t n) {
    if (len_ + (int64_t)n > cap_) {
      len_ = cap_ + 1;
      return;
    }
    std::memcpy(buf_ + len_, s, n);
    len_ += (int64_t)n;
  }

  void put(const char* s) { put(s, std::strlen(s)); }

  // a float's double value as Python's format(x, f">{width}.{prec}f")
  void fixed(float x, int width, int prec) {
    char tmp[80];
    int n = std::isnan(x)
                ? std::snprintf(tmp, sizeof tmp, "%*s", width, "nan")
                : std::snprintf(tmp, sizeof tmp, "%*.*f", width, prec,
                                (double)x);
    put(tmp, (size_t)n);
  }

  void integer(int64_t v, int width) {
    char tmp[32];
    int n = std::snprintf(tmp, sizeof tmp, "%*lld", width, (long long)v);
    put(tmp, (size_t)n);
  }

  // the pattern's letters, right-aligned in `width` columns
  void pattern(const int8_t* digits, int w, const char* letters, int width) {
    for (int pad = width - w; pad > 0; pad--) put(" ", 1);
    char tmp[64];
    for (int p = 0; p < w; p++) tmp[p] = letters[digits[p]];
    put(tmp, (size_t)w);
  }

  bool ok() const { return len_ <= cap_; }
  int64_t len() const { return len_; }

 private:
  char* buf_;
  int64_t cap_;
  int64_t len_;
};

}  // namespace

extern "C" {

// The trace holds T steps of S walks, R accepted-row slots a step
// ([T, S] and [T, S, R] arrays, row-major).  sim is the [11, maxsim]
// similar-letter table (-1 padded), letters the 11 IUPAC letters.
// Outputs: per seed emitted, final digits [S, w], final count, expected
// and bgp; per row (rows of seed s at [row_start[s], row_start[s + 1]))
// digits [row_cap, w], count, expected and score; the climb section's
// text in text[0, *text_len).  Returns the number of rows, or
//   -1  11^w does not fit in an int64_t (or w < 1),
//   -2  the rows or the text outgrow row_cap or text_cap,
//   -3  the trace is malformed: a walk runs past T steps, or an accepted
//       count or a candidate index lies outside its table.
int64_t climb_replay(
    int64_t S, int w, int64_t T, int64_t R, const uint8_t* improved,
    const int32_t* chosen_idx, const int64_t* chosen_counts,
    const float* chosen_expected, const float* chosen_bgp,
    const int32_t* acc_idx, const int64_t* acc_counts,
    const float* acc_expected, const float* acc_score, const int32_t* acc_n,
    const int64_t* init_counts, const float* init_expected,
    const float* init_bgp, const float* init_score, const int64_t* seed_ids,
    const int32_t* sim, int maxsim, const char* letters, uint8_t* emitted,
    int8_t* final_digits, int64_t* final_counts, float* final_expected,
    float* final_bgp, int64_t* row_start, int8_t* row_digits,
    int64_t* row_counts, float* row_expected, float* row_score,
    int64_t row_cap, char* text, int64_t text_cap, int64_t* text_len) {
  if (w < 1) return -1;
  std::vector<int64_t> pow11(w + 1, 1);
  for (int p = 1; p <= w; p++)
    if (__builtin_mul_overflow(pow11[p - 1], (int64_t)11, &pow11[p]))
      return -1;

  KeySet seen;
  Text out(text, text_cap);
  std::vector<int8_t> digits(w);
  std::vector<int64_t> cands;
  int64_t n_rows = 0;

  auto add_row = [&](int64_t count, float expected, float score, int q,
                     int8_t letter) -> bool {
    if (n_rows >= row_cap) return false;
    int8_t* d = row_digits + n_rows * w;
    std::memcpy(d, digits.data(), (size_t)w);
    if (q >= 0) d[q] = letter;
    row_counts[n_rows] = count;
    row_expected[n_rows] = expected;
    row_score[n_rows] = score;
    n_rows++;
    const float enr = expected != 0.0f ? (float)count / expected : INFINITY;
    out.put("\t", 1);
    out.pattern(d, w, letters, 15);
    out.put("\t", 1);
    out.integer(count, 10);
    out.put("\t", 1);
    out.fixed(enr, 5, 2);
    out.put("\t", 1);
    out.fixed(score, 10, 6);
    out.put("\n", 1);
    return true;
  };
  // candidate index (p * maxsim + r) -> position and letter; false when
  // the index names no similar letter of the mother
  auto decode = [&](int32_t idx, int* p, int8_t* letter) -> bool {
    if (idx < 0 || idx >= w * maxsim) return false;
    *p = idx / maxsim;
    const int32_t l = sim[digits[*p] * maxsim + idx % maxsim];
    *letter = (int8_t)l;
    return l >= 0;
  };

  for (int64_t s = 0; s < S; s++) {
    row_start[s] = n_rows;
    int64_t key = 0;
    for (int p = 0; p < w; p++) {
      digits[p] = (int8_t)((seed_ids[s] >> (2 * p)) & 3);
      key += digits[p] * pow11[p];
    }
    if (!add_row(init_counts[s], init_expected[s], init_score[s], -1, 0))
      return -2;
    int64_t f_cnt = init_counts[s];
    float f_exp = init_expected[s], f_bgp = init_bgp[s];

    for (int64_t t = 0;; t++) {
      if (t >= T) return -3;
      const int64_t ts = t * S + s;
      const int32_t n_acc = acc_n[ts];
      if (n_acc < 0 || n_acc > R) return -3;
      for (int32_t j = 0; j < n_acc; j++) {
        const int64_t a = ts * R + j;
        int p;
        int8_t letter;
        if (!decode(acc_idx[a], &p, &letter)) return -3;
        if (!add_row(acc_counts[a], acc_expected[a], acc_score[a], p, letter))
          return -2;
      }
      cands.clear();
      for (int p = 0; p < w; p++) {
        const int64_t base = key - digits[p] * pow11[p];
        for (int r = 0; r < maxsim; r++) {
          const int32_t l = sim[digits[p] * maxsim + r];
          if (l < 0) break;
          cands.push_back(base + l * pow11[p]);
        }
      }
      if (!improved[ts]) {
        // the walk ends on its mother, which is none of its candidates
        for (int64_t c : cands) seen.insert(c);
        break;
      }
      int p;
      int8_t letter;
      if (!decode(chosen_idx[ts], &p, &letter)) return -3;
      const int64_t new_key = key + (letter - digits[p]) * pow11[p];
      f_cnt = chosen_counts[ts];
      f_exp = chosen_expected[ts];
      f_bgp = chosen_bgp[ts];
      const bool killed = seen.contains(new_key);
      for (int64_t c : cands)
        if (c != new_key) seen.insert(c);
      digits[p] = letter;
      key = new_key;
      if (killed) break;
    }

    const bool emit = !seen.contains(key);
    if (emit) seen.insert(key);
    emitted[s] = emit ? 1 : 0;
    std::memcpy(final_digits + s * w, digits.data(), (size_t)w);
    final_counts[s] = f_cnt;
    final_expected[s] = f_exp;
    final_bgp[s] = f_bgp;

    char seed[64];
    for (int p = 0; p < w; p++)
      seed[p] = "ACGT"[(seed_ids[s] >> (2 * p)) & 3];
    out.put("optimization: ");
    out.put(seed, (size_t)w);
    if (emit) {
      out.put(" -> ");
      out.pattern(digits.data(), w, letters, 0);
      out.put("\n\n");
    } else {
      out.put(" removed\t\n\n");
    }
  }
  row_start[S] = n_rows;
  if (!out.ok()) return -2;
  *text_len = out.len();
  return n_rows;
}

}  // extern "C"
