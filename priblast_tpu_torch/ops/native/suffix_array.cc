// Suffix array construction over the search-encoded transcriptome
// (byte alphabet, repeated 0 sentinels allowed — NOT required to be unique).
//
// The suffix array of a string is unique, so any correct algorithm produces
// output identical to the reference's vendored SA-IS (reference:
// src/sais.cpp:656-667); byte-level parity of the .ind database files is
// asserted in tests. This implementation uses prefix-doubling with radix
// sort (O(n log n)), which is simple, branch-light and fast in practice;
// the host cost is a small fraction of the db step (the accessibility DP
// dominates).

#include <cstdint>
#include <cstring>
#include <vector>

namespace rp {

extern "C" void rp_sa_build(const uint8_t *s, int64_t n, int32_t *sa) {
  if (n <= 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<int32_t> rank(n), tmp(n), cnt;
  std::vector<int32_t> order(n), order2(n);

  // initial order: counting sort by first byte
  {
    cnt.assign(257, 0);
    for (int64_t i = 0; i < n; i++) cnt[s[i] + 1]++;
    for (int i = 0; i < 256; i++) cnt[i + 1] += cnt[i];
    for (int64_t i = 0; i < n; i++) order[cnt[s[i]]++] = (int32_t)i;
    rank[order[0]] = 0;
    for (int64_t i = 1; i < n; i++)
      rank[order[i]] =
          rank[order[i - 1]] + (s[order[i]] != s[order[i - 1]] ? 1 : 0);
  }

  for (int64_t k = 1;; k <<= 1) {
    int32_t max_rank = rank[order[n - 1]];
    if (max_rank == n - 1) break;

    // sort by (rank[i], rank[i+k]) — two stable counting-sort passes.
    // Pass 1 (secondary key): suffixes with i+k >= n have empty second key
    // (smallest); others ordered by existing order of their i+k suffix.
    {
      int64_t p = 0;
      for (int64_t i = n - k; i < n; i++) order2[p++] = (int32_t)i;
      for (int64_t i = 0; i < n; i++) {
        int32_t j = order[i];
        if (j >= k) order2[p++] = j - (int32_t)k;
      }
    }
    // Pass 2 (primary key): stable counting sort by rank[i]
    {
      cnt.assign((size_t)max_rank + 2, 0);
      for (int64_t i = 0; i < n; i++) cnt[rank[i] + 1]++;
      for (int64_t r = 0; r <= max_rank; r++) cnt[r + 1] += cnt[r];
      for (int64_t i = 0; i < n; i++) order[cnt[rank[order2[i]]]++] = order2[i];
    }
    // re-rank
    tmp[order[0]] = 0;
    for (int64_t i = 1; i < n; i++) {
      int32_t a = order[i - 1], b = order[i];
      bool diff = rank[a] != rank[b];
      if (!diff) {
        int32_t ra = a + k < n ? rank[a + k] : -1;
        int32_t rb = b + k < n ? rank[b + k] : -1;
        diff = ra != rb;
      }
      tmp[b] = tmp[a] + (diff ? 1 : 0);
    }
    rank.swap(tmp);
  }
  std::memcpy(sa, order.data(), (size_t)n * sizeof(int32_t));
}

}  // namespace rp
