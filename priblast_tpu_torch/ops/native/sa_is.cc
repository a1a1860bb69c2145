// Linear-time suffix array construction by induced sorting (SA-IS,
// Nong/Zhang/Chan 2009) — a from-scratch implementation over byte input
// with repeated sentinels allowed (like the reference's vendored builder,
// src/sais.cpp, it sorts the string as-is; the SA is unique so outputs are
// byte-identical). Replaces the O(n log n) prefix-doubling builder for
// large transcriptomes; rp_sa_build dispatches here.

#include <cstdint>
#include <cstring>
#include <vector>

namespace rp {

namespace {

template <typename Char>
void sais_rec(const Char *s, int32_t *sa, int64_t n, int64_t sigma,
              std::vector<int32_t> &work) {
  if (n == 0) return;
  if (n == 1) {
    sa[0] = 0;
    return;
  }

  // type[i]: true = S-type (suffix i < suffix i+1), false = L-type.
  std::vector<bool> stype(n);
  stype[n - 1] = true;
  for (int64_t i = n - 2; i >= 0; i--) {
    if (s[i] < s[i + 1])
      stype[i] = true;
    else if (s[i] > s[i + 1])
      stype[i] = false;
    else
      stype[i] = stype[i + 1];
  }
  auto is_lms = [&](int64_t i) {
    return i > 0 && stype[i] && !stype[i - 1];
  };

  std::vector<int64_t> bucket(sigma + 1, 0);
  for (int64_t i = 0; i < n; i++) bucket[s[i] + 1]++;
  for (int64_t c = 0; c < sigma; c++) bucket[c + 1] += bucket[c];

  std::vector<int64_t> ptr(sigma);

  auto induce = [&](auto lms_seed) {
    // place LMS seeds at bucket ends
    std::fill(sa, sa + n, -1);
    for (int64_t c = 0; c < sigma; c++) ptr[c] = bucket[c + 1];
    lms_seed();
    // induce L-types left-to-right from bucket heads
    for (int64_t c = 0; c < sigma; c++) ptr[c] = bucket[c];
    for (int64_t i = 0; i < n; i++) {
      int32_t j = sa[i];
      if (j > 0 && !stype[j - 1]) sa[ptr[s[j - 1]]++] = j - 1;
    }
    // induce S-types right-to-left from bucket ends
    for (int64_t c = 0; c < sigma; c++) ptr[c] = bucket[c + 1];
    for (int64_t i = n - 1; i >= 0; i--) {
      int32_t j = sa[i];
      if (j > 0 && stype[j - 1]) sa[--ptr[s[j - 1]]] = j - 1;
    }
  };

  // ---- pass 1: sort LMS substrings by induction from unsorted seeds ----
  induce([&] {
    for (int64_t i = n - 1; i >= 0; i--)
      if (is_lms(i)) sa[--ptr[s[i]]] = (int32_t)i;
  });

  // collect sorted LMS positions
  std::vector<int32_t> lms_sorted;
  lms_sorted.reserve(n / 2 + 1);
  for (int64_t i = 0; i < n; i++)
    if (sa[i] > 0 && is_lms(sa[i])) lms_sorted.push_back(sa[i]);
  const int64_t m = (int64_t)lms_sorted.size();

  // name LMS substrings in sorted order
  std::vector<int32_t> name_of(n, -1);
  int64_t names = 0;
  int64_t prev = -1;
  for (int64_t k = 0; k < m; k++) {
    int64_t cur = lms_sorted[k];
    bool differ = false;
    if (prev < 0) {
      differ = true;
    } else {
      // compare LMS substrings starting at prev and cur
      for (int64_t d = 0;; d++) {
        if (cur + d >= n || prev + d >= n) {
          differ = (cur + d >= n) != (prev + d >= n);
          break;
        }
        if (s[cur + d] != s[prev + d] || stype[cur + d] != stype[prev + d]) {
          differ = true;
          break;
        }
        if (d > 0 && (is_lms(cur + d) || is_lms(prev + d))) {
          differ = !(is_lms(cur + d) && is_lms(prev + d));
          break;
        }
      }
    }
    if (differ) names++;
    name_of[cur] = (int32_t)(names - 1);
    prev = cur;
  }

  // LMS positions in text order + their names
  std::vector<int32_t> lms_text;
  lms_text.reserve(m);
  for (int64_t i = 0; i < n; i++)
    if (is_lms(i)) lms_text.push_back((int32_t)i);
  std::vector<int32_t> s1(m);
  for (int64_t k = 0; k < m; k++) s1[k] = name_of[lms_text[k]];

  std::vector<int32_t> sa1(m);
  if (names < m) {
    sais_rec(s1.data(), sa1.data(), m, names, work);
  } else {
    for (int64_t k = 0; k < m; k++) sa1[s1[k]] = (int32_t)k;
  }

  // ---- pass 2: induce the full SA from sorted LMS suffixes ----
  induce([&] {
    for (int64_t k = m - 1; k >= 0; k--) {
      int32_t j = lms_text[sa1[k]];
      sa[--ptr[s[j]]] = j;
    }
  });
}

}  // namespace

extern "C" void rp_sais(const uint8_t *s, int64_t n, int32_t *sa) {
  // SA-IS needs a unique minimal sentinel; our encodings repeat 0, so sort
  // s' = (s+1) ++ [0] and drop the sentinel row (the suffix order of s is
  // unchanged: the virtual sentinel only breaks prefix ties toward the
  // shorter suffix, which is already the bytewise rule).
  uint8_t maxc = 0;
  for (int64_t i = 0; i < n; i++) maxc = s[i] > maxc ? s[i] : maxc;
  std::vector<int32_t> sa2(n + 1);
  std::vector<int32_t> work;
  if (maxc < 255) {
    // stay in bytes (our encodings use values <= 9)
    std::vector<uint8_t> sp(n + 1);
    for (int64_t i = 0; i < n; i++) sp[i] = s[i] + 1;
    sp[n] = 0;
    sais_rec(sp.data(), sa2.data(), n + 1, (int64_t)maxc + 2, work);
  } else {
    std::vector<int32_t> sp(n + 1);
    for (int64_t i = 0; i < n; i++) sp[i] = (int32_t)s[i] + 1;
    sp[n] = 0;
    sais_rec(sp.data(), sa2.data(), n + 1, 257, work);
  }
  std::memcpy(sa, sa2.data() + 1, n * sizeof(int32_t));
}

}  // namespace rp
