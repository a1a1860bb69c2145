// Exact search chain: k-mer hash build, simultaneous suffix-array seed
// search, interaction-energy expansion, ungapped and gapped extension,
// redundancy removal. Per-query-per-chunk semantics match the reference's
// kernel chain (reference: src/rna_interaction_search.cpp:185-196) with
// identical arithmetic and iteration order, so end-to-end output is
// byte-identical (asserted against golden predictions.txt in tests).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include "tables.hpp"

namespace rp {

// ---------------------------------------------------------------------------
// SA interval refinement by one character at `offset` (binary search within
// [start,end]); empty result is encoded as (1,0)
// (reference: src/seed_search.cpp:232-295 / src/db_construction.cpp:438-500).
// ---------------------------------------------------------------------------
static void refine_interval(const uint8_t *seq, int64_t n, const int32_t *sa,
                            int *start, int *end, uint8_t c, int offset) {
  int s = *start, e = *end;
  // The reference pre-increments *start when suffix sa[s] is shorter than
  // offset+1; with sentinel-terminated encodings and c in 2..5 that suffix
  // can never match the pattern so the increment is unreachable here except
  // for already-empty intervals, which are normalized below anyway.
  if ((uint64_t)(sa[s] + offset) >= (uint64_t)n) ++(*start);

  if (s > e) {
    *start = 1;
    *end = 0;
    return;
  }
  if (s == e) {
    if ((uint64_t)(sa[s] + offset) < (uint64_t)n &&
        seq[sa[s] + offset] == c)
      return;
    *start = 1;
    *end = 0;
    return;
  }

  if (seq[sa[s] + offset] != c) {
    while (s < e - 1) {
      const int m = (s + e) / 2;
      if (seq[sa[m] + offset] < c)
        s = m;
      else
        e = m;
    }
    if (seq[sa[e] + offset] != c) {
      *start = 1;
      *end = 0;
      return;
    }
    *start = e;
    s = e;
    e = *end;
  }

  if (seq[sa[e] + offset] != c) {
    while (s < e - 1) {
      const int m = (s + e) / 2;
      if (seq[sa[m] + offset] > c)
        e = m;
      else
        s = m;
    }
    if (seq[sa[s] + offset] != c) {
      *start = 1;
      *end = 0;
      return;
    }
    *end = s;
  }
}

// ---------------------------------------------------------------------------
// Short-substring hash: SA interval for every 4^k k-mer, k = 1..hash_size,
// built by nested interval refinement (reference: src/db_construction.cpp:
// 337-369). Output is flattened level-major: level L occupies 4^(L+1) slots
// starting at (4^(L+1) - 4) / 3.
// ---------------------------------------------------------------------------
extern "C" void rp_kmer_hash(const uint8_t *seq, int64_t n, const int32_t *sa,
                             int hash_size, int32_t *hstart, int32_t *hend) {
  int64_t off = 0, prev_off = 0;
  for (int lvl = 0; lvl < hash_size; lvl++) {
    const int64_t cnt = (int64_t)1 << (2 * (lvl + 1));
    for (int64_t j = 0; j < cnt; j++) {
      const uint8_t c = (uint8_t)((j % 4) + 2);
      int s, e;
      if (lvl == 0) {
        s = 0;
        e = (int)(n - 1);
      } else {
        s = hstart[prev_off + j / 4];
        e = hend[prev_off + j / 4];
      }
      refine_interval(seq, n, sa, &s, &e, c, lvl);
      hstart[off + j] = s;
      hend[off + j] = e;
    }
    prev_off = off;
    off += cnt;
  }
}

// ---------------------------------------------------------------------------
// Hit model (struct-of-work internal representation;
// reference: src/hit.hpp:38-118).
// ---------------------------------------------------------------------------
struct XHit {
  int dbseq_id = -1;
  int dbseq_start = -1;  // window start in db-local (reversed) coordinates
  int q_sp, db_sp;
  int q_len, db_len;
  double acc_e, hyb_e, energy;
  bool flag = false;
  std::vector<std::pair<int, int>> bps;
};

struct SearchParams {
  int hash_size;
  int max_seed_length;
  int min_acc_len;
  double hybrid_thr;
  double interaction_thr;
  double final_thr;
  int dropout_wo_gap;
  int dropout_w_gap;
  int min_helix;
};

struct DbChunkView {
  const uint8_t *seq;
  int64_t n;
  const int32_t *sa;
  const int32_t *hstart;
  const int32_t *hend;
  const float *acc;
  const float *cond;
  const int64_t *acc_off;   // n_seqs+1 prefix offsets into acc
  const int64_t *cond_off;  // n_seqs+1 prefix offsets into cond
  const int32_t *seq_len;   // per-seq stored length
  const int32_t *start_pos; // per-seq start position in `seq`
  int n_seqs;

  const float *acc_of(int id) const { return acc + acc_off[id]; }
  const float *cond_of(int id) const { return cond + cond_off[id]; }
};

struct QueryView {
  const uint8_t *seq;  // encoded, sentinel-terminated, length n
  int n;
  const int32_t *sa;
  const float *acc;   // length n-1
  const float *cond;  // length n-1
};

// base char for energy lookups: 2..5 -> 1..4, 6..9 (soft-masked) -> 1..4
static inline int mapc(uint8_t v) { return v <= 5 ? v - 1 : v - 5; }

// boundary-safe char (reference: src/gapped_extension.cpp:401-407)
static inline int safec(const uint8_t *seq, int64_t n, int64_t i) {
  if (i < 0 || i >= n || seq[i] < 2) return 0;
  return mapc(seq[i]);
}

// window accessibility: acc[sp] + sum of conditional terms
// (reference: src/seed_search.cpp:143-151)
static double window_access(const float *acc, const float *cond, int sp,
                            int length, int d) {
  double t = acc[sp];
  for (int i = d; i < length; i++) t += cond[sp + i];
  return t;
}

// ---------------------------------------------------------------------------
// Seed search: depth-first simultaneous SA traversal over the 6
// complementary pair types (reference: src/seed_search.cpp:153-230).
// ---------------------------------------------------------------------------
struct SeedCandidate {
  int sp_q, ep_q, sp_db, ep_db, length;
  double energy;
};

// stem pairs (query char, db char): GC, CG(G/C swapped), CU? — order matters
// for DFS emission order (reference: src/seed_search.hpp:38-50)
static const int kStemPairs[6][2] = {{3, 4}, {4, 3}, {4, 5},
                                     {5, 4}, {2, 5}, {5, 2}};

struct SeedSearcher {
  const QueryView &q;
  const DbChunkView &db;
  const SearchParams &p;
  std::vector<SeedCandidate> out;
  int q_seed[64];
  int db_seed[64];

  SeedSearcher(const QueryView &q_, const DbChunkView &db_,
               const SearchParams &p_)
      : q(q_), db(db_), p(p_) {}

  void run() {
    dfs(0, q.n - 1, 0, (int)(db.n - 1), 0.0, 0);
  }

  void dfs(int sp_q, int ep_q, int sp_db, int ep_db, double score,
           int length) {
    if (length >= p.max_seed_length) return;
    int qs[6], qe[6], ds[6], de[6];
    for (int i = 0; i < 6; i++) {
      int s = sp_q, e = ep_q;
      refine_interval(q.seq, q.n, q.sa, &s, &e, (uint8_t)kStemPairs[i][0],
                      length);
      qs[i] = s;
      qe[i] = e;
      s = sp_db;
      e = ep_db;
      if (length + 1 > p.hash_size) {
        refine_interval(db.seq, db.n, db.sa, &s, &e, (uint8_t)kStemPairs[i][1],
                        length);
      } else {
        // hash lookup: index of the (length+1)-mer db_seed[0..length-1]+c
        int64_t idx = kStemPairs[i][1] - 2;
        for (int j = 0; j < length; j++)
          idx += ((int64_t)1 << (2 * (length - j))) * (db_seed[j] - 2);
        const int64_t base = (((int64_t)1 << (2 * (length + 1))) - 4) / 3;
        s = db.hstart[base + idx];
        e = db.hend[base + idx];
      }
      ds[i] = s;
      de[i] = e;
    }
    for (int i = 0; i < 6; i++) {
      if (qs[i] > qe[i] || ds[i] > de[i]) continue;
      double sc = 0.0;
      if (length > 0) {
        const int type = g.bp[q_seed[length - 1] - 1][db_seed[length - 1] - 1];
        int type2 = g.bp[kStemPairs[i][0] - 1][kStemPairs[i][1] - 1];
        type2 = g.rtype[type2];
        sc = score + ((double)g.stack37[type][type2]) / 100;
      }
      if (sc < p.hybrid_thr && length + 1 >= p.min_acc_len) {
        out.push_back({qs[i], qe[i], ds[i], de[i], length + 1, sc});
      } else {
        q_seed[length] = kStemPairs[i][0];
        db_seed[length] = kStemPairs[i][1];
        dfs(qs[i], qe[i], ds[i], de[i], sc, length + 1);
      }
    }
  }
};

// Candidate SA intervals -> per-position hits with total interaction energy
// (reference: src/seed_search.cpp:47-99).
static void expand_candidates(const std::vector<SeedCandidate> &cands,
                              const QueryView &q, const DbChunkView &db,
                              const SearchParams &p,
                              std::vector<XHit> &hits) {
  std::vector<int> q_sps;
  std::vector<double> q_accs;
  for (const SeedCandidate &c : cands) {
    q_sps.clear();
    q_accs.clear();
    for (int j = c.sp_q; j <= c.ep_q; j++) {
      q_sps.push_back(q.sa[j]);
      q_accs.push_back(
          window_access(q.acc, q.cond, q.sa[j], c.length, p.min_acc_len));
    }
    for (int k = c.sp_db; k <= c.ep_db; k++) {
      const int db_sp = db.sa[k];
      // locate owning sequence (unique; reference: seed_search.cpp:101-141)
      const int id =
          (int)(std::upper_bound(db.start_pos, db.start_pos + db.n_seqs,
                                 db_sp) -
                db.start_pos) -
          1;
      const int local_start =
          db.seq_len[id] - (db_sp - db.start_pos[id]) - c.length;
      const double dba = window_access(db.acc_of(id), db.cond_of(id),
                                       local_start, c.length, p.min_acc_len);
      for (int j = c.sp_q; j <= c.ep_q; j++) {
        const double qa = q_accs[j - c.sp_q];
        const double interaction = qa + dba + c.energy;
        if (interaction < 0) {
          XHit h;
          h.q_sp = q_sps[j - c.sp_q];
          h.db_sp = db_sp;
          h.q_len = h.db_len = c.length;
          h.acc_e = qa + dba;
          h.hyb_e = c.energy;
          h.energy = h.acc_e + h.hyb_e;
          h.dbseq_id = id;
          h.dbseq_start = local_start;
          hits.push_back(std::move(h));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Hybridization loop energy on raw tables, in kcal/mol
// (reference: src/ungapped_extension.cpp:157-186 — no-bulge variant — and
// src/gapped_extension.cpp:426-473 — with bulges).
// ---------------------------------------------------------------------------
static double loop37_nobulge(int type, int type2, int64_t i, int64_t j,
                             int64_t pp, int64_t qq, const uint8_t *qseq,
                             const uint8_t *dbseq) {
  const int u1 = (int)(pp - i - 1), u2 = (int)(qq - j - 1);
  double z;
  if (u1 == 0 && u2 == 0) {
    z = g.stack37[type][type2];
  } else {
    const int a = mapc(qseq[i + 1]), b = mapc(dbseq[j + 1]);
    const int c = mapc(qseq[pp - 1]), d = mapc(dbseq[qq - 1]);
    if (u1 + u2 == 2)
      z = g.int11_37[type][type2][a][b];
    else if (u1 == 1 && u2 == 2)
      z = g.int21_37[type][type2][a][d][b];
    else if (u1 == 2 && u2 == 1)
      z = g.int21_37[type2][type][d][a][c];
    else if (u1 == 2 && u2 == 2)
      z = g.int22_37[type][type2][a][c][d][b];
    else
      z = g.internal_loop37[u1 + u2] + g.mismatchI37[type][a][b] +
          g.mismatchI37[type2][d][c];
  }
  return z / 100.0;
}

static double loop37_gapped(int type, int type2, int64_t i, int64_t j,
                            int64_t pp, int64_t qq, const uint8_t *qseq,
                            const uint8_t *dbseq) {
  const int u1 = (int)(pp - i - 1), u2 = (int)(qq - j - 1);
  double z;
  if (u1 == 0 && u2 == 0) {
    z = g.stack37[type][type2];
  } else if (u1 == 0 || u2 == 0) {
    const int u = u1 == 0 ? u2 : u1;
    z = u <= 30 ? g.bulge37[u] : g.bulge37[30] + g.lxc * std::log(u / 30.);
    if (u == 1) {
      z += g.stack37[type][type2];
    } else {
      if (type > 2) z += g.terminal_au37;
      if (type2 > 2) z += g.terminal_au37;
    }
  } else {
    const int a = mapc(qseq[i + 1]), b = mapc(dbseq[j + 1]);
    const int c = mapc(qseq[pp - 1]), d = mapc(dbseq[qq - 1]);
    if (u1 + u2 == 2)
      z = g.int11_37[type][type2][a][b];
    else if (u1 == 1 && u2 == 2)
      z = g.int21_37[type][type2][a][d][b];
    else if (u1 == 2 && u2 == 1)
      z = g.int21_37[type2][type][d][a][c];
    else if (u1 == 2 && u2 == 2)
      z = g.int22_37[type][type2][a][c][d][b];
    else
      z = g.internal_loop37[u1 + u2] + g.mismatchI37[type][a][b] +
          g.mismatchI37[type2][d][c];
  }
  return z / 100.0;
}

// ---------------------------------------------------------------------------
// Ungapped extension (reference: src/ungapped_extension.cpp:30-155).
// ---------------------------------------------------------------------------
static void ungapped_extend(std::vector<XHit> &hits, const QueryView &q,
                            const DbChunkView &db, const SearchParams &p) {
  const int d = p.min_acc_len;
  for (XHit &h : hits) {
    const float *dacc = db.acc_of(h.dbseq_id);
    const float *dcond = db.cond_of(h.dbseq_id);
    double min_e = h.energy, e = h.energy;
    double min_a = h.acc_e, a = h.acc_e;
    double min_h = h.hyb_e, hh = h.hyb_e;

    int64_t i = h.q_sp, pp = h.q_sp, j = h.db_sp, qq = h.db_sp;
    int64_t min_p = pp, min_q = qq;
    int id_start = h.dbseq_start;
    int id_end = id_start + h.db_len - 1;
    int min_id_start = id_start;

    for (;;) {
      i--;
      j--;
      id_end++;
      if (i < 0 || j < 0 || q.seq[i] < 2 || db.seq[j] < 2) break;
      // float32 arithmetic then widen, as in the reference
      // (ungapped_extension.cpp:62-65 — all operands are float)
      const double dacc_step =
          q.acc[i] - q.acc[i + 1] + q.cond[i + d] + dcond[id_end];
      e += dacc_step;
      a += dacc_step;
      const int type = g.bp[mapc(q.seq[i])][mapc(db.seq[j])];
      if (type != 0) {
        int type2 = g.bp[mapc(q.seq[pp])][mapc(db.seq[qq])];
        type2 = g.rtype[type2];
        const double le = loop37_nobulge(type, type2, i, j, pp, qq, q.seq,
                                         db.seq);
        e += le;
        hh += le;
        if (e < min_e) {
          min_e = e;
          min_a = a;
          min_h = hh;
          min_p = i;
          min_q = j;
        }
        pp = i;
        qq = j;
      }
      if (min_p - i >= p.dropout_wo_gap) break;
    }

    e = min_e;
    a = min_a;
    hh = min_h;
    int64_t k = h.q_sp + h.q_len - 1, r = k;
    int64_t l = h.db_sp + h.q_len - 1, s = l;
    int64_t min_r = r;
    for (;;) {
      k++;
      l++;
      id_start--;
      if (q.seq[k] < 2 || db.seq[l] < 2) break;
      // float32 arithmetic then widen (ungapped_extension.cpp:112-117)
      const double dacc_step = q.cond[k] + dacc[id_start] -
                               dacc[id_start + 1] + dcond[id_start + d];
      e += dacc_step;
      a += dacc_step;
      int type2 = g.bp[mapc(q.seq[k])][mapc(db.seq[l])];
      type2 = g.rtype[type2];
      if (type2 != 0) {
        const int type = g.bp[mapc(q.seq[r])][mapc(db.seq[s])];
        const double le = loop37_nobulge(type, type2, r, s, k, l, q.seq,
                                         db.seq);
        e += le;
        hh += le;
        if (e < min_e) {
          min_e = e;
          min_a = a;
          min_h = hh;
          min_r = k;
          min_id_start = id_start;
        }
        r = k;
        s = l;
      }
      if (k - min_r >= p.dropout_wo_gap) break;
    }

    h.dbseq_start = min_id_start;
    h.q_sp = (int)min_p;
    h.db_sp = (int)min_q;
    h.q_len = h.db_len = (int)(min_r - min_p + 1);
    h.energy = min_e;
    h.acc_e = min_a;
    h.hyb_e = min_h;
  }
}

// ---------------------------------------------------------------------------
// Gapped extension: anti-diagonal DP with pruned predecessor-stem list
// (reference: src/gapped_extension.cpp:33-319).
// ---------------------------------------------------------------------------
struct GCell {
  int first = -1, second = -1, type = 0;
  double hybrid = POS_INF;
};

struct GStem {
  int first, second, type;
};

static inline bool wobble(int type) { return type == 3 || type == 4; }

static int bp_type_at(int flag, const QueryView &q, const DbChunkView &db,
                      int64_t q_start, int64_t db_start, int i, int j, int x) {
  int qc, dc;
  if (flag == 0) {
    qc = safec(q.seq, q.n, q_start - i - x);
    dc = safec(db.seq, db.n, db_start - j - x);
  } else {
    qc = safec(q.seq, q.n, q_start + i + x);
    dc = safec(db.seq, db.n, db_start + j + x);
  }
  int type = g.bp[qc][dc];
  if (flag == 1) type = g.rtype[type];
  return type;
}

// minimum-helix/wobble admission check (reference: gapped_extension.cpp:342-364)
static int helix_type(int flag, const QueryView &q, const DbChunkView &db,
                      int64_t q_start, int64_t db_start, int i, int j,
                      const std::vector<std::vector<GCell>> &m,
                      int min_helix) {
  int t0 = bp_type_at(flag, q, db, q_start, db_start, i, j, 0);
  if (t0 != 0) {
    const GCell &prev = m[i - 1][j - 1];
    if (prev.type == 0 || (wobble(t0) && wobble(prev.type))) {
      for (int x = 1; x <= min_helix - 1; x++) {
        const int t = bp_type_at(flag, q, db, q_start, db_start, i, j, x);
        if (t == 0 || (x == 1 && wobble(t0) && wobble(t))) {
          t0 = 0;
          break;
        }
      }
    }
  }
  return t0;
}

// terminal dangle energy (reference: gapped_extension.cpp:366-399)
static double dangle37(int64_t q_pos, int64_t db_pos, int flag,
                       const QueryView &q, const DbChunkView &db) {
  double x = 0;
  const int qc = safec(q.seq, q.n, q_pos);
  const int dc = safec(db.seq, db.n, db_pos);
  const int type = flag == 0 ? g.bp[qc][dc] : g.bp[dc][qc];
  const int64_t q_length = q.n - 1;
  if (type != 0) {
    if (flag == 0) {
      if (q_pos > 0) x += g.dangle5_37[type][safec(q.seq, q.n, q_pos - 1)];
      if (db_pos > 0 && db.seq[db_pos - 1] != 0)
        x += g.dangle3_37[type][safec(db.seq, db.n, db_pos - 1)];
      if ((db_pos == 0 || db.seq[db_pos - 1] == 0) && type > 2)
        x += g.terminal_au37;
    } else {
      if (db_pos < db.n - 1 && db.seq[db_pos + 1] != 0)
        x += g.dangle5_37[type][safec(db.seq, db.n, db_pos + 1)];
      if (q_pos < q_length - 1)
        x += g.dangle3_37[type][safec(q.seq, q.n, q_pos + 1)];
      if ((db_pos == db.n - 1 || db.seq[db_pos + 1] == 0) && type > 2)
        x += g.terminal_au37;
    }
  }
  return x / 100.0;
}

static void gapped_extend_one(XHit &h, const QueryView &q,
                              const DbChunkView &db, const SearchParams &p,
                              int flag) {
  const int d = p.min_acc_len;
  const int dropout = p.dropout_w_gap;
  const float *dacc = db.acc_of(h.dbseq_id);
  const float *dcond = db.cond_of(h.dbseq_id);
  constexpr int kUnbounded = 100000;  // reference MAX_EXTENSION

  double min_energy = h.energy;
  const double first_a = h.acc_e;
  double min_a = first_a;
  int64_t q_start, db_start;
  if (flag == 0) {
    q_start = h.q_sp;
    db_start = h.db_sp;
  } else {
    q_start = h.q_sp + h.q_len - 1;
    db_start = h.db_sp + h.db_len - 1;
  }

  int max_q_ext = kUnbounded, max_db_ext = kUnbounded;
  const int id_start0 = h.dbseq_start;
  const int id_end0 = id_start0 + h.db_len - 1;

  int64_t min_q_start = q_start, min_db_start = db_start;
  const int q_len0 = h.q_len, db_len0 = h.db_len;
  int min_q_len = q_len0, min_db_len = db_len0;
  int min_id_start = id_start0;

  int length = 0, min_length = 0;
  std::vector<std::vector<GCell>> m(100, std::vector<GCell>(100));
  std::vector<double> ext_q_acc, ext_db_acc;
  ext_q_acc.reserve(128);
  ext_db_acc.reserve(128);

  {
    int type = g.bp[safec(q.seq, q.n, q_start)][safec(db.seq, db.n, db_start)];
    if (flag == 0) type = g.rtype[type];
    m[0][0] = {-1, -1, type, min_energy};
  }
  std::vector<GStem> stems;
  stems.reserve(128);
  stems.push_back({0, 0, m[0][0].type});

  for (;;) {
    length++;
    // boundary detection (sentinel / unknown char stops extension)
    if (flag == 0) {
      if (max_q_ext == kUnbounded &&
          (q_start - length < 0 || q.seq[q_start - length] < 2))
        max_q_ext = length - 1;
      if (max_db_ext == kUnbounded &&
          (db_start - length < 0 || db.seq[db_start - length] < 2))
        max_db_ext = length - 1;
    } else {
      if (max_q_ext == kUnbounded && q.seq[q_start + length] < 2)
        max_q_ext = length - 1;
      if (max_db_ext == kUnbounded && db.seq[db_start + length] < 2)
        max_db_ext = length - 1;
    }

    // prefix accessibility arrays (reference: gapped_extension.cpp:156-212).
    // At length 1 the reference computes in float32 and widens on push; at
    // length > 1 the running double promotes every operand, so the chain is
    // evaluated left-to-right in double. Both are replicated exactly.
    if (flag == 0) {
      if (max_q_ext == kUnbounded) {
        if (length == 1)
          ext_q_acc.push_back(q.acc[q_start - 1] - q.acc[q_start] +
                              q.cond[q_start - 1 + d]);
        else
          ext_q_acc.push_back(ext_q_acc[length - 2] +
                              q.acc[q_start - length] -
                              q.acc[q_start - length + 1] +
                              q.cond[q_start - length + d]);
      }
      if (max_db_ext == kUnbounded) {
        if (length == 1)
          ext_db_acc.push_back(dcond[id_end0 + 1]);
        else
          ext_db_acc.push_back(ext_db_acc[length - 2] +
                               dcond[id_end0 + length]);
      }
    } else {
      if (max_q_ext == kUnbounded) {
        if (length == 1)
          ext_q_acc.push_back(q.cond[q_start + 1]);
        else
          ext_q_acc.push_back(ext_q_acc[length - 2] +
                              q.cond[q_start + length]);
      }
      if (max_db_ext == kUnbounded) {
        if (length == 1)
          ext_db_acc.push_back(dacc[id_start0 - 1] - dacc[id_start0] +
                               dcond[id_start0 - 1 + d]);
        else
          ext_db_acc.push_back(ext_db_acc[length - 2] +
                               dacc[id_start0 - length] -
                               dacc[id_start0 - length + 1] +
                               dcond[id_start0 - length + d]);
      }
    }

    // prune stems whose loop would exceed the dropout window
    if (length - 2 > dropout) {
      stems.erase(std::remove_if(stems.begin(), stems.end(),
                                 [&](const GStem &st) {
                                   return length - st.first - st.second - 2 >
                                          dropout;
                                 }),
                  stems.end());
    }

    for (int i = 1; i <= length - 1; i++) {
      const int j = length - i;
      if (i <= max_q_ext && j <= max_db_ext) {
        const int type1 =
            helix_type(flag, q, db, q_start, db_start, i, j, m, p.min_helix);
        if (type1 != 0) {
          int min_k = 0;
          double hybrid = POS_INF;
          const int sc_size = (int)stems.size();
          for (int k = 0; k < sc_size; k++) {
            const GStem &st = stems[k];
            if (st.first < i && st.second < j) {
              double ce;
              if (flag == 0) {
                ce = loop37_gapped(type1, st.type, q_start - i, db_start - j,
                                   q_start - st.first, db_start - st.second,
                                   q.seq, db.seq);
              } else {
                ce = loop37_gapped(st.type, type1, q_start + st.first,
                                   db_start + st.second, q_start + i,
                                   db_start + j, q.seq, db.seq);
              }
              ce += m[st.first][st.second].hybrid;
              if (ce < hybrid) {
                hybrid = ce;
                min_k = k;
              }
            }
          }
          m[i][j] = {stems[min_k].first, stems[min_k].second,
                     stems[min_k].type, hybrid};

          const double interaction =
              ext_q_acc[i - 1] + ext_db_acc[j - 1] + hybrid;
          stems.push_back({i, j, g.rtype[type1]});
          if (interaction < min_energy) {
            min_energy = interaction;
            min_a = first_a + ext_q_acc[i - 1] + ext_db_acc[j - 1];
            min_length = length;
            if (flag == 0) {
              min_q_start = q_start - i;
              min_db_start = db_start - j;
            } else {
              min_id_start = id_start0 - j;
            }
            min_q_len = q_len0 + i;
            min_db_len = db_len0 + j;
          }
        }
      }
      // grow the square matrix like the reference (one row+col per step)
      if ((size_t)(i + 1) == m.size()) {
        for (auto &row : m) row.emplace_back();
        m.emplace_back(m.size() + 1);
      }
    }

    if (length - min_length >= dropout) break;
    if (max_q_ext != kUnbounded && max_db_ext != kUnbounded) break;
  }

  // traceback along stored predecessor links
  // (reference: gapped_extension.cpp:300-308,409-424)
  if (q_len0 - min_q_len != 0 && db_len0 - min_db_len != 0) {
    int ti, tj;
    if (flag == 0) {
      ti = (int)(q_start - min_q_start);
      tj = (int)(db_start - min_db_start);
    } else {
      ti = min_q_len - q_len0;
      tj = min_db_len - db_len0;
    }
    while (ti != 0 && tj != 0) {
      if (flag == 0)
        h.bps.emplace_back((int)(q_start - ti), (int)(db_start - tj));
      else
        h.bps.emplace_back((int)(q_start + ti), (int)(db_start + tj));
      const GCell &c = m[ti][tj];
      ti = c.first;
      tj = c.second;
    }
  }

  h.dbseq_start = min_id_start;
  if (flag == 0) {
    h.q_sp = (int)min_q_start;
    h.db_sp = (int)min_db_start;
  }
  h.q_len = min_q_len;
  h.db_len = min_db_len;
  h.energy = min_energy;
  h.acc_e = min_a;
  h.hyb_e = min_energy - min_a;
}

static void add_dangles(std::vector<XHit> &hits, const QueryView &q,
                        const DbChunkView &db) {
  for (XHit &h : hits) {
    double e = h.energy, hh = h.hyb_e;
    const double d5 = dangle37(h.q_sp, h.db_sp, 0, q, db);
    const double d3 =
        dangle37(h.q_sp + h.q_len - 1, h.db_sp + h.db_len - 1, 1, q, db);
    e += d5;
    e += d3;
    hh += d5;
    hh += d3;
    h.energy = e;
    h.hyb_e = hh;
  }
}

static void gapped_extend(std::vector<XHit> &hits, const QueryView &q,
                          const DbChunkView &db, const SearchParams &p) {
  for (XHit &h : hits) {
    gapped_extend_one(h, q, db, p, 0);
    gapped_extend_one(h, q, db, p, 1);
  }
  add_dangles(hits, q, db);
}

// hit ordering (reference: rna_interaction_search.cpp:45-55)
static bool hit_before(const XHit &a, const XHit &b) {
  if (a.db_sp != b.db_sp) return a.db_sp < b.db_sp;
  if (a.q_sp != b.q_sp) return a.q_sp < b.q_sp;
  if (a.db_len != b.db_len) return a.db_len > b.db_len;
  return a.q_len > b.q_len;
}

// containment redundancy removal, keep lower energy
// (reference: rna_interaction_search.cpp:387-424)
static void drop_redundant(std::vector<XHit> &hits, double thr) {
  const size_t n = hits.size();
  for (size_t i = 0; i < n; i++) {
    if (hits[i].energy > thr) hits[i].flag = true;
    if (hits[i].flag) continue;
    const int a_qsp = hits[i].q_sp, a_dbsp = hits[i].db_sp;
    const int a_qep = a_qsp + hits[i].q_len - 1;
    const int a_dbep = a_dbsp + hits[i].db_len - 1;
    for (size_t j = i + 1; j < n; j++) {
      if (hits[j].flag) continue;
      const int b_dbsp = hits[j].db_sp;
      if (a_dbep < b_dbsp) break;
      const int b_qsp = hits[j].q_sp;
      const int b_qep = b_qsp + hits[j].q_len - 1;
      const int b_dbep = b_dbsp + hits[j].db_len - 1;
      if (a_qep >= b_qep && a_qsp <= b_qsp && a_dbep >= b_dbep) {
        if (hits[i].energy > hits[j].energy)
          hits[i].flag = true;
        else
          hits[j].flag = true;
      }
    }
  }
  hits.erase(std::remove_if(hits.begin(), hits.end(),
                            [](const XHit &h) { return h.flag; }),
             hits.end());
}

// seed-region base pairs (reference: rna_interaction_search.cpp:371-385).
// For soft-masked chars (6..9) the reference indexes BP_pair out of bounds
// (UB); we use the masked-as-unmasked pairing (see mapc) instead, which is
// well-defined and matches the reference for repeat_flag 0 and 2.
static void collect_seed_bps(std::vector<XHit> &hits, const QueryView &q,
                             const DbChunkView &db) {
  for (XHit &h : hits) {
    for (int j = 0; j < h.q_len; j++) {
      const uint8_t qc = q.seq[h.q_sp + j];
      const uint8_t dc = db.seq[h.db_sp + j];
      const int qi = qc <= 5 ? qc - 1 : qc - 5;
      const int di = dc <= 5 ? dc - 1 : dc - 5;
      if (g.bp[qi][di] != 0) h.bps.emplace_back(h.q_sp + j, h.db_sp + j);
    }
  }
}

// ---------------------------------------------------------------------------
// Full per-query-per-chunk chain; results kept in a handle for staged copy.
// ---------------------------------------------------------------------------
struct ResultHandle {
  std::vector<XHit> hits;
};

extern "C" void *rp_search_chunk(
    const uint8_t *q_seq, int q_n, const int32_t *q_sa, const float *q_acc,
    const float *q_cond, const uint8_t *db_seq, int64_t db_n,
    const int32_t *db_sa, const int32_t *hstart, const int32_t *hend,
    const float *db_acc, const float *db_cond, const int64_t *db_acc_off,
    const int64_t *db_cond_off, const int32_t *db_seq_len,
    const int32_t *db_start_pos, int n_seqs, int hash_size,
    int max_seed_length, int min_acc_len, double hybrid_thr,
    double interaction_thr, double final_thr, int dropout_wo_gap,
    int dropout_w_gap, int min_helix, int stage) {
  if (!g.ready) return nullptr;
  QueryView q{q_seq, q_n, q_sa, q_acc, q_cond};
  DbChunkView db{db_seq,     db_n,       db_sa,      hstart,
                 hend,       db_acc,     db_cond,    db_acc_off,
                 db_cond_off, db_seq_len, db_start_pos, n_seqs};
  SearchParams p{hash_size,       max_seed_length, min_acc_len,
                 hybrid_thr,      interaction_thr, final_thr,
                 dropout_wo_gap,  dropout_w_gap,   min_helix};

  auto *res = new ResultHandle;
  SeedSearcher seeder(q, db, p);
  seeder.run();
  if (stage == 4) {
    // raw seed candidates (SA interval pairs), packed into XHit fields for
    // the shared copy ABI: q_sp/db_sp = query interval, q_len/db_len = db
    // interval, dbseq_id = seed length, hyb_e = hybrid energy. Consumed by
    // the device expansion stage (search/seed.py).
    res->hits.reserve(seeder.out.size());
    for (const SeedCandidate &c : seeder.out) {
      XHit h;
      h.q_sp = c.sp_q;
      h.db_sp = c.ep_q;
      h.q_len = c.sp_db;
      h.db_len = c.ep_db;
      h.dbseq_id = c.length;
      h.dbseq_start = 0;
      h.acc_e = 0.0;
      h.hyb_e = c.energy;
      h.energy = c.energy;
      res->hits.push_back(std::move(h));
    }
    return res;
  }
  expand_candidates(seeder.out, q, db, p, res->hits);
  if (stage == 1) return res;  // pre-ungapped hits (for kernel validation)
  ungapped_extend(res->hits, q, db, p);
  if (stage == 2) return res;  // post-ungapped hits
  std::sort(res->hits.begin(), res->hits.end(), hit_before);
  drop_redundant(res->hits, p.interaction_thr);
  collect_seed_bps(res->hits, q, db);
  gapped_extend(res->hits, q, db, p);
  // the reference sorts base pairs for hits 1..n-1 only (its loop starts at
  // index 1 — see rna_interaction_search.cpp:314-317); replicated for parity
  for (size_t i = 1; i < res->hits.size(); i++) {
    std::sort(res->hits[i].bps.begin(), res->hits[i].bps.end(),
              [](const std::pair<int, int> &a, const std::pair<int, int> &b) {
                return a.first < b.first;
              });
  }
  std::sort(res->hits.begin(), res->hits.end(), hit_before);
  drop_redundant(res->hits, p.final_thr);
  return res;
}

// Resume the chain after an externally-computed ungapped extension (the
// device kernel): sort, dedup, seed base pairs, gapped extension, final
// dedup — identical to the tail of rp_search_chunk.
extern "C" void *rp_chain_from_hits(
    const uint8_t *q_seq, int q_n, const float *q_acc, const float *q_cond,
    const uint8_t *db_seq, int64_t db_n, const float *db_acc,
    const float *db_cond, const int64_t *db_acc_off,
    const int64_t *db_cond_off, const int32_t *db_seq_len,
    const int32_t *db_start_pos, int n_seqs, int min_acc_len,
    double interaction_thr, double final_thr, int dropout_w_gap,
    int min_helix, int64_t n_hits, const int32_t *dbseq_id,
    const int32_t *dbseq_start, const int32_t *q_sp, const int32_t *db_sp,
    const int32_t *q_len, const int32_t *db_len, const double *acc_e,
    const double *hyb_e, const double *energy) {
  if (!g.ready) return nullptr;
  QueryView q{q_seq, q_n, nullptr, q_acc, q_cond};
  DbChunkView db{db_seq,      db_n,        nullptr,     nullptr,
                 nullptr,     db_acc,      db_cond,     db_acc_off,
                 db_cond_off, db_seq_len,  db_start_pos, n_seqs};
  SearchParams p{};
  p.min_acc_len = min_acc_len;
  p.interaction_thr = interaction_thr;
  p.final_thr = final_thr;
  p.dropout_w_gap = dropout_w_gap;
  p.min_helix = min_helix;

  auto *res = new ResultHandle;
  res->hits.resize(n_hits);
  for (int64_t i = 0; i < n_hits; i++) {
    XHit &h = res->hits[i];
    h.dbseq_id = dbseq_id[i];
    h.dbseq_start = dbseq_start[i];
    h.q_sp = q_sp[i];
    h.db_sp = db_sp[i];
    h.q_len = q_len[i];
    h.db_len = db_len[i];
    h.acc_e = acc_e[i];
    h.hyb_e = hyb_e[i];
    h.energy = energy[i];
  }
  std::sort(res->hits.begin(), res->hits.end(), hit_before);
  drop_redundant(res->hits, p.interaction_thr);
  collect_seed_bps(res->hits, q, db);
  gapped_extend(res->hits, q, db, p);
  for (size_t i = 1; i < res->hits.size(); i++) {
    std::sort(res->hits[i].bps.begin(), res->hits[i].bps.end(),
              [](const std::pair<int, int> &a, const std::pair<int, int> &b) {
                return a.first < b.first;
              });
  }
  std::sort(res->hits.begin(), res->hits.end(), hit_before);
  drop_redundant(res->hits, p.final_thr);
  return res;
}

static void load_hits(std::vector<XHit> &hits, int64_t n,
                      const int32_t *dbseq_id, const int32_t *dbseq_start,
                      const int32_t *q_sp, const int32_t *db_sp,
                      const int32_t *q_len, const int32_t *db_len,
                      const double *acc_e, const double *hyb_e,
                      const double *energy) {
  hits.resize(n);
  for (int64_t i = 0; i < n; i++) {
    XHit &h = hits[i];
    h.dbseq_id = dbseq_id[i];
    h.dbseq_start = dbseq_start[i];
    h.q_sp = q_sp[i];
    h.db_sp = db_sp[i];
    h.q_len = q_len[i];
    h.db_len = db_len[i];
    h.acc_e = acc_e[i];
    h.hyb_e = hyb_e[i];
    h.energy = energy[i];
  }
}

// Middle of the chain for the device-extend path: post-ungapped hits ->
// sort, interaction-threshold dedup, seed base pairs (the part of
// rp_chain_from_hits before the gapped extension).
extern "C" void *rp_chain_mid(const uint8_t *q_seq, int q_n,
                              const uint8_t *db_seq, int64_t db_n,
                              double interaction_thr, int64_t n_hits,
                              const int32_t *dbseq_id,
                              const int32_t *dbseq_start, const int32_t *q_sp,
                              const int32_t *db_sp, const int32_t *q_len,
                              const int32_t *db_len, const double *acc_e,
                              const double *hyb_e, const double *energy) {
  if (!g.ready) return nullptr;
  QueryView q{q_seq, q_n, nullptr, nullptr, nullptr};
  DbChunkView db{};
  db.seq = db_seq;
  db.n = db_n;
  auto *res = new ResultHandle;
  load_hits(res->hits, n_hits, dbseq_id, dbseq_start, q_sp, db_sp, q_len,
            db_len, acc_e, hyb_e, energy);
  std::sort(res->hits.begin(), res->hits.end(), hit_before);
  drop_redundant(res->hits, interaction_thr);
  collect_seed_bps(res->hits, q, db);
  return res;
}

// Host gapped extension for a hit subset (device-kernel oracle and
// max_ext-overflow fallback). No dangle energies; base pairs returned are
// the gapped tracebacks only.
extern "C" void *rp_gapped_extend(
    const uint8_t *q_seq, int q_n, const float *q_acc, const float *q_cond,
    const uint8_t *db_seq, int64_t db_n, const float *db_acc,
    const float *db_cond, const int64_t *db_acc_off,
    const int64_t *db_cond_off, const int32_t *db_seq_len,
    const int32_t *db_start_pos, int n_seqs, int min_acc_len,
    int dropout_w_gap, int min_helix, int64_t n_hits,
    const int32_t *dbseq_id, const int32_t *dbseq_start, const int32_t *q_sp,
    const int32_t *db_sp, const int32_t *q_len, const int32_t *db_len,
    const double *acc_e, const double *hyb_e, const double *energy) {
  if (!g.ready) return nullptr;
  QueryView q{q_seq, q_n, nullptr, q_acc, q_cond};
  DbChunkView db{db_seq,      db_n,       nullptr,      nullptr,
                 nullptr,     db_acc,     db_cond,      db_acc_off,
                 db_cond_off, db_seq_len, db_start_pos, n_seqs};
  SearchParams p{};
  p.min_acc_len = min_acc_len;
  p.dropout_w_gap = dropout_w_gap;
  p.min_helix = min_helix;
  auto *res = new ResultHandle;
  load_hits(res->hits, n_hits, dbseq_id, dbseq_start, q_sp, db_sp, q_len,
            db_len, acc_e, hyb_e, energy);
  for (XHit &h : res->hits) {
    gapped_extend_one(h, q, db, p, 0);
    gapped_extend_one(h, q, db, p, 1);
  }
  return res;
}

// Tail of the chain for the device-extend path: post-gapped hits with their
// base-pair lists (seed bps + both tracebacks, in reference push order) ->
// dangle energies, per-hit bp sort (hits 1..n-1 only, a reference parity
// quirk), final sort, final-threshold dedup.
extern "C" void *rp_chain_finish(
    const uint8_t *q_seq, int q_n, const uint8_t *db_seq, int64_t db_n,
    double final_thr, int64_t n_hits, const int32_t *dbseq_id,
    const int32_t *dbseq_start, const int32_t *q_sp, const int32_t *db_sp,
    const int32_t *q_len, const int32_t *db_len, const double *acc_e,
    const double *hyb_e, const double *energy, const int64_t *bp_off,
    const int32_t *bp_q, const int32_t *bp_db) {
  if (!g.ready) return nullptr;
  QueryView q{q_seq, q_n, nullptr, nullptr, nullptr};
  DbChunkView db{};
  db.seq = db_seq;
  db.n = db_n;
  auto *res = new ResultHandle;
  load_hits(res->hits, n_hits, dbseq_id, dbseq_start, q_sp, db_sp, q_len,
            db_len, acc_e, hyb_e, energy);
  for (int64_t i = 0; i < n_hits; i++) {
    XHit &h = res->hits[i];
    h.bps.reserve(bp_off[i + 1] - bp_off[i]);
    for (int64_t b = bp_off[i]; b < bp_off[i + 1]; b++)
      h.bps.emplace_back(bp_q[b], bp_db[b]);
  }
  add_dangles(res->hits, q, db);
  for (size_t i = 1; i < res->hits.size(); i++) {
    std::sort(res->hits[i].bps.begin(), res->hits[i].bps.end(),
              [](const std::pair<int, int> &a, const std::pair<int, int> &b) {
                return a.first < b.first;
              });
  }
  std::sort(res->hits.begin(), res->hits.end(), hit_before);
  drop_redundant(res->hits, final_thr);
  return res;
}

extern "C" void rp_result_sizes(void *handle, int64_t *n_hits,
                                int64_t *n_bps) {
  auto *res = (ResultHandle *)handle;
  *n_hits = (int64_t)res->hits.size();
  int64_t bps = 0;
  for (const XHit &h : res->hits) bps += (int64_t)h.bps.size();
  *n_bps = bps;
}

extern "C" void rp_result_copy(void *handle, int32_t *dbseq_id,
                               int32_t *dbseq_start, int32_t *q_sp,
                               int32_t *db_sp, int32_t *q_len,
                               int32_t *db_len, double *acc_e, double *hyb_e,
                               double *energy, int64_t *bp_off, int32_t *bp_q,
                               int32_t *bp_db) {
  auto *res = (ResultHandle *)handle;
  int64_t bp = 0;
  for (size_t i = 0; i < res->hits.size(); i++) {
    const XHit &h = res->hits[i];
    dbseq_id[i] = h.dbseq_id;
    dbseq_start[i] = h.dbseq_start;
    q_sp[i] = h.q_sp;
    db_sp[i] = h.db_sp;
    q_len[i] = h.q_len;
    db_len[i] = h.db_len;
    acc_e[i] = h.acc_e;
    hyb_e[i] = h.hyb_e;
    energy[i] = h.energy;
    bp_off[i] = bp;
    for (const auto &pr : h.bps) {
      bp_q[bp] = pr.first;
      bp_db[bp] = pr.second;
      bp++;
    }
  }
  bp_off[res->hits.size()] = bp;
}

extern "C" void rp_result_free(void *handle) {
  delete (ResultHandle *)handle;
}

// Descending-length argsort with libstdc++ std::sort so the permutation of
// equal-length sequences matches the reference exactly
// (reference: src/utils.cpp:56-63).
extern "C" void rp_argsort_desc(const int64_t *lengths, int64_t n,
                                int32_t *order) {
  for (int64_t i = 0; i < n; i++) order[i] = (int32_t)i;
  std::sort(order, order + n, [&](int32_t a, int32_t b) {
    return lengths[b] < lengths[a];
  });
}

}  // namespace rp
