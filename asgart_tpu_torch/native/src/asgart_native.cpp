// asgart_tpu native runtime, exposed through a plain C API for ctypes.
//
// Components:
//   1. suffix-array construction: SA-IS (the test oracle; the reference
//      uses libdivsufsort, src/divsufsort.rs:8-33) and the production
//      builder `asgart_build_position_index_codes*` — parallel MSD-bucket
//      k-mer sort + Manber-Myers prefix doubling over unresolved groups,
//      emitting the suffix array, fused per-position equal-range tables,
//      and optionally the sorted keys.
//   2. seed lookups: `asgart_batch_equal_range[_bucketed]` (parallel
//      binary search, prefix-bucket accelerated) + k-mer packing
//      (`asgart_pack_kmers`, `asgart_pack_at`).
//   3. the gap-tolerant arm-extension automaton ("chaining") consuming a
//      stream of per-probe suffix-array ranges — semantics match the
//      reference automaton (src/automaton.rs:57-216) exactly, including
//      snapshot classification, greedy first-arm assignment, gap aging by
//      step_size, the 200-arm prune and simultaneous-death families.
//   4. Levenshtein distance (two-row DP) for --compute-score
//      (reference: bio::alignment::distance::levenshtein).
//
// Build: g++ -O3 -shared -fPIC (see asgart_tpu/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#if defined(__linux__)
#include <sys/mman.h>
#endif
#include <thread>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <limits>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SA-IS
// ---------------------------------------------------------------------------

// Core SA-IS over s[0..m) where s[m-1] is a unique smallest sentinel (0).
// Alphabet size K (values in [0, K)). sa must have length m.
void sais_rec(const int64_t* s, int64_t* sa, int64_t m, int64_t K) {
  if (m == 1) {
    sa[0] = 0;
    return;
  }

  std::vector<uint8_t> t(m);  // 1 = S-type, 0 = L-type
  t[m - 1] = 1;
  for (int64_t i = m - 2; i >= 0; --i)
    t[i] = (s[i] < s[i + 1] || (s[i] == s[i + 1] && t[i + 1])) ? 1 : 0;

  auto is_lms = [&](int64_t i) -> bool {
    return i > 0 && t[i] && !t[i - 1];
  };

  std::vector<int64_t> bkt(K);
  auto get_buckets = [&](bool end) {
    std::fill(bkt.begin(), bkt.end(), 0);
    for (int64_t i = 0; i < m; ++i) bkt[s[i]]++;
    int64_t sum = 0;
    for (int64_t i = 0; i < K; ++i) {
      sum += bkt[i];
      bkt[i] = end ? sum : sum - bkt[i];
    }
  };

  auto induce = [&]() {
    // induce L-type from sorted (partial) S/LMS positions
    get_buckets(false);
    for (int64_t i = 0; i < m; ++i) {
      int64_t j = sa[i];
      if (j > 0 && !t[j - 1]) sa[bkt[s[j - 1]]++] = j - 1;
    }
    // induce S-type
    get_buckets(true);
    for (int64_t i = m - 1; i >= 0; --i) {
      int64_t j = sa[i];
      if (j > 0 && t[j - 1]) sa[--bkt[s[j - 1]]] = j - 1;
    }
  };

  // Stage 1: place LMS suffixes at bucket ends (arbitrary order), induce.
  std::fill(sa, sa + m, -1);
  get_buckets(true);
  for (int64_t i = 1; i < m; ++i)
    if (is_lms(i)) sa[--bkt[s[i]]] = i;
  induce();

  // Stage 2: name sorted LMS substrings.
  int64_t n1 = 0;
  for (int64_t i = 0; i < m; ++i)
    if (sa[i] > 0 && is_lms(sa[i])) sa[n1++] = sa[i];
  std::fill(sa + n1, sa + m, -1);

  int64_t name = 0, prev = -1;
  for (int64_t i = 0; i < n1; ++i) {
    int64_t pos = sa[i];
    bool diff = false;
    for (int64_t d = 0; d < m; ++d) {
      if (prev < 0 || s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
        diff = true;
        break;
      }
      if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
    }
    if (diff) {
      ++name;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  // compact names to the tail of sa
  for (int64_t i = m - 1, j = m - 1; i >= n1; --i)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // Stage 3: sort the reduced problem, then map back and induce.
  int64_t* s1 = sa + m - n1;
  if (name < n1) {
    sais_rec(s1, sa, n1, name);
  } else {
    for (int64_t i = 0; i < n1; ++i) sa[s1[i]] = i;
  }
  // gather LMS positions in text order
  std::vector<int64_t> p(n1);
  for (int64_t i = 1, j = 0; i < m; ++i)
    if (is_lms(i)) p[j++] = i;
  for (int64_t i = 0; i < n1; ++i) sa[i] = p[sa[i]];
  std::fill(sa + n1, sa + m, -1);
  get_buckets(true);
  for (int64_t i = n1 - 1; i >= 0; --i) {
    int64_t j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
  }
  induce();
}

// ---------------------------------------------------------------------------
// Chaining automaton
// ---------------------------------------------------------------------------

struct Arm {
  int64_t l_start, l_end;
  int64_t r_start, r_end;
  int64_t gap;
  bool active, dirty;
};

// Minimal distance between an arm's right segment and a match segment
// (automaton.rs:207-216).
inline int64_t d_ss(int64_t a_start, int64_t a_end, int64_t m_start,
                    int64_t m_end) {
  if ((m_start >= a_start && m_start <= a_end) ||
      (m_end >= a_start && m_end <= a_end))
    return 0;
  int64_t d1 = a_start - m_end;
  if (d1 < 0) d1 = -d1;
  int64_t d2 = a_end - m_start;
  if (d2 < 0) d2 = -d2;
  return d1 < d2 ? d1 : d2;
}

}  // namespace

extern "C" {

// Build the suffix array of text[0..n) (arbitrary bytes, '$' included by the
// caller). sa_out must have length n. Returns 0 on success.
int asgart_sais(const uint8_t* text, int64_t n, int64_t* sa_out) {
  if (n <= 0) return 0;
  // Shift bytes by +1 and append the 0 sentinel so the generic core can
  // assume a unique smallest last symbol; drop the sentinel row afterwards.
  std::vector<int64_t> s(n + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = int64_t(text[i]) + 1;
  s[n] = 0;
  std::vector<int64_t> sa(n + 1);
  sais_rec(s.data(), sa.data(), n + 1, 258);
  std::memcpy(sa_out, sa.data() + 1, sizeof(int64_t) * n);
  return 0;
}

struct ChainParams {
  int64_t probe_size;
  int64_t step_size;
  int64_t max_gap_size;
  int64_t min_duplication_length;
  int64_t max_cardinality;
  int64_t needle_offset;
  int64_t needle_len;
  int64_t reverse;        // 1 = reversed-mode direction filter
  int64_t max_match_pos;  // drop matches at/after this position (the
                          // doubled-text index interleaves transformed-half
                          // positions into the equal ranges)
  int64_t sa_is_i32;      // the sa pointer holds int32 positions
};

// Run the arm automaton over a stream of processed probes.
//
//   probe_is[p]  : needle-relative probe index i (ascending)
//   los/his[p]   : SA range [lo, hi) of the probe's exact k-mer matches
//   sa           : the suffix array (absolute positions)
//
// Per-probe behavior (automaton.rs:96-201): matches = sa[lo..hi) in SA
// order, filtered by self-hit (m.start != i) and the direction predicate;
// probes whose filtered match count exceeds max_cardinality are skipped
// entirely (no gap aging). The caller must already have excluded N-probes.
//
// Outputs: flat SDs (4 int64: left, right, left_len, right_len) plus a
// family-size array. Returns 0 on success, 1 if capacities were exceeded
// (n_sds_out / n_families_out then hold the required sizes).
int asgart_chain(const ChainParams* prm, const int64_t* sa,
                 const int64_t* probe_is, const int64_t* los,
                 const int64_t* his, int64_t n_probes, int64_t* out_sds,
                 int64_t* out_family_sizes, int64_t cap_sds,
                 int64_t cap_families, int64_t* n_sds_out,
                 int64_t* n_families_out) {
  std::vector<Arm> arms;
  std::vector<int64_t> m_starts;
  std::vector<int32_t> ops;  // >=0: extend arm idx; -1: new arm

  int64_t n_sds = 0, n_families = 0;
  bool overflow = false;
  const int64_t ps = prm->probe_size;

  for (int64_t p = 0; p < n_probes; ++p) {
    const int64_t i = probe_is[p];

    // Gather + filter matches (searcher offset is 0: m.start = sa value).
    m_starts.clear();
    const int32_t* sa32 = (const int32_t*)sa;
    for (int64_t r = los[p]; r < his[p]; ++r) {
      const int64_t m_start = prm->sa_is_i32 ? int64_t(sa32[r]) : sa[r];
      if (m_start >= prm->max_match_pos) continue;  // transformed-half hit
      if (m_start == i) continue;  // self-hit filter (automaton.rs:106)
      if (!prm->reverse) {
        if (!(m_start > i + prm->needle_offset)) continue;
      } else {
        if (!(m_start >= prm->needle_offset + prm->needle_len - i)) continue;
      }
      m_starts.push_back(m_start);
    }
    if ((int64_t)m_starts.size() > prm->max_cardinality) continue;

    for (auto& a : arms) a.dirty = false;

    // Classify every match against the pre-step arm snapshot
    // (matches.par_iter in the reference: all see the same arms).
    ops.resize(m_starts.size());
    for (size_t mi = 0; mi < m_starts.size(); ++mi) {
      const int64_t m_start = m_starts[mi];
      const int64_t m_end = m_start + ps;
      int32_t op = -1;
      for (size_t j = 0; j < arms.size(); ++j) {
        const Arm& a = arms[j];
        if (!a.active) continue;
        const int64_t allow =
            std::max(prm->max_gap_size,
                     (int64_t)(0.1 * (double)(a.l_end - a.l_start)));
        if (d_ss(a.r_start, a.r_end, m_start, m_end) < allow &&
            m_end > a.r_end) {
          op = (int32_t)j;
          break;
        }
      }
      ops[mi] = op;
    }

    // Apply extensions in match order (last writer wins on r_end).
    for (size_t mi = 0; mi < m_starts.size(); ++mi) {
      if (ops[mi] >= 0) {
        Arm& a = arms[ops[mi]];
        a.l_end = i + ps;
        a.r_end = m_starts[mi] + ps;
        a.dirty = true;
        a.gap = 0;
      }
    }
    // Spawn new arms in match order.
    for (size_t mi = 0; mi < m_starts.size(); ++mi) {
      if (ops[mi] < 0) {
        arms.push_back(Arm{i, i + ps, m_starts[mi], m_starts[mi] + ps, 0,
                           true, false});
      }
    }

    // Age the gap of every non-dirty arm (new arms included,
    // automaton.rs:166-171).
    for (auto& a : arms) {
      if (!a.dirty) {
        a.gap += prm->step_size;
        if (a.gap >= prm->max_gap_size) a.active = false;
      }
    }

    // Prune when the arm set grows beyond 200 (automaton.rs:173-179).
    if (arms.size() > 200) {
      arms.erase(std::remove_if(arms.begin(), arms.end(),
                                [&](const Arm& a) {
                                  return !(a.active ||
                                           a.l_end - a.l_start >=
                                               prm->min_duplication_length ||
                                           a.r_end - a.r_start >=
                                               prm->min_duplication_length);
                                }),
                 arms.end());
    }

    // Simultaneous death: emit one family (automaton.rs:182-200).
    if (!arms.empty()) {
      bool any_active = false;
      for (const auto& a : arms)
        if (a.active) {
          any_active = true;
          break;
        }
      if (!any_active) {
        int64_t fam_size = 0;
        for (const auto& a : arms) {
          if (a.r_end - a.r_start >= prm->min_duplication_length) {
            if (n_sds < cap_sds) {
              out_sds[4 * n_sds + 0] = a.l_start;
              out_sds[4 * n_sds + 1] = a.r_start;
              out_sds[4 * n_sds + 2] = a.l_end - a.l_start;
              out_sds[4 * n_sds + 3] = a.r_end - a.r_start;
            } else {
              overflow = true;
            }
            ++n_sds;
            ++fam_size;
          }
        }
        if (fam_size > 0) {
          if (n_families < cap_families)
            out_family_sizes[n_families] = fam_size;
          else
            overflow = true;
          ++n_families;
        }
        arms.clear();
      }
    }
  }
  // Arms still alive when the probe stream ends are dropped, like the
  // reference's end-of-needle behavior.
  *n_sds_out = n_sds;
  *n_families_out = n_families;
  return overflow ? 1 : 0;
}

// Event-stream variant of the automaton: consumes only probes that have
// at least one kept match ("events"), with the number of intervening
// aging steps (valid zero-match probes) precomputed. The device engine
// compacts the probe stream on the TPU and downloads just the events;
// this entry replays the exact per-step semantics of `asgart_chain`
// (aging, the 200-arm prune, simultaneous-death families) by simulating
// the skipped steps — bounded by the arm-death horizon, after which a
// quiet run cannot change state further.
//
//   probe_is[e]   : needle-relative probe index of event e (ascending)
//   z_before[e]   : count of valid zero-match probes since the previous
//                   event (aging steps to apply BEFORE event e)
//   m_offsets[e]  : CSR offsets into m_starts (kept matches, SA order,
//                   already self/direction/cardinality filtered upstream;
//                   every event satisfies 1 <= count <= max_cardinality)
//   z_trail       : valid zero-match probes after the last event (arms
//                   still alive after those steps are dropped, matching
//                   the end-of-needle behavior)
int asgart_chain_events(const ChainParams* prm, const int64_t* probe_is,
                        const int64_t* z_before, const int64_t* m_offsets,
                        const int64_t* m_starts, int64_t n_events,
                        int64_t z_trail, int64_t* out_sds,
                        int64_t* out_family_sizes, int64_t cap_sds,
                        int64_t cap_families, int64_t* n_sds_out,
                        int64_t* n_families_out) {
  std::vector<Arm> arms;
  std::vector<int32_t> ops;
  int64_t n_sds = 0, n_families = 0;
  bool overflow = false;
  const int64_t ps = prm->probe_size;

  auto prune = [&]() {
    if (arms.size() > 200) {
      arms.erase(std::remove_if(arms.begin(), arms.end(),
                                [&](const Arm& a) {
                                  return !(a.active ||
                                           a.l_end - a.l_start >=
                                               prm->min_duplication_length ||
                                           a.r_end - a.r_start >=
                                               prm->min_duplication_length);
                                }),
                 arms.end());
    }
  };
  auto emit_if_all_dead = [&]() {
    if (arms.empty()) return;
    for (const auto& a : arms)
      if (a.active) return;
    int64_t fam_size = 0;
    for (const auto& a : arms) {
      if (a.r_end - a.r_start >= prm->min_duplication_length) {
        if (n_sds < cap_sds) {
          out_sds[4 * n_sds + 0] = a.l_start;
          out_sds[4 * n_sds + 1] = a.r_start;
          out_sds[4 * n_sds + 2] = a.l_end - a.l_start;
          out_sds[4 * n_sds + 3] = a.r_end - a.r_start;
        } else {
          overflow = true;
        }
        ++n_sds;
        ++fam_size;
      }
    }
    if (fam_size > 0) {
      if (n_families < cap_families)
        out_family_sizes[n_families] = fam_size;
      else
        overflow = true;
      ++n_families;
    }
    arms.clear();
  };
  // z skipped quiet steps, each: age-all, prune, emit-check. Arms only
  // ever lose activity during a quiet run, so once none are active (and
  // the emission fired) the remaining steps are no-ops.
  auto apply_aging = [&](int64_t z) {
    for (int64_t s = 0; s < z && !arms.empty(); ++s) {
      bool any_active = false;
      for (auto& a : arms) {
        a.gap += prm->step_size;
        if (a.gap >= prm->max_gap_size) a.active = false;
        any_active |= a.active;
      }
      prune();
      emit_if_all_dead();
      if (!any_active) break;  // arms now cleared or permanently inert
    }
  };

  for (int64_t e = 0; e < n_events; ++e) {
    apply_aging(z_before[e]);
    const int64_t i = probe_is[e];
    const int64_t mb = m_offsets[e], me = m_offsets[e + 1];

    for (auto& a : arms) a.dirty = false;
    ops.resize(me - mb);
    for (int64_t mi = mb; mi < me; ++mi) {
      const int64_t m_start = m_starts[mi];
      const int64_t m_end = m_start + ps;
      int32_t op = -1;
      for (size_t j = 0; j < arms.size(); ++j) {
        const Arm& a = arms[j];
        if (!a.active) continue;
        const int64_t allow =
            std::max(prm->max_gap_size,
                     (int64_t)(0.1 * (double)(a.l_end - a.l_start)));
        if (d_ss(a.r_start, a.r_end, m_start, m_end) < allow &&
            m_end > a.r_end) {
          op = (int32_t)j;
          break;
        }
      }
      ops[mi - mb] = op;
    }
    for (int64_t mi = mb; mi < me; ++mi) {
      if (ops[mi - mb] >= 0) {
        Arm& a = arms[ops[mi - mb]];
        a.l_end = i + ps;
        a.r_end = m_starts[mi] + ps;
        a.dirty = true;
        a.gap = 0;
      }
    }
    for (int64_t mi = mb; mi < me; ++mi) {
      if (ops[mi - mb] < 0) {
        arms.push_back(Arm{i, i + ps, m_starts[mi], m_starts[mi] + ps, 0,
                           true, false});
      }
    }
    for (auto& a : arms) {
      if (!a.dirty) {
        a.gap += prm->step_size;
        if (a.gap >= prm->max_gap_size) a.active = false;
      }
    }
    prune();
    emit_if_all_dead();
  }
  apply_aging(z_trail);
  // arms alive after the trailing quiet run are dropped (end-of-needle)
  *n_sds_out = n_sds;
  *n_families_out = n_families;
  return overflow ? 1 : 0;
}

// Suffix sort seeded by packed k-mers: parallel LSD radix sort of
// (k-mer, position), then Manber-Myers prefix doubling restricted to the
// unresolved (non-singleton) groups. Produces the same suffix array as
// SA-IS (all suffixes are distinct thanks to the unique '$' separator)
// but runs memory-bandwidth-bound and parallel instead of the SA-IS
// pointer-chasing recursion — the index-build hot path for the
// doubled-text position index.
// Suffix sort (+ optionally fused per-position equal-range tables).
// pos_lo/pos_hi may be null (sort only) or int32 arrays of length n.
int asgart_build_position_index(const int64_t* kmers, int64_t n, int64_t k,
                                int64_t* sa_out, int32_t* pos_lo,
                                int32_t* pos_hi, int64_t n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  const bool prof = std::getenv("ASGART_NATIVE_PROFILE") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char* what) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[kss] %s: %.2fs\n", what,
                 std::chrono::duration<double>(now - tick).count());
    tick = now;
  };

  // ---- MSD bucket partition + in-cache per-bucket sorts ----
  // One streaming partition pass on the top bits, then each bucket is
  // comparison-sorted in cache. Ties (equal k-mers) keep arbitrary order
  // here; the doubling rounds resolve them.
  struct KV {
    int64_t key, pos;
  };
  int topb = 8;
  while ((int64_t(1) << topb) * 65536 < n && topb < 20) ++topb;
  if (topb > 3 * k) topb = int(3 * k);
  const int64_t n_buckets = int64_t(1) << topb;
  const int shift = int(3 * k) - topb;
  const int64_t per = (n + n_threads - 1) / n_threads;

  std::vector<KV> recs(n);
  {
    // per-thread histograms over buckets
    std::vector<std::vector<int64_t>> hist(
        n_threads, std::vector<int64_t>(n_buckets, 0));
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, t, b0, b1]() {
        auto& h = hist[t];
        for (int64_t i = b0; i < b1; ++i) h[kmers[i] >> shift]++;
      });
    }
    for (auto& th : ts) th.join();
    int64_t sum = 0;
    for (int64_t d = 0; d < n_buckets; ++d) {
      for (int64_t t = 0; t < n_threads; ++t) {
        int64_t c = hist[t][d];
        hist[t][d] = sum;
        sum += c;
      }
    }
    ts.clear();
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, t, b0, b1]() {
        auto h = hist[t];
        for (int64_t i = b0; i < b1; ++i) {
          recs[h[kmers[i] >> shift]++] = KV{kmers[i], i};
        }
      });
    }
    for (auto& th : ts) th.join();
    // bucket boundaries for the sorting phase = hist[0] before scatter;
    // recompute from a fresh prefix of total counts
  }
  lap("partition");
  std::vector<int64_t> bstart(n_buckets + 1, 0);
  {
    // recompute counts from recs (streaming) to avoid keeping histograms
    for (int64_t i = 0; i < n; ++i) bstart[(recs[i].key >> shift) + 1]++;
    for (int64_t d = 0; d < n_buckets; ++d) bstart[d + 1] += bstart[d];
  }
  {
    std::atomic<int64_t> cursor{0};
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      ts.emplace_back([&]() {
        int64_t d;
        while ((d = cursor.fetch_add(1)) < n_buckets) {
          std::sort(recs.begin() + bstart[d], recs.begin() + bstart[d + 1],
                    [](const KV& a, const KV& b) { return a.key < b.key; });
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  lap("bucket sorts");
  auto key_at = [&](int64_t r) -> int64_t { return recs[r].key; };
  auto idx_at = [&](int64_t r) -> int64_t& { return recs[r].pos; };
  lap("copy out");

  // unresolved spans first: when every k-mer is unique (no spans), the
  // rank scatter — a latency-bound inverse permutation — is skipped
  struct Span { int64_t b, e; };
  std::vector<Span> spans;
  {
    int64_t r = 0;
    while (r < n) {
      int64_t e = r + 1;
      while (e < n && key_at(e) == key_at(r)) ++e;
      if (e - r > 1) spans.push_back({r, e});
      r = e;
    }
  }
  lap("span scan");

  // ---- initial ranks ----
  // Dense array only when repeats are plentiful; for the common
  // low-duplication case a sparse map over span members avoids the
  // latency-bound full inverse-permutation scatter (rank of any resolved
  // position is recoverable by binary search over the sorted keys).
  int64_t span_cov = 0;
  for (const auto& sp : spans) span_cov += sp.e - sp.b;
  const bool sparse_ranks = span_cov * 32 < n;
  std::vector<std::pair<int64_t, int64_t>> sparse;  // (pos, rank) sorted
  std::vector<int64_t> rank;
  if (!spans.empty() && sparse_ranks) {
    sparse.reserve(span_cov);
    for (const auto& sp : spans)
      for (int64_t r = sp.b; r < sp.e; ++r)
        sparse.emplace_back(idx_at(r), sp.b);
    std::sort(sparse.begin(), sparse.end());
  } else if (!spans.empty()) {
    rank.resize(n);
    // stripe-parallel: rank = index of the first element of the equal run
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, b0, b1]() {
        // find the true run start for the stripe head by scanning back
        int64_t start = b0;
        while (start > 0 && key_at(start - 1) == key_at(b0)) --start;
        for (int64_t r = b0; r < b1; ++r) {
          if (r > 0 && key_at(r) != key_at(r - 1)) start = r;
          rank[idx_at(r)] = start;
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  lap("initial ranks");

  auto rank_of = [&](int64_t p) -> int64_t {
    if (!sparse_ranks) return rank[p];
    auto it = std::lower_bound(
        sparse.begin(), sparse.end(),
        std::make_pair(p, std::numeric_limits<int64_t>::min()));
    if (it != sparse.end() && it->first == p) return it->second;
    // resolved position: its rank is the start of its key's run
    const int64_t key = kmers[p];
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (key_at(mid) < key) lo = mid + 1; else hi = mid;
    }
    return lo;
  };
  auto rank_set = [&](int64_t p, int64_t r) {
    if (!sparse_ranks) { rank[p] = r; return; }
    auto it = std::lower_bound(
        sparse.begin(), sparse.end(),
        std::make_pair(p, std::numeric_limits<int64_t>::min()));
    it->second = r;  // span members are always present in `sparse`
  };

  // Doubling rounds: phase A sorts every span by rank[p+h] and records
  // the refined ranks on the side; phase B applies them after a barrier
  // (readers of rank[p+h] in other spans must see the pre-round values).
  int64_t h = k;
  while (!spans.empty() && h < 2 * n) {
    std::vector<std::vector<Span>> next_per_thread(n_threads);
    std::vector<std::vector<std::pair<int64_t, int64_t>>> updates(n_threads);
    std::atomic<size_t> span_cursor{0};
    {
      std::vector<std::thread> ts;
      for (int64_t t = 0; t < n_threads; ++t) {
        ts.emplace_back([&, t]() {
          size_t si;
          while ((si = span_cursor.fetch_add(1)) < spans.size()) {
            const Span sp = spans[si];
            auto key2 = [&](int64_t p) -> int64_t {
              return p + h < n ? rank_of(p + h) : -1;
            };
            std::stable_sort(recs.begin() + sp.b, recs.begin() + sp.e,
                             [&](const KV& a, const KV& b) {
                               return key2(a.pos) < key2(b.pos);
                             });
            int64_t start = sp.b;
            for (int64_t r = sp.b; r < sp.e; ++r) {
              if (r > sp.b && key2(idx_at(r)) != key2(idx_at(r - 1)))
                start = r;
              if (start != sp.b)  // rank unchanged for the first sub-group
                updates[t].emplace_back(idx_at(r), start);
            }
            int64_t r = sp.b;
            while (r < sp.e) {
              int64_t e = r + 1;
              while (e < sp.e && key2(idx_at(e)) == key2(idx_at(r))) ++e;
              if (e - r > 1) next_per_thread[t].push_back({r, e});
              r = e;
            }
          }
        });
      }
      for (auto& th : ts) th.join();
    }
    {
      std::vector<std::thread> ts;
      for (int64_t t = 0; t < n_threads; ++t) {
        if (updates[t].empty()) continue;
        ts.emplace_back([&, t]() {
          for (auto& [p, r] : updates[t]) rank_set(p, r);
        });
      }
      for (auto& th : ts) th.join();
    }
    std::vector<Span> next_spans;
    for (auto& v : next_per_thread)
      next_spans.insert(next_spans.end(), v.begin(), v.end());
    spans.swap(next_spans);
    h *= 2;
  }

  lap("doubling");
  {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, b0, b1]() {
        if (pos_lo && pos_hi) {
          // equal-range (by k-mer key) per rank, found by extending the
          // stripe head's run; then scatter through the positions
          int64_t lo = b0;
          while (lo > 0 && key_at(lo - 1) == key_at(b0)) --lo;
          int64_t hi = -1;
          for (int64_t r = b0; r < b1; ++r) {
            if (r > 0 && key_at(r) != key_at(r - 1)) lo = r;
            if (r >= hi) {
              hi = r + 1;
              while (hi < n && key_at(hi) == key_at(r)) ++hi;
            }
            const int64_t p = recs[r].pos;
            sa_out[r] = p;
            pos_lo[p] = (int32_t)lo;
            pos_hi[p] = (int32_t)hi;
          }
        } else {
          for (int64_t r = b0; r < b1; ++r) sa_out[r] = recs[r].pos;
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  lap("tables");
  return 0;
}


// Primary index-build entry: computes packed k-mers on the fly from the
// 3-bit symbol codes (no separate k-mer array), sorts 12-byte records
// (key + int32 position), resolves ties by prefix doubling, and emits the
// suffix array plus fused per-position equal-range tables.
int asgart_build_position_index_codes2(const uint8_t* codes, int64_t n,
                                       int64_t k, int64_t* sa_out,
                                       int32_t* pos_lo, int64_t* keys_out,
                                       int64_t n_threads);

int asgart_build_position_index_codes(const uint8_t* codes, int64_t n,
                                      int64_t k, int64_t* sa_out,
                                      int32_t* pos_lo, int32_t* pos_hi,
                                      int64_t n_threads) {
  (void)pos_hi;
  return asgart_build_position_index_codes2(codes, n, k, sa_out, pos_lo,
                                            nullptr, n_threads);
}

static int bpi_codes_impl(const uint8_t* codes, int64_t n, int64_t k,
                          void* sa_out_v, int sa_elem, int32_t* pos_lo,
                          int64_t* keys_out, int64_t n_threads) {
  int64_t* sa64 = sa_elem == 8 ? (int64_t*)sa_out_v : nullptr;
  int32_t* sa32 = sa_elem == 4 ? (int32_t*)sa_out_v : nullptr;
  if (n <= 0) return 0;
  if (n >= (int64_t(1) << 31)) return 2;  // int32 positions
  if (n_threads < 1) n_threads = 1;
  const bool prof = std::getenv("ASGART_NATIVE_PROFILE") != nullptr;
  auto tick = std::chrono::steady_clock::now();
  auto lap = [&](const char* what) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[bpi] %s: %.2fs\n", what,
                 std::chrono::duration<double>(now - tick).count());
    tick = now;
  };

  // 3k == 63 must keep exactly 63 bits: ~0 would let rolled history
  // pollute the sign bit (negative keys -> OOB radix buckets)
  const int64_t mask = (k * 3 >= 63)
                           ? int64_t(~uint64_t(0) >> 1)
                           : ((int64_t(1) << (k * 3)) - 1);
  auto code_at = [&](int64_t q) -> int64_t {
    return q < n ? int64_t(codes[q]) : 0;
  };
  auto pack_at = [&](int64_t p) -> int64_t {
    int64_t v = 0;
    for (int64_t j = 0; j < k; ++j) v = (v << 3) | code_at(p + j);
    return v;
  };

#pragma pack(push, 1)
  struct KV {
    int64_t key;
    int32_t pos;
  };
#pragma pack(pop)

  int topb = 8;
  while ((int64_t(1) << topb) * 65536 < n && topb < 20) ++topb;
  if (topb > 3 * k) topb = int(3 * k);
  const int64_t n_buckets = int64_t(1) << topb;
  const int shift = int(3 * k) - topb;
  const int64_t per = (n + n_threads - 1) / n_threads;

  // default-init (no memset): a value-initialized vector would zero
  // 12 B/elem on one thread — both the memset and the first-touch page
  // faults dominate cold builds. Pages are touched in parallel below,
  // and THP (madvise mode on this kernel) cuts fault counts 512x.
  std::unique_ptr<KV[]> recs_owner(new KV[n]);
  KV* recs = recs_owner.get();
#if defined(__linux__) && defined(MADV_HUGEPAGE)
  {
    const uintptr_t a = (uintptr_t)recs & ~uintptr_t(4095);
    madvise((void*)a,
            size_t(n) * sizeof(KV) + ((uintptr_t)recs - a),
            MADV_HUGEPAGE);
  }
#endif
  {
    std::vector<std::vector<int64_t>> hist(
        n_threads, std::vector<int64_t>(n_buckets, 0));
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, t, b0, b1]() {
        auto& h = hist[t];
        // parallel first-touch of this thread's stripe of the record
        // buffer (the scatter below writes in bucket order, which would
        // fault pages in random order from whichever thread gets there)
        const size_t stride = 4096 / sizeof(KV);
        for (size_t q = size_t(b0); q < size_t(b1); q += stride)
          recs[q].key = 0;
        int64_t v = pack_at(b0);
        h[v >> shift]++;
        for (int64_t i = b0 + 1; i < b1; ++i) {
          v = ((v << 3) | code_at(i + k - 1)) & mask;
          h[v >> shift]++;
        }
      });
    }
    for (auto& th : ts) th.join();
    int64_t sum = 0;
    for (int64_t d = 0; d < n_buckets; ++d) {
      for (int64_t t = 0; t < n_threads; ++t) {
        int64_t c = hist[t][d];
        hist[t][d] = sum;
        sum += c;
      }
    }
    ts.clear();
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, t, b0, b1]() {
        auto h = hist[t];
        int64_t v = pack_at(b0);
        recs[h[v >> shift]++] = KV{v, (int32_t)b0};
        for (int64_t i = b0 + 1; i < b1; ++i) {
          v = ((v << 3) | code_at(i + k - 1)) & mask;
          recs[h[v >> shift]++] = KV{v, (int32_t)i};
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  lap("partition");

  std::vector<int64_t> bstart(n_buckets + 1, 0);
  for (int64_t i = 0; i < n; ++i) bstart[(recs[i].key >> shift) + 1]++;
  for (int64_t d = 0; d < n_buckets; ++d) bstart[d + 1] += bstart[d];
  {
    std::atomic<int64_t> cursor{0};
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      ts.emplace_back([&]() {
        int64_t d;
        while ((d = cursor.fetch_add(1)) < n_buckets) {
          std::sort(recs + bstart[d], recs + bstart[d + 1],
                    [](const KV& a, const KV& b) { return a.key < b.key; });
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  lap("bucket sorts");

  auto key_at = [&](int64_t r) -> int64_t { return recs[r].key; };
  auto idx_at = [&](int64_t r) -> int64_t { return recs[r].pos; };

  struct Span {
    int64_t b, e;
  };
  std::vector<Span> spans;
  {
    int64_t r = 0;
    while (r < n) {
      int64_t e = r + 1;
      while (e < n && key_at(e) == key_at(r)) ++e;
      if (e - r > 1) spans.push_back({r, e});
      r = e;
    }
  }
  lap("span scan");

  int64_t span_cov = 0;
  for (const auto& sp : spans) span_cov += sp.e - sp.b;
  const bool sparse_ranks = span_cov * 32 < n;
  std::vector<std::pair<int64_t, int64_t>> sparse;
  std::vector<int64_t> rank;
  if (!spans.empty() && sparse_ranks) {
    sparse.reserve(span_cov);
    for (const auto& sp : spans)
      for (int64_t r = sp.b; r < sp.e; ++r)
        sparse.emplace_back(idx_at(r), sp.b);
    std::sort(sparse.begin(), sparse.end());
  } else if (!spans.empty()) {
    rank.resize(n);
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, b0, b1]() {
        int64_t start = b0;
        while (start > 0 && key_at(start - 1) == key_at(b0)) --start;
        for (int64_t r = b0; r < b1; ++r) {
          if (r > 0 && key_at(r) != key_at(r - 1)) start = r;
          rank[idx_at(r)] = start;
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  lap("initial ranks");

  auto rank_of = [&](int64_t p) -> int64_t {
    if (!sparse_ranks) return rank[p];
    auto it = std::lower_bound(
        sparse.begin(), sparse.end(),
        std::make_pair(p, std::numeric_limits<int64_t>::min()));
    if (it != sparse.end() && it->first == p) return it->second;
    const int64_t key = pack_at(p);
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (key_at(mid) < key) lo = mid + 1; else hi = mid;
    }
    return lo;
  };
  auto rank_set = [&](int64_t p, int64_t r) {
    if (!sparse_ranks) {
      rank[p] = r;
      return;
    }
    auto it = std::lower_bound(
        sparse.begin(), sparse.end(),
        std::make_pair(p, std::numeric_limits<int64_t>::min()));
    it->second = r;
  };

  int64_t h = k;
  while (!spans.empty() && h < 2 * n) {
    std::vector<std::vector<Span>> next_per_thread(n_threads);
    std::vector<std::vector<std::pair<int64_t, int64_t>>> updates(n_threads);
    std::atomic<size_t> span_cursor{0};
    {
      std::vector<std::thread> ts;
      for (int64_t t = 0; t < n_threads; ++t) {
        ts.emplace_back([&, t]() {
          size_t si;
          while ((si = span_cursor.fetch_add(1)) < spans.size()) {
            const Span sp = spans[si];
            auto key2 = [&](int64_t p) -> int64_t {
              return p + h < n ? rank_of(p + h) : -1;
            };
            std::stable_sort(recs + sp.b, recs + sp.e,
                             [&](const KV& a, const KV& b) {
                               return key2(a.pos) < key2(b.pos);
                             });
            int64_t start = sp.b;
            for (int64_t r = sp.b; r < sp.e; ++r) {
              if (r > sp.b && key2(idx_at(r)) != key2(idx_at(r - 1)))
                start = r;
              if (start != sp.b)
                updates[t].emplace_back(idx_at(r), start);
            }
            int64_t r = sp.b;
            while (r < sp.e) {
              int64_t e = r + 1;
              while (e < sp.e && key2(idx_at(e)) == key2(idx_at(r))) ++e;
              if (e - r > 1) next_per_thread[t].push_back({r, e});
              r = e;
            }
          }
        });
      }
      for (auto& th : ts) th.join();
    }
    {
      std::vector<std::thread> ts;
      for (int64_t t = 0; t < n_threads; ++t) {
        if (updates[t].empty()) continue;
        ts.emplace_back([&, t]() {
          for (auto& [p, r] : updates[t]) rank_set(p, r);
        });
      }
      for (auto& th : ts) th.join();
    }
    std::vector<Span> next_spans;
    for (auto& v : next_per_thread)
      next_spans.insert(next_spans.end(), v.begin(), v.end());
    spans.swap(next_spans);
    h *= 2;
  }
  lap("doubling");

  {
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, b0, b1]() {
        int64_t lo = b0;
        while (lo > 0 && key_at(lo - 1) == key_at(b0)) --lo;
        int64_t hi = -1;
        for (int64_t r = b0; r < b1; ++r) {
          // the pos_lo scatter below is a random 8 B store per row over
          // a multi-GB table (latency-bound, RFO per line): prefetch
          // the destination line PF rows ahead — recs[] itself is a
          // sequential read, so the lookahead is nearly free
          constexpr int64_t PF = 48;
          if (r + PF < b1)
            __builtin_prefetch(&pos_lo[2 * (int64_t)recs[r + PF].pos],
                               1, 0);
          if (r > 0 && key_at(r) != key_at(r - 1)) lo = r;
          if (r >= hi) {
            hi = r + 1;
            while (hi < n && key_at(hi) == key_at(r)) ++hi;
          }
          const int64_t p = idx_at(r);
          if (sa64) sa64[r] = p; else sa32[r] = (int32_t)p;
          if (keys_out) keys_out[r] = key_at(r);
          // pos_lo is an interleaved [n][2] table: one 8-byte store per
          // position instead of two distant 4-byte stores
          pos_lo[2 * p] = (int32_t)lo;
          pos_lo[2 * p + 1] = (int32_t)hi;
        }
      });
    }
    for (auto& th : ts) th.join();
  }
  lap("tables");
  return 0;
}

int asgart_kmer_suffix_sort(const int64_t* kmers, int64_t n, int64_t k,
                            int64_t* sa_out, int64_t n_threads) {
  return asgart_build_position_index(kmers, n, k, sa_out, nullptr, nullptr,
                                     n_threads);
}

int asgart_build_position_index_codes2(const uint8_t* codes, int64_t n,
                                       int64_t k, int64_t* sa_out,
                                       int32_t* pos_lo, int64_t* keys_out,
                                       int64_t n_threads) {
  return bpi_codes_impl(codes, n, k, sa_out, 8, pos_lo, keys_out,
                        n_threads);
}

int asgart_build_position_index_codes_i32(
    const uint8_t* codes, int64_t n, int64_t k, int32_t* sa_out,
    int32_t* pos_lo, int64_t* keys_out, int64_t n_threads) {
  return bpi_codes_impl(codes, n, k, sa_out, 4, pos_lo, keys_out,
                        n_threads);
}

// Pack the k 3-bit symbol ranks starting at every position of `codes`
// (zero-padded semantics beyond n) into int64 k-mers. Parallel by blocks;
// each block recomputes its first k-mer from scratch then rolls.
int asgart_pack_kmers(const uint8_t* codes, int64_t n, int64_t k,
                      int64_t* out, int64_t n_threads) {
  if (n <= 0) return 0;
  const int64_t mask = (k * 3 >= 63)
                           ? int64_t(~uint64_t(0) >> 1)
                           : ((int64_t(1) << (k * 3)) - 1);
  auto code_at = [&](int64_t q) -> int64_t {
    return q < n ? int64_t(codes[q]) : 0;
  };
  auto work = [&](int64_t b0, int64_t b1) {
    int64_t v = 0;
    for (int64_t j = 0; j < k; ++j) v = (v << 3) | code_at(b0 + j);
    out[b0] = v;
    for (int64_t i = b0 + 1; i < b1; ++i) {
      v = ((v << 3) | code_at(i + k - 1)) & mask;
      out[i] = v;
    }
  };
  if (n_threads <= 1) {
    work(0, n);
    return 0;
  }
  std::vector<std::thread> ts;
  const int64_t per = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
    if (b0 >= b1) break;
    ts.emplace_back(work, b0, b1);
  }
  for (auto& t : ts) t.join();
  return 0;
}

// Build position→equal-range tables: for every text position p,
// pos_lo[p]..pos_hi[p] is the suffix-array interval of positions whose
// k-mer equals p's. This turns every probe lookup into one gather —
// the TPU-native replacement of the reference's per-probe binary search
// (searcher.rs:145-171).
// elem_size selects int64 (8) or int32 (4) output tables; int32 halves
// the latency-bound scatter traffic and feeds the device path directly.
static int group_tables_impl(const int64_t* sa, const int64_t* kmers,
                             int64_t n, void* pos_lo_v, void* pos_hi_v,
                             int64_t n_threads, int elem_size) {
  if (n <= 0) return 0;
  int64_t* pos_lo64 = elem_size == 8 ? (int64_t*)pos_lo_v : nullptr;
  int64_t* pos_hi64 = elem_size == 8 ? (int64_t*)pos_hi_v : nullptr;
  int32_t* pos_lo32 = elem_size == 4 ? (int32_t*)pos_lo_v : nullptr;
  int32_t* pos_hi32 = elem_size == 4 ? (int32_t*)pos_hi_v : nullptr;
  std::vector<int64_t> sa_k(n);
  {
    std::vector<std::thread> ts;
    const int64_t per = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, b0, b1]() {
        for (int64_t r = b0; r < b1; ++r) sa_k[r] = kmers[sa[r]];
      });
    }
    for (auto& t : ts) t.join();
  }
  // group start per rank (forward), group end per rank (backward); then
  // scatter to positions. Done in per-thread stripes with boundary fixups.
  std::vector<int64_t> lo(n), hi(n);
  {
    const int64_t per = (n + n_threads - 1) / n_threads;
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, b0, b1]() {
        int64_t cur = b0;
        for (int64_t r = b0; r < b1; ++r) {
          if (r > 0 && sa_k[r] != sa_k[r - 1]) cur = r;
          lo[r] = cur;  // may be fixed up across stripes below
        }
        int64_t cure = b1;
        for (int64_t r = b1 - 1; r >= b0; --r) {
          if (r + 1 < n && sa_k[r] != sa_k[r + 1]) cure = r + 1;
          hi[r] = cure;
        }
      });
    }
    for (auto& t : ts) t.join();
    // fixups: a group spanning a stripe boundary
    for (int64_t t = 1; t < n_threads; ++t) {
      int64_t b0 = t * per;
      if (b0 >= n) break;
      if (sa_k[b0] == sa_k[b0 - 1]) {
        int64_t true_lo = lo[b0 - 1];
        for (int64_t r = b0; r < n && lo[r] == b0; ++r) lo[r] = true_lo;
      }
    }
    for (int64_t t = n_threads - 1; t >= 1; --t) {
      int64_t b0 = t * per;
      if (b0 >= n) continue;
      if (sa_k[b0] == sa_k[b0 - 1]) {
        int64_t true_hi = hi[b0];
        for (int64_t r = b0 - 1; r >= 0 && hi[r] == b0; --r) hi[r] = true_hi;
      }
    }
  }
  {
    std::vector<std::thread> ts;
    const int64_t per = (n + n_threads - 1) / n_threads;
    for (int64_t t = 0; t < n_threads; ++t) {
      int64_t b0 = t * per, b1 = std::min(n, (t + 1) * per);
      if (b0 >= b1) break;
      ts.emplace_back([&, b0, b1]() {
        if (elem_size == 8) {
          for (int64_t r = b0; r < b1; ++r) {
            pos_lo64[sa[r]] = lo[r];
            pos_hi64[sa[r]] = hi[r];
          }
        } else {
          for (int64_t r = b0; r < b1; ++r) {
            pos_lo32[sa[r]] = (int32_t)lo[r];
            pos_hi32[sa[r]] = (int32_t)hi[r];
          }
        }
      });
    }
    for (auto& t : ts) t.join();
  }
  return 0;
}

int asgart_group_tables(const int64_t* sa, const int64_t* kmers, int64_t n,
                        int64_t* pos_lo, int64_t* pos_hi,
                        int64_t n_threads) {
  return group_tables_impl(sa, kmers, n, pos_lo, pos_hi, n_threads, 8);
}

int asgart_group_tables32(const int64_t* sa, const int64_t* kmers,
                          int64_t n, int32_t* pos_lo, int32_t* pos_hi,
                          int64_t n_threads) {
  return group_tables_impl(sa, kmers, n, pos_lo, pos_hi, n_threads, 4);
}

// Parallel batched equal-range over the sorted k-mer keys: for each
// probe k-mer, [lo, hi) via branchless binary search. Used by the
// single-text host strategy for transformed (R/C/RC) probes.
int asgart_batch_equal_range(const int64_t* keys, int64_t n,
                             const int64_t* probes, int64_t m,
                             int64_t* lo_out, int64_t* hi_out,
                             int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto lower = [&](int64_t v) -> int64_t {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (keys[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
  };
  const int64_t per = (m + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(m, (t + 1) * per);
    if (b0 >= b1) break;
    ts.emplace_back([&, b0, b1]() {
      for (int64_t i = b0; i < b1; ++i) {
        lo_out[i] = lower(probes[i]);
        hi_out[i] = lower(probes[i] + 1);  // exact integer keys
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// Bucket table over the sorted keys: out[b] = first rank whose key's top
// `topb` bits are >= b. Narrows each probe search from log2(n) to
// log2(max bucket) levels.
int asgart_build_bucket_table(const int64_t* keys, int64_t n, int64_t k,
                              int64_t topb, int64_t* out,
                              int64_t n_threads) {
  const int shift = int(3 * k - topb);
  const int64_t nb = int64_t(1) << topb;
  if (n_threads < 1) n_threads = 1;
  const int64_t per = (nb + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(nb, (t + 1) * per);
    if (b0 >= b1) break;
    ts.emplace_back([&, b0, b1]() {
      for (int64_t b = b0; b < b1; ++b) {
        // lower bound of bucket prefix b
        int64_t lo = 0, hi = n;
        const int64_t v = b << shift;
        while (lo < hi) {
          int64_t mid = (lo + hi) >> 1;
          if (keys[mid] < v) lo = mid + 1; else hi = mid;
        }
        out[b] = lo;
      }
    });
  }
  for (auto& th : ts) th.join();
  out[nb] = n;
  return 0;
}

// Byte-compare batched equal-range over a suffix array: the wide-probe
// (k > 21) strategy, equivalent to the reference's sa_searchb64 +
// equal_range_by byte comparisons (searcher.rs:145-171, including the
// "suffix shorter than the pattern compares Less" rule,
// searcher.rs:164-170). `sa` holds ABSOLUTE positions; `sa_offset`
// rebases them into `text` (trim windows pass the window text and its
// start). Patterns are a flat [m*k] byte array.
int asgart_batch_equal_range_bytes(
    const uint8_t* text, int64_t text_len, const int64_t* sa,
    int64_t n_sa, int64_t sa_offset, const uint8_t* patterns, int64_t k,
    int64_t m, int64_t* lo_out, int64_t* hi_out, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  // -1: suffix < pattern, 0: equal on k (or suffix prefix-equal but
  // shorter => -1), +1: suffix > pattern
  auto cmp = [&](int64_t r, const uint8_t* pat) -> int {
    const int64_t s = sa[r] - sa_offset;
    const int64_t avail = text_len - s;
    const int64_t lim = avail < k ? avail : k;
    for (int64_t j = 0; j < lim; ++j) {
      const uint8_t a = text[s + j], b = pat[j];
      if (a != b) return a < b ? -1 : 1;
    }
    return avail < k ? -1 : 0;
  };
  const int64_t per = (m + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(m, (t + 1) * per);
    if (b0 >= b1) break;
    ts.emplace_back([&, b0, b1]() {
      for (int64_t i = b0; i < b1; ++i) {
        const uint8_t* pat = patterns + i * k;
        int64_t lo = 0, hi = n_sa;
        while (lo < hi) {  // first suffix >= pattern
          int64_t mid = (lo + hi) >> 1;
          if (cmp(mid, pat) < 0) lo = mid + 1; else hi = mid;
        }
        lo_out[i] = lo;
        int64_t lo2 = lo, hi2 = n_sa;
        while (lo2 < hi2) {  // first suffix > pattern
          int64_t mid = (lo2 + hi2) >> 1;
          if (cmp(mid, pat) <= 0) lo2 = mid + 1; else hi2 = mid;
        }
        hi_out[i] = lo2;
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// Bucket-accelerated batched equal-range.
int asgart_batch_equal_range_bucketed(
    const int64_t* keys, int64_t /*n*/, const int64_t* probes, int64_t m,
    const int64_t* buckets, int64_t k, int64_t topb,
    int64_t* lo_out, int64_t* hi_out, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  const int shift = int(3 * k - topb);
  auto lower = [&](int64_t v, int64_t lo, int64_t hi) -> int64_t {
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (keys[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
  };
  const int64_t per = (m + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(m, (t + 1) * per);
    if (b0 >= b1) break;
    ts.emplace_back([&, b0, b1]() {
      for (int64_t i = b0; i < b1; ++i) {
        const int64_t v = probes[i];
        const int64_t b = v >> shift;
        const int64_t blo = buckets[b], bhi = buckets[b + 1];
        lo_out[i] = lower(v, blo, bhi);
        hi_out[i] = lower(v + 1, lo_out[i], bhi);
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// Pack the k-mers at the given positions only (probe packing).
int asgart_pack_at(const uint8_t* codes, int64_t n, int64_t k,
                   const int64_t* positions, int64_t m, int64_t* out,
                   int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  auto code_at = [&](int64_t q) -> int64_t {
    return q < n ? int64_t(codes[q]) : 0;
  };
  const int64_t per = (m + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(m, (t + 1) * per);
    if (b0 >= b1) break;
    ts.emplace_back([&, b0, b1]() {
      for (int64_t i = b0; i < b1; ++i) {
        const int64_t p = positions[i];
        int64_t v = 0;
        for (int64_t j = 0; j < k; ++j) v = (v << 3) | code_at(p + j);
        out[i] = v;
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Post-processing: FilterNs + ReduceOverlap over CSR-packed families,
// threaded across families (the reference parallelizes these steps with
// rayon par_iter, asgart.rs:40,89,105). Records are [4] int64:
// left, right, left_length, right_length.
// ---------------------------------------------------------------------------

namespace {

inline bool pp_subsegment(int64_t xs, int64_t xl, int64_t ys, int64_t yl) {
  return xs >= ys && xs + xl <= ys + yl;
}

inline bool pp_overlap(int64_t xs, int64_t xl, int64_t ys, int64_t yl) {
  const int64_t xe = xs + xl, ye = ys + yl;
  return (ys <= xs && xs <= ye && xe >= ye) ||
         (xs <= ys && ys <= xe && ye >= xe);
}

// One absorb pass (asgart.rs:515-551), preserving the reference's
// left/right length mixing in merge (asgart.rs:497-513).
inline int64_t pp_reduce_once(const int64_t* in, int64_t m, int64_t* out) {
  int64_t k = 0;
  for (int64_t i = 0; i < m; ++i) {
    const int64_t xl = in[4 * i], xr = in[4 * i + 1];
    const int64_t xll = in[4 * i + 2], xrl = in[4 * i + 3];
    bool absorbed = false;
    for (int64_t j = 0; j < k; ++j) {
      int64_t& yl = out[4 * j];
      int64_t& yr = out[4 * j + 1];
      int64_t& yll = out[4 * j + 2];
      int64_t& yrl = out[4 * j + 3];
      if (pp_subsegment(xl, xll, yl, yll) &&
          pp_subsegment(xr, xrl, yr, yrl)) {
        absorbed = true;
        break;
      }
      if (pp_subsegment(yl, yll, xl, xll) &&
          pp_subsegment(yr, yrl, xr, xrl)) {
        yl = xl; yr = xr; yll = xll; yrl = xrl;
        absorbed = true;
        break;
      }
      if (pp_overlap(xl, xll, yl, yll) && pp_overlap(xr, xrl, yr, yrl)) {
        const int64_t nl = std::min(xl, yl);
        const int64_t ls =
            std::max(xl + xll, yl + yrl) - nl;  // reference quirk
        const int64_t nr = std::min(xr, yr);
        const int64_t rs = std::max(xr + xll, yr + yrl) - nr;
        yl = nl; yr = nr; yll = ls; yrl = rs;
        absorbed = true;
        break;
      }
    }
    if (!absorbed) {
      out[4 * k] = xl; out[4 * k + 1] = xr;
      out[4 * k + 2] = xll; out[4 * k + 3] = xrl;
      ++k;
    }
  }
  return k;
}

}  // namespace

// Fixpoint overlap reduction per family (asgart.rs:553-561), threaded
// across families. In/out CSR; out buffers must be at least input-sized
// (output never grows). Returns 0.
int asgart_reduce_overlap(const int64_t* sds, const int64_t* fam_offsets,
                          int64_t n_fams, int64_t* out_sds,
                          int64_t* out_offsets, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int64_t> sizes(n_fams, 0);
  std::atomic<int64_t> cursor{0};
  std::vector<std::thread> ts;
  std::vector<std::vector<int64_t>> results(n_fams);
  for (int64_t t = 0; t < n_threads; ++t) {
    ts.emplace_back([&]() {
      std::vector<int64_t> buf_a, buf_b;
      int64_t f;
      while ((f = cursor.fetch_add(1)) < n_fams) {
        const int64_t b = fam_offsets[f], e = fam_offsets[f + 1];
        int64_t m = e - b;
        buf_a.assign(sds + 4 * b, sds + 4 * e);
        buf_b.resize(4 * m);
        int64_t old_size = m;
        int64_t k = pp_reduce_once(buf_a.data(), m, buf_b.data());
        buf_a.swap(buf_b);
        while (k < old_size) {
          old_size = k;
          buf_b.resize(4 * k);
          k = pp_reduce_once(buf_a.data(), k, buf_b.data());
          buf_a.swap(buf_b);
        }
        buf_a.resize(4 * k);
        results[f] = buf_a;
        sizes[f] = k;
      }
    });
  }
  for (auto& th : ts) th.join();
  int64_t off = 0;
  out_offsets[0] = 0;
  for (int64_t f = 0; f < n_fams; ++f) {
    std::memcpy(out_sds + 4 * off, results[f].data(),
                sizeof(int64_t) * 4 * sizes[f]);
    off += sizes[f];
    out_offsets[f + 1] = off;
  }
  return 0;
}

// FilterNs (asgart.rs:81-96 / structs.rs:454-467): drop duplicons whose
// worse arm exceeds 20% N ('N' or 'n'; arms are INCLUSIVE slices, and
// the fractions are computed in f32 like the reference). keep_out[i] = 1
// to keep record i. Threaded across records.
int asgart_filter_ns(const int64_t* sds, int64_t n_sds,
                     const uint8_t* strand, int64_t strand_len,
                     uint8_t* keep_out, int64_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  const int64_t per = (n_sds + n_threads - 1) / n_threads;
  std::vector<std::thread> ts;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(n_sds, (t + 1) * per);
    if (b0 >= b1) break;
    ts.emplace_back([&, b0, b1]() {
      auto count_n = [&](int64_t s, int64_t l) -> int64_t {
        int64_t e = std::min(s + l + 1, strand_len);  // inclusive slice
        s = std::min(std::max(s, int64_t(0)), strand_len);
        int64_t c = 0;
        for (int64_t q = s; q < e; ++q)
          c += (strand[q] == 'N') | (strand[q] == 'n');
        return c;
      };
      for (int64_t i = b0; i < b1; ++i) {
        const int64_t ln = count_n(sds[4 * i], sds[4 * i + 2]);
        const int64_t rn = count_n(sds[4 * i + 1], sds[4 * i + 3]);
        const float lf = float(ln) / float(sds[4 * i + 2]);
        const float rf = float(rn) / float(sds[4 * i + 3]);
        keep_out[i] = (std::max(lf, rf) <= 0.2f) ? 1 : 0;
      }
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// Levenshtein distance, Myers/Hyyrö bit-parallel (word-packed DP columns,
// O(n*m/64)). Exactly the same metric as the reference's two-row DP
// (bio::alignment::distance::levenshtein, used by structs.rs:439-452) —
// the DP implementation below is kept as the test oracle. Global-distance
// variant: the horizontal input into each column starts at +1 (row 0 of
// the DP is 0,1,2,... unlike Myers' semi-global matcher).
int64_t asgart_levenshtein_myers(const uint8_t* a, int64_t n,
                                 const uint8_t* b, int64_t m) {
  // a = text (columns), b = pattern (rows, bit-packed)
  if (m == 0) return n;
  if (n == 0) return m;
  const int64_t W = 64;
  const int64_t B = (m + W - 1) / W;
  // per-symbol pattern-match masks (dense 256 keeps it branch-free)
  std::vector<uint64_t> peq(256 * B, 0);
  for (int64_t i = 0; i < m; ++i)
    peq[int64_t(b[i]) * B + i / W] |= uint64_t(1) << (i % W);

  std::vector<uint64_t> VP(B, ~uint64_t(0)), VN(B, 0);
  int64_t score = m;
  const int64_t r = (m - 1) % W;  // row m-1's bit in the last block

  for (int64_t j = 0; j < n; ++j) {
    const uint64_t* eqc = &peq[int64_t(a[j]) * B];
    int hin = 1;  // global distance: row 0 grows by 1 per column
    for (int64_t bk = 0; bk < B; ++bk) {
      uint64_t Eq = eqc[bk];
      const uint64_t vp = VP[bk], vn = VN[bk];
      const uint64_t Xv = Eq | vn;
      if (hin < 0) Eq |= 1;
      const uint64_t Xh = (((Eq & vp) + vp) ^ vp) | Eq;
      uint64_t Ph = vn | ~(Xh | vp);
      uint64_t Mh = vp & Xh;
      const int64_t out_bit = (bk == B - 1) ? r : W - 1;
      int hout = 0;
      if ((Ph >> out_bit) & 1) hout = 1;
      else if ((Mh >> out_bit) & 1) hout = -1;
      Ph <<= 1;
      Mh <<= 1;
      if (hin > 0) Ph |= 1;
      else if (hin < 0) Mh |= 1;
      VP[bk] = Mh | ~(Xv | Ph);
      VN[bk] = Ph & Xv;
      if (bk == B - 1) score += hout;
      hin = hout;
    }
  }
  return score;
}

// Levenshtein distance, two-row DP (test oracle; the production path is
// the bit-parallel variant above).
int64_t asgart_levenshtein(const uint8_t* a, int64_t n, const uint8_t* b,
                           int64_t m) {
  if (n == 0) return m;
  if (m == 0) return n;
  std::vector<int64_t> prev(m + 1), cur(m + 1);
  for (int64_t j = 0; j <= m; ++j) prev[j] = j;
  for (int64_t i = 1; i <= n; ++i) {
    cur[0] = i;
    const uint8_t ca = a[i - 1];
    for (int64_t j = 1; j <= m; ++j) {
      const int64_t sub = prev[j - 1] + (ca != b[j - 1]);
      const int64_t del = prev[j] + 1;
      const int64_t ins = cur[j - 1] + 1;
      cur[j] = std::min(sub, std::min(del, ins));
    }
    std::swap(prev, cur);
  }
  return prev[m];
}

}  // extern "C"
