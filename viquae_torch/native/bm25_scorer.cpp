// Native BM25 batch scorer — the sparse-retrieval hot loop.
//
// Role: the reference's sparse path runs inside Elasticsearch/Lucene (Java
// native, meerqat/ir/search.py:268-293). This framework's in-repo BM25
// (viquae_tpu/ops/bm25.py) scores with vectorized numpy; this C++ core
// replaces the per-term scatter-accumulate + top-k with a single pass over
// CSR postings using a touched-docs accumulator and a bounded partial sort,
// matching Lucene's BM25Similarity math bit-for-bit with the Python path:
//     idf(t) = ln(1 + (N - df + 0.5) / (df + 0.5))
//     s(t,d) = idf(t) * qtf * tf / (tf + k1 * (1 - b + b * dl/avgdl))
// Ties break by ascending doc id (the framework's FAISS-flat contract).
//
// Built by viquae_tpu/native/build.py (g++ -O3 -shared), loaded via ctypes.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Score one query against the index.
//   offsets[v], docs[nnz], tfs[nnz]: postings CSR grouped by term
//   idf[v]: per-term idf; norm[d]: k1 * (1 - b + b * dl/avgdl) per doc
//   query_terms/query_tfs[q_len]: the query's term ids + repetition counts
//   out_scores/out_indices[k]: top-k results (score desc, ties by doc asc)
// Returns the number of hits written (<= k).
int32_t bm25_score_query(
    const int64_t* offsets,
    const int32_t* docs,
    const float* tfs,
    const float* idf,
    const float* norm,
    int64_t n_docs,
    const int32_t* query_terms,
    const float* query_tfs,
    int64_t q_len,
    int32_t k,
    float* accumulator,       // caller-provided (n_docs) scratch, zeroed
    int32_t* touched,         // caller-provided (n_docs) scratch
    float* out_scores,
    int32_t* out_indices) {
  int64_t n_touched = 0;
  for (int64_t t = 0; t < q_len; ++t) {
    const int32_t term = query_terms[t];
    const float term_idf = idf[term] * query_tfs[t];
    const int64_t lo = offsets[term];
    const int64_t hi = offsets[term + 1];
    for (int64_t p = lo; p < hi; ++p) {
      const int32_t d = docs[p];
      const float tf = tfs[p];
      if (accumulator[d] == 0.0f) {
        touched[n_touched++] = d;
      }
      accumulator[d] += term_idf * tf / (tf + norm[d]);
    }
  }
  // exact top-k over touched docs: nth_element + sort, ties by doc id asc
  auto better = [&](int32_t a, int32_t b) {
    const float sa = accumulator[a];
    const float sb = accumulator[b];
    if (sa != sb) return sa > sb;
    return a < b;
  };
  const int64_t keep = std::min<int64_t>(k, n_touched);
  if (keep > 0 && keep < n_touched) {
    std::nth_element(touched, touched + keep, touched + n_touched, better);
  }
  std::sort(touched, touched + keep, better);
  int32_t written = 0;
  for (int64_t i = 0; i < keep; ++i) {
    const int32_t d = touched[i];
    if (accumulator[d] <= 0.0f) break;  // drop zero/negative (not retrieved)
    out_scores[written] = accumulator[d];
    out_indices[written] = d;
    ++written;
  }
  // reset only the touched entries for the next query
  for (int64_t i = 0; i < n_touched; ++i) {
    accumulator[touched[i]] = 0.0f;
  }
  return written;
}

// Batch driver: queries flattened CSR-style via query_offsets.
void bm25_score_batch(
    const int64_t* offsets,
    const int32_t* docs,
    const float* tfs,
    const float* idf,
    const float* norm,
    int64_t n_docs,
    const int32_t* query_terms,
    const float* query_tfs,
    const int64_t* query_offsets,
    int64_t n_queries,
    int32_t k,
    float* out_scores,     // (n_queries, k)
    int32_t* out_indices,  // (n_queries, k)
    int32_t* out_counts) { // (n_queries,)
  std::vector<float> accumulator(static_cast<size_t>(n_docs), 0.0f);
  std::vector<int32_t> touched(static_cast<size_t>(n_docs));
  for (int64_t q = 0; q < n_queries; ++q) {
    const int64_t lo = query_offsets[q];
    const int64_t hi = query_offsets[q + 1];
    out_counts[q] = bm25_score_query(
        offsets, docs, tfs, idf, norm, n_docs,
        query_terms + lo, query_tfs + lo, hi - lo, k,
        accumulator.data(), touched.data(),
        out_scores + q * k, out_indices + q * k);
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// MaxScore (document-at-a-time with term upper-bound pruning) — exact top-k.
//
// The TAAT scorer above scans EVERY posting of every query term; with a
// Zipf vocabulary the common terms contribute million-entry postings whose
// docs almost never reach the top-k (low idf). Lucene solves this with
// block-max WAND/MaxScore; this is classic MaxScore (Turtle & Flood 1995):
// terms sorted by upper-bound contribution ub(t) = idf(t)*qtf*max_d tf/(tf+
// norm_d); once the running top-k threshold exceeds the sum of the lowest
// ubs, those terms become NON-ESSENTIAL — their postings are never merged,
// only probed by binary search for docs already surfaced by essential
// terms. Rank-safe (exact scores, exact tie order): candidates are skipped
// only when their score upper bound is STRICTLY below the k-th score, so
// boundary ties always survive to the final (score desc, doc asc) sort.
// ---------------------------------------------------------------------------
namespace {

struct HeapEntry {
  float score;
  int32_t doc;
};

// "less" for std::push_heap so the TOP is the WORST kept entry
inline bool heap_less(const HeapEntry& a, const HeapEntry& b) {
  if (a.score != b.score) return a.score > b.score;
  return a.doc < b.doc;
}

inline bool better_than(float score, int32_t doc, const HeapEntry& worst) {
  if (score != worst.score) return score > worst.score;
  return doc < worst.doc;
}

}  // namespace

extern "C" {

int32_t bm25_maxscore_query(
    const int64_t* offsets,
    const int32_t* docs,
    const float* tfs,
    const float* idf,
    const float* norm,
    const float* term_ub,      // per-term ub at qtf=1 (python-precomputed)
    const int32_t* query_terms,
    const float* query_tfs,
    int64_t q_len,
    int32_t k,
    float* out_scores,
    int32_t* out_indices) {
  // per-query-term state, sorted ASCENDING by upper bound
  struct Term {
    float ub;
    float widf;     // idf * qtf
    int64_t lo, hi; // postings slice; lo advances for essential terms
    int64_t probe;  // non-essential probe cursor (candidates ascend)
    int32_t orig;   // original query-term position (see below)
  };
  std::vector<Term> terms;
  terms.reserve(static_cast<size_t>(q_len));
  for (int64_t t = 0; t < q_len; ++t) {
    const int32_t term = query_terms[t];
    const int64_t lo = offsets[term];
    const int64_t hi = offsets[term + 1];
    if (hi <= lo) continue;
    terms.push_back({term_ub[term] * query_tfs[t],
                     idf[term] * query_tfs[t], lo, hi, lo,
                     static_cast<int32_t>(terms.size())});
  }
  const int64_t n_terms = static_cast<int64_t>(terms.size());
  if (n_terms == 0 || k <= 0) return 0;
  std::sort(terms.begin(), terms.end(),
            [](const Term& a, const Term& b) { return a.ub < b.ub; });
  std::vector<float> prefix(static_cast<size_t>(n_terms) + 1, 0.0f);
  for (int64_t i = 0; i < n_terms; ++i) {
    prefix[i + 1] = prefix[i] + terms[i].ub;
  }
  // Final scores must be BITWISE identical to the TAAT scorer (and to the
  // doc's score had it been evaluated at any other pruning state), or
  // exact score TIES (duplicate passages) would break order: collect each
  // term's contribution into a slot and reduce in ORIGINAL query-term
  // order. by_orig[j] = sorted position of original term j.
  std::vector<float> slot(static_cast<size_t>(n_terms));
  std::vector<int32_t> by_orig(static_cast<size_t>(n_terms));
  for (int64_t i = 0; i < n_terms; ++i) by_orig[terms[i].orig] = i;

  std::vector<HeapEntry> heap;
  heap.reserve(static_cast<size_t>(k));
  float theta = 0.0f;       // k-th best score once the heap is full
  int64_t n_non = 0;        // terms[0..n_non) are non-essential

  auto update_split = [&]() {
    // largest m with prefix[m] < theta (STRICT: ties must stay essential).
    // Same ulp slack as the candidate pruning below: the exact score is a
    // different float-addition order than the ub prefix sum, so a doc
    // whose every term went non-essential could score a few ulps ABOVE
    // prefix[n_non] and be lost on an exact-theta tie without it.
    while (n_non < n_terms) {
      const float slack = 1e-6f * (theta < 0.0f ? -theta : theta) + 1e-20f;
      if (!(prefix[n_non + 1] + slack < theta)) break;
      ++n_non;
    }
  };

  while (true) {
    // next candidate = min current doc over essential cursors. (A WAND
    // pivot over the essential lists was tried and REVERTED: with Zipf
    // queries the essential terms are the rare ones, so candidates are
    // already few — the pivot bookkeeping cost 25%. The probing of the
    // huge non-essential lists is the hot part; see the galloping
    // cursors below.)
    int32_t next = INT32_MAX;
    for (int64_t i = n_non; i < n_terms; ++i) {
      if (terms[i].lo < terms[i].hi) {
        const int32_t d = docs[terms[i].lo];
        if (d < next) next = d;
      }
    }
    if (next == INT32_MAX) break;  // all essential postings consumed
    // score essential contributions, advancing their cursors
    float running = 0.0f;
    for (int64_t i = 0; i < n_terms; ++i) slot[i] = 0.0f;
    for (int64_t i = n_non; i < n_terms; ++i) {
      Term& t = terms[i];
      if (t.lo < t.hi && docs[t.lo] == next) {
        const float tf = tfs[t.lo];
        const float c = t.widf * tf / (tf + norm[next]);
        slot[i] = c;
        running += c;
        ++t.lo;
      }
    }
    // probe non-essential terms (highest ub first) while the bound holds.
    // Pruning uses a tiny slack: `running` is a different float-addition
    // order than the final fixed-order reduction, so an exactly-boundary
    // candidate could otherwise be lost to last-bit drift.
    float bound = running + prefix[n_non];
    const float slack = 1e-6f * (theta < 0.0f ? -theta : theta) + 1e-20f;
    bool viable = heap.size() < static_cast<size_t>(k)
                  || !(bound + slack < theta);
    if (viable) {
      for (int64_t i = n_non - 1; i >= 0; --i) {
        if (heap.size() >= static_cast<size_t>(k)
            && bound + slack < theta) {
          viable = false;
          break;
        }
        Term& t = terms[i];
        bound -= t.ub;
        // GALLOPING probe: candidates arrive in ascending doc order, so
        // each term's probe cursor only moves forward — exponential
        // search from it beats a full-list binary search (20 cache-missy
        // levels over a million-entry postings list) by ~log(gap)
        int64_t start = t.probe > t.lo ? t.probe : t.lo;
        if (start < t.hi && docs[start] < next) {
          int64_t step = 1;
          int64_t far = start + 1;
          while (far < t.hi && docs[far] < next) {
            start = far;
            far = start + step;
            step <<= 1;
          }
          if (far > t.hi) far = t.hi;
          start = std::lower_bound(docs + start, docs + far, next) - docs;
        }
        t.probe = start;
        if (start < t.hi && docs[start] == next) {
          const float tf = tfs[start];
          const float c = t.widf * tf / (tf + norm[next]);
          slot[i] = c;
          bound += c;
        }
      }
    }
    // fixed-order reduction: original query-term order, like the TAAT path
    float score = 0.0f;
    if (viable) {
      for (int64_t j = 0; j < n_terms; ++j) score += slot[by_orig[j]];
    }
    if (viable && score > 0.0f) {
      if (heap.size() < static_cast<size_t>(k)) {
        heap.push_back({score, next});
        std::push_heap(heap.begin(), heap.end(), heap_less);
        if (heap.size() == static_cast<size_t>(k)) {
          theta = heap.front().score;
          update_split();
        }
      } else if (better_than(score, next, heap.front())) {
        std::pop_heap(heap.begin(), heap.end(), heap_less);
        heap.back() = {score, next};
        std::push_heap(heap.begin(), heap.end(), heap_less);
        theta = heap.front().score;
        update_split();
      }
    }
  }
  std::sort(heap.begin(), heap.end(), [](const HeapEntry& a,
                                         const HeapEntry& b) {
    if (a.score != b.score) return a.score > b.score;
    return a.doc < b.doc;
  });
  int32_t written = 0;
  for (const HeapEntry& e : heap) {
    out_scores[written] = e.score;
    out_indices[written] = e.doc;
    ++written;
  }
  return written;
}

void bm25_maxscore_batch(
    const int64_t* offsets,
    const int32_t* docs,
    const float* tfs,
    const float* idf,
    const float* norm,
    const float* term_ub,
    int64_t n_docs,
    const int32_t* query_terms,
    const float* query_tfs,
    const int64_t* query_offsets,
    int64_t n_queries,
    int32_t k,
    float* out_scores,
    int32_t* out_indices,
    int32_t* out_counts) {
  (void)n_docs;
  for (int64_t q = 0; q < n_queries; ++q) {
    const int64_t lo = query_offsets[q];
    const int64_t hi = query_offsets[q + 1];
    out_counts[q] = bm25_maxscore_query(
        offsets, docs, tfs, idf, norm, term_ub,
        query_terms + lo, query_tfs + lo, hi - lo, k,
        out_scores + q * k, out_indices + q * k);
  }
}

// Multithreaded batch driver. bm25_maxscore_query only READS the shared
// index arrays and writes disjoint per-query output slices, so queries are
// embarrassingly parallel (the reference's Elasticsearch scores across a
// Java thread pool the same way). Assignment is STRIDED (thread w takes
// queries w, w+nt, ...), not chunked: Zipf query costs are heavy-tailed
// and striding spreads the expensive ones across workers. Per-query
// results are bitwise identical to the sequential driver — rank safety
// and tie order are per-query properties and threading changes neither.
void bm25_maxscore_batch_mt(
    const int64_t* offsets,
    const int32_t* docs,
    const float* tfs,
    const float* idf,
    const float* norm,
    const float* term_ub,
    int64_t n_docs,
    const int32_t* query_terms,
    const float* query_tfs,
    const int64_t* query_offsets,
    int64_t n_queries,
    int32_t k,
    float* out_scores,
    int32_t* out_indices,
    int32_t* out_counts,
    int32_t n_threads) {
  if (n_threads <= 1 || n_queries <= 1) {
    bm25_maxscore_batch(offsets, docs, tfs, idf, norm, term_ub, n_docs,
                        query_terms, query_tfs, query_offsets, n_queries, k,
                        out_scores, out_indices, out_counts);
    return;
  }
  const int64_t nt = std::min<int64_t>(n_threads, n_queries);
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(nt));
  for (int64_t w = 0; w < nt; ++w) {
    pool.emplace_back([=]() {
      for (int64_t q = w; q < n_queries; q += nt) {
        const int64_t lo = query_offsets[q];
        const int64_t hi = query_offsets[q + 1];
        out_counts[q] = bm25_maxscore_query(
            offsets, docs, tfs, idf, norm, term_ub,
            query_terms + lo, query_tfs + lo, hi - lo, k,
            out_scores + q * k, out_indices + q * k);
      }
    });
  }
  for (auto& t : pool) t.join();
}

}  // extern "C"
