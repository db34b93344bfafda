// Native answer-position labeling — the reader-collator host hot loop.
//
// Role: token-level answer matching is O(M * L * |answers| * |answer|) per
// question and the reference runs it as a python loop inside the collator
// (meerqat/train/data.py:947-975); SURVEY.md §7 flags it as dominating
// reader input latency. This C++ core implements the same contract:
// answers are tried in order, matches scanned left-to-right, a span is kept
// only if neither its start nor its end index was already used, capped at
// max_n spans per row.
//
// Built by viquae_tpu/native/build.py (g++ -O3 -shared), loaded via ctypes.
#include <cstdint>

extern "C" {

// One row: returns the number of spans found (<= max_n).
int32_t match_row(
    const int32_t* input_ids, int64_t seq_len,
    const int32_t* answer_tokens,        // flattened answer token ids
    const int64_t* answer_offsets,       // (n_answers + 1) CSR offsets
    int64_t n_answers,
    int32_t max_n,
    int32_t* out_starts,                 // (max_n)
    int32_t* out_ends) {                 // (max_n)
  int32_t found = 0;
  for (int64_t a = 0; a < n_answers && found < max_n; ++a) {
    const int64_t lo = answer_offsets[a];
    const int64_t len = answer_offsets[a + 1] - lo;
    if (len <= 0 || len > seq_len) continue;
    const int32_t* ans = answer_tokens + lo;
    for (int64_t i = 0; i + len <= seq_len && found < max_n; ++i) {
      bool match = true;
      for (int64_t j = 0; j < len; ++j) {
        if (input_ids[i + j] != ans[j]) { match = false; break; }
      }
      if (!match) continue;
      const int32_t start = static_cast<int32_t>(i);
      const int32_t end = static_cast<int32_t>(i + len - 1);
      bool duplicate = false;
      for (int32_t f = 0; f < found; ++f) {
        if (out_starts[f] == start || out_ends[f] == end) {
          duplicate = true;
          break;
        }
      }
      if (!duplicate) {
        out_starts[found] = start;
        out_ends[found] = end;
        ++found;
      }
    }
  }
  return found;
}

// Batch driver: rows with per-row answer lists (CSR over answers).
void match_batch(
    const int32_t* input_ids,            // (n_rows, seq_len)
    int64_t n_rows, int64_t seq_len,
    const int32_t* answer_tokens,
    const int64_t* answer_offsets,       // (total_answers + 1)
    const int64_t* row_answer_offsets,   // (n_rows + 1): answers per row
    int32_t max_n,
    int32_t* out_starts,                 // (n_rows, max_n)
    int32_t* out_ends,                   // (n_rows, max_n)
    int32_t* out_counts) {               // (n_rows)
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t a_lo = row_answer_offsets[r];
    const int64_t a_hi = row_answer_offsets[r + 1];
    out_counts[r] = match_row(
        input_ids + r * seq_len, seq_len,
        answer_tokens, answer_offsets + a_lo, a_hi - a_lo,
        max_n, out_starts + r * max_n, out_ends + r * max_n);
  }
}

}  // extern "C"
