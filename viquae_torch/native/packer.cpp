// First-fit-decreasing sequence packer (native core of ops/packing.py).
//
// The Python packer costs ~14 ms per 1280-query batch (hidden by the
// serving prefetch thread, but on the critical path for synchronous
// embed_texts callers and large offline embedding jobs). This is the same
// deterministic algorithm — std::stable_sort by descending length ==
// np.argsort(-lengths, kind="stable"), identical first-fit placement and
// original-order canvas fill — so outputs are bit-identical to the
// Python path (asserted in tests/test_packing.py).
#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// Returns 0 on success. Canvas buffers must be pre-sized to
// (max_rows * row_len) and pre-filled by the caller (input_ids with
// pad_token, segment/position ids with 0).
int64_t pack_sequences(
    const int32_t* tokens,        // concatenated (truncated) token ids
    const int64_t* offsets,       // n_seqs+1 prefix offsets into `tokens`
    int64_t n_seqs,
    int64_t row_len,
    int64_t max_rows,             // capacity of the output canvases
    int32_t* input_ids,           // (max_rows, row_len)
    int32_t* segment_ids,         // (max_rows, row_len)
    int32_t* position_ids,        // (max_rows, row_len)
    int32_t* cls_rows,            // (n_seqs)
    int32_t* cls_cols,            // (n_seqs)
    int64_t* rows_used_out)       // [1]
{
    std::vector<int64_t> length(n_seqs);
    for (int64_t i = 0; i < n_seqs; ++i) {
        length[i] = std::min(offsets[i + 1] - offsets[i], row_len);
    }
    std::vector<int64_t> order(n_seqs);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(),
                     [&](int64_t a, int64_t b) { return length[a] > length[b]; });

    std::vector<int64_t> row_free;
    std::vector<int64_t> place_row(n_seqs), place_col(n_seqs);
    for (int64_t oi = 0; oi < n_seqs; ++oi) {
        const int64_t i = order[oi];
        const int64_t li = length[i];
        bool placed = false;
        for (size_t r = 0; r < row_free.size(); ++r) {
            if (row_free[r] >= li) {
                place_row[i] = static_cast<int64_t>(r);
                place_col[i] = row_len - row_free[r];
                row_free[r] -= li;
                placed = true;
                break;
            }
        }
        if (!placed) {
            place_row[i] = static_cast<int64_t>(row_free.size());
            place_col[i] = 0;
            row_free.push_back(row_len - li);
        }
    }
    const int64_t rows_used =
        std::max<int64_t>(static_cast<int64_t>(row_free.size()), 1);
    *rows_used_out = rows_used;
    if (rows_used > max_rows) return 1;  // caller raises

    std::vector<int32_t> seg_counter(static_cast<size_t>(rows_used), 0);
    for (int64_t i = 0; i < n_seqs; ++i) {  // original order: ties stable
        const int64_t r = place_row[i], c = place_col[i], li = length[i];
        const int32_t seg = ++seg_counter[static_cast<size_t>(r)];
        int32_t* ids = input_ids + r * row_len + c;
        int32_t* segs = segment_ids + r * row_len + c;
        int32_t* pos = position_ids + r * row_len + c;
        const int32_t* src = tokens + offsets[i];
        for (int64_t t = 0; t < li; ++t) {
            ids[t] = src[t];
            segs[t] = seg;
            pos[t] = static_cast<int32_t>(t);
        }
        cls_rows[i] = static_cast<int32_t>(r);
        cls_cols[i] = static_cast<int32_t>(c);
    }
    return 0;
}

}  // extern "C"
