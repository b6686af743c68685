// Native batch packing (the reference's Cython hot path,
// fairseq/data/data_utils_fast.pyx batch_by_size_vec). Exact port of the
// Python loop in espresso_tpu_torch/data/batching.py::batch_by_size, re-run
// every epoch after the shuffle.
//
// Output: out_offsets[i]..out_offsets[i+1] delimit batch i inside the
// (pre-ordered) index array. Returns the number of batches.

#include <cstdint>
#include <algorithm>

extern "C" {

int64_t batch_by_size_fast(
    const int64_t* num_tokens,  // [n] sizes in index order
    int64_t n,
    int64_t max_tokens,         // <0: unlimited
    int64_t max_sentences,      // <0: unlimited
    int64_t bsz_mult,
    int64_t* out_offsets)       // [n+1] caller-allocated
{
    int64_t num_batches = 0;
    out_offsets[0] = 0;
    int64_t start = 0;
    int64_t tail_max = 0;
    int64_t pos = 0;
    while (pos < n) {
        tail_max = std::max(tail_max, num_tokens[pos]);
        int64_t sent_count = pos - start + 1;
        bool overflow =
            (max_tokens >= 0 && sent_count * tail_max > max_tokens) ||
            (max_sentences >= 0 && sent_count > max_sentences);
        if (overflow) {
            int64_t batch_len = sent_count - 1;
            if (batch_len > bsz_mult) {
                batch_len -= batch_len % bsz_mult;
            }
            if (batch_len == 0) {
                // single item exceeds the budget: emit it alone
                out_offsets[++num_batches] = start + 1;
                start = pos + 1;
                tail_max = 0;
                ++pos;
                continue;
            }
            out_offsets[++num_batches] = start + batch_len;
            start = start + batch_len;
            tail_max = 0;
            for (int64_t j = start; j <= pos; ++j)
                tail_max = std::max(tail_max, num_tokens[j]);
        }
        ++pos;
    }
    if (start < n) {
        out_offsets[++num_batches] = n;
    }
    return num_batches;
}

}  // extern "C"
