// Batched Levenshtein edit distance (host-side native kernel).
//
// Native replacement for the reference's fairseq.libnat / libnat_cuda
// (fairseq/clib/libnat/edit_dist.cpp) used here to accelerate WER/CER
// scoring during validation (espresso/tools/wer.py semantics). Exposed via
// ctypes (no pybind11 in this image).
//
// Built at first use by espresso_tpu_torch/clib/__init__.py:
// g++ -O3 -shared -fPIC -o libedit_distance.so edit_distance.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Fill the (n+1) x (m+1) DP matrix for one pair. dist must hold
// (n+1)*(m+1) int32. Enables Python-side backtrace for aligned printing.
void edit_distance_matrix(const int32_t* ref, int32_t n, const int32_t* hyp,
                          int32_t m, int32_t* dist) {
  const int32_t W = m + 1;
  for (int32_t j = 0; j <= m; ++j) dist[j] = j;
  for (int32_t i = 1; i <= n; ++i) {
    dist[i * W] = i;
    const int32_t r = ref[i - 1];
    for (int32_t j = 1; j <= m; ++j) {
      const int32_t sub = dist[(i - 1) * W + (j - 1)] + (r != hyp[j - 1]);
      const int32_t ins = dist[i * W + (j - 1)] + 1;
      const int32_t del = dist[(i - 1) * W + j] + 1;
      dist[i * W + j] = std::min(sub, std::min(ins, del));
    }
  }
}

// Batched error counts. refs: [B, max_ref] padded with -1; hyps likewise.
// out: [B, 4] = (corr, sub, ins, del) per pair, backtraced with the same
// tie-breaking order as the Python reference (corr/sub > ins > del).
void batched_edit_counts(const int32_t* refs, const int32_t* ref_lens,
                         const int32_t* hyps, const int32_t* hyp_lens,
                         int32_t batch, int32_t max_ref, int32_t max_hyp,
                         int32_t* out) {
  std::vector<int32_t> dist((max_ref + 1) * (max_hyp + 1));
  for (int32_t b = 0; b < batch; ++b) {
    const int32_t n = ref_lens[b];
    const int32_t m = hyp_lens[b];
    const int32_t* ref = refs + (size_t)b * max_ref;
    const int32_t* hyp = hyps + (size_t)b * max_hyp;
    const int32_t W = m + 1;
    edit_distance_matrix(ref, n, hyp, m, dist.data());
    int32_t corr = 0, sub = 0, ins = 0, del = 0;
    int32_t i = n, j = m;
    while (i > 0 || j > 0) {
      if (i > 0 && j > 0 && dist[i * W + j] == dist[(i - 1) * W + (j - 1)] &&
          ref[i - 1] == hyp[j - 1]) {
        ++corr; --i; --j;
      } else if (i > 0 && j > 0 &&
                 dist[i * W + j] == dist[(i - 1) * W + (j - 1)] + 1) {
        ++sub; --i; --j;
      } else if (j > 0 && dist[i * W + j] == dist[i * W + (j - 1)] + 1) {
        ++ins; --j;
      } else {
        ++del; --i;
      }
    }
    out[b * 4 + 0] = corr;
    out[b * 4 + 1] = sub;
    out[b * 4 + 2] = ins;
    out[b * 4 + 3] = del;
  }
}

}  // extern "C"
