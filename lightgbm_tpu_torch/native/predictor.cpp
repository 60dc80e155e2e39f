// Row-parallel stacked-forest predictor.
//
// reference: src/application/predictor.hpp:29 (OpenMP row-parallel
// Predictor) + include/LightGBM/tree.h:190 (inline scalar traversal) +
// src/boosting/prediction_early_stop.cpp (margin early stop).
//
// predict.StackedForest passes its padded arrays; each thread
// walks rows scalar root-to-leaf exactly like the reference — double
// thresholds, so results are bit-identical to the NumPy host path.
//
// Built by native/build.py with `g++ -O3 -fopenmp -shared`.

#include <cmath>
#include <cstdint>

namespace {

constexpr double kZeroThreshold = 1e-35;

struct Forest {
  int64_t T, I, L;
  const int32_t* split_feature;  // [T, I]
  const double* threshold;       // [T, I]
  const int32_t* left;           // [T, I]
  const int32_t* right;          // [T, I]
  const uint8_t* is_cat;         // [T, I]
  const uint8_t* default_left;   // [T, I]
  const int8_t* missing_type;    // [T, I]
  const double* leaf_value;      // [T, L]
  const int64_t* cat_offset;     // [T, I]
  const int32_t* cat_nwords;     // [T, I]
  const uint32_t* cat_words;     // flat
};

inline int32_t leaf_for_row(const Forest& f, int64_t t, const double* x) {
  int32_t node = 0;
  const int64_t base = t * f.I;
  while (node >= 0) {
    const int64_t j = base + node;
    const double fval = x[f.split_feature[j]];
    bool go_left;
    if (f.is_cat[j]) {
      const bool nan = std::isnan(fval);
      const int64_t iv = nan ? -1 : static_cast<int64_t>(fval);
      const int64_t nbits = static_cast<int64_t>(f.cat_nwords[j]) * 32;
      if (iv >= 0 && iv < nbits) {
        const uint32_t w = f.cat_words[f.cat_offset[j] + iv / 32];
        go_left = (w >> (iv % 32)) & 1u;
      } else {
        go_left = false;
      }
    } else {
      const int mt = f.missing_type[j];
      double fz = fval;
      bool nan = std::isnan(fval);
      if (mt != 2 && nan) { fz = 0.0; nan = false; }
      const bool missing = (mt == 1 && std::fabs(fz) <= kZeroThreshold) ||
                           (mt == 2 && nan);
      go_left = missing ? (f.default_left[j] != 0) : (fz <= f.threshold[j]);
    }
    node = go_left ? f.left[j] : f.right[j];
  }
  return ~node;
}

}  // namespace

extern "C" {

// out: [K, n] accumulated raw scores (tree t adds into class t % K).
// leaf_out: optional [n, T] leaf indices (pass nullptr to skip).
// early_stop_kind: 0 none, 1 binary (|2*raw|>margin), 2 multiclass
// (top-2 gap > margin), checked every `freq` iterations as in the
// reference single-row predictor.
void lgbt_predict(const double* X, int64_t n, int64_t F,
                  int64_t T, int64_t I, int64_t L,
                  const int32_t* split_feature, const double* threshold,
                  const int32_t* left, const int32_t* right,
                  const uint8_t* is_cat, const uint8_t* default_left,
                  const int8_t* missing_type, const double* leaf_value,
                  const int64_t* cat_offset, const int32_t* cat_nwords,
                  const uint32_t* cat_words,
                  int64_t K, int early_stop_kind, int freq, double margin,
                  double* out, int32_t* leaf_out) {
  const Forest f{T, I, L, split_feature, threshold, left, right,
                 is_cat, default_left, missing_type, leaf_value,
                 cat_offset, cat_nwords, cat_words};
  const int64_t iters = (K > 0) ? T / K : 0;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < n; ++r) {
    const double* x = X + r * F;
    for (int64_t it = 0; it < iters; ++it) {
      for (int64_t k = 0; k < K; ++k) {
        const int64_t t = it * K + k;
        const int32_t leaf = leaf_for_row(f, t, x);
        if (leaf_out) leaf_out[r * T + t] = leaf;
        if (out) out[k * n + r] += leaf_value[t * L + leaf];
      }
      if (out && early_stop_kind != 0 && freq > 0 && (it + 1) % freq == 0 &&
          it + 1 < iters) {
        if (early_stop_kind == 1) {
          if (std::fabs(2.0 * out[r]) > margin) break;
        } else if (early_stop_kind == 2 && K >= 2) {
          double best = out[r], second = -1e300;
          for (int64_t k = 1; k < K; ++k) {
            const double v = out[k * n + r];
            if (v > best) { second = best; best = v; }
            else if (v > second) { second = v; }
          }
          if (best - second > margin) break;
        }
      }
    }
  }
}

}  // extern "C"
