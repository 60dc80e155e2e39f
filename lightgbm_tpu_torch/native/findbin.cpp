// Native GreedyFindBin: the equal-ish-frequency boundary search over
// sorted distinct values (reference algorithm: src/io/bin.cpp:77-155 —
// re-implemented from the Python body of binning.greedy_find_bin, which
// the tests pin bit for bit against it and the JAX package).
//
// The greedy scan is the one Python loop of fitting the bin bounds: it
// is sequential over up to bin_construct_sample_cnt distinct values a
// feature.  Exposed as plain C for ctypes.
//
// Float semantics mirrored exactly:
//  - bound = nextafter((upper + lower) / 2, +inf)
//  - dedup: CheckDoubleEqualOrdered(a, b) == (b <= nextafter(a, +inf))
//  - the "half mean bin" trigger compares at DOUBLE precision (the
//    reference's std::max(1.0, mean_bin_size * 0.5f) promotes:
//    double * float -> double)

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Returns the number of bounds written to out (out has capacity max_bin;
// the +inf terminator IS written and counted).
int lgbt_greedy_find_bin(const double* distinct_values,
                         const int64_t* counts,
                         int64_t num_distinct,
                         int max_bin,
                         int64_t total_cnt,
                         int min_data_in_bin,
                         double* out) {
    int n_out = 0;
    if (max_bin <= 0) return 0;
    if (num_distinct == 0) {
        out[n_out++] = HUGE_VAL;
        return n_out;
    }
    if (num_distinct <= max_bin) {
        int64_t cur_cnt_inbin = 0;
        for (int64_t i = 0; i < num_distinct - 1; ++i) {
            cur_cnt_inbin += counts[i];
            if (cur_cnt_inbin >= min_data_in_bin) {
                double val = std::nextafter(
                    (distinct_values[i] + distinct_values[i + 1]) / 2.0,
                    HUGE_VAL);
                if (n_out == 0 ||
                    !(val <= std::nextafter(out[n_out - 1], HUGE_VAL))) {
                    out[n_out++] = val;
                    cur_cnt_inbin = 0;
                }
            }
        }
        out[n_out++] = HUGE_VAL;
        return n_out;
    }

    if (min_data_in_bin > 0) {
        int cap = (int)(total_cnt / min_data_in_bin);
        if (max_bin > cap) max_bin = cap;
        if (max_bin < 1) max_bin = 1;
    }
    double mean_bin_size = (double)total_cnt / max_bin;

    int64_t rest_bin_cnt = max_bin;
    int64_t rest_sample_cnt = total_cnt;
    std::vector<char> is_big(num_distinct);
    for (int64_t i = 0; i < num_distinct; ++i) {
        is_big[i] = counts[i] >= mean_bin_size;
        if (is_big[i]) {
            --rest_bin_cnt;
            rest_sample_cnt -= counts[i];
        }
    }
    mean_bin_size = rest_bin_cnt > 0
        ? (double)rest_sample_cnt / rest_bin_cnt : HUGE_VAL;

    std::vector<double> upper(max_bin, HUGE_VAL), lower(max_bin, HUGE_VAL);
    int bin_cnt = 0;
    lower[0] = distinct_values[0];
    int64_t cur_cnt_inbin = 0;
    for (int64_t i = 0; i < num_distinct - 1; ++i) {
        if (!is_big[i]) rest_sample_cnt -= counts[i];
        cur_cnt_inbin += counts[i];
        // the reference's std::max(1.0, mean_bin_size * 0.5f) promotes
        // to DOUBLE (double * float -> double), so the half-mean compare
        // runs at double precision, as in binning.py
        double half = mean_bin_size * 0.5;
        if (half < 1.0) half = 1.0;
        if (is_big[i] || (double)cur_cnt_inbin >= mean_bin_size ||
            (is_big[i + 1] && (double)cur_cnt_inbin >= half)) {
            upper[bin_cnt] = distinct_values[i];
            ++bin_cnt;
            lower[bin_cnt] = distinct_values[i + 1];
            if (bin_cnt >= max_bin - 1) break;
            cur_cnt_inbin = 0;
            if (!is_big[i]) {
                --rest_bin_cnt;
                mean_bin_size = rest_bin_cnt > 0
                    ? (double)rest_sample_cnt / rest_bin_cnt : HUGE_VAL;
            }
        }
    }
    ++bin_cnt;
    for (int i = 0; i < bin_cnt - 1; ++i) {
        double val = std::nextafter((upper[i] + lower[i + 1]) / 2.0,
                                    HUGE_VAL);
        if (n_out == 0 ||
            !(val <= std::nextafter(out[n_out - 1], HUGE_VAL))) {
            out[n_out++] = val;
        }
    }
    out[n_out++] = HUGE_VAL;
    return n_out;
}

}  // extern "C"
