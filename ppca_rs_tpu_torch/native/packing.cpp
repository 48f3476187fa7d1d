// Host packing for ppca_rs_tpu_torch: user arrays into the dense (values,
// mask) pair a Dataset holds, and long-format triplets into a dense array.
//
// mask_non_finite is the reference's MaskedSample::mask_non_finite
// (ppca/src/dataset.rs:19-22) over a whole array: one multithreaded pass
// that reads each float64 once and writes the value (0 where it is not
// finite) in the storage type and the observed flag together.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Elements a thread gets at least: below it, starting a thread costs more
// than the pass it would share.
constexpr int64_t kGrain = int64_t(1) << 16;

template <typename F>
void parallel_for(int64_t n, F&& body) {
  int64_t hw = std::max<unsigned>(std::thread::hardware_concurrency(), 1u);
  int64_t workers = std::min<int64_t>(hw, std::max<int64_t>(n / kGrain, 1));
  if (workers <= 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  int64_t chunk = (n + workers - 1) / workers;
  for (int64_t lo = 0; lo < n; lo += chunk) {
    int64_t hi = std::min(n, lo + chunk);
    threads.emplace_back([lo, hi, &body] { body(lo, hi); });
  }
  for (auto& t : threads) t.join();
}

template <typename T>
void mask_non_finite(const double* in, T* values, bool* mask, int64_t n) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      double v = in[i];
      bool finite = std::isfinite(v);
      mask[i] = finite;
      values[i] = finite ? static_cast<T>(v) : T(0);
    }
  });
}

}  // namespace

extern "C" {

void ppca_mask_non_finite_f64(const double* in, double* values, bool* mask, int64_t n) {
  mask_non_finite(in, values, mask, n);
}

void ppca_mask_non_finite_f32(const double* in, float* values, bool* mask, int64_t n) {
  mask_non_finite(in, values, mask, n);
}

// Scatter long-format triplets into a dense row-major (n_samples, n_dims)
// array the caller filled with NaN.  Sequential on purpose: duplicate
// (sample, dim) pairs resolve last-wins, as numpy fancy assignment does;
// threads writing one element would race.  The caller checks the indices.
void ppca_scatter_long_f64(const int64_t* sample_idx, const int64_t* dim_idx,
                           const double* values, int64_t n, double* out, int64_t n_dims) {
  for (int64_t i = 0; i < n; ++i) out[sample_idx[i] * n_dims + dim_idx[i]] = values[i];
}

}  // extern "C"
