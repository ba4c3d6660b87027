// Native calibration kernels: order statistics + histogram counting.
//
// The calibration capture path (teal_jax/calibration/grab_acts.py) builds
// a 10,000-bin histogram per (layer, module, hidden-type) over every
// captured activation value — ~225M floats per histogram for a 7B at the
// reference's corpus size (10 x 2048 x 11008). The numpy implementation
// full-sorts each array (O(n log n)) and bins via searchsorted; this
// replaces it with O(n) nth_element order statistics and an OpenMP
// parallel counting pass that is bit-identical to
// np.histogram(values, bins=edges) for finite inputs.
//
// Reference behavior being accelerated (not copied): find_histogram,
// /root/reference/utils/utils.py:145-173.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see loader.py);
// plain C ABI so ctypes binds without pybind11.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Exact k-th order statistic by counting refinement: one parallel pass
// histograms the data over 2^16 uniform bins, locating the bin that
// contains the k-th value; a second pass gathers just that bin's members
// (typically n/65536-ish) and nth_element finishes on the small subset.
// Exact for any distribution, no O(n) copy, ~2 streaming passes.
// out4 = {min, max, kth_low, kth_high} where kth_* are the exact k_lo-th /
// k_hi-th order statistics (0-based) of data — the outlier-clamp bounds.
void teal_order_stats(const float* data, int64_t n, int64_t k_lo,
                      int64_t k_hi, float* out4) {
  float mn = data[0], mx = data[0];
#pragma omp parallel for reduction(min : mn) reduction(max : mx) \
    schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float v = data[i];
    mn = v < mn ? v : mn;
    mx = v > mx ? v : mx;
  }
  out4[0] = mn;
  out4[1] = mx;
  if (!(mx > mn)) {
    out4[2] = mn;
    out4[3] = mn;
    return;
  }

  constexpr int64_t B = 1 << 16;
  const double inv = (double)B / ((double)mx - (double)mn);
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<int64_t> partial((size_t)nthreads * B, 0);
#pragma omp parallel
  {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    int64_t* mine = partial.data() + (size_t)tid * B;
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      int64_t b = (int64_t)(((double)data[i] - (double)mn) * inv);
      if (b < 0) b = 0;
      if (b >= B) b = B - 1;
      ++mine[b];
    }
  }
  std::vector<int64_t> total(B, 0);
  for (int t = 0; t < nthreads; ++t)
    for (int64_t b = 0; b < B; ++b) total[b] += partial[(size_t)t * B + b];

  const int64_t ks[2] = {k_lo, k_hi};
  for (int which = 0; which < 2; ++which) {
    const int64_t k = ks[which];
    int64_t before = 0, target = -1;
    for (int64_t b = 0; b < B; ++b) {
      if (before + total[b] > k) {
        target = b;
        break;
      }
      before += total[b];
    }
    float result = mx;
    if (target >= 0) {
      // gather the candidate bin's members; exact nth within the subset
      std::vector<float> sub;
      sub.reserve((size_t)total[target]);
      for (int64_t i = 0; i < n; ++i) {
        int64_t b = (int64_t)(((double)data[i] - (double)mn) * inv);
        if (b < 0) b = 0;
        if (b >= B) b = B - 1;
        if (b == target) sub.push_back(data[i]);
      }
      std::nth_element(sub.begin(), sub.begin() + (k - before), sub.end());
      result = sub[k - before];
    }
    out4[2 + which] = result;
  }
}

// np.histogram(values, bins=edges) semantics for finite inputs: bin i
// covers [edges[i], edges[i+1]), the last bin includes its right edge;
// values outside [edges[0], edges[nbins]] are dropped. The interior
// edges (edges[1..nbins-1]) are uniform (linspace), so the bin index is
// computed arithmetically in O(1) and then nudged by at most a step to
// agree exactly with searchsorted on the rounded float64 edge values.
void teal_histogram_count(const float* data, int64_t n, const double* edges,
                          int64_t nbins, double* counts) {
  const double first = edges[0], last = edges[nbins];
  const double lower = edges[1], upper = edges[nbins - 1];
  const double width = (upper - lower) / (double)(nbins - 2);
  const double invw = width > 0 ? 1.0 / width : 0.0;
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<int64_t> partial((size_t)nthreads * nbins, 0);
#pragma omp parallel
  {
    int tid = 0;
#ifdef _OPENMP
    tid = omp_get_thread_num();
#endif
    int64_t* mine = partial.data() + (size_t)tid * nbins;
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
      const double v = (double)data[i];
      if (!(v >= first) || !(v <= last)) continue;  // drops NaN too
      int64_t idx;
      if (v < lower) {
        idx = 0;
      } else if (v >= upper) {
        idx = nbins - 1;
      } else {
        idx = 1 + (int64_t)((v - lower) * invw);
        if (idx > nbins - 2) idx = nbins - 2;
        // exact searchsorted agreement on the stored edges
        while (idx > 1 && v < edges[idx]) --idx;
        while (idx < nbins - 2 && v >= edges[idx + 1]) ++idx;
      }
      ++mine[idx];
    }
  }
  for (int64_t b = 0; b < nbins; ++b) {
    int64_t acc = 0;
    for (int t = 0; t < nthreads; ++t) acc += partial[(size_t)t * nbins + b];
    counts[b] = (double)acc;
  }
}

}  // extern "C"
