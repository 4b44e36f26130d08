// Metric cells: lock-free scalar samples and fixed-bucket histograms (the
// port's copy of the JAX package's _native/csrc/metrics.cc).
//
// The metrics registry (metrics.py) instruments the eager dispatch path,
// so a cell update must cost one atomic op — no mutex, no allocation.
// Scalars are atomic doubles (CAS add since fetch_add on floating
// atomics is C++20); histograms keep one atomic counter per bucket plus
// a CAS-accumulated sum. Reads are relaxed snapshots: a scrape races
// concurrent updates by design (Prometheus semantics — monotonic
// counters make torn cross-series reads harmless).
#include "common.hpp"

#include <algorithm>
#include <atomic>

namespace {

struct Cell {
  std::atomic<double> v{0.0};
};

void atomic_add(std::atomic<double>& a, double d) {
  double cur = a.load(std::memory_order_relaxed);
  while (!a.compare_exchange_weak(cur, cur + d,
                                  std::memory_order_relaxed)) {
  }
}

struct Hist {
  int32_t n = 0;                      // finite bucket bounds
  double* bounds = nullptr;           // sorted upper bounds, size n
  std::atomic<uint64_t>* counts = nullptr;  // n + 1 (last = +Inf)
  std::atomic<double> sum{0.0};
  std::atomic<uint64_t> total{0};
  ~Hist() {
    delete[] bounds;
    delete[] counts;
  }
};

}  // namespace

HVD_EXPORT void* hvd_mtr_create() { return new Cell(); }

HVD_EXPORT void hvd_mtr_destroy(void* h) { delete static_cast<Cell*>(h); }

HVD_EXPORT void hvd_mtr_add(void* h, double d) {
  atomic_add(static_cast<Cell*>(h)->v, d);
}

HVD_EXPORT void hvd_mtr_set(void* h, double d) {
  static_cast<Cell*>(h)->v.store(d, std::memory_order_relaxed);
}

HVD_EXPORT double hvd_mtr_get(void* h) {
  return static_cast<Cell*>(h)->v.load(std::memory_order_relaxed);
}

HVD_EXPORT void* hvd_hist_create(const double* bounds, int32_t n) {
  if (n <= 0) return nullptr;
  Hist* h = new Hist();
  h->n = n;
  h->bounds = new double[n];
  std::copy(bounds, bounds + n, h->bounds);
  h->counts = new std::atomic<uint64_t>[n + 1];
  for (int32_t i = 0; i <= n; ++i)
    h->counts[i].store(0, std::memory_order_relaxed);
  return h;
}

HVD_EXPORT void hvd_hist_destroy(void* p) { delete static_cast<Hist*>(p); }

HVD_EXPORT void hvd_hist_observe(void* p, double v) {
  Hist* h = static_cast<Hist*>(p);
  // first bucket whose bound >= v (lower_bound: le semantics), else +Inf
  int32_t idx = static_cast<int32_t>(
      std::lower_bound(h->bounds, h->bounds + h->n, v) - h->bounds);
  h->counts[idx].fetch_add(1, std::memory_order_relaxed);
  atomic_add(h->sum, v);
  h->total.fetch_add(1, std::memory_order_relaxed);
}

HVD_EXPORT int32_t hvd_hist_read(void* p, uint64_t* out_counts,
                                 double* out_sum, uint64_t* out_total) {
  Hist* h = static_cast<Hist*>(p);
  for (int32_t i = 0; i <= h->n; ++i)
    out_counts[i] = h->counts[i].load(std::memory_order_relaxed);
  *out_sum = h->sum.load(std::memory_order_relaxed);
  *out_total = h->total.load(std::memory_order_relaxed);
  return h->n + 1;
}
