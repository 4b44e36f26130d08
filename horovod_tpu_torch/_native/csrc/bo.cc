// Bayesian optimization with Gaussian-process regression (the port's copy
// of the JAX package's _native/csrc/bo.cc, unchanged in behaviour).
//
// Native analogue of the reference autotuner's optimizer (horovod/common/
// optim/{bayesian_optimization,gaussian_process}.{h,cc}): expected-
// improvement BO over an RBF-kernel GP, used by ParameterManager to tune the
// fusion threshold and the pack cutoff by throughput score. Self-contained
// dense linear algebra (Cholesky), no Eigen/LBFGS; EI is maximized by a
// deterministic pseudo-random candidate search, which at the 1-3 dimensions
// of the tuning space matches gradient ascent in practice and keeps every
// process's suggestion identical for a given observation history, and the
// same as the JAX package's for the same history, bit for bit.
#include <cmath>
#include <cstdint>
#include <vector>

#include "common.hpp"

namespace {

struct BO {
  int32_t dim;
  std::vector<double> lo, hi;
  std::vector<std::vector<double>> xs;  // normalized [0,1]^dim
  std::vector<double> ys;               // raw scores (higher = better)
  uint64_t seed;
  double length_scale = 0.2;
  double noise = 1e-6;
};

// xorshift64* — deterministic across platforms.
double next_unit(uint64_t* s) {
  uint64_t x = *s;
  x ^= x >> 12;
  x ^= x << 25;
  x ^= x >> 27;
  *s = x;
  return (double)((x * 0x2545F4914F6CDD1DULL) >> 11) / 9007199254740992.0;
}

double kernel(const std::vector<double>& a, const std::vector<double>& b,
              double ls) {
  double d2 = 0;
  for (size_t i = 0; i < a.size(); i++) {
    double d = a[i] - b[i];
    d2 += d * d;
  }
  return std::exp(-d2 / (2.0 * ls * ls));
}

// Cholesky factorization of A (n x n, row-major) in place: A = L L^T.
// Returns false if not positive definite.
bool cholesky(std::vector<double>& a, int n) {
  for (int i = 0; i < n; i++) {
    for (int j = 0; j <= i; j++) {
      double sum = a[i * n + j];
      for (int k = 0; k < j; k++) sum -= a[i * n + k] * a[j * n + k];
      if (i == j) {
        if (sum <= 0) return false;
        a[i * n + i] = std::sqrt(sum);
      } else {
        a[i * n + j] = sum / a[j * n + j];
      }
    }
    for (int j = i + 1; j < n; j++) a[i * n + j] = 0;
  }
  return true;
}

// Solves L y = b then L^T x = y (in place on b).
void chol_solve(const std::vector<double>& l, int n, std::vector<double>& b) {
  for (int i = 0; i < n; i++) {
    double sum = b[i];
    for (int k = 0; k < i; k++) sum -= l[i * n + k] * b[k];
    b[i] = sum / l[i * n + i];
  }
  for (int i = n - 1; i >= 0; i--) {
    double sum = b[i];
    for (int k = i + 1; k < n; k++) sum -= l[k * n + i] * b[k];
    b[i] = sum / l[i * n + i];
  }
}

double norm_cdf(double z) { return 0.5 * std::erfc(-z / std::sqrt(2.0)); }

double norm_pdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}

}  // namespace

HVD_EXPORT void* hvd_bo_create(int32_t dim, const double* lo,
                               const double* hi, uint64_t seed) {
  auto* b = new BO();
  b->dim = dim;
  b->lo.assign(lo, lo + dim);
  b->hi.assign(hi, hi + dim);
  b->seed = seed ? seed : 0x9E3779B97F4A7C15ULL;
  return b;
}

HVD_EXPORT void hvd_bo_destroy(void* p) { delete static_cast<BO*>(p); }

HVD_EXPORT void hvd_bo_observe(void* p, const double* x, double y) {
  auto* b = static_cast<BO*>(p);
  std::vector<double> xn(b->dim);
  for (int i = 0; i < b->dim; i++) {
    double span = b->hi[i] - b->lo[i];
    xn[i] = span > 0 ? (x[i] - b->lo[i]) / span : 0.0;
  }
  b->xs.push_back(std::move(xn));
  b->ys.push_back(y);
}

HVD_EXPORT int64_t hvd_bo_num_obs(void* p) {
  return (int64_t)static_cast<BO*>(p)->ys.size();
}

// Writes the next point to evaluate into x_out (denormalized). With fewer
// than 2 observations, space-filling pseudo-random exploration; afterwards,
// argmax of expected improvement over `n_cand` candidates. Deterministic for
// a given observation history.
HVD_EXPORT void hvd_bo_suggest(void* p, int32_t n_cand, double* x_out) {
  auto* b = static_cast<BO*>(p);
  int n = (int)b->ys.size();
  uint64_t rng = b->seed + (uint64_t)n * 0xD1B54A32D192ED03ULL;
  if (n_cand <= 0) n_cand = 512;

  auto denorm = [&](const std::vector<double>& xn) {
    for (int i = 0; i < b->dim; i++)
      x_out[i] = b->lo[i] + xn[i] * (b->hi[i] - b->lo[i]);
  };

  if (n < 2) {
    std::vector<double> xn(b->dim);
    for (int i = 0; i < b->dim; i++) xn[i] = next_unit(&rng);
    denorm(xn);
    return;
  }

  // Normalize y for a zero-mean unit-ish-scale GP.
  double mean = 0, var = 0;
  for (double y : b->ys) mean += y;
  mean /= n;
  for (double y : b->ys) var += (y - mean) * (y - mean);
  double sd = std::sqrt(var / n);
  if (sd < 1e-12) sd = 1.0;
  std::vector<double> yn(n);
  double best_y = -1e300;
  for (int i = 0; i < n; i++) {
    yn[i] = (b->ys[i] - mean) / sd;
    if (yn[i] > best_y) best_y = yn[i];
  }

  // K + noise I, Cholesky, alpha = K^-1 y.
  std::vector<double> K((size_t)n * n);
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) {
      K[(size_t)i * n + j] = kernel(b->xs[i], b->xs[j], b->length_scale);
      if (i == j) K[(size_t)i * n + j] += b->noise;
    }
  if (!cholesky(K, n)) {
    // Degenerate (duplicate points): fall back to exploration.
    std::vector<double> xn(b->dim);
    for (int i = 0; i < b->dim; i++) xn[i] = next_unit(&rng);
    denorm(xn);
    return;
  }
  std::vector<double> alpha = yn;
  chol_solve(K, n, alpha);

  double best_ei = -1;
  std::vector<double> best_x(b->dim, 0.5);
  std::vector<double> kstar(n), v(n);
  for (int c = 0; c < n_cand; c++) {
    std::vector<double> xn(b->dim);
    for (int i = 0; i < b->dim; i++) xn[i] = next_unit(&rng);
    for (int i = 0; i < n; i++)
      kstar[i] = kernel(xn, b->xs[i], b->length_scale);
    // mu = k*^T alpha
    double mu = 0;
    for (int i = 0; i < n; i++) mu += kstar[i] * alpha[i];
    // sigma^2 = k(x,x) - k*^T K^-1 k*  via v = L^-1 k*
    v = kstar;
    for (int i = 0; i < n; i++) {
      double sum = v[i];
      for (int k = 0; k < i; k++) sum -= K[(size_t)i * n + k] * v[k];
      v[i] = sum / K[(size_t)i * n + i];
    }
    double s2 = 1.0 + b->noise;
    for (int i = 0; i < n; i++) s2 -= v[i] * v[i];
    double sigma = s2 > 1e-12 ? std::sqrt(s2) : 0.0;
    double ei;
    const double xi = 0.01;  // exploration margin
    if (sigma <= 0) {
      ei = 0;
    } else {
      double z = (mu - best_y - xi) / sigma;
      ei = (mu - best_y - xi) * norm_cdf(z) + sigma * norm_pdf(z);
    }
    if (ei > best_ei) {
      best_ei = ei;
      best_x = xn;
    }
  }
  denorm(best_x);
}
