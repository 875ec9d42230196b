// Native CPU runtime for tpu_assim.
//
// The reference's hot path rides ATen/LAPACK from Python per grid point
// (/root/reference/pytassim/core/utils.py:57 torch.symeig inside an
// np.vectorize loop, interface/letkf.py:127-143) — Python-call-rate bound.
// This library is the host-side (non-accelerator) runtime equivalent: an
// OpenMP-threaded, batched localized-ETKF weight solver (cyclic Jacobi
// eigensolver per K x K Gram matrix) and the observation bucketing /
// neighborhood machinery used by the input pipeline. The device compute path
// (XLA) never calls this; it serves CPU-only deployments, host-side
// data preparation, and as an independent oracle for tests.
//
// Exported C ABI (bound via ctypes, tpu_assim/runtime/native.py):
//   ta_letkf_weights_dense  — batched localized ETKF weights, f64
//   ta_etkf_weights         — single global ETKF weight matrix, f64
//   ta_bucket_obs           — counting-sort obs->shard bucketing
//   ta_gaspari_cohn         — batched GC(z, 1/2, c) taper evaluation
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (see runtime/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// Cyclic one-sided Jacobi eigendecomposition of a symmetric k x k matrix.
// a: row-major k x k, overwritten with garbage; evals: k; evecs: row-major
// k x k whose COLUMNS are eigenvectors (evecs[i*k+j] = V_ij).
// K is small (ensemble size <= ~128), so O(k^3) sweeps are fine and
// convergence is quadratic; 30 sweeps is far beyond need.
void jacobi_eigh(double* a, int64_t k, double* evals, double* evecs) {
  for (int64_t i = 0; i < k; ++i)
    for (int64_t j = 0; j < k; ++j) evecs[i * k + j] = (i == j) ? 1.0 : 0.0;
  const int max_sweeps = 30;
  const double tol = 1e-14;
  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    double off = 0.0;
    for (int64_t p = 0; p < k; ++p)
      for (int64_t q = p + 1; q < k; ++q) off += a[p * k + q] * a[p * k + q];
    if (std::sqrt(off) < tol) break;
    for (int64_t p = 0; p < k - 1; ++p) {
      for (int64_t q = p + 1; q < k; ++q) {
        const double apq = a[p * k + q];
        if (std::fabs(apq) < 1e-300) continue;
        const double app = a[p * k + p];
        const double aqq = a[q * k + q];
        const double theta = 0.5 * (aqq - app) / apq;
        const double t = (theta >= 0 ? 1.0 : -1.0) /
                         (std::fabs(theta) + std::sqrt(1.0 + theta * theta));
        const double c = 1.0 / std::sqrt(1.0 + t * t);
        const double s = t * c;
        // A <- J^T A J on rows/cols p, q
        for (int64_t i = 0; i < k; ++i) {
          const double aip = a[i * k + p];
          const double aiq = a[i * k + q];
          a[i * k + p] = c * aip - s * aiq;
          a[i * k + q] = s * aip + c * aiq;
        }
        for (int64_t i = 0; i < k; ++i) {
          const double api = a[p * k + i];
          const double aqi = a[q * k + i];
          a[p * k + i] = c * api - s * aqi;
          a[q * k + i] = s * api + c * aqi;
        }
        for (int64_t i = 0; i < k; ++i) {
          const double vip = evecs[i * k + p];
          const double viq = evecs[i * k + q];
          evecs[i * k + p] = c * vip - s * viq;
          evecs[i * k + q] = s * vip + c * viq;
        }
      }
    }
  }
  for (int64_t i = 0; i < k; ++i) evals[i] = a[i * k + i];
}

// One localized ETKF weight solve (reference math: pytassim/core/etkf.py:57-77
// with wrapper.py:86-99 localization scaling): given normalized perts z [k,o],
// innovations y [o], per-obs taper weights w [o], write weights [k,k].
void letkf_point_solve(const double* perts, const double* innov,
                       const double* obs_w, int64_t k, int64_t o,
                       double inf_factor, double* out,
                       double* gram, double* evals, double* evecs,
                       double* zy, double* cov_zy) {
  const double reg = (static_cast<double>(k) - 1.0) / inf_factor;
  // G = Z diag(w) Z^T ; zy = Z diag(w) y
  for (int64_t i = 0; i < k; ++i) {
    for (int64_t j = i; j < k; ++j) {
      double acc = 0.0;
      for (int64_t n = 0; n < o; ++n)
        acc += perts[i * o + n] * obs_w[n] * perts[j * o + n];
      gram[i * k + j] = acc;
      gram[j * k + i] = acc;
    }
    double acc = 0.0;
    for (int64_t n = 0; n < o; ++n)
      acc += perts[i * o + n] * obs_w[n] * innov[n];
    zy[i] = acc;
  }
  jacobi_eigh(gram, k, evals, evecs);
  // evals <- clamp(evals, 0) + reg; inverse eigenvalues used twice
  for (int64_t i = 0; i < k; ++i) {
    const double e = std::max(evals[i], 0.0) + reg;
    evals[i] = 1.0 / e;  // inverse
  }
  // w_mean = V diag(einv) V^T zy ; W' = V diag(sqrt((k-1)einv)) V^T
  for (int64_t i = 0; i < k; ++i) {
    double acc = 0.0;
    for (int64_t j = 0; j < k; ++j) acc += evecs[j * k + i] * zy[j];
    cov_zy[i] = acc * evals[i];  // diag(einv) V^T zy
  }
  const double km1 = static_cast<double>(k) - 1.0;
  for (int64_t i = 0; i < k; ++i) {
    double wm = 0.0;
    for (int64_t j = 0; j < k; ++j) wm += evecs[i * k + j] * cov_zy[j];
    for (int64_t m = 0; m < k; ++m) {
      double wp = 0.0;
      for (int64_t j = 0; j < k; ++j)
        wp += evecs[i * k + j] * std::sqrt(km1 * evals[j]) * evecs[m * k + j];
      out[i * k + m] = wm + wp;
    }
  }
}

}  // namespace

extern "C" {

// Batched localized-ETKF weights.
// perts [k, o], innov [o], obs_w [g, o] row-major f64; out [g, k, k].
// Returns 0 on success.
int ta_letkf_weights_dense(const double* perts, const double* innov,
                           const double* obs_w, double* out, int64_t g,
                           int64_t k, int64_t o, double inf_factor) {
  if (g < 0 || k <= 0 || o < 0) return 1;
#pragma omp parallel
  {
    std::vector<double> gram(k * k), evals(k), evecs(k * k), zy(k), cov_zy(k);
#pragma omp for schedule(static)
    for (int64_t col = 0; col < g; ++col) {
      letkf_point_solve(perts, innov, obs_w + col * o, k, o, inf_factor,
                        out + col * k * k, gram.data(), evals.data(),
                        evecs.data(), zy.data(), cov_zy.data());
    }
  }
  return 0;
}

// Global ETKF weights: all obs weights = 1 (reference: core/etkf.py:79-103).
int ta_etkf_weights(const double* perts, const double* innov, double* out,
                    int64_t k, int64_t o, double inf_factor) {
  std::vector<double> ones(o, 1.0), gram(k * k), evals(k), evecs(k * k),
      zy(k), cov_zy(k);
  letkf_point_solve(perts, innov, ones.data(), k, o, inf_factor, out,
                    gram.data(), evals.data(), evecs.data(), zy.data(),
                    cov_zy.data());
  return 0;
}

// Counting-sort bucketing of observations into grid shards (the native
// version of parallel/halo.py:shard_observations' assignment loop).
// obs_idx [n]: observed grid column; order [n]: output permutation grouping
// obs by shard (stable); counts [n_shards]: obs per shard.
// Returns the max per-shard count (the static obs_per_shard), or -1 on error.
int64_t ta_bucket_obs(const int32_t* obs_idx, int64_t n, int64_t shard_size,
                      int64_t n_shards, int32_t* order, int64_t* counts) {
  if (shard_size <= 0 || n_shards <= 0) return -1;
  std::memset(counts, 0, sizeof(int64_t) * n_shards);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = obs_idx[i] / shard_size;
    if (s < 0 || s >= n_shards) return -1;
    counts[s]++;
  }
  std::vector<int64_t> offs(n_shards, 0);
  for (int64_t s = 1; s < n_shards; ++s) offs[s] = offs[s - 1] + counts[s - 1];
  for (int64_t i = 0; i < n; ++i) {
    const int64_t s = obs_idx[i] / shard_size;
    order[offs[s]++] = static_cast<int32_t>(i);
  }
  int64_t maxc = 0;
  for (int64_t s = 0; s < n_shards; ++s) maxc = std::max(maxc, counts[s]);
  return maxc;
}

// Batched Gaspari-Cohn GC(z, 1/2, c) taper over |grid - obs| distances
// (polynomials verbatim from pytassim/localization/gaspari_cohn.py:77-95).
// grid [g], obs [o] 1-D coordinates; out [g, o]; weights < eps cut to 0.
int ta_gaspari_cohn(const double* grid, const double* obs, double* out,
                    int64_t g, int64_t o, double radius, double eps) {
  if (radius <= 0) return 1;
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < g; ++i) {
    for (int64_t j = 0; j < o; ++j) {
      const double z = std::fabs(grid[i] - obs[j]) / radius;
      double w = 0.0;
      if (z < 1.0) {
        w = -0.25 * z * z * z * z * z + 0.5 * z * z * z * z +
            0.625 * z * z * z - 5.0 / 3.0 * z * z + 1.0;
      } else if (z < 2.0) {
        w = z * z * z * z * z / 12.0 - 0.5 * z * z * z * z +
            0.625 * z * z * z + 5.0 / 3.0 * z * z - 5.0 * z + 4.0 -
            2.0 / (3.0 * z);
      }
      out[i * o + j] = (w > eps) ? w : 0.0;
    }
  }
  return 0;
}

}  // extern "C"
