// gpu_bench native runtime support (C++17, no CUDA).
//
// Counterpart of the reference's host-side C++ layer: the
// monotonic stopwatch (utils/timer.h:3-45), the deterministic data
// initializers that every benchmark harness runs before timing
// (benchmark01/benchmark01.cc:178, benchmark02/benchmark02.cc:139-143,
// benchmark03/benchmark03.cc:161-167, benchmark04/benchmark04.cc:470-486),
// and fast float64 CPU reference oracles used by the validation layer so
// that norm cross-checks stay cheap even at large sizes.  The device compute
// path itself lives in JAX/Pallas; this library is host runtime only.
//
// Exposed with a plain C ABI and loaded from Python via ctypes
// (gpu_bench/utils/native.py).  Falls back to NumPy when not built.

#include <cmath>
#include <cstdint>
#include <ctime>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---- stopwatch ----------------------------------------------------------

int64_t tb_monotonic_ns() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<int64_t>(ts.tv_sec) * 1000000000ll + ts.tv_nsec;
}

// ---- deterministic initializers ----------------------------------------

// b01/b02 first operand: x[i] = i%13 + (0.2 + 1e-5 * (i%100191))
void tb_init_mod13(double* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (double)(i % 13) + (0.2 + 0.00001 * (double)(i % 100191));
    }
}

// b02 second operand: y[i] = i%8 + (0.4 + 3e-5 * (i%100721))
void tb_init_mod8(double* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = (double)(i % 8) + (0.4 + 0.00003 * (double)(i % 100721));
    }
}

// b03 matrix: A[l] = sin(l + 1); b04/b05 element data: in[l] = sin(l + 1)
void tb_init_sin1(double* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = std::sin((double)(i + 1));
    }
}

// b04/b05 basis: B[l] = cos(l)
void tb_init_cos(double* out, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        out[i] = std::cos((double)i);
    }
}

// ---- validation oracles (float64, OpenMP) ------------------------------

double tb_l2norm_sq(const double* x, int64_t n) {
    double acc = 0.0;
#pragma omp parallel for reduction(+ : acc) schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        acc += x[i] * x[i];
    }
    return acc;
}

double tb_dot(const double* x, const double* y, int64_t n) {
    double acc = 0.0;
#pragma omp parallel for reduction(+ : acc) schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        acc += x[i] * y[i];
    }
    return acc;
}

// y = A.x with A row-major (m x n) — b03 oracle
void tb_matvec_ref(const double* A, const double* x, double* y, int64_t m,
                   int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < m; ++i) {
        double acc = 0.0;
        for (int64_t j = 0; j < n; ++j) {
            acc += A[i * n + j] * x[j];
        }
        y[i] = acc;
    }
}

// 2D BwdTrans oracle: out[e,j,i] = sum_{q,p} in[e,q,p] B0[p,i] B1[q,j]
// (loop structure of benchmark04/benchmark04.cc:489-523, f64, OpenMP)
void tb_bwdtrans2d_ref(const double* in, const double* b0, const double* b1,
                       double* out, int64_t nelmt, int64_t nq0, int64_t nq1,
                       int64_t nm0, int64_t nm1) {
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < nelmt; ++e) {
        const double* ine = in + e * nm0 * nm1;
        double* oute = out + e * nq0 * nq1;
        for (int64_t j = 0; j < nq1; ++j) {
            for (int64_t i = 0; i < nq0; ++i) {
                double acc = 0.0;
                for (int64_t q = 0; q < nm1; ++q) {
                    double tmp = 0.0;
                    for (int64_t p = 0; p < nm0; ++p) {
                        tmp += ine[q * nm0 + p] * b0[p * nq0 + i];
                    }
                    acc += tmp * b1[q * nq1 + j];
                }
                oute[j * nq0 + i] = acc;
            }
        }
    }
}

// 3D BwdTrans oracle: out[e,k,j,i] = sum_{r,q,p} in[e,r,q,p] B0[p,i] B1[q,j]
// B2[r,k] (semantics of benchmark05/benchmark05.cc:695-740)
void tb_bwdtrans3d_ref(const double* in, const double* b0, const double* b1,
                       const double* b2, double* out, int64_t nelmt,
                       int64_t nq0, int64_t nq1, int64_t nq2, int64_t nm0,
                       int64_t nm1, int64_t nm2) {
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < nelmt; ++e) {
        const double* ine = in + e * nm0 * nm1 * nm2;
        double* oute = out + e * nq0 * nq1 * nq2;
        for (int64_t k = 0; k < nq2; ++k) {
            for (int64_t j = 0; j < nq1; ++j) {
                for (int64_t i = 0; i < nq0; ++i) {
                    double acc = 0.0;
                    for (int64_t r = 0; r < nm2; ++r) {
                        double accq = 0.0;
                        for (int64_t q = 0; q < nm1; ++q) {
                            double tmp = 0.0;
                            for (int64_t p = 0; p < nm0; ++p) {
                                tmp += ine[(r * nm1 + q) * nm0 + p] *
                                       b0[p * nq0 + i];
                            }
                            accq += tmp * b1[q * nq1 + j];
                        }
                        acc += accq * b2[r * nq2 + k];
                    }
                    oute[(k * nq1 + j) * nq0 + i] = acc;
                }
            }
        }
    }
}

}  // extern "C"
