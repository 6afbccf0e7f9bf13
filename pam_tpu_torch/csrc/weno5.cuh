// The order-5 WENO limiter of pam_tpu_torch's CUDA kernels (sm_90a), once.
//
// csrc/weno_x.cu (periodic-x edge reconstruction) and csrc/awfl_flux.cu
// (the AWFL directional flux) both evaluate the limiter of
// ops/weno.py::_weno_candidates_and_weights (ref dynamics/awfl/
// WenoLimiter.h:98-181): three quadratic candidates and the bridge
// polynomial of a five-cell stencil, their smoothness indicators, the
// mapped nonlinear weights, and the weighted polynomial. This header holds
// that limiter as a *cell limiter*: five stencil values in, the five
// weighted monomial coefficients out. Nothing in it depends on the edge,
// so one call serves both edges of a cell (`edges`) or the one that faces
// the flow (`edge`).
//
// What bounds it: instructions issued. A point is about 150 multiply-adds
// and 6 reciprocals on values held in registers; no tensor-core shape and
// no bulk copy is in it (the limiter is nonlinear and pointwise, so
// `wgmma` and TMA do not apply). The design therefore counts instructions:
//
//  * Every constant is prepared on the host (ops/weno5.py::
//    prepare_tables, checked there against the numpy formulas): the bridge
//    polynomial's matrix (s2c - sum_i idl_i wrl_i) / idl_hi merged into one
//    5x5 matrix, the smoothness forms as their nonzero merged upper
//    triangles (the forms couple only coefficients of equal parity, which
//    prepare_tables verifies), the map's four constants per weight formed
//    in double, 1/3, and the monomials at +1/2 (those at -1/2 differ in
//    the sign of the odd ones). The kernel tests no table entry and adds
//    no pair of them.
//  * One reciprocal per normalisation. The first normalisation is four
//    reciprocals (of tv^2 + eps) and one of their sum. The map
//    w (a - b w + w^2) / (c + d w) and the second normalisation together
//    take one: with n_i the numerators and d_i the denominators (each
//    within [idl_i^2, (1 - idl_i)^2], so their products neither overflow
//    nor vanish), w_i = n_i prod_{j != i} d_j / sum_k n_k prod_{j != k}
//    d_j. The eps = 1e-20 that the plain version adds to that second sum
//    (of order 1) is below rounding in both precisions and is left out.
//  * Reciprocals are the hardware's approximation, one MUFU instruction
//    (float: 1 ulp) or one plus two Newton steps (double: to rounding),
//    without the IEEE division's slow path: every argument is a sum of
//    positive terms of at least 1e-20.
//  * Products and sums are written so that they contract to multiply-adds
//    (the two sources are built with contraction on).
//
// The result differs from the plain version by rounding only:
// chip_smoke.py holds both kernels within 1e-12 (float64) and 2e-5
// (float32) of each output's largest value, and tests/test_torch_weno.py
// holds ops/weno5.py::cell_limiter, the numpy transcription of this
// file's order of operations, against ops/weno.py at 1e-13.

#pragma once

#include <cuda_runtime.h>

namespace weno5 {

constexpr int ORD = 5;
constexpr int HS = 3;    // number and size of the low-order sub-stencils
constexpr int NMAT = ORD * ORD + HS * HS * HS;  // stencil matrices of a level
constexpr int NTAB = NMAT + 2 + 6 + ORD + 5 * (HS + 1) + 2;

// The tables as ops/weno5.py::prepare_tables packs them, in this order.
template <typename T>
struct Tables {
  T mat[NMAT];      // bridge[c][s] at c*5+s, then wrl[i][s][c] at
                    // 25+(i*3+s)*3+c: stencil -> candidate coefficients
  T tvl[2];         // low-order smoothness form: (1,1), (2,2)
  T tvh[6];         // bridge form: (1,1), (1,3), (2,2), (2,4), (3,3), (4,4)
  T g[ORD];         // monomials at x = +1/2
  T idl[HS + 1];    // ideal weights
  T map_a[HS + 1];  // idl + idl^2
  T map_b[HS + 1];  // 3 idl
  T map_c[HS + 1];  // idl^2
  T map_d[HS + 1];  // 1 - 2 idl
  T sigma;
  T third;          // 1 / HS
};

template <typename T>
Tables<T> unpack(const double* p) {
  static_assert(sizeof(Tables<T>) == NTAB * sizeof(T), "Tables is NTAB values");
  Tables<T> t;
  T* q = reinterpret_cast<T*>(&t);
  for (int k = 0; k < NTAB; ++k) q[k] = T(p[k]);
  return t;
}

// n / d for 0 <= n < 2^31 by a multiplication, the constants from the host.
struct FastDiv {
  unsigned d, mul, shr;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d == 1 ? n : __umulhi(n, mul) >> shr;
  }
  __device__ __forceinline__ void divmod(unsigned n, unsigned& q,
                                         unsigned& r) const {
    q = div(n);
    r = n - q * d;
  }
};

inline FastDiv fast_div(unsigned d) {
  FastDiv f{d, 0u, 0u};
  if (d > 1) {
    unsigned log2 = 0;
    while ((1ull << log2) < d) ++log2;
    const unsigned p = 31 + log2;
    f.mul = (unsigned)(((1ull << p) + d - 1) / d);
    f.shr = p - 32;
  }
  return f;
}

__device__ __forceinline__ float rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ double rcp(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  double e = fma(-x, r, 1.0);   // the seed holds some 20 bits
  r = fma(r, e, r);
  e = fma(-x, r, 1.0);
  r = fma(r, e, r);
  return r;
}

// The stencil matrices of the uniform grid: kernel parameters, read as
// constant operands of the multiply-adds.
template <typename T>
struct UniformMats {
  const Tables<T>& t;
  __device__ __forceinline__ T operator()(int k) const { return t.mat[k]; }
};

// The stencil matrices of one level of a stretched grid: NMAT values at a
// 16-byte aligned address, fetched with 16-byte loads.
template <typename T>
struct LevelMats {
  T m[NMAT];
  __device__ __forceinline__ explicit LevelMats(const T* p) {
    if constexpr (sizeof(T) == 4) {
      const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
      for (int k = 0; k < NMAT / 4; ++k) {
        const float4 x = v[k];
        m[4 * k] = x.x;
        m[4 * k + 1] = x.y;
        m[4 * k + 2] = x.z;
        m[4 * k + 3] = x.w;
      }
    } else {
      const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
      for (int k = 0; k < NMAT / 2; ++k) {
        const double2 x = v[k];
        m[2 * k] = x.x;
        m[2 * k + 1] = x.y;
      }
    }
  }
  __device__ __forceinline__ T operator()(int k) const { return m[k]; }
};

// The cell limiter: the stencil u[0..4] of a cell (the cell is u[2]) to
// the weighted polynomial's monomial coefficients a[0..4], on the cell's
// normalised coordinate in [-1/2, 1/2].
template <typename T, typename M>
__device__ __forceinline__ void cell_limiter(const T (&u)[ORD], const M& m,
                                             const Tables<T>& t,
                                             T (&a)[ORD]) {
  // candidates: three quadratics and the bridge polynomial
  T lo[HS][HS];
#pragma unroll
  for (int i = 0; i < HS; ++i)
#pragma unroll
    for (int c = 0; c < HS; ++c) {
      T acc = m(ORD * ORD + (i * HS) * HS + c) * u[i];
#pragma unroll
      for (int s = 1; s < HS; ++s)
        acc += m(ORD * ORD + (i * HS + s) * HS + c) * u[i + s];
      lo[i][c] = acc;
    }
  T br[ORD];
#pragma unroll
  for (int c = 0; c < ORD; ++c) {
    T acc = m(c * ORD) * u[0];
#pragma unroll
    for (int s = 1; s < ORD; ++s) acc += m(c * ORD + s) * u[s];
    br[c] = acc;
  }

  // smoothness indicators; the bridge's is blended with the low-order mean
  T tv[HS + 1];
  T lo_sum = T(0);
#pragma unroll
  for (int i = 0; i < HS; ++i) {
    tv[i] = t.tvl[0] * lo[i][1] * lo[i][1] + t.tvl[1] * lo[i][2] * lo[i][2];
    lo_sum += tv[i];
  }
  const T hi = br[1] * (t.tvh[0] * br[1] + t.tvh[1] * br[3]) +
               br[2] * (t.tvh[2] * br[2] + t.tvh[3] * br[4]) +
               t.tvh[4] * br[3] * br[3] + t.tvh[5] * br[4] * br[4];
  const T lo_avg = lo_sum * t.third;
  tv[HS] = lo_avg + (hi - lo_avg) * t.sigma;

  // nonlinear weights idl / (tv^2 + eps), normalised
  const T eps = T(1.0e-20);
  T w[HS + 1];
  T sum = eps;
#pragma unroll
  for (int i = 0; i < HS + 1; ++i) {
    w[i] = t.idl[i] * rcp(tv[i] * tv[i] + eps);
    sum += w[i];
  }
  T r = rcp(sum);
  // the map's numerators and denominators, then map and second
  // normalisation with one reciprocal
  T d[HS + 1];
#pragma unroll
  for (int i = 0; i < HS + 1; ++i) {
    const T wi = w[i] * r;
    w[i] = wi * (t.map_a[i] + wi * (wi - t.map_b[i]));
    d[i] = t.map_c[i] + wi * t.map_d[i];
  }
  const T d01 = d[0] * d[1];
  const T d23 = d[2] * d[3];
  w[0] *= d[1] * d23;
  w[1] *= d[0] * d23;
  w[2] *= d[3] * d01;
  w[3] *= d[2] * d01;
  r = rcp((w[0] + w[1]) + (w[2] + w[3]));
#pragma unroll
  for (int i = 0; i < HS + 1; ++i) w[i] *= r;

  // the weighted polynomial
#pragma unroll
  for (int c = 0; c < ORD; ++c) {
    T acc = w[HS] * br[c];
    if (c < HS) {
#pragma unroll
      for (int i = 0; i < HS; ++i) acc += w[i] * lo[i][c];
    }
    a[c] = acc;
  }
}

// The polynomial's even and odd part at x = +1/2.
template <typename T>
__device__ __forceinline__ void halves(const T (&a)[ORD], const Tables<T>& t,
                                       T& even, T& odd) {
  even = a[0] + t.g[2] * a[2] + t.g[4] * a[4];
  odd = t.g[1] * a[1] + t.g[3] * a[3];
}

// Both edge values of the cell: at x = -1/2 (left) and +1/2 (right).
template <typename T>
__device__ __forceinline__ void edges(const T (&a)[ORD], const Tables<T>& t,
                                      T& left, T& right) {
  T even, odd;
  halves(a, t, even, odd);
  left = even - odd;
  right = even + odd;
}

// One edge value of the cell.
template <typename T>
__device__ __forceinline__ T edge(const T (&a)[ORD], const Tables<T>& t,
                                  bool right) {
  T even, odd;
  halves(a, t, even, odd);
  return right ? even + odd : even - odd;
}

}  // namespace weno5
