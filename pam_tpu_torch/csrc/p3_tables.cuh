// P3 lookup tables on the card: the index walks and the multilinear
// interpolation as device functions, for any kernel of the P3 scheme
// (csrc/p3_part2.cu today; part 3 and the sedimentation loops read the
// same tables through physics/p3/tables.py's contractions).
//
// pam_tpu (pam_tpu/physics/p3/tables.py:150-163) interpolates by dense
// hat-weight contractions, weights max(0, 1 - |k - x|) over every entry
// of an axis, because gathers are slow on a TPU and its matrix unit is
// free. Along an axis of n entries at the clamped position x only the
// entries k = min(floor(x), n - 2) and k + 1 carry a nonzero weight,
// 1 - (x - k) and 1 - ((k + 1) - x); every other term of the contraction
// is exactly 0. So here each lookup reads its 2^d corners (8 for the ice
// table, 16 for the collection table, 4 for a rain table) through the
// read-only path and combines them with those two weights, axis by axis
// in the contractions' order: the same numbers, up to the rounding of a
// two-term sum. The tables (12,000 + 60,000 + 3,000 values) stay in L2
// and L1. The plain PyTorch form of this arithmetic is
// physics/p3/tables.py::access_*_table_gather.
//
// Every expression follows physics/p3/tables.py::indices_* with each
// literal rounded to T as PyTorch rounds a Python scalar (1e-300 is 0 in
// float), and torch.clamp / maximum / minimum's NaN propagation.

#pragma once

#include <math.h>

namespace p3 {

// the tables' shapes (physics/p3/constants.py): ice (DENSIZE, RIMSIZE,
// ISIZE, ICE_ENTRIES), collect (DENSIZE, RIMSIZE, ISIZE, RCOLLSIZE,
// COLL_ENTRIES), rain (RAIN_SIZE, RAIN_MU)
constexpr int ISIZE = 50, DENSIZE = 5, RIMSIZE = 4, RCOLLSIZE = 30,
              ICE_ENTRIES = 12, COLL_ENTRIES = 2, RAIN_SIZE = 300,
              RAIN_MU = 10;

// torch.clamp / torch.maximum / torch.minimum semantics: NaN propagates
template <typename T>
__device__ __forceinline__ bool nan_(T x) {
  return x != x;
}
template <typename T>
__device__ __forceinline__ T cmax(T x, T lo) {  // clamp(x, min=lo)
  return nan_(x) ? x : (x < lo ? lo : x);
}
template <typename T>
__device__ __forceinline__ T cmin(T x, T hi) {  // clamp(x, max=hi)
  return nan_(x) ? x : (x > hi ? hi : x);
}
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return cmin(cmax(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return nan_(a) ? a : (nan_(b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return nan_(a) ? a : (nan_(b) ? b : (a < b ? a : b));
}

// tensor / Python scalar: on the card PyTorch multiplies by the scalar's
// reciprocal, taken in T
template <typename T>
__device__ __forceinline__ T div_scalar(T x, double s) {
  return x * (static_cast<T>(1.0) / static_cast<T>(s));
}

// The precise pow, exp, log, log10 and tanh of the CUDA math library,
// each as one body that every call site of a kernel shares: inlined,
// a float64 pow alone is some hundreds of instructions, and a kernel
// with a dozen of them outgrows the instruction cache.
#ifndef P3_MATH_INLINE
#define P3_MATH_INLINE __noinline__
#endif
template <typename T>
__device__ P3_MATH_INLINE T pow_(T x, T y) {
  return pow(x, y);
}
template <typename T>
__device__ P3_MATH_INLINE T exp_(T x) {
  return exp(x);
}
template <typename T>
__device__ P3_MATH_INLINE T log_(T x) {
  return log(x);
}
template <typename T>
__device__ P3_MATH_INLINE T log10_(T x) {
  return log10(x);
}
template <typename T>
__device__ P3_MATH_INLINE T tanh_(T x) {
  return tanh(x);
}

#define P3K(x) static_cast<T>(x)

// ------------------------------------------------------------ index walks
// Zero-based fractional positions, each clamped to its axis (the integer
// indices that indices_* also return are the corners corner() finds).

template <typename T>
struct IcePos {
  T size, rime, dens;
};

// indices_1a(qi, ni, qm, rhop); c1a is LOOKUP_TABLE_1A_DUM1_C
template <typename T>
__device__ __forceinline__ IcePos<T> indices_1a(T qi, T ni, T qm, T rhop,
                                                T c1a) {
  IcePos<T> p;
  const T dum1 =
      (log10_(qi / cmax(ni, P3K(1e-300))) + P3K(18.0)) * c1a - P3K(10.0);
  p.size = clip(dum1, P3K(1.0), P3K(ISIZE)) - P3K(1.0);
  const T dum4 = (qm / cmax(qi, P3K(1e-300))) * P3K(3.0) + P3K(1.0);
  p.rime = clip(dum4, P3K(1.0), P3K(RIMSIZE)) - P3K(1.0);
  const T dum5 = rhop <= P3K(650.0)
                     ? (rhop - P3K(50.0)) * P3K(0.005) + P3K(1.0)
                     : (rhop - P3K(650.0)) * P3K(0.004) + P3K(4.0);
  p.dens = clip(dum5, P3K(1.0), P3K(DENSIZE)) - P3K(1.0);
  return p;
}

// indices_1b(qr, nr): the rain-size position of the collection table;
// pi_rho_h2o is pi * rho_h2o
template <typename T>
__device__ __forceinline__ T indices_1b(T qr, T nr, T pi_rho_h2o) {
  const bool active = (qr >= P3K(1e-14)) && (nr > P3K(0.0));
  const T dumlr =
      pow_(qr / (cmax(nr, P3K(1e-300)) * pi_rho_h2o), P3K(1.0 / 3.0));
  T dum3 = (log10_(cmax(dumlr, P3K(1e-300))) + P3K(5.0)) * P3K(10.70415);
  dum3 = clip(dum3, P3K(1.0), P3K(RCOLLSIZE));
  return (active ? dum3 : P3K(1.0)) - P3K(1.0);
}

template <typename T>
struct RainPos {
  T size, mu;
};

// indices_3(mu_r, lamr)
template <typename T>
__device__ __forceinline__ RainPos<T> indices_3(T mu_r, T lamr) {
  RainPos<T> p;
  const T dum1 = (mu_r + P3K(1.0)) / cmax(lamr, P3K(1e-300));
  const T rdumii =
      dum1 <= P3K(195.0e-6)
          ? clip((dum1 * P3K(1e6) + P3K(5.0)) * P3K(0.1), P3K(1.0),
                 P3K(20.0))
          : clip(div_scalar(dum1 * P3K(1e6) - P3K(195.0), 30.0) + P3K(20.0),
                 P3K(20.0), P3K(RAIN_SIZE));
  p.size = rdumii - P3K(1.0);
  p.mu = clip(mu_r + P3K(1.0), P3K(1.0), P3K(RAIN_MU)) - P3K(1.0);
  return p;
}

// ---------------------------------------------------------- interpolation

// The two entries of an axis of n that carry the hat weights at the
// clamped position x in [0, n - 1]: k and k + 1, with _hat's weights
// (at x = n - 1 exactly: k = n - 2, weights 0 and 1; a NaN x gives NaN
// weights at k = 0)
template <typename T>
struct Corner {
  int k;
  T w0, w1;
};

template <typename T>
__device__ __forceinline__ Corner<T> corner(T x, int n) {
  Corner<T> c;
  const T fl = floor(x);
  c.k = fl >= P3K(n - 2) ? n - 2 : (fl >= P3K(0.0) ? static_cast<int>(fl) : 0);
  const T kf = static_cast<T>(c.k);
  c.w0 = P3K(1.0) - (x - kf);
  c.w1 = P3K(1.0) - ((kf + P3K(1.0)) - x);
  return c;
}

// access_ice_table_multi(tab, (E...), pos): the entries E... (zero-based)
// of the ice table at one position, contracted over size, then rime,
// then density
template <typename T, int... E>
__device__ __forceinline__ void ice_lookup(const T* __restrict__ tab,
                                           const IcePos<T>& pos,
                                           T (&out)[sizeof...(E)]) {
  constexpr int K = sizeof...(E);
  constexpr int e[K] = {E...};
  const Corner<T> ci = corner(pos.size, ISIZE), ck = corner(pos.rime, RIMSIZE),
                  cj = corner(pos.dens, DENSIZE);
  T t2[2][K];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    T t1[2][K];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const T* row = tab + (((cj.k + jj) * RIMSIZE + (ck.k + kk)) * ISIZE +
                            ci.k) * ICE_ENTRIES;
#pragma unroll
      for (int n = 0; n < K; ++n)
        t1[kk][n] = __ldg(row + e[n]) * ci.w0 +
                    __ldg(row + ICE_ENTRIES + e[n]) * ci.w1;
    }
#pragma unroll
    for (int n = 0; n < K; ++n)
      t2[jj][n] = t1[0][n] * ck.w0 + t1[1][n] * ck.w1;
  }
#pragma unroll
  for (int n = 0; n < K; ++n) out[n] = t2[0][n] * cj.w0 + t2[1][n] * cj.w1;
}

// access_collect_table_multi(tab, (0, 1), pos, rain): both entries of the
// collection table, contracted over size, rain size, rime, then density
template <typename T>
__device__ __forceinline__ void collect_lookup(const T* __restrict__ tab,
                                               const IcePos<T>& pos, T rain,
                                               T (&out)[COLL_ENTRIES]) {
  constexpr int K = COLL_ENTRIES;
  const Corner<T> ci = corner(pos.size, ISIZE), cr = corner(rain, RCOLLSIZE),
                  ck = corner(pos.rime, RIMSIZE),
                  cj = corner(pos.dens, DENSIZE);
  T t2[2][K];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    T t1[2][K];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const T* at = tab + ((((cj.k + jj) * RIMSIZE + (ck.k + kk)) * ISIZE +
                            ci.k) * RCOLLSIZE + cr.k) * K;
      T t0[2][K];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int n = 0; n < K; ++n)
          t0[rr][n] = __ldg(at + rr * K + n) * ci.w0 +
                      __ldg(at + (RCOLLSIZE + rr) * K + n) * ci.w1;
#pragma unroll
      for (int n = 0; n < K; ++n)
        t1[kk][n] = t0[0][n] * cr.w0 + t0[1][n] * cr.w1;
    }
#pragma unroll
    for (int n = 0; n < K; ++n)
      t2[jj][n] = t1[0][n] * ck.w0 + t1[1][n] * ck.w1;
  }
#pragma unroll
  for (int n = 0; n < K; ++n) out[n] = t2[0][n] * cj.w0 + t2[1][n] * cj.w1;
}

// access_rain_table(tab, pos): one (RAIN_SIZE, RAIN_MU) table, contracted
// over size, then mu
template <typename T>
__device__ __forceinline__ T rain_lookup(const T* __restrict__ tab,
                                         const RainPos<T>& pos) {
  const Corner<T> ci = corner(pos.size, RAIN_SIZE),
                  cm = corner(pos.mu, RAIN_MU);
  const T* at = tab + ci.k * RAIN_MU + cm.k;
  const T t0 = __ldg(at) * ci.w0 + __ldg(at + RAIN_MU) * ci.w1;
  const T t1 = __ldg(at + 1) * ci.w0 + __ldg(at + RAIN_MU + 1) * ci.w1;
  return t0 * cm.w0 + t1 * cm.w1;
}

#undef P3K

}  // namespace p3
