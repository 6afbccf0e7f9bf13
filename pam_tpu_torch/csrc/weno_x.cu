// Periodic-x order-5 WENO edge reconstruction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels pam_tpu/ops/weno_x_pallas.py
// (edge_recon_x_pallas, body _kernel) and pam_tpu/ops/weno_pallas.py
// (edge_recon_x/_run), which compute the same function: for every cell of
// every row, the WENO-limited values at its left and right edge, from the
// five cells i-2 .. i+2 with i wrapped modulo nx (the uniform-grid branch
// of spam/tendencies.py::_edge_recon_x). The math is that of
// ops/weno.py::weno_edges_list with the tables of weno_tables(5): three
// quadratic candidates, the bridge polynomial, Jiang-Shu smoothness
// quadratic forms, mapped nonlinear weights, then each edge as the
// weighted sum of the candidates evaluated there.
//
// Bound: operations, by a little. Each cell reads one value (its four
// neighbours come from L1/L2, shared with the neighbouring threads) and
// writes two, against 277 operations (ops/weno_x.py::weno_x_work): at
// (32000, 65) in float32 25 MB, 7.5 us at 3.35 TB/s, and 0.58 Gflop,
// 8.6 us at 67 Tflop/s. The Pallas version staged row blocks through
// VMEM; here one thread computes one output cell, the periodic wrap is
// index arithmetic (no padded copy in device memory), and the limiter
// lives in registers. Row tiles in shared memory and several cells per
// thread are later work.
//
// Interface: plain C, bound with ctypes. The tables arrive as 101 host
// doubles in the order s2c[5][5], wrl[3][3][3], tv_hi[5][5], tv_lo[3][3],
// c2g[5][2], idl[4], sigma (all already rounded to the field's dtype) and
// are passed to the kernel by value. Each entry point launches on the
// given stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int ORD = 5;
constexpr int HS = 3;    // number and size of the low-order sub-stencils
constexpr int HALF = 2;  // cells on each side of the centre
constexpr int NTAB = ORD * ORD + HS * HS * HS + ORD * ORD + HS * HS + ORD * 2 +
                     (HS + 1) + 1;

template <typename T>
struct WenoTables {
  T s2c[ORD][ORD];    // [c][s]: stencil -> monomial coefficients
  T wrl[HS][HS][HS];  // [i][s][c]: sub-stencil i -> its coefficients
  T tv_hi[ORD][ORD];
  T tv_lo[HS][HS];
  T c2g[ORD][2];      // monomials at x = -1/2 (col 0) and +1/2 (col 1)
  T idl[HS + 1];
  T sigma;
};

template <typename T>
WenoTables<T> unpack(const double* p) {
  WenoTables<T> t;
  for (int c = 0; c < ORD; ++c)
    for (int s = 0; s < ORD; ++s) t.s2c[c][s] = T(*p++);
  for (int i = 0; i < HS; ++i)
    for (int s = 0; s < HS; ++s)
      for (int c = 0; c < HS; ++c) t.wrl[i][s][c] = T(*p++);
  for (int a = 0; a < ORD; ++a)
    for (int b = 0; b < ORD; ++b) t.tv_hi[a][b] = T(*p++);
  for (int a = 0; a < HS; ++a)
    for (int b = 0; b < HS; ++b) t.tv_lo[a][b] = T(*p++);
  for (int c = 0; c < ORD; ++c)
    for (int e = 0; e < 2; ++e) t.c2g[c][e] = T(*p++);
  for (int i = 0; i < HS + 1; ++i) t.idl[i] = T(*p++);
  t.sigma = T(*p++);
  return t;
}

// a^T M a over the upper triangle, skipping zero entries as the plain
// version does, so both sum the same terms in the same order.
template <typename T, int N>
__device__ __forceinline__ T quadform(const T (&a)[N], const T (&M)[N][N]) {
  T acc = T(0);
#pragma unroll
  for (int ci = 0; ci < N; ++ci) {
    if (M[ci][ci] != T(0)) acc += M[ci][ci] * a[ci] * a[ci];
#pragma unroll
    for (int d = ci + 1; d < N; ++d) {
      const T m = M[ci][d] + M[d][ci];
      if (m != T(0)) acc += m * a[ci] * a[d];
    }
  }
  return acc;
}

template <typename T>
__global__ void weno_x_kernel(const T* __restrict__ field,
                              T* __restrict__ left, T* __restrict__ right,
                              long long rows, int nx,
                              const WenoTables<T> t) {
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= rows * nx) return;
  const long long row = idx / nx;
  const int i = (int)(idx - row * nx);
  const T* f = field + row * nx;

  T u[ORD];
#pragma unroll
  for (int s = 0; s < ORD; ++s) {
    int j = i - HALF + s;
    if (j < 0) j += nx;
    else if (j >= nx) j -= nx;
    u[s] = f[j];
  }

  // candidate polynomials
  T a_lo[HS][HS];
#pragma unroll
  for (int k = 0; k < HS; ++k)
#pragma unroll
    for (int c = 0; c < HS; ++c) {
      T acc = T(0);
#pragma unroll
      for (int s = 0; s < HS; ++s) acc += t.wrl[k][s][c] * u[k + s];
      a_lo[k][c] = acc;
    }
  const T inv_idl_hi = T(1) / t.idl[HS];
  T a_br[ORD];
#pragma unroll
  for (int c = 0; c < ORD; ++c) {
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < ORD; ++s) acc += t.s2c[c][s] * u[s];
    if (c < HS) {
      T lo = T(0);
#pragma unroll
      for (int k = 0; k < HS; ++k) lo += t.idl[k] * a_lo[k][c];
      acc = acc - lo;
    }
    a_br[c] = acc * inv_idl_hi;
  }

  // smoothness indicators
  T tv[HS + 1];
#pragma unroll
  for (int k = 0; k < HS; ++k) tv[k] = quadform<T, HS>(a_lo[k], t.tv_lo);
  const T lo_avg = (tv[0] + tv[1] + tv[2]) * (T(1) / T(HS));
  tv[HS] = lo_avg + (quadform<T, ORD>(a_br, t.tv_hi) - lo_avg) * t.sigma;

  // nonlinear weights: idl/(tv^2+eps) -> convexify -> map -> convexify
  const T eps = T(1.0e-20);
  T w[HS + 1];
  T wsum = T(0);
#pragma unroll
  for (int k = 0; k < HS + 1; ++k) {
    w[k] = t.idl[k] / (tv[k] * tv[k] + eps);
    wsum += w[k];
  }
  wsum += eps;
  T wsum2 = T(0);
#pragma unroll
  for (int k = 0; k < HS + 1; ++k) {
    const T d = t.idl[k];
    const T wk = w[k] / wsum;
    w[k] = wk * (d + d * d - T(3) * d * wk + wk * wk) /
           (d * d + wk * (T(1) - T(2) * d));
    wsum2 += w[k];
  }
  wsum2 += eps;

  // both edges: weighted sum of the candidates evaluated at the edge
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    T out = T(0);
#pragma unroll
    for (int k = 0; k < HS; ++k) {
      T ek = T(0);
#pragma unroll
      for (int c = 0; c < HS; ++c) ek += t.c2g[c][e] * a_lo[k][c];
      out += (w[k] / wsum2) * ek;
    }
    T ebr = T(0);
#pragma unroll
    for (int c = 0; c < ORD; ++c) ebr += t.c2g[c][e] * a_br[c];
    out += (w[HS] / wsum2) * ebr;
    (e == 0 ? left : right)[idx] = out;
  }
}

template <typename T>
int launch(const T* field, T* left, T* right, long long rows, int nx,
           const double* tables, void* stream) {
  const long long n = rows * nx;
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  weno_x_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      field, left, right, rows, nx, unpack<T>(tables));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pam_weno_x_ntables() { return NTAB; }

extern "C" int pam_weno_x_f32(const float* field, float* left, float* right,
                              long long rows, int nx, const double* tables,
                              void* stream) {
  return launch<float>(field, left, right, rows, nx, tables, stream);
}

extern "C" int pam_weno_x_f64(const double* field, double* left,
                              double* right, long long rows, int nx,
                              const double* tables, void* stream) {
  return launch<double>(field, left, right, rows, nx, tables, stream);
}
