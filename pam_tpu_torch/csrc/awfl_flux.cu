// The AWFL directional flux for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pam_tpu/ops/awfl_pallas.py
// (flux_direction_fused, body _direction_kernel), which is direction(axis)
// of pam_tpu/dycore/awfl.py (ref dynamics/awfl/Dycore.h:334-519). For one
// direction, at every face: the order-5 WENO values of rho*u_n and of the
// pressure from the left and the right cell, the acoustic characteristic
// split at the frozen sound speed cs, the rigid ground/lid mask in z, then
// for u, v, w, theta and every tracer one upwind-selected WENO value times
// the mass flux, with the pressure added to the flux of the normal
// momentum. The limiter is that of ops/weno.py::weno_coefs_list followed
// by _eval_edge_list (the coefficient form), operation for operation, so
// that the kernel and ops/awfl_flux.py::flux_direction_reference round
// alike (the library is built without multiply-add contraction).
//
// Bound: operations. A face reads about 1.1 values per field and writes
// one per output, against (8 + ntr) limiter evaluations of 247
// operations each; at 65x1x50, nens 128, three tracers that is 30 MB
// (9 us at 3.35 TB/s) and 1.16 Gflop (17 us at 67 Tflop/s in f32, 35 us
// at half that rate in f64).
//
// Design. The TPU kernel wants the stencil axis in lanes, so its z and y
// directions transpose every input and output. Here one thread computes
// one face, with x fastest in the thread index for every direction, and
// walks its stencil with the stride of the direction's axis (1, nx or
// nz*nx elements of the padded arrays): all loads and stores of a warp
// are contiguous along x, the inputs are read in place as strided views
// (no transposed or sliced copy), and the outputs are written in the
// dycore's layout. The six stencil values of a field sit in registers
// and serve the left and the right stencil. On a stretched vertical grid
// the per-level matrices (52 values per level; one set for every member,
// or one set per member behind a member stride) are read through the
// read-only cache, and the upwind select of the matrices is a pointer
// select per thread. The tracer count is a run-time
// argument; the advected fields are one rolled loop.
//
// Interface: plain C, bound with ctypes (ops/awfl_flux.py). `args` is
// N_ARGS host int64 values (pointers, sizes, strides in elements; see
// FluxArgs), `tables` the 101 host doubles of ops/weno_x.py::
// _packed_tables. Each entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int ORD = 5;
constexpr int HS = 3;    // number and size of the low-order sub-stencils
constexpr int NTAB = ORD * ORD + HS * HS * HS + ORD * ORD + HS * HS + ORD * 2 +
                     (HS + 1) + 1;
constexpr int LEVEL_STRIDE = ORD * ORD + HS * HS * HS;  // per-level matrices
constexpr int N_ARGS = 27;
constexpr int NPRIM = 5;  // rho, u, v, w, theta

template <typename T>
struct Consts {
  T s2c[ORD][ORD];    // [c][s]: stencil -> monomial coefficients
  T wrl[HS][HS][HS];  // [i][s][c]: sub-stencil i -> its coefficients
  T tv_hi[ORD][ORD];
  T tv_lo[HS][HS];
  T g_left[ORD];      // monomials at x = -1/2
  T g_right[ORD];     // monomials at x = +1/2
  T idl[HS + 1];
  T sigma;
  // scalars the plain version forms in double before they meet a tensor
  T inv_idl_hi;       // 1 / idl[HS]
  T map_a[HS + 1];    // idl + idl^2
  T map_b[HS + 1];    // 3 idl
  T map_c[HS + 1];    // idl^2
  T map_d[HS + 1];    // 1 - 2 idl
  T third;            // 1 / HS
  T cs, inv_cs;
};

template <typename T>
Consts<T> unpack(const double* p, double cs) {
  Consts<T> t;
  for (int c = 0; c < ORD; ++c)
    for (int s = 0; s < ORD; ++s) t.s2c[c][s] = T(*p++);
  for (int i = 0; i < HS; ++i)
    for (int s = 0; s < HS; ++s)
      for (int c = 0; c < HS; ++c) t.wrl[i][s][c] = T(*p++);
  for (int a = 0; a < ORD; ++a)
    for (int b = 0; b < ORD; ++b) t.tv_hi[a][b] = T(*p++);
  for (int a = 0; a < HS; ++a)
    for (int b = 0; b < HS; ++b) t.tv_lo[a][b] = T(*p++);
  for (int c = 0; c < ORD; ++c) {
    t.g_left[c] = T(*p++);
    t.g_right[c] = T(*p++);
  }
  for (int i = 0; i < HS + 1; ++i) {
    const double d = *p++;
    t.idl[i] = T(d);
    t.map_a[i] = T(d + d * d);
    t.map_b[i] = T(3.0 * d);
    t.map_c[i] = T(d * d);
    t.map_d[i] = T(1.0 - 2.0 * d);
    if (i == HS) t.inv_idl_hi = T(1.0 / d);
  }
  t.sigma = T(*p++);
  t.third = T(1.0 / HS);
  t.cs = T(cs);
  // a tensor over a Python scalar runs on the card as a product with the
  // reciprocal taken in the tensor's type; ru = (w2 - w1) / cs follows it
  t.inv_cs = T(1) / T(cs);
  return t;
}

struct FluxArgs {
  const void* prim;   // (5, nens, ny, nz, nx) view, padded along the axis
  const void* trac;   // (ntr, ...) view
  const void* pres;   // (...) view
  void* sflux;        // (5, nens, ony, onz, onx) contiguous
  void* tflux;        // (ntr, ...) contiguous
  const void* mats;   // (members, nlev, LEVEL_STRIDE) per-level matrices or
                      // null
  long long mstride;  // elements between two members' matrices; 0: one set
  long long ntr;
  long long nens, ony, onz, onx;  // output extents (faces along the axis)
  long long dir;                  // 0 x, 1 y, 2 z: also the normal momentum
  long long ps[5];                // prim strides: field, ens, y, z, x
  long long ts[5];                // trac strides
  long long qs[4];                // pres strides: ens, y, z, x
};

// the uniform-grid matrices (kernel parameters) and the matrices of one
// level (device memory), behind one pair of accessors
template <typename T>
struct UniformMats {
  const Consts<T>& t;
  __device__ __forceinline__ T s2c(int c, int s) const { return t.s2c[c][s]; }
  __device__ __forceinline__ T wrl(int i, int s, int c) const {
    return t.wrl[i][s][c];
  }
};

template <typename T>
struct LevelMats {
  const T* p;
  __device__ __forceinline__ T s2c(int c, int s) const {
    return __ldg(p + c * ORD + s);
  }
  __device__ __forceinline__ T wrl(int i, int s, int c) const {
    return __ldg(p + ORD * ORD + (i * HS + s) * HS + c);
  }
};

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

// The limited value at one edge of the centre cell of the stencil u[0..4]:
// weno_coefs_list, then _eval_edge_list at x = +1/2 (right) or -1/2.
template <typename T, typename M>
__device__ __forceinline__ T weno_edge(const T* u, const M m,
                                       const Consts<T>& t, bool right) {
  // candidate polynomials
  T a_lo[HS][HS];
#pragma unroll
  for (int i = 0; i < HS; ++i)
#pragma unroll
    for (int c = 0; c < HS; ++c) {
      T acc = m.wrl(i, 0, c) * u[i];
#pragma unroll
      for (int s = 1; s < HS; ++s) acc += m.wrl(i, s, c) * u[i + s];
      a_lo[i][c] = acc;
    }
  T a_br[ORD];
#pragma unroll
  for (int c = 0; c < ORD; ++c) {
    T acc = m.s2c(c, 0) * u[0];
#pragma unroll
    for (int s = 1; s < ORD; ++s) acc += m.s2c(c, s) * u[s];
    if (c < HS) {
      T lo = t.idl[0] * a_lo[0][c];
#pragma unroll
      for (int i = 1; i < HS; ++i) lo += t.idl[i] * a_lo[i][c];
      acc = acc - lo;
    }
    a_br[c] = acc * t.inv_idl_hi;
  }

  // smoothness indicators
  T tv[HS + 1];
#pragma unroll
  for (int i = 0; i < HS; ++i) tv[i] = quadform<T, HS>(a_lo[i], t.tv_lo);
  T lo_avg = tv[0];
#pragma unroll
  for (int i = 1; i < HS; ++i) lo_avg += tv[i];
  lo_avg = lo_avg * t.third;
  tv[HS] = lo_avg + (quadform<T, ORD>(a_br, t.tv_hi) - lo_avg) * t.sigma;

  // nonlinear weights: idl/(tv^2+eps) -> convexify -> map -> convexify
  // (a Python scalar over a tensor is the tensor's reciprocal times the
  // scalar)
  const T eps = T(1.0e-20);
  T w[HS + 1];
#pragma unroll
  for (int i = 0; i < HS + 1; ++i)
    w[i] = (T(1) / (tv[i] * tv[i] + eps)) * t.idl[i];
  T wsum = w[0];
#pragma unroll
  for (int i = 1; i < HS + 1; ++i) wsum += w[i];
  wsum += eps;
#pragma unroll
  for (int i = 0; i < HS + 1; ++i) {
    const T wi = w[i] / wsum;
    w[i] = wi * (t.map_a[i] - t.map_b[i] * wi + wi * wi) /
           (t.map_c[i] + wi * t.map_d[i]);
  }
  wsum = w[0];
#pragma unroll
  for (int i = 1; i < HS + 1; ++i) wsum += w[i];
  wsum += eps;
#pragma unroll
  for (int i = 0; i < HS + 1; ++i) w[i] = w[i] / wsum;

  // weighted coefficients, evaluated at the edge
  T val = T(0);
#pragma unroll
  for (int c = 0; c < ORD; ++c) {
    T acc = w[HS] * a_br[c];
    if (c < HS) {
      T lo = w[0] * a_lo[0][c];
#pragma unroll
      for (int i = 1; i < HS; ++i) lo += w[i] * a_lo[i][c];
      acc = acc + lo;
    }
    const T term = (right ? t.g_right[c] : t.g_left[c]) * acc;
    val = c == 0 ? term : val + term;
  }
  return val;
}

template <typename T, bool PER_LEVEL>
__device__ __forceinline__ T edge(const T* u, const T* level,
                                  const Consts<T>& t, bool right) {
  if constexpr (PER_LEVEL)
    return weno_edge<T>(u, LevelMats<T>{level}, t, right);
  else
    return weno_edge<T>(u, UniformMats<T>{t}, t, right);
}

template <typename T, bool PER_LEVEL>
__global__ void __launch_bounds__(128)
awfl_flux_kernel(const FluxArgs a, const Consts<T> t) {
  const long long n = a.nens * a.ony * a.onz * a.onx;
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= n) return;
  // x fastest, whatever the direction
  long long r = idx;
  const long long i = r % a.onx;
  r /= a.onx;
  const long long k = r % a.onz;
  r /= a.onz;
  const long long j = r % a.ony;
  const long long e = r / a.ony;

  const int dir = (int)a.dir;
  const long long face = dir == 0 ? i : dir == 1 ? j : k;
  const long long nfaces = dir == 0 ? a.onx : dir == 1 ? a.ony : a.onz;

  const T* prim = (const T*)a.prim + e * a.ps[1] + j * a.ps[2] +
                  k * a.ps[3] + i * a.ps[4];
  const T* trac = (const T*)a.trac + e * a.ts[1] + j * a.ts[2] +
                  k * a.ts[3] + i * a.ts[4];
  const T* pres = (const T*)a.pres + e * a.qs[0] + j * a.qs[1] +
                  k * a.qs[2] + i * a.qs[3];
  // the stencil's stride: that of the direction's axis
  const long long pst = dir == 0 ? a.ps[4] : dir == 1 ? a.ps[2] : a.ps[3];
  const long long tst = dir == 0 ? a.ts[4] : dir == 1 ? a.ts[2] : a.ts[3];
  const long long qst = dir == 0 ? a.qs[3] : dir == 1 ? a.qs[1] : a.qs[2];

  // matrix `face` serves the left candidate, `face + 1` the right one
  const T* mat_l = nullptr;
  const T* mat_r = nullptr;
  if (PER_LEVEL) {
    mat_l = (const T*)a.mats + e * a.mstride + face * LEVEL_STRIDE;
    mat_r = mat_l + LEVEL_STRIDE;
  }

  // acoustic quantities from both sides: rho*u_n and the pressure
  T ruf[ORD + 1], pf[ORD + 1];
  const T* rho = prim;
  const T* mom = prim + (1 + dir) * a.ps[0];
#pragma unroll
  for (int s = 0; s < ORD + 1; ++s) {
    ruf[s] = rho[s * pst] * mom[s * pst];
    pf[s] = pres[s * qst];
  }
  T ru_l = edge<T, PER_LEVEL>(ruf, mat_l, t, true);
  T ru_r = edge<T, PER_LEVEL>(ruf + 1, mat_r, t, false);
  const T pp_l = edge<T, PER_LEVEL>(pf, mat_l, t, true);
  const T pp_r = edge<T, PER_LEVEL>(pf + 1, mat_r, t, false);
  // rigid ground and lid: no acoustic mass flux through the first and
  // last z face (Dycore.h:477-496)
  const bool wall = dir == 2 && (face == 0 || face == nfaces - 1);
  if (wall) {
    ru_l = T(0);
    ru_r = T(0);
  }
  const T w1 = T(0.5) * (pp_r - t.cs * ru_r);
  const T w2 = T(0.5) * (pp_l + t.cs * ru_l);
  const T pp = w1 + w2;
  T ru = (w2 - w1) * t.inv_cs;
  if (wall) ru = T(0);
  const bool upw = ru > T(0);   // strict, as the reference

  T* sflux = (T*)a.sflux + idx;
  T* tflux = (T*)a.tflux + idx;
  sflux[0] = ru;

  // advected quantities u, v, w, theta and the tracers: the upwind cell's
  // stencil (and matrices), evaluated at the edge that faces the flow
  const T* mat_u = upw ? mat_l : mat_r;
  const long long nq = NPRIM - 1 + a.ntr;
#pragma unroll 1
  for (long long q = 0; q < nq; ++q) {
    const bool state = q < NPRIM - 1;
    const long long st = state ? pst : tst;
    const T* src = state ? prim + (1 + q) * a.ps[0]
                         : trac + (q - (NPRIM - 1)) * a.ts[0];
    if (!upw) src += st;
    T u[ORD];
#pragma unroll
    for (int s = 0; s < ORD; ++s) u[s] = src[s * st];
    T flux = ru * edge<T, PER_LEVEL>(u, mat_u, t, upw);
    if (q == dir) flux = flux + pp;
    if (state) sflux[(1 + q) * n] = flux;
    else tflux[(q - (NPRIM - 1)) * n] = flux;
  }
}

template <typename T>
int launch(const long long* v, const double* tables, double cs,
           void* stream) {
  FluxArgs a;
  a.prim = (const void*)v[0];
  a.trac = (const void*)v[1];
  a.pres = (const void*)v[2];
  a.sflux = (void*)v[3];
  a.tflux = (void*)v[4];
  a.mats = (const void*)v[5];
  a.mstride = v[6];
  a.ntr = v[7];
  a.nens = v[8];
  a.ony = v[9];
  a.onz = v[10];
  a.onx = v[11];
  a.dir = v[12];
  for (int d = 0; d < 5; ++d) a.ps[d] = v[13 + d];
  for (int d = 0; d < 5; ++d) a.ts[d] = v[18 + d];
  for (int d = 0; d < 4; ++d) a.qs[d] = v[23 + d];
  const long long n = a.nens * a.ony * a.onz * a.onx;
  if (n == 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  const Consts<T> t = unpack<T>(tables, cs);
  cudaStream_t s = (cudaStream_t)stream;
  if (a.mats != nullptr)
    awfl_flux_kernel<T, true><<<(unsigned)blocks, threads, 0, s>>>(a, t);
  else
    awfl_flux_kernel<T, false><<<(unsigned)blocks, threads, 0, s>>>(a, t);
  return (int)cudaGetLastError();
}

}  // namespace

// argument-array length, table length and per-level stride, for the
// loader's layout check (pam_tpu_torch/_cuda.py)
extern "C" int pam_awfl_flux_layout() {
  return N_ARGS * 1000000 + NTAB * 1000 + LEVEL_STRIDE;
}

extern "C" int pam_awfl_flux_f32(const long long* args, const double* tables,
                                 double cs, void* stream) {
  return launch<float>(args, tables, cs, stream);
}

extern "C" int pam_awfl_flux_f64(const long long* args, const double* tables,
                                 double cs, void* stream) {
  return launch<double>(args, tables, cs, stream);
}
