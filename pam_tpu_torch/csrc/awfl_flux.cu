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
// momentum. The limiter is csrc/weno5.cuh, shared with csrc/weno_x.cu; it
// agrees with ops/awfl_flux.py::flux_direction_reference to rounding, not
// bit for bit (see the header).
//
// Bound: operations, that is, instructions issued. A face reads about 1.1
// values per field and writes one per output, against (8 + ntr) limiter
// evaluations as the plain version counts them; at 65x1x50, nens 128,
// three tracers that is 30 MB (9 us at 3.35 TB/s) and 1.16 Gflop (17 us at
// 67 Tflop/s in f32, 35 us at half that rate in f64). Tensor cores, TMA
// and wgmma do not apply: the limiter is nonlinear and pointwise, and a
// block's tile is a few KB that plain loads through L1 serve.
//
// Design.
//  * Each cell's acoustic limiter once. The limiters of rho*u_n and p do
//    not depend on the edge, and a cell is the left cell of one face and
//    the right cell of the one before. A thread owns one cell: it
//    evaluates both limiters there, keeps the right-edge values (its own
//    face's left state) and hands the left-edge values to the thread of
//    the face before through shared memory. That is 2 acoustic
//    evaluations per face where the plain version does 4, so 6 + ntr in
//    all, plus the one extra cell that ends each tile.
//  * Tiles keep a stencil's neighbours in one block, so that the five of
//    six values two neighbouring faces share come from the block's L1
//    lines and are fetched from L2 once. Along x (the contiguous axis) a
//    block is 256 consecutive cells of the flattened (row, cell) index,
//    and the next block starts on this one's last cell. Along z and y a
//    block is 32 contiguous x (one warp) times tf + 1 cells of the
//    stencil axis (tf faces, at most 8; ops/awfl_flux.py::tile_faces
//    chooses tf, 4 where the axis is long: the fastest measured); x
//    is fastest in the thread index for every direction, so all loads and
//    stores of a warp are contiguous, the inputs are read in place as
//    strided views (no transposed, padded or sliced copy) and the outputs
//    are written in the dycore's layout.
//  * On a stretched vertical grid an evaluation fetches the 52 matrix
//    values of its level with thirteen 16-byte loads that the whole warp
//    shares (a warp is one level), through L1: one set for all members is
//    11 KB, and with a member stride a block touches the few levels of
//    one or two members. The upwind select of the matrices is a pointer
//    select. Staging a tile's levels in shared memory first was measured
//    and was slower (62 against 43 us in f32): it took more registers,
//    and spilled under the cap that keeps three blocks on an SM.
//  * Indices are 32-bit and divided by multiplication (weno5::FastDiv).
//    The tracer count is a run-time argument; the advected fields are one
//    rolled loop, so ten tracers cost no more registers than three.
//
// Interface: plain C, bound with ctypes (ops/awfl_flux.py). `args` is
// N_ARGS host int64 values (pointers, sizes, strides in elements; see
// FluxArgs), `tables` the weno5::NTAB host doubles of ops/weno5.py::
// prepare_tables. Each entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "weno5.cuh"

namespace {

using weno5::FastDiv;
using weno5::NMAT;
using weno5::ORD;
using weno5::Tables;

constexpr int N_ARGS = 28;
constexpr int NPRIM = 5;     // rho, u, v, w, theta
constexpr int TC = 32;       // a tile's columns across the stencil axis
constexpr int MAX_TF = 8;    // most faces of a tile along the stencil axis
constexpr int MAX_BT = TC * (MAX_TF + 1);
constexpr int BT_ALONG = 256;  // threads of a block along x

// blocks of a kernel that an SM should hold: the cap on registers that
// the measurements favoured (float 72-80 with 27 warps resident, double
// 96-128 with 16-18; without a cap double takes 144-152 and one block)
template <typename T>
constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 3 : 2;

struct FluxArgs {
  const void* prim;   // (5, nens, ny, nz, nx) view, padded along the axis
  const void* trac;   // (ntr, ...) view
  const void* pres;   // (...) view
  void* sflux;        // (5, nens, ony, onz, onx) contiguous
  void* tflux;        // (ntr, ...) contiguous
  const void* mats;   // (members, nlev, NMAT) per-level matrices or null
  long long mstride;  // elements between two members' matrices; 0: one set
  long long ntr;
  long long nens, ony, onz, onx;  // output extents (faces along the axis)
  long long dir;                  // 0 x, 1 y, 2 z: also the normal momentum
  long long ps[5];                // prim strides: field, ens, y, z, x
  long long ts[5];                // trac strides
  long long qs[4];                // pres strides: ens, y, z, x
  long long tf;                   // faces of a tile along y or z
};

// LEVELS: the stencil matrices are those of a level of a stretched grid
// (at `level`), not the uniform grid's
template <typename T, bool LEVELS>
__device__ __forceinline__ void limiter(const T (&u)[ORD], const T* level,
                                        const Tables<T>& t, T (&a)[ORD]) {
  if constexpr (LEVELS)
    weno5::cell_limiter(u, weno5::LevelMats<T>(level), t, a);
  else
    weno5::cell_limiter(u, weno5::UniformMats<T>{t}, t, a);
}

// One thread per cell m of the stencil axis (cells 0 .. nf of a row or
// column of nf faces): the cell's acoustic limiters, then face m.
template <typename T, bool LEVELS, bool ALONG>
__global__ void __launch_bounds__(ALONG ? BT_ALONG : MAX_BT, MIN_BLOCKS<T>)
awfl_flux_kernel(const FluxArgs a, const FastDiv d0, const FastDiv d1,
                 const FastDiv d2, const Tables<T> t, const T cs,
                 const T inv_cs) {
  // left-edge values of each thread's cell: the right state of the face
  // before
  __shared__ T s_ru[MAX_BT];
  __shared__ T s_pp[MAX_BT];

  const int dir = (int)a.dir;
  const unsigned tid = threadIdx.x;
  const unsigned nf =
      (unsigned)(dir == 0 ? a.onx : dir == 1 ? a.ony : a.onz);
  const unsigned tf = (unsigned)a.tf;
  constexpr unsigned NEXT = ALONG ? 1 : TC;   // the thread of cell m + 1
  unsigned e, j, k, i, m;
  bool cell_ok, face_ok;
  if constexpr (ALONG) {
    const unsigned ncells = (unsigned)(a.nens * a.ony * a.onz) * (nf + 1);
    const unsigned c = blockIdx.x * (BT_ALONG - 1) + tid;
    unsigned row, ej;
    d0.divmod(c, row, m);
    d1.divmod(row, ej, k);
    d2.divmod(ej, e, j);
    i = m;
    cell_ok = c < ncells;
    face_ok = cell_ok && m < nf && tid < BT_ALONG - 1;
  } else {
    const unsigned ncols =
        (unsigned)(a.nens * (dir == 2 ? a.ony : a.onz) * a.onx);
    const unsigned col = blockIdx.x * TC + (tid & (TC - 1));
    const unsigned warp = tid / TC;
    m = blockIdx.y * tf + warp;
    unsigned eo, o;
    d0.divmod(col, eo, i);
    d1.divmod(eo, e, o);
    j = dir == 2 ? o : m;
    k = dir == 2 ? m : o;
    cell_ok = col < ncols && m <= nf;
    face_ok = col < ncols && m < nf && warp < tf;
  }

  // the cell's stencil starts at padded cell m of the axis
  const T* prim = (const T*)a.prim + e * a.ps[1] + j * a.ps[2] +
                  k * a.ps[3] + i * a.ps[4];
  const T* pres = (const T*)a.pres + e * a.qs[0] + j * a.qs[1] +
                  k * a.qs[2] + i * a.qs[3];
  const long long pst = dir == 0 ? a.ps[4] : dir == 1 ? a.ps[2] : a.ps[3];
  const long long qst = dir == 0 ? a.qs[3] : dir == 1 ? a.qs[1] : a.qs[2];

  // the matrices of level m serve cell m
  const T* level = nullptr;
  if constexpr (LEVELS)
    level = (const T*)a.mats + e * a.mstride + (size_t)m * NMAT;

  // acoustic quantities rho*u_n and p: this cell's limiter, both edges
  T ru_l = T(0), pp_l = T(0);
  if (cell_ok) {
    const T* rho = prim;
    const T* mom = prim + (1 + dir) * a.ps[0];
    T u[ORD], c5[ORD], left;
#pragma unroll
    for (int s = 0; s < ORD; ++s) u[s] = rho[s * pst] * mom[s * pst];
    limiter<T, LEVELS>(u, level, t, c5);
    weno5::edges(c5, t, left, ru_l);
    s_ru[tid] = left;
#pragma unroll
    for (int s = 0; s < ORD; ++s) u[s] = pres[s * qst];
    limiter<T, LEVELS>(u, level, t, c5);
    weno5::edges(c5, t, left, pp_l);
    s_pp[tid] = left;
  }
  __syncthreads();
  if (!face_ok) return;

  // face m: left state from this cell, right state from cell m + 1
  T ru_r = s_ru[tid + NEXT];
  const T pp_r = s_pp[tid + NEXT];
  // rigid ground and lid: no acoustic mass flux through the first and
  // last z face (Dycore.h:477-496)
  const bool wall = dir == 2 && (m == 0 || m == nf - 1);
  if (wall) {
    ru_l = T(0);
    ru_r = T(0);
  }
  const T w1 = T(0.5) * (pp_r - cs * ru_r);
  const T w2 = T(0.5) * (pp_l + cs * ru_l);
  const T pp = w1 + w2;
  T ru = (w2 - w1) * inv_cs;
  if (wall) ru = T(0);
  const bool upw = ru > T(0);   // strict, as the reference

  const size_t n = (size_t)(a.nens * a.ony * a.onz * a.onx);
  const size_t oidx = (((size_t)e * a.ony + j) * a.onz + k) * a.onx + i;
  T* sflux = (T*)a.sflux + oidx;
  sflux[0] = ru;

  // advected quantities u, v, w, theta and the tracers: the upwind cell's
  // stencil (and matrices), evaluated at the edge that faces the flow
  const T* level_u = upw ? level : level + NMAT;
  auto advect = [&](const T* src, long long st, T* dst, bool normal) {
    T u[ORD], c5[ORD];
#pragma unroll
    for (int s = 0; s < ORD; ++s) u[s] = src[s * st];
    limiter<T, LEVELS>(u, level_u, t, c5);
    T flux = ru * weno5::edge(c5, t, upw);
    if (normal) flux = flux + pp;
    *dst = flux;
  };
  const T* src = prim + a.ps[0] + (upw ? 0 : pst);
  T* dst = sflux + n;
#pragma unroll 1
  for (int q = 0; q < NPRIM - 1; ++q, src += a.ps[0], dst += n)
    advect(src, pst, dst, q == dir);
  const long long tst = dir == 0 ? a.ts[4] : dir == 1 ? a.ts[2] : a.ts[3];
  src = (const T*)a.trac + e * a.ts[1] + j * a.ts[2] + k * a.ts[3] +
        i * a.ts[4] + (upw ? 0 : tst);
  dst = (T*)a.tflux + oidx;
#pragma unroll 1
  for (int q = 0; q < (int)a.ntr; ++q, src += a.ts[0], dst += n)
    advect(src, tst, dst, false);
}

template <typename T, bool LEVELS, bool ALONG>
void run(const FluxArgs& a, const Tables<T>& t, double cs, dim3 grid,
         unsigned threads, const FastDiv (&d)[3], cudaStream_t s) {
  // a tensor over a Python scalar runs on the card as a product with the
  // reciprocal taken in the tensor's type; ru = (w2 - w1) / cs follows it
  awfl_flux_kernel<T, LEVELS, ALONG><<<grid, threads, 0, s>>>(
      a, d[0], d[1], d[2], t, T(cs), T(1) / T(cs));
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
  a.tf = v[27];
  const long long faces = a.nens * a.ony * a.onz * a.onx;
  if (faces == 0) return 0;
  const long long nf = a.dir == 0 ? a.onx : a.dir == 1 ? a.ony : a.onz;
  const long long cells = faces / nf * (nf + 1);
  if (cells >= (1ll << 31) || a.tf < 1 || a.tf > MAX_TF)
    return (int)cudaErrorInvalidValue;
  const Tables<T> t = weno5::unpack<T>(tables);
  cudaStream_t s = (cudaStream_t)stream;
  if (a.dir == 0) {
    if (a.mats != nullptr) return (int)cudaErrorInvalidValue;
    const FastDiv d[3] = {weno5::fast_div((unsigned)(nf + 1)),
                          weno5::fast_div((unsigned)a.onz),
                          weno5::fast_div((unsigned)a.ony)};
    const unsigned blocks =
        (unsigned)((cells - 1 + BT_ALONG - 2) / (BT_ALONG - 1));
    run<T, false, true>(a, t, cs, dim3(blocks), BT_ALONG, d, s);
  } else {
    const long long other = a.dir == 2 ? a.ony : a.onz;
    const FastDiv d[3] = {weno5::fast_div((unsigned)a.onx),
                          weno5::fast_div((unsigned)other),
                          weno5::fast_div(1u)};
    const long long tiles = (nf + a.tf - 1) / a.tf;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((faces / nf + TC - 1) / TC), (unsigned)tiles);
    const unsigned threads = TC * ((unsigned)a.tf + 1);
    if (a.mats == nullptr)
      run<T, false, false>(a, t, cs, grid, threads, d, s);
    else
      run<T, true, false>(a, t, cs, grid, threads, d, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// argument-array length, table length and per-level stride, for the
// loader's layout check (pam_tpu_torch/_cuda.py)
extern "C" int pam_awfl_flux_layout() {
  return N_ARGS * 1000000 + weno5::NTAB * 1000 + NMAT;
}

// the most faces a tile may hold along y or z (ops/awfl_flux.py)
extern "C" int pam_awfl_flux_max_tile() { return MAX_TF; }

extern "C" int pam_awfl_flux_f32(const long long* args, const double* tables,
                                 double cs, void* stream) {
  return launch<float>(args, tables, cs, stream);
}

extern "C" int pam_awfl_flux_f64(const long long* args, const double* tables,
                                 double cs, void* stream) {
  return launch<double>(args, tables, cs, stream);
}
