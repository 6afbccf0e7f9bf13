// Vertical order-5 WENO edge reconstruction of the SPAM slab, for Hopper
// (sm_90a).
//
// A kernel of the port with no TPU original: pam_tpu leaves
// spam/tendencies.py::_edge_recon_z to XLA, which fuses the unrolled
// arithmetic of ops/weno.py::weno_edges_list into one pass. Eager PyTorch
// and its CUDA graph run that arithmetic as ~550 elementwise kernels a
// call pair (densities and PV), each reading and writing whole fields.
// This kernel computes the same function in one launch: for every cell
// k = 0 .. nlev-1 of every column of a z-padded field (rows, nlev+4, nx),
// the WENO-limited values at its bottom (-1/2) and top (+1/2) edge from
// the five cells k .. k+4 of the padded column, with either the uniform
// grid's stencil matrices or a stretched grid's per-level matrices (one
// set per member and level, or one set for all members). The limiter is
// csrc/weno5.cuh, shared with csrc/weno_x.cu and csrc/awfl_flux.cu; it
// agrees with weno_edges_list to rounding (see the header).
//
// Bound: operations, by a little, as B1. A cell reads one value (and its
// four neighbours in z from L1) and writes two, against 277 operations
// as the plain version counts them (ops/weno_z.py::weno_z_work): the
// production density call, (1536, 54, 65) in float32, is 61.5 MB, 18.4
// us at 3.35 TB/s, and 1.38 Gflop, 20.6 us at 67 Tflop/s.
//
// Design. One thread a cell, the cells in their order in memory: a warp's
// stencil loads are five contiguous runs along x (the rows k .. k+4 of
// its columns), its two stores contiguous, and the neighbours in z that
// a thread reads are the cells its neighbours in the block read too, so
// DRAM sees each value about once. The per-level matrices of a cell are
// NMAT values at a 16-byte aligned address (weno5::LevelMats); the
// threads of a warp lie on one or two levels of one member, so the loads
// are broadcasts. Nothing is staged in shared memory: a block of 256
// cells spans about four levels, and the L1 serves the overlap of its
// stencils. No thread walks a column: the slab's calls have 0.3-5
// million cells, hundreds to thousands of blocks for 132 SMs.
//
// Interface: plain C, bound with ctypes. The uniform tables arrive as the
// weno5::NTAB host doubles of ops/weno5.py::prepare_tables and are passed
// to the kernel by value. Each entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "weno5.cuh"

namespace {

using weno5::FastDiv;
using weno5::NMAT;
using weno5::ORD;
using weno5::Tables;

constexpr int THREADS = 256;

// cells = rows * nlev * nx; row r of the input starts at field + r *
// row_stride, padded level z of a row at + z * nx. LEVELS: the stencil
// matrices of cell k of row r are at mats + (r mod members) * mstride +
// k * NMAT (mstride 0: one set for every member).
template <typename T, bool LEVELS>
__global__ void __launch_bounds__(THREADS)
weno_z_edges_kernel(const T* __restrict__ field, T* __restrict__ bottom,
                    T* __restrict__ top, unsigned cells, long long row_stride,
                    int nx, const FastDiv by_nx, const FastDiv by_nlev,
                    const FastDiv by_members, const T* __restrict__ mats,
                    long long mstride, const Tables<T> t) {
  const unsigned item = blockIdx.x * THREADS + threadIdx.x;
  if (item >= cells) return;
  unsigned q, x, r, k;
  by_nx.divmod(item, q, x);
  by_nlev.divmod(q, r, k);
  const T* c = field + (long long)r * row_stride + (long long)k * nx + x;
  const T u[ORD] = {c[0], c[nx], c[2 * nx], c[3 * nx], c[4 * nx]};
  T a[ORD], lo, hi;
  if constexpr (LEVELS) {
    unsigned m, e;
    by_members.divmod(r, m, e);
    const T* level = mats + (long long)e * mstride + (size_t)k * NMAT;
    weno5::cell_limiter(u, weno5::LevelMats<T>(level), t, a);
  } else {
    weno5::cell_limiter(u, weno5::UniformMats<T>{t}, t, a);
  }
  weno5::edges(a, t, lo, hi);
  bottom[item] = lo;
  top[item] = hi;
}

template <typename T>
int launch(const T* field, T* bottom, T* top, long long rows,
           long long row_stride, int nlev, int nx, const T* mats,
           long long members, const double* tables, void* stream) {
  if (rows == 0 || nlev == 0 || nx == 0) return 0;
  const long long cells = rows * nlev * nx;
  if (rows < 0 || nlev < 0 || nx < 0 || cells >= (1ll << 31) ||
      row_stride < (long long)(nlev + ORD - 1) * nx ||
      (mats && (members < 1 || rows % members)))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((cells + THREADS - 1) / THREADS);
  const Tables<T> t = weno5::unpack<T>(tables);
  const FastDiv by_nx = weno5::fast_div((unsigned)nx);
  const FastDiv by_nlev = weno5::fast_div((unsigned)nlev);
  cudaStream_t s = (cudaStream_t)stream;
  if (mats) {
    const long long mstride = members > 1 ? (long long)nlev * NMAT : 0;
    weno_z_edges_kernel<T, true><<<blocks, THREADS, 0, s>>>(
        field, bottom, top, (unsigned)cells, row_stride, nx, by_nx, by_nlev,
        weno5::fast_div((unsigned)members), mats, mstride, t);
  } else {
    weno_z_edges_kernel<T, false><<<blocks, THREADS, 0, s>>>(
        field, bottom, top, (unsigned)cells, row_stride, nx, by_nx, by_nlev,
        weno5::fast_div(1u), nullptr, 0, t);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// table length and per-level stride, for the loader's layout check
// (pam_tpu_torch/_cuda.py)
extern "C" int pam_weno_z_layout() { return weno5::NTAB * 1000 + NMAT; }

// mats: null (the uniform grid) or (members, nlev, NMAT) matrices, the
// rows' member being the row's index modulo members
extern "C" int pam_weno_z_f32(const float* field, float* bottom, float* top,
                              long long rows, long long row_stride, int nlev,
                              int nx, const float* mats, long long members,
                              const double* tables, void* stream) {
  return launch<float>(field, bottom, top, rows, row_stride, nlev, nx, mats,
                       members, tables, stream);
}

extern "C" int pam_weno_z_f64(const double* field, double* bottom,
                              double* top, long long rows,
                              long long row_stride, int nlev, int nx,
                              const double* mats, long long members,
                              const double* tables, void* stream) {
  return launch<double>(field, bottom, top, rows, row_stride, nlev, nx, mats,
                        members, tables, stream);
}
