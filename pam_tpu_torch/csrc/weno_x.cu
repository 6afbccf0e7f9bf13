// Periodic-x order-5 WENO edge reconstruction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels pam_tpu/ops/weno_x_pallas.py
// (edge_recon_x_pallas, body _kernel) and pam_tpu/ops/weno_pallas.py
// (edge_recon_x/_run), which compute the same function: for every cell of
// every row, the WENO-limited values at its left and right edge, from the
// five cells i-2 .. i+2 with i wrapped modulo nx (the uniform-grid branch
// of spam/tendencies.py::_edge_recon_x). The limiter is csrc/weno5.cuh,
// shared with csrc/awfl_flux.cu; it agrees with ops/weno.py::
// weno_edges_list to rounding (see the header).
//
// Bound: operations, by a little. Each cell reads one value and writes
// two, against 277 operations as the plain version counts them
// (ops/weno_x.py::weno_x_work): at (32000, 65) in float32 25 MB, 7.5 us at
// 3.35 TB/s, and 0.58 Gflop, 8.6 us at 67 Tflop/s. Tensor cores, TMA and
// wgmma do not apply: the limiter is nonlinear and pointwise, and a
// block's tile is a few KB.
//
// Design. One limiter evaluation per cell gives both edges (one set of
// weights, one reciprocal per normalisation). A block takes a run of
// whole rows (ops/weno_x.py::tiling chooses how many, up to 16: the count
// whose cells fill the block's last warp best, nx = 65 being no multiple
// of anything useful), copies them into shared memory with a two-cell
// periodic halo on each side of every row, so that the wrap is paid once
// per row at the copy and the stencil reads are plain offsets, and then
// walks the run's cells in their order in memory: loads and both stores
// of a warp are contiguous across row ends. The copy is plain 4- or
// 8-byte loads, a warp on 128 or 256 contiguous bytes: wider loads would
// save one or two of the ~215 instructions a cell takes, 150 of them the
// limiter's arithmetic. A row wider than the tile is cut into segments,
// each with its halo, one row per block.
//
// Padded mode (pam_weno_x_padded_*). Under x or y sharding a row is one
// rank's block of a periodic axis, and its two-cell halos belong to the
// neighbouring ranks: parallel/comm.py::halo_pad fetches them, and the
// kernel takes the (rows, nx+4) field so padded, as the TPU kernel
// (weno_x_pallas.py:46) takes its input. It copies each row's nx+4
// columns as they are and wraps nothing. The wrapping mode stays the
// route of an unsharded axis.
//
// Interface: plain C, bound with ctypes. The tables arrive as the
// weno5::NTAB host doubles of ops/weno5.py::prepare_tables and are passed
// to the kernel by value. Each entry point launches on the given stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "weno5.cuh"

namespace {

using weno5::FastDiv;
using weno5::ORD;
using weno5::Tables;

constexpr int HALO = 2;       // cells on each side of the centre
constexpr int TILE = 4608;    // values of a block's tile, halos included
constexpr int THREADS = 256;

// rb rows of `seg` cells from x0 = blockIdx.y * seg on; seg = nx unless a
// row is wider than the tile (then rb = 1). PADDED: each input row holds
// nx + 2*HALO values, its halos included, and nothing wraps.
template <typename T, bool PADDED>
__global__ void __launch_bounds__(THREADS)
weno_x_kernel(const T* __restrict__ field, T* __restrict__ left,
              T* __restrict__ right, long long rows, int nx, int rb, int seg,
              const FastDiv by_nx, const Tables<T> t) {
  __shared__ T tile[TILE];
  const long long row0 = (long long)blockIdx.x * rb;
  const int nrows = (int)min((long long)rb, rows - row0);
  const int x0 = blockIdx.y * seg;
  const int len = min(seg, nx - x0);
  const int pitch = len + 2 * HALO;
  const long long in_pitch = PADDED ? nx + 2 * HALO : nx;
  const T* src = field + row0 * in_pitch;

  // rows with their periodic halo, a warp per row at a time
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < nrows; r += THREADS / 32)
    for (int s = lane; s < pitch; s += 32) {
      if constexpr (PADDED) {
        // padded column x0 + s is cell x0 - HALO + s
        tile[r * pitch + s] = src[(long long)r * in_pitch + x0 + s];
      } else {
        int x = x0 - HALO + s;
        if (x < 0) x += nx;
        else if (x >= nx) x -= nx;
        tile[r * pitch + s] = src[(long long)r * nx + x];
      }
    }
  __syncthreads();

  // whole rows are one contiguous run and a segment is one row: cell
  // `item` of the block lies at out0 + item either way
  const size_t out0 = (size_t)row0 * nx + x0;
  for (unsigned item = threadIdx.x; item < (unsigned)(nrows * len);
       item += THREADS) {
    unsigned r = 0, i = item;
    if (rb > 1) by_nx.divmod(item, r, i);
    const T* c = tile + r * pitch + i;
    const T u[ORD] = {c[0], c[1], c[2], c[3], c[4]};
    T a[ORD], lo, hi;
    weno5::cell_limiter(u, weno5::UniformMats<T>{t}, t, a);
    weno5::edges(a, t, lo, hi);
    left[out0 + item] = lo;
    right[out0 + item] = hi;
  }
}

template <typename T, bool PADDED>
int launch(const T* field, T* left, T* right, long long rows, int nx, int rb,
           int seg, const double* tables, void* stream) {
  if (rows == 0 || nx == 0) return 0;
  const long long blocks = (rows + rb - 1) / rb;
  const int segments = (nx + seg - 1) / seg;
  if ((!PADDED && nx < HALO) || rb < 1 || seg < 1 ||
      (rb > 1 && seg != nx) || (long long)rb * (seg + 2 * HALO) > TILE ||
      blocks >= (1ll << 31) || segments > 65535)
    return (int)cudaErrorInvalidValue;
  weno_x_kernel<T, PADDED>
      <<<dim3((unsigned)blocks, (unsigned)segments), THREADS, 0,
         (cudaStream_t)stream>>>(
      field, left, right, rows, nx, rb, seg, weno5::fast_div((unsigned)nx),
      weno5::unpack<T>(tables));
  return (int)cudaGetLastError();
}

}  // namespace

// table length and tile size, for the loader's layout check
// (pam_tpu_torch/_cuda.py) and ops/weno_x.py::tiling
extern "C" int pam_weno_x_ntables() { return weno5::NTAB; }
extern "C" int pam_weno_x_tile() { return TILE; }

extern "C" int pam_weno_x_f32(const float* field, float* left, float* right,
                              long long rows, int nx, int rb, int seg,
                              const double* tables, void* stream) {
  return launch<float, false>(field, left, right, rows, nx, rb, seg, tables,
                             stream);
}

extern "C" int pam_weno_x_f64(const double* field, double* left,
                              double* right, long long rows, int nx, int rb,
                              int seg, const double* tables, void* stream) {
  return launch<double, false>(field, left, right, rows, nx, rb, seg, tables,
                               stream);
}

// the same over a (rows, nx+4) field whose halos are already in place
extern "C" int pam_weno_x_padded_f32(const float* field, float* left,
                                     float* right, long long rows, int nx,
                                     int rb, int seg, const double* tables,
                                     void* stream) {
  return launch<float, true>(field, left, right, rows, nx, rb, seg, tables,
                             stream);
}

extern "C" int pam_weno_x_padded_f64(const double* field, double* left,
                                     double* right, long long rows, int nx,
                                     int rb, int seg, const double* tables,
                                     void* stream) {
  return launch<double, true>(field, left, right, rows, nx, rb, seg, tables,
                              stream);
}
