// The AWFL dycore's FCT tracer limiter for Hopper (sm_90a).
//
// A kernel of the port with no TPU original: pam_tpu's dycore/awfl.py
// writes the limiter (ref dynamics/awfl/Dycore.h:521-550) as jnp, which
// XLA fuses. Eager PyTorch and its CUDA graph run that arithmetic
// (ops/awfl_fct.py::fct_limit_reference) as ~31 elementwise kernels a
// tendency, each streaming a whole tracer array. This kernel computes the
// same function of a 2-D run in one launch: for every positive-definite
// tracer, the multiplier of each cell (the share of its outflow that the
// mass it starts the stage with allows), then every x and z face flux
// scaled by the multiplier of the cell it leaves: a positive flux the
// cell on its minus side, a negative one the cell on its plus side, a
// zero flux by one. x wraps periodically (faces 0 and nx both see cells
// nx-1 and 0, as comm.halo_pad makes them); z pads with multiplier 1.
// A tracer that is not positive-definite keeps its fluxes.
//
// Bound: bytes. A cell reads its tracer's start value and, shared with
// its neighbours, two x and two z face fluxes, and each face flux is
// written once: at 65x1x50, nens 128, three tracers in f64 that is 30 MB
// read and 20 MB written, 15 us at 3.35 TB/s, against ~15 operations a
// cell and face.
//
// Design. One block a tile of one (tracer, member) x-z plane: whole rows,
// as many as fit ENTRIES multipliers with the row below and the column to
// the left (wrapped), or a row's segments where a row does not fit
// (ops/awfl_fct.py::fct_tiles: the cell's plane as four tiles of 13 rows,
// 1,536 blocks). Each thread holds CPT entries of its tile, unrolled, so
// that all of its loads are in flight at once. Pass 1 loads an entry's
// start value and its four face fluxes, computes its multiplier into
// shared memory, and keeps the multiplier and the fluxes of the faces on
// its plus side in registers; after one barrier, pass 2 scales those
// fluxes by the multiplier and by the one across the face, from shared
// memory, and writes them. No flux is read twice from memory beyond L1;
// the halo row and column are recomputed by the neighbouring tile, not
// exchanged. x is the fastest thread index, so every load and store of a
// warp is contiguous. On an H100 at the cell's call this took 31 us in
// f64 (49% of the bound), the fastest of 2-16 entries a thread, 128-512
// threads and 1-50 rows a tile; a first design that read the fluxes again
// in pass 2 took 34-40 us (PERF.md). The arithmetic follows the plain
// version's order, rounded as its separate launches round (built with
// -fmad=false): vol = (dx*dy)*dz, the x then the z outflow, each
// (max(right, 0) - min(left, 0)) / d as a true division, mass_out =
// (outflow*dt)*vol, mass_avail = max(start, 0)*vol, and the select with
// the mass_out == 0 guard; a NaN passes through as torch.clamp lets it.
// The plain version on the card divides by dx as a product with its
// reciprocal, so the two differ there in the last bit; on the CPU it
// divides, and the two agree bit for bit.
//
// Interface: plain C, bound with ctypes (ops/awfl_fct.py). `args` is
// N_ARGS host int64 values (pointers, sizes, strides in elements, tile;
// see FctArgs). dt is read on the device through its pointer (a 0-d
// tensor of the compiled step), or taken by value where the pointer is
// null. Each entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <initializer_list>

namespace {

constexpr int N_ARGS = 28;
constexpr int THREADS = 256;
constexpr int CPT = 4;                  // a thread's entries of a tile
constexpr int ENTRIES = THREADS * CPT;  // a tile's multipliers, at most

struct FctArgs {
  const void* fx;     // (ntr, nens, 1, nz, nx+1) x face fluxes
  const void* fz;     // (ntr, nens, 1, nz+1, nx) z face fluxes
  const void* ts;     // (ntr, nens, 1, nz, nx) tracers at the stage start
  const void* dz;     // (nens or 1, nz) cell heights
  const unsigned char* pos;   // (ntr,) positive-definite
  const void* dt;     // 0-d, or null: dt_value
  void* ox;           // limited fluxes, contiguous, shaped as fx
  void* oz;           // and as fz
  int ntr, nens, nz, nx;
  long long sfx[4], sfz[4], sts[4];   // strides over (tracer, member, z, x)
  long long sdz[2];                   // over (member, z)
  int kt, xt;                         // a tile's rows and columns
};

template <typename T>
__device__ __forceinline__ T clamp_min0(T v) { return v < T(0) ? T(0) : v; }

template <typename T>
__device__ __forceinline__ T clamp_max0(T v) { return v > T(0) ? T(0) : v; }

// a face flux scaled by the multiplier of the cell it leaves
template <typename T>
__device__ __forceinline__ T limited(T f, T m_minus, T m_plus) {
  return f * (f > T(0) ? m_minus : f < T(0) ? m_plus : T(1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
awfl_fct_kernel(const FctArgs a, int ztiles, int xtiles, T dxdy, T dx,
                T dt_value) {
  __shared__ T mult[ENTRIES];
  const int nz = a.nz, nx = a.nx;
  unsigned b = blockIdx.x;
  const int xtile = (int)(b % (unsigned)xtiles);
  b /= (unsigned)xtiles;
  const int ztile = (int)(b % (unsigned)ztiles);
  const int plane = (int)(b / (unsigned)ztiles);
  const int t = plane / a.nens, e = plane - t * a.nens;
  const int k0 = ztile * a.kt, k1 = min(k0 + a.kt, nz);
  const int x0 = xtile * a.xt, x1 = min(x0 + a.xt, nx);
  const T* __restrict__ fx = (const T*)a.fx + t * a.sfx[0] + e * a.sfx[1];
  const T* __restrict__ fz = (const T*)a.fz + t * a.sfz[0] + e * a.sfz[1];
  const T* __restrict__ ts = (const T*)a.ts + t * a.sts[0] + e * a.sts[1];
  const T* __restrict__ dz = (const T*)a.dz + e * a.sdz[0];
  T* __restrict__ ox = (T*)a.ox + (long long)plane * nz * (nx + 1);
  T* __restrict__ oz = (T*)a.oz + (long long)plane * (nz + 1) * nx;
  const bool limit = a.pos[t] != 0;
  const T dt = !limit ? T(0) : a.dt ? *(const T*)a.dt : dt_value;
  // in-plane strides, 32-bit (the launch checks that a plane's offsets fit)
  const int fxz = (int)a.sfx[2], fxx = (int)a.sfx[3];
  const int fzz = (int)a.sfz[2], fzx = (int)a.sfz[3];
  const int tsz = (int)a.sts[2], tsx = (int)a.sts[3], dzz = (int)a.sdz[1];

  // The tile's entries: rows k0-1 .. k1-1 (r = k - k0 + 1; k = -1 is the
  // vertical pad, multiplier 1) by columns x0-1 .. x1-1 (c = x - x0 + 1;
  // c = 0 wraps to nx-1 at x0 = 0), CPT of them a thread. An entry owns
  // the faces on its plus side that lie in the tile: x face x+1 in the
  // rows k0 .. k1-1 and the columns but the last (at x0 = 0 the wrapped
  // entry owns faces nx and 0), z face k+1 in the columns x0 .. x1-1, up
  // to k1-1, or nz in the top tile. Pass 1 computes each entry's
  // multiplier into shared memory and keeps it and its plus faces'
  // fluxes in registers; pass 2 scales those fluxes by it and by the
  // multiplier across the face, from shared memory.
  const int cols = x1 - x0 + 1, n = (k1 - k0 + 1) * cols;
  T m[CPT], fxp[CPT], fzp[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    m[j] = T(1);
    fxp[j] = fzp[j] = T(0);
    if (idx >= n) continue;
    const int r = idx / cols, c = idx - r * cols;
    const int k = k0 - 1 + r;
    int x = x0 - 1 + c;
    if (x < 0) x += nx;
    const T* fzc = fz + x * fzx;
    fzp[j] = fzc[(k + 1) * fzz];
    if (k < 0) continue;
    const T* fxr = fx + k * fxz;
    fxp[j] = fxr[(x + 1) * fxx];
    if (!limit) continue;
    const T dzk = dz[k * dzz];
    const T vol = dxdy * dzk;
    const T avail = clamp_min0(ts[k * tsz + x * tsx]) * vol;
    const T out_x = (clamp_min0(fxp[j]) - clamp_max0(fxr[x * fxx])) / dx;
    const T out_z = (clamp_min0(fzp[j]) - clamp_max0(fzc[k * fzz])) / dzk;
    const T mass_out = (out_x + out_z) * dt * vol;
    if (mass_out > avail)
      m[j] = avail / (mass_out == T(0) ? T(1) : mass_out);
  }
  if (limit) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      if (idx < n) mult[idx] = m[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    if (idx >= n) continue;
    const int r = idx / cols, c = idx - r * cols;
    const int k = k0 - 1 + r;
    int x = x0 - 1 + c;
    if (x < 0) x += nx;
    if (r >= 1 && c < cols - 1) {
      const T* across = mult + r * cols + c + 1;
      T* row = ox + (long long)k * (nx + 1);
      row[x + 1] = limit ? limited(fxp[j], m[j], *across) : fxp[j];
      if (c == 0 && x0 == 0) {
        const T f = fx[k * fxz];
        row[0] = limit ? limited(f, m[j], *across) : f;
      }
    }
    if (c >= 1 && (k + 1 < k1 || k + 1 == nz))
      oz[(long long)(k + 1) * nx + x] =
          !limit ? fzp[j]
                 : limited(fzp[j], m[j], k + 1 == nz ? T(1) : mult[idx + cols]);
  }
}

template <typename T>
int launch(const long long* v, double dxdy, double dx, double dt_value,
           void* stream) {
  FctArgs a;
  a.fx = (const void*)v[0];
  a.fz = (const void*)v[1];
  a.ts = (const void*)v[2];
  a.dz = (const void*)v[3];
  a.pos = (const unsigned char*)v[4];
  a.dt = (const void*)v[5];
  a.ox = (void*)v[6];
  a.oz = (void*)v[7];
  const long long ntr = v[8], nens = v[9], nz = v[10], nx = v[11];
  for (int d = 0; d < 4; ++d) {
    a.sfx[d] = v[12 + d];
    a.sfz[d] = v[16 + d];
    a.sts[d] = v[20 + d];
  }
  a.sdz[0] = v[24];
  a.sdz[1] = v[25];
  const long long kt = v[26], xt = v[27];
  if (ntr == 0 || nens == 0) return 0;
  if (ntr < 0 || nens < 0 || nz < 1 || nx < 1 || kt < 1 || xt < 1 ||
      ntr * nens * (nz + 1) * (nx + 1) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const long long ztiles = (nz + kt - 1) / kt, xtiles = (nx + xt - 1) / xt;
  const long long blocks = ntr * nens * ztiles * xtiles;
  if (blocks >= (1ll << 31) ||
      ((kt < nz ? kt : nz) + 1) * ((xt < nx ? xt : nx) + 1) > ENTRIES ||
      a.sdz[1] < 0 || nz * a.sdz[1] >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  for (const long long* st : {a.sfx, a.sfz, a.sts})
    if (st[2] < 0 || st[3] < 0 || (nz + 1) * st[2] + (nx + 1) * st[3] >=
                                      (1ll << 31))
      return (int)cudaErrorInvalidValue;
  a.ntr = (int)ntr;
  a.nens = (int)nens;
  a.nz = (int)nz;
  a.nx = (int)nx;
  a.kt = (int)kt;
  a.xt = (int)xt;
  awfl_fct_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      a, (int)ztiles, (int)xtiles, T(dxdy), T(dx), T(dt_value));
  return (int)cudaGetLastError();
}

}  // namespace

// argument-array length and the most entries a tile may hold, for the
// loader's layout check (pam_tpu_torch/_cuda.py)
extern "C" int pam_awfl_fct_layout() { return N_ARGS * 1000000 + ENTRIES; }

extern "C" int pam_awfl_fct_f32(const long long* args, double dxdy, double dx,
                                double dt_value, void* stream) {
  return launch<float>(args, dxdy, dx, dt_value, stream);
}

extern "C" int pam_awfl_fct_f64(const long long* args, double dxdy, double dx,
                                double dt_value, void* stream) {
  return launch<double>(args, dxdy, dx, dt_value, stream);
}
