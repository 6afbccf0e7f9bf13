// Time stamps taken on the device, for the spans of utils/observe.py.
//
// A span of the tracer is a pair of one-thread kernels launched on the
// current stream: stamp_begin reads the card's nanosecond clock
// (%globaltimer) into the span's begin slot; stamp_end reads it again and
// adds the difference and 1 into the span's accumulators, and, for a span
// outside a loop body, appends (slot, begin, end) to a bounded ring. They
// are plain kernels, so a CUDA graph capture takes them as kernel nodes:
// inside a WHILE node's body too, where event-record nodes are not allowed,
// so a span there adds once a trip. Nothing reads the accumulators while a
// graph replays; the host copies them out in one go.
//
// The buffer is one int64 array (utils/observe.py::_DeviceStamps lays it
// out): begin[S], ns[S], count[S], trips[S], ring_n, ring[cap][3]. The
// kernels are launched one after another on one stream, so a plain
// read-modify-write is safe: two stamps of one stream never overlap.
//
// Not a kernel of the TPU's: pam_tpu's profiles come from XLA's own trace.
// One thread reading the clock: what it costs is its node's launch in the
// graph, not its work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void stamp_begin(long long* begin) { *begin = now(); }

__global__ void stamp_end(const long long* begin, long long* ns,
                          long long* count, long long* ring_n,
                          long long* ring, long long cap, int slot) {
  long long t = now();
  long long b = *begin;
  *ns += t - b;
  *count += 1;
  if (ring != nullptr) {
    long long i = (*ring_n)++;
    if (i < cap) {
      ring[3 * i] = slot;
      ring[3 * i + 1] = b;
      ring[3 * i + 2] = t;
    }
  }
}

__global__ void stamp_now(long long* out) { *out = now(); }

// the clock's resolution: n successive readings that differ from the one
// before them, after out[n], the first reading, in one thread; a reading
// that never came (2^26 tries without a change) is left at -1
__global__ void stamp_ticks(long long* out, int n) {
  long long last = now();
  out[n] = last;
  int i = 0;
  for (long long tries = 0; i < n && tries < (1LL << 26); ++tries) {
    long long t = now();
    if (t != last) {
      out[i++] = t;
      last = t;
    }
  }
  for (; i < n; ++i) out[i] = -1;
}

}  // namespace

extern "C" int pam_stamp_begin(void* begin, void* stream) {
  stamp_begin<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(begin));
  return cudaGetLastError();
}

// ring: null for a span inside a loop body (no ring entry)
extern "C" int pam_stamp_end(void* begin, void* ns, void* count,
                             void* ring_n, void* ring, long long cap,
                             int slot, void* stream) {
  stamp_end<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(begin), static_cast<long long*>(ns),
      static_cast<long long*>(count), static_cast<long long*>(ring_n),
      static_cast<long long*>(ring), cap, slot);
  return cudaGetLastError();
}

extern "C" int pam_stamp_now(void* out, void* stream) {
  stamp_now<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out));
  return cudaGetLastError();
}

extern "C" int pam_stamp_ticks(void* out, int n, void* stream) {
  stamp_ticks<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), n);
  return cudaGetLastError();
}
