// The legacy paged gathers for Hopper (sm_90a): the delta-pages product and
// the unit-page gather.
//
// Replace sparsex_tpu/ops/pallas_kernels.py:_build_delta_kernel and
// :_build_gather_kernel.  The host planners (build_delta_pages,
// build_unit_pages) cut an element stream into 1024-element tiles whose x
// columns lie in a window of q consecutive 1024-value pages starting at page
// plo[t], and store each element's offset into that window as
//   sl = sub * 128 + lane   (< q * 1024),
// int16 for the delta stream (the packing halves its metadata bytes) and
// int32 for the unit plans.  On the TPU the window's q pages are streamed
// into VMEM and each element is picked with q * 8 lane shuffles and
// selects, because a (8, 128) VREG shuffle is Mosaic's only vector gather.
// On the card the window is just an offset: one thread per element reads
//   x2flat[plo[t] * 1024 + sl]
// straight from the zero-padded page grid x2 through L1/L2 (a tile's window
// is at most q * 4 KB of f32, shared by the tile's 1024 threads), and 0
// where sl is outside [0, q * 1024), as the Pallas kernels' selects give 0.
// Both kernels are bound by the bytes of their streams (sl, vals, output),
// read and written once, coalesced.
//
//   delta_pages_kernel:  out[e] = vals[e] * x  (one multiply, no sum)
//   paged_gather_kernel: out[e] = x           (a copy: bit-exact)
//
// Interface: plain C launchers per value type (loaded with ctypes); each
// launches on the caller's stream, never synchronises, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAGE = 1024;       // x values per page = elements per tile

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T, typename S>
__device__ __forceinline__ T window_x(const int32_t* __restrict__ plo,
                                      const S* __restrict__ sl,
                                      const T* __restrict__ x2, long long e,
                                      int win) {
  const int s = (int)sl[e];
  return (s >= 0 && s < win) ? x2[(long long)plo[e / PAGE] * PAGE + s] : T(0);
}

template <typename T>
__global__ void delta_pages_kernel(const int32_t* __restrict__ plo,
                                   const int16_t* __restrict__ sl,
                                   const T* __restrict__ vals,
                                   const T* __restrict__ x2,
                                   T* __restrict__ out, long long n_elems,
                                   int win) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  out[e] = mul_rn(window_x(plo, sl, x2, e, win), vals[e]);
}

template <typename T, typename S>
__global__ void paged_gather_kernel(const int32_t* __restrict__ plo,
                                    const S* __restrict__ sl,
                                    const T* __restrict__ x2,
                                    T* __restrict__ out, long long n_elems,
                                    int win) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  out[e] = window_x(plo, sl, x2, e, win);
}

constexpr int THREADS = 256;

inline unsigned n_blocks(long long n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

template <typename T>
int launch_delta_pages(const void* plo, const void* sl, const void* vals,
                       const void* x2, void* out, long long T_tiles, int q,
                       void* stream) {
  const long long n = T_tiles * PAGE;
  if (n == 0) return (int)cudaGetLastError();
  delta_pages_kernel<T><<<n_blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int16_t*)sl, (const T*)vals, (const T*)x2,
      (T*)out, n, q * PAGE);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged_gather(const void* plo, const void* sl, const void* x2,
                        void* out, long long T_tiles, int q, int sl_bytes,
                        void* stream) {
  const long long n = T_tiles * PAGE;
  if (n == 0) return (int)cudaGetLastError();
  if (sl_bytes == 2) {
    paged_gather_kernel<T, int16_t>
        <<<n_blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
            (const int32_t*)plo, (const int16_t*)sl, (const T*)x2, (T*)out,
            n, q * PAGE);
  } else if (sl_bytes == 4) {
    paged_gather_kernel<T, int32_t>
        <<<n_blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
            (const int32_t*)plo, (const int32_t*)sl, (const T*)x2, (T*)out,
            n, q * PAGE);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spx_delta_pages_f32(const void* plo, const void* sl,
                                   const void* vals, const void* x2,
                                   void* out, long long T, int q,
                                   void* stream) {
  return launch_delta_pages<float>(plo, sl, vals, x2, out, T, q, stream);
}

extern "C" int spx_delta_pages_f64(const void* plo, const void* sl,
                                   const void* vals, const void* x2,
                                   void* out, long long T, int q,
                                   void* stream) {
  return launch_delta_pages<double>(plo, sl, vals, x2, out, T, q, stream);
}

extern "C" int spx_paged_gather_f32(const void* plo, const void* sl,
                                    const void* x2, void* out, long long T,
                                    int q, int sl_bytes, void* stream) {
  return launch_paged_gather<float>(plo, sl, x2, out, T, q, sl_bytes, stream);
}

extern "C" int spx_paged_gather_f64(const void* plo, const void* sl,
                                    const void* x2, void* out, long long T,
                                    int q, int sl_bytes, void* stream) {
  return launch_paged_gather<double>(plo, sl, x2, out, T, q, sl_bytes,
                                     stream);
}
