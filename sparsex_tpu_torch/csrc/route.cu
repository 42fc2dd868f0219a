// The route network's lane gather for Hopper (sm_90a).
//
// Replaces sparsex_tpu/ops/route.py:_build_lane_gather, the Pallas kernel
//   out[r, j] = sum_k (idx[k, r, j] >= 0 ? x[r, idx[k, r, j]] : 0)
// over (R, 128) values and K int8 wire planes (K = 1 for a merged plan
// instance's G1, ops/fused.py:merged_e1s).  The TPU kernel exists because
// a per-sublane take_along_axis is its only vectorised gather; here every
// thread simply owns one output (r, j), reads its K wires and sums the
// gathered values from 0 in wire order, so K = 1 is an exact copy and the
// result is bit-equal to the Pallas kernel.  A row of x is 512 B (f32) or
// 1 KB (f64) and is read by the 128 threads of its row, so the reads hit
// L1/L2: the kernel is bound by the bytes of x, the wires and the output,
// which it each touches once.
//
// Interface: a plain C launcher per value type (loaded with ctypes); it
// launches on the caller's stream, never synchronises, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;           // lanes per row (the TPU's 128-lane axis)

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void lane_gather_kernel(const T* __restrict__ x,
                                   const int8_t* __restrict__ idx,
                                   T* __restrict__ out, long long n_elems,
                                   int K) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long row = e >> 7;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const int w = idx[(long long)k * n_elems + e];
    acc = add_rn(acc, w >= 0 ? x[(row << 7) + w] : T(0));
  }
  out[e] = acc;
}

// The k-batched variant (replaces the kb > 0 pallas_call, route.py:461):
// x and out are k-major, kb <= MAX_KB columns of n = R * 128 values each.
// On the TPU the wire block stays in VMEM across the innermost k grid axis;
// here a thread reads its K wires once and applies each to all kb column
// sums (register arrays under fully unrolled `c < kb` loops), in the same
// order as the kb = 1 kernel, so column c is bit-equal to it.  Bound: the
// wires once plus kb x (x + out).
constexpr int MAX_KB = 8;        // columns per launch (exec.MM_FUSED_KB)

template <typename T>
__global__ void lane_gather_kb_kernel(const T* __restrict__ x,
                                      const int8_t* __restrict__ idx,
                                      T* __restrict__ out, long long n_elems,
                                      int K, int kb) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long base = (e >> 7) << 7;
  T acc[MAX_KB];
#pragma unroll
  for (int c = 0; c < MAX_KB; ++c) acc[c] = T(0);
  for (int k = 0; k < K; ++k) {
    const int w = idx[(long long)k * n_elems + e];
#pragma unroll
    for (int c = 0; c < MAX_KB; ++c)
      if (c < kb)
        acc[c] = add_rn(acc[c], w >= 0 ? x[c * n_elems + base + w] : T(0));
  }
#pragma unroll
  for (int c = 0; c < MAX_KB; ++c)
    if (c < kb) out[c * n_elems + e] = acc[c];
}

template <typename T>
int launch_lane_gather(const void* x, const void* idx, void* out, long long R,
                       int K, void* stream) {
  const long long n = R * L;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  lane_gather_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const int8_t*)idx, (T*)out, n, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lane_gather_kb(const void* x, const void* idx, void* out,
                          long long R, int K, int kb, void* stream) {
  if (kb < 1 || kb > MAX_KB) return (int)cudaErrorInvalidValue;
  const long long n = R * L;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  lane_gather_kb_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)x, (const int8_t*)idx, (T*)out, n, K, kb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spx_lane_gather_f32(const void* x, const void* idx, void* out,
                                   long long R, int K, void* stream) {
  return launch_lane_gather<float>(x, idx, out, R, K, stream);
}

extern "C" int spx_lane_gather_f64(const void* x, const void* idx, void* out,
                                   long long R, int K, void* stream) {
  return launch_lane_gather<double>(x, idx, out, R, K, stream);
}

extern "C" int spx_lane_gather_kb_f32(const void* x, const void* idx,
                                      void* out, long long R, int K, int kb,
                                      void* stream) {
  return launch_lane_gather_kb<float>(x, idx, out, R, K, kb, stream);
}

extern "C" int spx_lane_gather_kb_f64(const void* x, const void* idx,
                                      void* out, long long R, int K, int kb,
                                      void* stream) {
  return launch_lane_gather_kb<double>(x, idx, out, R, K, kb, stream);
}
