// The route network's lane gather for Hopper (sm_90a).
//
// Replaces sparsex_tpu/ops/route.py:_build_lane_gather, the Pallas kernel
//   out[r, j] = sum_k (idx[k, r, j] >= 0 ? x[r, idx[k, r, j]] : 0)
// over (R, 128) values and K int8 wire planes (K = 1 for a merged plan
// instance's G1, ops/fused.py:merged_e1s).  The TPU kernel exists because
// a per-sublane take_along_axis is its only vectorised gather.  Every sum
// starts from 0 and adds the K gathered values in wire order, so K = 1 is
// an exact copy and the result is bit-equal to the Pallas kernel.
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

// Four adjacent values as 16-byte vectors (one in f32, two in f64).
__device__ __forceinline__ void load4(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(double (&v)[4], const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// The SpMV form: a warp per 128-lane row, with no block barrier.  Thread i
// owns lanes 4i..4i+3: it loads its 4 values of the row (16 bytes in f32)
// and its 4 wires of plane 0 (one 4-byte word) together, so neither load
// waits on the other, and puts the values in the warp's own shared row;
// after one __syncwarp it reads its gathered values there and stores its 4
// sums as one 16-byte vector.  Planes k > 0 (the g3 planes of a legacy
// scatter route) load after the row.  The one-thread-one-output kernel it
// replaced made every x read wait on its 1-byte wire load from device memory
// and moved 1 and 4 bytes an instruction.  Now the shared-row gather costs
// nothing measurable and the output stores take about 40 % of the time
// (PERF.md).  The wires are read once and stream past the caches; x and the
// output use the default cache policy (streaming them gained nothing alone
// and cost the SpMV: T1 reads the output next).  Two rows a warp, and 4 or
// 16 warps a block, measured no faster.
constexpr int LG_WARPS = 8;                   // rows (warps) a block
constexpr int LG_THREADS = LG_WARPS * 32;

template <typename T>
__global__ void __launch_bounds__(LG_THREADS)
    lane_gather_kernel(const T* __restrict__ x,
                       const int8_t* __restrict__ idx, T* __restrict__ out,
                       long long R, int K) {
  __shared__ __align__(16) T s[LG_WARPS][L];
  const int w = threadIdx.x >> 5;
  const int i = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * LG_WARPS + w;
  if (row >= R) return;                       // a whole warp: no barrier
  const long long e = (row << 7) + 4 * i;
  T v[4];
  load4(v, x + e);
  int wk = __ldcs(reinterpret_cast<const int*>(idx + e));
  T* r = s[w];
  store4(r + 4 * i, v);
  __syncwarp();
  T acc[4] = {T(0), T(0), T(0), T(0)};
  for (int k = 0; k < K; ++k) {
    if (k) wk = __ldcs(reinterpret_cast<const int*>(idx + k * R * L + e));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int wire = (int)(int8_t)(wk >> (8 * j));
      acc[j] = add_rn(acc[j], wire >= 0 ? r[wire] : T(0));
    }
  }
  store4(out + e, acc);
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
  // 16-byte vectors of x and out, 4-byte wire words
  if (K < 1 || (((uintptr_t)x | (uintptr_t)out) & 15) || ((uintptr_t)idx & 3))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (R + LG_WARPS - 1) / LG_WARPS;
  if (blocks == 0) return (int)cudaGetLastError();
  lane_gather_kernel<T><<<(unsigned)blocks, LG_THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const T*)x, (const int8_t*)idx, (T*)out, R, K);
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
