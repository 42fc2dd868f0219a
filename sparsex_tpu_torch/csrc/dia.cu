// The standalone DIA kernel for Hopper (sm_90a).
//
// Replaces sparsex_tpu/ops/pallas_kernels.py:_build_dia_kernel, the Pallas
// kernel of the plain-table variant's DIA tables:
//   y[r] = sum_k dv[k, r] * xp[r + off[k]],   off[k] = offsets[k] + pad_lo,
// for r in [0, nrows), over the zero-padded x frame xp that
// ops/pallas_kernels.dia_spmv builds with dia_spmv_pallas's pad_lo / xp_len
// framing (x outside [0, ncols) reads the padding's zeros).  The TPU kernel
// stages 32,768-row x windows in VMEM, grouped by block quotient, so that x
// is read from HBM once for all diagonals.  Here one thread owns one row and
// walks the D diagonals in the reference's k order: neighbouring threads
// read neighbouring dv[k, r] and xp values, so every load is coalesced, and
// the D shifted windows of x re-read the same lines through L1/L2 (x is at
// most tens of MB against a 50 MB L2).  The kernel is bound by dv's bytes,
// D * nrows values read once, plus one x pass and one y write.  D is a
// runtime value with no cap (the Pallas path stops at 64 diagonals and
// leaves the rest to XLA); the offsets come in a small device array.
//
// Numerics: __fmul_rn / __fadd_rn keep nvcc from contracting the multiply
// and the add into an FMA, so the row sums round exactly as dia_plain (and
// the Pallas kernel) round them: from 0, multiply then add, in k order.
//
// Interface: a plain C launcher per value type (loaded with ctypes); it
// launches on the caller's stream, never synchronises, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void dia_kernel(const T* __restrict__ dv, const T* __restrict__ xp,
                           const int32_t* __restrict__ off, int D,
                           long long nrows, T* __restrict__ y) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nrows) return;
  T acc = T(0);
  for (int k = 0; k < D; ++k)
    acc = add_rn(acc, mul_rn(dv[(long long)k * nrows + r], xp[r + off[k]]));
  y[r] = acc;
}

template <typename T>
int launch_dia(const void* dv, const void* xp, const void* off, int D,
               long long nrows, void* y, void* stream) {
  if (nrows == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (nrows + threads - 1) / threads;
  dia_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)dv, (const T*)xp, (const int32_t*)off, D, nrows, (T*)y);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spx_dia_f32(const void* dv, const void* xp, const void* off,
                           int D, long long nrows, void* y, void* stream) {
  return launch_dia<float>(dv, xp, off, D, nrows, y, stream);
}

extern "C" int spx_dia_f64(const void* dv, const void* xp, const void* off,
                           int D, long long nrows, void* y, void* stream) {
  return launch_dia<double>(dv, xp, off, D, nrows, y, stream);
}
