// The fused CSX SpMV pipeline for Hopper (sm_90a): K1 (styles lp and
// rlp{W}), T1, K2 and K3.
//
// Each kernel replaces one Pallas TPU kernel of sparsex_tpu/ops/fused.py and
// reads exactly the plan arrays its counterpart reads (the shared NumPy
// planners build them).  All are gathers with little or no reuse, so
// each is bound by device-memory bytes and latency, not by arithmetic; the
// first versions keep every intermediate either in registers or in one
// shared-memory stage and read x through L2.
//
// Numerics: the only arithmetic is K1's one multiply (plus the rlp styles'
// sliding lane sums) and K3's sums.  The
// explicit __fmul_rn / __fadd_rn (and double) intrinsics keep nvcc from
// contracting a multiply and an add into an FMA, so the sums round exactly
// as the plain PyTorch versions and the Pallas kernels round them, in the
// same order.
//
// Interface: plain C launchers (loaded with ctypes), one per kernel and
// value type.  Each launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;           // lanes per row (the TPU's 128-lane axis)
constexpr int TILE3 = L * L;     // y rows per K3 destination block
constexpr int MAX_INST = 8;      // K3 instance fan-in (fused.MAX_INSTANCES)

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// ---------------------------------------------------------------------------
// K1 (replaces fused.py:_build_k1, style "lp").  One thread per output
// element (t, s, l) of the (T, 8, 128) grid:
//   g1 = (mg[t,s,l] >> 16) - 1;  out = g1 < 0 ? 0 : prod[t, s, g1]
//   prod[t, s, g] = x2[page, low & 7, g] * vals[t, s, g],  low = mg[t,s,g] & 0x3FFF
//   page = plo[t] * q8 + (low >> 3)   (q8 == 1: the window is one page)
// A q = 32 window is 128 KB of f32 (256 KB of f64), more than a block's
// shared memory, so x is read through L2 rather than staged.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void k1_lp_kernel(const int32_t* __restrict__ plo,
                             const int32_t* __restrict__ mg,
                             const T* __restrict__ vals,
                             const T* __restrict__ x2,
                             T* __restrict__ out, long long n_elems, int q8) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long row = e >> 7;            // t * 8 + s
  const int g1 = (int)(((uint32_t)mg[e]) >> 16) - 1;
  T r = T(0);
  if (g1 >= 0) {
    const long long src = (row << 7) + g1;
    const int low = mg[src] & 0x3FFF;
    const int pg = low >> 3;
    if (q8 == 1 || pg < q8) {
      const long long page =
          (long long)plo[row >> 3] * q8 + (q8 == 1 ? 0 : pg);
      r = mul_rn(x2[((page << 3) + (low & 7)) * L + g1], vals[src]);
    }
  }
  out[e] = r;
}

// ---------------------------------------------------------------------------
// K1, styles "rlp2" / "rlp4" / "rlp8" (replaces fused.py:_build_k1, the
// lane-placed run styles).  Horizontal runs of width W sit in W-aligned
// mod-128 lane slots of a row; every lane holds the lp product
//   p[l] = x2[page, low & 7, l] * vals[t, s, l]   (0 where the page is
//          outside the q8-page window, as in k1_lp_kernel)
// then log2(W) CIRCULAR roll-right adds, p[l] += p[(l - d) & 127] for
// d = 1, 2, 4, leave each run's total at its last lane (arcs that wrap
// lane 127 -> 0 sum correctly because the roll is circular), and the G1
// wires route the totals: out[l] = g1 < 0 ? 0 : p[g1].
// One 128-thread group per (tile, sublane) row computes each product once
// into shared memory, where a per-output gather (k1_lp_kernel's design)
// would recompute up to W products per lane.  Like the lp kernel it is
// bound by the bytes of mg, vals and the x window, read through L2; the
// adds keep the Pallas kernel's order, so the result is bit-equal to it.
// ---------------------------------------------------------------------------
constexpr int K1_ROWS = 2;       // (tile, sublane) rows per rlp block

template <typename T>
__global__ void k1_rlp_kernel(const int32_t* __restrict__ plo,
                              const int32_t* __restrict__ mg,
                              const T* __restrict__ vals,
                              const T* __restrict__ x2,
                              T* __restrict__ out, int q8, int W) {
  __shared__ T p[K1_ROWS][L];
  const int r = threadIdx.x >> 7;
  const int l = threadIdx.x & (L - 1);
  const long long row = (long long)blockIdx.x * K1_ROWS + r;   // t * 8 + s
  const long long e = (row << 7) + l;
  const int m = mg[e];
  const int low = m & 0x3FFF;
  const int pg = low >> 3;
  T xv = T(0);
  if (q8 == 1 || pg < q8) {
    const long long page = (long long)plo[row >> 3] * q8 + (q8 == 1 ? 0 : pg);
    xv = x2[((page << 3) + (low & 7)) * L + l];
  }
  T acc = mul_rn(xv, vals[e]);
  for (int d = 1; d < W; d <<= 1) {
    p[r][l] = acc;
    __syncthreads();
    acc = add_rn(acc, p[r][(l - d) & (L - 1)]);
    __syncthreads();
  }
  p[r][l] = acc;
  __syncthreads();
  const int g1 = (int)(((uint32_t)m) >> 16) - 1;
  out[e] = g1 >= 0 ? p[r][g1] : T(0);
}

// ---------------------------------------------------------------------------
// T1 (replaces fused.py:_build_t1).  (A2R*128, 128) -> (A2R, 128, 128),
// block a = A1[a*128:(a+1)*128].T.  A 32x32 shared-memory tile transpose:
// both the read and the write are coalesced; the +1 column pad removes bank
// conflicts on the transposed read.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void t1_kernel(const T* __restrict__ in, T* __restrict__ out) {
  __shared__ T tile[32][33];
  const size_t base = (size_t)blockIdx.z * L * L;
  const int c0 = blockIdx.x * 32;          // input column = output row
  const int j0 = blockIdx.y * 32;          // input row = output column
  for (int k = threadIdx.y; k < 32; k += blockDim.y)
    tile[k][threadIdx.x] = in[base + (size_t)(j0 + k) * L + c0 + threadIdx.x];
  __syncthreads();
  for (int k = threadIdx.y; k < 32; k += blockDim.y)
    out[base + (size_t)(c0 + k) * L + j0 + threadIdx.x] = tile[threadIdx.x][k];
}

// ---------------------------------------------------------------------------
// K2 (replaces fused.py:_build_k2).  One block per outer color c, working
// from RAW g2b wires (the port removes the lane offset that the unmasked
// Pallas kernel bakes in):
//   C1[b, w]   = a = g2a[c,b,w];  a >= 0 ? A1T[b, c, a] : 0      (shared)
//   D1[w, d]   = b = g2b[c,w,d];  0 <= b < A2R ? C1[b, w] : 0
//   E1[c,d,l]  = g = g2c[c,d,l];  0 <= g < W2 ? D1[g, d] : 0
// C1 is A2R x 128 values: at most 64 KB in f32, 128 KB in f64, so above
// 48 KB the launcher raises the dynamic shared-memory limit.  D1 is never
// stored: each output resolves its two wires and reads C1 once.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void k2_kernel(const T* __restrict__ a1t,
                          const int8_t* __restrict__ g2a,
                          const int8_t* __restrict__ g2b,
                          const int8_t* __restrict__ g2c,
                          T* __restrict__ e1, int A2R, int W2, int D2R) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  T* c1 = reinterpret_cast<T*>(k2_smem);
  const int c = blockIdx.x;
  const int8_t* ga = g2a + (size_t)c * A2R * L;
  for (int i = threadIdx.x; i < A2R * L; i += blockDim.x) {
    const int b = i >> 7;
    const int a = ga[i];
    c1[i] = a >= 0 ? a1t[((size_t)b * L + c) * L + a] : T(0);
  }
  __syncthreads();
  const int8_t* gb = g2b + (size_t)c * W2 * L;
  const int8_t* gc = g2c + (size_t)c * D2R * L;
  T* oc = e1 + (size_t)c * D2R * L;
  for (int i = threadIdx.x; i < D2R * L; i += blockDim.x) {
    const int d = i >> 7;
    const int g = gc[i];
    T v = T(0);
    if (g >= 0 && g < W2) {
      const int b = gb[g * L + d];
      if (b >= 0 && b < A2R) v = c1[b * L + g];
    }
    oc[i] = v;
  }
}

// ---------------------------------------------------------------------------
// K3 (replaces fused.py:_build_k3).  One block of 128 threads per
// (destination block i, row strip p); thread l owns y row
// i*16384 + p*128 + l and writes it once:
//   y = sum_inst sum_k (g = g3[i,k,p,l]) >= 0 ? E1[g, i, p] : 0
//     + sum_d dv[i,d,p,l] * x[row + off_d] + sum_a adv[i,a,p,l] * xr[row + aoff_a]
// The 128 E1 values a strip gathers from (a strided column of E1) are
// staged in shared memory per instance.  x reads outside [0, nx) give 0,
// where the Pallas kernel reads a clamped block and relies on dv being 0.
// ---------------------------------------------------------------------------
struct K3Args {
  const void* e1[MAX_INST];
  const int8_t* g3[MAX_INST];
  int K[MAX_INST];
  int n_inst;
  const void* dv;
  const int32_t* doff;
  int nd;
  const void* adv;
  const int32_t* aoff;
  int na;
  const void* x;
  const void* xr;
  long long nx;
  int D2R;
};

template <typename T>
__global__ void k3_kernel(K3Args a, T* __restrict__ y) {
  __shared__ T se[MAX_INST][L];
  const int i = blockIdx.x >> 7;
  const int p = blockIdx.x & (L - 1);
  const int l = threadIdx.x;
  for (int s = 0; s < a.n_inst; ++s)
    se[s][l] = static_cast<const T*>(a.e1[s])[((size_t)l * a.D2R + i) * L + p];
  __syncthreads();
  T total = T(0);
  for (int s = 0; s < a.n_inst; ++s) {
    const int K = a.K[s];
    const int8_t* g = a.g3[s] + ((size_t)i * K * L + p) * L + l;
    for (int k = 0; k < K; ++k) {
      const int w = g[(size_t)k * L * L];
      total = add_rn(total, w >= 0 ? se[s][w] : T(0));
    }
  }
  const long long row = (long long)i * TILE3 + p * L + l;
  const T* x = static_cast<const T*>(a.x);
  const T* dv = static_cast<const T*>(a.dv);
  for (int d = 0; d < a.nd; ++d) {
    const long long j = row + a.doff[d];
    const T xv = (j >= 0 && j < a.nx) ? x[j] : T(0);
    total = add_rn(total, mul_rn(dv[(((size_t)i * a.nd + d) * L + p) * L + l], xv));
  }
  const T* xr = static_cast<const T*>(a.xr);
  const T* adv = static_cast<const T*>(a.adv);
  for (int d = 0; d < a.na; ++d) {
    const long long j = row + a.aoff[d];
    const T xv = (j >= 0 && j < a.nx) ? xr[j] : T(0);
    total = add_rn(total, mul_rn(adv[(((size_t)i * a.na + d) * L + p) * L + l], xv));
  }
  y[row] = total;
}

template <typename T>
int launch_k1(const void* plo, const void* mg, const void* vals, const void* x2,
              void* out, long long n_tiles, int q8, void* stream) {
  const long long n = n_tiles * 8 * L;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  k1_lp_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int32_t*)mg, (const T*)vals, (const T*)x2,
      (T*)out, n, q8);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k1_rlp(const void* plo, const void* mg, const void* vals,
                  const void* x2, void* out, long long n_tiles, int q8, int W,
                  void* stream) {
  if (W < 2 || W > L || (W & (W - 1))) return (int)cudaErrorInvalidValue;
  const long long blocks = n_tiles * 8 / K1_ROWS;   // 8 rows per tile
  if (blocks == 0) return (int)cudaGetLastError();
  k1_rlp_kernel<T><<<(unsigned)blocks, K1_ROWS * L, 0, (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int32_t*)mg, (const T*)vals, (const T*)x2,
      (T*)out, q8, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t1(const void* in, void* out, int A2R, void* stream) {
  dim3 grid(L / 32, L / 32, A2R);
  dim3 block(32, 8);
  t1_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>((const T*)in, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k2(const void* a1t, const void* g2a, const void* g2b, const void* g2c,
              void* e1, int A2R, int W2, int D2R, void* stream) {
  const size_t smem = (size_t)A2R * L * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k2_kernel<T><<<L, 512, smem, (cudaStream_t)stream>>>(
      (const T*)a1t, (const int8_t*)g2a, (const int8_t*)g2b,
      (const int8_t*)g2c, (T*)e1, A2R, W2, D2R);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k3(const void* const* e1, const void* const* g3, const int* K,
              int n_inst, const void* dv, const void* doff, int nd,
              const void* adv, const void* aoff, int na, const void* x,
              const void* xr, long long nx, int D2R, void* y, void* stream) {
  if (n_inst < 0 || n_inst > MAX_INST) return (int)cudaErrorInvalidValue;
  K3Args a = {};
  for (int s = 0; s < n_inst; ++s) {
    a.e1[s] = e1[s];
    a.g3[s] = (const int8_t*)g3[s];
    a.K[s] = K[s];
  }
  a.n_inst = n_inst;
  a.dv = dv;
  a.doff = (const int32_t*)doff;
  a.nd = nd;
  a.adv = adv;
  a.aoff = (const int32_t*)aoff;
  a.na = na;
  a.x = x;
  a.xr = xr;
  a.nx = nx;
  a.D2R = D2R;
  k3_kernel<T><<<D2R * L, L, 0, (cudaStream_t)stream>>>(a, (T*)y);
  return (int)cudaGetLastError();
}

}  // namespace

#define SPX_FUSED_LAUNCHERS(SFX, T)                                            \
  extern "C" int spx_k1_##SFX(const void* plo, const void* mg,                 \
                              const void* vals, const void* x2, void* out,     \
                              long long n_tiles, int q8, void* stream) {       \
    return launch_k1<T>(plo, mg, vals, x2, out, n_tiles, q8, stream);          \
  }                                                                            \
  extern "C" int spx_k1_rlp_##SFX(const void* plo, const void* mg,             \
                                  const void* vals, const void* x2, void* out, \
                                  long long n_tiles, int q8, int W,            \
                                  void* stream) {                              \
    return launch_k1_rlp<T>(plo, mg, vals, x2, out, n_tiles, q8, W, stream);   \
  }                                                                            \
  extern "C" int spx_t1_##SFX(const void* in, void* out, int A2R,              \
                              void* stream) {                                  \
    return launch_t1<T>(in, out, A2R, stream);                                 \
  }                                                                            \
  extern "C" int spx_k2_##SFX(const void* a1t, const void* g2a,                \
                              const void* g2b, const void* g2c, void* e1,      \
                              int A2R, int W2, int D2R, void* stream) {        \
    return launch_k2<T>(a1t, g2a, g2b, g2c, e1, A2R, W2, D2R, stream);         \
  }                                                                            \
  extern "C" int spx_k3_##SFX(const void* const* e1, const void* const* g3,    \
                              const int* K, int n_inst, const void* dv,        \
                              const void* doff, int nd, const void* adv,       \
                              const void* aoff, int na, const void* x,         \
                              const void* xr, long long nx, int D2R, void* y,  \
                              void* stream) {                                  \
    return launch_k3<T>(e1, g3, K, n_inst, dv, doff, nd, adv, aoff, na, x, xr, \
                        nx, D2R, y, stream);                                   \
  }

SPX_FUSED_LAUNCHERS(f32, float)
SPX_FUSED_LAUNCHERS(f64, double)

extern "C" const char* spx_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
