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
// On the card the window is just an offset: the element reads
//   x2flat[plo[t] * 1024 + sl]
// from the zero-padded page grid x2, and 0 where sl is outside
// [0, q * 1024), as the Pallas kernels' selects give 0.  Both kernels are
// bound by the bytes of their streams (sl, vals, output), read and written
// once, and the distinct x values the windows hold.
//
//   delta_pages_kernel:        out[e] = x * vals[e]  (one multiply, no sum)
//   delta_pages_acc_kernel:    acc[rows[e]] += x * vals[e]  (epilogue form)
//   delta_rowblock_acc_kernel: the same sums, row-blocked (epilogue form)
//   paged_gather_kernel:       out[e] = x           (a copy: bit-exact)
//
// The delta stream's two epilogue forms, and when each runs.  A paged delta
// stream whose products have no scatter route (ops/exec.device_layout)
// is laid out again by the port in row blocks of rb rows, where every tile
// of each block's elements, taken in page order, keeps its window within 8
// pages at the largest rb whose sums fit the planner's 64 KB (RB_SMEM in
// ops/pallas_kernels.py: 16,384 rows in f32, 8,192 in f64; two thread
// blocks an SM): delta_rowblock_acc_kernel runs it.  Where the rows are too
// sparse for that, and for a symmetric shard's two streams, the stream
// keeps the planner's layout and delta_pages_acc_kernel runs it.
//
// delta_pages_acc_kernel's products land on about 1024 distinct rows a
// tile: one scattered atomicAdd into device memory each, an L2 sector
// operation apiece, which bounds it (16.8 M on GAP urand at 2^19: 216 us,
// where its streams need 50).  delta_rowblock_acc_kernel (below) streams
// 8 bytes an element in f32 (int16 offset, int16 row in the block, value:
// 134 MB on urand, 40 us at 3.35 TB/s) and keeps the sums in shared
// memory, so device memory sees one coalesced atomic a row a thread
// block; what bounds it now is the stream and the shared-memory adds
// (compare-and-swap loops on sm_90), which the threads of an SM (two
// blocks of 1024 in f32, one in f64) overlap with the stream (PERF.md).
//
// delta_pages_kernel and delta_pages_acc_kernel run one body
// (delta_products): a block per tile, each thread on V = 16 / sizeof(T)
// consecutive elements (4 in f32, 2 in f64).
// plo[t] is read once per block (thread 0, through shared memory); a thread
// reads its V int16 offsets as one vector (8 or 4 bytes) and its V values
// as one 16-byte load, both streaming past the caches (each is read once),
// issues its V gathers from the tile's window at once, through L1, which
// the block's threads share, and forms each product with __fmul_rn /
// __dmul_rn, so it is bit-equal to delta_pages_plain.  The product form
// then writes its V products with one 16-byte streaming store (the
// delta_pages_products / dscatter routes read them).  The epilogue form,
// for a paged delta without a scatter route, reads its V int32 rows as one
// vector and adds each product into acc[rows[e]] with atomicAdd, dropping
// rows outside [0, n_acc) (the padding slots carry the sentinel row
// nrows_part, or nrows_glob on a symmetric shard's transposed stream): the
// products never cross HBM, and the index_add_ that read them back is gone
// (the epilogue of paged_units_kernel below).  Atomic adds sum in no fixed
// order, as index_add_'s own kernel does.  The port's first design, a
// thread per element with a 2-byte offset load, a plo load and a scalar
// store each, reached 43-64 % of its bound in f32 (PERF.md).  The three
// launchers refuse sl off its vector boundary, vals and out off 16 bytes,
// rows and lrow off their vector boundaries, q outside 1..16, and rb past
// 32,768 (int16 local rows) or its sums past the shared memory a block may
// take: CUDA error 1.
//
// paged_gather_kernel (the fblk chain's gather, kernels.py:607-621) runs a
// block per tile, each thread on V = 16 / sizeof(T) consecutive elements (4
// in f32, 2 in f64): it reads its V offsets as one vector (16 or 8 bytes of
// int32, 8 or 4 of int16), issues its V gathers from the tile's window at
// once, through L1, which the block's threads share (a window is at most
// q * 4 KB of f32), and writes its values with one 16-byte streaming store.
// One thread a scattered 4-byte load, as before, left it slower than
// torch.take; staging the whole window in shared memory with cp.async
// first read up to q times the tile's distinct x values and was slower than
// this in both types on blocky 2^22 (PERF.md).  The launcher refuses sl off
// its vector boundary, out off 16 bytes, or q outside 1..16: CUDA error 1.
//
// paged_units_kernel takes a paged run or block table's pageable prefix a
// step further: the gather, the multiply by the table's values and each
// unit's sums in one pass (the reference's XLA ops around
// _build_gather_kernel, kernels.py:471-491, :570-588, :647-665), so the
// gathered values never cross HBM: a separate gather would write the
// (T, 8, 128) grid and read it back to multiply and row-sum it.  Tile t's
// slots [u*SU, (u+1)*SU) hold unit t*g + u's window offsets (g = 1024 / SU
// units per tile, slots past g*SU unused); unit u's R partials are
//   out[u, r] = sum_{c < C} vals[u, r, c] * x(sl[t, u*SU + r*RS + c])
// with (R, C, RS) = (1, W, 0) for a horizontal run table (one total per
// unit), (W, 1, 1) for a diagonal one (each product on its own row) and
// (br, bc, 0) for a block table.  One block per tile stages the tile's
// q-page window (q * 4 KB of f32, contiguous in x2) in shared memory with
// 16-byte asynchronous copies, so x crosses HBM/L2 as whole lines, then each
// thread forms one partial from shared memory: products and sums by
// __fmul_rn / __fadd_rn from 0 in c order, as paged_units_plain adds them,
// so the partials are bit-equal to it.  Where the table's partials are
// scatter-added (no partial-segment route), the kernel adds each into
// acc[dest] itself with atomicAdd (the epilogue form: dest, one int64 row per
// partial, rows outside [0, n_acc) dropped), in place of the written
// partials and the compare / select / clamp / index_add_ glue after them;
// the order of the atomic adds is free, as in index_add_'s own kernel.
// Interface: plain C launchers per value type (loaded with ctypes); each
// launches on the caller's stream, never synchronises, allocates nothing
// and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAGE = 1024;       // x values per page = elements per tile
// The row-blocked epilogue's thread blocks: RB_THREADS threads and rb row
// sums in shared memory (the planner's rb: 64 KB of sums), so that two fill
// an H100 SM (2048 threads, 228 KB of shared memory) in float32, where 32
// registers a thread do; in float64 they would spill, and one thread block
// takes an SM.  A local row is int16: rb is at most RB_MAX_ROWS.
constexpr int RB_THREADS = 1024;
constexpr int RB_MAX_ROWS = 32768;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// A thread's V consecutive window offsets (V = 16 / sizeof(T): 4 in f32, 2
// in f64, the values of its one 16-byte store), loaded as one vector that
// streams past the caches (each offset is read once).
__device__ __forceinline__ void load_offsets(const int32_t* p, int (&s)[4]) {
  const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
  s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
}

__device__ __forceinline__ void load_offsets(const int32_t* p, int (&s)[2]) {
  const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
  s[0] = v.x; s[1] = v.y;
}

__device__ __forceinline__ void load_offsets(const int16_t* p, int (&s)[4]) {
  const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
  s[0] = (int16_t)(v.x & 0xFFFF); s[1] = (int16_t)((unsigned)v.x >> 16);
  s[2] = (int16_t)(v.y & 0xFFFF); s[3] = (int16_t)((unsigned)v.y >> 16);
}

__device__ __forceinline__ void load_offsets(const int16_t* p, int (&s)[2]) {
  const int v = __ldcs(reinterpret_cast<const int*>(p));
  s[0] = (int16_t)(v & 0xFFFF); s[1] = (int16_t)((unsigned)v >> 16);
}

// A thread's values as one 16-byte streaming store.
__device__ __forceinline__ void store_values(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void store_values(double* p, const double (&v)[2]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

// A thread's V values as one 16-byte load that streams past the caches.
__device__ __forceinline__ void load_values(const float* p, float (&v)[4]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load_values(const double* p, double (&v)[2]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  v[0] = a.x; v[1] = a.y;
}

// The products of a thread's V consecutive elements from e (the body of
// both delta kernels; a block per tile, 1024 / V threads): offsets and
// values as one vector each, plo[t] once per block, the V gathers from the
// tile's window in flight together, the products rounded as the plain
// version rounds them.
template <typename T>
__device__ __forceinline__ void delta_products(
    const int32_t* __restrict__ plo, const int16_t* __restrict__ sl,
    const T* __restrict__ vals, const T* __restrict__ x2, long long e,
    int win, T (&p)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  __shared__ long long window;
  int s[V];
  load_offsets(sl + e, s);
  T v[V];
  load_values(vals + e, v);
  if (threadIdx.x == 0) window = (long long)plo[blockIdx.x] * PAGE;
  __syncthreads();
  const T* src = x2 + window;
  T xv[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    xv[j] = (s[j] >= 0 && s[j] < win) ? __ldg(src + s[j]) : T(0);
#pragma unroll
  for (int j = 0; j < V; ++j) p[j] = mul_rn(xv[j], v[j]);
}

template <typename T>
__global__ void __launch_bounds__(PAGE * sizeof(T) / 16)
delta_pages_kernel(const int32_t* __restrict__ plo,
                   const int16_t* __restrict__ sl, const T* __restrict__ vals,
                   const T* __restrict__ x2, T* __restrict__ out, int win) {
  constexpr int V = 16 / sizeof(T);
  const long long e = (long long)blockIdx.x * PAGE + V * threadIdx.x;
  T p[V];
  delta_products(plo, sl, vals, x2, e, win, p);
  store_values(out + e, p);
}

template <typename T>
__global__ void __launch_bounds__(PAGE * sizeof(T) / 16)
delta_pages_acc_kernel(const int32_t* __restrict__ plo,
                       const int16_t* __restrict__ sl,
                       const T* __restrict__ vals, const T* __restrict__ x2,
                       const int32_t* __restrict__ rows, T* __restrict__ acc,
                       long long n_acc, int win) {
  constexpr int V = 16 / sizeof(T);
  const long long e = (long long)blockIdx.x * PAGE + V * threadIdx.x;
  int r[V];
  load_offsets(rows + e, r);
  T p[V];
  delta_products(plo, sl, vals, x2, e, win, p);
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (r[j] >= 0 && r[j] < n_acc) atomicAdd(acc + r[j], p[j]);
}

// The row-blocked epilogue form.  The stream's tiles are grouped by row
// block (rows [b * rb, (b + 1) * rb) in tiles [blk_tile[b], blk_tile[b +
// 1])), each element carrying its row as an int16 offset into its block
// (lrow; -1 in padding slots, dropped).  Thread block i of the grid's N
// takes the tiles [T * i / N, T * (i + 1) / N): for each row block that run
// meets it zeroes rb sums in shared memory, adds each product there with a
// shared-memory atomicAdd, then adds each nonzero sum into acc with one
// coalesced atomic a row.  A tile is a group of 1024 / V threads, and the
// block's groups walk the run's tiles together, each thread on V elements
// of a tile as delta_products does (its offsets, local rows and values as
// one vector each, streaming past the caches; its V gathers through L1;
// __fmul_rn / __dmul_rn).  A grid of as many blocks as the card holds at
// once gives each an equal run, where a block a row block would leave SMs
// idle or run a second wave.
template <typename T>
__global__ void __launch_bounds__(RB_THREADS, 8 / sizeof(T))
delta_rowblock_acc_kernel(const int32_t* __restrict__ plo,
                          const int16_t* __restrict__ sl,
                          const int16_t* __restrict__ lrow,
                          const T* __restrict__ vals,
                          const T* __restrict__ x2,
                          const int32_t* __restrict__ blk_tile, int nb,
                          long long n_tiles, T* __restrict__ acc,
                          long long n_acc, int rb, int win) {
  extern __shared__ __align__(16) unsigned char rb_smem[];
  T* part = reinterpret_cast<T*>(rb_smem);
  constexpr int V = 16 / sizeof(T);
  constexpr int TPT = PAGE / V;            // threads a tile
  constexpr int G = RB_THREADS / TPT;      // tiles the block walks at once
  const int g = threadIdx.x / TPT;
  const int lane = threadIdx.x - g * TPT;
  const long long t_end = n_tiles * (blockIdx.x + 1) / gridDim.x;
  long long t0 = n_tiles * blockIdx.x / gridDim.x;
  int b = 0, hi = nb;                      // blk_tile[b] <= t0 < blk_tile[hi]
  while (hi - b > 1) {
    const int mid = (b + hi) / 2;
    if (blk_tile[mid] <= t0) b = mid; else hi = mid;
  }
  while (t0 < t_end) {
    while (blk_tile[b + 1] <= t0) ++b;     // past empty row blocks
    const long long t1 = min(t_end, (long long)blk_tile[b + 1]);
    for (int i = threadIdx.x; i < rb; i += RB_THREADS) part[i] = T(0);
    __syncthreads();
    for (long long t = t0 + g; t < t1; t += G) {
      const long long e = t * PAGE + V * lane;
      int s[V], r[V];
      load_offsets(sl + e, s);
      load_offsets(lrow + e, r);
      T v[V];
      load_values(vals + e, v);
      const T* src = x2 + (long long)__ldg(plo + t) * PAGE;
      T xv[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        xv[j] = (r[j] >= 0 && s[j] >= 0 && s[j] < win) ? __ldg(src + s[j])
                                                       : T(0);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if ((unsigned)r[j] < (unsigned)rb)
          atomicAdd(part + r[j], mul_rn(xv[j], v[j]));
    }
    __syncthreads();
    const long long row0 = (long long)b * rb;
    const long long n = n_acc - row0 < rb ? n_acc - row0 : rb;
    for (int i = threadIdx.x; i < n; i += RB_THREADS)
      if (part[i] != T(0)) atomicAdd(acc + row0 + i, part[i]);
    __syncthreads();
    t0 = t1;
  }
}

// One block per tile, V elements a thread (a block of 1024 / V threads):
// the thread's offsets as one vector, its V gathers from the tile's window
// (q * 1024 values, contiguous in x2 from plo[t] * 1024, which the block's
// threads share through L1) all in flight at once, its values as one
// 16-byte store.
template <typename T, typename S>
__global__ void __launch_bounds__(PAGE * sizeof(T) / 16)
paged_gather_kernel(const int32_t* __restrict__ plo, const S* __restrict__ sl,
                    const T* __restrict__ x2, T* __restrict__ out, int win) {
  constexpr int V = 16 / sizeof(T);
  const long long t = blockIdx.x;
  const T* src = x2 + (long long)plo[t] * PAGE;
  const long long e = t * PAGE + V * threadIdx.x;
  int s[V];
  load_offsets(sl + e, s);
  T v[V];
#pragma unroll
  for (int j = 0; j < V; ++j)
    v[j] = (s[j] >= 0 && s[j] < win) ? __ldg(src + s[j]) : T(0);
  store_values(out + e, v);
}

// One block per tile: win = q * 1024 values of the window, staged from
// x2 + plo[t] * 1024 (16-byte copies when that address is 16-byte aligned,
// which a page grid of its own always is; element copies otherwise).
template <typename T, typename S>
__global__ void paged_units_kernel(const int32_t* __restrict__ plo,
                                   const S* __restrict__ sl,
                                   const T* __restrict__ vals,
                                   const T* __restrict__ x2,
                                   T* __restrict__ out, T* __restrict__ acc,
                                   const int64_t* __restrict__ dest,
                                   long long n_acc, int win, int R, int C,
                                   int RS, int SU, int g) {
  extern __shared__ __align__(16) unsigned char pu_smem[];
  T* xw = reinterpret_cast<T*>(pu_smem);
  const long long t = blockIdx.x;
  const T* src = x2 + (long long)plo[t] * PAGE;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int V = 16 / sizeof(T);      // values per 16-byte copy
    for (int i = threadIdx.x; i < win / V; i += blockDim.x)
      __pipeline_memcpy_async(xw + i * V, src + i * V, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
  } else {
    for (int i = threadIdx.x; i < win; i += blockDim.x) xw[i] = src[i];
  }
  __syncthreads();
  const S* st = sl + t * PAGE;
  const long long u0 = t * g;
  for (int o = threadIdx.x; o < g * R; o += blockDim.x) {
    const int u = o / R;
    const int r = o - u * R;
    const T* v = vals + ((u0 + u) * R + r) * C;
    const S* s = st + u * SU + r * RS;
    T sum = T(0);
    for (int c = 0; c < C; ++c) {
      const int off = (int)s[c];
      sum = add_rn(sum, mul_rn(v[c], (off >= 0 && off < win) ? xw[off] : T(0)));
    }
    const long long p = (u0 + u) * R + r;
    if (acc == nullptr) {
      out[p] = sum;
    } else {
      const long long d = dest[p];
      if (d >= 0 && d < n_acc) atomicAdd(acc + d, sum);
    }
  }
}

constexpr int THREADS = 256;

// Whether a delta kernel refuses its operands: a thread's offsets (V int16)
// and rows (V int32) load as one vector each, its values as 16 bytes, its
// products store as 16 bytes (out, the product form), and the window is
// 1..16 pages.
template <typename T>
bool delta_refused(const void* sl, const void* vals, const void* out,
                   const void* rows, int q) {
  constexpr uintptr_t V = 16 / sizeof(T);
  return q < 1 || q > 16 || ((uintptr_t)sl & (2 * V - 1)) ||
         ((uintptr_t)vals & 15) || ((uintptr_t)out & 15) ||
         ((uintptr_t)rows & (4 * V - 1));
}

template <typename T>
int launch_delta_pages(const void* plo, const void* sl, const void* vals,
                       const void* x2, void* out, long long T_tiles, int q,
                       void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (out == nullptr || delta_refused<T>(sl, vals, out, nullptr, q))
    return (int)cudaErrorInvalidValue;
  if (T_tiles == 0) return (int)cudaGetLastError();
  delta_pages_kernel<T><<<(unsigned)T_tiles, PAGE / V, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int16_t*)sl, (const T*)vals, (const T*)x2,
      (T*)out, q * PAGE);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta_pages_acc(const void* plo, const void* sl, const void* vals,
                           const void* x2, const void* rows, void* acc,
                           long long n_acc, long long T_tiles, int q,
                           void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (acc == nullptr || rows == nullptr ||
      delta_refused<T>(sl, vals, nullptr, rows, q))
    return (int)cudaErrorInvalidValue;
  if (T_tiles == 0) return (int)cudaGetLastError();
  delta_pages_acc_kernel<T><<<(unsigned)T_tiles, PAGE / V, 0,
                              (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int16_t*)sl, (const T*)vals, (const T*)x2,
      (const int32_t*)rows, (T*)acc, n_acc, q * PAGE);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rowblock(const void* plo, const void* sl, const void* lrow,
                    const void* vals, const void* x2, const void* blk_tile,
                    int nb, long long n_tiles, void* acc, long long n_acc,
                    int rb, int q, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (acc == nullptr || lrow == nullptr || blk_tile == nullptr ||
      delta_refused<T>(sl, vals, nullptr, nullptr, q) ||
      ((uintptr_t)lrow & (2 * V - 1)) || rb < 1 || rb > RB_MAX_ROWS ||
      nb < 1)
    return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaGetLastError();
  auto kernel = delta_rowblock_acc_kernel<T>;
  const size_t smem = (size_t)rb * sizeof(T);
  // as many thread blocks as the card holds at once, each a run of tiles;
  // rb sums past the shared memory a block may take are refused
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > (size_t)optin)
    return (int)cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        RB_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  kernel<<<(unsigned)grid, RB_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int16_t*)sl, (const int16_t*)lrow,
      (const T*)vals, (const T*)x2, (const int32_t*)blk_tile, nb, n_tiles,
      (T*)acc, n_acc, rb, q * PAGE);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged_gather(const void* plo, const void* sl, const void* x2,
                        void* out, long long T_tiles, int q, int sl_bytes,
                        void* stream) {
  // a thread's offsets are one vector load, its values one 16-byte store
  constexpr int V = 16 / sizeof(T);
  const uintptr_t sl_align = (uintptr_t)(V * sl_bytes) - 1;
  if (q < 1 || q > 16 || (sl_bytes != 2 && sl_bytes != 4) ||
      ((uintptr_t)sl & sl_align) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (T_tiles == 0) return (int)cudaGetLastError();
  const unsigned grid = (unsigned)T_tiles;
  cudaStream_t st = (cudaStream_t)stream;
  if (sl_bytes == 2)
    paged_gather_kernel<T, int16_t><<<grid, PAGE / V, 0, st>>>(
        (const int32_t*)plo, (const int16_t*)sl, (const T*)x2, (T*)out,
        q * PAGE);
  else
    paged_gather_kernel<T, int32_t><<<grid, PAGE / V, 0, st>>>(
        (const int32_t*)plo, (const int32_t*)sl, (const T*)x2, (T*)out,
        q * PAGE);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch_paged_units_as(const void* plo, const void* sl, const void* vals,
                          const void* x2, void* out, void* acc,
                          const void* dest, long long n_acc, long long T_tiles,
                          int q, int R, int C, int RS, int SU, int g,
                          void* stream) {
  const size_t smem = (size_t)q * PAGE * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_units_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_units_kernel<T, S><<<(unsigned)T_tiles, THREADS, smem,
                             (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const S*)sl, (const T*)vals, (const T*)x2,
      (T*)out, (T*)acc, (const int64_t*)dest, n_acc, q * PAGE, R, C, RS, SU,
      g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged_units(const void* plo, const void* sl, const void* vals,
                       const void* x2, void* out, void* acc, const void* dest,
                       long long n_acc, long long T_tiles, int q, int sl_bytes,
                       int R, int C, int each, int SU, int g, void* stream) {
  const int RS = each ? 1 : 0;
  if (q < 1 || q > 16 || R < 1 || C < 1 || SU < 1 || SU > PAGE ||
      g != PAGE / SU || (each ? (C != 1 || R != SU) : C != SU) ||
      (acc == nullptr) == (out == nullptr) ||
      (acc != nullptr && dest == nullptr))
    return (int)cudaErrorInvalidValue;
  if (T_tiles == 0) return (int)cudaGetLastError();
  if (sl_bytes == 2)
    return launch_paged_units_as<T, int16_t>(plo, sl, vals, x2, out, acc,
                                             dest, n_acc, T_tiles, q, R, C,
                                             RS, SU, g, stream);
  if (sl_bytes == 4)
    return launch_paged_units_as<T, int32_t>(plo, sl, vals, x2, out, acc,
                                             dest, n_acc, T_tiles, q, R, C,
                                             RS, SU, g, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int spx_paged_units_f32(
    const void* plo, const void* sl, const void* vals, const void* x2,
    void* out, void* acc, const void* dest, long long n_acc, long long T,
    int q, int sl_bytes, int R, int C, int each, int SU, int g,
    void* stream) {
  return launch_paged_units<float>(plo, sl, vals, x2, out, acc, dest,
      n_acc, T, q, sl_bytes, R, C, each, SU, g, stream);
}

extern "C" int spx_paged_units_f64(
    const void* plo, const void* sl, const void* vals, const void* x2,
    void* out, void* acc, const void* dest, long long n_acc, long long T,
    int q, int sl_bytes, int R, int C, int each, int SU, int g,
    void* stream) {
  return launch_paged_units<double>(plo, sl, vals, x2, out, acc, dest,
      n_acc, T, q, sl_bytes, R, C, each, SU, g, stream);
}

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

extern "C" int spx_delta_pages_acc_f32(const void* plo, const void* sl,
                                       const void* vals, const void* x2,
                                       const void* rows, void* acc,
                                       long long n_acc, long long T, int q,
                                       void* stream) {
  return launch_delta_pages_acc<float>(plo, sl, vals, x2, rows, acc, n_acc,
                                       T, q, stream);
}

extern "C" int spx_delta_pages_acc_f64(const void* plo, const void* sl,
                                       const void* vals, const void* x2,
                                       const void* rows, void* acc,
                                       long long n_acc, long long T, int q,
                                       void* stream) {
  return launch_delta_pages_acc<double>(plo, sl, vals, x2, rows, acc, n_acc,
                                        T, q, stream);
}

extern "C" int spx_delta_rowblock_acc_f32(
    const void* plo, const void* sl, const void* lrow, const void* vals,
    const void* x2, const void* blk_tile, int nb, long long T, void* acc,
    long long n_acc, int rb, int q, void* stream) {
  return launch_rowblock<float>(plo, sl, lrow, vals, x2, blk_tile, nb, T,
                                acc, n_acc, rb, q, stream);
}

extern "C" int spx_delta_rowblock_acc_f64(
    const void* plo, const void* sl, const void* lrow, const void* vals,
    const void* x2, const void* blk_tile, int nb, long long T, void* acc,
    long long n_acc, int rb, int q, void* stream) {
  return launch_rowblock<double>(plo, sl, lrow, vals, x2, blk_tile, nb, T,
                                 acc, n_acc, rb, q, stream);
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
