// The fused CSX SpMV pipeline for Hopper (sm_90a): K1 (the lane-placed
// styles lp and rlp{W}, the dense-tile styles sl and run{W}), T1, K2 and K3,
// and their k-batched (SpMM) variants at the end of the file.
//
// Each kernel replaces one Pallas TPU kernel of sparsex_tpu/ops/fused.py and
// reads exactly the plan arrays its counterpart reads (the host planners of
// sparsex_tpu_torch, copies of the reference's, build them).  All are
// gathers with little or no reuse, so each is bound by device-memory bytes
// and latency, not by arithmetic; the first versions keep every
// intermediate either in registers or in one shared-memory stage and read x
// through L2.
//
// Numerics: the only arithmetic is K1's one multiply (plus the run styles'
// sliding lane sums) and K3's sums.  The
// explicit __fmul_rn / __fadd_rn (and double) intrinsics keep nvcc from
// contracting a multiply and an add into an FMA, so the sums round exactly
// as the plain PyTorch versions and the Pallas kernels round them, in the
// same order.
//
// Interface: plain C launchers (loaded with ctypes), one per kernel and
// value type.  Each launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_pipeline.h>
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
// K1 (replaces fused.py:_build_k1, all four styles).  Every element (t, s, l)
// of the (T, 8, 128) tile grid carries low = mg & 0x3FFF, its offset in the
// tile's x window, and reads one x value, by one of two addressing modes:
//   lane-placed (lp, rlp{W}; q = q8, plo counts q8-page blocks): the element
//     sits at its x lane l: x2[plo[t]*q8 + (low >> 3), low & 7, l], 0 where
//     the page low >> 3 is outside the window (q8 == 1: the window is one
//     page and the page bits are ignored, as in the Pallas kernel);
//   dense tile (sl, run{W}; q pages, plo counts pages): the element may sit
//     at any lane: x2flat[plo[t]*1024 + low], 0 where the sublane low >> 7 is
//     8q or more.  low has 14 bits, so q <= 16.
// A q = 32 window is 128 KB of f32 (256 KB of f64), more than a block's
// shared memory, so x is read through L2 rather than staged.
// ---------------------------------------------------------------------------
template <bool DENSE>
__device__ __forceinline__ long long k1_x_index(const int32_t* __restrict__ plo,
                                                long long row, int low, int l,
                                                int q) {
  if (DENSE) {
    if ((low >> 7) >= 8 * q) return -1;
    return (long long)plo[row >> 3] * 1024 + low;
  }
  const int pg = low >> 3;
  if (q != 1 && pg >= q) return -1;
  const long long page = (long long)plo[row >> 3] * q + (q == 1 ? 0 : pg);
  return ((page << 3) + (low & 7)) * L + l;
}

// Style sl, the SpMV form: one thread per output element, which forms only
// the product its G1 wire routes there (no product is formed twice):
//   g1 = (mg[t,s,l] >> 16) - 1;  out = g1 < 0 ? 0 : x[t,s,g1] * vals[t,s,g1]
// Bound by the bytes of mg, vals and out (12 B a slot in f32) plus the x
// window, read through L2.  (lp runs k1_slot in both forms, and sl's kb
// form the warp-per-row picking body k1_pick_kb; both below.)
template <typename T>
__device__ __forceinline__ void k1_route(const int32_t* __restrict__ plo,
                                         const int32_t* __restrict__ mg,
                                         const T* __restrict__ vals,
                                         const T* __restrict__ x2,
                                         T* __restrict__ out, long long n_elems,
                                         int q) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const long long row = e >> 7;            // t * 8 + s
  const int g1 = (int)(((uint32_t)mg[e]) >> 16) - 1;
  T r = T(0);
  if (g1 >= 0) {
    const long long src = (row << 7) + g1;
    const long long i = k1_x_index<true>(plo, row, mg[src] & 0x3FFF, g1, q);
    if (i >= 0) r = mul_rn(x2[i], vals[src]);
  }
  out[e] = r;
}

template <typename T>
__global__ void k1_sl_kernel(const int32_t* __restrict__ plo,
                             const int32_t* __restrict__ mg,
                             const T* __restrict__ vals,
                             const T* __restrict__ x2,
                             T* __restrict__ out, long long n_elems, int q) {
  k1_route<T>(plo, mg, vals, x2, out, n_elems, q);
}

// Styles rlp{W} and run{W}: horizontal runs of width W (W divides 128) sit
// in W-lane slots of a row: W-aligned mod-128 slots for rlp, lanes
// [uW, uW+W) for run.  Every lane holds its product p[l] (0 outside the
// window), then log2(W) CIRCULAR roll-right adds, p[l] += p[(l - d) & 127]
// for d = 1, 2, 4, .. < W, leave each run's total at its last lane (rlp arcs
// that wrap lane 127 -> 0 sum correctly because the roll is circular; the
// run style's lanes below W - 1 hold wrapped values that no wire reads), and
// the G1 wires route the totals: out[l] = g1 < 0 ? 0 : p[g1].
// One 128-thread group per (tile, sublane) row computes each product once
// into shared memory, where a per-output gather (k1_route) would recompute
// up to W products per lane.  Like k1_route it is bound by the bytes of mg,
// vals, out and the x window; the adds keep the Pallas kernel's order, so
// the result is bit-equal to it.
// ---------------------------------------------------------------------------
constexpr int K1_ROWS = 2;       // (tile, sublane) rows per run-style block

template <typename T, bool DENSE>
__device__ __forceinline__ void k1_roll(const int32_t* __restrict__ plo,
                                        const int32_t* __restrict__ mg,
                                        const T* __restrict__ vals,
                                        const T* __restrict__ x2,
                                        T* __restrict__ out, int q, int W) {
  __shared__ T p[K1_ROWS][L];
  const int r = threadIdx.x >> 7;
  const int l = threadIdx.x & (L - 1);
  const long long row = (long long)blockIdx.x * K1_ROWS + r;   // t * 8 + s
  const long long e = (row << 7) + l;
  const int m = mg[e];
  const long long i = k1_x_index<DENSE>(plo, row, m & 0x3FFF, l, q);
  T acc = mul_rn(i >= 0 ? x2[i] : T(0), vals[e]);
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

template <typename T>
__global__ void k1_rlp_kernel(const int32_t* __restrict__ plo,
                              const int32_t* __restrict__ mg,
                              const T* __restrict__ vals,
                              const T* __restrict__ x2,
                              T* __restrict__ out, int q8, int W) {
  k1_roll<T, false>(plo, mg, vals, x2, out, q8, W);
}

template <typename T>
__global__ void k1_run_kernel(const int32_t* __restrict__ plo,
                              const int32_t* __restrict__ mg,
                              const T* __restrict__ vals,
                              const T* __restrict__ x2,
                              T* __restrict__ out, int q, int W) {
  k1_roll<T, true>(plo, mg, vals, x2, out, q, W);
}

// ---------------------------------------------------------------------------
// T1 (replaces fused.py:_build_t1; t1_kb_kernel below, the same over kb x A2R
// blocks, replaces its kb > 0 form).  (A2R*128, 128) -> (A2R, 128, 128),
// block a = A1[a*128:(a+1)*128].T.  It only moves data, so what bounds it is
// device-memory bytes: each 64 KB (f32) / 128 KB (f64) block is read once and
// written once, and a launch (A2R <= 128 blocks, at most 16 MB in and out)
// is short enough that the whole input can be in flight at once.
//
// A block of T1_THREADS threads takes 32 input rows of one 128 x 128 block
// (so A2R = 110 gives 440 blocks, about 3 a SM): each thread loads its
// 32 / GROUPS rows of one 16-byte vector (V = 4 f32 / 2 f64
// columns) at once, a warp's lanes spanning a 512-byte input row a load;
// it turns each V x V sub-block around in registers and stores it as V
// 16-byte vectors into a shared tile held output-row-major; one barrier;
// then each 16-byte vector of an output row segment (32 values) is
// read back and written out with a streaming store, a warp's lanes covering
// whole 128-byte lines (4 rows of 128 bytes in f32, 2 of 256 in f64).  Both
// shared-memory passes are free of bank conflicts: a vector's slot in its
// row is XOR-swizzled by (row / V) & 7, so the 8 lanes of a quarter-warp,
// which hit 8 rows on the way in and 8 slots of one row on the way out,
// always take 8 different 16-byte bank groups.  Stores that leave a warp
// as 16 bytes to each of 32 rows (a transpose in registers alone, or after
// a 1-D bulk copy of the rows) took 1.4 to 2.1 times the old kernel's time;
// the streaming stores cut the fs-block path's T1 by a fifth (PERF.md §6).
// The launchers refuse in / out off a 16-byte boundary (CUDA error 1).
// ---------------------------------------------------------------------------
constexpr int T1_THREADS = 256;

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename T>
struct T1Tile {
  static constexpr int ROWS = 32;                    // input rows a block
  static constexpr int V = 16 / (int)sizeof(T);      // values a vector
  static constexpr int LANES = L / V;                // vectors an input row
  static constexpr int CH = ROWS / V;                // vectors an output row
  static constexpr int GROUPS = T1_THREADS / LANES;  // threads down a column
  static constexpr int RT = ROWS / GROUPS;           // input rows a thread
  static constexpr int OUT = L * CH / T1_THREADS;    // vectors a thread writes
  static constexpr int PARTS = L / ROWS;             // blocks a 128-row block
  static_assert(CH >= 8 && RT % V == 0 && OUT * T1_THREADS == L * CH, "");
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double comp(const double2& v, int i) {
  return i == 0 ? v.x : v.y;
}
// Component i of V consecutive vectors (V rows of a V x V sub-block): one
// vector of output row i.
__device__ __forceinline__ float4 column(const float4* v, int i) {
  return make_float4(comp(v[0], i), comp(v[1], i), comp(v[2], i),
                     comp(v[3], i));
}
__device__ __forceinline__ double2 column(const double2* v, int i) {
  return make_double2(comp(v[0], i), comp(v[1], i));
}

// Block blockIdx.x takes input rows [part * ROWS, (part + 1) * ROWS) of the
// 128 x 128 block blockIdx.x / PARTS.
template <typename T>
__device__ __forceinline__ void t1_body(const T* __restrict__ in,
                                        T* __restrict__ out) {
  using S = T1Tile<T>;
  using Vec = typename Vec16<T>::type;
  __shared__ Vec tile[L * S::CH];     // [output row c][swizzled vector]
  const long long base = (long long)(blockIdx.x / S::PARTS) * TILE3;
  const int j0 = (blockIdx.x % S::PARTS) * S::ROWS;
  const int lane = threadIdx.x % S::LANES;
  const int g = threadIdx.x / S::LANES;
  const Vec* src = reinterpret_cast<const Vec*>(
                       in + base + (long long)(j0 + g * S::RT) * L) + lane;
  Vec v[S::RT];
#pragma unroll
  for (int r = 0; r < S::RT; ++r) v[r] = src[r * S::LANES];
#pragma unroll
  for (int b = 0; b < S::RT / S::V; ++b) {
    const int q = g * (S::RT / S::V) + b;           // vector in the row
#pragma unroll
    for (int i = 0; i < S::V; ++i) {
      const int c = lane * S::V + i;                // output row
      tile[c * S::CH + (q ^ ((c / S::V) & 7))] = column(v + b * S::V, i);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < S::OUT; ++k) {
    const int o = k * T1_THREADS + threadIdx.x;
    const int c = o / S::CH, q = o % S::CH;
    __stcs(reinterpret_cast<Vec*>(out + base + (long long)c * L + j0) + q,
           tile[c * S::CH + (q ^ ((c / S::V) & 7))]);
  }
}

template <typename T>
__global__ void __launch_bounds__(T1_THREADS)
    t1_kernel(const T* __restrict__ in, T* __restrict__ out) {
  t1_body<T>(in, out);
}

// ---------------------------------------------------------------------------
// K2 (replaces fused.py:_build_k2, kb = 0 and kb > 0).  Per outer colour c,
// from RAW g2b wires (the port removes the lane offset that the unmasked
// Pallas kernel bakes in):
//   C1[b, w]   = a = g2a[c,b,w];  a >= 0 ? A1T[b, c, a] : 0
//   D1[w, d]   = b = g2b[c,w,d];  0 <= b < A2R ? C1[b, w] : 0
//   E1[c,d,l]  = g = g2c[c,d,l];  0 <= g < W2 ? D1[g, d] : 0
// Only moves data, so it is bit-equal to k2_plain.  One block per (colour,
// K2_ROWS output rows d): it resolves the D1 entries its rows read, D1[w, d]
// for w < W2, straight through g2b -> g2a -> A1T (C1 is never formed: an
// entry of C1 that no D1 entry selects is never read, and a block needs no
// row of D1 but its own), into shared memory, then writes its rows of E1,
// 4 adjacent lanes a thread: one 4-byte load of g2c wires, 4 shared-memory
// reads, one 16-byte (f32) or two (f64) stores.  A block per colour would
// give 128 blocks to 132 SMs, each serialising a C1 stage and its outputs
// behind one barrier; here D2R = 128 gives 2048 blocks of 256 threads, up to
// 8 resident per SM, each with at most 4 independent three-load chains a
// thread.  A1T (<= 8 MB f32) stays in L2 between the blocks of a colour.
// What bounds it now is L2 sectors: each D1 entry gathers one g2a byte and
// one A1T value at data-dependent places, a 32-byte sector each.  A
// cluster of 8 blocks per colour that builds C1 once from whole A1T rows
// and reads it through distributed shared memory reads no scattered sector,
// but ran 2.7x slower on the H100 (its phases are long dependent chains
// behind two cluster barriers), and blocks of 16 rows that stage the
// colour's g2a wires (16 KB) in shared memory ran 1.26x slower (PERF.md,
// section 6).  A k-batched A1T (kb columns, k-major)
// resolves each wire chain once and reads kb values through it, and writes
// kb columns of E1 through the same g2c wires.
// Shared memory: kb x K2_ROWS x (W2 + pad) values, at most 66 KB in f64.
// ---------------------------------------------------------------------------
constexpr int K2_ROWS = 8;           // output rows d per block
constexpr int K2_THREADS = 256;      // K2_ROWS x 32 threads x 4 lanes
constexpr int K2_STRIDE = L + 4;     // D1 row stride: a warp's stores of 8
                                     // rows x 4 w hit 32 banks (f32)
constexpr int K2_ROUNDS = L * K2_ROWS / K2_THREADS;   // D1 entries a thread

template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&v)[4]);

template <>
__device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store4<double>(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(K2_THREADS)
    k2_kernel(const T* __restrict__ a1t, const int8_t* __restrict__ g2a,
              const int8_t* __restrict__ g2b, const int8_t* __restrict__ g2c,
              T* __restrict__ e1, int A2R, int W2, int D2R, int kb) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  T* d1 = reinterpret_cast<T*>(k2_smem);   // [kb][K2_ROWS][K2_STRIDE]
  const int c = blockIdx.y;
  const int d0 = blockIdx.x * K2_ROWS;
  const int nd = min(K2_ROWS, D2R - d0);
  const int8_t* gb = g2b + (size_t)c * W2 * L + d0;
  const int8_t* ga = g2a + (size_t)c * A2R * L;
  // entry i = w * K2_ROWS + dd: a warp reads 4 w rows of 8 adjacent g2b
  // wires; the chains of a thread's K2_ROUNDS entries are independent
  int b[K2_ROUNDS];
#pragma unroll
  for (int r = 0; r < K2_ROUNDS; ++r) {
    const int i = r * K2_THREADS + threadIdx.x;
    const int w = i / K2_ROWS, dd = i % K2_ROWS;
    b[r] = (w < W2 && dd < nd) ? (int)gb[(size_t)w * L + dd] : -1;
  }
  long long src[K2_ROUNDS];
#pragma unroll
  for (int r = 0; r < K2_ROUNDS; ++r) {
    const int w = (r * K2_THREADS + threadIdx.x) / K2_ROWS;
    src[r] = -1;
    if (b[r] >= 0 && b[r] < A2R) {
      const int a = ga[b[r] * L + w];
      if (a >= 0) src[r] = ((long long)b[r] * L + c) * L + a;
    }
  }
  const size_t a1c = (size_t)A2R * L * L;          // A1T values per column
  for (int k = 0; k < kb; ++k) {
#pragma unroll
    for (int r = 0; r < K2_ROUNDS; ++r) {
      const int i = r * K2_THREADS + threadIdx.x;
      const int w = i / K2_ROWS, dd = i % K2_ROWS;
      if (w < W2)
        d1[(k * K2_ROWS + dd) * K2_STRIDE + w] =
            src[r] >= 0 ? a1t[k * a1c + src[r]] : T(0);
    }
  }
  __syncthreads();
  const int dd = threadIdx.x / 32;
  if (dd >= nd) return;
  const int l = (threadIdx.x % 32) * 4;
  const size_t o = ((size_t)c * D2R + d0 + dd) * L + l;
  const char4 gq = *reinterpret_cast<const char4*>(g2c + o);
  const int g[4] = {gq.x, gq.y, gq.z, gq.w};
  const size_t e1c = (size_t)L * D2R * L;          // E1 values per column
  for (int k = 0; k < kb; ++k) {
    const T* row = d1 + (k * K2_ROWS + dd) * K2_STRIDE;
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = (g[j] >= 0 && g[j] < W2) ? row[g[j]] : T(0);
    store4(e1 + k * e1c + o, v);
  }
}

// ---------------------------------------------------------------------------
// K3 (replaces fused.py:_build_k3: the kb = 0 pallas_call at :1556 with
// k3_kernel, the kb > 0 one at :1545 with k3_kb_kernel).  Row
// i*16384 + p*128 + l of y, for destination block i, row strip p, lane l:
//   y = sum_inst sum_k (g = g3[i,k,p,l]) >= 0 ? E1[g, i, p] : 0
//     + sum_d dv[i,d,p,l] * x[row + off_d] + sum_a adv[i,a,p,l] * xr[row + aoff_a]
// x reads outside [0, nx) give 0, where the Pallas kernel reads a clamped
// block and relies on dv being 0.
//
// Bound: bytes (chip_smoke._bound_k3): each E1, g3, dv, adv and x block
// read once and y written once, E1, x and y once per column; on blocky
// 2^21 (six instances, about 21 wires a row) 102 MB, about 31 us of HBM.
//
// Design (both forms share k3_body).  A block owns destination block i and
// a band of K3_BAND = 16 adjacent strips (D2R x 8 blocks of 512 threads):
// warp w owns strip p0 + w, lane j its lanes 4j..4j+3, so every g3 wire
// load is one 4-byte word a thread and one 128-byte line a warp, and every
// dv and y access a 16-byte vector.  Per instance s, and per column c in
// the kb form, the block gathers from the tile E1[s][c][:, i, p0:p0+16]:
// 128 row segments of 64 B (f32) / 128 B (f64), each contiguous, so E1
// crosses HBM and L2 as whole sectors and every value once (the kb = 0
// kernel of PR 1 read one 4-byte value per 32-byte sector and left the
// other 7/8 to L2).  The tiles (s, c) stream, in that order, through a
// ring of 4 (SpMV) or 8 (kb) shared-memory stages filled by 16-byte
// asynchronous copies (cp.async, one or two a thread a tile): the copies
// of tile t + STAGES - 1 are in flight while tile t is gathered from, one
// barrier a tile.  A tile keeps E1's row-major layout, se[g][pp], its rows
// padded to 16-byte boundaries (20 f32 / 18 f64 values), so that a warp's
// 32 wires of one strip fall on 8 banks (f32) and the gathers conflict a
// few ways; a tile landed transposed, se[pp][g] (the Pallas kernel's
// VMEM slab transpose), spreads them over all banks but needs 4-8-byte
// element copies, and measured 1.4-1.6x slower in the f32 kb form
// (PERF.md, section 6).  A thread loads its K <= 8 wires of an instance once into
// registers and applies them to every column, so g3 is read once a block
// in both forms (the kb kernel of PR 5 read it again for every column and
// waited at two barriers a column with its loads not overlapped).
//
// Order of the sums, per column: instances in order, k in order, then the
// diagonals, then the anti-diagonals, with add_rn / mul_rn, so column c of
// k3_kb_kernel is bit-equal to k3_kernel on column c.
// ---------------------------------------------------------------------------
constexpr int K3_BAND = 16;                  // row strips per block
constexpr int K3_THREADS = K3_BAND * 32;     // a warp per strip
constexpr int K3_LANES = L / 32;             // lanes (y rows) per thread
constexpr int MAX_K = 8;         // g3 wires per instance (route max_k)

// ring stages: the SpMV runs 3-4 blocks an SM, the kb form 1-2 (its kb x 4
// running sums a thread), which keep more tiles in flight instead
template <int KB>
__host__ __device__ constexpr int k3_stages() { return KB > 1 ? 8 : 4; }

// a tile row: K3_BAND values padded by 16 bytes, so that each row starts on
// a 16-byte boundary (the copies' alignment) and row g + 1 on other banks
template <typename T>
__host__ __device__ constexpr int k3_row() { return K3_BAND + 16 / (int)sizeof(T); }

template <typename T>
__host__ __device__ constexpr size_t k3_smem_bytes(int stages) {
  return (size_t)stages * L * k3_row<T>() * sizeof(T);
}

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
__device__ __forceinline__ void load4(T (&v)[4], const T* p);

template <>
__device__ __forceinline__ void load4<float>(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <>
__device__ __forceinline__ void load4<double>(double (&v)[4], const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// total[c][r] += vals[r] * xs_c[j0 + r] for the kb columns (x read as 0
// outside [0, nx)): one diagonal of the DIA part.
template <typename T, int KB>
__device__ __forceinline__ void k3_window(T (&total)[KB][K3_LANES],
                                          const T (&vals)[K3_LANES],
                                          const T* __restrict__ xs,
                                          long long j0, long long nx, int kb,
                                          long long col) {
#pragma unroll
  for (int c = 0; c < KB; ++c) {
    if (c < kb) {
#pragma unroll
      for (int r = 0; r < K3_LANES; ++r) {
        const long long j = j0 + r;
        const T xv = (j >= 0 && j < nx) ? xs[c * col + j] : T(0);
        total[c][r] = add_rn(total[c][r], mul_rn(vals[r], xv));
      }
    }
  }
}

// One block of either form; KB = 1 is the SpMV (kb = 1, no column
// strides), KB = MAX_KB the k-batched kernel with kb <= KB columns.
template <typename T, int KB>
__device__ __forceinline__ void k3_body(const K3Args& a, int kb, long long xs,
                                        long long xrs, T* __restrict__ y) {
  constexpr int STAGES = k3_stages<KB>();
  constexpr int ROW = k3_row<T>();
  constexpr int TILE = L * ROW;
  extern __shared__ __align__(16) unsigned char k3_ring[];
  T* ring = reinterpret_cast<T*>(k3_ring);   // [STAGES][L][ROW]
  const int i = blockIdx.x / (L / K3_BAND);
  const int p0 = (blockIdx.x % (L / K3_BAND)) * K3_BAND;
  const int strip = threadIdx.x / 32;
  const int l0 = (threadIdx.x % 32) * K3_LANES;
  const int p = p0 + strip;
  const size_t e1c = (size_t)L * a.D2R * L;           // E1 values per column
  const int n_tiles = a.n_inst * kb;

  // tile t = s * kb + c: E1[s][c][g, i, p0 + pp] -> ring[t % STAGES][g][pp];
  // one commit group per tile (empty past the last), so that waiting for
  // all but the newest STAGES - 2 groups waits for tile t
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int s = t / kb;
      const T* src = static_cast<const T*>(a.e1[s]) + (t - s * kb) * e1c +
                     (size_t)i * L + p0;
      T* dst = ring + (t % STAGES) * TILE;
      constexpr int V = 16 / sizeof(T);
#pragma unroll
      for (int m = 0; m < L * K3_BAND / V / K3_THREADS; ++m) {
        const int e = m * K3_THREADS + threadIdx.x;
        const int g = e / (K3_BAND / V), pp = (e % (K3_BAND / V)) * V;
        __pipeline_memcpy_async(dst + g * ROW + pp,
                                src + (size_t)g * a.D2R * L + pp, 16);
      }
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  T total[KB][K3_LANES];
#pragma unroll
  for (int c = 0; c < KB; ++c)
#pragma unroll
    for (int r = 0; r < K3_LANES; ++r) total[c][r] = T(0);
  int t = 0;
  for (int s = 0; s < a.n_inst; ++s) {
    const int K = a.K[s];
    const int8_t* g = a.g3[s] + ((size_t)i * K * L + p) * L + l0;
    uint32_t wires[MAX_K];           // 4 int8 wires (lanes l0..l0+3) per k
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      wires[k] = k < K ? *reinterpret_cast<const uint32_t*>(g + (size_t)k * L * L)
                       : 0u;
#pragma unroll
    for (int c = 0; c < KB; ++c) {
      if (c < kb) {                  // uniform over the block: the barrier holds
        __pipeline_wait_prior(STAGES - 2);
        __syncthreads();             // tile t landed; tile t - 1's stage is free
        issue(t + STAGES - 1);
        const T* se = ring + (t % STAGES) * TILE + strip;
#pragma unroll
        for (int k = 0; k < MAX_K; ++k) {
          if (k < K) {
#pragma unroll
            for (int r = 0; r < K3_LANES; ++r) {
              const int w = (int)(int8_t)(wires[k] >> (8 * r));
              total[c][r] = add_rn(total[c][r], w >= 0 ? se[w * ROW] : T(0));
            }
          }
        }
        ++t;
      }
    }
  }
  const long long row = (long long)i * TILE3 + p * L + l0;
  for (int d = 0; d < a.nd; ++d) {
    T v[K3_LANES];
    load4(v, static_cast<const T*>(a.dv) + (((size_t)i * a.nd + d) * L + p) * L + l0);
    k3_window<T, KB>(total, v, static_cast<const T*>(a.x), row + a.doff[d],
                     a.nx, kb, xs);
  }
  for (int d = 0; d < a.na; ++d) {
    T v[K3_LANES];
    load4(v, static_cast<const T*>(a.adv) + (((size_t)i * a.na + d) * L + p) * L + l0);
    k3_window<T, KB>(total, v, static_cast<const T*>(a.xr), row + a.aoff[d],
                     a.nx, kb, xrs);
  }
  const long long yc = (long long)a.D2R * TILE3;      // y values per column
#pragma unroll
  for (int c = 0; c < KB; ++c)
    if (c < kb) store4(y + c * yc + row, total[c]);
}

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
    k3_kernel(K3Args a, T* __restrict__ y) {
  k3_body<T, 1>(a, 1, 0, 0, y);
}

// ===========================================================================
// The k-batched (SpMM) variants: kb <= MAX_KB columns of x per launch, x
// and every output k-major (column c at c * its column stride).  Each
// replaces the kb > 0 pallas_call of the same builder (fused.py:1063/:1098
// K1, :1343 T1, :1545 K3; K2's, :1282, is k2_kernel above with kb > 1).
// On the TPU the k axis is the
// innermost grid axis and Mosaic's revisit optimisation keeps the metadata
// blocks in VMEM across it; a CUDA grid has no revisit, so here a block
// reads its metadata once (K1: mg/vals, K2: its wire chains, K3: its g3
// wires, dv and adv) and loops over the kb columns itself.  K1's run
// styles and sl take a warp per (tile, sublane) row (the rolling body
// k1_roll_kb, the picking body k1_pick_kb); lp takes a thread per slot and
// a tile per block (k1_slot, which with two rows a block also serves lp's
// SpMV form).
// Bound: the metadata bytes once plus kb x (the x values the slots read +
// the output).  Column c is computed with the same intrinsics in the same
// order as the kb = 1 kernel, so it is bit-equal to it; per-column values
// live in MAX_KB-wide register arrays under fully unrolled `c < kb` loops.
// ===========================================================================
constexpr int MAX_KB = 8;        // columns per launch (exec.MM_FUSED_KB)

// K1 rlp{W} / run{W}, k-batched: the products, circular roll and G1 route
// of k1_roll, column by column, with a warp per (tile, sublane) row.  Lane
// i of the warp holds the row's lanes l = 4i + j (j < 4), so mg and vals
// load, and each column's outputs store, as 16-byte vectors (a warp
// writes 512 contiguous bytes a column in f32).  mg and vals are read
// once and the output is read by the next kernel, so both stream past the
// caches (__ldcs / __stcs) and leave L1 and L2 to the x windows.  The roll
// pass of distance d adds lane l - d to lane l in registers: for d = 1
// and 2 a thread adds its own register j - d, and only registers j < d
// take register j - d + 4 of lane i - 1 (mod 32, one __shfl_sync each);
// for d >= 4 every register takes the same register of lane i - d/4 (mod
// 32).  These are k1_roll's adds, operand for operand, so column c is
// bit-equal to the kb = 1 kernel, with no block barrier.  The G1 route
// (p[g1], any lane) goes through a warp-private shared-memory row, two of
// them in turn so that one __syncwarp a column suffices.
// What bounds it is the latency of the chain mg -> x -> roll -> store and
// the gather's L2 sectors (a row's runs fall on rows of the window far
// apart, one sector each per column), not the bytes: so a thread keeps
// one column's 4 products at a time (43 registers in f32, 60 in f64) and
// the SM as many warps as it holds; larger column groups, or a block's
// tiles that share a window walked column by column, cost more in
// occupancy than they saved (PERF.md).  os = T * 1024.
// ---------------------------------------------------------------------------
constexpr int K1KB_WARPS = 8;                 // rows (warps) a block: a tile
constexpr int K1KB_THREADS = K1KB_WARPS * 32;

template <typename T>
__device__ __forceinline__ void load4_cs(T (&v)[4], const T* p);

template <>
__device__ __forceinline__ void load4_cs<float>(float (&v)[4],
                                                const float* p) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <>
__device__ __forceinline__ void load4_cs<double>(double (&v)[4],
                                                 const double* p) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T>
__device__ __forceinline__ void store4_cs(T* p, const T (&v)[4]);

template <>
__device__ __forceinline__ void store4_cs<float>(float* p,
                                                 const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

template <>
__device__ __forceinline__ void store4_cs<double>(double* p,
                                                  const double (&v)[4]) {
  __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcs(reinterpret_cast<double2*>(p) + 1, make_double2(v[2], v[3]));
}

template <typename T, bool DENSE>
__device__ __forceinline__ void k1_roll_kb(const int32_t* __restrict__ plo,
                                           const int32_t* __restrict__ mg,
                                           const T* __restrict__ vals,
                                           const T* __restrict__ x2,
                                           T* __restrict__ out, int q, int W,
                                           int kb, long long xs, long long os,
                                           long long n_rows) {
  constexpr unsigned FULL = 0xffffffffu;
  __shared__ __align__(16) T g[K1KB_WARPS][2][L];
  const int w = threadIdx.x >> 5;
  const int i = threadIdx.x & 31;
  const int up = (i - 1) & 31;
  const long long row = (long long)blockIdx.x * K1KB_WARPS + w;  // t * 8 + s
  if (row >= n_rows) return;                  // a whole warp: no barrier
  const long long e = (row << 7) + 4 * i;
  const int4 m4 = __ldcs(reinterpret_cast<const int4*>(mg + e));
  const int m[4] = {m4.x, m4.y, m4.z, m4.w};
  T v[4];
  load4_cs(v, vals + e);
  int xi[4];                     // x index in a column (< xs < 2^31), or -1
#pragma unroll
  for (int j = 0; j < 4; ++j)
    xi[j] = (int)k1_x_index<DENSE>(plo, row, m[j] & 0x3FFF, 4 * i + j, q);
  for (int c = 0; c < kb; ++c) {
    T p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[j] = mul_rn(xi[j] >= 0 ? x2[c * xs + xi[j]] : T(0), v[j]);
#pragma unroll
    for (int d = 1; d < L; d <<= 1) {
      if (d >= W) break;
      T s[4];
      if (d < 4) {                            // lane i - 1's top d registers
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[j] = j < d ? __shfl_sync(FULL, p[(j - d) & 3], up) : p[j - d];
      } else {
        const int src = (i - (d >> 2)) & 31;
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = __shfl_sync(FULL, p[j], src);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) p[j] = add_rn(p[j], s[j]);
    }
    T* r = g[w][c & 1];
    store4(r + 4 * i, p);
    __syncwarp();
    T o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int g1 = (int)(((uint32_t)m[j]) >> 16) - 1;
      o[j] = g1 >= 0 ? r[g1 & (L - 1)] : T(0);
    }
    store4_cs(out + c * os + e, o);
  }
}

template <typename T>
__global__ void __launch_bounds__(K1KB_THREADS)
    k1_rlp_kb_kernel(const int32_t* __restrict__ plo,
                     const int32_t* __restrict__ mg,
                     const T* __restrict__ vals, const T* __restrict__ x2,
                     T* __restrict__ out, int q8, int W, int kb, long long xs,
                     long long os, long long n_rows) {
  k1_roll_kb<T, false>(plo, mg, vals, x2, out, q8, W, kb, xs, os, n_rows);
}

template <typename T>
__global__ void __launch_bounds__(K1KB_THREADS)
    k1_run_kb_kernel(const int32_t* __restrict__ plo,
                     const int32_t* __restrict__ mg,
                     const T* __restrict__ vals, const T* __restrict__ x2,
                     T* __restrict__ out, int q, int W, int kb, long long xs,
                     long long os, long long n_rows) {
  k1_roll_kb<T, true>(plo, mg, vals, x2, out, q, W, kb, xs, os, n_rows);
}

// K1 sl, k-batched: the row layout of k1_roll_kb (a warp per (tile,
// sublane) row, thread i on lanes 4i..4i+3, 16-byte mg / vals / out
// streams), with the G1 route taken before the products.  The row's mg
// and vals go through the warp's shared rows once; each lane then picks
// the window offset and value of the slot g1 its wire names and, column
// by column, forms that one product and stores it.  So a column is x
// gathers, multiplies and a 16-byte store, with no shared memory or
// __syncwarp in it, and only routed slots read x (an unrouted slot is
// +0, a routed one past the window 0 x v, as k1_plain gives).  The
// one-thread-one-slot kernel it replaced waited on a chain of three
// dependent loads (mg, then mg and vals at the routed lane, then x) and
// moved 4 bytes an instruction.  k1_roll_kb at W = 1 (a product for every
// slot, routed through shared memory each column) was slower, most in f64;
// the streaming output stores take most of the time (PERF.md).  For lp
// this body was slower than k1_slot (PERF.md).  os = T * 1024.
template <typename T>
__device__ __forceinline__ void k1_pick_kb(const int32_t* __restrict__ plo,
                                           const int32_t* __restrict__ mg,
                                           const T* __restrict__ vals,
                                           const T* __restrict__ x2,
                                           T* __restrict__ out, int q, int kb,
                                           long long xs, long long os,
                                           long long n_rows) {
  __shared__ __align__(16) int32_t gm[K1KB_WARPS][L];
  __shared__ __align__(16) T gv[K1KB_WARPS][L];
  const int w = threadIdx.x >> 5;
  const int i = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * K1KB_WARPS + w;  // t * 8 + s
  if (row >= n_rows) return;                  // a whole warp: no barrier
  const long long e = (row << 7) + 4 * i;
  const int4 m4 = __ldcs(reinterpret_cast<const int4*>(mg + e));
  T v[4];
  load4_cs(v, vals + e);
  *reinterpret_cast<int4*>(&gm[w][4 * i]) = m4;
  store4(&gv[w][4 * i], v);
  __syncwarp();
  const int m[4] = {m4.x, m4.y, m4.z, m4.w};
  int xi[4];          // x index in a column (< xs < 2^31); -1 past the window
  bool routed[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int g1 = (int)(((uint32_t)m[j]) >> 16) - 1;
    routed[j] = g1 >= 0;
    const int src = g1 & (L - 1);
    xi[j] = routed[j] ? (int)k1_x_index<true>(plo, row, gm[w][src] & 0x3FFF,
                                              src, q)
                      : -1;
    v[j] = routed[j] ? gv[w][src] : T(0);
  }
  for (int c = 0; c < kb; ++c) {
    T o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = routed[j] ? mul_rn(xi[j] >= 0 ? x2[c * xs + xi[j]] : T(0), v[j])
                       : T(0);
    store4_cs(out + c * os + e, o);
  }
}

template <typename T>
__global__ void __launch_bounds__(K1KB_THREADS)
    k1_sl_kb_kernel(const int32_t* __restrict__ plo,
                    const int32_t* __restrict__ mg,
                    const T* __restrict__ vals, const T* __restrict__ x2,
                    T* __restrict__ out, int q, int kb, long long xs,
                    long long os, long long n_rows) {
  k1_pick_kb<T>(plo, mg, vals, x2, out, q, kb, xs, os, n_rows);
}

// K1 lp, both forms: a thread per slot, R (tile, sublane) rows a block.
// The block's mg and vals rows come in as 16-byte streams (__ldcs) into
// shared memory (the first R warps load mg, the next R vals), then, after
// one __syncthreads, each thread picks the window offset and value of the
// slot g1 its wire names from shared memory (lp's lane-placed x index: the
// source lane g1 is the x lane), issues the x loads of all kb columns at
// once and stores its products with streaming stores; a warp's stores are
// 32 contiguous values a column.  Only routed slots read x (an unrouted
// slot is +0, a routed one past the window 0 x v, as k1_plain gives).
// Staging the rows spares the chain of three dependent global loads (mg,
// then mg and vals at the routed lane, then x).  The x gathers bound it:
// each is one L2 sector for one value, so what counts is how many are in
// flight (kb a thread, at full occupancy) and how many hit L1.  A tile's
// 8 rows read one window, about one x sector for every three routed
// slots, so the kb form takes a whole tile a block (R = 8) and the SpMV
// form, whose small launches want more blocks, two rows (R = 2).  The
// warp-per-row bodies (k1_pick_kb, and k1_roll_kb at W = 1) were slower
// here: a thread's 4 slots cut the loads in flight, or their registers
// the occupancy (PERF.md).  I is the x index's type: int where the
// launcher has checked that a column holds fewer than 2^31 values (kb
// form), else long long.  os = T * 1024.
template <typename T, typename I, int R>
__device__ __forceinline__ void k1_slot(const int32_t* __restrict__ plo,
                                        const int32_t* __restrict__ mg,
                                        const T* __restrict__ vals,
                                        const T* __restrict__ x2,
                                        T* __restrict__ out, int q8, int kb,
                                        long long xs, long long os) {
  __shared__ __align__(16) int32_t sm[R][L];
  __shared__ __align__(16) T sv[R][L];
  const int w = threadIdx.x >> 5;
  const int i = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * R;  // R divides T * 8
  if (w < R) {
    *reinterpret_cast<int4*>(&sm[w][4 * i]) = __ldcs(
        reinterpret_cast<const int4*>(mg + ((row0 + w) << 7) + 4 * i));
  } else if (w < 2 * R) {
    T v[4];
    load4_cs(v, vals + ((row0 + w - R) << 7) + 4 * i);
    store4(&sv[w - R][4 * i], v);
  }
  __syncthreads();
  const int r = threadIdx.x >> 7;
  const int l = threadIdx.x & (L - 1);
  const long long row = row0 + r;                   // t * 8 + s
  const int g1 = (int)(((uint32_t)sm[r][l]) >> 16) - 1;
  I xi = -1;                                       // -1: past the window
  T v = T(0);
  if (g1 >= 0) {
    xi = (I)k1_x_index<false>(plo, row, sm[r][g1] & 0x3FFF, g1, q8);
    v = sv[r][g1];
  }
  T xv[MAX_KB];
#pragma unroll
  for (int c = 0; c < MAX_KB; ++c)
    xv[c] = c < kb && xi >= 0 ? x2[c * xs + xi] : T(0);
  const long long e = (row << 7) + l;
#pragma unroll
  for (int c = 0; c < MAX_KB; ++c)
    if (c < kb) __stcs(out + c * os + e, g1 >= 0 ? mul_rn(xv[c], v) : T(0));
}

constexpr int K1LP_ROWS = 2;     // lp SpMV: (tile, sublane) rows a block
constexpr int K1LP_KB_ROWS = 8;  // lp kb: a tile a block

template <typename T>
__global__ void __launch_bounds__(K1LP_ROWS * L)
    k1_lp_kernel(const int32_t* __restrict__ plo,
                 const int32_t* __restrict__ mg, const T* __restrict__ vals,
                 const T* __restrict__ x2, T* __restrict__ out, int q8) {
  k1_slot<T, long long, K1LP_ROWS>(plo, mg, vals, x2, out, q8, 1, 0, 0);
}

template <typename T>
__global__ void __launch_bounds__(K1LP_KB_ROWS * L)
    k1_lp_kb_kernel(const int32_t* __restrict__ plo,
                    const int32_t* __restrict__ mg,
                    const T* __restrict__ vals, const T* __restrict__ x2,
                    T* __restrict__ out, int q8, int kb, long long xs,
                    long long os) {
  k1_slot<T, int, K1LP_KB_ROWS>(plo, mg, vals, x2, out, q8, kb, xs, os);
}

// T1: no metadata, so the k axis folds into the blocks: the kb x A2R input
// blocks are contiguous, block c * A2R + a.
template <typename T>
__global__ void __launch_bounds__(T1_THREADS)
    t1_kb_kernel(const T* __restrict__ in, T* __restrict__ out) {
  t1_body<T>(in, out);
}

// K3: k3_body over kb columns (above): the tiles of every column of an
// instance stream through the ring in turn, against the same wires in
// registers; each dv / adv value is read once and applied to all kb column
// sums.  xs / xrs: values per column of the x / reversed-x blocks.
struct K3KbArgs {
  K3Args a;
  int kb;
  long long xs;
  long long xrs;
};

template <typename T>
__global__ void __launch_bounds__(K3_THREADS)
    k3_kb_kernel(K3KbArgs b, T* __restrict__ y) {
  k3_body<T, MAX_KB>(b.a, b.kb, b.xs, b.xrs, y);
}

// The checks of the K1 launchers that stream mg and vals as 16-byte
// vectors (every kb form, lp's SpMV form): mg, vals and out on 16-byte
// boundaries (one contract for all of them, though lp stores its outputs
// one value at a time), 32-bit x indexes in a column (xs values; lp's
// SpMV form passes 0 and indexes in 64 bits).
int k1_row_refused(const void* mg, const void* vals, const void* out,
                   bool dense, int q, int kb, long long xs) {
  if (q < 1 || (dense && q > 16) || kb < 1 || kb > MAX_KB ||
      (((uintptr_t)mg | (uintptr_t)vals | (uintptr_t)out) & 15) ||
      xs > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch_k1_lp(const void* plo, const void* mg, const void* vals,
                 const void* x2, void* out, long long n_tiles, int q8,
                 void* stream) {
  if (int err = k1_row_refused(mg, vals, out, false, q8, 1, 0)) return err;
  const long long blocks = n_tiles * 8 / K1LP_ROWS;
  if (blocks == 0) return (int)cudaGetLastError();
  k1_lp_kernel<T><<<(unsigned)blocks, K1LP_ROWS * L, 0,
                    (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int32_t*)mg, (const T*)vals, (const T*)x2,
      (T*)out, q8);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k1_sl(const void* plo, const void* mg, const void* vals,
                 const void* x2, void* out, long long n_tiles, int q,
                 void* stream) {
  if (q < 1 || q > 16) return (int)cudaErrorInvalidValue;
  const long long n = n_tiles * 8 * L;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  k1_sl_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int32_t*)mg, (const T*)vals,
      (const T*)x2, (T*)out, n, q);
  return (int)cudaGetLastError();
}

template <typename T, bool DENSE>
int launch_k1_roll(const void* plo, const void* mg, const void* vals,
                   const void* x2, void* out, long long n_tiles, int q, int W,
                   void* stream) {
  if (W < 2 || W > L || (W & (W - 1))) return (int)cudaErrorInvalidValue;
  if (q < 1 || (DENSE && q > 16)) return (int)cudaErrorInvalidValue;
  const long long blocks = n_tiles * 8 / K1_ROWS;   // 8 rows per tile
  if (blocks == 0) return (int)cudaGetLastError();
  if (DENSE)
    k1_run_kernel<T><<<(unsigned)blocks, K1_ROWS * L, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)plo, (const int32_t*)mg, (const T*)vals,
        (const T*)x2, (T*)out, q, W);
  else
    k1_rlp_kernel<T><<<(unsigned)blocks, K1_ROWS * L, 0,
                       (cudaStream_t)stream>>>(
        (const int32_t*)plo, (const int32_t*)mg, (const T*)vals,
        (const T*)x2, (T*)out, q, W);
  return (int)cudaGetLastError();
}

// T1's arguments: A2R >= 1 blocks (kb times, 1 <= kb <= MAX_KB), in and
// out on 16-byte boundaries for the kernel's vectors.
int t1_refused(const void* in, const void* out, int A2R, int kb) {
  if (A2R < 1 || kb < 1 || kb > MAX_KB ||
      (((uintptr_t)in | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch_t1(const void* in, void* out, int A2R, void* stream) {
  if (int err = t1_refused(in, out, A2R, 1)) return err;
  t1_kernel<T><<<A2R * T1Tile<T>::PARTS, T1_THREADS, 0,
                 (cudaStream_t)stream>>>((const T*)in, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k2(const void* a1t, const void* g2a, const void* g2b, const void* g2c,
              void* e1, int A2R, int W2, int D2R, int kb, void* stream) {
  if (A2R < 1 || A2R > L || W2 < 1 || W2 > L || D2R < 1 || D2R > L ||
      kb < 1 || kb > MAX_KB)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kb * K2_ROWS * K2_STRIDE * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        k2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((D2R + K2_ROWS - 1) / K2_ROWS, L);
  k2_kernel<T><<<grid, K2_THREADS, smem, (cudaStream_t)stream>>>(
      (const T*)a1t, (const int8_t*)g2a, (const int8_t*)g2b,
      (const int8_t*)g2c, (T*)e1, A2R, W2, D2R, kb);
  return (int)cudaGetLastError();
}

// K3's arguments, checked: at most MAX_INST instances of at most MAX_K
// wires; E1 (16-byte copies), g3 (4 wires at a time), dv and adv (16-byte
// vectors) aligned for the kernel's loads.
int k3_args(K3Args& a, const void* const* e1, const void* const* g3,
            const int* K, int n_inst, const void* dv, const void* doff,
            int nd, const void* adv, const void* aoff, int na, const void* x,
            const void* xr, long long nx, int D2R) {
  if (n_inst < 0 || n_inst > MAX_INST || D2R < 1 ||
      ((uintptr_t)dv & 15) || ((uintptr_t)adv & 15))
    return (int)cudaErrorInvalidValue;
  a = K3Args{};
  for (int s = 0; s < n_inst; ++s) {
    if (K[s] < 0 || K[s] > MAX_K || ((uintptr_t)e1[s] & 15) ||
        ((uintptr_t)g3[s] & 3))
      return (int)cudaErrorInvalidValue;
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
  return 0;
}

// Both K3 kernels take 512 threads a block and dynamic shared memory
// beyond 48 KB in f64 (and in the kb form's f32).
template <typename Kernel>
int k3_allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
int launch_k3(const void* const* e1, const void* const* g3, const int* K,
              int n_inst, const void* dv, const void* doff, int nd,
              const void* adv, const void* aoff, int na, const void* x,
              const void* xr, long long nx, int D2R, void* y, void* stream) {
  K3Args a;
  int err = k3_args(a, e1, g3, K, n_inst, dv, doff, nd, adv, aoff, na, x, xr,
                    nx, D2R);
  const size_t smem = k3_smem_bytes<T>(k3_stages<1>());
  if (!err) err = k3_allow_smem(k3_kernel<T>, smem);
  if (err) return err;
  k3_kernel<T><<<D2R * (L / K3_BAND), K3_THREADS, smem,
                 (cudaStream_t)stream>>>(a, (T*)y);
  return (int)cudaGetLastError();
}

// --- the k-batched launchers (kb = 1 .. MAX_KB) ---------------------------

template <typename T>
int launch_k1_lp_kb(const void* plo, const void* mg, const void* vals,
                    const void* x2, void* out, long long n_tiles, int q8,
                    int kb, long long xs, void* stream) {
  if (int err = k1_row_refused(mg, vals, out, false, q8, kb, xs)) return err;
  const long long blocks = n_tiles * 8 / K1LP_KB_ROWS;
  if (blocks == 0) return (int)cudaGetLastError();
  k1_lp_kb_kernel<T><<<(unsigned)blocks, K1LP_KB_ROWS * L, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int32_t*)mg, (const T*)vals, (const T*)x2,
      (T*)out, q8, kb, xs, n_tiles * 8 * L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k1_sl_kb(const void* plo, const void* mg, const void* vals,
                    const void* x2, void* out, long long n_tiles, int q,
                    int kb, long long xs, void* stream) {
  if (int err = k1_row_refused(mg, vals, out, true, q, kb, xs)) return err;
  const long long n_rows = n_tiles * 8;
  const long long blocks = (n_rows + K1KB_WARPS - 1) / K1KB_WARPS;
  if (blocks == 0) return (int)cudaGetLastError();
  k1_sl_kb_kernel<T><<<(unsigned)blocks, K1KB_THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)plo, (const int32_t*)mg, (const T*)vals, (const T*)x2,
      (T*)out, q, kb, xs, n_rows * L, n_rows);
  return (int)cudaGetLastError();
}

template <typename T, bool DENSE>
int launch_k1_roll_kb(const void* plo, const void* mg, const void* vals,
                      const void* x2, void* out, long long n_tiles, int q,
                      int W, int kb, long long xs, void* stream) {
  if (W < 2 || W > L || (W & (W - 1))) return (int)cudaErrorInvalidValue;
  if (int err = k1_row_refused(mg, vals, out, DENSE, q, kb, xs)) return err;
  const long long n_rows = n_tiles * 8;
  const long long blocks = (n_rows + K1KB_WARPS - 1) / K1KB_WARPS;
  if (blocks == 0) return (int)cudaGetLastError();
  const long long os = n_rows * L;
  if (DENSE)
    k1_run_kb_kernel<T><<<(unsigned)blocks, K1KB_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)plo, (const int32_t*)mg, (const T*)vals,
        (const T*)x2, (T*)out, q, W, kb, xs, os, n_rows);
  else
    k1_rlp_kb_kernel<T><<<(unsigned)blocks, K1KB_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const int32_t*)plo, (const int32_t*)mg, (const T*)vals,
        (const T*)x2, (T*)out, q, W, kb, xs, os, n_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t1_kb(const void* in, void* out, int A2R, int kb, void* stream) {
  if (int err = t1_refused(in, out, A2R, kb)) return err;
  t1_kb_kernel<T><<<kb * A2R * T1Tile<T>::PARTS, T1_THREADS, 0,
                    (cudaStream_t)stream>>>((const T*)in, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k3_kb(const void* const* e1, const void* const* g3, const int* K,
                 int n_inst, const void* dv, const void* doff, int nd,
                 const void* adv, const void* aoff, int na, const void* x,
                 const void* xr, long long nx, int D2R, void* y, int kb,
                 long long xs, long long xrs, void* stream) {
  if (kb < 1 || kb > MAX_KB) return (int)cudaErrorInvalidValue;
  K3KbArgs b;
  int err = k3_args(b.a, e1, g3, K, n_inst, dv, doff, nd, adv, aoff, na, x,
                    xr, nx, D2R);
  b.kb = kb;
  b.xs = xs;
  b.xrs = xrs;
  const size_t smem = k3_smem_bytes<T>(k3_stages<MAX_KB>());
  if (!err) err = k3_allow_smem(k3_kb_kernel<T>, smem);
  if (err) return err;
  k3_kb_kernel<T><<<D2R * (L / K3_BAND), K3_THREADS, smem,
                    (cudaStream_t)stream>>>(b, (T*)y);
  return (int)cudaGetLastError();
}

}  // namespace

#define SPX_FUSED_LAUNCHERS(SFX, T)                                            \
  extern "C" int spx_k1_##SFX(const void* plo, const void* mg,                 \
                              const void* vals, const void* x2, void* out,     \
                              long long n_tiles, int q8, void* stream) {       \
    return launch_k1_lp<T>(plo, mg, vals, x2, out, n_tiles, q8, stream);       \
  }                                                                            \
  extern "C" int spx_k1_sl_##SFX(const void* plo, const void* mg,              \
                                 const void* vals, const void* x2, void* out,  \
                                 long long n_tiles, int q, void* stream) {     \
    return launch_k1_sl<T>(plo, mg, vals, x2, out, n_tiles, q, stream);        \
  }                                                                            \
  extern "C" int spx_k1_rlp_##SFX(const void* plo, const void* mg,             \
                                  const void* vals, const void* x2, void* out, \
                                  long long n_tiles, int q8, int W,            \
                                  void* stream) {                              \
    return launch_k1_roll<T, false>(plo, mg, vals, x2, out, n_tiles, q8, W,    \
                                    stream);                                   \
  }                                                                            \
  extern "C" int spx_k1_run_##SFX(const void* plo, const void* mg,             \
                                  const void* vals, const void* x2, void* out, \
                                  long long n_tiles, int q, int W,             \
                                  void* stream) {                              \
    return launch_k1_roll<T, true>(plo, mg, vals, x2, out, n_tiles, q, W,      \
                                   stream);                                    \
  }                                                                            \
  extern "C" int spx_t1_##SFX(const void* in, void* out, int A2R,              \
                              void* stream) {                                  \
    return launch_t1<T>(in, out, A2R, stream);                                 \
  }                                                                            \
  extern "C" int spx_k2_##SFX(const void* a1t, const void* g2a,                \
                              const void* g2b, const void* g2c, void* e1,      \
                              int A2R, int W2, int D2R, void* stream) {        \
    return launch_k2<T>(a1t, g2a, g2b, g2c, e1, A2R, W2, D2R, 1, stream);      \
  }                                                                            \
  extern "C" int spx_k3_##SFX(const void* const* e1, const void* const* g3,    \
                              const int* K, int n_inst, const void* dv,        \
                              const void* doff, int nd, const void* adv,       \
                              const void* aoff, int na, const void* x,         \
                              const void* xr, long long nx, int D2R, void* y,  \
                              void* stream) {                                  \
    return launch_k3<T>(e1, g3, K, n_inst, dv, doff, nd, adv, aoff, na, x, xr, \
                        nx, D2R, y, stream);                                   \
  }                                                                            \
  extern "C" int spx_k1_kb_##SFX(const void* plo, const void* mg,              \
                                 const void* vals, const void* x2, void* out,  \
                                 long long n_tiles, int q8, int kb,            \
                                 long long xs, void* stream) {                 \
    return launch_k1_lp_kb<T>(plo, mg, vals, x2, out, n_tiles, q8, kb, xs,     \
                              stream);                                         \
  }                                                                            \
  extern "C" int spx_k1_sl_kb_##SFX(const void* plo, const void* mg,           \
                                    const void* vals, const void* x2,          \
                                    void* out, long long n_tiles, int q,       \
                                    int kb, long long xs, void* stream) {      \
    return launch_k1_sl_kb<T>(plo, mg, vals, x2, out, n_tiles, q, kb, xs,      \
                              stream);                                         \
  }                                                                            \
  extern "C" int spx_k1_rlp_kb_##SFX(const void* plo, const void* mg,          \
                                     const void* vals, const void* x2,         \
                                     void* out, long long n_tiles, int q8,     \
                                     int W, int kb, long long xs,              \
                                     void* stream) {                           \
    return launch_k1_roll_kb<T, false>(plo, mg, vals, x2, out, n_tiles, q8, W, \
                                       kb, xs, stream);                        \
  }                                                                            \
  extern "C" int spx_k1_run_kb_##SFX(const void* plo, const void* mg,          \
                                     const void* vals, const void* x2,         \
                                     void* out, long long n_tiles, int q,      \
                                     int W, int kb, long long xs,              \
                                     void* stream) {                           \
    return launch_k1_roll_kb<T, true>(plo, mg, vals, x2, out, n_tiles, q, W,   \
                                      kb, xs, stream);                         \
  }                                                                            \
  extern "C" int spx_t1_kb_##SFX(const void* in, void* out, int A2R, int kb,   \
                                 void* stream) {                               \
    return launch_t1_kb<T>(in, out, A2R, kb, stream);                          \
  }                                                                            \
  extern "C" int spx_k2_kb_##SFX(const void* a1t, const void* g2a,             \
                                 const void* g2b, const void* g2c, void* e1,   \
                                 int A2R, int W2, int D2R, int kb,             \
                                 void* stream) {                               \
    return launch_k2<T>(a1t, g2a, g2b, g2c, e1, A2R, W2, D2R, kb, stream);     \
  }                                                                            \
  extern "C" int spx_k3_kb_##SFX(                                              \
      const void* const* e1, const void* const* g3, const int* K, int n_inst,  \
      const void* dv, const void* doff, int nd, const void* adv,               \
      const void* aoff, int na, const void* x, const void* xr, long long nx,   \
      int D2R, void* y, int kb, long long xs, long long xrs, void* stream) {   \
    return launch_k3_kb<T>(e1, g3, K, n_inst, dv, doff, nd, adv, aoff, na, x,  \
                           xr, nx, D2R, y, kb, xs, xrs, stream);               \
  }

SPX_FUSED_LAUNCHERS(f32, float)
SPX_FUSED_LAUNCHERS(f64, double)

extern "C" const char* spx_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
