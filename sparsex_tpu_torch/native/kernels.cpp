// sparsex_tpu_torch native host kernels: the port's own copy of
// sparsex_tpu/native/kernels.cpp, unchanged below this header.
//
// The compiled host-side machinery of the preprocessing pipeline
// (EncodingManager's DRLE scan, include/sparsex/internals/
// EncodingManager.hpp:1321-1487), the streaming MMF parser
// (src/internals/Mmf.cpp:27-79), the bipartite edge colouring of the route
// planner and the multithreaded CSR baseline used for result cross-checks.
// The SpMV itself runs on the GPU (csrc/*.cu); this library speeds up what
// runs on the host: parsing, mining, packing and planning.
//
// Exposed with a plain C ABI and loaded from Python via ctypes
// (sparsex_tpu_torch/native/__init__.py); every entry point has a NumPy
// fallback so the library remains optional.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// MMF body parsing
// ---------------------------------------------------------------------------
// Parse up to `max_entries` whitespace-separated coordinate lines from the
// text buffer [buf, buf+len).  Lines starting with '%' and blank lines are
// skipped.  When with_vals == 0 (MatrixMarket `pattern` field) only two
// integers per entry are read and vals is untouched.  Returns the number of
// entries parsed, or -(1 + byte_offset) on a malformed token.
long long spx_parse_mmf_body(const char *buf, long long len,
                             long long max_entries, int with_vals,
                             long long *rows, long long *cols, double *vals) {
  const char *p = buf;
  const char *end = buf + len;
  long long n = 0;
  // Line discipline: each entry must occupy exactly one line with exactly
  // 2 (pattern) or 3 (real) fields — a 2-column line in a 'real' file must
  // be rejected, not re-tokenized across lines.
  auto skip_spaces = [&]() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  };
  while (p < end && n < max_entries) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
    if (p >= end) break;
    if (*p == '%') {  // comment line
      while (p < end && *p != '\n') ++p;
      continue;
    }
    const char *line_start = p;
    char *next = nullptr;
    long long r = std::strtoll(p, &next, 10);
    if (next == p) return -(1 + (long long)(line_start - buf));
    p = next;
    skip_spaces();
    if (p >= end || *p == '\n')  // missing column field
      return -(1 + (long long)(line_start - buf));
    long long c = std::strtoll(p, &next, 10);
    if (next == p) return -(1 + (long long)(line_start - buf));
    p = next;
    double v = 1.0;
    if (with_vals) {
      skip_spaces();
      if (p < end && *p == '\n')  // missing value column
        return -(1 + (long long)(line_start - buf));
      v = std::strtod(p, &next);
      if (next == p) return -(1 + (long long)(line_start - buf));
      p = next;
    }
    skip_spaces();
    if (p < end && *p != '\n')  // extra tokens on the line
      return -(1 + (long long)(line_start - buf));
    rows[n] = r;
    cols[n] = c;
    if (with_vals) vals[n] = v;
    ++n;
  }
  // trailing content check: anything left that is not whitespace/comment?
  while (p < end) {
    if (*p == '%') {
      while (p < end && *p != '\n') ++p;
    } else if (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') {
      ++p;
    } else {
      break;  // extra entries beyond max_entries: caller decides
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// DRLE segment scan (the mining hot loop)
// ---------------------------------------------------------------------------
// Given lexsorted (trows, tcols), emit maximal runs of a constant column
// delta within each row: run k starts at delta-index j0[k] (element index of
// the first *delta* element is j0[k]+1), spans f[k] deltas of value delta[k],
// and adjacent[k] != 0 when the run immediately follows the previous run.
// Mirrors sparsex_tpu.preprocess.mining._segment_runs (itself the vectorized
// form of the reference's per-element RLE scan, EncodingManager.hpp:475-502).
// Output arrays must have room for m-1 entries.  Returns the run count.
long long spx_segment_runs(const long long *trows, const long long *tcols,
                           long long m, long long *j0, long long *f,
                           long long *delta, unsigned char *adjacent) {
  if (m < 2) return 0;
  long long nruns = 0;
  long long run_start = -1;
  long long run_delta = 0;
  long long prev_end = -2;  // delta-index one past the previous run
  for (long long j = 0; j < m - 1; ++j) {
    bool valid = trows[j + 1] == trows[j];
    long long d = tcols[j + 1] - tcols[j];
    if (valid && run_start >= 0 && d == run_delta) continue;  // extend
    if (run_start >= 0) {  // close current run
      j0[nruns] = run_start;
      f[nruns] = j - run_start;
      delta[nruns] = run_delta;
      adjacent[nruns] = (unsigned char)(run_start == prev_end);
      prev_end = j;
      ++nruns;
      run_start = -1;
    }
    if (valid) {
      run_start = j;
      run_delta = d;
    }
  }
  if (run_start >= 0) {
    j0[nruns] = run_start;
    f[nruns] = (m - 1) - run_start;
    delta[nruns] = run_delta;
    adjacent[nruns] = (unsigned char)(run_start == prev_end);
    ++nruns;
  }
  return nruns;
}

// ---------------------------------------------------------------------------
// Coordinate lexsort (row-major) — the Transform hot path
// ---------------------------------------------------------------------------
// Writes the permutation that sorts (rows, cols) lexicographically into
// `order`.  LSD radix sort over the packed 128-bit (row, col) key, 16 bits
// per pass, skipping passes whose key bytes are constant; multithreaded
// histogramming.  Equivalent to np.lexsort((cols, rows)).
static void radix_pass(const uint64_t *keys, const long long *src,
                       long long *dst, long long m, int shift) {
  long long count[65536] = {0};
  for (long long i = 0; i < m; ++i)
    ++count[(keys[src[i]] >> shift) & 0xffff];
  long long pos = 0;
  for (int b = 0; b < 65536; ++b) {
    long long c = count[b];
    count[b] = pos;
    pos += c;
  }
  for (long long i = 0; i < m; ++i) {
    uint64_t b = (keys[src[i]] >> shift) & 0xffff;
    dst[count[b]++] = src[i];
  }
}

void spx_lexsort_rc(const long long *rows, const long long *cols, long long m,
                    long long *order) {
  if (m <= 0) return;
  long long rmax = 0, cmax = 0;
  for (long long i = 0; i < m; ++i) {
    if (rows[i] > rmax) rmax = rows[i];
    if (cols[i] > cmax) cmax = cols[i];
  }
  int cbits = 1, rbits = 1;
  while ((1LL << cbits) <= cmax && cbits < 63) ++cbits;
  while ((1LL << rbits) <= rmax && rbits < 63) ++rbits;
  if (rbits + cbits <= 64) {
    std::vector<uint64_t> keys(m);
    for (long long i = 0; i < m; ++i)
      keys[i] = ((uint64_t)rows[i] << cbits) | (uint64_t)cols[i];
    std::vector<long long> tmp(m);
    long long *src = order, *dst = tmp.data();
    for (long long i = 0; i < m; ++i) order[i] = i;
    int total_bits = rbits + cbits;
    for (int shift = 0; shift < total_bits; shift += 16) {
      radix_pass(keys.data(), src, dst, m, shift);
      std::swap(src, dst);
    }
    if (src != order) std::memcpy(order, src, m * sizeof(long long));
  } else {
    for (long long i = 0; i < m; ++i) order[i] = i;
    std::sort(order, order + m, [&](long long a, long long b) {
      if (rows[a] != rows[b]) return rows[a] < rows[b];
      return cols[a] < cols[b];
    });
  }
}

// ---------------------------------------------------------------------------
// Multithreaded CSR SpMV (host baseline / oracle)
// ---------------------------------------------------------------------------
// y = alpha * A * x + beta * y.  Row-parallel over nthreads std::threads,
// each thread owning a contiguous nnz-balanced row range (the reference's
// ThreadPool row partition, src/internals/CsxKernels.cpp:35-55).  Serves as
// the fast independent-implementation baseline the bench tool cross-checks
// against (the reference compares vs MKL at 1e-7, src/bench/Bench.cpp:256).
void spx_csr_spmv_f64(long long nrows, const long long *rowptr,
                      const int *colind, const double *vals, const double *x,
                      double alpha, double beta, double *y, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  long long nnz = rowptr[nrows];
  auto worker = [&](long long r0, long long r1) {
    for (long long r = r0; r < r1; ++r) {
      double acc = 0.0;
      for (long long k = rowptr[r]; k < rowptr[r + 1]; ++k)
        acc += vals[k] * x[colind[k]];
      y[r] = alpha * acc + beta * y[r];
    }
  };
  if (nthreads == 1 || nrows < 2 * nthreads) {
    worker(0, nrows);
    return;
  }
  // nnz-balanced split (ref SparseInternal.hpp:117-152)
  std::vector<long long> bounds(nthreads + 1, 0);
  bounds[nthreads] = nrows;
  long long target = 0, r = 0;
  for (int t = 1; t < nthreads; ++t) {
    target = nnz * t / nthreads;
    while (r < nrows && rowptr[r] < target) ++r;
    bounds[t] = r;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back(worker, bounds[t], bounds[t + 1]);
  for (auto &th : threads) th.join();
}

// float32 variant (same structure).
void spx_csr_spmv_f32(long long nrows, const long long *rowptr,
                      const int *colind, const float *vals, const float *x,
                      float alpha, float beta, float *y, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  long long nnz = rowptr[nrows];
  auto worker = [&](long long r0, long long r1) {
    for (long long r = r0; r < r1; ++r) {
      float acc = 0.0f;
      for (long long k = rowptr[r]; k < rowptr[r + 1]; ++k)
        acc += vals[k] * x[colind[k]];
      y[r] = alpha * acc + beta * y[r];
    }
  };
  if (nthreads == 1 || nrows < 2 * nthreads) {
    worker(0, nrows);
    return;
  }
  std::vector<long long> bounds(nthreads + 1, 0);
  bounds[nthreads] = nrows;
  long long target = 0, r = 0;
  for (int t = 1; t < nthreads; ++t) {
    target = nnz * t / nthreads;
    while (r < nrows && rowptr[r] < target) ++r;
    bounds[t] = r;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back(worker, bounds[t], bounds[t + 1]);
  for (auto &th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Pattern-run coverage expansion
// ---------------------------------------------------------------------------
// Given selected runs (start_elem, count) over m sorted elements, set
// covered[i] = 1 for every element inside a run.  Replaces the NumPy
// diff/cumsum trick with a direct scan (used on large matrices where the
// temporary arrays dominate).
void spx_mark_covered(const long long *start_elem, const long long *count,
                      long long nruns, long long m, unsigned char *covered) {
  std::memset(covered, 0, (size_t)m);
  for (long long k = 0; k < nruns; ++k) {
    long long s = start_elem[k];
    long long e = s + count[k];
    if (s < 0) s = 0;
    if (e > m) e = m;
    for (long long i = s; i < e; ++i) covered[i] = 1;
  }
}

// ---------------------------------------------------------------------------
// Threaded permutation (apply a sort order to data arrays)
// ---------------------------------------------------------------------------
// dst[i] = src[order[i]] for arbitrary element size; row-parallel.  NumPy
// fancy indexing is single-threaded (~60 ns/elem on 8-byte data); the
// preprocessing pipeline applies each lexsort order to 3+ arrays, so this
// is one of its hottest loops.
void spx_permute(const char *src, char *dst, const long long *order,
                 long long n, long long elem_size, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto worker = [&](long long i0, long long i1) {
    switch (elem_size) {
      case 4: {
        const int32_t *s = (const int32_t *)src;
        int32_t *d = (int32_t *)dst;
        for (long long i = i0; i < i1; ++i) d[i] = s[order[i]];
        break;
      }
      case 8: {
        const int64_t *s = (const int64_t *)src;
        int64_t *d = (int64_t *)dst;
        for (long long i = i0; i < i1; ++i) d[i] = s[order[i]];
        break;
      }
      default:
        for (long long i = i0; i < i1; ++i)
          std::memcpy(dst + i * elem_size, src + order[i] * elem_size,
                      (size_t)elem_size);
    }
  };
  if (nthreads == 1 || n < 1 << 16) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> threads;
  long long per = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    long long i0 = t * per;
    long long i1 = std::min(n, i0 + per);
    if (i0 < i1) threads.emplace_back(worker, i0, i1);
  }
  for (auto &th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Pattern-unit value padding (the extraction hot loop)
// ---------------------------------------------------------------------------
// padded[u, j] = vals[heads[u] + j] for j < sizes[u], else 0 — builds the
// zero-padded (U, W) unit value table in one threaded pass (NumPy needs a
// (U, W) index matrix + where(mask), ~3 temporaries of U*W elements).
void spx_pad_units_f32(const float *vals, const long long *heads,
                       const long long *sizes, long long nunits,
                       long long width, float *padded, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto worker = [&](long long u0, long long u1) {
    for (long long u = u0; u < u1; ++u) {
      float *dst = padded + u * width;
      const float *src = vals + heads[u];
      long long s = sizes[u];
      if (s > width) s = width;
      std::memcpy(dst, src, (size_t)s * sizeof(float));
      if (s < width) std::memset(dst + s, 0, (size_t)(width - s) * sizeof(float));
    }
  };
  if (nthreads == 1 || nunits < 1024) {
    worker(0, nunits);
    return;
  }
  std::vector<std::thread> threads;
  long long per = (nunits + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    long long u0 = t * per, u1 = std::min(nunits, u0 + per);
    if (u0 < u1) threads.emplace_back(worker, u0, u1);
  }
  for (auto &th : threads) th.join();
}

void spx_pad_units_f64(const double *vals, const long long *heads,
                       const long long *sizes, long long nunits,
                       long long width, double *padded, int nthreads) {
  if (nthreads < 1) nthreads = 1;
  auto worker = [&](long long u0, long long u1) {
    for (long long u = u0; u < u1; ++u) {
      double *dst = padded + u * width;
      const double *src = vals + heads[u];
      long long s = sizes[u];
      if (s > width) s = width;
      std::memcpy(dst, src, (size_t)s * sizeof(double));
      if (s < width) std::memset(dst + s, 0, (size_t)(width - s) * sizeof(double));
    }
  };
  if (nthreads == 1 || nunits < 1024) {
    worker(0, nunits);
    return;
  }
  std::vector<std::thread> threads;
  long long per = (nunits + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    long long u0 = t * per, u1 = std::min(nunits, u0 + per);
    if (u0 < u1) threads.emplace_back(worker, u0, u1);
  }
  for (auto &th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Run -> pattern-unit selection (the second half of the mining hot loop)
// ---------------------------------------------------------------------------
// Consumes spx_segment_runs output and applies the selection rules of the
// reference miner (EncodingManager.hpp:1321-1408): eligibility by delta,
// the absorb-previous-element rule (resolved sequentially: a run of
// f == min_limit-1 deltas becomes a pattern only when it can claim its
// anchor, i.e. the adjacent previous run is not itself a pattern), and
// splitting long runs into units of <= max_limit elements with
// sub-min_limit remainders returned to singles.  Emits unit heads/sizes/
// deltas and the element coverage mask in one pass.
long long spx_select_units(const long long *j0, const long long *f,
                           const long long *delta,
                           const unsigned char *adjacent, long long nruns,
                           long long m, long long min_limit,
                           long long max_limit,
                           const long long *allowed, long long n_allowed,
                           long long *heads, long long *sizes,
                           long long *udelta, unsigned char *covered) {
  std::memset(covered, 0, (size_t)m);
  long long nu = 0;
  bool prev_pattern = false;
  long long cert_min = min_limit > 2 ? min_limit : 2;
  for (long long k = 0; k < nruns; ++k) {
    bool eligible = delta[k] > 0;
    if (eligible && allowed != nullptr) {
      // allowed is sorted; binary search
      long long lo = 0, hi = n_allowed;
      while (lo < hi) {
        long long mid = (lo + hi) / 2;
        if (allowed[mid] < delta[k]) lo = mid + 1; else hi = mid;
      }
      eligible = lo < n_allowed && allowed[lo] == delta[k];
    }
    bool adj = adjacent[k] != 0;
    bool pattern;
    if (eligible && f[k] >= cert_min) {
      pattern = true;
    } else if (eligible && f[k] == min_limit - 1 && f[k] >= 2) {
      pattern = !(adj && prev_pattern);
    } else {
      pattern = false;
    }
    if (!pattern) {
      prev_pattern = false;
      continue;
    }
    bool absorbed = !(adj && prev_pattern);
    long long start = j0[k] + 1 - (absorbed ? 1 : 0);
    long long count = f[k] + (absorbed ? 1 : 0);
    long long nfull = count / max_limit;
    long long rem = count % max_limit;
    long long covered_count = nfull * max_limit
        + (rem >= min_limit ? rem : 0);
    long long pos = start;
    for (long long u = 0; u < nfull; ++u) {
      heads[nu] = pos;
      sizes[nu] = max_limit;
      udelta[nu] = delta[k];
      ++nu;
      pos += max_limit;
    }
    if (rem >= min_limit) {
      heads[nu] = pos;
      sizes[nu] = rem;
      udelta[nu] = delta[k];
      ++nu;
    }
    if (covered_count > 0) {
      long long e0 = start, e1 = start + covered_count;
      if (e0 < 0) e0 = 0;
      if (e1 > m) e1 = m;
      for (long long i = e0; i < e1; ++i) covered[i] = 1;
      prev_pattern = true;
    } else {
      // nothing actually encoded (run shorter than a unit): not a pattern
      prev_pattern = false;
    }
  }
  return nu;
}

// ---------------------------------------------------------------------------
// Bipartite multigraph edge coloring (Konig / Euler-split)
// ---------------------------------------------------------------------------
// Proper edge coloring of a bipartite multigraph with W colors (W a power of
// two, max degree <= W), by recursive Euler partition: each level walks
// maximal trails (odd-degree starts first, then circuits) assigning edges
// alternately to two halves, so per-vertex degrees split ceil/floor; after
// log2(W) levels every class is a matching.  Used by ops/route.py to plan
// the static scatter-add routing network (the TPU-native replacement for
// the serialized y-scatter of the delta path; the role of the reference's
// sequential per-row ctl walk, src/templates/delta_tmpl.c:21-38, which a
// CPU can do in-order but a TPU cannot).
// Returns 0 on success, -1 on bad W, -2 if a degree exceeds W.
long long spx_color_bipartite(long long m, const long long *src,
                              const long long *dst, long long n_src,
                              long long n_dst, long long W,
                              long long *color_out) {
  if (W <= 0 || (W & (W - 1))) return -1;
  if (m == 0) return 0;
  if (m > 2000000000LL || n_src + n_dst > 2000000000LL) return -1;
  const int32_t n_nodes = (int32_t)(n_src + n_dst);
  const int32_t ns = (int32_t)n_src;

  // 32-bit edge endpoints (cache-friendly: the walk is random access).
  std::vector<int32_t> esrc(m), edst(m);
  for (long long i = 0; i < m; ++i) {
    esrc[i] = (int32_t)src[i];
    edst[i] = ns + (int32_t)dst[i];
  }

  // order[] holds edge ids grouped contiguously per color-range; ranges are
  // split in place level by level.
  std::vector<int32_t> order(m), tmp(m);
  for (long long i = 0; i < m; ++i) order[i] = (int32_t)i;
  std::vector<unsigned char> side(m);

  struct Range {
    int32_t lo, hi, color, width;
  };
  std::vector<Range> ranges{{0, (int32_t)m, 0, (int32_t)W}}, next;

  // Per-group scratch, reset via the touched list.
  std::vector<int32_t> deg(n_nodes, 0);
  std::vector<int32_t> aoff(n_nodes), aend(n_nodes), aptr(n_nodes);
  std::vector<int32_t> adj(2 * m);  // incident order-positions
  std::vector<int32_t> touched;
  std::vector<unsigned char> used(m);
  touched.reserve(1 << 12);

  bool first_level = true;
  while (!ranges.empty()) {
    next.clear();
    for (const Range &rg : ranges) {
      const int32_t lo = rg.lo, hi = rg.hi, mg = hi - lo;
      if (mg == 0) continue;
      if (rg.width == 1) {
        for (int32_t i = lo; i < hi; ++i) color_out[order[i]] = rg.color;
        continue;
      }
      // --- build adjacency over this group's edges ---
      touched.clear();
      int32_t maxdeg = 0;
      for (int32_t i = lo; i < hi; ++i) {
        int32_t e = order[i];
        int32_t u = esrc[e], v = edst[e];
        if (deg[u]++ == 0) touched.push_back(u);
        if (deg[v]++ == 0) touched.push_back(v);
        if (deg[u] > maxdeg) maxdeg = deg[u];
        if (deg[v] > maxdeg) maxdeg = deg[v];
      }
      if (first_level && maxdeg > W) {
        for (int32_t nd : touched) deg[nd] = 0;
        return -2;
      }
      if (maxdeg <= 1) {
        // already a matching: one color serves the whole group
        for (int32_t i = lo; i < hi; ++i) color_out[order[i]] = rg.color;
        for (int32_t nd : touched) deg[nd] = 0;
        continue;
      }
      int32_t cur = 0;
      for (int32_t nd : touched) {
        aoff[nd] = aptr[nd] = cur;
        cur += deg[nd];
        aend[nd] = cur;
      }
      for (int32_t i = lo; i < hi; ++i) {
        int32_t e = order[i];
        adj[aptr[esrc[e]]++] = i;
        adj[aptr[edst[e]]++] = i;
        used[i] = 0;
      }
      for (int32_t nd : touched) aptr[nd] = aoff[nd];

      // --- Euler partition: walk maximal trails, alternating sides ---
      auto walk = [&](int32_t start) {
        int32_t at = start;
        unsigned char s = 0;
        for (;;) {
          int32_t p = aptr[at];
          while (p < aend[at] && used[adj[p]]) ++p;
          aptr[at] = p;
          if (p == aend[at]) break;
          int32_t i = adj[p];
          used[i] = 1;
          side[i] = s;
          s ^= 1;
          int32_t e = order[i];
          at = (at == esrc[e]) ? edst[e] : esrc[e];
        }
      };
      for (int32_t nd : touched)
        if (deg[nd] & 1) walk(nd);
      for (int32_t nd : touched) walk(nd);  // remaining circuits

      // --- stable partition by side; recurse halves ---
      int32_t w0 = 0;
      for (int32_t i = lo; i < hi; ++i)
        if (side[i] == 0) tmp[lo + w0++] = order[i];
      int32_t w1 = w0;
      for (int32_t i = lo; i < hi; ++i)
        if (side[i] == 1) tmp[lo + w1++] = order[i];
      std::memcpy(&order[lo], &tmp[lo], mg * sizeof(int32_t));
      next.push_back({lo, lo + w0, rg.color, rg.width / 2});
      next.push_back({(int32_t)(lo + w0), hi,
                      (int32_t)(rg.color + rg.width / 2), rg.width / 2});

      for (int32_t nd : touched) deg[nd] = 0;
    }
    ranges.swap(next);
    first_level = false;
  }
  return 0;
}

int spx_native_abi_version() { return 5; }

}  // extern "C"
