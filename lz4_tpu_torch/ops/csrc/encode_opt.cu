// The OPT arm as three passes: level 12 (every position searched) and
// levels 10-11.
//
// Replaces the OPT arm `opt_body` of the TPU kernel `pallas_encode5`
// (lz4_tpu/ops/encode_pallas5.py:1172, inside `pallas_encode5`) and the OPT
// arm of `pallas_encode_stream` (lz4_tpu/ops/encode_pallas_stream.py:266);
// the nearest C text is `lz4tpu_encode_opt` (lz4_tpu/native/lz4tpu.c:1225).
// encode_stream.cu's `encode_windows_hc<true>` runs the same parse with its
// searches made one after another, one thread per row: the card's
// reference for these passes.
//
// Rows are the windows of kernel D (encode_stream.cu): row r is
// base[starts[r], starts[r] + lens[r]), its first src_offs[r] bytes a prefix
// that matches may reach.  The passes' tables hold every position of every
// row back to back: row r's position p is entry toff[r] + p.
//
// Why passes: the OPT arm inserts into its chain only up to the search
// position, so the search at p with a given minimum length is a function of
// the window, p and that length.  At level 12 every search is opt_find(p,
// 3); at levels 10-11 the parse asks for a match longer than last - cur,
// which its price table sets.  The serial arm makes the searches one after
// another on one thread per row (one CTA per SM for its 192 KB of shared
// memory: 132 threads for the card), each chain step a dependent read with
// no other warp to hide it.  Here:
// 1. opt_chain_rows: prev[p], the previous position of p's hash in the
//    row (kHcEmpty when none), for every p below n - 3.  One warp per row
//    walks it 32 positions at a time, the row's head table (128 KB) in
//    shared memory: lanes of one hash find their predecessor among the
//    lower lanes (__match_any_sync), the lowest of them in the head table,
//    and the highest writes the head back.  The exact prev, not the clamped
//    delta, because the head read at p needs the position; the delta a
//    chain step reads is min(q - prev[q], 0xFFFF), computed where it is
//    read.  Positions before the row's window are not in its table, so a
//    chained window's first positions end their chains as its ring does.
// 2. opt_matches_rows: every position's search, wider_match(p, p, 3,
//    pattern analysis, chain swap) over the tables with the level's depth,
//    one thread per position, 256 to a CTA and as many CTAs per SM as
//    registers allow: the dependent reads of many positions are in flight
//    at once.  Writes (length, offset), or (0, 0) when nothing is longer
//    than 3 bytes, for every position of the row (zeros outside the
//    searched span).  A search whose work passes its budget (BudgetChain:
//    chain steps plus bytes measured) gives up and writes (-1 - the longest
//    match it had found, 0): in a long repeat every position would measure
//    the whole repeat at every step, work that the serial parse, which
//    jumps over the repeat, never does.  Every search starts with a small
//    budget; one that gives up with no match longer than `retry_longest`
//    starts again with a large one (a longer match is a repeat the parse is
//    likely to jump over).
// 3. Level 12, opt_parse_rows: the price parse (lz4_hc_body.cuh opt_parse)
//    with its searches read from the table, and a search that gave up made
//    again in full on the spot (TableChain: any position's search needs
//    only the tables), one thread per row, a CTA each: only the 64 KB
//    price table is in shared memory, so three rows run per SM and 256
//    rows in one wave.
//    Levels 10-11, opt_parse_spec_rows: the same parse by one warp per row
//    (lz4_hc_body.cuh opt_parse_rounds), three rows per SM.  A search whose
//    minimum length is 3 or less reads the table (opt_find(p, m) equals
//    opt_find(p, 3) there); the others run on the lanes, each lane one of
//    the next <= 32 positions the parse does not skip, with the minimum
//    length the state gives it, and the warp commits them in order up to
//    the first that finds a match (a search that finds nothing changes no
//    state).  So a row's searches take as many dependent rounds as its
//    parse has matches, where the serial arm takes one per search.
//
// What bounds them: not bytes (the windows, 12 bytes of table per window
// byte and the output: ~0.1 ms per 16 MiB at 3.35 TB/s).  The chain pass is
// bound by its 32-position steps (~4,000 per 128 KB window); the match pass
// by the chain steps, about 5x the serial parse's at level 12 (it searches
// positions the parse skips), now spread over every SM, with warps held by
// their longest lane; the level 12 parse by its serial walk of the row;
// the level 10-11 parse by its rounds, each as long as its longest lane's
// search (up to the level's 96 or 512 chain steps).  The tables of a batch
// take 12 bytes per window byte of device memory; the wrapper processes
// rows in groups under a fixed cap.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"
#include "lz4_hc_body.cuh"

using namespace lz4t;

namespace {

constexpr int kMatchThreads = 256;

__global__ void __launch_bounds__(32) opt_chain_rows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ lens, const long long* __restrict__ toff,
    int* __restrict__ prev) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* head = reinterpret_cast<int*>(smem);
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < kHcHeadInts; i += 32) head[i] = kHcEmpty;
  __syncwarp();
  const uint8_t* s = base + starts[row];
  const int n = lens[row];
  int* pv = prev + toff[row];
  const int max_insert = n - kMinMatch + 1;  // read32 stays in the row
  for (int p0 = 0; p0 < n; p0 += 32) {
    const int p = p0 + lane;
    const bool ins = p < max_insert;
    // lanes past the inserted span take keys no hash has
    const int h = ins ? hash4<kHcHashLog>(read32(s, p)) : -1 - lane;
    const unsigned peers = __match_any_sync(0xffffffffu, h);
    const unsigned lower = peers & ((1u << lane) - 1u);
    int q = kHcEmpty;
    if (ins) q = lower ? p0 + 31 - __clz(lower) : head[h];
    __syncwarp();
    if (ins && (peers >> lane) == 1u) head[h] = p;  // the group's last position
    __syncwarp();
    if (p < n) pv[p] = q;
  }
}

__global__ void __launch_bounds__(kMatchThreads) opt_matches_rows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    const long long* __restrict__ toff, const int* __restrict__ prev,
    int2* __restrict__ matches, int depth, int first_budget, int budget, int retry_longest) {
  const int row = blockIdx.y;
  const int p = blockIdx.x * kMatchThreads + threadIdx.x;
  const int n = lens[row];
  if (p >= n) return;
  const int src_off = src_offs[row];
  int2 m = make_int2(0, 0);
  if (n - src_off >= kMfLimit + 1 && p >= src_off && p <= n - kMfLimit) {
    BudgetChain c{base + starts[row], prev + toff[row], n - kLastLiterals, depth, first_budget};
    int ms = p, mp = -1;
    int len = wider_match(c, p, p, kMinMatch - 1, ms, mp, true, true);
    if (len < 0 && -1 - len <= retry_longest && budget > first_budget) {
      c.budget = budget;  // no long repeat measured: search again with the large budget
      ms = p;
      mp = -1;
      len = wider_match(c, p, p, kMinMatch - 1, ms, mp, true, true);
    }
    if (len < 0)
      m = make_int2(len, 0);  // gave up: the parse searches here itself
    else if (len > kMinMatch - 1)
      m = make_int2(len, p - mp);
  }
  matches[toff[row] + p] = m;
}

__global__ void __launch_bounds__(1) opt_parse_rows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    const long long* __restrict__ toff, const int* __restrict__ prev,
    const int2* __restrict__ matches, uint8_t* __restrict__ out, long long out_stride,
    int ocap, int depth, int sufficient, int* __restrict__ clens, int* __restrict__ errs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const uint8_t* s = base + starts[row];
  const int n = lens[row];
  const int2* t = matches + toff[row];
  TableChain c{s, prev + toff[row], n - kLastLiterals, depth, 0};
  auto find = [t, &c](int p, int min_len, int& off) {
    const int2 m = t[p];
    if (m.x < 0) return opt_find(c, p, min_len, off);
    off = m.y;
    return m.x;
  };
  Sink o{out + row * out_stride, 0, static_cast<int>(out_stride)};
  opt_parse(s, src_offs[row], n, sufficient, true, o, reinterpret_cast<OptCell*>(smem), find);
  clens[row] = o.op;
  errs[row] = o.op > ocap ? 1 : 0;
}

__global__ void __launch_bounds__(32) opt_parse_spec_rows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    const long long* __restrict__ toff, const int* __restrict__ prev,
    const int2* __restrict__ matches, uint8_t* __restrict__ out, long long out_stride,
    int ocap, int depth, int sufficient, int* __restrict__ clens, int* __restrict__ errs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const uint8_t* s = base + starts[row];
  const int n = lens[row];
  TableChain c{s, prev + toff[row], n - kLastLiterals, depth, 0};
  WarpSink o{out + row * out_stride, 0, static_cast<int>(out_stride)};
  opt_parse_rounds(s, src_offs[row], n, sufficient, matches + toff[row], c, o,
                   reinterpret_cast<OptCell*>(smem), reinterpret_cast<int*>(smem + kOptCellsBytes));
  if (threadIdx.x == 0) {
    clens[row] = o.op;
    errs[row] = o.op > ocap ? 1 : 0;
  }
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
//
// Each launches on `stream`, does not synchronise, and returns the first
// CUDA error (0 on success).  The caller has checked every window against
// `base` and laid the tables out by `toff`.

extern "C" int lz4t_opt_chain_shared_bytes() { return kHcHeadInts * static_cast<int>(sizeof(int)); }

extern "C" int lz4t_opt_parse_shared_bytes() { return kOptCellsBytes; }

// The price table and the lanes' positions (32 ints).
extern "C" int lz4t_opt_parse_spec_shared_bytes() { return kOptCellsBytes + 32 * 4; }

extern "C" int lz4t_opt_chain(const void* base, const void* starts, const void* lens,
                              const void* toff, void* prev, int nrows, void* stream) {
  const int smem = lz4t_opt_chain_shared_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      opt_chain_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  opt_chain_rows<<<nrows, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(lens), static_cast<const long long*>(toff),
      static_cast<int*>(prev));
  return static_cast<int>(cudaGetLastError());
}

// `max_len` is the longest row: the grid is (ceil(max_len / 256), nrows),
// nrows <= 65,535.
extern "C" int lz4t_opt_matches(const void* base, const void* starts, const void* src_offs,
                                const void* lens, const void* toff, const void* prev,
                                void* matches, int depth, int first_budget, int budget,
                                int retry_longest, int nrows, int max_len, void* stream) {
  const dim3 grid((max_len + kMatchThreads - 1) / kMatchThreads, nrows);
  opt_matches_rows<<<grid, kMatchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(src_offs), static_cast<const int*>(lens),
      static_cast<const long long*>(toff), static_cast<const int*>(prev),
      static_cast<int2*>(matches), depth, first_budget, budget, retry_longest);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lz4t_opt_parse(const void* base, const void* starts, const void* src_offs,
                              const void* lens, const void* toff, const void* prev,
                              const void* matches, void* out, long long out_stride, int ocap,
                              int depth, int sufficient, void* clens, void* errs, int nrows,
                              void* stream) {
  const int smem = lz4t_opt_parse_shared_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      opt_parse_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  opt_parse_rows<<<nrows, 1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(src_offs), static_cast<const int*>(lens),
      static_cast<const long long*>(toff), static_cast<const int*>(prev),
      static_cast<const int2*>(matches), static_cast<uint8_t*>(out), out_stride, ocap, depth,
      sufficient, static_cast<int*>(clens), static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
}


// One warp per row (levels 10-11): `depth` and `sufficient` are the level's.
extern "C" int lz4t_opt_parse_spec(const void* base, const void* starts, const void* src_offs,
                                   const void* lens, const void* toff, const void* prev,
                                   const void* matches, void* out, long long out_stride,
                                   int ocap, int depth, int sufficient, void* clens, void* errs,
                                   int nrows, void* stream) {
  const int smem = lz4t_opt_parse_spec_shared_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      opt_parse_spec_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  opt_parse_spec_rows<<<nrows, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(src_offs), static_cast<const int*>(lens),
      static_cast<const long long*>(toff), static_cast<const int*>(prev),
      static_cast<const int2*>(matches), static_cast<uint8_t*>(out), out_stride, ocap, depth,
      sufficient, static_cast<int*>(clens), static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
}
