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
//    pattern analysis, chain swap) over the tables with the level's depth.
//    Writes (length, offset), or (0, 0) when nothing is longer than 3
//    bytes, for every position of the row (zeros outside the searched
//    span).  A search whose work passes its budget (BudgetChain: chain
//    steps plus bytes measured) gives up and writes (-1 - the longest match
//    it had found, 0): in a long repeat every position would measure the
//    whole repeat at every step, work that the serial parse, which jumps
//    over the repeat, never does.  Every search starts with a small budget;
//    one that gives up with no match longer than `retry_longest` starts
//    again with a large one (a longer match is a repeat the parse is likely
//    to jump over).  One CTA of 1,024 threads per slice of kSlice (16,384)
//    positions of a row, one CTA per SM: it stages in shared memory the u16
//    chain deltas min(q - prev[q], 0xFFFF) of [slice start - 65,535, slice
//    end) (2 x (65,535 + 16,384) bytes, within the card's 227 KB a block),
//    each computed once from prev.  A search at p reaches no candidate below
//    p - 65,535, so every chain step reads a staged delta, a dependent
//    shared load (SliceChain, lz4_hc_body.cuh); the bytes it compares come
//    from the row in device memory, which its neighbours' searches keep in
//    L1 (staging them too, at 8,192 positions a slice, was slower: each
//    read then tests which copy to read).  Each warp takes the slice's next
//    32 positions from a shared counter, so the warps of a slice end
//    together; a warp still waits for its longest lane, and a slice's
//    slowest search holds its SM, which the larger slice amortises.
// 3. The price parse (lz4_hc_body.cuh opt_parse_rounds) by one warp per
//    row, three rows per SM, the 64 KB price table in shared memory (the
//    one-thread walk it replaces at level 12 stays only in the serial arm).
//    Levels 10-11, opt_parse_spec_rows: a search whose minimum length is 3
//    or less reads the table (opt_find(p, m) equals opt_find(p, 3) there),
//    the others run on the lanes; each round the lanes take the next <= 32
//    positions the parse does not skip, each with the minimum length the
//    state gives it, and the warp commits them in order up to the first
//    that finds a match (a search that finds nothing changes no state).
//    Level 12, opt_parse_rows (`full`): every search has minimum length 3,
//    so no table entry depends on the state: a round reads the entries of
//    the next 32 positions and commits their matches in order, each the
//    first position past the last commit that the live price table does
//    not skip (level 12's test) and whose entry, or its lane's search on
//    the spot where the match pass gave up, has a match.  A committed
//    match's price-table step (opt_add_warp: up to `sufficient` = 4,095
//    lengths at level 12) and a window's seed are spread over the lanes.
//    So a row takes one dependent step per commit (a few shared loads,
//    ballots and shuffles: one warp, nothing to hide their latency), per
//    32 positions read and per ceil((length - 3) / 32) lengths priced,
//    where the serial walk took one per position visited, per length
//    priced and per chain step of a search made on the spot.

// What bounds them: not bytes (the windows, 12 bytes of table per window
// byte and the output: ~0.1 ms per 16 MiB at 3.35 TB/s), but dependent
// steps: the chain pass's 32-position steps (2,048 per 64 KB row, 4,096 per
// 128 KB window); the match pass's slowest search (its chain steps and
// bytes measured, at most first_budget + budget), with warps held by their
// longest lane; the parse's commits and rounds, on the level 12 path the
// noise rows' (one commit per ~1.7 positions).  The tables of a batch take
// 12 bytes per window byte of device memory; the wrapper processes rows in
// groups under a fixed cap.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"
#include "lz4_hc_body.cuh"

using namespace lz4t;

namespace {

constexpr int kMatchThreads = 1024;
constexpr int kSlice = 16384;  // positions a CTA of the match pass searches
// the staged deltas of the positions a slice's searches reach
constexpr int kSliceDeltaBytes = ((kMaxDistance + kSlice) * 2 + 15) / 16 * 16;

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

__global__ void __launch_bounds__(kMatchThreads, 1) opt_matches_rows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    const long long* __restrict__ toff, const int* __restrict__ prev,
    int2* __restrict__ matches, int depth, int first_budget, int budget, int retry_longest) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int next;  // the slice's next position to hand a warp
  const int row = blockIdx.y;
  const int n = lens[row];
  const int p0 = blockIdx.x * kSlice;
  if (p0 >= n) return;
  const int p1 = min(n, p0 + kSlice);
  const int src_off = src_offs[row];
  int2* out = matches + toff[row];
  // the slice's searched positions [a, b)
  const int a = max(p0, src_off);
  const int b = n - src_off >= kMfLimit + 1 ? min(p1, n - kMfLimit + 1) : a;
  if (a >= b) {  // a prefix or the row's tail: nothing searched
    for (int p = p0 + threadIdx.x; p < p1; p += kMatchThreads) out[p] = make_int2(0, 0);
    return;
  }
  const uint8_t* s = base + starts[row];
  const int* pv = prev + toff[row];
  const int lo = max(0, a - kMaxDistance);  // the lowest position a search reaches
  uint16_t* delta = reinterpret_cast<uint16_t*>(smem);
  // four loads in flight a thread: the staging waits on device memory
  for (int q0 = lo + threadIdx.x; q0 < b; q0 += 4 * kMatchThreads) {
    int pq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + k * kMatchThreads;
      pq[k] = q < b ? __ldg(pv + q) : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + k * kMatchThreads;
      const int d = q - pq[k];
      if (q < b) delta[q - lo] = static_cast<uint16_t>(d > 0xFFFF ? 0xFFFF : d);
    }
  }
  if (threadIdx.x == 0) next = p0;
  __syncthreads();
  SliceChain c{s, pv, delta, lo, n - kLastLiterals, depth, 0};
  const int lane = lane_id();
  for (;;) {
    int w0 = 0;
    if (lane == 0) w0 = atomicAdd(&next, 32);
    w0 = __shfl_sync(kFull, w0, 0);
    if (w0 >= p1) break;
    const int p = w0 + lane;
    if (p >= p1) continue;
    int2 m = make_int2(0, 0);
    if (p >= a && p < b) {
      int len, mp;
      c.budget = first_budget;
      for (;;) {  // one call site: wider_match inlined over the staged tables
        int ms = p;
        mp = -1;
        len = wider_match(c, p, p, kMinMatch - 1, ms, mp, true, true);
        if (len >= 0 || -1 - len > retry_longest || c.budget >= budget) break;
        c.budget = budget;  // no long repeat measured: search again with the large budget
      }
      if (len < 0)
        m = make_int2(len, 0);  // gave up: the parse searches here itself
      else if (len > kMinMatch - 1)
        m = make_int2(len, p - mp);
    }
    out[p] = m;
  }
}

// The parse by one warp per row (opt_parse_rounds): level 12 with `full`.
template <bool full>
__device__ __forceinline__ void parse_row(
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
  opt_parse_rounds<full>(s, src_offs[row], n, sufficient, matches + toff[row], c, o,
                         reinterpret_cast<OptCell*>(smem),
                         reinterpret_cast<int*>(smem + kOptCellsBytes));
  if (threadIdx.x == 0) {
    clens[row] = o.op;
    errs[row] = o.op > ocap ? 1 : 0;
  }
}

__global__ void __launch_bounds__(32) opt_parse_rows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    const long long* __restrict__ toff, const int* __restrict__ prev,
    const int2* __restrict__ matches, uint8_t* __restrict__ out, long long out_stride,
    int ocap, int depth, int sufficient, int* __restrict__ clens, int* __restrict__ errs) {
  parse_row<true>(base, starts, src_offs, lens, toff, prev, matches, out, out_stride, ocap, depth,
                  sufficient, clens, errs);
}

__global__ void __launch_bounds__(32) opt_parse_spec_rows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    const long long* __restrict__ toff, const int* __restrict__ prev,
    const int2* __restrict__ matches, uint8_t* __restrict__ out, long long out_stride,
    int ocap, int depth, int sufficient, int* __restrict__ clens, int* __restrict__ errs) {
  parse_row<false>(base, starts, src_offs, lens, toff, prev, matches, out, out_stride, ocap,
                   depth, sufficient, clens, errs);
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
//
// Each launches on `stream`, does not synchronise, and returns the first
// CUDA error (0 on success).  The caller has checked every window against
// `base` and laid the tables out by `toff`.

extern "C" int lz4t_opt_chain_shared_bytes() { return kHcHeadInts * static_cast<int>(sizeof(int)); }

// The staged deltas of one slice of `lz4t_opt_slice()` positions.
extern "C" int lz4t_opt_matches_shared_bytes() { return kSliceDeltaBytes; }

extern "C" int lz4t_opt_slice() { return kSlice; }

// The price table and the lanes' positions (32 ints), at every level.
extern "C" int lz4t_opt_parse_shared_bytes() { return kOptCellsBytes + 32 * 4; }

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

// `max_len` is the longest row: the grid is (ceil(max_len / kSlice),
// nrows), nrows <= 65,535.
extern "C" int lz4t_opt_matches(const void* base, const void* starts, const void* src_offs,
                                const void* lens, const void* toff, const void* prev,
                                void* matches, int depth, int first_budget, int budget,
                                int retry_longest, int nrows, int max_len, void* stream) {
  const int smem = lz4t_opt_matches_shared_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      opt_matches_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((max_len + kSlice - 1) / kSlice, nrows);
  opt_matches_rows<<<grid, kMatchThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(src_offs), static_cast<const int*>(lens),
      static_cast<const long long*>(toff), static_cast<const int*>(prev),
      static_cast<int2*>(matches), depth, first_budget, budget, retry_longest);
  return static_cast<int>(cudaGetLastError());
}

// One warp per row: `depth` and `sufficient` are the level's (level 12).
extern "C" int lz4t_opt_parse(const void* base, const void* starts, const void* src_offs,
                              const void* lens, const void* toff, const void* prev,
                              const void* matches, void* out, long long out_stride, int ocap,
                              int depth, int sufficient, void* clens, void* errs, int nrows,
                              void* stream) {
  const int smem = lz4t_opt_parse_shared_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      opt_parse_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  opt_parse_rows<<<nrows, 32, smem, static_cast<cudaStream_t>(stream)>>>(
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
  const int smem = lz4t_opt_parse_shared_bytes();
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
