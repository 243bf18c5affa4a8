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
// 1. The chain pass: prev[p], the previous position of p's hash in the
//    row (kHcEmpty when none), for every p below n - 3.  It replaces the
//    chain inserts of the TPU kernel's HC and OPT arms (`insert_upto`,
//    lz4_tpu/ops/encode_pallas5.py:474-489; the nearest host text is
//    lz4_tpu/block/hostref.py:472-500, `_ChainFinder.insert_upto`): the
//    head read at p, then p made the head.  The exact prev, not the
//    clamped delta, because the head read at p needs the position; the
//    delta a chain step reads is min(q - prev[q], 0xFFFF), computed where
//    it is read.  Positions before the row's window are not in its table,
//    so a chained window's first positions end their chains as its ring
//    does.  prev is a stable sort of the row's positions by hash: nothing
//    in it is a chain of dependent steps, so bytes bound it, not steps
//    (the window read once, prev written once: ~5 bytes a position).  The
//    pass cuts every row into segments of kChainSegment positions, each
//    its own CTA, and joins them exactly afterwards:
//    a. opt_chain_walk, one CTA of 256 threads per (segment, row), two
//       CTAs an SM: the CTA stages the segment's bytes (+3) in shared
//       memory with 16-byte loads of the aligned chunks around them (a
//       row may start at any byte); its eight warps hash every position
//       and find, among the 32 positions of each step, the lanes of each
//       hash (__match_any_sync), keeping for each position its hash and a
//       code (the highest lower lane of its hash, or for the lowest lane
//       of a hash its highest).  Then one warp walks the segment 32
//       positions a step over a head table of segment-relative u16
//       entries (64 KB): a lane with a lower lane of its hash takes that
//       lane's position; the lowest lane of each hash reads the head and
//       writes back the hash's highest position, so one thread touches
//       each entry in a step and one __syncwarp orders the steps; its
//       results stay in shared memory (a step waits only on its head
//       load) and are written out coalesced after the walk.  A position
//       with no earlier one of its hash in the segment gets kHcEmpty;
//       where the row has more than one segment, its position is kept as
//       its hash's first in the segment, and the final head table as each
//       hash's last (two u16 tables, 128 KB a segment).
//    b. opt_chain_join, one thread per (hash, row of more than one
//       segment): the row's segments in order, the hash's last position in
//       those before carried and written as prev of the hash's first
//       position in each later segment that has it.  Segment j's
//       positions all lie below segment k's for j < k, so that is the
//       position the serial walk's head held.  Its table reads are
//       coalesced over the hashes, eight segments' at once; a join that
//       looked back from each first position instead read the tables at
//       random: ~2 ms on 16 x 4 MiB rows of the mix on an H100.
// 2. opt_matches_rows: every position's search, wider_match(p, p, 3,
//    pattern analysis, chain swap) over the tables with the level's depth.
//    Writes (length, offset), or (0, 0) when nothing is longer than 3
//    bytes, for every position of the row (zeros outside the searched
//    span).  A search whose work passes its budget (SliceChain: chain
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
// 3. The price parse (lz4_hc_body.cuh opt_walk_rounds) by one warp, its
//    searches made 32 at a time.  Levels 10-11 (opt_parse_spec): a search
//    whose minimum length is 3 or less reads the table (opt_find(p, m)
//    equals opt_find(p, 3) there), the others run on the lanes; each round
//    the lanes take the next <= 32 positions the parse does not skip, each
//    with the minimum length the state gives it, and the warp commits them
//    in order up to the first that finds a match (a search that finds
//    nothing changes no state).  Every row is cut into segments of
//    kOptSegment positions, each walked by its own warp from a guessed
//    state and joined to the walk before where their states meet
//    (parse_segments.cuh; one warp per row left 116 of 132 SMs idle on 16
//    rows of 4 MiB), the price tables in device memory so that the SM's
//    registers alone bound its walks.  Level 12 (opt_parse_rows, one warp
//    per row, three rows per SM, the 64 KB price table in shared memory;
//    the one-thread walk it replaces stays only in the serial arm):
//    every search has minimum length 3, so no table entry depends on the
//    state: a round reads the entries of
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

// What bounds the chain pass: bytes (the windows read once, prev written
// once, ~0.025 ms per 16 MiB at 3.35 TB/s); its segments' tables add ~16
// bytes a position of traffic, and a segment's walk kChainSegment / 32
// dependent steps, two walks an SM.  What bounds the match
// pass and the parses: not bytes (12 bytes of table per window byte and
// the output: ~0.1 ms per 16 MiB), but dependent steps: the match pass's
// slowest search (its chain steps and bytes measured, at most
// first_budget + budget), with warps held by their longest lane; the
// parse's commits and rounds, on the level 12 path the noise rows' (one
// commit per ~1.7 positions), at levels 10-11 those of the slowest
// segment's walk and of the rounds its links take.  The tables of a batch take 12 bytes per
// window byte of device memory (the chain pass's scratch, 8 bytes a
// position, is freed before the match pass allocates its table); the
// wrapper processes rows in groups under a fixed cap.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"
#include "lz4_hc_body.cuh"
#include "parse_segments.cuh"

using namespace lz4t;

namespace {

#ifndef LZ4T_CHAIN_SEGMENT
#define LZ4T_CHAIN_SEGMENT 16384
#endif
// positions a CTA of the chain pass walks (`encode_opt.CHAIN_SEGMENT`)
constexpr int kChainSegment = LZ4T_CHAIN_SEGMENT;
constexpr int kMatchThreads = 1024;
constexpr int kSlice = 16384;  // positions a CTA of the match pass searches
// the staged deltas of the positions a slice's searches reach
constexpr int kSliceDeltaBytes = ((kMaxDistance + kSlice) * 2 + 15) / 16 * 16;

// ---- the chain pass ------------------------------------------------------

// all the threads stage, hash and write the tables out; one warp walks
constexpr int kChainThreads = 256;
constexpr int kChainHashes = 1 << kHcHashLog;
constexpr uint16_t kNoHead = 0xFFFF;  // no position of the hash in the segment yet
constexpr int kChainHeadBytes = kChainHashes * static_cast<int>(sizeof(uint16_t));
// A lane's code in its step: kLower | the highest lower lane of its hash
// if it has one; else (the lowest lane of its hash: it reads and writes
// the head) the highest lane of its hash.
constexpr uint8_t kLower = 0x40;
// the head table, then each position's hash (u16) and code (u8); the
// segment's bytes are staged where the head table goes until the walk
constexpr int kChainSharedBytes = kChainHeadBytes + 3 * kChainSegment;
static_assert((kChainSegment & (kChainSegment - 1)) == 0 && kChainSegment >= 32 &&
                  kChainSegment <= 32768,
              "a segment is a power of two of 32 to 32,768 positions: a head entry is a "
              "segment-relative u16 and 0xFFFF is none");
// the staged bytes (a segment's positions and the 3 bytes after them, the
// aligned 16-byte chunks that hold them, a zero chunk) fit the head table
static_assert(((15 + kChainSegment + 3 + 15) / 16 + 1) * 16 <= kChainHeadBytes, "stage");

// The hash of the segment's position i (relative) from the staged words
// (byte i at `lead` + i), or -1 past the inserted positions.
__device__ __forceinline__ int chain_key(const uint32_t* w, int lead, int i, int ins) {
  if (i >= ins) return -1;
  const int b = lead + i;
  const uint32_t v = __funnelshift_r(w[b >> 2], w[(b >> 2) + 1], (b & 3) * 8);
  return hash4<kHcHashLog>(v);
}

// One lane's step of the walk: its position i (-1: not inserted), its hash,
// code and head read.  result() is what the walk leaves in place of its
// hash: the segment-relative position of its predecessor (the highest
// lower lane of its hash, else the head), or kFirst | its hash where the
// segment has none.
constexpr int kFirst = 0x8000;  // above every segment-relative position
struct ChainStep {
  int i, h, c, x;
  __device__ __forceinline__ int result(int lane) const {
    if (c & kLower) return i - lane + (c & 31);
    return x != kNoHead ? x : kFirst | h;
  }
};

__global__ void __launch_bounds__(kChainThreads, 2) opt_chain_walk(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ lens, const long long* __restrict__ toff,
    const long long* __restrict__ segoff, uint16_t* __restrict__ last,
    uint16_t* __restrict__ first, int* __restrict__ prev, int nrows) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* head = reinterpret_cast<uint16_t*>(smem);
  uint4* stage = reinterpret_cast<uint4*>(smem);  // until the walk
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem + kChainHeadBytes);
  uint8_t* code = smem + kChainHeadBytes + 2 * kChainSegment;
  const int k = blockIdx.x;
  const int p0 = k * kChainSegment;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.y; row < nrows; row += gridDim.y) {
    const int n = lens[row];
    if (p0 >= n) continue;  // the same for every thread of the CTA
    const int len = min(kChainSegment, n - p0);
    const int ins = max(0, min(len, n - kMinMatch + 1 - p0));  // read32 stays in the row
    const uintptr_t a = reinterpret_cast<uintptr_t>(base + starts[row] + p0);
    const uint4* g = reinterpret_cast<const uint4*>(a & ~uintptr_t{15});
    const int lead = static_cast<int>(a & 15);
    const int chunks = ins ? (lead + ins + 3 + 15) >> 4 : 0;
    __syncthreads();  // the row before is done with the shared tables
    for (int c = threadIdx.x; c < chunks; c += kChainThreads) stage[c] = __ldg(g + c);
    if (threadIdx.x == 0) stage[chunks] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    // every step's hashes and codes, a warp a step
    const uint32_t* w = reinterpret_cast<const uint32_t*>(stage);
    for (int i0 = warp * 32; i0 < len; i0 += kChainThreads) {
      const int i = i0 + lane;
      const int h = chain_key(w, lead, i, ins);
      // the lanes of this lane's hash (a lane past the inserted positions
      // takes a key of its own)
      const unsigned peers = __match_any_sync(kFull, h >= 0 ? h : -1 - lane);
      const unsigned lower = peers & ((1u << lane) - 1u);
      if (i < len) {
        hs[i] = static_cast<uint16_t>(h);
        code[i] = static_cast<uint8_t>(
            h < 0 ? 0 : lower ? kLower | (31 - __clz(lower)) : 31 - __clz(peers));
      }
    }
    __syncthreads();
    uint4* h4 = reinterpret_cast<uint4*>(head);
    for (int c = threadIdx.x; c < kChainHeadBytes / 16; c += kChainThreads)
      h4[c] = make_uint4(~0u, ~0u, ~0u, ~0u);
    __syncthreads();
    // this segment's tables, where the row has more than one segment
    const int segments = (n + kChainSegment - 1) / kChainSegment;
    const long long t = segments > 1 ? (segoff[row] + k) * kChainHashes : -1;
    if (warp == 0) {
      // each step's result is stored a step late, so that no step waits on
      // its head read; the walk stores nothing to device memory, whose
      // stores a __syncwarp would wait for
      ChainStep before{-1, -1, 0, kNoHead};
      int h = lane < ins ? hs[lane] : -1;
      int c = lane < ins ? code[lane] : 0;
      int h1 = lane + 32 < ins ? hs[lane + 32] : -1;
      int c1 = lane + 32 < ins ? code[lane + 32] : 0;
      for (int i0 = 0; i0 < len; i0 += 32) {
        const int i = i0 + lane;
        int x = kNoHead;
        if (h >= 0 && !(c & kLower)) {  // the lowest lane of its hash
          x = head[h];
          head[h] = static_cast<uint16_t>(i0 + c);  // the hash's highest lane
        }
        const int j = i + 64;  // the hash and code two steps on, read ahead
        const int h2 = j < ins ? hs[j] : -1;
        const int c2 = j < ins ? code[j] : 0;
        if (before.i >= 0) hs[before.i] = static_cast<uint16_t>(before.result(lane));
        __syncwarp();  // this step's head writes before the next step's reads
        before = ChainStep{h >= 0 ? i : -1, h, c, x};
        h = h1;
        c = c1;
        h1 = h2;
        c1 = c2;
      }
      if (before.i >= 0) hs[before.i] = static_cast<uint16_t>(before.result(lane));
    }
    __syncthreads();
    // every position's prev, and where the row has tables, each hash's
    // first position in the segment (the join gives it the hash's last
    // position in the segments before)
    int* pv = prev + toff[row] + p0;
    uint16_t* fst = t >= 0 && k > 0 ? first + t : nullptr;
#pragma unroll 4
    for (int i = threadIdx.x; i < len; i += kChainThreads) {
      int q = kHcEmpty;
      if (i < ins) {
        const int r = hs[i];
        if (!(r & kFirst))
          q = p0 + r;
        else if (fst)
          fst[r & (kFirst - 1)] = static_cast<uint16_t>(i);
      }
      pv[i] = q;
    }
    if (t >= 0) {  // each hash's last position in the segment, for the join
      uint4* out = reinterpret_cast<uint4*>(last + t);
      for (int c = threadIdx.x; c < kChainHeadBytes / 16; c += kChainThreads) out[c] = h4[c];
    }
  }
}

// One thread per (hash, row) of the rows with more than one segment: the
// segments in order, the hash's last position in those before carried,
// and written at the hash's first position in each later one that has it.
__global__ void __launch_bounds__(kChainThreads) opt_chain_join(
    const int* __restrict__ lens, const long long* __restrict__ toff,
    const long long* __restrict__ segoff, const uint16_t* __restrict__ last,
    const uint16_t* __restrict__ first, int* __restrict__ prev, int nrows) {
  constexpr int kAhead = 8;  // segments whose tables are read at once
  const int h = blockIdx.x * kChainThreads + threadIdx.x;
  for (int row = blockIdx.y; row < nrows; row += gridDim.y) {
    const int segments = (lens[row] + kChainSegment - 1) / kChainSegment;
    if (segments < 2) continue;
    const uint16_t* la = last + segoff[row] * kChainHashes + h;
    const uint16_t* fi = first + segoff[row] * kChainHashes + h;
    int* pv = prev + toff[row];
    int carry = kHcEmpty;
    for (int k0 = 0; k0 < segments; k0 += kAhead) {
      int v[kAhead], f[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        v[u] = k0 + u < segments
                   ? __ldg(la + static_cast<long long>(k0 + u) * kChainHashes) : kNoHead;
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
        f[u] = v[u] != kNoHead && k0 + u > 0
                   ? __ldg(fi + static_cast<long long>(k0 + u) * kChainHashes) : 0;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (v[u] == kNoHead) continue;
        const int p = (k0 + u) * kChainSegment;
        if (carry != kHcEmpty) pv[p + f[u]] = carry;
        carry = p + v[u];
      }
    }
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

// Level 12's parse by one warp per row (opt_parse_rounds with `full`).
__global__ void __launch_bounds__(32) opt_parse_rows(
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
  opt_parse_rounds<true>(s, src_offs[row], n, sufficient, matches + toff[row], c, o,
                         reinterpret_cast<OptCell*>(smem),
                         reinterpret_cast<int*>(smem + kOptCellsBytes));
  if (threadIdx.x == 0) {
    clens[row] = o.op;
    errs[row] = o.op > ocap ? 1 : 0;
  }
}

// ---- levels 10-11: the parse by segments (parse_segments.cuh) -----------

// A segment walk's price table lies in device memory (read through L1),
// one a segment: in shared memory (65.7 KB) three walks fit an SM, here
// the SM's registers bound them (32 an SM, every segment of 16 rows of
// 4 MiB at once).
constexpr int kSegCells = kOptNum + kOptTrailing;

// Segment g's walk from `start` by the warp: the parse by rounds
// (opt_walk_rounds) over the row's tables, into g's records, its price
// table `cells`.
__device__ void opt_seg_walk(const SegPlan& p, int g, int4 start, int round,
                             const long long* __restrict__ toff, const int* __restrict__ prev,
                             const int2* __restrict__ matches, int depth, int sufficient,
                             OptCell* cells, int* lane_pos) {
  const SegBounds b = seg_bounds(p, g);
  TableChain c{b.s, prev + toff[b.row], b.n - kLastLiterals, depth, 0};
  SegOut<true> o = seg_out<true>(p, g, b);
  int ip = start.x, anchor = start.y;
  opt_walk_rounds<false>(b.s, ip, anchor, b.mflimit, sufficient, matches + toff[b.row], c, o,
                         cells, lane_pos);
  seg_finish(p, g, b, start, o, ip, anchor, 0, round);
}

// One round: a warp for each segment to walk (round 0: every one, from its
// guess).
__global__ void __launch_bounds__(32) opt_seg_walks(SegPlan p, const long long* __restrict__ toff,
                                                    const int* __restrict__ prev,
                                                    const int2* __restrict__ matches, int depth,
                                                    int sufficient, OptCell* __restrict__ cells,
                                                    int round) {
  __shared__ int lane_pos[32];
  const int g = blockIdx.x;
  if (round > 0 && !p.todo[g]) return;
  const int4 start = seg_start(p, g, seg_bounds(p, g), round == 0);
  if (lane_id() == 0) atomicAdd(p.stats + round, 1);
  opt_seg_walk(p, g, start, round, toff, prev, matches, depth, sufficient,
               cells + static_cast<long long>(g) * kSegCells, lane_pos);
}

// The serial tail, a warp a row: its first segment not exact walked from
// its predecessor's end and linked, until every one is (segment 0 first
// where no round walked it).
__global__ void __launch_bounds__(32) opt_seg_tail(SegPlan p, const long long* __restrict__ toff,
                                                   const int* __restrict__ prev,
                                                   const int2* __restrict__ matches, int depth,
                                                   int sufficient, OptCell* __restrict__ cells) {
  __shared__ int lane_pos[32];
  __shared__ int first;
  const int row = blockIdx.x;
  if (p.row_last[row] >= 0) return;  // settled in a round
  const int g0 = p.segoff[row], K = p.segoff[row + 1] - g0;
  const int lane = lane_id();
  OptCell* table = cells + (static_cast<long long>(p.nseg) + row) * kSegCells;
  if (p.walked[g0] < 0) {
    opt_seg_walk(p, g0, seg_start(p, g0, seg_bounds(p, g0), true), p.rounds, toff, prev, matches,
                 depth, sufficient, table, lane_pos);
    if (lane == 0) atomicAdd(p.stats + p.rounds + kStatTail, 1);
  }
  for (;;) {
    __syncwarp();  // the walk's records before lane 0 reads them
    if (lane == 0) first = seg_settle(p, row);
    __syncwarp();
    const int f = first;
    if (f >= K) break;
    const int g = g0 + f;
    opt_seg_walk(p, g, p.next[g], p.rounds, toff, prev, matches, depth, sufficient, table,
                 lane_pos);
    __syncwarp();
    if (lane == 0) {
      atomicAdd(p.stats + p.rounds + kStatTail, 1);
      p.links[g] = seg_link(p, g);
      if (f + 1 < K) p.links[g + 1] = seg_link(p, g + 1);
    }
  }
}

// The records a walk keeps at levels 10-11 (encode_opt.opt_segment_caps):
// its states lie where sequences end, 4 positions apart at least; its
// sequences start before its stop or in the window that crosses it.
__host__ __device__ constexpr int opt_head_cap(int overlap) { return overlap / 4 + 2; }
__host__ __device__ constexpr int opt_seq_cap(int segment, int overlap) {
  return (segment + overlap + kOptNum) / 4 + 2;
}

SegPlan opt_plan(const void* base, const void* starts, const void* src_offs, const void* lens,
                 const void* segoff, const void* seg_row, int nrows, int nseg, int segment,
                 int overlap, int rounds, void* scratch, void* stats) {
  SegPlan p{};
  p.base = static_cast<const uint8_t*>(base);
  p.starts = static_cast<const long long*>(starts);
  p.src_offs = static_cast<const int*>(src_offs);
  p.lens = static_cast<const int*>(lens);
  p.segoff = static_cast<const int*>(segoff);
  p.seg_row = static_cast<const int*>(seg_row);
  p.nrows = nrows;
  p.nseg = nseg;
  p.rounds = rounds;
  p.segment = segment;
  p.overlap = overlap;
  p.head_cap = p.tail_cap = opt_head_cap(overlap);
  p.seq_cap = opt_seq_cap(segment, overlap);
  p.keyed = false;
  p.stats = static_cast<int*>(stats);
  seg_scratch(p, scratch, nseg, nrows);
  return p;
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
//
// Each launches on `stream`, does not synchronise, and returns the first
// CUDA error (0 on success).  The caller has checked every window against
// `base` and laid the tables out by `toff`.

// The chain walk's head table and each position's hash and code.
extern "C" int lz4t_opt_chain_shared_bytes() { return kChainSharedBytes; }

extern "C" int lz4t_opt_chain_segment() { return kChainSegment; }

static cudaError_t chain_walk_attributes() {
  cudaError_t e = cudaFuncSetAttribute(opt_chain_walk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kChainSharedBytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(opt_chain_walk, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// CTAs of the chain walk that an SM holds at once (-1 - the CUDA error).
extern "C" int lz4t_opt_chain_ctas_per_sm() {
  int ctas = 0;
  cudaError_t e = chain_walk_attributes();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, opt_chain_walk, kChainThreads,
                                                      kChainSharedBytes);
  return e == cudaSuccess ? ctas : -1 - static_cast<int>(e);
}

// The staged deltas of one slice of `lz4t_opt_slice()` positions.
extern "C" int lz4t_opt_matches_shared_bytes() { return kSliceDeltaBytes; }

extern "C" int lz4t_opt_slice() { return kSlice; }

// The price table and the lanes' positions (32 ints) of level 12's parse.
extern "C" int lz4t_opt_parse_shared_bytes() { return kOptCellsBytes + 32 * 4; }

// `segoff[r]` is the first of row r's segment tables in `last` and
// `first` (u16, kChainHashes a table, one for each of its segments where
// it has more than one); `max_len` is the longest row.  Enqueues the walk,
// then the join.
extern "C" int lz4t_opt_chain(const void* base, const void* starts, const void* lens,
                              const void* toff, const void* segoff, void* last, void* first,
                              void* prev, int nrows, int max_len, void* stream) {
  cudaError_t e = chain_walk_attributes();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int segments = (max_len + kChainSegment - 1) / kChainSegment;
  const int ys = nrows < 65535 ? nrows : 65535;
  if (segments == 0 || nrows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  opt_chain_walk<<<dim3(segments, ys), kChainThreads, kChainSharedBytes, s>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(lens), static_cast<const long long*>(toff),
      static_cast<const long long*>(segoff), static_cast<uint16_t*>(last),
      static_cast<uint16_t*>(first), static_cast<int*>(prev), nrows);
  e = cudaGetLastError();
  if (e != cudaSuccess || segments == 1) return static_cast<int>(e);
  opt_chain_join<<<dim3(kChainHashes / kChainThreads, ys), kChainThreads, 0, s>>>(
      static_cast<const int*>(lens), static_cast<const long long*>(toff),
      static_cast<const long long*>(segoff), static_cast<const uint16_t*>(last),
      static_cast<const uint16_t*>(first), static_cast<int*>(prev), nrows);
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


// The level 10-11 parse by segments: rows cut into `segment` positions a
// segment (segoff [nrows + 1], seg_row [nseg]), each walked on past its
// end by `overlap`, `rounds` rounds of walks and checks, the serial tail,
// the emit.  `scratch` holds the bytes lz4t_opt_seg_scratch gives;
// `stats` int [rounds + 4]: each round's walks, the tail's, a record
// overflow flag, the links behind a frontier (0 here) and the links kept.
// The records' bytes, then the price tables' (one a segment and one a
// row, for the tail).
static size_t opt_seg_bytes(SegPlan& p, void* scratch, long long nseg, int nrows) {
  const size_t records = seg_align(seg_scratch(p, scratch, nseg, nrows));
  return records + (nseg + nrows) * static_cast<size_t>(kOptCellsBytes);
}

extern "C" int lz4t_opt_seg_scratch(long long nseg, int nrows, int segment, int overlap,
                                    void* bytes) {
  SegPlan p{};
  p.head_cap = p.tail_cap = opt_head_cap(overlap);
  p.seq_cap = opt_seq_cap(segment, overlap);
  *static_cast<long long*>(bytes) = static_cast<long long>(opt_seg_bytes(p, nullptr, nseg, nrows));
  return 0;
}

extern "C" int lz4t_opt_segment() { return kOptSegment; }
extern "C" int lz4t_opt_overlap() { return kOptOverlap; }

extern "C" int lz4t_opt_parse_spec(const void* base, const void* starts, const void* src_offs,
                                   const void* lens, const void* toff, const void* prev,
                                   const void* matches, void* out, long long out_stride,
                                   int ocap, int depth, int sufficient, void* clens, void* errs,
                                   int nrows, const void* segoff, const void* seg_row, int nseg,
                                   int segment, int overlap, int rounds, void* scratch,
                                   void* stats, void* stream) {
  for (const void* k : {reinterpret_cast<const void*>(opt_seg_walks),
                        reinterpret_cast<const void*>(opt_seg_tail)}) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxL1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  SegPlan p = opt_plan(base, starts, src_offs, lens, segoff, seg_row, nrows, nseg, segment,
                       overlap, rounds, scratch, stats);
  // the price tables after the records (opt_seg_bytes)
  auto* cells = reinterpret_cast<OptCell*>(static_cast<char*>(scratch) +
                                           seg_align(seg_scratch(p, scratch, nseg, nrows)));
  const auto* tf = static_cast<const long long*>(toff);
  const auto* pv = static_cast<const int*>(prev);
  const auto* mt = static_cast<const int2*>(matches);
  cudaError_t e = seg_reset(p, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int r = 0; r < rounds; ++r) {
    opt_seg_walks<<<nseg, 32, 0, st>>>(p, tf, pv, mt, depth, sufficient, cells, r);
    seg_round_check(p, r, st);
  }
  opt_seg_tail<<<nrows, 32, 0, st>>>(p, tf, pv, mt, depth, sufficient, cells);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(seg_emit(p, out, out_stride, ocap, clens, errs, st));
}
