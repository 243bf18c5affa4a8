// The HC arm (levels 3-9) as three passes.
//
// Replaces, at levels 3-9, the HC arm `hc_body` of the TPU kernel
// `pallas_encode5` (lz4_tpu/ops/encode_pallas5.py:953, inside
// `pallas_encode5`) and the HC arm of `pallas_encode_stream`
// (lz4_tpu/ops/encode_pallas_stream.py:266); the nearest C text is
// `lz4tpu_encode_hc` (lz4_tpu/native/lz4tpu.c:980).  encode_stream.cu's
// `encode_windows_hc<false>` runs the same parse with its searches made one
// after another, one thread per row: the card's reference for these passes.
//
// Rows are the windows of kernel D (encode_stream.cu): row r is
// base[starts[r], starts[r] + lens[r]), its first src_offs[r] bytes a prefix
// that matches may reach.  `prev` (encode_opt.cu's chain pass, the
// first pass) holds every window position back to back from toff[r]; the
// episode tables hold the block positions only, row r's position p at
// soff[r] + p - src_offs[r]: `first` an int4 each (the episode's first two
// searches), `more` max(k - 2, 0) HcSlot records each (the next ones);
// `deltas` holds every window position's chain step as a u16, laid out as
// prev.
//
// Why passes: the HC parse runs in episodes (lz4_hc_body.cuh hc_episode),
// each a first search at ip and the lookahead searches that follow from its
// answers; what an episode searches depends on the window and ip alone, as
// long as every search is made with the positions below it inserted in the
// chain and none at or above it (the frontier property).  The serial arm
// makes the searches one after another, one thread per row on one CTA per
// SM (its 128 KB ring in shared memory): 132 threads for the card, each
// chain step a dependent read with nothing to hide it.  Here:
// 2. hc_episodes_rows: one thread per window position p writes p's chain
//    step to `deltas`; at a block position it runs the episode at p over
//    the tables (BudgetChain) into a null sink and keeps its first k
//    searches, key (ip, ilow, longest) and answer (length, m_start, m_pos),
//    the first two packed in one int4, 256 positions to a CTA, 8 CTAs per
//    SM (32 registers).  A search whose work passes its budget gives up
//    (length -1 - L), and the episode stops there, as at level 12
//    (encode_opt.cu): in a long repeat every position would measure the
//    whole repeat at every step.
// 3. The parse: a thread runs the episodes; the j-th search of the
//    episode at ip reads record j of ip where it holds the search's key
//    and an answer and ip lies at or past the row's frontier (the highest
//    position searched so far); any other search is made on the spot over
//    the tables with the ring's answers at that frontier (FrontierChain),
//    with no budget.  Every row is cut into segments of kHcSegment
//    positions, each walked by its own thread from a guessed state (ip =
//    anchor = frontier = the segment's start) and joined to the walk
//    before where their states (ip and the frontier raised to it) meet
//    (parse_segments.cuh: hc_seg_walks, seg_check, hc_seg_tail, the emit;
//    one thread per row left 16 threads on the card for 16 rows of
//    4 MiB).  No shared memory: 4,096 walks, one CTA each, run in one
//    wave.
//
// The exactness guard.  A record answers the search at its key as the ring
// does when exactly the positions below the search are inserted (the
// tables: head prev[ip], deltas min(q - prev[q], 0xFFFF)).  The parse takes
// a record only for the search of the same key made with the ring's insert
// mark at that search: any search behind an earlier one would find
// positions at or above it in the ring and its deltas aliased, and is made
// on the spot with those answers.  The episode pass relies on the frontier
// property inside each episode (a search behind an earlier one of its own
// episode would hold a different answer in the ring); the plain episode
// pass (ops/encode_hc_passes.py) asserts it on every CPU test, and
// chip_smoke.py holds these passes' output to the serial arm on the card.
//
// What bounds them: not bytes (the windows, 6 bytes of prev and deltas per
// window byte and 16 + 24 (k - 2) bytes of episode tables per block byte,
// and the output: ~1.1 ms per 16 MiB at 3.35 TB/s at k = 10).  The episode
// pass by its chain steps: up to k searches per position, each up to
// `depth` steps (256 at level 9) and the bytes compared, two loads (prev
// and the source) a step, the reads of many positions in flight at once;
// it searches every position, where the parse starts an episode at few of
// them (a 64 KB text row: ~1,600).  The parse pass by its slowest
// segment's walk and the rounds its links take, one thread's dependent
// steps: a table read (or a search on the spot) after another, each read of `first` a line of 8 positions, prefetched
// kAhead positions on (text and noise rows read nearly every position's);
// a longer episode than k searches, or a search given up, is made on the
// spot, its chain steps read from `deltas` (half prev's bytes).

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"
#include "lz4_hc_body.cuh"
#include "parse_segments.cuh"

using namespace lz4t;

namespace {

constexpr int kEpisodeThreads = 256;
// CTAs of the episode pass per SM: 8 (32 registers a thread, with spills to
// local memory) ran faster than 4 (64 registers, no spills) on the H100.
constexpr int kEpisodeMinBlocks = 8;
// How far ahead of the parse `first` is prefetched, in positions (1 KB).
constexpr int kAhead = 64;

__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#endif
}

// An episode's first two searches as the episode pass keeps them, one
// int4 per position p: the first search's key is (p, p, 3) and its m_start
// p, so x = its length and y = its m_pos; the second is the search2 after
// it, whose key (p + x - 2, p, x) the first answer sets, so z = its length
// and w packs its answer: back (p + x - 2 - m_start) in the high 16 bits,
// m_start - m_pos in the low (0 where m_pos is -1).  A length below 0: the
// search gave up (-1 - L), was not made, or (z only) its answer does not
// pack.  A walk over literals reads 8 positions to a line, each with both
// searches.
__device__ __forceinline__ int4 head_record(int len1, int pos1, int len2, int start2, int pos2,
                                            int ip2) {
  const int back = ip2 - start2, off = pos2 < 0 ? 0 : start2 - pos2;
  if (len2 >= 0 && back > 0xFFFF) len2 = -1;  // a match reaching that far back: not kept
  return make_int4(len1, pos1, len2, static_cast<int>((static_cast<unsigned>(back) << 16) | off));
}

// A later search (the third on) as the episode pass keeps it: its key and
// its answer (length -1 - L where it gave up), ip -1 where none was made.
struct alignas(8) HcSlot {
  int ip, ilow, longest, len, start, pos;
};

// The episode pass's search: the budgeted search over the tables, the
// first `k` of an episode recorded, the episode stopped at the k + 1-th or
// where one gives up.
struct RecordSearch {
  BudgetChain c;
  int4 head;
  HcSlot* more;
  int k, j;
  int first_budget, budget, retry_longest;
  bool pa;
  static constexpr bool kCanStop = true;

  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ int operator()(int ip, int ilow, int longest, int& m_start,
                                            int& m_pos) {
    if (j == k) return -1;
    c.budget = first_budget;
    int len = wider_match(c, ip, ilow, longest, m_start, m_pos, pa, false);
    if (len < 0 && -1 - len <= retry_longest && budget > first_budget) {
      c.budget = budget;  // no long repeat measured: search again with the large budget
      len = wider_match(c, ip, ilow, longest, m_start, m_pos, pa, false);
    }
    if (j == 0)
      head = make_int4(len, m_pos, -1, 0);
    else if (j == 1)
      head = head_record(head.x, head.y, len, m_start, m_pos, ip);
    else
      more[j - 2] = HcSlot{ip, ilow, longest, len, m_start, m_pos};
    ++j;
    return len;
  }
};

// The parse pass's search: the episode's recorded search j where it
// answers the search, else the ring's answer at the row's frontier.
struct ReplaySearch {
  FrontierChain c;
  const int4* row_first;    // the row's block positions
  const HcSlot* row_more;
  const HcSlot* more;       // the current episode's third search on
  int4 head;                // the current episode's first two searches
  int ep, src_off, nmore, j;  // ep: the current episode's position
  bool pa;
  int nblock, prefetched;   // block positions; the first of the line of
                            // `first` prefetched last
  static constexpr bool kCanStop = false;

  __device__ __forceinline__ void begin(int ip) {
    // `first` is read nearly in order: its line kAhead positions on into L1
    const int ahead = ip - src_off + kAhead;
    if (ahead >= prefetched + 8 && ahead < nblock) {
      prefetched = ahead & ~7;
      prefetch_l1(row_first + prefetched);
    }
    ep = ip;
    head = row_first[ip - src_off];
    more = row_more + static_cast<long long>(ip - src_off) * nmore;
    j = 0;
  }
  __device__ __forceinline__ int operator()(int ip, int ilow, int longest, int& m_start,
                                            int& m_pos) {
    if (ip >= c.frontier) {
      if (j == 0) {  // key (ep, ep, 3)
        if (ip == ep && ilow == ip && longest == kMinMatch - 1 && head.x >= 0) {
          ++j;
          c.frontier = ip;
          m_pos = head.y;
          return head.x;
        }
      } else if (j == 1) {  // key (ep + x - 2, ep, x)
        if (ip == ep + head.x - 2 && ilow == ep && longest == head.x && head.z >= 0) {
          ++j;
          c.frontier = ip;
          const unsigned w = static_cast<unsigned>(head.w);
          m_start = ip - static_cast<int>(w >> 16);
          m_pos = (w & 0xFFFF) ? m_start - static_cast<int>(w & 0xFFFF) : -1;
          return head.z;
        }
      } else if (j - 2 < nmore) {
        const HcSlot sl = more[j - 2];
        if (sl.ip == ip && sl.ilow == ilow && sl.longest == longest && sl.len >= 0) {
          ++j;
          c.frontier = ip;
          m_start = sl.start;
          m_pos = sl.pos;
          return sl.len;
        }
      }
    }
    ++j;
    return wider_match(c, ip, ilow, longest, m_start, m_pos, pa, false);
  }
};

__global__ void __launch_bounds__(kEpisodeThreads, kEpisodeMinBlocks) hc_episodes_rows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    const long long* __restrict__ toff, const long long* __restrict__ soff,
    const int* __restrict__ prev, int4* __restrict__ first, HcSlot* __restrict__ more,
    uint16_t* __restrict__ deltas, int k, int depth, int first_budget, int budget,
    int retry_longest) {
  const int row = blockIdx.y;
  const int src_off = src_offs[row];
  const int n = lens[row];
  const int p = blockIdx.x * kEpisodeThreads + threadIdx.x;  // window position
  if (p >= n) return;
  const int d = p - prev[toff[row] + p];
  deltas[toff[row] + p] = static_cast<uint16_t>(d > 0xFFFF ? 0xFFFF : d);
  if (p < src_off) return;
  const long long at = soff[row] + (p - src_off);
  const int nmore = k > 2 ? k - 2 : 0;
  HcSlot* mine = more + at * nmore;
  RecordSearch search{BudgetChain{base + starts[row], prev + toff[row], n - kLastLiterals,
                                  depth, first_budget},
                      make_int4(-1, -1, -1, 0), mine, k, 0, first_budget, budget,
                      retry_longest, depth > 128};
  if (n - src_off >= kMfLimit + 1 && p <= n - kMfLimit) {
    NullSink o;
    int ip = p, anchor = p;
    hc_episode(base + starts[row], n - kMfLimit, ip, anchor, o, search);
  }
  first[at] = search.head;
  for (int j = search.j > 2 ? search.j : 2; j < k; ++j) mine[j - 2] = HcSlot{-1, 0, 0, 0, 0, 0};
}

// ---- the parse by segments (parse_segments.cuh) ----------------------

struct HcTables {
  const long long* toff;
  const long long* soff;
  const int* prev;
  const int4* first;
  const HcSlot* more;
  const uint16_t* deltas;
  int k, depth;
};

// Segment g's walk from `start` (ip, anchor, frontier) by one thread: the
// episodes of the row's parse (ReplaySearch over the tables) from each
// state, every state recorded with its frontier raised to ip.
__device__ void hc_seg_walk(const SegPlan& p, int g, int4 start, int round, const HcTables& t) {
  const SegBounds b = seg_bounds(p, g);
  const int nmore = t.k > 2 ? t.k - 2 : 0;
  ReplaySearch search{
      FrontierChain{b.s, t.prev + t.toff[b.row], t.deltas + t.toff[b.row], b.n - kLastLiterals,
                    t.depth, start.z},
      t.first + t.soff[b.row], t.more + t.soff[b.row] * nmore, nullptr, make_int4(0, 0, 0, 0), 0,
      b.src_off, nmore, 0, t.depth > 128, b.n - b.src_off, -8};
  SegOut<false> o = seg_out<false>(p, g, b);
  int ip = start.x, anchor = start.y, key = 0;
  while (ip <= b.mflimit) {
    key = max(search.c.frontier, ip);
    if (o.state(ip, anchor, key)) break;
    search.begin(ip);
    hc_episode(b.s, b.mflimit, ip, anchor, o, search);
  }
  seg_finish(p, g, b, start, o, ip, anchor, key, round);
}

// One round: a thread (a CTA) for each segment to walk (round 0: every
// one, from its guess).
__global__ void __launch_bounds__(1) hc_seg_walks(SegPlan p, HcTables t, int round) {
  const int g = blockIdx.x;
  if (round > 0 && !p.todo[g]) return;
  atomicAdd(p.stats + round, 1);
  hc_seg_walk(p, g, seg_start(p, g, seg_bounds(p, g), round == 0), round, t);
}

// The serial tail, a thread a row: its first segment not exact walked
// from its predecessor's end and linked, until every one is (segment 0
// first where no round walked it).
__global__ void __launch_bounds__(1) hc_seg_tail(SegPlan p, HcTables t) {
  const int row = blockIdx.x;
  const int g0 = p.segoff[row], K = p.segoff[row + 1] - g0;
  if (p.walked[g0] < 0) {
    hc_seg_walk(p, g0, seg_start(p, g0, seg_bounds(p, g0), true), p.rounds, t);
    atomicAdd(p.stats + p.rounds + kStatTail, 1);
  }
  for (int f; (f = seg_settle(p, row)) < K;) {
    const int g = g0 + f;
    hc_seg_walk(p, g, p.next[g], p.rounds, t);
    atomicAdd(p.stats + p.rounds + kStatTail, 1);
    p.links[g] = seg_link(p, g);
    if (f + 1 < K) p.links[g + 1] = seg_link(p, g + 1);
  }
}

// The records a walk keeps at levels 3-9 (encode_hc_passes.hc_segment_caps):
// every episode's start is a state, one a position at most; its sequences
// start before its stop, and up to 1,024 more in the episode that crosses
// it.
__host__ __device__ constexpr int hc_head_cap(int overlap) { return overlap + 2; }
__host__ __device__ constexpr int hc_seq_cap(int segment, int overlap) {
  return (segment + overlap) / 4 + 1026;
}

SegPlan hc_plan(const void* base, const void* starts, const void* src_offs, const void* lens,
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
  p.head_cap = p.tail_cap = hc_head_cap(overlap);
  p.seq_cap = hc_seq_cap(segment, overlap);
  p.keyed = true;
  p.stats = static_cast<int*>(stats);
  seg_scratch(p, scratch, nseg, nrows);
  return p;
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
//
// Each launches on `stream`, does not synchronise, and returns the first
// CUDA error (0 on success).  The caller has checked every window against
// `base` and laid the tables out by `toff` and `soff`.

// `max_len` is the longest window: the grid is (ceil(max_len / 256),
// nrows), nrows <= 65,535.  `first` holds an int4 and `more` max(k - 2, 0)
// HcSlot records per block position, `deltas` a u16 per window position.
extern "C" int lz4t_hc_episodes(const void* base, const void* starts, const void* src_offs,
                                const void* lens, const void* toff, const void* soff,
                                const void* prev, void* first, void* more, void* deltas, int k,
                                int depth, int first_budget, int budget, int retry_longest,
                                int nrows, int max_len, void* stream) {
  const dim3 grid((max_len + kEpisodeThreads - 1) / kEpisodeThreads, nrows);
  hc_episodes_rows<<<grid, kEpisodeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(src_offs), static_cast<const int*>(lens),
      static_cast<const long long*>(toff), static_cast<const long long*>(soff),
      static_cast<const int*>(prev), static_cast<int4*>(first), static_cast<HcSlot*>(more),
      static_cast<uint16_t*>(deltas), k, depth, first_budget, budget, retry_longest);
  return static_cast<int>(cudaGetLastError());
}

// The parse by segments: rows cut into `segment` positions a segment
// (segoff [nrows + 1], seg_row [nseg]), each walked on past its end by
// `overlap`, `rounds` rounds of walks and checks, the serial tail, the
// emit.  `scratch` holds the bytes lz4t_hc_seg_scratch gives;
// `stats` int [rounds + 4]: each round's walks, the tail's, a record
// overflow flag, the links made behind a frontier and the links kept.
extern "C" int lz4t_hc_seg_scratch(long long nseg, int nrows, int segment, int overlap,
                         void* bytes) {
  SegPlan p{};
  p.head_cap = p.tail_cap = hc_head_cap(overlap);
  p.seq_cap = hc_seq_cap(segment, overlap);
  *static_cast<long long*>(bytes) = static_cast<long long>(seg_scratch(p, nullptr, nseg, nrows));
  return 0;
}

extern "C" int lz4t_hc_segment() { return kHcSegment; }
extern "C" int lz4t_hc_overlap() { return kHcOverlap; }

extern "C" int lz4t_hc_parse(const void* base, const void* starts, const void* src_offs,
                             const void* lens, const void* toff, const void* soff,
                             const void* prev, const void* first, const void* more,
                             const void* deltas, int k, void* out, long long out_stride,
                             int ocap, int depth, void* clens, void* errs, int nrows,
                             const void* segoff, const void* seg_row, int nseg, int segment,
                             int overlap, int rounds, void* scratch, void* stats,
                             void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const SegPlan p = hc_plan(base, starts, src_offs, lens, segoff, seg_row, nrows, nseg, segment,
                            overlap, rounds, scratch, stats);
  const HcTables t{static_cast<const long long*>(toff), static_cast<const long long*>(soff),
                   static_cast<const int*>(prev), static_cast<const int4*>(first),
                   static_cast<const HcSlot*>(more), static_cast<const uint16_t*>(deltas), k,
                   depth};
  cudaError_t e = seg_reset(p, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int r = 0; r < rounds; ++r) {
    hc_seg_walks<<<nseg, 1, 0, st>>>(p, t, r);
    seg_check<<<nrows, 128, 0, st>>>(p, r);
  }
  hc_seg_tail<<<nrows, 1, 0, st>>>(p, t);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(seg_emit(p, out, out_stride, ocap, clens, errs, st));
}
