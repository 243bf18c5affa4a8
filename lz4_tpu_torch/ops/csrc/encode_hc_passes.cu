// The HC arm (levels 3-9) as passes: after the chain pass, the deltas and
// the parse by segments.
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
// that matches may reach.  `prev` (encode_opt.cu's chain pass, the first
// pass) holds every window position back to back from toff[r]; `deltas`
// holds every window position's chain step as a u16, laid out as prev.
//
// Why passes: the HC parse runs in episodes (lz4_hc_body.cuh hc_episode),
// each a first search at ip and the lookahead searches that follow from its
// answers.  Every search is made with the positions below the row's
// frontier (the highest position searched so far) inserted in the chain:
// the ring's answers, which FrontierChain reads from prev and deltas.  So
// the parse from a state (ip, the frontier raised to ip) is a function of
// that state, and a row's parse can be cut into segments walked at once
// from guessed states (parse_segments.cuh).  The serial arm makes the
// searches one after another, one thread per row on one CTA per SM (its
// 128 KB ring in shared memory): 132 threads for the card, each chain step
// a dependent read with nothing to hide it.  Here:
// 2. hc_deltas_rows: one thread per window position p writes p's chain
//    step min(p - prev[p], 0xFFFF) to `deltas` (half prev's bytes, which
//    each chain step reads).
// 3. The parse by segments: every row cut into segments of kHcSegment
//    positions, each walked by its own thread from a guessed state (ip =
//    anchor = frontier = the segment's start) on past its end by
//    kHcOverlap, making every search of its episodes on the spot over prev
//    and deltas (FrontierChain at the walk's frontier: the serial arm's
//    searches, where the parse needs them and nowhere else), and joined to
//    the walk before where their states meet (parse_segments.cuh:
//    hc_seg_walks, seg_links, seg_check, hc_seg_tail, the emit).
//    kWalkThreads walks to a CTA, a walk a thread: at 512 positions a
//    segment, 131,072 walks for 64 MiB of 4 MiB rows and 32,768 for 256
//    rows of 64 KB.  No search is made ahead of the parse: a pass that
//    searched every block position's episode made ~34 times the chain
//    steps the parse reads (hc9bench.py --host), into 208 bytes of tables a
//    block byte.
//
// What bounds them: the deltas by their bytes (prev read, deltas written:
// 6 bytes a position, ~0.12 ms per 64 MiB at 3.35 TB/s).  The parse by its
// schedule's slowest walk and the rounds its links take (one thread's
// dependent steps: an episode after another, each search's chain steps a
// read of `deltas` after another); its bytes (the window, prev and deltas
// read, the output written) are ~0.15 ms per 16 MiB.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"
#include "lz4_hc_body.cuh"
#include "parse_segments.cuh"

using namespace lz4t;

namespace {

constexpr int kDeltaThreads = 256;
// Walks (threads) of the parse by segments a CTA, and CTAs an SM its
// registers are held to: 64 registers, no spills (64 or 256 walks a CTA,
// or room for 128 registers, ran no faster on the H100).
constexpr int kWalkThreads = 128;
constexpr int kWalkMinBlocks = 8;

__global__ void __launch_bounds__(kDeltaThreads) hc_deltas_rows(
    const int* __restrict__ lens, const long long* __restrict__ toff,
    const int* __restrict__ prev, uint16_t* __restrict__ deltas) {
  const int row = blockIdx.y;
  const int p = blockIdx.x * kDeltaThreads + threadIdx.x;  // window position
  if (p >= lens[row]) return;
  const long long at = toff[row] + p;
  const int d = p - prev[at];
  deltas[at] = static_cast<uint16_t>(d > 0xFFFF ? 0xFFFF : d);
}

// ---- the parse by segments (parse_segments.cuh) ----------------------

struct HcTables {
  const long long* toff;
  const int* prev;
  const uint16_t* deltas;
  int depth;
};

// Segment g's walk from `start` (ip, anchor, frontier) by one thread: the
// episodes of the row's parse from each state, every search made on the
// spot with the ring's answers at the walk's frontier, every state
// recorded with its frontier raised to ip.  The walk's measures stop a
// segment past its stop (FrontierChain::cap): an episode whose search
// would measure a match or a pattern run past that ends the walk at the
// state where the episode began, its sequences dropped; the first episode
// of a walk from an exact state (`exact`: a row's first segment in the
// first round, the first segment not exact in a later one, every walk of
// the tail) measures in full.  So a long repeat is measured once, by the
// walk that needs it, and not by every walk that starts inside it (4 MiB
// of zeros: 8,192 walks, each measuring to the row's end twice, took
// minutes); a cap at the stop itself ended walks at most matches that
// cross it, and their links with them.
__device__ void hc_seg_walk(const SegPlan& p, int g, int4 start, int round, const HcTables& t,
                            bool exact) {
  const SegBounds b = seg_bounds(p, g);
  FrontierChain c{b.s, t.prev + t.toff[b.row], t.deltas + t.toff[b.row], b.n - kLastLiterals,
                  t.depth, start.z, b.stop};
  ChainSearch<FrontierChain> search{c, t.depth > 128};
  SegOut<false> o = seg_out<false>(p, g, b);
  int ip = start.x, anchor = start.y, key = 0;
  for (bool first = true; ip <= b.mflimit; first = false) {
    key = max(c.frontier, ip);
    if (o.state(ip, anchor, key)) break;
    c.cap = first && exact ? INT_MAX : b.stop == INT_MAX ? INT_MAX : b.stop + p.segment;
    const int ip0 = ip, anchor0 = anchor, nseq0 = o.nseq;
    if (!hc_episode(b.s, b.mflimit, ip, anchor, o, search)) {  // capped: the walk ends here
      ip = ip0;
      anchor = anchor0;
      o.nseq = nseq0;
      break;
    }
  }
  seg_finish(p, g, b, start, o, ip, anchor, key, round);
}

// One round: a thread for each segment to walk (round 0: every one, from
// its guess), kWalkThreads consecutive segments to a CTA.
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks) hc_seg_walks(SegPlan p,
                                                                             HcTables t,
                                                                             int round) {
  const int g = blockIdx.x * kWalkThreads + threadIdx.x;
  if (g >= p.nseg || (round > 0 && !p.todo[g])) return;
  atomicAdd(p.stats + round, 1);
  const SegBounds b = seg_bounds(p, g);
  const int4 start = seg_start(p, g, b, round == 0);
  hc_seg_walk(p, g, start, round, t, round == 0 ? b.k == 0 : start.w != 0);
}

// The serial tail, a thread a row: its first segment not exact walked
// from its predecessor's end and linked, until every one is (segment 0
// first where no round walked it).
__global__ void __launch_bounds__(1) hc_seg_tail(SegPlan p, HcTables t) {
  const int row = blockIdx.x;
  if (p.row_last[row] >= 0) return;  // settled in a round
  const int g0 = p.segoff[row], K = p.segoff[row + 1] - g0;
  if (p.walked[g0] < 0) {
    hc_seg_walk(p, g0, seg_start(p, g0, seg_bounds(p, g0), true), p.rounds, t, true);
    atomicAdd(p.stats + p.rounds + kStatTail, 1);
  }
  for (int f; (f = seg_settle(p, row)) < K;) {
    const int g = g0 + f;
    hc_seg_walk(p, g, p.next[g], p.rounds, t, true);
    atomicAdd(p.stats + p.rounds + kStatTail, 1);
    p.links[g] = seg_link(p, g);
    if (f + 1 < K) p.links[g + 1] = seg_link(p, g + 1);
  }
}

// The records a walk keeps at levels 3-9 (encode_hc_passes.hc_segment_caps):
// every episode's start is a state, one a position at most; its sequences
// start before its stop, and up to 256 more in the episode that crosses it
// (each turn of an episode's loop needs a longer match than the turn
// before: 256 turns take tens of KB of ever longer matches).  A row whose
// kept walks held more is flagged in errs, as an output that overflowed.
__host__ __device__ constexpr int hc_head_cap(int overlap) { return overlap + 2; }
__host__ __device__ constexpr int hc_seq_cap(int segment, int overlap) {
  return (segment + overlap) / 4 + 258;
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
// `base` and laid the tables out by `toff`.

// `max_len` is the longest window: the grid is (ceil(max_len / 256),
// nrows), nrows <= 65,535.  `deltas` a u16 per window position.
extern "C" int lz4t_hc_deltas(const void* lens, const void* toff, const void* prev,
                              void* deltas, int nrows, int max_len, void* stream) {
  const dim3 grid((max_len + kDeltaThreads - 1) / kDeltaThreads, nrows);
  hc_deltas_rows<<<grid, kDeltaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lens), static_cast<const long long*>(toff),
      static_cast<const int*>(prev), static_cast<uint16_t*>(deltas));
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
                             const void* lens, const void* toff, const void* prev,
                             const void* deltas, void* out, long long out_stride, int ocap,
                             int depth, void* clens, void* errs, int nrows, const void* segoff,
                             const void* seg_row, int nseg, int segment, int overlap,
                             int rounds, void* scratch, void* stats, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const SegPlan p = hc_plan(base, starts, src_offs, lens, segoff, seg_row, nrows, nseg, segment,
                            overlap, rounds, scratch, stats);
  const HcTables t{static_cast<const long long*>(toff), static_cast<const int*>(prev),
                   static_cast<const uint16_t*>(deltas), depth};
  cudaError_t e = seg_reset(p, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ctas = (nseg + kWalkThreads - 1) / kWalkThreads;
  for (int r = 0; r < rounds; ++r) {
    hc_seg_walks<<<ctas, kWalkThreads, 0, st>>>(p, t, r);
    seg_round_check(p, r, st);
  }
  hc_seg_tail<<<nrows, 1, 0, st>>>(p, t);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(seg_emit(p, out, out_stride, ocap, clens, errs, st));
}
