// The segment schedule of the level 3-11 parses (encode_hc_passes.cu
// hc_parse, encode_opt.cu opt_parse_spec): its records, the check between
// rounds, the serial tail's steps and the emit.  The plain model is
// lz4_tpu_torch/ops/parse_segments.py `schedule`, which says why it is
// exact; the walks are the parses' own loops (hc_episode from each state,
// lz4_hc_body.cuh opt_walk_rounds), here into a SegOut.
//
// A launch's rows are cut into segments: row r holds segments
// [segoff[r], segoff[r + 1]), at least one; its segment k covers the parse
// positions from lo = src_off + k * segment.  A walk of segment g keeps:
// - its sequences (start, length, offset), seq_cap at most;
// - its first head_cap states (ip, key, sequences before it), and
//   its states at or past the next segment's start (its tail), tail_cap at
//   most (the HC parse keeps every state, keyed by its frontier; the OPT
//   parse the states where ip == anchor, key 0);
// - its start and end states, its counts (SegWalk).
// It stops at its first state at or past lo + segment + overlap (the
// row's last segment at the row's end).
//
// Each round: the walk kernel walks every segment to walk (round 0: all,
// each from its guessed state, ip = anchor = key = lo); then seg_links
// computes the links of the segments next to a walk of the round
// (seg_link, a merge of two state lists, a thread a segment), and
// seg_check, one CTA per row, settles the row (seg_settle, one thread
// scanning records its CTA stages): the first segment without a valid
// link, and for every such segment a walk in the next round from its
// predecessor's end state (a row settled in an earlier round is left
// alone).  After the rounds, the tail kernel (one CTA a row) walks the
// row's first segment not exact from its predecessor's end and links it,
// until every segment is.  Then seg_sizes (a warp a segment) counts the
// bytes of each segment's kept sequences (the last kept segment of a row
// with the row's last literals), seg_offsets (a CTA a row) scans them into
// each segment's offset in its row, and seg_write (a warp a segment)
// writes them there.
//
// What bounds the schedule: the walks, each a dependent walk of its
// segment and overlap; a round is as slow as its slowest walk.  The checks
// and the emit move the records (~20 bytes a position walked) and the
// output once: bytes, ~0.1 ms per 16 MiB.

#pragma once

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"

namespace lz4t {

// The HC parse's segments: its walks are one thread each, 128 to a CTA; a
// walk's time grows with its length, so short segments, many walks at
// once, are fastest until the schedule's rounds and links take over.
// Parse ms (hc9bench.py; NVIDIA H100 80GB HBM3, 700 W), 256 x 64 KB / 16
// x 4 MiB of the mix / 16 x 4 MiB of random bytes, by (segment, overlap):
// (256, 64) 19.6 / 82.3 / 28.5; (512, 128) 26.1 / 65.3 / 25.4; (1024,
// 256) 44.6 / 82.4 / 19.3; (4096, 256) 132.4 / 229.9 / 19.6.  At 512 +
// 128, 0.4-0.9% of the mix's segments are walked again in a second round.
constexpr int kHcSegment = 512;
constexpr int kHcOverlap = 128;
// The OPT parse's segments: a warp each (its price table in device
// memory, 32 an SM); the links seen at level 11 lie within ~510
// positions of a segment's start (ops/parse_segments.py).
constexpr int kOptSegment = 16384;
constexpr int kOptOverlap = 2048;

// stats: walks of each round, then these
constexpr int kStatTail = 0, kStatOverflow = 1, kStatBehind = 2, kStatLinks = 3,
              kStatInts = 4;

struct SegState {
  int ip, key, seq;
};

struct SegSeq {
  int start, len, off;
};

struct SegWalk {
  int start_ip, start_anchor, start_key;
  int end_ip, end_anchor, end_key;  // end_ip -1: the walk reached the row's end
  int nseq, nhead, ntail;
  int free;  // its states read no anchor: an HC walk; an OPT walk with no window, no tail state
};

constexpr int kLinkNone = 0, kLinkMade = 1, kLinkCovered = 2;

// Segment g's link to g - 1: the walk before keeps its sequences up to
// keep_to, g's from keep_from, at the state (ip, key); `free`: made at
// g's start with its anchor replaced (seg_settle).
struct SegLink {
  int kind, keep_to, keep_from, ip, key, free;
};

struct SegPlan {
  const uint8_t* base;
  const long long* starts;
  const int* src_offs;
  const int* lens;
  const int* segoff;   // [nrows + 1]
  const int* seg_row;  // [nseg]
  int nrows, nseg, rounds;
  int segment, overlap, head_cap, tail_cap, seq_cap;
  bool keyed;  // HC: every state recorded, keyed by the frontier
  SegSeq* seqs;
  SegState* heads;
  SegState* tails;
  SegWalk* walks;
  SegLink* links;
  int* todo;
  int* walked;  // the round of each segment's last walk (-1: none)
  int4* next;   // the state each segment is walked from next (w 1: an exact one)
  int* row_last;  // each row's last kept segment once every one is exact (-1 before)
  int* row_bad;   // a kept segment's walk held more sequences than its records (seg_settle)
  int* lits;      // where the literals before each segment's first kept sequence start
  int* seg_bytes;  // each segment's bytes (seg_sizes), then their offsets in the row
  int* stats;  // [rounds + kStatInts]
};

inline size_t seg_align(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// The scratch of `nseg` segments over `nrows` rows, carved into `p` where
// `scratch` is given; returns its bytes.
inline size_t seg_scratch(SegPlan& p, void* scratch, long long nseg, int nrows) {
  size_t at = 0;
  auto take = [&](size_t bytes) {
    void* ptr = scratch ? static_cast<char*>(scratch) + at : nullptr;
    at += seg_align(bytes);
    return ptr;
  };
  p.seqs = static_cast<SegSeq*>(take(nseg * p.seq_cap * sizeof(SegSeq)));
  p.heads = static_cast<SegState*>(take(nseg * p.head_cap * sizeof(SegState)));
  p.tails = static_cast<SegState*>(take(nseg * p.tail_cap * sizeof(SegState)));
  p.walks = static_cast<SegWalk*>(take(nseg * sizeof(SegWalk)));
  p.links = static_cast<SegLink*>(take(nseg * sizeof(SegLink)));
  p.todo = static_cast<int*>(take(nseg * sizeof(int)));
  p.walked = static_cast<int*>(take(nseg * sizeof(int)));
  p.next = static_cast<int4*>(take(nseg * sizeof(int4)));
  p.row_last = static_cast<int*>(take(nrows * sizeof(int)));
  p.row_bad = static_cast<int*>(take(nrows * sizeof(int)));
  p.lits = static_cast<int*>(take(nseg * sizeof(int)));
  p.seg_bytes = static_cast<int*>(take(nseg * sizeof(int)));
  return at;
}

// A walk's bounds: its segment's start (lo), the next segment's (next_lo,
// INT_MAX for the row's last), where it stops, and the row's last parse
// position (mflimit; below src_off for a block shorter than 13 bytes).
struct SegBounds {
  int row, k, last, lo, next_lo, stop, src_off, n, mflimit;
  const uint8_t* s;
};

__device__ inline SegBounds seg_bounds(const SegPlan& p, int g) {
  SegBounds b;
  b.row = p.seg_row[g];
  b.k = g - p.segoff[b.row];
  b.last = p.segoff[b.row + 1] - p.segoff[b.row] - 1;
  b.src_off = p.src_offs[b.row];
  b.n = p.lens[b.row];
  b.s = p.base + p.starts[b.row];
  b.lo = b.src_off + b.k * p.segment;
  b.next_lo = b.k == b.last ? INT_MAX : b.lo + p.segment;
  b.stop = b.k == b.last ? INT_MAX : b.lo + p.segment + p.overlap;
  b.mflimit = b.n - b.src_off >= kMfLimit + 1 ? b.n - kMfLimit : b.src_off - 1;
  return b;
}

// Where a walk of g starts: its guess in round 0, else the state set for
// it (the tail sets it too).
__device__ inline int4 seg_start(const SegPlan& p, int g, const SegBounds& b, bool first) {
  return first ? make_int4(b.lo, b.lo, b.lo, 0) : p.next[g];
}

// A walk's recorder: every lane of a warp (kWarp) keeps the same counts,
// lane 0 writes.
template <bool kWarp>
struct SegOut {
  SegSeq* seqs;
  SegState* heads;
  SegState* tails;
  int nseq, nhead, ntail;
  int next_lo, stop, head_cap, tail_cap, seq_cap;
  bool keyed;
  int overflow, windows;

  __device__ __forceinline__ bool writer() const { return !kWarp || lane_id() == 0; }
  // A state at the top of the loop: recorded, and true where the walk stops.
  __device__ inline bool state(int ip, int anchor, int key) {
    if (keyed || ip == anchor) {
      const SegState st{ip, key, nseq};
      if (nhead < head_cap) {
        if (writer()) heads[nhead] = st;
        ++nhead;
      }
      if (ip >= next_lo) {
        if (ntail < tail_cap) {
          if (writer()) tails[ntail] = st;
          ++ntail;
        } else {
          overflow = 1;
        }
      }
    }
    return ip >= stop;
  }
  __device__ inline void put(int start, int off, int len) {
    if (nseq < seq_cap) {
      if (writer()) seqs[nseq] = SegSeq{start, len, off};
    } else {
      overflow = 1;
    }
    ++nseq;
  }
};

template <bool kWarp>
__device__ __forceinline__ void emit(SegOut<kWarp>& o, const uint8_t*, int anchor, int ll,
                                     int off, int ml) {
  o.put(anchor + ll, off, ml);
}

// The OPT walk's states (opt_walk_rounds): key 0; and its windows.
__device__ __forceinline__ bool at_state(SegOut<true>& o, int ip, int anchor) {
  return o.state(ip, anchor, 0);
}
__device__ __forceinline__ void at_window(SegOut<true>& o) { o.windows = 1; }

template <bool kWarp>
__device__ inline SegOut<kWarp> seg_out(const SegPlan& p, int g, const SegBounds& b) {
  return SegOut<kWarp>{p.seqs + static_cast<long long>(g) * p.seq_cap,
                       p.heads + static_cast<long long>(g) * p.head_cap,
                       p.tails + static_cast<long long>(g) * p.tail_cap,
                       0, 0, 0, b.next_lo, b.stop, p.head_cap, p.tail_cap, p.seq_cap, p.keyed, 0,
                       0};
}

// After a walk from `start` that ended at (ip, anchor, key): its summary
// (by the writer), the round it was walked in.
template <bool kWarp>
__device__ inline void seg_finish(const SegPlan& p, int g, const SegBounds& b, const int4 start,
                                  const SegOut<kWarp>& o, int ip, int anchor, int key,
                                  int round) {
  if (!o.writer()) return;
  const bool ended = ip > b.mflimit;
  p.walks[g] = SegWalk{start.x, start.y, start.z, ended ? -1 : ip, anchor, ended ? 0 : key,
                       o.nseq, o.nhead, o.ntail, p.keyed || (!o.windows && !o.ntail)};
  p.walked[g] = round;
  p.todo[g] = 0;
  if (o.overflow) atomicOr(p.stats + p.rounds + kStatOverflow, 1);
}

// Segment g's link to g - 1 (g not a row's first): the first state of
// g - 1's tail that g's head holds (a link at g's start is seg_settle's).
__device__ inline SegLink seg_link(const SegPlan& p, int g) {
  const SegWalk a = p.walks[g - 1], b = p.walks[g];
  if (a.end_ip < 0) return SegLink{kLinkCovered, 0, 0, 0, 0, 0};
  if (p.walked[g] < 0) return SegLink{kLinkNone, 0, 0, 0, 0, 0};
  const SegState* t = p.tails + static_cast<long long>(g - 1) * p.tail_cap;
  const SegState* h = p.heads + static_cast<long long>(g) * p.head_cap;
  int i = 0, j = 0;
  while (i < a.ntail && j < b.nhead) {
    const SegState x = t[i], y = h[j];
    if (y.ip < x.ip) {
      ++j;
    } else if (y.ip > x.ip) {
      ++i;
    } else if (y.key == x.key) {
      return SegLink{kLinkMade, x.seq, y.seq, x.ip, x.key, 0};
    } else {
      ++i;
      ++j;
    }
  }
  return SegLink{kLinkNone, 0, 0, 0, 0, 0};
}

// Segment g's kept sequences: [a, b) of its walk's.
__device__ __forceinline__ int seg_kept_from(const SegPlan& p, int k, int g) {
  return k ? p.links[g].keep_from : 0;
}
__device__ __forceinline__ int seg_kept_to(const SegPlan& p, int k, int last, int g) {
  return k == last ? p.walks[g].nseq : p.links[g + 1].keep_to;
}

__device__ __forceinline__ void prefetch_l1(const void* q) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(q));
#endif
}

// How far ahead of its scan seg_settle prefetches a segment's records: one
// thread reads them one segment after another (~3 dependent L2 reads a
// segment without it).
constexpr int kSettleAhead = 16;

// The row's first segment not exact (K where every one is; then its last
// kept segment to row_last, and each kept segment's literal start to
// lits: the end of the row's kept sequence before its first, which may
// lie in an earlier segment, as an HC state's anchor in the walk does not
// tell); every segment without a valid link is set to be walked next from
// the effective end of the walk before.  A link is valid at or past the
// state where the segment before was linked, or where that one has no
// link yet; else a walk is linked at its start where that start is the
// effective end, and a free walk (SegWalk::free: its states read no
// anchor) where its ip and key are: its own end's effective anchor is
// then that end's (it read none).
// The scan's state from one segment to the next (seg_settle_step).
struct SegSettle {
  int K, f, last, prev_kind, prev_ip;
  int4 eff;  // the effective end of the walk before
};

__device__ inline SegSettle seg_settle_begin(const SegPlan& p, int row) {
  const int g0 = p.segoff[row], K = p.segoff[row + 1] - g0;
  const SegWalk w0 = p.walks[g0];
  return SegSettle{K, K, K - 1, kLinkMade, p.src_offs[row],
                   make_int4(w0.end_ip, w0.end_anchor, w0.end_key, 0)};
}

// Segment k (g, k >= 1) of the scan, given its link l, walk b and whether
// it was walked; false where the scan ends (a covered link).
__device__ inline bool seg_settle_step(const SegPlan& p, SegSettle& c, int k, int g, SegLink l,
                                       const SegWalk& b, bool walked) {
  if (l.kind == kLinkCovered) {
    c.last = k - 1;
    return false;
  }
  bool ok = l.kind == kLinkMade && (c.prev_kind != kLinkMade || l.ip >= c.prev_ip);
  const int4 eff = c.eff;
  if (!ok && walked && eff.x >= 0 && b.start_ip == eff.x && b.start_key == eff.z &&
      (b.start_anchor == eff.y || b.free)) {
    l = SegLink{kLinkMade, p.walks[g - 1].nseq, 0, b.start_ip, b.start_key,
                b.start_anchor != eff.y};
    p.links[g] = l;
    ok = true;
  }
  if (!ok) {
    if (c.f == c.K) c.f = k;
    p.next[g] = make_int4(eff.x, eff.y, eff.z, c.f == k);  // w: the first, whose start is exact
    p.todo[g] = 1;
  }
  c.prev_kind = l.kind;
  c.prev_ip = l.ip;
  c.eff = walked ? make_int4(b.end_ip, l.free ? eff.y : b.end_anchor, b.end_key, 0)
                 : make_int4(-1, 0, 0, 0);
  return true;
}

// After the scan: the first segment not exact, or K where every one is,
// and then the row's last kept segment and each kept one's literal start.
__device__ inline int seg_settle_end(const SegPlan& p, int row, const SegSettle& c) {
  if (c.f < c.K) return c.f;
  const int g0 = p.segoff[row], last = c.last;
  p.row_last[row] = last;
  int end = p.src_offs[row], bad = 0;
  for (int k = 0; k <= last; ++k) {
    const int g = g0 + k, a = seg_kept_from(p, k, g);
    int b = seg_kept_to(p, k, last, g);
    if (b > p.seq_cap) {  // sequences past the walk's records: the row's output is flagged
      bad = 1;
      b = p.seq_cap;
    }
    if (k + kSettleAhead <= last) {
      prefetch_l1(p.links + g + kSettleAhead);
      prefetch_l1(p.walks + g + kSettleAhead);
    }
    p.lits[g] = end;
    if (b > a) {
      const SegSeq q = p.seqs[static_cast<long long>(g) * p.seq_cap + b - 1];
      end = q.start + q.len;
    }
  }
  p.row_bad[row] = bad;
  return c.K;
}

// The scan by one thread, its records read from device memory (the serial
// tails).
__device__ inline int seg_settle(const SegPlan& p, int row) {
  const int g0 = p.segoff[row];
  SegSettle c = seg_settle_begin(p, row);
  for (int k = 1; k < c.K; ++k) {
    const int g = g0 + k;
    if (k + kSettleAhead < c.K) {  // the records a few segments on into L1
      prefetch_l1(p.links + g + kSettleAhead);
      prefetch_l1(p.walks + g + kSettleAhead);
      prefetch_l1(p.walked + g + kSettleAhead);
    }
    if (!seg_settle_step(p, c, k, g, p.links[g], p.walks[g], p.walked[g] >= 0)) break;
  }
  return seg_settle_end(p, row, c);
}

}  // namespace lz4t

namespace {

using namespace lz4t;

constexpr int kCheckThreads = 128;
constexpr int kCheckChunk = 256;  // segments staged at a time for the scan

// A settled row's literal starts and record flag, by the CTA (what
// seg_settle_end's loop does one segment after another, ~1 us each): each
// kept segment's last kept sequence's end, then a scan that carries the
// last such end before each segment (src_off before the first).
__device__ inline void seg_lits(const SegPlan& p, int row, int last) {
  __shared__ int warp_end[kCheckThreads / 32];
  const int g0 = p.segoff[row];
  const int lane = lane_id(), warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  int carry = p.src_offs[row], bad = 0;
  for (int base = 0; base <= last; base += blockDim.x) {
    const int k = base + static_cast<int>(threadIdx.x), g = g0 + k;
    int end = -1;  // no kept sequence
    if (k <= last) {
      const int a = seg_kept_from(p, k, g);
      int b = seg_kept_to(p, k, last, g);
      if (b > p.seq_cap) {  // sequences past the walk's records: the row's output is flagged
        bad = 1;
        b = p.seq_cap;
      }
      if (b > a) {
        const SegSeq q = p.seqs[static_cast<long long>(g) * p.seq_cap + b - 1];
        end = q.start + q.len;
      }
    }
    int x = end;  // the warp's scan: the last end at or before each lane
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d && x < 0) x = y;
    }
    if (lane == 31) warp_end[warp] = x;
    __syncthreads();
    int before = carry, after = carry;  // the last end before this warp, and before the next step
    for (int w = 0; w < warps; ++w) {
      if (warp_end[w] >= 0) {
        if (w < warp) before = warp_end[w];
        after = warp_end[w];
      }
    }
    const int left = __shfl_up_sync(kFull, x, 1);
    if (k <= last) p.lits[g] = lane > 0 && left >= 0 ? left : before;
    carry = after;
    __syncthreads();  // the ends read before the next step writes them
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) p.row_bad[row] = bad;
}

// After a round's walks, first: the link of every segment next to a walk
// of the round (not a row's first), a thread a segment.
__global__ void __launch_bounds__(kCheckThreads) seg_links(SegPlan p, int round) {
  const int g = blockIdx.x * kCheckThreads + threadIdx.x;
  if (g >= p.nseg) return;
  const int row = p.seg_row[g];
  if (g == p.segoff[row] || p.row_last[row] >= 0) return;
  if (p.walked[g] == round || p.walked[g - 1] == round) p.links[g] = seg_link(p, g);
}

// Then one CTA per row (a row settled in an earlier round has nothing left
// to walk or link: row_last is set): its threads stage the row's records
// kCheckChunk segments at a time in shared memory, where one thread scans
// them (seg_settle, whose reads one after another from device memory took
// ~1 us a segment); a row that settles gets its literal starts from the
// whole CTA (seg_lits).
__global__ void __launch_bounds__(kCheckThreads) seg_check(SegPlan p) {
  __shared__ SegLink links[kCheckChunk];
  __shared__ SegWalk walks[kCheckChunk];
  __shared__ int walked[kCheckChunk];
  __shared__ int more;
  const int row = blockIdx.x;
  if (p.row_last[row] >= 0) return;
  const int g0 = p.segoff[row], K = p.segoff[row + 1] - g0;
  SegSettle c{};
  if (threadIdx.x == 0) {
    c = seg_settle_begin(p, row);
    more = 1;
  }
  for (int k0 = 1; k0 < K; k0 += kCheckChunk) {
    const int n = min(kCheckChunk, K - k0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      links[i] = p.links[g0 + k0 + i];
      walks[i] = p.walks[g0 + k0 + i];
      walked[i] = p.walked[g0 + k0 + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n && more; ++i)
        more = seg_settle_step(p, c, k0 + i, g0 + k0 + i, links[i], walks[i], walked[i] >= 0);
    }
    __syncthreads();
    if (!more) break;
  }
  __shared__ int settled;  // the row's last kept segment once it settles, else -1
  if (threadIdx.x == 0) {
    settled = c.f == c.K ? c.last : -1;
    if (settled >= 0) p.row_last[row] = settled;
  }
  __syncthreads();
  if (settled >= 0) seg_lits(p, row, settled);
}

__device__ __forceinline__ int vle_bytes(int v) { return v >= 15 ? 1 + (v - 15) / 255 : 0; }

// Bytes of a sequence with `ll` literals and a match of `ml` (0: the last
// literals).
__device__ __forceinline__ int seq_bytes(int ll, int ml) {
  return 1 + vle_bytes(ll) + ll + (ml ? 2 + vle_bytes(ml - kMinMatch) : 0);
}

// Segment g's kept sequences [a, b), where the literals before the first
// start, and whether it is its row's last kept segment (-1 in a: none
// kept).
struct SegKeep {
  int a, b, anchor;
  bool last;
};

__device__ inline SegKeep seg_keep(const SegPlan& p, int g, const SegBounds& bd) {
  const int last = p.row_last[bd.row];
  if (bd.k > last) return SegKeep{-1, -1, 0, false};
  return SegKeep{seg_kept_from(p, bd.k, g), min(seg_kept_to(p, bd.k, last, g), p.seq_cap),
                 p.lits[g],
                 bd.k == last};
}

// The literals before kept sequence i of g and its match (the end of the
// sequence before, or `keep.anchor` for the first).
__device__ __forceinline__ void seg_seq(const SegSeq* seqs, const SegKeep& keep, int i,
                                        int& anchor, SegSeq& q) {
  q = seqs[i];
  if (i == keep.a) {
    anchor = keep.anchor;
  } else {
    const SegSeq e = seqs[i - 1];
    anchor = e.start + e.len;
  }
}

// Each segment's bytes (its row's last literals with its last kept
// segment): a warp a segment.
__global__ void __launch_bounds__(32) seg_sizes(SegPlan p) {
  const int g = blockIdx.x;
  const SegBounds bd = seg_bounds(p, g);
  const SegKeep keep = seg_keep(p, g, bd);
  const int lane = lane_id();
  if (keep.a < 0) {
    if (lane == 0) p.seg_bytes[g] = 0;
    return;
  }
  const SegSeq* seqs = p.seqs + static_cast<long long>(g) * p.seq_cap;
  int total = 0;
  for (int i = keep.a + lane; i < keep.b; i += 32) {
    int anchor;
    SegSeq q;
    seg_seq(seqs, keep, i, anchor, q);
    total += seq_bytes(q.start - anchor, q.len);
  }
  for (int d = 16; d; d >>= 1) total += __shfl_xor_sync(kFull, total, d);
  if (lane != 0) return;
  if (keep.last) {
    int end = keep.anchor;
    if (keep.b > keep.a) end = seqs[keep.b - 1].start + seqs[keep.b - 1].len;
    total += seq_bytes(bd.n - end, 0);
  }
  p.seg_bytes[g] = total;
  if (bd.k) {
    atomicAdd(p.stats + p.rounds + kStatLinks, 1);
    if (p.keyed && p.links[g].key != p.links[g].ip) atomicAdd(p.stats + p.rounds + kStatBehind, 1);
  }
}

struct ByteOut {
  uint8_t* out;
  int cap, op;
  __device__ __forceinline__ void put(int b) {
    if (op < cap) out[op] = static_cast<uint8_t>(b);
    ++op;
  }
  __device__ inline void vle(int v) {
    for (; v >= 255; v -= 255) put(255);
    put(v);
  }
};

// `count` bytes of s from `from` to out[at..], by the warp: 16 bytes a lane
// a step (a row of incompressible bytes is one run of literals).
__device__ __forceinline__ void warp_copy(uint8_t* out, int cap, int at, const uint8_t* s,
                                          int from, int count) {
  int i = lane_id() * 16;
  for (; i + 16 <= count; i += 512) {
    uint8_t b[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) b[j] = s[from + i + j];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (at + i + j < cap) out[at + i + j] = b[j];
  }
  for (const int stop = min(i + 16, count); i < stop; ++i)  // the lane's last, partial 16
    if (at + i < cap) out[at + i] = s[from + i];
}

// Literal runs a lane copies itself; longer ones the warp copies.
constexpr int kLaneLiterals = 16;

// Each row's segment sizes to their exclusive prefix sums, in place: a CTA
// a row, 256 segments a step.
__global__ void __launch_bounds__(256) seg_offsets(SegPlan p) {
  __shared__ int warp_sums[8];
  const int row = blockIdx.x;
  const int g0 = p.segoff[row], K = p.segoff[row + 1] - g0;
  const int lane = lane_id(), warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < K; base += 256) {
    const int k = base + static_cast<int>(threadIdx.x);
    const int v = k < K ? p.seg_bytes[g0 + k] : 0;
    int x = v;  // the warp's inclusive scan
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < 8; ++w) {
      const int t = warp_sums[w];
      if (w < warp) before += t;
      total += t;
    }
    if (k < K) p.seg_bytes[g0 + k] = carry + before + x - v;
    carry += total;
    __syncthreads();  // the sums read before the next step writes them
  }
}

// Each segment's kept sequences at its row's offset, a warp a segment: 32
// sequences a step, their offsets a scan of their sizes; the last kept
// segment of a row writes the row's last literals, its length and flag.
__global__ void __launch_bounds__(32) seg_write(SegPlan p, uint8_t* __restrict__ out,
                                                long long out_stride, int ocap,
                                                int* __restrict__ clens,
                                                int* __restrict__ errs) {
  const int g = blockIdx.x;
  const SegBounds bd = seg_bounds(p, g);
  const SegKeep keep = seg_keep(p, g, bd);
  if (keep.a < 0) return;
  const int lane = lane_id();
  int op = p.seg_bytes[g];  // the bytes of the row's segments before g (seg_offsets)
  uint8_t* row = out + bd.row * out_stride;
  const int cap = static_cast<int>(out_stride);
  const SegSeq* seqs = p.seqs + static_cast<long long>(g) * p.seq_cap;
  for (int base = keep.a; base < keep.b; base += 32) {
    const int i = base + lane;
    int anchor = 0, ll = 0, size = 0;
    SegSeq q{0, 0, 0};
    if (i < keep.b) {
      seg_seq(seqs, keep, i, anchor, q);
      ll = q.start - anchor;
      size = seq_bytes(ll, q.len);
    }
    int at = size;  // inclusive scan of the sizes
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, at, d);
      if (lane >= d) at += v;
    }
    const int step = __shfl_sync(kFull, at, 31);
    at += op - size;
    int lits = 0;  // where this lane's literals go
    if (i < keep.b) {
      const int mlc = q.len - kMinMatch;
      ByteOut o{row, cap, at};
      o.put(((ll >= 15 ? 15 : ll) << 4) | (mlc >= 15 ? 15 : mlc));
      if (ll >= 15) o.vle(ll - 15);
      lits = o.op;
      if (ll <= kLaneLiterals)
        for (int c = 0; c < ll; ++c)
          if (lits + c < cap) row[lits + c] = bd.s[anchor + c];
      o.op += ll;
      o.put(q.off & 0xFF);
      o.put(q.off >> 8);
      if (mlc >= 15) o.vle(mlc - 15);
    }
    unsigned long_runs = __ballot_sync(kFull, i < keep.b && ll > kLaneLiterals);
    while (long_runs) {
      const int src = __ffs(static_cast<int>(long_runs)) - 1;
      long_runs &= long_runs - 1;
      warp_copy(row, cap, __shfl_sync(kFull, lits, src), bd.s, __shfl_sync(kFull, anchor, src),
                __shfl_sync(kFull, ll, src));
    }
    op += step;
  }
  if (!keep.last) return;
  int end = keep.anchor;
  if (keep.b > keep.a) end = seqs[keep.b - 1].start + seqs[keep.b - 1].len;
  const int ll = bd.n - end;
  const int vle = ll >= 15 ? (ll - 15) / 255 : -1;  // bytes of 255, then one more
  if (lane == 0 && op < cap) row[op] = static_cast<uint8_t>((ll >= 15 ? 15 : ll) << 4);
  ++op;
  if (vle >= 0) {
    for (int c = lane; c < vle; c += 32)
      if (op + c < cap) row[op + c] = 255;
    if (lane == 0 && op + vle < cap) row[op + vle] = static_cast<uint8_t>((ll - 15) % 255);
    op += vle + 1;
  }
  warp_copy(row, cap, op, bd.s, end, ll);
  op += ll;
  if (lane == 0) {  // a row whose records fell short is flagged as an output that overflowed
    clens[bd.row] = op;
    errs[bd.row] = op > ocap || p.row_bad[bd.row] ? 1 : 0;
  }
}

// After round r's walks: the links, then each row settled.
inline void seg_round_check(const SegPlan& p, int r, cudaStream_t st) {
  seg_links<<<(p.nseg + kCheckThreads - 1) / kCheckThreads, kCheckThreads, 0, st>>>(p, r);
  seg_check<<<p.nrows, kCheckThreads, 0, st>>>(p);
}

// The rounds' start: no segment walked or linked, no row settled.
inline cudaError_t seg_reset(const SegPlan& p, cudaStream_t st) {
  cudaError_t e = cudaMemsetAsync(p.walked, 0xFF, sizeof(int) * p.nseg, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(p.links, 0, sizeof(SegLink) * p.nseg, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(p.todo, 0, sizeof(int) * p.nseg, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(p.walks, 0, sizeof(SegWalk) * p.nseg, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(p.row_last, 0xFF, sizeof(int) * p.nrows, st);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(p.stats, 0, sizeof(int) * (p.rounds + kStatInts), st);
  return e;
}

// After the rounds and the tail: the sizes, their offsets, then the bytes.
inline cudaError_t seg_emit(const SegPlan& p, void* out, long long out_stride, int ocap,
                            void* clens, void* errs, cudaStream_t st) {
  seg_sizes<<<p.nseg, 32, 0, st>>>(p);
  seg_offsets<<<p.nrows, 256, 0, st>>>(p);
  seg_write<<<p.nseg, 32, 0, st>>>(p, static_cast<uint8_t*>(out), out_stride, ocap,
                                  static_cast<int*>(clens), static_cast<int*>(errs));
  return cudaGetLastError();
}

}  // namespace
