// The LZ4 HC (levels 3-9) and OPT (levels 10-12) encode bodies of kernel
// D's HC/OPT kernel (encode_stream.cu), which also takes kernel B's rows at
// these levels: the hash-chain
// engine of lz4_tpu/native/lz4tpu.c (chain_insert, count_pattern,
// hc_wider_match, lz4tpu_encode_hc, lz4tpu_encode_opt), whose bytes the TPU
// kernels' `_encode_body` HC and OPT arms (lz4_tpu/ops/encode_pallas5.py:
// insert_upto, wider_match, hc_body, opt_body) reproduce, and so liblz4's
// LZ4_compress_HC at levels 3-12.
//
// A row is a flat window s[0, n): a prefix s[0, src_off) that enters the
// chain through the normal insert and that matches may reach, then the block
// s[src_off, n) to encode.  One thread runs a scan.  Its tables:
// - head: 2^15 most recent positions (int, kHcEmpty when empty), written
//   and read once per inserted position;
// - delta: the u16 ring of distances to the previous position of the same
//   hash, indexed pos & 0xFFFF at every window size, read at every chain step;
// - cells (OPT only): the price table of one 4,096-position window.
// The caller resets head and delta with hc_reset before each row.  Every
// read stays inside [0, n).
//
// The search (wider_match) reads its chain through a source type: Chain,
// the ring above, filled as the scan goes, or TableChain, the read-only
// tables of every position of a row that the level 12 and HC passes build
// (encode_opt.cu, encode_hc_passes.cu; FrontierChain reads the ring's
// answers from those tables when positions past the search are inserted).
// The OPT parse (opt_parse) and one HC episode (hc_episode) take their
// search as a callable: opt_scan and hc_scan hand them the ring's, the HC
// parse by segments FrontierChain's, the level 10-12 passes a read of a
// table of searches made ahead.  opt_parse_rounds is the OPT parse at
// levels 10-12 by one warp, its searches made up to 32 at a time over
// TableChain and its price-table steps spread over the lanes
// (opt_seed_warp, opt_add_warp).  SliceChain is a budgeted TableChain over
// a slice of a row whose chain deltas are staged in shared memory (the
// match pass).

#pragma once

#include <cstdint>

#include "lz4_encode_body.cuh"

namespace lz4t {

constexpr int kHcHashLog = 15;
constexpr int kHcEmpty = -65536;  // any i - kHcEmpty exceeds 0xFFFF: chain end
constexpr int kOptimalMl = 18;    // (ML_MASK - 1) + MIN_MATCH
constexpr int kOptNum = 4096;     // the optimal parse's window
constexpr int kOptTrailing = 3;

struct OptCell {
  int price, off, mlen, litlen;
};

constexpr int kHcThreads = 256;  // reset the tables together; one of them parses
constexpr int kHcHeadInts = 1 << kHcHashLog;
constexpr int kHcRingBytes = 65536 * static_cast<int>(sizeof(uint16_t));
constexpr int kOptCellsBytes = (kOptNum + kOptTrailing) * static_cast<int>(sizeof(OptCell));

// Reset one row's tables, by every thread of the CTA: head to kHcEmpty,
// delta to 0xFFFF (lz4tpu.c chain_init).
__device__ inline void hc_reset(int* head, uint16_t* delta) {
  int4* h = reinterpret_cast<int4*>(head);
  uint4* d = reinterpret_cast<uint4*>(delta);
  const int4 e = make_int4(kHcEmpty, kHcEmpty, kHcEmpty, kHcEmpty);
  const uint4 f = make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int i = threadIdx.x; i < kHcHeadInts / 4; i += blockDim.x) h[i] = e;
  for (int i = threadIdx.x; i < kHcRingBytes / 16; i += blockDim.x) d[i] = f;
}

__device__ __forceinline__ int read16(const uint8_t* s, int p) {
  return s[p] | (s[p + 1] << 8);
}

struct Chain {
  const uint8_t* s;
  int* head;
  uint16_t* delta;
  int inserted;    // positions [0, inserted) are in the tables
  int max_insert;  // read32 must stay in bounds
  int ihigh;       // match limit: n - LAST_LITERALS
  int attempts;    // chain steps per search
  static constexpr bool kBudgeted = false;
  static constexpr bool kCapped = false;

  __device__ inline void insert(int upto);
  // the most recent inserted position of hash h (the search is at pos)
  __device__ __forceinline__ int first(int h, int) const { return head[h]; }
  // the distance from q to the previous position of its hash
  __device__ __forceinline__ int step(int q) const { return delta[q & 0xFFFF]; }
};

__device__ inline void chain_insert(Chain& c, int upto) {
  if (upto > c.max_insert) upto = c.max_insert;
  for (int i = c.inserted; i < upto; ++i) {
    const int h = hash4<kHcHashLog>(read32(c.s, i));
    const int d = i - c.head[h];
    c.delta[i & 0xFFFF] = static_cast<uint16_t>(d > 0xFFFF ? 0xFFFF : d);
    c.head[h] = i;
  }
  if (upto > c.inserted) c.inserted = upto;
}

__device__ inline void Chain::insert(int upto) { chain_insert(*this, upto); }

// The chain of every position of a row at once, read-only: prev[p] is the
// previous position of p's hash in the row (kHcEmpty when none), for every
// p below n - 3.  What Chain holds when the search at pos begins, as long
// as nothing was inserted past pos (the OPT arm's searches): head[h] is
// prev[pos], and the ring's delta at q (pos - 65,535 <= q < pos) is
// min(q - prev[q], 0xFFFF).  With kBudget a search gives up once its
// work, one per chain step plus the bytes each match length and pattern
// run measures, would pass `budget`; wider_match then returns -1 - L, L
// the longest match it had found or, when a measure passed the budget,
// that measure + 4 if longer (a long repeat).
template <bool kBudget>
struct TableChainT {
  const uint8_t* s;
  const int* prev;
  int ihigh;
  int attempts;
  int budget;  // read with kBudget only
  static constexpr bool kBudgeted = kBudget;
  static constexpr bool kCapped = false;

  __device__ __forceinline__ void insert(int) {}
  __device__ __forceinline__ int first(int, int pos) const { return prev[pos]; }
  __device__ __forceinline__ int step(int q) const {
    const int d = q - prev[q];
    return d > 0xFFFF ? 0xFFFF : d;
  }
};
using TableChain = TableChainT<false>;

// TableChainT<true> over one slice of a row's positions, its chain deltas staged
// in shared memory (encode_opt.cu opt_matches_rows): min(q - prev[q],
// 0xFFFF) for q in [lo, the slice's end) at delta[q - lo].  A search at pos
// in the slice reads its head prev[pos] from device memory and its chain
// steps only at positions in [lowest = max(0, pos - 65,535), pos), lo <=
// lowest: wider_match steps from a candidate it has checked against
// `lowest`, or from one inside the current best, which ends at or before
// pos.  So every step reads a staged delta.  The bytes are read from the
// row in device memory (through L1).  The answers are TableChainT<true>'s.
struct SliceChain {
  const uint8_t* s;
  const int* prev;
  const uint16_t* delta;
  int lo;
  int ihigh;
  int attempts;
  int budget;
  static constexpr bool kBudgeted = true;
  static constexpr bool kCapped = false;

  __device__ __forceinline__ void insert(int) {}
  __device__ __forceinline__ int first(int, int pos) const { return __ldg(prev + pos); }
  __device__ __forceinline__ int step(int q) const { return delta[q - lo]; }
};

// The ring's answers read from the same tables when positions past the
// search may already be inserted: `frontier` is the ring's insert mark
// (every position below it inserted, raised to the search position by
// insert).  The head read at pos is then the latest position below the
// frontier with pos's hash, and the ring's delta at q is the one of the
// latest position below the frontier that shares q's ring slot
// (q & 0xFFFF), as the ring overwrites it.  With frontier == pos it reads
// what TableChain reads.  Each step reads `delta`, min(q - prev[q],
// 0xFFFF) as a u16 per position: half prev's bytes, so that a row's last
// 64 K steps and bytes fit one SM's L1.  `cap` (below ihigh) is a position
// no forward measure passes: a search whose measure reaches it returns -1
// (the match may run past it; encode_hc_passes.cu's walks end there).
struct FrontierChain {
  const uint8_t* s;
  const int* prev;
  const uint16_t* delta;
  int ihigh;
  int attempts;
  int frontier;
  int cap;
  static constexpr bool kBudgeted = false;
  static constexpr bool kCapped = true;

  __device__ __forceinline__ void insert(int pos) {
    if (pos > frontier) frontier = pos;
  }
  __device__ inline int first(int h, int pos) const {
    if (frontier <= pos) return prev[pos];
    for (int q = frontier - 1; q > pos; --q)
      if (hash4<kHcHashLog>(read32(s, q)) == h) return q;
    return pos;  // pos itself is inserted
  }
  __device__ __forceinline__ int step(int q) const {
    return delta[q + (((frontier - 1 - q) >> 16) << 16)];
  }
};

// Forward length over which bytes repeat the little-endian 4-byte pattern.
__device__ inline int count_pattern(const uint8_t* s, int p, int end, uint32_t pattern) {
  const int start = p;
  while (p + 4 <= end && read32(s, p) == pattern) p += 4;
  while (p < end && s[p] == (pattern & 0xFF)) {
    ++p;
    pattern = (pattern >> 8) | (pattern << 24);
  }
  return p - start;
}

// Backward pattern run length from p (the pattern scanned from its last
// byte), down to position `floor`: a word at a time while one fits (four
// bytes back the pattern is the same word), then byte by byte.
__device__ inline int count_back_pattern(const uint8_t* s, int p, uint32_t pattern,
                                         int floor = 0) {
  const int start = p;
  while (p - 4 >= floor && read32(s, p - 4) == pattern) p -= 4;
  while (p > floor && s[p - 1] == (pattern >> 24)) {
    --p;
    pattern = (pattern << 8) | (pattern >> 24);
  }
  return start - p;
}

// Widest match at ip whose start may slide back to ilow (lz4tpu.c
// hc_wider_match).  When it beats `longest` it sets m_start (>= ilow) and
// m_pos (the match source for m_start).  `pa`: repeated-pattern
// acceleration; `swap`: follow the chain entry inside the current best that
// jumps farthest back (the OPT search, which forces `pa` on).  C is Chain
// or TableChainT; a budgeted one returns -1 - L when the search gives up
// (TableChainT), each measure cut one byte past the budget's room, so that
// a search that stays inside it measures what an unbounded one does.
template <class C>
__device__ int wider_match(C& c, int ip, int ilow, int longest, int& m_start,
                           int& m_pos, bool pa, bool swap) {
  const uint8_t* s = c.s;
  const int pos = ip;
  const int lowest = pos > kMaxDistance ? pos - kMaxDistance : 0;
  const int lookback = ip - ilow;
  const uint32_t pattern = read32(s, ip);
  int attempts = c.attempts;
  int chain_off = 0;
  bool repeat_tested = false, repeat_confirmed = false;
  int src_pat_len = 0;
  int best_s = m_start, best_p = m_pos;
  int want = read16(s, ilow + longest - 1);  // the two bytes a wider match must reproduce
  int work = 0;                              // budgeted chains only

  c.insert(pos);
  int cand = c.first(hash4<kHcHashLog>(pattern), pos);
  while (cand >= pos) {  // self/ahead entries from lookahead probes
    const int d = c.step(cand);
    if (d > cand) {
      cand = -1;
      break;
    }
    cand -= d;
  }

  while (cand >= lowest && attempts > 0) {
    if constexpr (C::kBudgeted) {
      if (work > c.budget) return -1 - longest;
      ++work;
    }
    int match_len = 0;
    --attempts;
    // the step at cand, loaded beside the bytes it is compared with (a table
    // chain's steps are reads of device memory: one after the other they
    // would double each step's latency)
    const int d_here = c.step(cand);
    if (want == read16(s, cand - lookback + longest - 1) && read32(s, cand) == pattern) {
      int back = 0;
      if (lookback) {
        const int floor = ilow - ip > -cand ? ilow - ip : -cand;
        while (back > floor && s[ip + back - 1] == s[cand + back - 1]) --back;
      }
      int limit = c.ihigh;
      if constexpr (C::kBudgeted) limit = min(limit, ip + kMinMatch + c.budget - work + 1);
      if constexpr (C::kCapped) limit = min(limit, c.cap);
      const int run = run_length(s, cand + kMinMatch, ip + kMinMatch, limit);
      if constexpr (C::kCapped) {
        if (c.cap < c.ihigh && ip + kMinMatch + run >= c.cap) return -1;
      }
      if constexpr (C::kBudgeted) {
        if (run > c.budget - work) return -1 - max(longest, run + 4);
        work += run;
      }
      match_len = kMinMatch + run - back;
      if (match_len > longest) {
        longest = match_len;
        best_p = cand + back;
        best_s = ip + back;
        want = read16(s, ilow + longest - 1);
      }
    }

    if (swap && match_len == longest && cand + longest <= pos) {
      int best_jump = 1;
      const int end = longest - kMinMatch + 1;
      int step = 1, accel = 1 << 4;
      chain_off = 0;
      for (int q = 0; q < end; q += step) {
        const int d = q ? c.step(cand + q) : d_here;
        step = accel++ >> 4;
        if (d > best_jump) {
          best_jump = d;
          chain_off = q;
          accel = 1 << 4;
        }
      }
      if (best_jump > 1) {
        if (best_jump > cand) break;
        cand -= best_jump;
        continue;
      }
    }

    if (pa && d_here == 1 && chain_off == 0) {
      // the candidate sits in a run of a repeated pattern: jump straight to
      // the best-aligned position of the run
      const int cand2 = cand - 1;
      if (!repeat_tested) {
        repeat_tested = true;
        repeat_confirmed = (pattern & 0xFFFF) == (pattern >> 16) &&
                           (pattern & 0xFF) == (pattern >> 24);
        if (repeat_confirmed) {
          int end = c.ihigh;
          if constexpr (C::kBudgeted) end = min(end, ip + 5 + c.budget - work);
          if constexpr (C::kCapped) end = min(end, c.cap);
          const int run = count_pattern(s, ip + 4, end, pattern);
          if constexpr (C::kCapped) {
            if (c.cap < c.ihigh && ip + 4 + run >= c.cap) return -1;
          }
          if constexpr (C::kBudgeted) {
            if (run > c.budget - work) return -1 - max(longest, run + 4);
            work += run;
          }
          src_pat_len = run + 4;
        }
      }
      if (repeat_confirmed && cand2 >= lowest && read32(s, cand2) == pattern) {
        // the backward run is cut at lowest below (a budgeted search: where
        // its work runs out), so it is measured no further
        int end = c.ihigh, floor = lowest;
        if constexpr (C::kBudgeted) end = min(end, cand2 + 5 + c.budget - work);
        if constexpr (C::kCapped) end = min(end, c.cap);
        const int run = count_pattern(s, cand2 + 4, end, pattern);
        if constexpr (C::kCapped) {
          if (c.cap < c.ihigh && cand2 + 4 + run >= c.cap) return -1;
        }
        if constexpr (C::kBudgeted) {
          if (run > c.budget - work) return -1 - max(longest, run + 4);
          work += run;
          floor = max(0, cand2 - (c.budget - work) - 1);
        }
        const int fwd = run + 4;
        int backp = count_back_pattern(s, cand2, pattern, floor);
        if constexpr (C::kBudgeted) {
          if (backp > c.budget - work) return -1 - max(longest, backp + 4);
          work += backp;
        }
        if (backp > cand2 - lowest) backp = cand2 - lowest;
        const int seg = backp + fwd;
        if (seg >= src_pat_len && fwd <= src_pat_len) {
          cand = cand2 + fwd - src_pat_len;  // the run holds the source's: align to its end
        } else {
          cand = cand2 - backp;  // the run's farthest position
          if (lookback == 0) {
            const int max_ml = seg < src_pat_len ? seg : src_pat_len;
            if (longest < max_ml) {
              if (pos - cand > kMaxDistance) break;
              longest = max_ml;
              best_p = cand;
              best_s = ip;
              want = read16(s, ilow + longest - 1);
            }
            const int d2 = c.step(cand);
            if (d2 > cand) break;
            cand -= d2;
          }
        }
        continue;
      }
    }

    const int d = chain_off ? c.step(cand + chain_off) : d_here;
    if (d > cand) break;
    cand -= d;
  }
  m_start = best_s;
  m_pos = best_p;
  return longest;
}

// The HC arm's search over a chain source: wider_match without the chain
// swap, pattern analysis from 256 attempts (level 9) up.  A search callable
// of hc_episode is search(ip, ilow, longest, m_start, m_pos) -> length, the
// caller presetting m_start = ip and m_pos = -1; one whose kCanStop is set
// may return a negative length (a capped chain's measure reached its cap),
// which ends the episode where it stands.
template <class C>
struct ChainSearch {
  C& c;
  bool pa;
  static constexpr bool kCanStop = C::kCapped;
  __device__ __forceinline__ int operator()(int ip, int ilow, int longest, int& m_start,
                                            int& m_pos) {
    return wider_match(c, ip, ilow, longest, m_start, m_pos, pa, false);
  }
};

// One episode of the HC arm (lz4tpu.c lz4tpu_encode_hc): the
// three-candidate lookahead parse from ip.  A first search at ip; on a match
// ML1, probe for a strictly longer ML2 overlapping it, then an ML3 beyond
// ML2, resolving the overlaps with the OPTIMAL_ML trim rules, until the
// sequences are emitted.  Advances ip and anchor to where the parse goes
// on.  What an episode searches depends only on the window, ip and its
// searches' answers; its emits only add anchor.  Returns false where a
// search stopped it (Search::kCanStop), leaving ip and anchor as they were
// changed so far.
template <class Search, class Out>
__device__ __forceinline__ bool hc_episode(const uint8_t* s, int mflimit, int& ip, int& anchor,
                                           Out& o, Search& search) {
  int ml, ml0, ml2, ml3, ref, ref0, ref2, ref3, start0, start2, start3;
  {
    int ms = ip, mp = -1;
    ml = search(ip, ip, kMinMatch - 1, ms, mp);
    if (Search::kCanStop && ml < 0) return false;
    if (ml < kMinMatch) {
      ++ip;
      return true;
    }
    ref = mp;
  }
  start0 = ip;
  ref0 = ref;
  ml0 = ml;

search2:
  if (ip + ml <= mflimit) {
    start2 = ip + ml - 2;
    ref2 = -1;
    ml2 = search(start2, ip, ml, start2, ref2);
    if (Search::kCanStop && ml2 < 0) return false;
  } else {
    ml2 = ml;
  }
  if (ml2 == ml) {  // no better overlap: emit ML1
    emit(o, s, anchor, ip - anchor, ip - ref, ml);
    ip += ml;
    anchor = ip;
    return true;
  }
  if (start0 < ip && start2 < ip + ml0) {  // the skipped ML1 still fits: restore it
    ip = start0;
    ref = ref0;
    ml = ml0;
  }
  if (start2 - ip < 3) {  // ML1 too short to keep: ML2 replaces it
    ml = ml2;
    ip = start2;
    ref = ref2;
    goto search2;
  }

search3:
  if (start2 - ip < kOptimalMl) {  // trim ML1 so the pair packs token-optimally
    int new_ml = ml > kOptimalMl ? kOptimalMl : ml;
    if (ip + new_ml > start2 + ml2 - kMinMatch) new_ml = (start2 - ip) + ml2 - kMinMatch;
    const int corr = new_ml - (start2 - ip);
    if (corr > 0) {
      start2 += corr;
      ref2 += corr;
      ml2 -= corr;
    }
  }
  if (start2 + ml2 <= mflimit) {
    start3 = start2 + ml2 - 3;
    ref3 = -1;
    ml3 = search(start3, start2, ml2, start3, ref3);
    if (Search::kCanStop && ml3 < 0) return false;
  } else {
    ml3 = ml2;
  }
  if (ml3 == ml2) {  // stable pair: emit ML1 then ML2
    if (start2 < ip + ml) ml = start2 - ip;
    emit(o, s, anchor, ip - anchor, ip - ref, ml);
    anchor = ip + ml;
    emit(o, s, anchor, start2 - anchor, start2 - ref2, ml2);
    ip = start2 + ml2;
    anchor = ip;
    return true;
  }
  if (start3 < ip + ml + 3) {  // ML3 kills ML2
    if (start3 >= ip + ml) {   // ML1 can go now; ML3 becomes the new ML1
      if (start2 < ip + ml) {
        const int corr = (ip + ml) - start2;
        start2 += corr;
        ref2 += corr;
        ml2 -= corr;
        if (ml2 < kMinMatch) {
          start2 = start3;
          ref2 = ref3;
          ml2 = ml3;
        }
      }
      emit(o, s, anchor, ip - anchor, ip - ref, ml);
      anchor = ip + ml;
      ip = start3;
      ref = ref3;
      ml = ml3;
      start0 = start2;
      ref0 = ref2;
      ml0 = ml2;
      goto search2;
    }
    start2 = start3;
    ref2 = ref3;
    ml2 = ml3;
    goto search3;
  }
  // three ascending matches: emit ML1 (trimmed), shift the window
  if (start2 < ip + ml) {
    if (start2 - ip < kOptimalMl) {
      if (ml > kOptimalMl) ml = kOptimalMl;
      if (ip + ml > start2 + ml2 - kMinMatch) ml = (start2 - ip) + ml2 - kMinMatch;
      const int corr = ml - (start2 - ip);
      if (corr > 0) {
        start2 += corr;
        ref2 += corr;
        ml2 -= corr;
      }
    } else {
      ml = start2 - ip;
    }
  }
  emit(o, s, anchor, ip - anchor, ip - ref, ml);
  anchor = ip + ml;
  ip = start2;
  ref = ref2;
  ml = ml2;
  start2 = start3;
  ref2 = ref3;
  ml2 = ml3;
  goto search3;
}

// The HC arm's parse of a row: episodes from src_off until the last match
// position, then the final literals.
template <class Search>
__device__ void hc_parse(const uint8_t* s, int src_off, int n, Sink& o, Search& search) {
  int anchor = src_off;
  if (n - src_off >= kMfLimit + 1) {
    const int mflimit = n - kMfLimit;
    int ip = src_off;
    while (ip <= mflimit) hc_episode(s, mflimit, ip, anchor, o, search);
  }
  emit(o, s, anchor, n - anchor, 0, 0);
}

// The HC arm over the ring: every prefix position inserted, then the parse
// with the ring's search (`attempts` chain steps per search).
__device__ void hc_scan(const uint8_t* s, int src_off, int n, int attempts, Sink& o,
                        int* head, uint16_t* delta) {
  Chain c{s, head, delta, 0, n - kMinMatch + 1, n - kLastLiterals, attempts};
  if (n - src_off >= kMfLimit + 1) chain_insert(c, src_off);
  ChainSearch<Chain> search{c, attempts > 128};
  hc_parse(s, src_off, n, o, search);
}

__device__ __forceinline__ int lit_price(int litlen) {
  return litlen + (litlen >= 15 ? 1 + (litlen - 15) / 255 : 0);
}

__device__ __forceinline__ int seq_price(int litlen, int mlen) {
  return 3 + lit_price(litlen) +
         (mlen >= 15 + kMinMatch ? 1 + (mlen - 15 - kMinMatch) / 255 : 0);
}

// Best (length, offset) at ip by the chain-swap search; length 0 when none
// is longer than min_len.
template <class C>
__device__ __forceinline__ int opt_find(C& c, int ip, int min_len, int& off) {
  int ms = ip, mp = -1;
  const int len = wider_match(c, ip, ip, min_len, ms, mp, true, true);
  if (len <= min_len) return 0;
  off = ip - mp;
  return len;
}

__device__ __forceinline__ void opt_set(OptCell& cell, int price, int off, int mlen, int litlen) {
  cell.price = price;
  cell.off = off;
  cell.mlen = mlen;
  cell.litlen = litlen;
}

// The price table's steps of the serial parse (opt_parse; the warp's are
// opt_seed_warp and opt_add_warp below).  Seed a window: leading literals,
// then the first match at its start.
__device__ inline void opt_seed(OptCell* cells, int llen, int first_len, int first_off) {
  for (int r = 0; r < kMinMatch; ++r) opt_set(cells[r], lit_price(llen + r), 0, 1, llen + r);
  for (int m = kMinMatch; m <= first_len; ++m)
    opt_set(cells[m], seq_price(llen, m), first_off, m, llen);
  for (int a = 1; a <= kOptTrailing; ++a)
    opt_set(cells[first_len + a], cells[first_len].price + lit_price(a), 0, 1, a);
}

// Price the match (new_len, new_off) found at cur and the literals after
// cur; returns the window's new last position.
__device__ inline int opt_add(OptCell* cells, int cur, int new_len, int new_off, int last) {
  {  // literal extensions from cur
    const int base_ll = cells[cur].litlen;
    const int base_p = cells[cur].price;
    for (int l = 1; l < kMinMatch; ++l) {
      const int price = base_p - lit_price(base_ll) + lit_price(base_ll + l);
      if (price < cells[cur + l].price) opt_set(cells[cur + l], price, 0, 1, base_ll + l);
    }
  }
  {  // match lengths from cur
    const bool lit = cells[cur].mlen == 1;
    const int ll = lit ? cells[cur].litlen : 0;
    const int base = lit ? (cur > ll ? cells[cur - ll].price : 0) : cells[cur].price;
    for (int m = kMinMatch; m <= new_len; ++m) {
      const int p = cur + m;
      const int price = base + seq_price(ll, m);
      if (p > last + kOptTrailing || price <= cells[p].price) {
        if (m == new_len && last < p) last = p;
        opt_set(cells[p], price, new_off, m, ll);
      }
    }
  }
  for (int a = 1; a <= kOptTrailing; ++a)
    opt_set(cells[last + a], cells[last].price + lit_price(a), 0, 1, a);
  return last;
}

// The same two steps by one warp (opt_parse_rounds), every lane calling
// with the same arguments.  Each match length m writes only cells[m] (the
// seed) or cells[cur + m] (opt_add) and reads nothing another length writes,
// so lane l takes m = 4 + l, 4 + l + 32, ...; the literal extensions (cells
// cur + 1..3) and the seed's leading literals take lanes 1-3 and 0-3.  In
// opt_add only m == new_len can move `last`, against the `last` from before
// the loop: its lane hands the new one to the warp, and the trailing
// literals, which read cells[last], follow a __syncwarp.  The seed's
// trailing literals price cells[first_len], which the seed sets to
// seq_price(llen, first_len).  The caller orders these writes before any
// lane's reads with a __syncwarp.
__device__ inline void opt_seed_warp(OptCell* cells, int llen, int first_len, int first_off) {
  const int lane = lane_id();
  if (lane < kMinMatch) opt_set(cells[lane], lit_price(llen + lane), 0, 1, llen + lane);
  for (int m = kMinMatch + lane; m <= first_len; m += 32)
    opt_set(cells[m], seq_price(llen, m), first_off, m, llen);
  if (lane >= 1 && lane <= kOptTrailing)
    opt_set(cells[first_len + lane], seq_price(llen, first_len) + lit_price(lane), 0, 1, lane);
}

__device__ inline int opt_add_warp(OptCell* cells, int cur, int new_len, int new_off, int last) {
  const int lane = lane_id();
  const OptCell at = cells[cur];
  if (lane >= 1 && lane < kMinMatch) {  // the literal extension to cur + lane
    const int price = at.price - lit_price(at.litlen) + lit_price(at.litlen + lane);
    if (price < cells[cur + lane].price) opt_set(cells[cur + lane], price, 0, 1, at.litlen + lane);
  }
  const bool lit = at.mlen == 1;
  const int ll = lit ? at.litlen : 0;
  const int base = lit ? (cur > ll ? cells[cur - ll].price : 0) : at.price;
  int moved = last;
  for (int m = kMinMatch + lane; m <= new_len; m += 32) {
    const int p = cur + m;
    const int price = base + seq_price(ll, m);
    if (p > last + kOptTrailing || price <= cells[p].price) {
      if (m == new_len && last < p) moved = p;
      opt_set(cells[p], price, new_off, m, ll);
    }
  }
  last = __shfl_sync(kFull, moved, (new_len - kMinMatch) & 31);
  __syncwarp();  // every length's cells before cells[last] is read
  if (lane >= 1 && lane <= kOptTrailing)
    opt_set(cells[last + lane], cells[last].price + lit_price(lane), 0, 1, lane);
  return last;
}

// Reverse the chosen path in place: its last step (sel_len, sel_off) ends
// at cur + sel_len.
__device__ inline void opt_reverse(OptCell* cells, int cur, int sel_len, int sel_off) {
  for (int p = cur;;) {
    const int nl = cells[p].mlen, no = cells[p].off;
    cells[p].mlen = sel_len;
    cells[p].off = sel_off;
    sel_len = nl;
    sel_off = no;
    if (nl > p) break;  // reached the first step
    p -= nl;
  }
}

__device__ __forceinline__ void emit(WarpSink& o, const uint8_t* s, int anchor, int ll, int off,
                                     int ml) {
  warp_emit(o, s, anchor, ll, off, ml);
}

// Emit the reversed path of a window forward, from ip; advances ip and
// anchor past it.
template <class Out>
__device__ inline void opt_emit(const uint8_t* s, const OptCell* cells, int last, int& ip,
                                int& anchor, Out& o) {
  for (int r = 0; r < last;) {
    const int m = cells[r].mlen, off = cells[r].off;
    if (m == 1) {
      ++ip;
      ++r;
      continue;
    }
    r += m;
    emit(o, s, anchor, ip - anchor, off, m);
    ip += m;
    anchor = ip;
  }
}

// The OPT arm's parse (lz4tpu.c lz4tpu_encode_opt): the exact price-model
// optimal parse over 4,096-position windows, a match longer than
// `sufficient` (<= 4,095) taken at once, and with `full` (level 12) every
// position searched anew.  find(p, min_len, off) is the chain-swap search
// at p (opt_find); positions are searched in increasing order, each at most
// once.
template <class Find>
__device__ void opt_parse(const uint8_t* s, int src_off, int n, int sufficient, bool full,
                          Sink& o, OptCell* cells, Find& find) {
  int anchor = src_off;
  if (n - src_off >= kMfLimit + 1) {
    const int mflimit = n - kMfLimit;
    int ip = src_off;
    while (ip <= mflimit) {
      const int llen = ip - anchor;
      int first_off = 0;
      const int first_len = find(ip, kMinMatch - 1, first_off);
      if (first_len == 0) {
        ++ip;
        continue;
      }
      if (first_len > sufficient) {  // long enough: take it outright
        emit(o, s, anchor, llen, first_off, first_len);
        ip += first_len;
        anchor = ip;
        continue;
      }
      opt_seed(cells, llen, first_len, first_off);
      int last = first_len;
      int best_mlen, best_off, cur;
      for (cur = 1; cur < last; ++cur) {
        if (ip + cur > mflimit) break;
        if (cells[cur + 1].price <= cells[cur].price &&
            (!full || cells[cur + kMinMatch].price < cells[cur].price + 3))
          continue;
        int new_off = 0;
        const int new_len = find(ip + cur, full ? kMinMatch - 1 : last - cur, new_off);
        if (new_len == 0) continue;
        if (new_len > sufficient || new_len + cur >= kOptNum) {
          best_mlen = new_len;
          best_off = new_off;
          last = cur + 1;
          goto encode;
        }
        last = opt_add(cells, cur, new_len, new_off, last);
      }
      best_mlen = cells[last].mlen;
      best_off = cells[last].off;
      cur = last - best_mlen;

    encode:
      opt_reverse(cells, cur, best_mlen, best_off);
      opt_emit(s, cells, last, ip, anchor, o);
    }
  }
  emit(o, s, anchor, n - anchor, 0, 0);
}

// The OPT arm's parse (opt_parse) by one warp, its searches made up to 32
// at a time: levels 10-11 with `full` false, level 12 with `full` true.
// `t` is the row's table of every position's min-length-3 search
// (encode_opt.cu opt_matches_rows: (0, 0) for none, a length below 0 where
// it gave up); `c` makes a search on the spot.  Two facts make the rounds
// exact:
// 1. opt_find(p, m) equals opt_find(p, 3) for m <= 3: the quick reject's two
//    bytes lie inside the 4-byte compare, every measured match and pattern
//    length is at least 4, so the chain swap and pattern step act alike.
//    So a search with a minimum length of 3 or less reads the table (one
//    that gave up there is made on the spot).  At level 12 every search
//    has minimum length 3, so every lane reads the table.
// 2. A search that finds nothing changes nothing: the parse goes on to the
//    next position before it writes a cell or `last`.  From a given state
//    every later position's skip test (level 12's with its extra clause)
//    and minimum length (last - cur, or 3) stay as the state gives them up
//    to the first search that finds a match.
// So at levels 10-11 each round the lanes take the next <= 32 positions the
// state does not skip, each searches (or reads the table) with the state's
// minimum length, the lanes' searches on the spot running side by side,
// and the warp commits them in order up to the first that finds a match,
// which it applies (opt_add_warp); the next round starts after it.  At level
// 12 no search depends on the state, so a round reads the table entries of
// the next 32 positions and commits their matches in order: after each
// commit the lanes past it test their positions against the new cells, and
// a lane whose position is open and whose entry gave up searches on the
// spot (side by side with the others).  Where the window starts, the lanes
// read 32 table entries and take the first nonzero one.
// Every lane keeps the same scalar state (positions, last, anchor, the
// output cursor).  Every lane writes cells in opt_seed_warp and
// opt_add_warp; lane 0 alone reverses the path; a __syncwarp orders each
// phase's writes before the next phase's reads and its reads before the
// next writes.  `lane_pos` (32 ints of shared memory) hands each lane its
// position.
//
// opt_walk_rounds is the loop from the state (ip, anchor) up to mflimit,
// its sequences given to emit(o, ...); at_state(o, ip, anchor), asked at
// the top of every turn of the loop (a window's start, or the next 32
// positions read where none had a match), ends the walk where it returns
// true (the segment walks, parse_segments.cuh; never for a WarpSink);
// at_window(o) is told where a window opens (its seed reads the anchor).
__device__ __forceinline__ bool at_state(WarpSink&, int, int) { return false; }
__device__ __forceinline__ void at_window(WarpSink&) {}

template <bool full, class C, class Out>
__device__ void opt_walk_rounds(const uint8_t* s, int& ip_, int& anchor_, int mflimit,
                                int sufficient, const int2* t, C& c, Out& o, OptCell* cells,
                                int* lane_pos) {
  const int lane = lane_id();
  int ip = ip_, anchor = anchor_;
  while (ip <= mflimit) {
    if (at_state(o, ip, anchor)) break;
    int first_len, first_off;
    {  // the first of the next 32 table entries that is not (0, 0)
      const int2 e = ip + lane <= mflimit ? t[ip + lane] : make_int2(0, 0);
      const unsigned hit = __ballot_sync(kFull, e.x != 0);
      if (hit == 0) {
        ip += 32;
        continue;
      }
      const int k = __ffs(static_cast<int>(hit)) - 1;
      ip += k;
      first_len = __shfl_sync(kFull, e.x, k);
      first_off = __shfl_sync(kFull, e.y, k);
    }
    if (first_len < 0) first_len = opt_find(c, ip, kMinMatch - 1, first_off);  // gave up
    if (first_len == 0) {
      ++ip;
      continue;
    }
    at_window(o);
    const int llen = ip - anchor;
    if (first_len > sufficient) {  // long enough: take it outright
      emit(o, s, anchor, llen, first_off, first_len);
      ip += first_len;
      anchor = ip;
      continue;
    }
    opt_seed_warp(cells, llen, first_len, first_off);
    int last = first_len, cur = 1, best_mlen = 0, best_off = 0;
    bool early = false;
    // the serial loop's skip test at window position q
    auto open_at = [cells](int q) {
      return cells[q + 1].price > cells[q].price ||
             (full && cells[q + kMinMatch].price >= cells[q].price + 3);
    };
    for (;;) {  // one round
      int end = min(last, mflimit - ip + 1);
      if (cur >= end) break;
      __syncwarp();  // the cells before the reads
      int mine, next;  // this lane's position; where the round's positions end
      int2 e = make_int2(0, 0);
      if (full) {  // the next 32 positions, each lane's table entry read once
        mine = cur + lane;
        next = cur + 32;
        if (ip + mine <= mflimit) e = t[ip + mine];
      } else {
        int got = 0;  // positions not skipped, the first 32 in lane_pos
        for (int c0 = cur; c0 < end && got < 32; c0 += 32) {
          const int q = c0 + lane;
          const bool open = q < end && open_at(q);
          const unsigned ball = __ballot_sync(kFull, open);
          const int rank = got + __popc(ball & ((1u << lane) - 1u));
          if (open && rank < 32) lane_pos[rank] = q;
          got += __popc(ball);
        }
        __syncwarp();  // lane_pos before the reads; the cells' reads before the writes
        mine = lane < got ? lane_pos[lane] : -1;
        next = got >= 32 ? lane_pos[31] + 1 : end;
      }
      for (;;) {  // the round's commits, in position order
        int len = 0, off = 0;
        if (full) {
          // an entry does not depend on the state: after a commit the
          // lanes past it test their positions again against the new cells
          if (mine >= cur && mine < end && open_at(mine)) {
            if (e.x < 0) e.x = opt_find(c, ip + mine, kMinMatch - 1, e.y);  // gave up
            len = e.x;
            off = e.y;
          }
        } else if (mine >= 0) {
          const int m = last - mine;
          const int2 te = m < kMinMatch ? t[ip + mine] : make_int2(-1, 0);
          if (te.x >= 0) {
            len = te.x;
            off = te.y;
          } else {
            len = opt_find(c, ip + mine, m, off);
          }
        }
        const unsigned found = __ballot_sync(kFull, len != 0);
        if (found == 0) {
          cur = next;
          break;
        }
        const int k = __ffs(static_cast<int>(found)) - 1;
        cur = __shfl_sync(kFull, mine, k);
        const int new_len = __shfl_sync(kFull, len, k);
        const int new_off = __shfl_sync(kFull, off, k);
        if (new_len > sufficient || new_len + cur >= kOptNum) {
          best_mlen = new_len;
          best_off = new_off;
          last = cur + 1;
          early = true;
          break;
        }
        last = opt_add_warp(cells, cur, new_len, new_off, last);
        ++cur;
        end = min(last, mflimit - ip + 1);
        // levels 10-11: the new state changed the minimum lengths of the
        // lanes past the commit, so their searches are made again
        if (!full || cur >= end) break;
        __syncwarp();  // the cells before the reads
      }
      if (early) break;
    }
    __syncwarp();  // every lane's cells before lane 0 walks the path
    if (lane == 0) {
      if (!early) {
        best_mlen = cells[last].mlen;
        best_off = cells[last].off;
        cur = last - best_mlen;
      }
      opt_reverse(cells, cur, best_mlen, best_off);
    }
    __syncwarp();
    opt_emit(s, cells, last, ip, anchor, o);  // every lane alike
    __syncwarp();  // the cells' reads before the next window's seed
  }
  ip_ = ip;
  anchor_ = anchor;
}

template <bool full, class C>
__device__ void opt_parse_rounds(const uint8_t* s, int src_off, int n, int sufficient,
                                 const int2* t, C& c, WarpSink& o, OptCell* cells,
                                 int* lane_pos) {
  int ip = src_off, anchor = src_off;
  if (n - src_off >= kMfLimit + 1)
    opt_walk_rounds<full>(s, ip, anchor, n - kMfLimit, sufficient, t, c, o, cells, lane_pos);
  warp_emit(o, s, anchor, n - anchor, 0, 0);
}

// The OPT arm over the ring: every prefix position inserted, then the parse
// with the ring's search (`searches` chain steps).
__device__ void opt_scan(const uint8_t* s, int src_off, int n, int searches, int sufficient,
                         bool full, Sink& o, int* head, uint16_t* delta, OptCell* cells) {
  Chain c{s, head, delta, 0, n - kMinMatch + 1, n - kLastLiterals, searches};
  if (n - src_off >= kMfLimit + 1) chain_insert(c, src_off);
  auto find = [&c](int ip, int min_len, int& off) { return opt_find(c, ip, min_len, off); };
  opt_parse(s, src_off, n, sufficient, full, o, cells, find);
}

}  // namespace lz4t
