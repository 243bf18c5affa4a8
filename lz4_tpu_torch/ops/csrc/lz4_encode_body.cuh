// The LZ4 encode primitives (sequence writer, match length, hashes) that
// the HC and OPT bodies (lz4_hc_body.cuh) run on one thread, and the two
// FAST scans of lz4_tpu/native/lz4tpu.c (lz4tpu_encode_fast_canonical and
// lz4tpu_encode_fast), whose bytes the TPU kernels' `_encode_body`
// (lz4_tpu/ops/encode_pallas5.py) reproduces, run by one warp (kernel D's
// `encode_windows`, encode_stream.cu).
//
// A row is a flat window s[0, n): a prefix s[0, src_off) that matches may
// reach (a dictionary, or the previous 64 KB of a chained frame), then the
// source bytes s[src_off, n) to encode.  Positions are int: a row is at most
// a 4 MB block plus a 64 KB window.  Every read stays inside [0, n), or, for
// the warp scans' aligned word loads, inside the 4-byte words that hold the
// window's bytes.  The caller zeroes the hash table first (every table below
// reads 0 as "empty").

#pragma once

#include <cstdint>

namespace lz4t {

constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kSkipTrigger = 6;
constexpr int kMaxDistance = 65535;
constexpr int kCanonHashLog16 = 13;  // upstream byU16 table (LZ4_HASHLOG + 1)
constexpr int kCanonHashLog32 = 12;  // upstream byU32 table (LZ4_HASHLOG)
constexpr int kCanon64K = 65536 + kMfLimit - 1;  // LZ4_64Klimit: byU32 at/above
constexpr int kDenseHashLog = 15;
constexpr int kDense16Max = 65536;  // the longest window of a 16-bit dense table

__device__ __forceinline__ uint32_t read32(const uint8_t* s, int p) {
  return static_cast<uint32_t>(s[p]) | (static_cast<uint32_t>(s[p + 1]) << 8) |
         (static_cast<uint32_t>(s[p + 2]) << 16) |
         (static_cast<uint32_t>(s[p + 3]) << 24);
}

__device__ __forceinline__ uint64_t read64(const uint8_t* s, int p) {
  return static_cast<uint64_t>(read32(s, p)) |
         (static_cast<uint64_t>(read32(s, p + 4)) << 32);
}

template <int kHashLog>
__device__ __forceinline__ int hash4(uint32_t w) {
  return static_cast<int>((w * 2654435761u) >> (32 - kHashLog));
}

// upstream LZ4_hash5, the byU32 table's hash: the 5 low bytes of v (CUDA's
// native 64-bit multiply; the TPU kernel split it into 32-bit pieces).
__device__ __forceinline__ int canon_hash5(uint64_t v) {
  return static_cast<int>(((v << 24) * 889523592379ULL) >> (64 - kCanonHashLog32));
}

// Output cursor of one row: bytes past the row's width are counted but not
// written (the overflow flag reports them).
struct Sink {
  uint8_t* out;
  int op;
  int cap;
  __device__ __forceinline__ void put(int b) {
    if (op < cap) out[op] = static_cast<uint8_t>(b);
    ++op;
  }
};

// Common run of s[a..] and s[b..] (a < b), clipped at `limit` - b.
__device__ inline int run_length(const uint8_t* s, int a, int b, int limit) {
  const int b0 = b;
  while (b + 4 <= limit) {
    const uint32_t x = read32(s, a) ^ read32(s, b);
    if (x) return b - b0 + ((__ffs(static_cast<int>(x)) - 1) >> 3);
    a += 4;
    b += 4;
  }
  while (b < limit && s[a] == s[b]) {
    ++a;
    ++b;
  }
  return b - b0;
}

__device__ inline void put_vle(Sink& o, int v) {
  while (v >= 255) {
    o.put(255);
    v -= 255;
  }
  o.put(v);
}

// One sequence: literals s[anchor, anchor + ll), then a match of `ml` bytes
// at offset `off` (ml == 0: the final literals, no match).
__device__ inline void emit(Sink& o, const uint8_t* s, int anchor, int ll, int off, int ml) {
  const int mlc = ml ? ml - kMinMatch : 0;
  o.put(((ll >= 15 ? 15 : ll) << 4) | (mlc >= 15 ? 15 : mlc));
  if (ll >= 15) put_vle(o, ll - 15);
  for (int k = 0; k < ll; ++k) o.put(s[anchor + k]);
  if (ml) {
    o.put(off & 0xFF);
    o.put(off >> 8);
    if (mlc >= 15) put_vle(o, mlc - 15);
  }
}

// ---- the FAST scans, one warp per row -----------------------------------
//
// Every lane keeps the same copy of the scan's state (positions, anchor,
// output cursor); the work of each step is spread over the lanes:
// - a probe search makes its first kSerialProbes probes one at a time
//   (every lane alike), then 32 probes a step.  Where a search starts (byte
//   1, or after a match) the probe positions are known in advance: the skip
//   ramp depends only on the probe's index in the search.  Lane k hashes
//   the position of probe k and reads the table as it stood when the step
//   began; a lane whose bucket an earlier lane of the step writes takes
//   that lane's position instead (__match_any_sync), as the serial walk
//   would read it.  The first lane whose candidate matches (__ballot_sync)
//   ends the search; the table writes of the lanes up to it are made, the
//   highest lane of each bucket writing, and the lanes after it never
//   happened.  The serial walk's end rules hold per lane: the canonical
//   scan stops when the next probe would pass mf1 (checked before the
//   probe), the dense one while p < mf_limit; a canonical search that ends
//   so makes the writes of the lanes before the end (kernel F's next block
//   reads the table);
// - a match length compares 32 words (128 bytes) a step;
// - literal runs and length-extension bytes are written 32 bytes a step,
//   lane 0 writing the token and offset;
// - the dense scan's prefix seed inserts 32 stride-2 positions a step, the
//   highest lane of each bucket writing (the later insert wins).
// Back-extension and the immediate retry after a match stay serial: every
// lane computes them alike and makes the same table reads and writes, so
// no value is broadcast.  Each lane sees its own writes in program order,
// and a __syncwarp before every write of the table keeps a lane that runs
// ahead from writing a bucket another lane has still to read, and orders
// each lane's earlier writes before it (a slow lane's older value never
// lands after a newer one).

constexpr unsigned kFull = 0xffffffffu;
// probes a search makes one at a time before it goes 32 wide: most
// searches of compressible data hit at their first probe or second
constexpr int kSerialProbes = 2;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// s[p, p + 4) as a little-endian word from aligned words read through the
// read-only path and funnel-shifted (the words holding bytes of the window
// lie inside its tensor's allocation).  kGeneric reads them with generic
// loads instead, for a window that may lie in shared memory (kernel F's
// staged walks).
template <bool kGeneric = false>
__device__ __forceinline__ uint32_t ld32(const uint8_t* s, int p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s + p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const unsigned sh = static_cast<unsigned>(a & 3) * 8;
  const uint32_t lo = kGeneric ? w[0] : __ldg(w);
  return sh ? __funnelshift_r(lo, kGeneric ? w[1] : __ldg(w + 1), sh) : lo;
}

template <bool kGeneric = false>
__device__ __forceinline__ uint64_t ld64(const uint8_t* s, int p) {
  return static_cast<uint64_t>(ld32<kGeneric>(s, p)) |
         (static_cast<uint64_t>(ld32<kGeneric>(s, p + 4)) << 32);
}

// The warp's output cursor: Sink's rule (bytes past the width are counted,
// not written), single bytes from lane 0, runs from every lane.
struct WarpSink {
  uint8_t* out;
  int op;
  int cap;
  __device__ __forceinline__ void put(int b) {
    if (lane_id() == 0 && op < cap) out[op] = static_cast<uint8_t>(b);
    ++op;
  }
  __device__ __forceinline__ void fill(int b, int count) {
    for (int i = lane_id(); i < count; i += 32)
      if (op + i < cap) out[op + i] = static_cast<uint8_t>(b);
    op += count;
  }
  __device__ __forceinline__ void copy(const uint8_t* s, int from, int count) {
    for (int i = lane_id(); i < count; i += 32)
      if (op + i < cap) out[op + i] = s[from + i];
    op += count;
  }
  __device__ __forceinline__ void vle(int v) {  // put_vle
    fill(255, v / 255);
    put(v % 255);
  }
};

// emit() by the warp.
__device__ inline void warp_emit(WarpSink& o, const uint8_t* s, int anchor, int ll, int off,
                                 int ml) {
  const int mlc = ml ? ml - kMinMatch : 0;
  if (ml && ll < 15 && mlc < 15) {  // no length bytes: token, literals, offset
    const int at = o.op;
    if (lane_id() == 0) {
      if (at < o.cap) o.out[at] = static_cast<uint8_t>((ll << 4) | mlc);
      if (at + 1 + ll < o.cap) o.out[at + 1 + ll] = static_cast<uint8_t>(off & 0xFF);
      if (at + 2 + ll < o.cap) o.out[at + 2 + ll] = static_cast<uint8_t>(off >> 8);
    }
    o.op = at + 1;
    o.copy(s, anchor, ll);
    o.op += 2;
    return;
  }
  o.put(((ll >= 15 ? 15 : ll) << 4) | (mlc >= 15 ? 15 : mlc));
  if (ll >= 15) o.vle(ll - 15);
  o.copy(s, anchor, ll);
  if (ml) {
    o.put(off & 0xFF);
    o.put(off >> 8);
    if (mlc >= 15) o.vle(mlc - 15);
  }
}

// run_length() by the warp (a < b, b < limit): the first two words
// compared by every lane alike (most matches end there), then lane k
// compares the words at a + 4k and b + 4k while they fit before limit, the
// first lane that differs giving the length; the last 0-3 bytes one at a
// time.
template <bool kGeneric = false>
__device__ inline int warp_run(const uint8_t* s, int a, int b, int limit) {
  const int lane = lane_id();
  const int b0 = b;
  for (int k = 0; k < 2 && b + 4 <= limit; ++k) {
    const uint32_t x = ld32<kGeneric>(s, a) ^ ld32<kGeneric>(s, b);
    if (x) return b - b0 + ((__ffs(static_cast<int>(x)) - 1) >> 3);
    a += 4;
    b += 4;
  }
  for (;;) {
    const int words = (limit - b) >> 2;
    if (words <= 0) break;
    const bool in = lane < words;
    const uint32_t x =
        in ? ld32<kGeneric>(s, a + 4 * lane) ^ ld32<kGeneric>(s, b + 4 * lane) : 0;
    const unsigned diff = __ballot_sync(kFull, x != 0);
    if (diff) {
      const int k = __ffs(diff) - 1;
      const uint32_t xk = __shfl_sync(kFull, x, k);
      return b - b0 + 4 * k + ((__ffs(static_cast<int>(xk)) - 1) >> 3);
    }
    if (words < 32) {
      a += 4 * words;
      b += 4 * words;
      break;
    }
    a += 128;
    b += 128;
  }
  while (b < limit && s[a] == s[b]) {
    ++a;
    ++b;
  }
  return b - b0;
}

// The lanes up to `last` write their bucket, the highest lane of a bucket
// only (`peers`: the lanes that share it).
template <typename T>
__device__ __forceinline__ void commit(T* tab, int h, unsigned peers, int last, int value) {
  const int lane = lane_id();
  const unsigned upto = last >= 31 ? kFull : (2u << last) - 1;
  const unsigned later = peers & upto & ~((2u << lane) - 1);
  __syncwarp();  // every lane has read the table
  if (lane <= last && !later) tab[h] = static_cast<T>(value);
  __syncwarp();
}

// The candidate a probe reads: the table's, unless an earlier lane of the
// step wrote the bucket (then that lane's value).
__device__ __forceinline__ int step_candidate(int from_table, unsigned peers, int value) {
  const int lane = lane_id();
  const unsigned earlier = peers & ((1u << lane) - 1);
  const int src = earlier ? 31 - __clz(static_cast<int>(earlier)) : lane;
  const int v = __shfl_sync(kFull, value, src);
  return earlier ? v : from_table;
}

// Inclusive sum of v over the lanes up to this one.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = lane_id();
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

// The warp's dependent steps of one canonical scan: probe steps (a serial
// probe, or a step of 32) and match sequences.  Kernel F reports them as its
// step bound; kernel D discards them.
struct ScanSteps {
  int probe_steps = 0;
  int sequences = 0;
};

// Upstream's schedule over the block s[start, n) of a buffer whose bytes
// before `start` matches may reach, positions absolute, the table carried
// in (the caller zeroes it before a buffer's first block).  T = uint16_t is
// byU16 (one-shot rows of n < kCanon64K, start 0): 2^13 positions, the
// 4-byte hash.  T = uint32_t is byU32: 2^12 positions, the 5-byte hash
// (`canon_hash5`), and candidates farther than 65,535 bytes skipped.  Kernel
// D's one-shot rows (LZ4_compress_default) are start = floor = 0 with a
// zeroed table; kernel F's blocks (LZ4_compress_fast_continue over one
// buffer) carry the table from block to block, back-extend no lower than
// `floor` (the block's 64 KB window) and reject a stale entry of an older
// block by its distance alone.  A block of fewer than 13 bytes is all
// literals and leaves the table as it was; a longer one inserts its first
// byte and probes from the next with the step lagging the skip ramp by
// one; after a match, refill at ip - 2, then a zero-literal immediate retry
// without back-extension.  Called by every lane of one warp.
template <typename T, bool kGeneric = false>
__device__ void canon_scan(const uint8_t* s, int start, int n, int floor, int accel,
                           WarpSink& o, T* tab, ScanSteps& st) {
  constexpr bool kU16 = sizeof(T) == 2;
  auto hash = [s](int p) {
    if constexpr (sizeof(T) == 2) {
      return hash4<kCanonHashLog16>(ld32<kGeneric>(s, p));
    } else {
      return canon_hash5(ld64<kGeneric>(s, p));
    }
  };
  const int lane = lane_id();
  const int ramp = accel << kSkipTrigger;
  int anchor = start;
  if (n - start >= kMfLimit + 1) {
    const int mf1 = n - kMfLimit + 1;
    const int match_limit = n - kLastLiterals;
    // the first byte's insert (every lane alike; with a zeroed table at
    // start 0 it writes the 0 already there)
    tab[hash(start)] = static_cast<T>(start);
    int first = start + 1;
    for (;;) {
      // the search from `first`: probe i at p_i, p_0 = first, p_{i+1} =
      // p_i + (i ? (ramp + i - 1) >> 6 : 1), made while p_{i+1} <= mf1
      int ip = 0, match = 0;
      int p = first, j = 0;
      for (; j < kSerialProbes; ++j) {  // every lane alike
        ++st.probe_steps;
        const int step = j ? (ramp + j - 1) >> kSkipTrigger : 1;
        if (p + step > mf1) goto last_literals;
        const int h = hash(p);
        const int c = static_cast<int>(tab[h]);
        __syncwarp();  // every lane has read before any writes
        tab[h] = static_cast<T>(p);
        if ((kU16 || c + kMaxDistance >= p) && ld32<kGeneric>(s, c) == ld32<kGeneric>(s, p)) {
          ip = p;
          match = c;
          break;
        }
        p += step;
      }
      for (; j >= kSerialProbes; j += 32) {
        ++st.probe_steps;
        const int i = j + lane;
        const int step = i ? (ramp + i - 1) >> kSkipTrigger : 1;
        const int reach = warp_scan(step);
        const int pos = p + reach - step;
        const bool valid = p + reach <= mf1;
        const int h = valid ? hash(pos) : -1 - lane;
        const unsigned peers = __match_any_sync(kFull, h);
        const int cand = step_candidate(valid ? static_cast<int>(tab[h]) : 0, peers, pos);
        const bool hit = valid && (kU16 || cand + kMaxDistance >= pos) &&
                         ld32<kGeneric>(s, cand) == ld32<kGeneric>(s, pos);
        const unsigned hits = __ballot_sync(kFull, hit);
        const unsigned ends = __ballot_sync(kFull, !valid);
        const int first_hit = hits ? __ffs(static_cast<int>(hits)) - 1 : 32;
        const int stop = ends ? __ffs(static_cast<int>(ends)) - 1 : 32;
        if (first_hit < stop) {
          commit(tab, h, peers, first_hit, pos);
          ip = __shfl_sync(kFull, pos, first_hit);
          match = __shfl_sync(kFull, cand, first_hit);
          break;
        }
        if (stop < 32) {  // the probes before it were made: the next block reads them
          if (stop > 0) commit(tab, h, peers, stop - 1, pos);
          goto last_literals;
        }
        commit(tab, h, peers, 31, pos);
        p = __shfl_sync(kFull, p + reach, 31);
      }
      while (ip > anchor && match > floor && s[ip - 1] == s[match - 1]) {
        --ip;
        --match;
      }
      for (;;) {
        const int ml =
            kMinMatch + warp_run<kGeneric>(s, match + kMinMatch, ip + kMinMatch, match_limit);
        warp_emit(o, s, anchor, ip - anchor, ip - match, ml);
        ++st.sequences;
        ip += ml;
        anchor = ip;
        if (ip >= mf1) goto last_literals;
        const int h1 = hash(ip - 2);
        const int h2 = hash(ip);
        const int m2 = h1 == h2 ? ip - 2 : static_cast<int>(tab[h2]);
        __syncwarp();  // every lane has read before any writes
        tab[h1] = static_cast<T>(ip - 2);
        tab[h2] = static_cast<T>(ip);
        if (!kU16 && m2 + kMaxDistance < ip) break;
        if (ld32<kGeneric>(s, m2) != ld32<kGeneric>(s, ip)) break;
        match = m2;
      }
      first = ip + 1;
    }
  }
last_literals:
  warp_emit(o, s, anchor, n - anchor, 0, 0);
}

// This library's 15-bit greedy finder over s[src_off, n), with matches
// reaching into the prefix: seed the table at stride 2 over the prefix (the
// later insert wins), probe every position the skip schedule reaches,
// back-extend each hit (into the prefix too), insert at p - 2 after a match.
// The table holds position + 1 (0 == empty): T = uint16_t serves windows
// of at most kDense16Max bytes (every position + 1 it stores is below
// n - 11), T = uint32_t any window.  Called by every lane of one warp.
template <typename T>
__device__ void dense_scan(const uint8_t* s, int src_off, int n, int accel, WarpSink& o,
                           T* tab) {
  const int lane = lane_id();
  for (int base = 0; base + kMinMatch <= src_off; base += 64) {
    const int i = base + 2 * lane;
    const bool in = i + kMinMatch <= src_off;
    const int h = in ? hash4<kDenseHashLog>(ld32(s, i)) : -1 - lane;
    const unsigned peers = __match_any_sync(kFull, h);
    const int last = __ffs(static_cast<int>(__ballot_sync(kFull, !in))) - 2;
    commit(tab, h, peers, last < 0 ? 31 : last, i + 1);
  }
  const int ramp = accel << kSkipTrigger;
  int anchor = src_off;
  if (n - src_off > kMfLimit) {
    const int mf_limit = n - kMfLimit;
    const int match_limit = n - kLastLiterals;
    int p = src_off;
    for (;;) {
      // the search from p: probe i at p_i, p_{i+1} = p_i + ((ramp + i) >> 6),
      // made while p_i < mf_limit
      int cand = 0, j = 0;
      for (; j < kSerialProbes; ++j) {  // every lane alike
        if (p >= mf_limit) goto last_literals;
        const uint32_t w = ld32(s, p);
        const int h = hash4<kDenseHashLog>(w);
        const int c = static_cast<int>(tab[h]) - 1;
        __syncwarp();  // every lane has read before any writes
        tab[h] = static_cast<T>(p + 1);
        if (c >= 0 && p - c <= kMaxDistance && ld32(s, c) == w) {
          cand = c;
          break;
        }
        p += (ramp + j) >> kSkipTrigger;
      }
      for (; j >= kSerialProbes; j += 32) {
        const int step = (ramp + j + lane) >> kSkipTrigger;
        const int reach = warp_scan(step);
        const int pos = p + reach - step;
        const bool valid = pos < mf_limit;
        const uint32_t w = valid ? ld32(s, pos) : 0;
        const int h = valid ? hash4<kDenseHashLog>(w) : -1 - lane;
        const unsigned peers = __match_any_sync(kFull, h);
        const int c = step_candidate(valid ? static_cast<int>(tab[h]) - 1 : -1, peers, pos);
        const bool hit = valid && c >= 0 && pos - c <= kMaxDistance && ld32(s, c) == w;
        const unsigned hits = __ballot_sync(kFull, hit);
        const unsigned ends = __ballot_sync(kFull, !valid);
        const int first = hits ? __ffs(static_cast<int>(hits)) - 1 : 32;
        const int stop = ends ? __ffs(static_cast<int>(ends)) - 1 : 32;
        if (first < stop) {
          commit(tab, h, peers, first, pos + 1);
          p = __shfl_sync(kFull, pos, first);
          cand = __shfl_sync(kFull, c, first);
          break;
        }
        if (stop < 32) goto last_literals;
        commit(tab, h, peers, 31, pos + 1);
        p = __shfl_sync(kFull, p + reach, 31);
      }
      while (p > anchor && cand > 0 && s[p - 1] == s[cand - 1]) {
        --p;
        --cand;
      }
      const int ml = kMinMatch + warp_run(s, cand + kMinMatch, p + kMinMatch, match_limit);
      warp_emit(o, s, anchor, p - anchor, p - cand, ml);
      p += ml;
      anchor = p;
      if (p >= mf_limit) break;
      const int h = hash4<kDenseHashLog>(ld32(s, p - 2));
      __syncwarp();  // the search's writes come first (a serial probe's too)
      tab[h] = static_cast<T>(p - 1);
    }
  }
last_literals:
  warp_emit(o, s, anchor, n - anchor, 0, 0);
}

}  // namespace lz4t
