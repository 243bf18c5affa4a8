// The LZ4 FAST encode bodies shared by kernel B (encode.cu) and kernel D
// (encode_stream.cu): the sequence writer and the two scans of
// lz4_tpu/native/lz4tpu.c (lz4tpu_encode_fast_canonical and
// lz4tpu_encode_fast), whose bytes the TPU kernels' `_encode_body`
// (lz4_tpu/ops/encode_pallas5.py) reproduces.
//
// A row is a flat window s[0, n): a prefix s[0, src_off) that matches may
// reach (a dictionary, or the previous 64 KB of a chained frame), then the
// source bytes s[src_off, n) to encode.  Positions are int: a row is at most
// a 4 MB block plus a 64 KB window.  Every read stays inside [0, n).
// One thread runs a scan; the caller zeroes the hash table first (every
// table below reads 0 as "empty").

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

// Upstream one-shot schedule over s[0, n) (no dictionary).  T = uint16_t is
// byU16 (n < kCanon64K): 2^13 positions, the 4-byte hash.  T = uint32_t is
// byU32: 2^12 positions, the 5-byte hash (CUDA's native 64-bit multiply),
// and candidates farther than 65,535 bytes skipped.  Insert byte 0, probe
// from byte 1 with the hash computed one probe ahead, the step lagging the
// skip ramp by one; after a match, refill at ip - 2, then a zero-literal
// immediate retry without back-extension.
template <typename T>
__device__ void canon_scan(const uint8_t* s, int n, int accel, Sink& o, T* tab) {
  constexpr bool kU16 = sizeof(T) == 2;
  auto hash = [s](int p) {
    if constexpr (sizeof(T) == 2) {
      return hash4<kCanonHashLog16>(read32(s, p));
    } else {
      return static_cast<int>(((read64(s, p) << 24) * 889523592379ULL) >>
                              (64 - kCanonHashLog32));
    }
  };
  int anchor = 0;
  if (n >= kMfLimit + 1) {
    const int mf1 = n - kMfLimit + 1;
    const int match_limit = n - kLastLiterals;
    int ip = 1;
    int fh = hash(ip);
    for (;;) {
      int match;
      int fwd = ip, step = 1, ramp = accel << kSkipTrigger;
      for (;;) {
        const int h = fh;
        ip = fwd;
        fwd += step;
        step = ramp++ >> kSkipTrigger;
        if (fwd > mf1) goto last_literals;
        match = static_cast<int>(tab[h]);
        fh = hash(fwd);
        tab[h] = static_cast<T>(ip);
        if (!kU16 && match + kMaxDistance < ip) continue;
        if (read32(s, match) == read32(s, ip)) break;
      }
      while (ip > anchor && match > 0 && s[ip - 1] == s[match - 1]) {
        --ip;
        --match;
      }
      for (;;) {
        const int ml = kMinMatch + run_length(s, match + kMinMatch, ip + kMinMatch, match_limit);
        emit(o, s, anchor, ip - anchor, ip - match, ml);
        ip += ml;
        anchor = ip;
        if (ip >= mf1) goto last_literals;
        tab[hash(ip - 2)] = static_cast<T>(ip - 2);
        const int h2 = hash(ip);
        const int m2 = static_cast<int>(tab[h2]);
        tab[h2] = static_cast<T>(ip);
        if (!kU16 && m2 + kMaxDistance < ip) break;
        if (read32(s, m2) != read32(s, ip)) break;
        match = m2;
      }
      ++ip;
      fh = hash(ip);
    }
  }
last_literals:
  emit(o, s, anchor, n - anchor, 0, 0);
}

// This library's 15-bit greedy finder over s[src_off, n), with matches
// reaching into the prefix: seed the table at stride 2 over the prefix (the
// later insert wins), probe every position the skip schedule reaches,
// back-extend each hit (into the prefix too), insert at p - 2 after a match.
// The table holds position + 1 (0 == empty): T = uint16_t serves windows
// of at most 65,540 bytes, T = uint32_t any window.
template <typename T>
__device__ void dense_scan(const uint8_t* s, int src_off, int n, int accel, Sink& o, T* tab) {
  for (int i = 0; i + kMinMatch <= src_off; i += 2)
    tab[hash4<kDenseHashLog>(read32(s, i))] = static_cast<T>(i + 1);
  int anchor = src_off;
  if (n - src_off > kMfLimit) {
    const int mf_limit = n - kMfLimit;
    const int match_limit = n - kLastLiterals;
    int p = src_off;
    int search = accel << kSkipTrigger;
    while (p < mf_limit) {
      const uint32_t w = read32(s, p);
      const int h = hash4<kDenseHashLog>(w);
      int cand = static_cast<int>(tab[h]) - 1;
      tab[h] = static_cast<T>(p + 1);
      if (cand >= 0 && p - cand <= kMaxDistance && read32(s, cand) == w) {
        while (p > anchor && cand > 0 && s[p - 1] == s[cand - 1]) {
          --p;
          --cand;
        }
        const int ml = kMinMatch + run_length(s, cand + kMinMatch, p + kMinMatch, match_limit);
        emit(o, s, anchor, p - anchor, p - cand, ml);
        p += ml;
        anchor = p;
        if (p >= mf_limit) break;
        tab[hash4<kDenseHashLog>(read32(s, p - 2))] = static_cast<T>(p - 1);
        search = accel << kSkipTrigger;
        continue;
      }
      p += search++ >> kSkipTrigger;
    }
  }
  emit(o, s, anchor, n - anchor, 0, 0);
}

}  // namespace lz4t
