// Shared steps of kernel A (decode.cu) and the chained decoder
// (decode_stream.cu): the length reader of the chained decoder's parse
// (`read_vle`; kernel A's one-warp route reads its lengths from a staged
// ring, `decode.cu` `Ring`), and the steps of both parallel decoders'
// literal and resolve passes (`place_sequence`, `jump_entry`).

#pragma once

#include <cstdint>

namespace lz4t {

constexpr int kDecMinMatch = 4;

// One length extension: bytes are added while they are 255 and input
// remains (a run that ends at clen is caught by the caller's checks).
__device__ __forceinline__ long long read_vle(const uint8_t* src, int& q, int clen) {
  long long v = 0;
  int b = 255;
  while (b == 255 && q < clen) {
    b = src[q++];
    v += b;
  }
  return v;
}

// The literal and resolve passes of both parallel decoders.  Each keeps an
// index array over its output: entries are positions in its own buffer,
// those below `lo` final (the chained frame's 64 KB prefix; rows use lo 0
// and negative entries for their dictionary bytes), any other a position
// whose own entry is ptr[v - lo].

// One sequence-table row (literal source, literal length, output position,
// offset, match length) by the lanes of a warp: its literal run copied
// from src to dst, the run's entries pointing to themselves, byte j of its
// match at d to d - off + (j mod off): one hop out of its own match
// however much it overlaps.  Entries are `base` + a position in dst.
template <typename Idx>
__device__ __forceinline__ void place_sequence(const int* r, const uint8_t* src,
                                               uint8_t* dst, Idx* pk, Idx base, int lane) {
  const int lit = r[0], ll = r[1], op = r[2], off = r[3], ml = r[4];
  for (int j = lane; j < ll; j += 32) {
    dst[op + j] = src[lit + j];
    pk[op + j] = base + op + j;
  }
  const int d = op + ll;
  for (int j = lane; j < ml; j += 32) pk[d + j] = base + d - off + (j < off ? j : j % off);
}

// One pointer-jumping step at entry i (ptr[i] <- ptr[ptr[i]]); a final
// entry or a literal's (pointing to itself) is not read again.  Returns
// whether the entry changed.
template <typename Idx>
__device__ __forceinline__ bool jump_entry(Idx* ptr, long long i, Idx lo) {
  const Idx v = ptr[i];
  if (v < lo || v - lo == i) return false;
  const Idx w = ptr[v - lo];
  if (w == v) return false;
  ptr[i] = w;
  return true;
}

}  // namespace lz4t
