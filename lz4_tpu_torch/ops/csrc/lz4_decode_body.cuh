// Kernel A's LZ4 block decoder (decode.cu): one warp decodes one block.
// The chained decoder's parse (decode_stream.cu) shares its length reader.
//
// Every lane runs the same parse (the reads are broadcasts), and the warp
// copies each literal run and each match together: byte i of a match at
// offset `off` is byte (i mod off) of the `off` bytes before it, so even an
// overlapping match copies in parallel from bytes already in place.  Every
// read stays below clen and every write inside [0, out_cap) of the block,
// so a corrupt stream gives an error code, never a stray write; a failing
// sequence copies nothing.

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

// Decodes src[0, clen) into dst[0, out_cap).  Matches may reach `dlen`
// bytes before dst; byte s < 0 of that window is dict_end[s] (dict_end ==
// dst when the window lies right before dst in memory).  Called by every
// lane of a CTA of one warp.  Returns 0, 1 (malformed) or 2 (trailing
// garbage) and sets *produced to the bytes written (up to the failing
// sequence on error).
__device__ inline int decode_block(const uint8_t* __restrict__ src, int clen,
                                   uint8_t* dst, int out_cap,
                                   const uint8_t* dict_end, int dlen,
                                   int* produced) {
  const int lane = threadIdx.x;
  const int width = blockDim.x;
  int ip = 0, op = 0, err = 0;
  for (;;) {
    if (ip >= clen) {
      err = 1;
      break;
    }
    const int token = src[ip];
    int q = ip + 1;
    long long ll = token >> 4;
    if (ll == 15) ll += read_vle(src, q, clen);
    if (q + ll > clen || op + ll > out_cap) {
      err = 1;
      break;
    }
    const int lit_at = q;
    const int nlit = (int)ll;
    q += nlit;
    if (q >= clen) {  // the last sequence: literals only
      for (int i = lane; i < nlit; i += width) dst[op + i] = src[lit_at + i];
      op += nlit;
      ip = q;
      break;
    }
    if (q + 2 > clen) {
      err = 1;
      break;
    }
    const int off = src[q] | (src[q + 1] << 8);
    q += 2;
    long long ml = (token & 15) + kDecMinMatch;
    if ((token & 15) == 15) ml += read_vle(src, q, clen);
    if (off == 0 || off > op + ll + dlen || op + ll + ml > out_cap) {
      err = 1;
      break;
    }
    for (int i = lane; i < nlit; i += width) dst[op + i] = src[lit_at + i];
    op += nlit;
    __syncwarp();  // the match may read the literals just written
    const int m = (int)ml;
    const int base = op - off;  // >= -dlen: may start in the window
    for (int i = lane; i < m; i += width) {
      const int s = base + (i < off ? i : i % off);
      dst[op + i] = s >= 0 ? dst[s] : dict_end[s];
    }
    __syncwarp();  // the next sequence may read this match
    op += m;
    ip = q;
  }
  __syncwarp();  // the caller may read the last literals
  if (err == 0 && ip != clen) err = 2;
  *produced = op;
  return err;
}

}  // namespace lz4t
