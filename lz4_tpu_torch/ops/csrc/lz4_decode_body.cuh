// Kernel A's LZ4 block decoder (decode.cu): one warp decodes one block.
// The chained decoder's parse (decode_stream.cu) shares its length reader,
// and both parallel decoders (decode.cu's rows, decode_stream.cu's chained
// frames) share the steps of their literal and resolve passes
// (`place_sequence`, `jump_entry`).
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
//
// limit >= 0 is a partial decode (upstream's LZ4_decompress_safe_partial):
// the block stops cleanly at the first literal or match byte that brings
// the output to `limit`, and nothing after that point is parsed.  Before
// it every check holds, the literal run's input check and the match's
// offset checks included, and a match length whose extension runs out of
// input is malformed; the match's capacity check does not apply to the
// match that reaches the limit.  A block that ends first returns what it
// produced.
__device__ inline int decode_block(const uint8_t* __restrict__ src, int clen,
                                   uint8_t* dst, int out_cap,
                                   const uint8_t* dict_end, int dlen,
                                   int* produced, int limit = -1) {
  const int lane = threadIdx.x;
  const int width = blockDim.x;
  int ip = 0, op = 0, err = 0;
  bool stopped = false;  // reached `limit`
  for (;;) {
    if (ip >= clen) {
      err = 1;
      break;
    }
    const int token = src[ip];
    int q = ip + 1;
    long long ll = token >> 4;
    if (ll == 15) ll += read_vle(src, q, clen);
    if (q + ll > clen) {
      err = 1;
      break;
    }
    if (limit >= 0 && op + ll >= limit) {  // the run reaches the limit
      for (int i = lane; i < limit - op; i += width) dst[op + i] = src[q + i];
      op = limit;
      stopped = true;
      break;
    }
    if (op + ll > out_cap) {
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
    if ((token & 15) == 15) {
      const int q0 = q;
      ml += read_vle(src, q, clen);
      // an extension that runs out of input: no byte, or a last byte of 255
      if (limit >= 0 && (q == q0 || src[q - 1] == 255)) {
        err = 1;
        break;
      }
    }
    const bool last = limit >= 0 && op + ll + ml >= limit;
    if (off == 0 || off > op + ll + dlen || (!last && op + ll + ml > out_cap)) {
      err = 1;
      break;
    }
    for (int i = lane; i < nlit; i += width) dst[op + i] = src[lit_at + i];
    op += nlit;
    __syncwarp();  // the match may read the literals just written
    const int m = last ? limit - op : (int)ml;
    const int base = op - off;  // >= -dlen: may start in the window
    for (int i = lane; i < m; i += width) {
      const int s = base + (i < off ? i : i % off);
      dst[op + i] = s >= 0 ? dst[s] : dict_end[s];
    }
    __syncwarp();  // the next sequence may read this match
    op += m;
    ip = q;
    if (last) {
      stopped = true;
      break;
    }
  }
  __syncwarp();  // the caller may read the last literals
  if (err == 0 && !stopped && ip != clen) err = 2;
  *produced = op;
  return err;
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
