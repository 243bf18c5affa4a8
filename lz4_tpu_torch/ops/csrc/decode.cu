// Kernel A: LZ4 block decode for a batch of independent rows.
//
// Replaces the TPU kernel `pallas_decode6` (lz4_tpu/ops/decode_pallas6.py,
// body `_decode_one`).  Same contract: row b holds comp_lens[b] compressed
// bytes; it decodes into out[b, 0:out_cap]; an optional right-aligned
// 64 KB dictionary row lets matches reach dict_lens[b] bytes before the
// output start.  lens[b] is the number of bytes produced (at the start of
// the sequence that failed, on error) and errs[b] is 0, 1 for malformed
// input, or 2 for trailing garbage.
//
// What bounds it on the card: the bytes are few (each compressed byte read
// once, each output byte written once), but the parse is a byte-serial
// dependency chain per row: a sequence's token, its length extensions and
// its offset must be read before the next token's position is known.
//
// What this design does about that: nothing yet.  One CTA of one warp per
// row.  Every lane runs the same parse (the reads are broadcasts), and the
// warp copies each literal run and each match together: byte i of a match
// at offset `off` is byte (i mod off) of the `off` bytes before it, so even
// an overlapping match copies in parallel from bytes already in place.
// Every read stays below clen and every write inside [0, out_cap) of the
// row, so a corrupt stream gives an error flag, never a stray write.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 4;
constexpr long long kDictCap = 65536;

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

__global__ void __launch_bounds__(32) decode_rows(
    const uint8_t* __restrict__ comps, long long comp_stride,
    const int* __restrict__ comp_lens, uint8_t* out, int out_cap,
    const uint8_t* __restrict__ dicts, const int* __restrict__ dict_lens,
    int* __restrict__ lens, int* __restrict__ errs) {
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  const int width = blockDim.x;
  const uint8_t* src = comps + row * comp_stride;
  uint8_t* dst = out + (long long)row * out_cap;
  const int clen = comp_lens[row];
  const int dlen = dicts ? dict_lens[row] : 0;
  const uint8_t* dict_end = dicts ? dicts + (row + 1) * kDictCap : nullptr;

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
    long long ml = (token & 15) + kMinMatch;
    if ((token & 15) == 15) ml += read_vle(src, q, clen);
    if (off == 0 || off > op + ll + dlen || op + ll + ml > out_cap) {
      err = 1;
      break;
    }
    for (int i = lane; i < nlit; i += width) dst[op + i] = src[lit_at + i];
    op += nlit;
    __syncwarp();  // the match may read the literals just written
    const int m = (int)ml;
    const int base = op - off;  // >= -dlen: may start in the dictionary
    for (int i = lane; i < m; i += width) {
      const int s = base + (i < off ? i : i % off);
      dst[op + i] = s >= 0 ? dst[s] : dict_end[s];
    }
    __syncwarp();  // the next sequence may read this match
    op += m;
    ip = q;
  }
  if (err == 0 && ip != clen) err = 2;
  if (lane == 0) {
    lens[row] = op;
    errs[row] = err;
  }
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
// `dicts`/`dict_lens` may be null (no dictionary).

extern "C" int lz4t_decode(const void* comps, long long comp_stride,
                           const void* comp_lens, void* out, int out_cap,
                           const void* dicts, const void* dict_lens,
                           void* lens, void* errs, int nrows, void* stream) {
  decode_rows<<<nrows, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comps), comp_stride,
      static_cast<const int*>(comp_lens), static_cast<uint8_t*>(out), out_cap,
      static_cast<const uint8_t*>(dicts), static_cast<const int*>(dict_lens),
      static_cast<int*>(lens), static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
}
