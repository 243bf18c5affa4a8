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
// row, running the shared block decoder (lz4_decode_body.cuh): the warp
// copies each literal run and each match together.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_decode_body.cuh"

using namespace lz4t;

namespace {

constexpr long long kDictCap = 65536;

__global__ void __launch_bounds__(32) decode_rows(
    const uint8_t* __restrict__ comps, long long comp_stride,
    const int* __restrict__ comp_lens, uint8_t* out, int out_cap,
    const uint8_t* __restrict__ dicts, const int* __restrict__ dict_lens,
    int* __restrict__ lens, int* __restrict__ errs) {
  const int row = blockIdx.x;
  const int dlen = dicts ? dict_lens[row] : 0;
  const uint8_t* dict_end = dicts ? dicts + (row + 1) * kDictCap : nullptr;
  int produced;
  const int err = decode_block(comps + row * comp_stride, comp_lens[row],
                               out + (long long)row * out_cap, out_cap,
                               dict_end, dlen, &produced);
  if (threadIdx.x == 0) {
    lens[row] = produced;
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
