// The chained decoder: every block of one chained LZ4 frame, in one launch.
//
// Replaces the chained-frame route of the TPU kernel `pallas_decode_stream`
// (lz4_tpu/ops/decode_pallas_stream.py), which the JAX package launches
// once per block, carrying the 64 KB window through the host
// (lz4_tpu/frame/api.py, `_try_chained_device_decompress`).  Here one warp
// walks the host-scanned block table (offset, length, stored) in frame
// order and writes one contiguous buffer laid out as
// [64 KB window prefix | decoded stream]: the preset dictionary sits
// right-aligned in the prefix, so each block's window is simply the
// min(65536, preset + written) bytes before it.  Stored blocks are copied.
// The walk stops at the first malformed block and reports its index, the
// bytes written so far (that block's output up to its failing sequence
// included) and its error code (1 malformed, 2 trailing garbage).
//
// What bounds it on the card: the format.  Each block's matches may reach
// into the block before it, so the blocks decode in order, and within a
// block each sequence's position depends on the one before: one warp, one
// SM, whatever the frame's size.
//
// What this design does about that: nothing yet.  The block decoder is the
// one kernel A runs (lz4_decode_body.cuh); the launch replaces one launch
// and one host round trip per block.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_decode_body.cuh"

using namespace lz4t;

namespace {

constexpr long long kWindow = 65536;
// the most a block of L compressed bytes decodes to is 255 L: a sequence
// of 3 + k bytes (token, offset, k length extensions) gives at most
// 19 + 255 k
constexpr long long kMaxExpansion = 255;

__global__ void __launch_bounds__(32) decode_chain(
    const uint8_t* __restrict__ frame, const long long* __restrict__ table,
    int nblocks, int block_size, uint8_t* out, int preset_len,
    long long* __restrict__ status) {
  const int lane = threadIdx.x;
  uint8_t* stream = out + kWindow;
  long long written = 0;
  int bad = -1, err = 0;
  for (int k = 0; k < nblocks; ++k) {
    const long long off = table[3 * k];
    const int len = static_cast<int>(table[3 * k + 1]);
    uint8_t* dst = stream + written;
    if (table[3 * k + 2]) {  // stored
      for (int i = lane; i < len; i += 32) dst[i] = frame[off + i];
      __syncwarp();  // the next block may read these bytes
      written += len;
      continue;
    }
    // the block's slot of `out`: no valid block of len bytes decodes to
    // more than 255 * len, and the cap makes that a check, not a promise
    const long long most = kMaxExpansion * len;
    const int cap = most < block_size ? static_cast<int>(most) : block_size;
    const long long reach = preset_len + written;
    int produced;
    err = decode_block(frame + off, len, dst, cap, dst,
                       static_cast<int>(reach < kWindow ? reach : kWindow),
                       &produced);
    written += produced;
    if (err) {
      bad = k;
      break;
    }
  }
  if (lane == 0) {
    status[0] = written;
    status[1] = bad;
    status[2] = err;
  }
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// Launches one warp on `stream`, does not synchronise, returns
// cudaGetLastError().  The caller has checked the table: every block lies
// inside the frame and a stored block holds at most block_size bytes.
// `out` holds 65,536 bytes plus, for each block, its slot: len bytes for a
// stored block, min(255 * len, block_size) for any other, the cap the
// kernel decodes it with.

extern "C" int lz4t_decode_chain(const void* frame, const void* table,
                                 int nblocks, int block_size, void* out,
                                 int preset_len, void* status, void* stream) {
  decode_chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frame), static_cast<const long long*>(table),
      nblocks, block_size, static_cast<uint8_t*>(out), preset_len,
      static_cast<long long*>(status));
  return static_cast<int>(cudaGetLastError());
}
