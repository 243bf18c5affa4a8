// Kernel F: canonical chained FAST frames, LZ4_compress_fast_continue over
// the blocks of one contiguous payload, and the byU32 hash over a tensor.
//
// Replaces the JAX package's host route for these frames
// (lz4_tpu/frame/api.py:313 `_host_chained_canonical_compress`, which runs
// lz4_tpu/native/lz4tpu.c `lz4tpu_encode_fast_continue` block after block;
// it has no `pallas_call`).  The frame's payload src[0, n) is cut into
// blocks of `block_size` bytes; block k's compressed candidate goes to
// out[k, 0:out_stride], its length to clens[k] and the warp's probe steps
// and sequences to steps[k, 0:2].  The
// caller sizes out_stride to compress_bound(block_size): every block is
// scanned to its end, since the frame may store a block raw whose inserts
// the table still carries.
//
// What bounds it on the card: the schedule is sequential across blocks
// (block k's table is what the parse of every block before it left) and
// serial inside each (each probe's lookup decides the next probe, each
// match's length where the scan resumes): the frame's probe steps and
// sequences, one after another, not its bytes.
//
// What this design does about that: one CTA of one warp for the frame, the
// table (4,096 absolute u32 positions, 16 KB) in shared memory, zeroed once
// and carried through the blocks in order; each block runs kernel
// D's warp scan (`canon_scan<uint32_t>`, lz4_encode_body.cuh: 32 probes a
// step, match lengths 128 bytes a step, literal runs 32 bytes a step) with
// the block's start, its 64 KB back-extension floor and the carried table.
// The frame uses one SM of the card (a redesign that spreads one frame is
// later work).
//
// `hash5_rows` is the byU32 hash (`canon_hash5`, the function kernels D and
// F call) over a tensor of 40-bit values: the Hopper counterpart of the
// TPU's 32-bit split of that hash (experiments/tests/test_canon_hash32.py:90,
// `test_pallas_scalar_kernel_matches`).  One thread per value; it moves 12
// bytes a value, so it is bound by its bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"

using namespace lz4t;

namespace {

__global__ void __launch_bounds__(32) encode_continue(
    const uint8_t* __restrict__ s, int n, int block_size, uint8_t* __restrict__ out,
    long long out_stride, int accel, int* __restrict__ clens, int* __restrict__ steps) {
  __shared__ uint32_t tab[1 << kCanonHashLog32];
  for (int i = threadIdx.x; i < (1 << kCanonHashLog32); i += blockDim.x) tab[i] = 0;
  long long row = 0;
  for (int off = 0; off < n; off += block_size, ++row) {
    const int end = n - off < block_size ? n : off + block_size;
    WarpSink o{out + row * out_stride, 0, static_cast<int>(out_stride)};
    ScanSteps st;
    __syncwarp();  // the zeroing, then each block's table reads, before the next writes
    canon_scan(s, off, end, off - (off < 65536 ? off : 65536), accel, o, tab, st);
    if (threadIdx.x == 0) {
      clens[row] = o.op;
      steps[2 * row] = st.probe_steps;
      steps[2 * row + 1] = st.sequences;
    }
  }
}

__global__ void hash5_rows(const uint64_t* __restrict__ v, int* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = canon_hash5(v[i]);
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------

// Launches one CTA of one warp for the frame src[0, n) on `stream`, does
// not synchronise, returns the first CUDA error (0 on success).  The caller
// has checked n (at most 2^31 - 64 MiB), clipped `accel` to [1, 65537] and
// made out_stride >= compress_bound(block_size).
extern "C" int lz4t_encode_continue(const void* src, int n, int block_size, void* out,
                                    long long out_stride, int accel, void* clens, void* steps,
                                    void* stream) {
  encode_continue<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), n, block_size, static_cast<uint8_t*>(out), out_stride,
      accel, static_cast<int*>(clens), static_cast<int*>(steps));
  return static_cast<int>(cudaGetLastError());
}

// canon_hash5 of n uint64 values into n ints, on `stream`; returns the first
// CUDA error (0 on success).
extern "C" int lz4t_hash5_rows(const void* v, void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  hash5_rows<<<blocks < 4096 ? static_cast<int>(blocks) : 4096, 256, 0,
               static_cast<cudaStream_t>(stream)>>>(static_cast<const uint64_t*>(v),
                                                    static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
