// Kernel B: LZ4 block encode, FAST levels, for a batch of independent rows.
//
// Replaces the FAST arms of the TPU kernel `pallas_encode5`
// (lz4_tpu/ops/encode_pallas5.py, `_encode_body`): the canonical byU16
// scan (`canon_scan`, byte-identical to LZ4_compress_default for blocks
// below 65,547 bytes) and the dense scan (`fast_body`).  Row b holds
// lens[b] <= 65536 source bytes; its compressed bytes go to
// out[b, 0:out_stride], clens[b] is their count and errs[b] is 1 when that
// count exceeds `ocap` (a row at or below the batch capacity cannot).
// The scans live in lz4_encode_body.cuh, shared with kernel D; here they
// run with no dictionary and 16-bit tables.
//
// What bounds it on the card: the bytes are few (each source byte read
// once, each compressed byte written once), but the parse is serial per
// row: each probe's table lookup and compare decide where the next probe
// lands, and each match's length decides where the scan resumes.
//
// What this design does about that: nothing yet.  One CTA per row; its 32
// threads zero the hash table, then one thread runs the scalar parse.  The
// table lives in dynamic shared memory as 16-bit positions: canonical
// 2^13 entries (16 KB, the upstream byU16 table; empty == position 0),
// dense 2^15 entries holding position + 1 (64 KB, empty == 0, the native
// engine's 16-bit layout for blocks <= 64 KB).  That is 14 CTAs per SM for
// the canonical scan and 3 for the dense one (227 KB of shared memory per
// SM).  The dense table is above the 48 KB default, hence the
// cudaFuncSetAttribute below.
//
// Levels 3-12 (`pallas_encode5`'s HC and OPT arms) run on kernel D's
// `encode_windows_hc` (encode_stream.cu), each row a window of the batch.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"

using namespace lz4t;

namespace {

__global__ void __launch_bounds__(32) encode_rows(
    const uint8_t* __restrict__ srcs, long long src_stride,
    const int* __restrict__ lens, uint8_t* __restrict__ out, int out_stride,
    int ocap, int accel, int dense, int* __restrict__ clens,
    int* __restrict__ errs) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  const int nwords = (dense ? (1 << kDenseHashLog) : (1 << kCanonHashLog16)) / 2;
  for (int i = threadIdx.x; i < nwords; i += blockDim.x) words[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int row = blockIdx.x;
  const uint8_t* s = srcs + row * src_stride;
  Sink o{out + static_cast<long long>(row) * out_stride, 0, out_stride};
  const int n = lens[row];
  if (dense)
    dense_scan(s, 0, n, accel, o, tab);
  else
    canon_scan(s, n, accel, o, tab);
  clens[row] = o.op;
  errs[row] = o.op > ocap ? 1 : 0;
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------

// Dynamic shared memory of one CTA: the hash table.
extern "C" int lz4t_encode_shared_bytes(int dense) {
  return (dense ? (1 << kDenseHashLog) : (1 << kCanonHashLog16)) *
         static_cast<int>(sizeof(uint16_t));
}

// Launches on `stream`, does not synchronise, returns the first CUDA error
// (0 on success).  `accel` is already clipped by the caller.
extern "C" int lz4t_encode(const void* srcs, long long src_stride,
                           const void* lens, void* out, int out_stride,
                           int ocap, int accel, int dense, void* clens,
                           void* errs, int nrows, void* stream) {
  const int smem = lz4t_encode_shared_bytes(dense);
  cudaError_t e = cudaFuncSetAttribute(
      encode_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_rows<<<nrows, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(srcs), src_stride,
      static_cast<const int*>(lens), static_cast<uint8_t*>(out), out_stride,
      ocap, accel, dense, static_cast<int*>(clens), static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
}
