// Kernel D: LZ4 block encode at any block size and with a window of
// dictionary bytes before each row, at every level.
//
// Replaces the FAST arms of the TPU kernel `pallas_encode_stream`
// (lz4_tpu/ops/encode_pallas_stream.py, `_encode_stream_one` over
// `_encode_body`).  Row r is the window base[starts[r], starts[r] + lens[r]):
// its first src_offs[r] bytes are a prefix that matches may reach (a preset
// dictionary, or the 64 KB of a chained frame before the block), the rest is
// the block to encode.  Rows may overlap: the chained path reads every
// block and its window straight out of one copy of the payload.  The
// compressed bytes go to out[r, 0:out_stride], clens[r] is their count and
// errs[r] is 1 when that count exceeds `ocap`.
//
// It also replaces the FAST arms of `pallas_encode5` (encode_pallas5.py,
// kernel B): B's rows of at most 64 KB come here as windows without a
// prefix (`ops.encode.encode_blocks`).
//
// Two scans (lz4_encode_body.cuh):
// - dense (every row with a prefix, or on request): the 15-bit finder with
//   the prefix seeded at stride 2, byte-identical to the native engine's
//   `lz4tpu_encode_fast` with a dictionary;
// - canonical (rows without a prefix): LZ4_compress_default's schedule,
//   byU16 below 65,547 bytes and byU32 at and above, chosen per row.
// The TPU kernel's rings, DMA and per-byte words existed to stream blocks
// through its 1 MB of scalar memory; on the card the row is read in place.
//
// What bounds it on the card: the parse is serial per row (each probe's
// lookup decides the next probe, each match's length where the scan
// resumes), not the bytes it moves: a 1 MiB row of noise makes ~226 K
// probes and one of text ~132 K sequences.
//
// What this design does about that: one warp per row runs the scan, every
// lane on every step: 32 probes of a search a step (the probe positions
// are known in advance, the table's writes inside a step resolved with
// __match_any_sync), match lengths 128 bytes a step, literal runs and the
// dense prefix seed 32 at a time (lz4_encode_body.cuh says how each stays
// exact).  Back-extension and the immediate retry after a match stay
// serial.  One CTA of one warp per row; the dense table holds 2^15
// positions + 1, as 16-bit words when every window of the launch is at
// most 64 KB (kernel B's rows: 64 KB of dynamic shared memory, 3 CTAs per
// SM), else as 32-bit words (128 KB: a window passes 65,535 bytes as soon
// as a 64 KB block has a prefix), so one CTA fits on an SM (227 KB) and
// 132 rows run at once, one warp per SM (a limit this design keeps).  The
// canonical tables are 16 KB (2^13 u16 or 2^12 u32 entries): 14 CTAs per
// SM.
//
// The HC (levels 3-9) and OPT (levels 10-12) arms, `encode_windows_hc`,
// replace the `hc_body` and `opt_body` arms of both `pallas_encode_stream`
// and `pallas_encode5`: kernel B's rows at these levels come here as
// windows without a prefix.  On the card every level runs as passes
// (encode_hc_passes.cu, encode_opt.cu); the HC and OPT arms here stay as
// the passes' reference.  Their bodies live in lz4_hc_body.cuh.  Each
// prefix is inserted into the chain as the native engine does, the delta
// ring indexed pos & 0xFFFF at every window size (a 4 MiB row walks the
// same 128 KB ring).
//
// What bounds them: the same serial parse, now with a chain walk of up to
// `depth` steps per search (256 at level 9, 16,384 at 12), each a
// dependent read of the delta ring and of the source.  What the design does
// about that: the ring (128 KB), read at every step, lives in dynamic
// shared memory with the OPT arm's price table (64 KB); the head table
// (2^15 ints, 128 KB), touched once per inserted position, lives in a slot
// of device memory per resident CTA (one CTA per SM at 131,072 or 196,656
// bytes of shared memory, so 132 slots, 17 MB, which stays in the 50 MB
// L2).  The grid is persistent: each CTA takes the next row from an atomic
// counter, so a row with long chains holds up no wave.  Its 256 threads
// reset the tables between rows; one thread parses.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"
#include "lz4_hc_body.cuh"

using namespace lz4t;

namespace {

__global__ void __launch_bounds__(32) encode_windows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    uint8_t* __restrict__ out, long long out_stride, int ocap, int accel,
    int table, int* __restrict__ clens, int* __restrict__ errs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int n = lens[row];
  const bool u16 = n < kCanon64K;
  // 32-bit words of the table this row uses
  // 32-bit words of the table this row uses (table: 0 canonical, 1 dense
  // with 16-bit entries, 2 dense with 32-bit entries)
  const int nwords = table == 1   ? (1 << kDenseHashLog) / 2
                     : table == 2 ? (1 << kDenseHashLog)
                     : u16        ? (1 << kCanonHashLog16) / 2
                                  : (1 << kCanonHashLog32);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  for (int i = threadIdx.x; i < nwords; i += blockDim.x) words[i] = 0;
  __syncthreads();

  const uint8_t* s = base + starts[row];
  WarpSink o{out + row * out_stride, 0, static_cast<int>(out_stride)};
  if (table == 1)
    dense_scan(s, src_offs[row], n, accel, o, reinterpret_cast<uint16_t*>(smem));
  else if (table == 2)
    dense_scan(s, src_offs[row], n, accel, o, words);
  else if (u16)
    canon_scan(s, n, accel, o, reinterpret_cast<uint16_t*>(smem));
  else
    canon_scan(s, n, accel, o, words);
  if (threadIdx.x == 0) {
    clens[row] = o.op;
    errs[row] = o.op > ocap ? 1 : 0;
  }
}

// The HC (kOpt false, levels 3-9) and OPT (kOpt true, levels 10-12) arms,
// over the same windows, every prefix inserted into the chain: a persistent
// grid, one CTA per slot of `heads`, each taking the next row from
// `next_row` until none is left.  `depth` is the chain steps per search;
// `sufficient` and `full` are the OPT arm's.
template <bool kOpt>
__global__ void __launch_bounds__(kHcThreads) encode_windows_hc(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ src_offs, const int* __restrict__ lens,
    uint8_t* __restrict__ out, long long out_stride, int ocap, int depth,
    int sufficient, int full, int* __restrict__ heads,
    int* __restrict__ next_row, int nrows, int* __restrict__ clens,
    int* __restrict__ errs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int row_s;
  uint16_t* delta = reinterpret_cast<uint16_t*>(smem);
  OptCell* cells = reinterpret_cast<OptCell*>(smem + kHcRingBytes);
  int* head = heads + static_cast<long long>(blockIdx.x) * kHcHeadInts;
  for (;;) {
    if (threadIdx.x == 0) row_s = atomicAdd(next_row, 1);
    __syncthreads();
    const int row = row_s;
    if (row >= nrows) return;
    hc_reset(head, delta);
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint8_t* s = base + starts[row];
      Sink o{out + row * out_stride, 0, static_cast<int>(out_stride)};
      if (kOpt)
        opt_scan(s, src_offs[row], lens[row], depth, sufficient, full, o, head, delta, cells);
      else
        hc_scan(s, src_offs[row], lens[row], depth, o, head, delta);
      clens[row] = o.op;
      errs[row] = o.op > ocap ? 1 : 0;
    }
    __syncthreads();
  }
}

auto hc_kernel(int opt) { return opt ? encode_windows_hc<true> : encode_windows_hc<false>; }

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------

// Dynamic shared memory of one CTA: the largest table of the geometry.
// The table of a launch: 0 canonical, 1 dense with 16-bit entries (every
// window at most kDense16Max bytes: kernel B's rows), 2 dense with 32-bit
// entries.
static int fast_table(int dense, int longest) {
  return dense ? (longest <= kDense16Max ? 1 : 2) : 0;
}

extern "C" int lz4t_encode_stream_shared_bytes(int dense, int longest) {
  switch (fast_table(dense, longest)) {
    case 1: return (1 << kDenseHashLog) * static_cast<int>(sizeof(uint16_t));
    case 2: return (1 << kDenseHashLog) * static_cast<int>(sizeof(uint32_t));
    default: return (1 << kCanonHashLog16) * static_cast<int>(sizeof(uint16_t));
  }
}

// Launches on `stream`, does not synchronise, returns the first CUDA error
// (0 on success).  The caller has checked every window against `base` and
// clipped `accel`; canonical rows have src_offs == 0.
extern "C" int lz4t_encode_stream(const void* base, const void* starts,
                                  const void* src_offs, const void* lens,
                                  void* out, long long out_stride, int ocap,
                                  int accel, int dense, int longest,
                                  void* clens, void* errs, int nrows,
                                  void* stream) {
  const int smem = lz4t_encode_stream_shared_bytes(dense, longest);
  cudaError_t e = cudaFuncSetAttribute(
      encode_windows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_windows<<<nrows, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(src_offs), static_cast<const int*>(lens),
      static_cast<uint8_t*>(out), out_stride, ocap, accel, fast_table(dense, longest),
      static_cast<int*>(clens), static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
}

// ---- HC / OPT arms --------------------------------------------------------

// Dynamic shared memory of one CTA of an arm: the delta ring, and the OPT
// arm's price table.
extern "C" int lz4t_encode_stream_hc_shared_bytes(int opt) {
  return kHcRingBytes + (opt ? kOptCellsBytes : 0);
}

// CTAs of an arm that the current device holds at once: the head-table
// slots the caller allocates (kHcHeadInts ints each).
extern "C" int lz4t_encode_stream_hc_slots(int opt, int* slots) {
  const auto kernel = hc_kernel(opt);
  const int smem = lz4t_encode_stream_hc_shared_bytes(opt);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kHcThreads, smem);
  *slots = sms * per_sm;
  return static_cast<int>(e);
}

// Launches min(nslots, nrows) CTAs on `stream`, does not synchronise,
// returns the first CUDA error (0 on success).  `heads` holds nslots head
// tables; `next_row` is one int, 0 on entry.  The caller has checked every
// window against `base`.
extern "C" int lz4t_encode_stream_hc(const void* base, const void* starts,
                                     const void* src_offs, const void* lens,
                                     void* out, long long out_stride, int ocap,
                                     int opt, int depth, int sufficient,
                                     int full, void* heads, int nslots,
                                     void* next_row, void* clens, void* errs,
                                     int nrows, void* stream) {
  const auto kernel = hc_kernel(opt);
  const int smem = lz4t_encode_stream_hc_shared_bytes(opt);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<nslots < nrows ? nslots : nrows, kHcThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(src_offs), static_cast<const int*>(lens),
      static_cast<uint8_t*>(out), out_stride, ocap, depth, sufficient, full,
      static_cast<int*>(heads), static_cast<int*>(next_row), nrows,
      static_cast<int*>(clens), static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
}
