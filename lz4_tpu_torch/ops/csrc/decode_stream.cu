// The chained decoder: every block of one chained LZ4 frame at once, in
// four passes on one stream.
//
// Replaces the chained-frame route of the TPU kernel `pallas_decode_stream`
// (lz4_tpu/ops/decode_pallas_stream.py), which the JAX package launches
// once per block, carrying the 64 KB window through the host
// (lz4_tpu/frame/api.py, `_try_chained_device_decompress`).  The output is
// one buffer laid out as [64 KB window prefix | decoded stream]: the preset
// dictionary sits right-aligned in the prefix, so each block's window is
// the min(65536, preset + start) bytes before it.  The decode stops at the
// first malformed block and reports its index, the bytes written (that
// block's output up to its failing sequence included) and its error code
// (1 malformed, 2 trailing garbage); nothing past that is written.
//
// The format orders the sequences inside a block, not the blocks: each
// block's tokens parse on their own, and only its match copies reach into
// the 64 KB before it.  So:
//   1. parse  (`chain_parse`, one warp per block, all blocks at once): a
//      block's compressed bytes staged in shared memory when every block
//      fits compress_bound(64 KB) (larger blocks are read through L1), one
//      lane walks the tokens with `decode_rows`' structural checks and
//      writes a sequence table (literal source, literal length, output
//      position, offset, match length), the block's decoded size and its
//      structural error;
//   2. place  (`chain_place`, one warp): the exclusive scan of the sizes
//      gives each block's start; the one check that needs it, an offset
//      past op + ll + min(65536, preset + start), runs on the blocks whose
//      window is shorter than 64 KB; the first failing block gives the
//      status, and each block the number of its sequences to apply;
//   3. literals (`chain_literals`, a grid of CTAs per block, one warp per
//      sequence): literal runs and stored blocks copied to their place, and
//      an index array over the stream: a literal or stored byte points to
//      itself, byte p of a match at d to d - off + ((p - d) mod off), one
//      hop out of its own match however much it overlaps;
//   4. resolve (`chain_jump` rounds, `chain_gather`): pointer jumping,
//      ptr[p] <- ptr[ptr[p]] in place until a round changes nothing (a
//      device flag per round; the rounds after it return at once), then
//      one gather of every match byte from the byte it finally copies.
// Every pass reads its sizes on the card (`status[0]` is the bytes
// written): no host round trip between them.
//
// What bounds it on the card: the bytes, 0.0073 ms per 16 MiB frame at
// 3.35 TB/s (frame read once, content written once), against
//   - the parse's per-block chain: each sequence's position needs the one
//     before, a few thousand dependent reads per 64 KB block; all blocks
//     run at once and read shared memory, so one block's chain sets it;
//   - the resolve rounds: ceil(log2 depth) + 1 passes over a 4-byte index
//     per output byte (8 above 2 GiB); a match never hops through its own
//     overlap, so the depth is the number of matches a byte passes through,
//     not its distance.
// The warps of the literal pass and the rounds are as many as the card
// holds; the launches of the rounds after convergence cost a few
// microseconds each.  Scratch: 20 bytes of sequence table per 3 compressed
// bytes and 4 bytes of index per output byte.

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
// one sequence-table row: literal source (in the block's compressed
// bytes), literal length, output position in the block, offset, match
// length (0: the last, literal-only sequence)
constexpr int kRow = 5;
constexpr unsigned kAll = 0xffffffffu;

__global__ void __launch_bounds__(32) chain_parse(
    const uint8_t* __restrict__ frame, const long long* __restrict__ table,
    int block_size, const long long* __restrict__ sbase, int stage,
    int* __restrict__ seqs, int* __restrict__ nseq, int* __restrict__ size,
    int* __restrict__ err) {
  extern __shared__ uint8_t staged[];
  const int k = blockIdx.x;
  const int len = static_cast<int>(table[3 * k + 1]);
  if (table[3 * k + 2]) {  // stored: its bytes as they are
    if (threadIdx.x == 0) {
      nseq[k] = 0;
      size[k] = len;
      err[k] = 0;
    }
    return;
  }
  const uint8_t* src = frame + table[3 * k];
  if (stage) {
    for (int i = threadIdx.x; i < len; i += 32) staged[i] = src[i];
    __syncwarp();
    src = staged;
  }
  if (threadIdx.x != 0) return;
  const long long most = kMaxExpansion * len;
  const int cap = most < block_size ? static_cast<int>(most) : block_size;
  int* row = seqs + kRow * sbase[k];
  int ip = 0, op = 0, e = 0, n = 0;
  // decode_rows' walk and checks (decode.cu), without the copies; its
  // window check needs the block's start and is place's
  for (;;) {
    if (ip >= len) {
      e = 1;
      break;
    }
    const int token = src[ip];
    int q = ip + 1;
    long long ll = token >> 4;
    if (ll == 15) ll += read_vle(src, q, len);
    if (q + ll > len || op + ll > cap) {
      e = 1;
      break;
    }
    const int lit = q;
    q += static_cast<int>(ll);
    if (q >= len) {  // the last sequence: literals only
      row[0] = lit;
      row[1] = static_cast<int>(ll);
      row[2] = op;
      row[3] = 0;
      row[4] = 0;
      ++n;
      op += static_cast<int>(ll);
      ip = q;
      break;
    }
    if (q + 2 > len) {
      e = 1;
      break;
    }
    const int off = src[q] | (src[q + 1] << 8);
    q += 2;
    long long ml = (token & 15) + kDecMinMatch;
    if ((token & 15) == 15) ml += read_vle(src, q, len);
    if (off == 0 || op + ll + ml > cap) {
      e = 1;
      break;
    }
    row[0] = lit;
    row[1] = static_cast<int>(ll);
    row[2] = op;
    row[3] = off;
    row[4] = static_cast<int>(ml);
    row += kRow;
    ++n;
    op += static_cast<int>(ll + ml);
    ip = q;
  }
  if (e == 0 && ip != len) e = 2;
  nseq[k] = n;
  size[k] = op;
  err[k] = e;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_xor_sync(kAll, v, d));
  return v;
}

// One warp, 32 blocks at a time.  use[k]: the sequences of block k to
// apply (1 or 0 for a stored block); 0 past the first failing block.
__global__ void __launch_bounds__(32) chain_place(
    const long long* __restrict__ table, int nb, const int* __restrict__ seqs,
    const long long* __restrict__ sbase, const int* __restrict__ nseq,
    const int* __restrict__ size, const int* __restrict__ err, int preset_len,
    long long* __restrict__ start, int* __restrict__ use,
    long long* __restrict__ status) {
  const int lane = threadIdx.x;
  long long carry = 0, written = 0;
  int bad = -1, code = 0;
  for (int base = 0; base < nb; base += 32) {
    const int k = base + lane;
    const bool in = k < nb;
    const long long v = in ? size[k] : 0;
    long long x = v;  // inclusive scan of the chunk
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kAll, x, d);
      if (lane >= d) x += y;
    }
    const long long at = carry + x - v;
    carry += __shfl_sync(kAll, x, 31);
    const bool stored = in && table[3 * k + 2] != 0;
    const int n = in && !stored ? nseq[k] : 0;
    // a window shorter than 64 KB: the only blocks whose offsets can
    // reach past it (an offset is at most 65,535)
    const bool check = in && !stored && bad < 0 && preset_len + at < kWindow;
    int first = n;
    for (unsigned todo = __ballot_sync(kAll, check); todo; todo &= todo - 1) {
      const int j = __ffs(todo) - 1;
      const long long reach = preset_len + __shfl_sync(kAll, at, j);
      const int m = __shfl_sync(kAll, n, j);
      const int* rows = seqs + kRow * sbase[base + j];
      int f = m;
      for (int i = lane; i < m; i += 32) {
        const int* r = rows + kRow * i;
        if (r[4] > 0 && r[3] > static_cast<long long>(r[2]) + r[1] + reach) {
          f = i;
          break;
        }
      }
      f = warp_min(f);
      if (lane == j) first = f;
    }
    const int e = in && !stored ? err[k] : 0;
    const unsigned fails = __ballot_sync(kAll, bad < 0 && (e != 0 || first < n));
    if (bad < 0 && fails) {
      const int j = __ffs(fails) - 1;
      bad = base + j;
      const int fj = __shfl_sync(kAll, first, j);
      const int nj = __shfl_sync(kAll, n, j);
      const long long atj = __shfl_sync(kAll, at, j);
      if (fj < nj) {  // the window check fails first
        written = atj + seqs[kRow * (sbase[bad] + fj) + 2];
        code = 1;
      } else {
        written = atj + size[bad];
        code = err[bad];
      }
    }
    if (in) {
      start[k] = at;
      use[k] = bad >= 0 && k > bad ? 0 : (stored ? 1 : first);
    }
  }
  if (lane == 0) {
    status[0] = bad < 0 ? carry : written;
    status[1] = bad;
    status[2] = code;
  }
}

// Grid (blocks, chunks) of 256 threads: the chunks of block k share its
// sequences (one warp per sequence) or its stored bytes.
template <typename Idx>
__global__ void __launch_bounds__(256) chain_literals(
    const uint8_t* __restrict__ frame, const long long* __restrict__ table,
    const int* __restrict__ seqs, const long long* __restrict__ sbase,
    const long long* __restrict__ start, const int* __restrict__ use,
    uint8_t* __restrict__ out, Idx* __restrict__ ptr) {
  const int k = blockIdx.x;
  const int n = use[k];
  if (n == 0) return;
  const long long s0 = start[k];
  const uint8_t* src = frame + table[3 * k];
  uint8_t* dst = out + kWindow + s0;
  Idx* pk = ptr + s0;
  const Idx base = static_cast<Idx>(kWindow + s0);
  if (table[3 * k + 2]) {
    const int len = static_cast<int>(table[3 * k + 1]);
    const int step = gridDim.y * blockDim.x;
    for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < len; i += step) {
      dst[i] = src[i];
      pk[i] = base + i;
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int* rows = seqs + kRow * sbase[k];
  for (int i = blockIdx.y * warps + (threadIdx.x >> 5); i < n;
       i += gridDim.y * warps)
    place_sequence(rows + kRow * i, src, dst, pk, base, lane);
}

// One round of pointer jumping over the stream's index array (entries are
// positions in `out`; below kWindow, the prefix, is final).  Returns at
// once when the round before changed nothing.
template <typename Idx>
__global__ void __launch_bounds__(256) chain_jump(
    Idx* ptr, const long long* __restrict__ status, int* flags, int round) {
  if (round > 0 && flags[round - 1] == 0) return;
  const long long n = status[0];
  bool changed = false;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    changed |= jump_entry(ptr, i, static_cast<Idx>(kWindow));
  if (__syncthreads_or(changed) && threadIdx.x == 0) flags[round] = 1;
}

template <typename Idx>
__global__ void __launch_bounds__(256) chain_gather(
    const Idx* __restrict__ ptr, const long long* __restrict__ status,
    uint8_t* out) {
  const long long n = status[0];
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Idx v = ptr[i];
    if (v != kWindow + i) out[kWindow + i] = out[v];
  }
}

template <typename Idx>
int literals(const void* frame, const void* table, int nb, int chunks,
             const void* seqs, const void* sbase, const void* start,
             const void* use, void* out, void* ptr, cudaStream_t stream) {
  chain_literals<Idx><<<dim3(nb, chunks), 256, 0, stream>>>(
      static_cast<const uint8_t*>(frame), static_cast<const long long*>(table),
      static_cast<const int*>(seqs), static_cast<const long long*>(sbase),
      static_cast<const long long*>(start), static_cast<const int*>(use),
      static_cast<uint8_t*>(out), static_cast<Idx*>(ptr));
  return static_cast<int>(cudaGetLastError());
}

template <typename Idx>
int resolve(void* ptr, void* out, const void* status, void* flags, int rounds,
            int grid, cudaStream_t stream) {
  for (int r = 0; r < rounds; ++r) {
    chain_jump<Idx><<<grid, 256, 0, stream>>>(
        static_cast<Idx*>(ptr), static_cast<const long long*>(status),
        static_cast<int*>(flags), r);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
  }
  chain_gather<Idx><<<grid, 256, 0, stream>>>(
      static_cast<const Idx*>(ptr), static_cast<const long long*>(status),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// Each entry point launches on `stream`, does not synchronise and returns
// cudaGetLastError().  The caller has checked the table (every block inside
// the frame, a stored block at most block_size bytes), laid out the
// sequence table (block k's rows from sbase[k], len / 3 + 1 of them for a
// compressed block) and sized `out` as 65,536 bytes plus each block's slot:
// len for a stored block, min(255 * len, block_size) for any other.  `wide`
// selects 64-bit index entries (needed when 65,536 + the slots reach 2^31).

extern "C" int lz4t_chain_parse(const void* frame, const void* table, int nb,
                                int block_size, const void* sbase,
                                int stage_bytes, void* seqs, void* nseq,
                                void* size, void* err, void* stream) {
  if (stage_bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        chain_parse, cudaFuncAttributeMaxDynamicSharedMemorySize, stage_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  chain_parse<<<nb, 32, stage_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(frame), static_cast<const long long*>(table),
      block_size, static_cast<const long long*>(sbase), stage_bytes > 0,
      static_cast<int*>(seqs), static_cast<int*>(nseq), static_cast<int*>(size),
      static_cast<int*>(err));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lz4t_chain_place(const void* table, int nb, const void* seqs,
                                const void* sbase, const void* nseq,
                                const void* size, const void* err,
                                int preset_len, void* start, void* use,
                                void* status, void* stream) {
  chain_place<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), nb, static_cast<const int*>(seqs),
      static_cast<const long long*>(sbase), static_cast<const int*>(nseq),
      static_cast<const int*>(size), static_cast<const int*>(err), preset_len,
      static_cast<long long*>(start), static_cast<int*>(use),
      static_cast<long long*>(status));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lz4t_chain_literals(const void* frame, const void* table,
                                   int nb, int chunks, const void* seqs,
                                   const void* sbase, const void* start,
                                   const void* use, void* out, void* ptr,
                                   int wide, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return wide ? literals<long long>(frame, table, nb, chunks, seqs, sbase,
                                    start, use, out, ptr, s)
              : literals<int>(frame, table, nb, chunks, seqs, sbase, start,
                              use, out, ptr, s);
}

extern "C" int lz4t_chain_resolve(void* ptr, void* out, const void* status,
                                  void* flags, int rounds, int grid, int wide,
                                  void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return wide ? resolve<long long>(ptr, out, status, flags, rounds, grid, s)
              : resolve<int>(ptr, out, status, flags, rounds, grid, s);
}
