// Kernel F: canonical chained FAST frames, LZ4_compress_fast_continue over
// the blocks of one contiguous payload, and the byU32 hash over a tensor.
//
// What it replaces: the JAX package's host route for these frames
// (lz4_tpu/frame/api.py:313 `_host_chained_canonical_compress`, which runs
// lz4_tpu/native/lz4tpu.c `lz4tpu_encode_fast_continue` block after block;
// it has no `pallas_call`).  The frame's payload src[0, n) is cut into
// blocks of `block_size` bytes; block k's compressed candidate goes to
// out[k, 0:out_stride], its length to clens[k] and its walk's probe steps
// and sequences to steps[k, 0:2].  The caller sizes out_stride to
// compress_bound(block_size): every block is scanned to its end, since the
// frame may store a block raw whose inserts the table still carries.
//
// What bounds it on the card: each block's walk is serial (each probe's
// lookup decides the next probe, each match's length where the scan
// resumes; ~750 cycles a probe step or sequence on the H100), and block k's
// walk reads the byU32 table (4,096 absolute positions) that block k - 1
// left.  But it reads only that table's live entries: an entry e with
// e + 65,535 < start(k) is rejected by its distance at every position of
// the block.  Two incoming tables equal on the live entries give the same
// bytes and outgoing tables equal on the entries live at start(k + 1).  So
// the blocks can be walked at once from guessed tables and the guesses
// checked afterwards: the time is the slowest walk of each round, summed
// over the rounds it takes the guesses to settle, not the frame's steps one
// after another.  How many rounds is a property of the data: on the bench
// mix the text blocks settle within 4 rounds, runs and records within 16,
// and noise one block a round (a parse that never resynchronises).
//
// What this design does: rounds of parallel walks over a window of blocks.
// Round 1 (`continue_walk`, one CTA of one warp per block, each block on
// kernel D's `canon_scan<uint32_t>` with its start, its 64 KB
// back-extension floor and its table in shared memory) walks every block
// from a zeroed table (the window's first block from the exact table the
// window before left), keeping in device memory the table each block
// started from and the one it left.  After each round `continue_check`
// compares, for each block whose predecessor was walked, the table it
// started from with the one its predecessor now leaves, dead entries
// counting as equal; where they differ the block takes that table and is
// walked again in the next round.  The first block that differs is the
// first that is not final (every block before it agrees with an exact
// predecessor), and it becomes exact in the next round, so each round
// makes at least one more block final; when none differs, all are.
// After `max_rounds` rounds (32 by default, `encode_continue.MAX_ROUNDS`)
// `continue_tail` walks the window's non-final suffix serially on one
// warp from the table its first block's predecessor left (max_rounds = 0:
// the serial schedule), which keeps a frame whose parse never settles near
// the serial time.  A re-walk clears the bytes an earlier, longer walk of
// its block left past its end.  The rounds are launched from the host
// without a synchronisation: a round with nothing to walk is a launch
// whose CTAs return at once.  A walk reads its window (the 64 KB before its
// block, and the block) from shared memory, staged by the warp, where it
// fits beside the table (blocks up to ~147 KB: one CTA per SM at 64 KB
// blocks), else from the payload through the read-only path at the largest
// L1 carveout.  The payload may start at any byte (a view of a tensor).
//
// Memory: two tables of 16 KB per block of a window, plus two int flags
// per block; the caller sizes the window (`encode_continue.WINDOW_BLOCKS`:
// 8,192 blocks, 256 MiB of tables at most; a 16 MiB frame of 64 KB blocks
// takes 8 MiB).  A longer frame runs its windows one after another, each
// starting from the table the window before left.  Shared memory: the
// table (16 KB) and the staged window (up to ~211 KB) per CTA.
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

constexpr int kTable = 1 << kCanonHashLog32;  // entries of the byU32 table
// The longest block whose window is staged in shared memory: the window,
// the block and the table in the 227 KB a CTA can use on the H100.
constexpr int kStageMax = 232448 - 4 * kTable - 65536 - 16;

// The warp's copy of a table between device and shared memory, 16 bytes a
// lane a step.
__device__ __forceinline__ void copy_table(uint32_t* dst, const uint32_t* src) {
  __syncwarp();
  for (int i = lane_id(); i < kTable / 4; i += 32)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  __syncwarp();
}

// The bytes of shared memory that hold a block's window (the 64 KB before
// it and the block, in 4-byte words, and two words past its end), or 0
// where they do not fit beside the table.
__host__ __device__ constexpr int stage_bytes(int block_size) {
  return block_size > kStageMax ? 0 : 4 * ((65536 + block_size + 3) / 4 + 3);
}

// The warp's copy of s[floor, end) into shared memory `buf`: the aligned
// 4-byte words that hold those bytes (inside the payload's allocation,
// whatever the payload's own alignment: a tensor may be a view at any
// byte), then two zero words; returns the pointer p with p[i] == s[i] for
// i in [floor, end), its word alignment that of s.
__device__ const uint8_t* stage(const uint8_t* s, int floor, int end, uint32_t* buf) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s + floor);
  const uint32_t* g = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
  const int lead = static_cast<int>(a & 3);
  const int words = (lead + end - floor + 3) >> 2;
  __syncwarp();  // the walk before has read the buffer
#pragma unroll 8
  for (int i = lane_id(); i < words; i += 32) buf[i] = __ldg(g + i);
  if (lane_id() < 2) buf[words + lane_id()] = 0;
  __syncwarp();
  return reinterpret_cast<const uint8_t*>(buf) + lead - floor;
}

// Block k's walk from the table `tab` (left as the walk leaves it), by the
// warp, its window staged into shared memory `buf` first (kStaged: generic
// loads) or else read from the payload (through the read-only path): its
// row, length and steps, its count of walks, and zeros over the bytes an
// earlier, longer walk of the block left past the new end.
template <bool kStaged>
__device__ void walk_block(const uint8_t* s, int n, int block_size, int k, uint32_t* tab,
                           uint32_t* buf, uint8_t* out, long long out_stride, int accel,
                           int* clens, int* steps, int* walks) {
  const int start = static_cast<int>(static_cast<long long>(k) * block_size);
  const int end = n - start < block_size ? n : start + block_size;
  const int floor = start - (start < 65536 ? start : 65536);
  uint8_t* row = out + k * out_stride;
  const int prev = walks[k] ? clens[k] : 0;
  WarpSink o{row, 0, static_cast<int>(out_stride)};
  ScanSteps st;
  if constexpr (kStaged) s = stage(s, floor, end, buf);
  __syncwarp();  // the table's writes before, and the reads above, are done
  canon_scan<uint32_t, kStaged>(s, start, end, floor, accel, o, tab, st);
  for (int i = o.op + lane_id(); i < prev; i += 32) row[i] = 0;
  __syncwarp();
  if (lane_id() == 0) {
    clens[k] = o.op;
    steps[2 * k] = st.probe_steps;
    steps[2 * k + 1] = st.sequences;
    ++walks[k];
  }
}

// A window's first state: block w0 + i starts from tin[i], zeroed but for
// the first block of a window after the first (`carry`: the table the
// window before left); every block is to be walked.
__global__ void __launch_bounds__(256) continue_setup(uint32_t* __restrict__ tin,
                                                      const uint32_t* __restrict__ carry,
                                                      int* __restrict__ dirty) {
  uint32_t* t = tin + static_cast<long long>(blockIdx.x) * kTable;
  const bool copy = blockIdx.x == 0 && carry != nullptr;
  for (int i = threadIdx.x; i < kTable; i += blockDim.x) t[i] = copy ? carry[i] : 0;
  if (threadIdx.x == 0) dirty[blockIdx.x] = 1;
}

// One round: each block of the window to be walked (dirty), from the table
// it starts from (tin) into the table it leaves (tout); `walked` counts the
// round's walks.
__global__ void __launch_bounds__(32) continue_walk(
    const uint8_t* __restrict__ s, int n, int block_size, int w0, uint8_t* __restrict__ out,
    long long out_stride, int accel, int* __restrict__ clens, int* __restrict__ steps,
    const uint32_t* __restrict__ tin, uint32_t* __restrict__ tout,
    const int* __restrict__ dirty, int* __restrict__ walked, int* __restrict__ walks) {
  const int i = blockIdx.x;
  if (!dirty[i]) return;
  __shared__ __align__(16) uint32_t tab[kTable];
  extern __shared__ __align__(16) uint32_t window[];
  copy_table(tab, tin + static_cast<long long>(i) * kTable);
  if (stage_bytes(block_size))
    walk_block<true>(s, n, block_size, w0 + i, tab, window, out, out_stride, accel, clens, steps,
                     walks);
  else
    walk_block<false>(s, n, block_size, w0 + i, tab, nullptr, out, out_stride, accel, clens, steps,
                      walks);
  copy_table(tout + static_cast<long long>(i) * kTable, tab);
  if (lane_id() == 0) atomicAdd(walked, 1);
}

// After a round: block w0 + i, whose predecessor was walked (cur[i - 1]),
// compares the table it started from with the one its predecessor now
// leaves, entries dead at its start (e + 65,535 < start) counting as equal;
// where they differ it takes that table and is walked in the next round
// (nxt[i]).  The window's first block is exact from its first walk.
__global__ void __launch_bounds__(256) continue_check(
    uint32_t* __restrict__ tin, const uint32_t* __restrict__ tout, int w0, int block_size,
    const int* __restrict__ cur, int* __restrict__ nxt) {
  const int i = blockIdx.x;
  if (i == 0 || !cur[i - 1]) {
    if (threadIdx.x == 0) nxt[i] = 0;
    return;
  }
  const long long start = static_cast<long long>(w0 + i) * block_size;
  uint32_t* a = tin + static_cast<long long>(i) * kTable;
  const uint32_t* b = tout + static_cast<long long>(i - 1) * kTable;
  bool diff = false;
  for (int j = threadIdx.x; j < kTable; j += blockDim.x) {
    const uint32_t x = a[j], y = b[j];
    diff |= x != y && !(x + static_cast<long long>(kMaxDistance) < start &&
                        y + static_cast<long long>(kMaxDistance) < start);
  }
  if (__syncthreads_or(diff)) {
    for (int j = threadIdx.x; j < kTable; j += blockDim.x) a[j] = b[j];
    if (threadIdx.x == 0) nxt[i] = 1;
  } else if (threadIdx.x == 0) {
    nxt[i] = 0;
  }
}

// After the last round: the window's blocks from its first block still to
// be walked (dirty) to its end, one after another on one warp, from the
// table that block starts from (its predecessor's, exact); the table the
// window leaves goes to tout[wn - 1], and the frame's first such block,
// plus one, to *first.
__global__ void __launch_bounds__(32) continue_tail(
    const uint8_t* __restrict__ s, int n, int block_size, int w0, int wn,
    uint8_t* __restrict__ out, long long out_stride, int accel, int* __restrict__ clens,
    int* __restrict__ steps, const uint32_t* __restrict__ tin, uint32_t* __restrict__ tout,
    const int* __restrict__ dirty, int* __restrict__ walks, int* __restrict__ first) {
  int f = wn;
  for (int base = 0; base < wn; base += 32) {
    const int i = base + lane_id();
    const unsigned d = __ballot_sync(kFull, i < wn && dirty[i]);
    if (d) {
      f = base + __ffs(static_cast<int>(d)) - 1;
      break;
    }
  }
  if (f == wn) return;
  __shared__ __align__(16) uint32_t tab[kTable];
  extern __shared__ __align__(16) uint32_t window[];
  copy_table(tab, tin + static_cast<long long>(f) * kTable);
  const bool staged = stage_bytes(block_size) != 0;
  for (int i = f; i < wn; ++i) {
    if (staged)
      walk_block<true>(s, n, block_size, w0 + i, tab, window, out, out_stride, accel, clens, steps,
                       walks);
    else
      walk_block<false>(s, n, block_size, w0 + i, tab, nullptr, out, out_stride, accel, clens,
                        steps, walks);
  }
  copy_table(tout + static_cast<long long>(wn - 1) * kTable, tab);
  if (lane_id() == 0 && *first == 0) *first = w0 + f + 1;
}

__global__ void hash5_rows(const uint64_t* __restrict__ v, int* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = canon_hash5(v[i]);
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------

// Encodes the frame src[0, n) on `stream`, its blocks in windows of
// `window`: per window, a setup, `max_rounds` rounds of a walk and a check,
// and the serial tail.  Scratch from the caller: `tables` 2 x window x
// 4,096 uint32 (the tables the blocks start from, then those they leave),
// `dirty` 2 x window int.  `stats`, int [max_rounds + 1 + nb], gets the
// blocks walked in each round (summed over the windows), the first block
// the tail walked plus one (0: none), and each block's walks.  Does not
// synchronise; returns the first CUDA error (0 on success).  The caller
// has checked n (1 to 2^31 - 64 MiB), clipped `accel` to [1, 65537], made
// out_stride >= compress_bound(block_size) and zeroed `out`.
extern "C" int lz4t_encode_continue(const void* src, int n, int block_size, void* out,
                                    long long out_stride, int accel, void* clens, void* steps,
                                    int max_rounds, int window, void* tables, void* dirty,
                                    void* stats, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  // A walk reads its window (its block and the 64 KB before it) from
  // shared memory where it fits (blocks up to ~147 KB), else through L1,
  // then with the largest L1 beside the table: on the H100 staging was the
  // faster of the three on a frame of 64 KB blocks, and the largest L1
  // faster than the default carveout.
  const int dyn = stage_bytes(block_size);
  const void* walkers[] = {reinterpret_cast<const void*>(continue_walk),
                           reinterpret_cast<const void*>(continue_tail)};
  for (const void* k : walkers) {
    const cudaError_t e =
        dyn ? cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn)
            : cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxL1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto* s = static_cast<const uint8_t*>(src);
  auto* o = static_cast<uint8_t*>(out);
  auto* cl = static_cast<int*>(clens);
  auto* sp = static_cast<int*>(steps);
  const int nb = static_cast<int>((static_cast<long long>(n) + block_size - 1) / block_size);
  auto* walked = static_cast<int*>(stats);
  int* first = walked + max_rounds;
  int* walks = first + 1;
  const cudaError_t e =
      cudaMemsetAsync(walked, 0, sizeof(int) * (max_rounds + 1 + static_cast<size_t>(nb)), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto* tin = static_cast<uint32_t*>(tables);
  uint32_t* tout = tin + static_cast<size_t>(window) * kTable;
  int* d[2] = {static_cast<int*>(dirty), static_cast<int*>(dirty) + window};
  for (int w0 = 0; w0 < nb; w0 += window) {
    const int wn = nb - w0 < window ? nb - w0 : window;
    continue_setup<<<wn, 256, 0, st>>>(
        tin, w0 ? tout + static_cast<size_t>(window - 1) * kTable : nullptr, d[0]);
    for (int r = 0; r < max_rounds; ++r) {
      continue_walk<<<wn, 32, dyn, st>>>(s, n, block_size, w0, o, out_stride, accel, cl, sp, tin,
                                       tout, d[r & 1], walked + r, walks);
      continue_check<<<wn, 256, 0, st>>>(tin, tout, w0, block_size, d[r & 1], d[(r + 1) & 1]);
    }
    continue_tail<<<1, 32, dyn, st>>>(s, n, block_size, w0, wn, o, out_stride, accel, cl, sp, tin,
                                    tout, d[max_rounds & 1], walks, first);
  }
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
