// Kernel E: xxHash32 (seed 0) of byte windows of one flat tensor.
//
// Replaces the TPU kernel `pallas_xxh32` (lz4_tpu/ops/xxh32_pallas.py:121,
// body `_xxh_kernel`).  Same function: out[w] is the xxHash32 with seed 0
// of base[starts[w] : starts[w] + lens[w]], its uint32 bits in an int32.
// The TPU kernel takes one row per grid step, staged as one LE word per byte
// (`_words_le`), and writes a 128-lane output row; both are TPU workarounds.
// This kernel reads the bytes where they lie: a batch's rows as windows at
// b * stride, a frame's blocks in place in the frame, the content as one
// window.
//
// What bounds it on the card:
// - a batch of rows: the bytes, each read once (1,024 x 64 KB: 64 MiB /
//   3.35 TB/s = 0.02 ms), and each row's dependent chain (below), about
//   the same;
// - one long window: the dependent chain.  xxHash32 updates each of four
//   accumulators once a 16-byte stripe, acc = rotl(acc + w * P2, 13) * P1,
//   each stripe's on the result of the one before: about 10 cycles a
//   stripe, about 21 ms per 64 MiB at 1,980 MHz.  xxHash32 defines that
//   chain; no layout removes it.
//
// What this design does about that:
// - the chain is cut to two instructions a stripe.  Each lane carries
//   r = acc * P1^-1 (P1 is odd, so it has an inverse mod 2^32), the value
//   before the multiply: r' = rotl(r * P1 + m, 13) with m = w * P2 made off
//   the chain, one IMAD and one SHF on the carried register; acc = r * P1 is
//   formed once, after the last stripe;
// - the words are fetched ahead: each window's bytes go through a ring of
//   kStages stages of kStage bytes in shared memory, the aligned 16-byte
//   chunks around the window copied by cp.async kStages - 3 stages ahead of
//   the walk (a window may start at any byte), and each stage's words are
//   loaded into registers one stage before the chain uses them, so that no
//   shared-memory load is waited on inside the chain;
// - four lanes a window, lane j carrying accumulator j, kGroups (8) windows
//   a warp and one warp a CTA: a batch of 1,024 rows takes 128 warps, one
//   an SM, each instruction serving eight windows; a long window takes one
//   warp and four of its lanes.
// Lane 0 of a window's four merges the accumulators and does the tail and
// the avalanche.  On the H100 (PERF.md §6): 29.29 ms per 64 MiB window
// against the kernel before it's 41.34, 13.8 cycles a stripe, where a lone
// dependent IMAD-and-SHF chain takes 10.09; 1,024 rows 0.036 ms against
// 0.050.  Of one to eight windows a warp and stages of 256 to 1,024 bytes,
// eight and 1,024 were the fastest at those shapes (PERF.md §6).
//
// The streaming form (`lz4t_xxh32_stripes`, the kStripes instance of the
// same kernel) is the same walk with the four accumulators read from, and
// written back to, a device array in place of the seed's: a frame's
// content hash carried across the writes or reads of a stream, the caller
// keeping the total and the bytes after the last whole stripe.  Its bound
// is the long window's: the dependent chain, about 10 cycles a stripe
// (0.33 ms per MiB at 1,980 MHz), against 0.3 us per MiB of bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP1Inv = 244002641u;  // kP1 * kP1Inv == 1 mod 2^32
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;

constexpr int kGroups = 8;     // windows a warp, four lanes each
constexpr int kStage = 1024;   // bytes a stage: 64 stripes
constexpr int kStageStripes = kStage / 16;
constexpr int kStages = 8;     // stages of a window's 8 KB ring
constexpr int kRingWords = kStage * kStages / 4;
// a window's ring and its 16 bytes past the end (slot 0's first chunk
// again), which also put the groups' loads of one word in different banks
constexpr int kRingStride = kRingWords + 4;
constexpr int kSharedBytes = kGroups * kRingStride * 4;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// One stripe on the carried value (see above): an IMAD and an SHF.
__device__ __forceinline__ uint32_t step(uint32_t r, uint32_t m) {
  return rotl(r * kP1 + m, 13);
}

// cp.async of one 16-byte chunk to a shared-memory address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The window's ring: its aligned 16-byte chunk c (the first holding the
// window's byte 0) at ring byte 16 c mod (kStage * kStages), so stage t
// (chunks kStage / 16 * t on) takes slot t mod kStages.  Lane j of the four
// copies chunks j, j + 4, j + 8, ... of the stage; slot 0's first chunk is
// copied once more past the ring's end, so that the last slot's stripes
// read on without wrapping.
struct Ring {
  const uint8_t* gal;  // the aligned chunk holding the window's byte 0
  const uint32_t* buf;
  uint32_t sbuf;       // buf as a shared-memory address
  int chunks, lead, j, lane;

  __device__ __forceinline__ void issue(int t) const {
    const int c0 = t * (kStage / 16);
    const int slot = t & (kStages - 1);
    const uint32_t dst = sbuf + slot * kStage + 16 * j;
    const uint8_t* src = gal + 16 * (static_cast<long long>(c0) + j);
    const int room = chunks - c0 - j;  // this lane's chunks u with 4 u < room
#pragma unroll
    for (int u = 0; u < kStage / 64; ++u) {
      if (4 * u < room) cp_async16(dst + 64 * u, src + 64 * u);
    }
    if (slot == 0 && j == 0 && c0 < chunks) cp_async16(sbuf + 4 * kRingWords, src);
    cp_async_commit();  // one group a stage, empty or not
  }

  // This lane's word (j) of the stage's stripes, times P2: word
  // (lead / 4 + kStage / 4 * t + 4 i + j) of the ring, funnel-shifted from
  // two words when the window starts off a 4-byte boundary (kShift).  Each
  // product goes through a shuffle to the lane itself, so that the
  // compiler cannot fold the multiply into the chain's multiply-add: it
  // would make a stripe three dependent instructions.
  template <bool kShift>
  __device__ __forceinline__ void words(uint32_t (&m)[kStageStripes], int t) const {
    const uint32_t* q = buf + (t & (kStages - 1)) * (kStage / 4) + (lead >> 2) + j;
    const int s = 8 * (lead & 3);
#pragma unroll
    for (int i = 0; i < kStageStripes; ++i) {
      uint32_t w = q[4 * i];
      if (kShift) w = __funnelshift_r(w, q[4 * i + 1], s);
      m[i] = __shfl_sync(0xffffffffu, w * kP2, lane);
    }
  }
};

// One stage of the walk, with no branch inside, so that the copies, the
// wait, the loads of the next stage's words and the loop's counting fill
// the chain's latency: issue stage t + kStages - 1; wait for stage t + 2
// (stage t + 1's stripes read up to its first chunk); load stage t + 1's
// words into ``next``; run this lane's stripes of stage t over ``m``.  A
// stage in which every window of the warp has all its stripes or none
// (kWhole) runs them all on a copy of the carried value, kept where the
// window has them; a window's last, short stage predicates its steps past
// the end off.  The slot refilled held stage t - 1, whose words were
// loaded one stage before.
template <bool kShift, bool kWhole>
__device__ __forceinline__ void stage_body(const Ring& ring, uint32_t& r,
                                           const uint32_t (&m)[kStageStripes],
                                           uint32_t (&next)[kStageStripes], int t, int n) {
  ring.issue(t + kStages - 1);
  cp_async_wait<kStages - 3>();
  __syncwarp();  // stage t + 2 visible to every lane; slot t - 1 free
  ring.words<kShift>(next, t + 1);
  if (kWhole) {
    uint32_t x = r;
#pragma unroll
    for (int i = 0; i < kStageStripes; ++i) x = step(x, m[i]);
    if (n > 0) r = x;
  } else {
#pragma unroll
    for (int i = 0; i < kStageStripes; ++i) {
      if (i < n) r = step(r, m[i]);
    }
  }
}

template <bool kShift>
__device__ __forceinline__ void stage(const Ring& ring, uint32_t& r,
                                      const uint32_t (&m)[kStageStripes],
                                      uint32_t (&next)[kStageStripes], int t, int nstripes) {
  const int n = nstripes - t * kStageStripes;  // this window's stripes from stage t on
  if (__all_sync(0xffffffffu, n >= kStageStripes || n <= 0)) {
    stage_body<kShift, true>(ring, r, m, next, t, n);
  } else {
    stage_body<kShift, false>(ring, r, m, next, t, n);
  }
}

// The walk over every stripe of the warp's windows, two stages an
// iteration (the word buffers swap roles without copies).
template <bool kShift>
__device__ __forceinline__ uint32_t walk(const Ring& ring, uint32_t r, int nstripes,
                                         int warp_stages) {
#pragma unroll 1
  for (int t = 0; t < kStages - 1; ++t) ring.issue(t);
  cp_async_wait<kStages - 3>();
  __syncwarp();
  uint32_t a[kStageStripes], b[kStageStripes];
  ring.words<kShift>(a, 0);
#pragma unroll 1
  for (int t = 0; t < warp_stages; t += 2) {
    stage<kShift>(ring, r, a, b, t, nstripes);
    stage<kShift>(ring, r, b, a, t + 1, nstripes);
  }
  cp_async_wait<0>();  // no copy into the ring outlives the walk
  return r;
}

// kStripes: out holds four accumulators per window, read before the first
// stripe and written after the last; the window's bytes after its last
// whole stripe are not read into the hash.
template <bool kStripes>
__global__ void __launch_bounds__(32) xxh32_windows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ lens, int nwin, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int j = lane & 3;
  const int w = blockIdx.x * kGroups + g;
  const bool live = w < nwin;
  const uint8_t* p = live ? base + starts[w] : base;
  const int n = live ? lens[w] : 0;
  const int nstripes = n >> 4;

  Ring ring;
  ring.lead = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  ring.gal = p - ring.lead;
  ring.buf = smem + g * kRingStride;
  ring.sbuf = static_cast<uint32_t>(__cvta_generic_to_shared(ring.buf));
  ring.chunks = n > 0 ? static_cast<int>((ring.lead + static_cast<long long>(n) + 15) >> 4) : 0;
  ring.j = j;
  ring.lane = lane;

  uint32_t acc = kStripes ? (live ? out[4 * w + j] : 0u)
                          : j == 0 ? kP1 + kP2 : j == 1 ? kP2 : j == 2 ? 0u : 0u - kP1;
  const unsigned full = 0xffffffffu;
  const int warp_stages =
      __reduce_max_sync(full, (nstripes + kStageStripes - 1) / kStageStripes);
  const bool shift = __any_sync(full, (ring.lead & 3) != 0);
  uint32_t r = acc * kP1Inv;
  if (warp_stages > 0) {
    r = shift ? walk<true>(ring, r, nstripes, warp_stages)
              : walk<false>(ring, r, nstripes, warp_stages);
  }
  acc = r * kP1;

  if (kStripes) {
    if (live) out[4 * w + j] = acc;
    return;
  }
  const int lead = lane & ~3;
  const uint32_t a1 = __shfl_sync(full, acc, lead + 1);
  const uint32_t a2 = __shfl_sync(full, acc, lead + 2);
  const uint32_t a3 = __shfl_sync(full, acc, lead + 3);
  if (!live || j != 0) return;
  uint32_t h = n >= 16 ? rotl(acc, 1) + rotl(a1, 7) + rotl(a2, 12) + rotl(a3, 18)
                       : kP5;
  h += static_cast<uint32_t>(n);
  const int rest = n & 15;
  const uint8_t* t = p + (nstripes << 4);  // the bytes after the last stripe
  int i = 0;
  for (; i + 4 <= rest; i += 4) {
    const uint32_t v = t[i] | (t[i + 1] << 8) | (t[i + 2] << 16) |
                       (static_cast<uint32_t>(t[i + 3]) << 24);
    h = rotl(h + v * kP3, 17) * kP4;
  }
  for (; i < rest; ++i) h = rotl(h + t[i] * kP5, 11) * kP1;
  h ^= h >> 15;
  h *= kP2;
  h ^= h >> 13;
  h *= kP3;
  h ^= h >> 16;
  out[w] = h;
}

template <bool kStripes>
int launch(const void* base, const void* starts, const void* lens, void* out, int nwin,
           void* stream) {
  if (nwin <= 0) return 0;
  // above 48 KB of shared memory only when asked: asked on every launch, as
  // the attribute is the current device's
  const cudaError_t e = cudaFuncSetAttribute(
      xxh32_windows<kStripes>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  xxh32_windows<kStripes><<<(nwin + kGroups - 1) / kGroups, 32, kSharedBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(lens), nwin, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
// starts: int64 [nwin], lens: int32 [nwin], out: uint32 bits [nwin].

extern "C" int lz4t_xxh32(const void* base, const void* starts,
                          const void* lens, void* out, int nwin,
                          void* stream) {
  return launch<false>(base, starts, lens, out, nwin, stream);
}

// The streaming form: accs (uint32 bits [nwin, 4]) in and out; each
// window's whole stripes are hashed from its accumulators.
extern "C" int lz4t_xxh32_stripes(const void* base, const void* starts,
                                  const void* lens, void* accs, int nwin,
                                  void* stream) {
  return launch<true>(base, starts, lens, accs, nwin, stream);
}
