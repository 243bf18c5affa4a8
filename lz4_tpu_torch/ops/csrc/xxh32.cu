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
//   3.35 TB/s = 0.02 ms);
// - one long window: the dependent chain.  Each 16-byte stripe updates the
//   four accumulators with a multiply-add, a rotate and a multiply, each on
//   the result of the one before: about 10 cycles a stripe, about 21 ms per
//   64 MiB at 1,980 MHz.  xxHash32 defines that chain; no layout removes it.
//
// What this design does about that: one warp per window.  The warp loads
// 2 KB at a time, coalesced, 16 bytes a lane per step, into one half of a
// double buffer in shared memory, and issues the loads of the next 2 KB
// before it walks the current one, so that on a long window the chain, not
// the load latency, sets the time.  Lane j carries accumulator j & 3 (the
// four are independent until the merge; lanes 4-31 repeat lanes 0-3's work
// at no cost in issue slots), so a stripe costs the warp four instructions.
// Lane 0 merges the accumulators and does the tails and the avalanche.
//
// The streaming form (`lz4t_xxh32_stripes`, the kStripes instance of the
// same kernel) is the same walk with the four accumulators read from, and
// written back to, a device array in place of the seed's: a frame's
// content hash carried across the writes or reads of a stream, the host
// keeping the total and the bytes after the last whole stripe.  Its bound
// is the long window's: the dependent chain, about 10 cycles a stripe
// (0.33 ms per MiB at 1,980 MHz), against 0.3 us per MiB of bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP1 = 2654435761u;
constexpr uint32_t kP2 = 2246822519u;
constexpr uint32_t kP3 = 3266489917u;
constexpr uint32_t kP4 = 668265263u;
constexpr uint32_t kP5 = 374761393u;

constexpr int kWarps = 4;                     // windows per CTA
constexpr int kSteps = 4;                     // 16-byte loads per lane per chunk
constexpr int kChunkStripes = kSteps * 32;    // 128 stripes
constexpr int kChunk = kChunkStripes * 16;    // 2,048 bytes

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Window bytes [c0 + 16 i, c0 + 16 i + 16) for i = step * 32 + lane, as four
// LE words.  Bytes past the window's end are don't-care: every load is of an
// aligned word or vector that holds at least one byte of the window, so it
// stays inside the window's allocation.  A window whose start is not 16-byte
// aligned reads five aligned words and funnel-shifts them into place.
__device__ __forceinline__ void load_chunk(uint4 (&v)[kSteps],
                                           const uint8_t* p, int c0, int n,
                                           bool aligned16, int mis, int lane) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int o = c0 + (u * 32 + lane) * 16;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (o < n) {
      if (aligned16) {
        r = __ldg(reinterpret_cast<const uint4*>(p + o));
      } else {
        const uint32_t* q = reinterpret_cast<const uint32_t*>(p + o - mis);
        const int left = n - o + mis;  // bytes from q to the window's end
        uint32_t a[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) a[i] = 4 * i < left ? __ldg(q + i) : 0u;
        const int s = 8 * mis;
        r = make_uint4(__funnelshift_r(a[0], a[1], s),
                       __funnelshift_r(a[1], a[2], s),
                       __funnelshift_r(a[2], a[3], s),
                       __funnelshift_r(a[3], a[4], s));
      }
    }
    v[u] = r;
  }
}

// kStripes: out holds four accumulators per window, read before the first
// stripe and written after the last; the window's bytes after its last
// whole stripe are not read into the hash.
template <bool kStripes>
__global__ void __launch_bounds__(kWarps * 32) xxh32_windows(
    const uint8_t* __restrict__ base, const long long* __restrict__ starts,
    const int* __restrict__ lens, int nwin, uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint4 ring[kWarps][2][kChunkStripes];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + warp;
  if (w >= nwin) return;  // the whole warp; the CTA never synchronises
  const uint8_t* p = base + starts[w];
  const int n = lens[w];
  const bool aligned16 = (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 3);
  const int nstripes = n >> 4;
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int j = lane & 3;
  uint32_t acc = kStripes ? out[4 * w + j]
                          : j == 0 ? kP1 + kP2 : j == 1 ? kP2 : j == 2 ? 0u : 0u - kP1;

  uint4 next[kSteps];
  if (nchunks > 0) load_chunk(next, p, 0, n, aligned16, mis, lane);
  for (int c = 0; c < nchunks; ++c) {
    // this half was last read two chunks ago, before the previous
    // iteration's __syncwarp
    uint4* buf = ring[warp][c & 1];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) buf[u * 32 + lane] = next[u];
    __syncwarp();
    if (c + 1 < nchunks) {
      load_chunk(next, p, (c + 1) * kChunk, n, aligned16, mis, lane);
    }
    const uint32_t* words = reinterpret_cast<const uint32_t*>(buf) + j;
    const int ns = min(kChunkStripes, nstripes - c * kChunkStripes);
    if (ns == kChunkStripes) {
#pragma unroll 16
      for (int k = 0; k < kChunkStripes; ++k) {
        acc = rotl(acc + words[4 * k] * kP2, 13) * kP1;
      }
    } else {
      for (int k = 0; k < ns; ++k) {
        acc = rotl(acc + words[4 * k] * kP2, 13) * kP1;
      }
    }
  }

  if (kStripes) {
    // every lane read its accumulator before the first chunk
    if (lane < 4) out[4 * w + lane] = acc;
    return;
  }
  const uint32_t a1 = __shfl_sync(0xffffffffu, acc, 1);
  const uint32_t a2 = __shfl_sync(0xffffffffu, acc, 2);
  const uint32_t a3 = __shfl_sync(0xffffffffu, acc, 3);
  if (lane != 0) return;
  uint32_t h = n >= 16 ? rotl(acc, 1) + rotl(a1, 7) + rotl(a2, 12) + rotl(a3, 18)
                       : kP5;
  h += static_cast<uint32_t>(n);
  const int rest = n & 15;
  if (rest) {
    // the bytes after the last stripe lie in the last chunk's half
    const uint8_t* t = reinterpret_cast<const uint8_t*>(ring[warp][(nchunks - 1) & 1]) +
                       (nstripes * 16) % kChunk;
    int i = 0;
    for (; i + 4 <= rest; i += 4) {
      const uint32_t v = t[i] | (t[i + 1] << 8) | (t[i + 2] << 16) |
                         (static_cast<uint32_t>(t[i + 3]) << 24);
      h = rotl(h + v * kP3, 17) * kP4;
    }
    for (; i < rest; ++i) h = rotl(h + t[i] * kP5, 11) * kP1;
  }
  h ^= h >> 15;
  h *= kP2;
  h ^= h >> 13;
  h *= kP3;
  h ^= h >> 16;
  out[w] = h;
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
// starts: int64 [nwin], lens: int32 [nwin], out: uint32 bits [nwin].

extern "C" int lz4t_xxh32(const void* base, const void* starts,
                          const void* lens, void* out, int nwin,
                          void* stream) {
  if (nwin <= 0) return 0;
  xxh32_windows<false><<<(nwin + kWarps - 1) / kWarps, kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(lens), nwin, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The streaming form: accs (uint32 bits [nwin, 4]) in and out; each
// window's whole stripes are hashed from its accumulators.
extern "C" int lz4t_xxh32_stripes(const void* base, const void* starts,
                                  const void* lens, void* accs, int nwin,
                                  void* stream) {
  if (nwin <= 0) return 0;
  xxh32_windows<true><<<(nwin + kWarps - 1) / kWarps, kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(base), static_cast<const long long*>(starts),
      static_cast<const int*>(lens), nwin, static_cast<uint32_t*>(accs));
  return static_cast<int>(cudaGetLastError());
}
