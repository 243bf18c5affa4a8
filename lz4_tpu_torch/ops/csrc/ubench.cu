// Micro-benchmarks of the card's primitives: the Hopper counterpart of the
// TPU's `ubench.py` (`run`, ubench.py:46, and its 20 micro-kernels at
// ubench.py:480-501), plus two primitives of this port's kernels: kernel
// E's stripe (four multiply-rotate-multiply chains) and kernel D's probe
// step (hash, shared table read, __match_any_sync, __ballot_sync).
//
// Each benchmark is one loop of n iterations, each iteration dependent on
// the one before through an accumulator (the TPU's while-loop carry), with
// its setup before the clock starts.  Thread 0 reads clock64() around the
// loop; the caller takes the slope between two n (ubench.py:56-58), so the
// launch and the setup cancel out.  Scalar benchmarks run on one thread (the
// TPU's scalar core), vector ones on one warp (the TPU's vector unit, 32
// lanes of 4 bytes for its 128).  Every loop keeps `#pragma unroll 1`: one
// trip is one iteration.  Each kernel writes its accumulators (one per
// thread) so that the caller can hold them to the plain versions
// (ops/ubench.py) and no loop can be compiled away; `seed` is a launch
// argument, so nothing folds to a constant.
//
// What bounds each: the latency of its dependent chain, which is what the
// slope measures.

#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_encode_body.cuh"

using namespace lz4t;

namespace {

enum Bench {
  kLoop, kSmemDepRead, kSmemDepRead2, kSmemDepRead4, kInnerWhile, kInnerInline,
  kSmemStoreThenLoad, kSmemStoreOnly, kSmemLoadIndep, kVmemDynRead, kVmemDynRmw,
  kRollDynamic, kVecCopy, kRollStatic, kVecAdd, kWhenScalarUntaken, kWhenVecUntaken,
  kMergedSeq, kMxuGather128, kSmemStoreLoadDep, kXxh32Stripe, kProbeStep, kBenches
};

constexpr uint32_t kP1 = 2654435761u;  // xxHash32's primes
constexpr uint32_t kP2 = 2246822519u;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// The benchmarks that run on one warp; the others run on one thread.
__host__ __device__ constexpr bool warp_bench(int k) {
  return k == kVmemDynRead || k == kVmemDynRmw || k == kWhenVecUntaken || k == kRollDynamic ||
         k == kRollStatic || k == kVecCopy || k == kVecAdd || k == kMergedSeq ||
         k == kMxuGather128 || k == kProbeStep;
}

// The loop of one benchmark; every thread of the launch calls it.  Returns
// the thread's accumulator; t0/t1 are the clock around the loop.
template <int K>
__device__ uint32_t bench(int n, uint32_t seed, long long& t0, long long& t1) {
  // one 32 KB buffer, seen as the TPU kernels' scalar scratch (sc), a
  // 256-row tile of 32 words (vm) or bytes (buf)
  __shared__ __align__(16) uint32_t mem[256 * 32];
  uint32_t* const sc = mem;
  uint32_t* const vm = mem;
  uint8_t* const buf = reinterpret_cast<uint8_t*>(mem);
  const int lane = threadIdx.x;
  uint32_t a = 0;
  if constexpr (K == kLoop) {
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) a += static_cast<uint32_t>(i) ^ seed;
  } else if constexpr (K == kSmemDepRead) {
    const uint32_t init[8] = {seed, 2, 5, 1, 7, 3, 0, 6};
    for (int j = 0; j < 8; ++j) sc[j] = init[j];
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) a = sc[a & 7];
  } else if constexpr (K == kSmemDepRead2 || K == kSmemDepRead4) {
    constexpr int kChains = K == kSmemDepRead2 ? 2 : 4;
    const uint32_t mul[4] = {3, 5, 7, 1}, add[4] = {1, 2, 3, 5};
    for (int c = 0; c < kChains; ++c)
      for (int j = 0; j < 8; ++j) sc[8 * c + j] = ((seed >> (3 * c)) + mul[c] * j + add[c]) & 7;
    uint32_t x[kChains];
    for (int c = 0; c < kChains; ++c) x[c] = c;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int c = 0; c < kChains; ++c) x[c] = sc[8 * c + (x[c] & 7)];
    for (int c = 0; c < kChains; ++c) a += x[c];
  } else if constexpr (K == kInnerWhile || K == kInnerInline) {
    for (int j = 0; j < 64; ++j) sc[j] = j;
    a = seed;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      if constexpr (K == kInnerWhile) {
#pragma unroll 1
        for (int j = 0; j < 1 + (i & 1); ++j) a = sc[(a + j) & 63];
      } else {
        a = sc[a & 63];
        if (i & 1) a = sc[(a + 1) & 63];
      }
    }
  } else if constexpr (K == kSmemStoreThenLoad) {
    for (int j = 0; j < 64; ++j) sc[j] = j;
    a = seed;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      sc[i & 63] = a;
      a = sc[(i + 32) & 63] + 1;
    }
  } else if constexpr (K == kSmemStoreOnly) {
    for (int j = 0; j < 64; ++j) sc[j] = j;
    sc[0] = seed;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      sc[i & 63] = a;
      a += 1;
    }
    a += sc[seed & 63];
  } else if constexpr (K == kSmemLoadIndep) {
    for (int j = 0; j < 64; ++j) sc[j] = j ^ seed;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) a += sc[(i + 32) & 63];
  } else if constexpr (K == kVmemDynRead || K == kVmemDynRmw || K == kWhenVecUntaken) {
    for (int r = 0; r < 256; ++r) vm[r * 32 + lane] = (r * 32 + lane) ^ seed;
    __syncwarp();
    const uint32_t base = seed;  // the TPU's second carry
    t0 = clock64();
    if constexpr (K == kVmemDynRead) {
#pragma unroll 1
      for (int i = 0; i < n; ++i) a += vm[((i + base) & 255) * 32 + lane];
    } else if constexpr (K == kVmemDynRmw) {
#pragma unroll 1
      for (int i = 0; i < n; ++i) vm[((i + base) & 255) * 32 + lane] += 1;
      a = vm[lane] + vm[255 * 32 + lane];
    } else {
      // the test reads the carry, so that it stays in the loop (a test of
      // i and the seed alone is loop-invariant, and nvcc hoists it out)
      uint32_t c = seed & 0xFFFF;
#pragma unroll 1
      for (int i = 0; i < n; ++i) {
        if (static_cast<int>(i ^ c) < 0) vm[(i & 255) * 32 + lane] = i;
        c += 1;
      }
      a = c + vm[(seed & 255) * 32 + lane];
    }
  } else if constexpr (K == kRollDynamic || K == kRollStatic) {
    a = lane ^ seed;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i)
      a = __shfl_sync(kFull, a, (lane + (K == kRollDynamic ? i : 5)) & 31);
  } else if constexpr (K == kVecCopy) {
    for (int k = lane; k < 512; k += 32) buf[k] = (k * 131 + seed) & 255;
    __syncwarp();
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int dst = 256 + ((i * 13) & 127);
      buf[dst + lane] = buf[((a + i) & 127) + lane];
      __syncwarp();
      a += buf[dst];
      __syncwarp();
    }
    a += buf[256 + lane] + (buf[384 + lane] << 8);
  } else if constexpr (K == kVecAdd) {
    a = lane ^ seed;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) a += static_cast<uint32_t>(i) ^ lane;
  } else if constexpr (K == kWhenScalarUntaken) {
    sc[0] = seed & 255;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      if (static_cast<int>(i ^ a) < 0) sc[0] = i;  // never: a, i < 2^31
      a += sc[0];
    }
  } else if constexpr (K == kMergedSeq) {
    for (int k = lane; k < 16384; k += 32) buf[k] = (k * 37 + seed) & 255;
    __syncwarp();
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int ll = i & 15, ml = 4 + ((i >> 4) & 15), off = 1 + ((a + i) & 31);
      const int src = (i * 13 + a) & 4095, d = 8192 + ((i * 11) & 4095), m = d + ll;
      if (lane < ll) buf[d + lane] = buf[src + lane];  // the literals
      __syncwarp();
      if (lane < ml) buf[m + lane] = buf[m - off + lane % off];  // the match
      __syncwarp();
      a += buf[m + ml - 1];
      __syncwarp();
    }
    a += buf[8192 + 128 * lane];
  } else if constexpr (K == kMxuGather128) {
    uint32_t* w = vm;
    for (int k = lane; k < 4096 + 32; k += 32) w[k] = (k * kP1) ^ seed;
    __syncwarp();
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      uint32_t x = w[((a + i) & 4095) + lane];  // 128 bytes at a dynamic base
#pragma unroll
      for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
      a += x;
    }
  } else if constexpr (K == kSmemStoreLoadDep) {
    for (int j = 0; j < 64; ++j) sc[j] = j ^ seed;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const uint32_t mi = sc[a];
      sc[a] = i;
      a = (mi * 7 + i) & 63;
    }
  } else if constexpr (K == kXxh32Stripe) {
    // the stripe's words from registers (made from i, off the chains), so
    // that the slope is the four chains' latency and not a load's
    uint32_t v0 = seed + kP1 + kP2, v1 = seed + kP2, v2 = seed, v3 = seed - kP1;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const uint32_t x = (4 * i) * 0x9E3779B1u ^ seed;
      v0 = rotl(v0 + x * kP2, 13) * kP1;
      v1 = rotl(v1 + (x + 0x9E3779B1u) * kP2, 13) * kP1;
      v2 = rotl(v2 + (x + 2 * 0x9E3779B1u) * kP2, 13) * kP1;
      v3 = rotl(v3 + (x + 3 * 0x9E3779B1u) * kP2, 13) * kP1;
    }
    a = rotl(v0, 1) + rotl(v1, 7) + rotl(v2, 12) + rotl(v3, 18);
  } else if constexpr (K == kProbeStep) {
    uint32_t* tab = vm;
    for (int k = lane; k < (1 << kCanonHashLog32); k += 32) tab[k] = 0;
    __syncwarp();
    uint32_t carry = seed;
    t0 = clock64();
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const uint32_t x = (carry + i) * 32 + lane;
      const int h = canon_hash5(static_cast<uint64_t>(x) * 0x9E3779B97F4A7C15ull);
      const uint32_t c = tab[h];
      const unsigned peers = __match_any_sync(kFull, h);
      const unsigned hits = __ballot_sync(kFull, (c ^ x) & 1);
      commit(tab, h, peers, 31, static_cast<int>(x));  // the highest lane of a bucket writes
      carry += __popc(hits);
      a += c;
    }
    a += carry;
  }
  if constexpr (warp_bench(K)) __syncwarp();
  t1 = clock64();
  return a;
}

template <int K>
__global__ void __launch_bounds__(32) ubench(int n, uint32_t seed, uint32_t* acc,
                                             long long* cycles) {
  long long t0 = 0, t1 = 0;
  const uint32_t a = bench<K>(n, seed, t0, t1);
  acc[threadIdx.x] = a;
  if (threadIdx.x == 0) cycles[0] = t1 - t0;
}

template <int K>
cudaError_t launch(int which, int n, uint32_t seed, uint32_t* acc, long long* cycles,
                   cudaStream_t stream) {
  if constexpr (K == kBenches) {
    return cudaErrorInvalidValue;
  } else {
    if (which != K) return launch<K + 1>(which, n, seed, acc, cycles, stream);
    ubench<K><<<1, warp_bench(K) ? 32 : 1, 0, stream>>>(n, seed, acc, cycles);
    return cudaGetLastError();
  }
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------

// Launches benchmark `which` (the order of the Bench enum, ops/ubench.py's
// BENCHES) on one CTA of one warp or one thread over n iterations, on
// `stream`; acc gets one uint32 per thread, cycles the loop's clock64()
// span.  Returns the first CUDA error (0 on success).
extern "C" int lz4t_ubench(int which, int n, int seed, void* acc, void* cycles, void* stream) {
  return static_cast<int>(launch<0>(which, n, static_cast<uint32_t>(seed),
                                    static_cast<uint32_t*>(acc),
                                    static_cast<long long*>(cycles),
                                    static_cast<cudaStream_t>(stream)));
}
