// Kernel B: LZ4 block encode, FAST levels, for a batch of independent rows.
//
// Replaces the FAST arms of the TPU kernel `pallas_encode5`
// (lz4_tpu/ops/encode_pallas5.py, `_encode_body`): the canonical byU16
// scan (`canon_scan`, byte-identical to LZ4_compress_default for blocks
// below 65,547 bytes) and the dense scan (`fast_body`).  Row b holds
// lens[b] <= 65536 source bytes; its compressed bytes go to
// out[b, 0:out_stride], clens[b] is their count and errs[b] is 1 when that
// count exceeds `ocap` (a row at or below the batch capacity cannot).
// The schedules follow lz4_tpu/native/lz4tpu.c (lz4tpu_encode_fast_canonical
// and lz4tpu_encode_fast with no dictionary), whose bytes the TPU kernel
// reproduces.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kSkipTrigger = 6;
constexpr int kMaxDistance = 65535;
constexpr int kCanonHashLog = 13;
constexpr int kDenseHashLog = 15;

__device__ __forceinline__ uint32_t read32(const uint8_t* s, int p) {
  return static_cast<uint32_t>(s[p]) | (static_cast<uint32_t>(s[p + 1]) << 8) |
         (static_cast<uint32_t>(s[p + 2]) << 16) |
         (static_cast<uint32_t>(s[p + 3]) << 24);
}

template <int kHashLog>
__device__ __forceinline__ int hash4(uint32_t w) {
  return static_cast<int>((w * 2654435761u) >> (32 - kHashLog));
}

// Output cursor of one row: bytes past the row's width are counted but not
// written (the overflow flag reports them).
struct Sink {
  uint8_t* out;
  int op;
  int cap;
  __device__ __forceinline__ void put(int b) {
    if (op < cap) out[op] = static_cast<uint8_t>(b);
    ++op;
  }
};

// Common run of s[a..] and s[b..] (a < b), clipped at `limit` - b.
__device__ int run_length(const uint8_t* s, int a, int b, int limit) {
  const int b0 = b;
  while (b + 4 <= limit) {
    const uint32_t x = read32(s, a) ^ read32(s, b);
    if (x) return b - b0 + ((__ffs(static_cast<int>(x)) - 1) >> 3);
    a += 4;
    b += 4;
  }
  while (b < limit && s[a] == s[b]) {
    ++a;
    ++b;
  }
  return b - b0;
}

__device__ void put_vle(Sink& o, int v) {
  while (v >= 255) {
    o.put(255);
    v -= 255;
  }
  o.put(v);
}

// One sequence: literals s[anchor, anchor + ll), then a match of `ml` bytes
// at offset `off` (ml == 0: the final literals, no match).
__device__ void emit(Sink& o, const uint8_t* s, int anchor, int ll, int off, int ml) {
  const int mlc = ml ? ml - kMinMatch : 0;
  o.put(((ll >= 15 ? 15 : ll) << 4) | (mlc >= 15 ? 15 : mlc));
  if (ll >= 15) put_vle(o, ll - 15);
  for (int k = 0; k < ll; ++k) o.put(s[anchor + k]);
  if (ml) {
    o.put(off & 0xFF);
    o.put(off >> 8);
    if (mlc >= 15) put_vle(o, mlc - 15);
  }
}

// Upstream one-shot schedule, byU16: insert byte 0, probe from byte 1 with
// the hash computed one probe ahead, the step lagging the skip ramp by one;
// after a match, refill at ip - 2, then a zero-literal immediate retry
// without back-extension.
__device__ void canon_scan(const uint8_t* s, int n, int accel, Sink& o, uint16_t* tab) {
  int anchor = 0;
  if (n >= kMfLimit + 1) {
    const int mf1 = n - kMfLimit + 1;
    const int match_limit = n - kLastLiterals;
    int ip = 1;
    int fh = hash4<kCanonHashLog>(read32(s, ip));
    for (;;) {
      int match;
      int fwd = ip, step = 1, ramp = accel << kSkipTrigger;
      for (;;) {
        const int h = fh;
        ip = fwd;
        fwd += step;
        step = ramp++ >> kSkipTrigger;
        if (fwd > mf1) goto last_literals;
        match = tab[h];
        fh = hash4<kCanonHashLog>(read32(s, fwd));
        tab[h] = static_cast<uint16_t>(ip);
        if (read32(s, match) == read32(s, ip)) break;
      }
      while (ip > anchor && match > 0 && s[ip - 1] == s[match - 1]) {
        --ip;
        --match;
      }
      for (;;) {
        const int ml = kMinMatch + run_length(s, match + kMinMatch, ip + kMinMatch, match_limit);
        emit(o, s, anchor, ip - anchor, ip - match, ml);
        ip += ml;
        anchor = ip;
        if (ip >= mf1) goto last_literals;
        tab[hash4<kCanonHashLog>(read32(s, ip - 2))] = static_cast<uint16_t>(ip - 2);
        const int h2 = hash4<kCanonHashLog>(read32(s, ip));
        const int m2 = tab[h2];
        tab[h2] = static_cast<uint16_t>(ip);
        if (read32(s, m2) != read32(s, ip)) break;
        match = m2;
      }
      ++ip;
      fh = hash4<kCanonHashLog>(read32(s, ip));
    }
  }
last_literals:
  emit(o, s, anchor, n - anchor, 0, 0);
}

// This library's 15-bit greedy finder: probe every position the skip
// schedule reaches, back-extend each hit, insert at p - 2 after a match.
__device__ void dense_scan(const uint8_t* s, int n, int accel, Sink& o, uint16_t* tab) {
  int anchor = 0;
  if (n > kMfLimit) {
    const int mf_limit = n - kMfLimit;
    const int match_limit = n - kLastLiterals;
    int p = 0;
    int search = accel << kSkipTrigger;
    while (p < mf_limit) {
      const uint32_t w = read32(s, p);
      const int h = hash4<kDenseHashLog>(w);
      int cand = static_cast<int>(tab[h]) - 1;
      tab[h] = static_cast<uint16_t>(p + 1);
      if (cand >= 0 && p - cand <= kMaxDistance && read32(s, cand) == w) {
        while (p > anchor && cand > 0 && s[p - 1] == s[cand - 1]) {
          --p;
          --cand;
        }
        const int ml = kMinMatch + run_length(s, cand + kMinMatch, p + kMinMatch, match_limit);
        emit(o, s, anchor, p - anchor, p - cand, ml);
        p += ml;
        anchor = p;
        if (p >= mf_limit) break;
        tab[hash4<kDenseHashLog>(read32(s, p - 2))] = static_cast<uint16_t>(p - 1);
        search = accel << kSkipTrigger;
        continue;
      }
      p += search++ >> kSkipTrigger;
    }
  }
  emit(o, s, anchor, n - anchor, 0, 0);
}

__global__ void __launch_bounds__(32) encode_rows(
    const uint8_t* __restrict__ srcs, long long src_stride,
    const int* __restrict__ lens, uint8_t* __restrict__ out, int out_stride,
    int ocap, int accel, int dense, int* __restrict__ clens,
    int* __restrict__ errs) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem);
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  const int nwords = (dense ? (1 << kDenseHashLog) : (1 << kCanonHashLog)) / 2;
  for (int i = threadIdx.x; i < nwords; i += blockDim.x) words[i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int row = blockIdx.x;
  const uint8_t* s = srcs + row * src_stride;
  Sink o{out + static_cast<long long>(row) * out_stride, 0, out_stride};
  const int n = lens[row];
  if (dense)
    dense_scan(s, n, accel, o, tab);
  else
    canon_scan(s, n, accel, o, tab);
  clens[row] = o.op;
  errs[row] = o.op > ocap ? 1 : 0;
}

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------

// Dynamic shared memory of one CTA: the hash table.
extern "C" int lz4t_encode_shared_bytes(int dense) {
  return (dense ? (1 << kDenseHashLog) : (1 << kCanonHashLog)) *
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
