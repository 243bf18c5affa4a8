// Kernel A: LZ4 block decode for a batch of independent rows.
//
// Replaces the TPU kernel `pallas_decode6` (lz4_tpu/ops/decode_pallas6.py,
// body `_decode_one`).  Same contract: row b holds comp_lens[b] compressed
// bytes; it decodes into out[b, 0:out_cap]; an optional right-aligned
// 64 KB dictionary row lets matches reach dict_lens[b] bytes before the
// output start.  lens[b] is the number of bytes produced (at the start of
// the sequence that failed, on error) and errs[b] is 0 or 1 for malformed
// input (2, trailing garbage, cannot occur: the literal-only last sequence
// must end at comp_lens[b]).  Each row fails or succeeds on its own.
//
// What bounds it on the card: the bytes are few (each compressed byte read
// once, each output byte written once), but the parse is a byte-serial
// dependency chain per row: a sequence's token, its length extensions and
// its offset must be read before the next token's position is known.  A
// 4 MiB row of text holds ~0.5 M sequences.
//
// What this design does about that: every position of a row is parsed at
// once, as the JAX package's dense decoder does (`decode_jax.py`,
// `_parse_and_decode`), and the true sequences are the orbit of position 0
// under "the token after this one".  Passes, all rows at once, on one
// stream, sizes read on the card (no host round trip between them):
//   1. `rows_nn`: for every position, the next byte that is not 255 (or
//      the row's end): a length extension then reads in O(1).
//   2. `rows_spans`: per segment of kSeg positions (one CTA, tables in
//      shared memory), every position parsed speculatively (`parse_at`,
//      decode_block's structural checks) into its successor, then pointer
//      jumping inside the segment: for every position, the first chain
//      position at or past the segment's end (or the end of the chain), the
//      sequences on the way and the bytes they decode to.
//   3. `rows_hops`: one thread per row hops segment to segment from
//      position 0, giving each segment the chain's entry into it, the
//      sequence index and the output position there.
//   4. `rows_table`: one thread per segment walks the chain from its entry
//      to the segment's end, writing the sequence table (literal source,
//      literal length, output position, offset, match length: 0 for the
//      literal-only last sequence, -1 for one that fails a structural
//      check) and holding each sequence to the checks that need the output
//      position; the first failing sequence of the row (atomicMin).
//   5. `rows_literals`: each row's lens and errs; literal runs copied to
//      their place (one warp per sequence, up to the failing one), and an
//      index array per row: a literal byte points to itself, byte j of a
//      match at d to d - off + (j mod off) (negative: the dictionary), one
//      hop out of its own match however much it overlaps.
//   6. `rows_jump` rounds and `rows_gather`: pointer jumping until a round
//      changes nothing (a device flag per round), then every match byte
//      gathered from the literal or dictionary byte it finally copies.
// Scratch, sized by the rows' comp_lens: four int32 per compressed
// position, 20 bytes of sequence table per 3 compressed bytes, and an
// int32 index per output byte (min(out_cap, 255 comp_len) per row).
//
// Rows of at most 64 KB (out_cap) take the one-warp route instead
// (`decode_rows`: a warp per row, every lane walking the serial parse of
// lz4_decode_body.cuh): on the H100 it decodes 1,024 rows of 64 KB in
// 3.7 ms against the passes' 6.0, whose pointer-jumping rounds cost the
// same per byte at any row size, while at 1 MiB and 4 MiB the passes take
// 6.9 and 8.2 ms against 47.7 and 187.1 (ops/decode.py, WARP_ROUTE_MAX).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "lz4_decode_body.cuh"

namespace {

constexpr long long kDictCap = 65536;
constexpr int kMinMatch = 4;
constexpr int kSeg = 4096;        // positions of one segment of the parse
constexpr int kSegThreads = 512;  // threads of a rows_spans CTA
constexpr int kEnd = INT_MAX;     // successor of a chain's last sequence
constexpr int kRow = 5;           // columns of the sequence table
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int sat(long long v) {
  return v > INT_MAX ? INT_MAX : static_cast<int>(v);
}

// The sequence that would start at position q: kind 0 a match, 1 the
// literal-only last sequence, 2 a structural failure (q at or past clen, a
// literal run or offset past clen, offset 0).
struct Seq {
  int kind;
  int lit;
  long long ll;
  int off;
  long long ml;
  int next;  // the next token's position (a match), else kEnd
};

// A length extension at t: bytes are added while they are 255 and input
// remains (decode_block's read_vle), the run's end read from nn.
__device__ __forceinline__ long long vle(const uint8_t* src, const int* nn, int clen, int& t) {
  if (t >= clen) return 0;
  const int e = nn[t];
  if (e < clen) {
    const long long v = 255LL * (e - t) + src[e];
    t = e + 1;
    return v;
  }
  const long long v = 255LL * (clen - t);
  t = clen;
  return v;
}

__device__ inline Seq parse_at(const uint8_t* src, const int* nn, int clen, int q) {
  Seq s{2, 0, 0, 0, 0, kEnd};
  if (q >= clen) return s;
  const int token = src[q];
  int t = q + 1;
  long long ll = token >> 4;
  if (ll == 15) ll += vle(src, nn, clen, t);
  if (t + ll > clen) return s;
  s.lit = t;
  s.ll = ll;
  t += static_cast<int>(ll);
  if (t >= clen) {
    s.kind = 1;
    return s;
  }
  if (t + 2 > clen) {
    s.lit = 0;
    s.ll = 0;
    return s;
  }
  const int off = src[t] | (src[t + 1] << 8);
  t += 2;
  long long ml = (token & 15) + kMinMatch;
  if ((token & 15) == 15) ml += vle(src, nn, clen, t);
  if (off == 0) {
    s.lit = 0;
    s.ll = 0;
    return s;
  }
  s.kind = 0;
  s.off = off;
  s.ml = ml;
  s.next = t;
  return s;
}

__device__ __forceinline__ int row_clen(const int* comp_lens, int b) {
  const int c = comp_lens[b];
  return c > 0 ? c : 0;
}

// Pass 1.  Grid (rows, chunks of 256 positions), 256 threads: one warp per
// 32 positions; a warp whose last lanes see only 255 walks on 32 bytes a
// step.  Positions 0..clen; nn[clen] = clen.
__global__ void __launch_bounds__(256) rows_nn(
    const uint8_t* __restrict__ comps, long long comp_stride,
    const int* __restrict__ comp_lens, const long long* __restrict__ cbase,
    int* __restrict__ nn) {
  const int b = blockIdx.x;
  const int clen = row_clen(comp_lens, b);
  const int lane = threadIdx.x & 31;
  const uint8_t* src = comps + b * comp_stride;
  int* rnn = nn + cbase[b];
  for (int base = (blockIdx.y * 8 + (threadIdx.x >> 5)) * 32; base <= clen;
       base += gridDim.y * 256) {
    const int q = base + lane;
    const unsigned m = __ballot_sync(kAll, q >= clen || src[q] != 255);
    int e = m >> lane ? q + __ffs(m >> lane) - 1 : -1;
    if (!(m >> 31)) {  // the tail of the chunk is 255: find the run's end
      for (int at = base + 32;; at += 32) {
        const int p = at + lane;
        const unsigned m2 = __ballot_sync(kAll, p >= clen || src[p] != 255);
        if (m2) {
          if (e < 0) e = at + __ffs(m2) - 1;
          break;
        }
      }
    }
    if (q <= clen) rnn[q] = e;
  }
}

// One segment of rows_spans: positions s0 .. s0 + len - 1 of the row, the
// tables nx (successor), cn (sequences) and os (bytes decoded) in shared
// memory.
__device__ inline void span(const uint8_t* src, const int* rnn, int clen, int s0,
                            int* nx, int* cn, int* os, int* exits, int* counts,
                            int* sums) {
  constexpr int kPer = kSeg / kSegThreads;
  const int len = min(kSeg, clen + 1 - s0);
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kSegThreads;
    if (i >= len) break;
    const Seq s = parse_at(src, rnn, clen, s0 + i);
    nx[i] = s.next;
    cn[i] = 1;
    os[i] = s.kind == 2 ? 0 : sat(s.ll + s.ml);
  }
  __syncthreads();
  const int s1 = s0 + len;
  for (;;) {
    int vx[kPer], vc[kPer], vs[kPer];
    bool changed = false;
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kSegThreads;
      vx[j] = -1;
      if (i >= len) continue;
      const int v = nx[i];
      if (v >= s1) continue;  // left the segment, or kEnd
      const int u = v - s0;
      vx[j] = nx[u];
      vc[j] = cn[i] + cn[u];
      vs[j] = sat(static_cast<long long>(os[i]) + os[u]);
      changed = true;
    }
    __syncthreads();
    for (int j = 0; j < kPer; ++j) {
      if (vx[j] < 0) continue;
      const int i = threadIdx.x + j * kSegThreads;
      nx[i] = vx[j];
      cn[i] = vc[j];
      os[i] = vs[j];
    }
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < len; i += kSegThreads) {
    exits[s0 + i] = nx[i];
    counts[s0 + i] = cn[i];
    sums[s0 + i] = os[i];
  }
}

// Pass 2.  Grid (rows, segments), kSegThreads threads.
__global__ void __launch_bounds__(kSegThreads) rows_spans(
    const uint8_t* __restrict__ comps, long long comp_stride,
    const int* __restrict__ comp_lens, const long long* __restrict__ cbase,
    const int* __restrict__ nn, int* __restrict__ exits,
    int* __restrict__ counts, int* __restrict__ sums) {
  __shared__ int nx[kSeg], cn[kSeg], os[kSeg];
  const int b = blockIdx.x;
  const int clen = row_clen(comp_lens, b);
  const uint8_t* src = comps + b * comp_stride;
  const int* rnn = nn + cbase[b];
  for (int s0 = blockIdx.y * kSeg; s0 <= clen; s0 += gridDim.y * kSeg) {
    span(src, rnn, clen, s0, nx, cn, os, exits + cbase[b], counts + cbase[b],
         sums + cbase[b]);
    __syncthreads();  // the tables are refilled for the next segment
  }
}

// Pass 3.  One thread per row.  entry[] holds -1 where the chain skips a
// segment (a literal run longer than kSeg).
__global__ void __launch_bounds__(128) rows_hops(
    const int* __restrict__ comp_lens, int nrows,
    const long long* __restrict__ cbase, const long long* __restrict__ gbase,
    const int* __restrict__ exits, const int* __restrict__ counts,
    const int* __restrict__ sums, int* __restrict__ entry,
    int* __restrict__ seq_at, int* __restrict__ op_at, int* __restrict__ nseq,
    int* __restrict__ total) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nrows) return;
  const long long cb = cbase[b], gb = gbase[b];
  int e = 0, seq = 0;
  long long op = 0;
  while (e != kEnd) {
    const long long k = gb + e / kSeg;
    entry[k] = e;
    seq_at[k] = seq;
    op_at[k] = static_cast<int>(op);
    seq += counts[cb + e];
    op = min(op + sums[cb + e], static_cast<long long>(INT_MAX));
    e = exits[cb + e];
  }
  nseq[b] = seq;
  total[b] = static_cast<int>(op);
}

// Pass 4.  Grid (rows, chunks of 128 segments), one thread per segment.
__global__ void __launch_bounds__(128) rows_table(
    const uint8_t* __restrict__ comps, long long comp_stride,
    const int* __restrict__ comp_lens, int out_cap,
    const int* __restrict__ dict_lens, const long long* __restrict__ cbase,
    const long long* __restrict__ gbase, const long long* __restrict__ sbase,
    const int* __restrict__ nn, const int* __restrict__ entry,
    const int* __restrict__ seq_at, const int* __restrict__ op_at,
    int* __restrict__ seqs, int* __restrict__ fail) {
  const int b = blockIdx.x;
  const int clen = row_clen(comp_lens, b);
  const long long dlen = dict_lens ? dict_lens[b] : 0;
  const uint8_t* src = comps + b * comp_stride;
  const int* rnn = nn + cbase[b];
  int first = INT_MAX;
  for (int k = blockIdx.y * blockDim.x + threadIdx.x; k * kSeg <= clen;
       k += gridDim.y * blockDim.x) {
    const long long gk = gbase[b] + k;
    int q = entry[gk];
    if (q < 0) continue;
    const int end = min((k + 1) * kSeg, clen + 1);
    int i = seq_at[gk];
    long long op = op_at[gk];
    int* row = seqs + kRow * (sbase[b] + i);
    while (q < end) {
      const Seq s = parse_at(src, rnn, clen, q);
      row[0] = s.lit;
      row[1] = sat(s.ll);
      row[2] = sat(op);
      row[3] = s.off;
      row[4] = s.kind == 0 ? sat(s.ml) : (s.kind == 1 ? 0 : -1);
      const bool bad = s.kind == 2 || op + s.ll > out_cap ||
                       (s.kind == 0 && (s.off > op + s.ll + dlen || op + s.ll + s.ml > out_cap));
      if (bad && i < first) first = i;
      op += s.ll + s.ml;
      ++i;
      row += kRow;
      q = s.next;
    }
  }
  if (first != INT_MAX) atomicMin(fail + b, first);
}

// Pass 5.  Grid (rows, chunks) of 256 threads, one warp per sequence.
__global__ void __launch_bounds__(256) rows_literals(
    const uint8_t* __restrict__ comps, long long comp_stride, int out_cap,
    const long long* __restrict__ sbase, const long long* __restrict__ pbase,
    const int* __restrict__ seqs, const int* __restrict__ nseq,
    const int* __restrict__ total, const int* __restrict__ fail,
    uint8_t* __restrict__ out, int* __restrict__ ptr, int* __restrict__ lens,
    int* __restrict__ errs) {
  const int b = blockIdx.x;
  const int n = nseq[b];
  const int f = fail[b];
  const int use = f < n ? f : n;
  const int* rows = seqs + kRow * sbase[b];
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    lens[b] = f < n ? rows[kRow * f + 2] : total[b];
    errs[b] = f < n ? 1 : 0;
  }
  const uint8_t* src = comps + b * comp_stride;
  uint8_t* dst = out + static_cast<long long>(b) * out_cap;
  int* pk = ptr + pbase[b];
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int i = blockIdx.y * warps + (threadIdx.x >> 5); i < use; i += gridDim.y * warps)
    lz4t::place_sequence(rows + kRow * i, src, dst, pk, 0, lane);
}

// Pass 6: one round of pointer jumping over every row's index array (an
// entry below 0 is a dictionary byte, final; a literal's points to
// itself).  Returns at once when the round before changed nothing.
__global__ void __launch_bounds__(256) rows_jump(
    const long long* __restrict__ pbase, const int* __restrict__ lens,
    int* ptr, int* flags, int round) {
  if (round > 0 && flags[round - 1] == 0) return;
  const int b = blockIdx.x;
  const int n = lens[b];
  int* pk = ptr + pbase[b];
  bool changed = false;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < n; i += gridDim.y * blockDim.x)
    changed |= lz4t::jump_entry(pk, i, 0);
  if (__syncthreads_or(changed) && threadIdx.x == 0) flags[round] = 1;
}

__global__ void __launch_bounds__(256) rows_gather(
    const long long* __restrict__ pbase, const int* __restrict__ lens,
    const int* __restrict__ ptr, int out_cap, const uint8_t* __restrict__ dicts,
    uint8_t* out) {
  const int b = blockIdx.x;
  const int n = lens[b];
  const int* pk = ptr + pbase[b];
  uint8_t* dst = out + static_cast<long long>(b) * out_cap;
  const uint8_t* dict_end = dicts ? dicts + (b + 1) * kDictCap : nullptr;
  for (int i = blockIdx.y * blockDim.x + threadIdx.x; i < n; i += gridDim.y * blockDim.x) {
    const int v = pk[i];
    if (v != i) dst[i] = v < 0 ? dict_end[v] : dst[v];
  }
}

// The one-warp route: one CTA of one warp per row, every lane walking the
// same serial parse (lz4_decode_body.cuh), the warp copying each literal
// run and match together.  `limits` (may be null: no limit) gives each row
// an output limit, -1 for none: a partial decode, which stops at the
// limit (`decode_block`); its bound is the bytes up to the limit.
__global__ void __launch_bounds__(32) decode_rows(
    const uint8_t* __restrict__ comps, long long comp_stride,
    const int* __restrict__ comp_lens, uint8_t* out, int out_cap,
    const uint8_t* __restrict__ dicts, const int* __restrict__ dict_lens,
    const int* __restrict__ limits, int* __restrict__ lens,
    int* __restrict__ errs) {
  const int row = blockIdx.x;
  const int dlen = dicts ? dict_lens[row] : 0;
  const uint8_t* dict_end = dicts ? dicts + (row + 1) * kDictCap : nullptr;
  int produced;
  const int err = lz4t::decode_block(comps + row * comp_stride, comp_lens[row],
                                     out + (long long)row * out_cap, out_cap,
                                     dict_end, dlen, &produced,
                                     limits ? limits[row] : -1);
  if (threadIdx.x == 0) {
    lens[row] = produced;
    errs[row] = err;
  }
}

// A grid's second dimension: at most 65,535 (the kernels stride over the
// rest).
int chunks(int n) { return n < 1 ? 1 : (n > 65535 ? 65535 : n); }

}  // namespace

// ---- C interface (ctypes) ------------------------------------------------
// Each entry point launches on `stream`, does not synchronise and returns
// cudaGetLastError().  The caller lays out the scratch from the rows'
// comp_lens (c = max(comp_len, 0)): cbase, the exclusive scan of c + 1
// (positions of nn, exits, counts, sums); gbase, of ceil((c + 1) / kSeg)
// (segments of entry, seq_at, op_at; entry filled with -1); sbase, of
// c / 3 + 1 (sequence-table rows); pbase, of min(out_cap, 255 c) (index
// entries); `fail` filled with INT_MAX; `out` zeroed; `flags` (rounds ints)
// zeroed.  `dicts`/`dict_lens` may be null (no dictionary).

extern "C" int lz4t_rows_segment() { return kSeg; }

extern "C" int lz4t_rows_parse(const void* comps, long long comp_stride,
                               const void* comp_lens, int out_cap,
                               const void* dict_lens, int nrows, int max_clen,
                               const void* cbase, const void* gbase,
                               const void* sbase, void* nn, void* exits,
                               void* counts, void* sums, void* entry,
                               void* seq_at, void* op_at, void* nseq,
                               void* total, void* seqs, void* fail,
                               void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(comps);
  const auto* cl = static_cast<const int*>(comp_lens);
  const auto* cb = static_cast<const long long*>(cbase);
  const auto* gb = static_cast<const long long*>(gbase);
  const int positions = max_clen + 1;
  rows_nn<<<dim3(nrows, chunks((positions + 255) / 256)), 256, 0, s>>>(
      c, comp_stride, cl, cb, static_cast<int*>(nn));
  const int segs = (positions + kSeg - 1) / kSeg;
  rows_spans<<<dim3(nrows, chunks(segs)), kSegThreads, 0, s>>>(
      c, comp_stride, cl, cb, static_cast<const int*>(nn),
      static_cast<int*>(exits), static_cast<int*>(counts), static_cast<int*>(sums));
  rows_hops<<<(nrows + 127) / 128, 128, 0, s>>>(
      cl, nrows, cb, gb, static_cast<const int*>(exits),
      static_cast<const int*>(counts), static_cast<const int*>(sums),
      static_cast<int*>(entry), static_cast<int*>(seq_at), static_cast<int*>(op_at),
      static_cast<int*>(nseq), static_cast<int*>(total));
  rows_table<<<dim3(nrows, chunks((segs + 127) / 128)), 128, 0, s>>>(
      c, comp_stride, cl, out_cap, static_cast<const int*>(dict_lens), cb, gb,
      static_cast<const long long*>(sbase), static_cast<const int*>(nn),
      static_cast<const int*>(entry), static_cast<const int*>(seq_at),
      static_cast<const int*>(op_at), static_cast<int*>(seqs), static_cast<int*>(fail));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lz4t_rows_literals(const void* comps, long long comp_stride,
                                  int out_cap, int nrows, int nchunks,
                                  const void* sbase, const void* pbase,
                                  const void* seqs, const void* nseq,
                                  const void* total, const void* fail,
                                  void* out, void* ptr, void* lens, void* errs,
                                  void* stream) {
  rows_literals<<<dim3(nrows, chunks(nchunks)), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comps), comp_stride, out_cap,
      static_cast<const long long*>(sbase), static_cast<const long long*>(pbase),
      static_cast<const int*>(seqs), static_cast<const int*>(nseq),
      static_cast<const int*>(total), static_cast<const int*>(fail),
      static_cast<uint8_t*>(out), static_cast<int*>(ptr), static_cast<int*>(lens),
      static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lz4t_rows_resolve(const void* pbase, const void* lens, void* ptr,
                                 int out_cap, const void* dicts, void* out,
                                 void* flags, int rounds, int nrows, int nchunks,
                                 void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* pb = static_cast<const long long*>(pbase);
  const auto* ln = static_cast<const int*>(lens);
  for (int r = 0; r < rounds; ++r) {
    rows_jump<<<dim3(nrows, chunks(nchunks)), 256, 0, s>>>(pb, ln, static_cast<int*>(ptr),
                                                  static_cast<int*>(flags), r);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc) return rc;
  }
  rows_gather<<<dim3(nrows, chunks(nchunks)), 256, 0, s>>>(
      pb, ln, static_cast<const int*>(ptr), out_cap,
      static_cast<const uint8_t*>(dicts), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lz4t_decode_warp(const void* comps, long long comp_stride,
                                const void* comp_lens, void* out, int out_cap,
                                const void* dicts, const void* dict_lens,
                                const void* limits, void* lens, void* errs,
                                int nrows, void* stream) {
  decode_rows<<<nrows, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(comps), comp_stride,
      static_cast<const int*>(comp_lens), static_cast<uint8_t*>(out), out_cap,
      static_cast<const uint8_t*>(dicts), static_cast<const int*>(dict_lens),
      static_cast<const int*>(limits), static_cast<int*>(lens),
      static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
}
