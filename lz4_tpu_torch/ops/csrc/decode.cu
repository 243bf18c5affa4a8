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
//      decode_rows' structural checks) into its successor, then pointer
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
// Batches of rows of at most 64 KB (out_cap), and large batches of rows of
// up to 256 KB, take the one-warp route instead (`decode_rows`, below: a
// parse warp and a copy warp per row), and so do rows with an output limit
// at any size; the rule and the times it rests on: ops/decode.py `route`.

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
// remains (read_vle), the run's end read from nn.
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

// ---- the one-warp route: `decode_rows` -------------------------------
//
// One CTA of two warps per row, rows of any out_cap (above kSharedOut only
// for the callers that ask for this route: rows with limits and the route
// holds).  What bounds it: one row's chain of dependent steps, a sequence's
// token, lengths and offset read before the next token's position is known
// (the bytes, a few tens of microseconds a batch, are far below).  The
// design keeps the chain short and runs the copies beside it:
//   - warp 0, the parse, over a ring of the row's compressed bytes in
//     shared memory (`Ring`: kStages stages of 512 bytes, each lane's
//     16-byte aligned chunk copied by cp.async, a stage refilled as soon as
//     the parse has left the stage kStages before it, so that the copies
//     run ahead of the parse).  A window step parses the sequences that
//     start in 32 bytes at once, one candidate a lane, the chain from the
//     window's start found by doubling and the output positions by a scan,
//     while they are common (length extensions of at most one byte, inside
//     the 64 bytes held, every check passed); any other sequence takes the
//     serial parse, every lane walking it (the reads are broadcasts).  The
//     literal runs go into place (from the ring, or from the row itself
//     when a run is longer than the ring holds); each match (destination,
//     offset, length, its literal run's length) is queued in shared
//     memory, batches of kBatch in kSlots slots, handed over with named
//     barriers;
//   - warp 1, the copies: the matches of a batch that read only bytes
//     final before the batch (below its first match, or in their own
//     literal run), one lane each side by side, then the rest in order,
//     each by the whole warp: byte i of a match at d from byte (i mod off)
//     of the off bytes before d, an index each lane advances (by 32, or
//     below 32 by 32 mod off from a small table, less off when it passes
//     off): no byte of a match waits for another, and no byte pays a
//     division;
//   - the output in shared memory for out_cap <= kSharedOut (a match reads
//     back at shared-memory latency; three CTAs an SM at 64 KB), written
//     out with 16-byte stores of [0, produced) at the end; above, in the
//     output row itself;
//   - a dictionary row read through L1.
// A failing sequence leaves nothing past the bytes before it: its literals
// are copied only after every check, as the plain version orders them.
// `limits` (may be null) gives each row an output limit, -1 for none: a
// partial decode, which stops at the first literal or match byte that
// brings the output to the limit, parsing nothing after it; before it every
// check holds, the literal run's input check and the match's offset checks
// included, and a match length whose extension runs out of input is
// malformed; the match's capacity check does not apply to the match that
// reaches the limit.  A limit above out_cap stops nothing: a sequence that
// would write past out_cap is malformed, as without a limit.  Returns (lens, errs): the bytes produced (up to the
// failing sequence on error) and 0, 1 (malformed) or 2 (trailing bytes).
// On the H100 (PERF.md §6): 0.86 ms for one 64 KB text row against the
// one-warp kernel before it's 3.11, 2.20 ms for 1,024 rows against 3.96.

constexpr int kRouteThreads = 64;   // the parse warp and the copy warp
constexpr int kStage = 512;         // bytes a stage: a 16-byte chunk a lane
constexpr int kStages = 16;         // stages of the ring
constexpr int kRing = kStage * kStages;
constexpr int kHold = kRing - kStage;  // the most a read lies past what it keeps
constexpr int kBatch = 32;          // queued matches a handover
constexpr int kSlots = 2;           // handovers in flight
constexpr int kDone = 64;           // a slot's count flag: the last batch
constexpr int kAloneMatch = 64;     // the longest match one lane copies
constexpr int kSharedOut = 65536;   // out_cap up to this: output in shared memory
constexpr int kQueueBytes = kSlots * kBatch * 16;
constexpr int kModBytes = 32 * 32;  // `copy_match`'s lane table
// the queue, the slot counts and the result, the lane table: three CTAs an
// SM at out_cap 64 KB
constexpr int kHeadBytes = kQueueBytes + 32 + kModBytes;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barriers of the two warps (barrier 0 is __syncthreads): a slot's
// "full" barrier 1 + slot, its "empty" barrier 1 + kSlots + slot.
__device__ __forceinline__ void bar_sync(int id) {
  __syncwarp();  // the warp arrives converged
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kRouteThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  __syncwarp();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kRouteThreads) : "memory");
}

// The ring of one row's compressed bytes, run by the parse warp (every
// lane keeps the same state).  Row position p lies in stage
// (p + lead) / kStage, at ring byte (p + lead) mod kRing; stage s takes
// slot s mod kStages, so stages [issued - kStages, issued) are held, and
// those below `landed` have landed.  A slot is refilled only once the
// stage it held has landed: two copies in flight into one slot may land in
// either order.
struct Ring {
  const uint8_t* gal;  // the aligned 16-byte chunk holding the row's byte 0
  uint8_t* buf;
  int lead, chunks, stages, issued, landed, ready_end, refill_at, lane;

  __device__ void init(const uint8_t* src, int clen, uint8_t* b, int l) {
    lead = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
    gal = src - lead;
    buf = b;
    lane = l;
    chunks = (lead + (clen > 0 ? clen : 0) + 15) >> 4;
    stages = (chunks + 31) >> 5;
    issued = 0;
    landed = 0;
    ready_end = 0;  // positions below it have landed
    refill_at = 0;  // a read keeping positions from here frees a slot
  }

  __device__ __forceinline__ int at(int p) const { return buf[(p + lead) & (kRing - 1)]; }

  // The first position whose stage is still held.
  __device__ __forceinline__ int held_from() const { return (issued - kStages) * kStage - lead; }

  // Issue every stage whose slot holds only positions below `keep`.
  __device__ void top_up(int keep) {
    __syncwarp();  // every lane is done with the slots refilled here
    const int lim = min(stages, ((keep + lead) >> 9) + kStages);
    if (lim - kStages > landed) {
      // a slot to refill has a copy in flight (the parse went past it
      // without reading it): let every copy land first, and skip the
      // stages wholly below `keep`, which nothing reads
      cp_async_wait<0>();
      issued = max(issued, lim - kStages);
      landed = issued;
    }
#pragma unroll 1
    for (; issued < lim; ++issued) {
      const int c = (issued << 5) + lane;
      if (c < chunks)
        cp_async16(buf + ((issued & (kStages - 1)) << 9) + (lane << 4),
                   gal + (static_cast<long long>(c) << 4));
      cp_async_commit();
    }
    refill_at = issued < stages ? ((issued - kStages + 1) << 9) - lead : INT_MAX;
  }

  // Wait for the stage holding p1 - 1, leaving the later ones in flight.
  __device__ void settle(int p1) {
    const int pend = issued - (((p1 - 1 + lead) >> 9) + 1);
    int left = 0;
    if (pend >= 8) {
      cp_async_wait<8>();
      left = 8;
    } else if (pend >= 4) {
      cp_async_wait<4>();
      left = 4;
    } else if (pend >= 2) {
      cp_async_wait<2>();
      left = 2;
    } else if (pend >= 1) {
      cp_async_wait<1>();
      left = 1;
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's chunks are visible to every lane
    landed = issued - left;
    ready_end = landed >= stages ? INT_MAX : (landed << 9) - lead;
  }

  // Positions [.., p1) readable, keeping those at and past `keep`
  // (p1 - keep <= kHold).
  __device__ __forceinline__ void need(int keep, int p1) {
    if (keep >= refill_at) top_up(keep);
    if (p1 > ready_end) settle(p1);
  }
};

// A length extension at q (read_vle through the ring), keeping positions
// from `hold`; *last gets the last byte read (255 when none was).
__device__ __forceinline__ long long ring_vle(Ring& r, int hold, int& q, int clen, int* last) {
  long long v = 0;
  int b = 255;
  while (b == 255 && q < clen) {
    r.need(max(hold, q + 1 - kHold), q + 1);
    b = r.at(q++);
    v += b;
  }
  *last = b;
  return v;
}

// n literal bytes from row position `from` to dst, by the parse warp: from
// the ring while it still holds them, else from the row itself.
__device__ __forceinline__ void copy_literals(Ring& r, const uint8_t* __restrict__ src,
                                              int from, int n, uint8_t* dst) {
  if (n <= 0) return;
  if (from >= r.held_from()) {
    for (int a = from; a < from + n;) {
      const int b = min(from + n, a + kHold);
      r.need(a, b);
      for (int i = a + r.lane; i < b; i += 32) dst[i - from] = static_cast<uint8_t>(r.at(i));
      a = b;
    }
  } else {
    for (int i = r.lane; i < n; i += 32) dst[i] = __ldg(src + from + i);
  }
}

// One queued match by the copy warp: m bytes at d, byte i from byte
// (i mod off) before d (negative: the dictionary, dend[s]).  Each lane
// advances its index j = i mod off without a division: by 32 when off >= 32
// (j starts at the lane), else by 32 mod off from lane mod off (`mods`: row
// off holds lane mod off for each lane, row 0 at column off 32 mod off),
// less off when it passes off.  A match of at most 32 bytes is one step of
// the lanes, each below off reading its own index.
__device__ __forceinline__ void copy_match(uint8_t* obuf, const uint8_t* dend,
                                           const uint8_t* mods, int d, int off, int m, int lane) {
  const int base = d - off;
  if (m <= 32) {
    if (lane < m) {
      const int j = lane < off ? lane : mods[(off << 5) + lane];
      const int s = base + j;
      obuf[d + lane] = s >= 0 ? obuf[s] : dend[s];
    }
  } else {
    int j = off >= 32 ? lane : mods[(off << 5) + lane];
    const int step = off >= 32 ? 32 : mods[off];
    for (int i = lane; i < m; i += 32) {
      const int s = base + j;
      obuf[d + i] = s >= 0 ? obuf[s] : dend[s];
      j += step;
      if (j >= off) j -= off;
    }
  }
  __syncwarp();  // the next match may read these bytes
}

// One queued match by one lane, byte after byte: byte i from byte
// j = i mod off before d, j advanced a byte at a time.
__device__ __forceinline__ void copy_alone(uint8_t* obuf, const uint8_t* dend, int d, int off,
                                           int m) {
  const int base = d - off;
  for (int i = 0, j = 0; i < m; ++i) {
    const int s = base + j;
    obuf[d + i] = s >= 0 ? obuf[s] : dend[s];
    if (++j == off) j = 0;
  }
}

// The parse warp of one row: the serial parse and checks of the plain
// version (ops/decode.py `_decode_row`), the literal runs copied, the
// matches queued, lens and errs written.
__device__ void parse_row(const uint8_t* __restrict__ src, int clen, uint8_t* obuf, int out_cap,
                          int dlen, int limit, uint8_t* ring, int4* queue, int* qcnt, int* res,
                          int* lens, int* errs, int row) {
  const int lane = threadIdx.x & 31;
  Ring r;
  r.init(src, clen, ring, lane);
  int ip = 0, op = 0, err = 0, batch = 0, k = 0, last_b = 0;
  bool stopped = false;  // reached `limit`
  // The queue: a match (destination, offset, length, its literal run's
  // length) at entry k of the batch being filled; a full batch of kBatch is
  // handed over.  `open_slot` before writing entry 0 of a slot.
  auto open_slot = [&]() {
    if (k == 0 && batch >= kSlots) bar_sync(1 + kSlots + (batch & (kSlots - 1)));
  };
  auto hand_over = [&]() {
    if (lane == 0) qcnt[batch & (kSlots - 1)] = kBatch;
    __threadfence_block();
    bar_arrive(1 + (batch & (kSlots - 1)));
    ++batch;
    k = 0;
  };
  auto push = [&](int d, int off, int m, int lits) {
    open_slot();
    if (lane == 0) queue[(batch & (kSlots - 1)) * kBatch + k] = make_int4(d, off, m, lits);
    if (++k == kBatch) hand_over();
  };
  for (;;) {
    // The window step: the sequences that start in the 32 bytes at ip,
    // parsed by the lanes at once while every one is common (length
    // extensions of at most one byte, the sequence inside the 64 bytes at
    // ip, every check passed, short of any limit; with 64 bytes landed and
    // inside the row none is the last).  Lane l holds bytes
    // ip + l and ip + 32 + l and takes the sequence that would start at
    // ip + l; the chain from ip is found by doubling (4 rounds: a chain of
    // sequences of 3 bytes or more crosses 32 bytes in at most 11), the
    // output positions by a scan, and each literal byte goes to its place
    // from the lane that holds it.  Any other sequence is parsed below.
    while (ip < r.refill_at && ip + 64 <= min(r.ready_end, clen)) {
      const int lo = r.at(ip + lane), hi = r.at(ip + 32 + lane);
      const int w = lo | (hi << 8);
      const int mc = lo & 15;
      // a literal length of 15 and one more byte: the run starts a byte later
      const int u = __shfl_sync(kAll, w, (lane + 1) & 31);
      const int lx = lo >> 4 == 15 ? 1 : 0;
      const int lext = lx ? (lane + 1 < 32 ? u & 255 : u >> 8) : 0;
      const int ll = (lo >> 4) + lext;
      const int ls = lane + 1 + lx;  // the literal run's position
      const int a = ls + ll;         // the offset's position, then its extension's
      const int v0 = __shfl_sync(kAll, w, a & 31), v1 = __shfl_sync(kAll, w, (a + 1) & 31);
      const int v2 = __shfl_sync(kAll, w, (a + 2) & 31);
      const int off = (a < 32 ? v0 & 255 : v0 >> 8) | ((a + 1 < 32 ? v1 & 255 : v1 >> 8) << 8);
      const int ext = mc == 15 ? (a + 2 < 32 ? v2 & 255 : v2 >> 8) : 0;
      const int ml = mc + kMinMatch + ext;
      const int c = ll + ml;                      // the bytes the sequence decodes to
      const int nx = a + 2 + (mc == 15 ? 1 : 0);  // the next token's position
      const bool plain = lext != 255 && ext != 255 && nx <= 64;
      unsigned path = plain ? 1u << lane : 0u;  // the positions from here on
      int succ = plain && nx < 32 ? nx : 32;    // 32: past the window, or stopped
#pragma unroll
      for (int round = 0; round < 4; ++round) {
        const unsigned p2 = __shfl_sync(kAll, path, succ & 31);
        const int s2 = __shfl_sync(kAll, succ, succ & 31);
        if (succ < 32) {
          path |= p2;
          succ = s2;
        }
      }
      const unsigned chain = __shfl_sync(kAll, path, 0);
      const bool member = (chain >> lane) & 1u;
      int before = member ? c : 0;  // exclusive scan of the members' bytes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kAll, before, d);
        if (lane >= d) before += t;
      }
      const int at_op = op + before - (member ? c : 0);
      const bool bad = off == 0 || off - ll - dlen > at_op || out_cap - at_op < c ||
                       (limit >= 0 && limit - at_op <= c);
      const unsigned fail = __ballot_sync(kAll, member && bad);
      unsigned take = fail ? chain & ((1u << (__ffs(fail) - 1)) - 1) : chain;
      // no more than the batch has room for
      take = __ballot_sync(kAll, ((take >> lane) & 1u) &&
                                     __popc(take & ((1u << lane) - 1)) < kBatch - k);
      if (!take) break;
      const int last = 31 - __clz(take);
      const int step = take == chain ? __shfl_sync(kAll, nx, last) : __ffs(chain & ~take) - 1;
      const int op_end = __shfl_sync(kAll, at_op + c, last);
      // the literal bytes: position lane and lane + 32, each from the lane
      // holding it, to the last taken sequence that starts before it
      for (int half = 0; half < 2; ++half) {
        const int pos = lane + 32 * half;
        const unsigned below = half ? take : take & ((1u << lane) - 1);
        const int owner = below ? 31 - __clz(below) : 0;
        const int own_ll = __shfl_sync(kAll, ll, owner);
        const int own_ls = __shfl_sync(kAll, ls, owner);
        const int own_op = __shfl_sync(kAll, at_op, owner);
        if (below && pos >= own_ls && pos < own_ls + own_ll)
          obuf[own_op + pos - own_ls] = static_cast<uint8_t>(half ? hi : lo);
      }
      open_slot();
      if ((take >> lane) & 1u)
        queue[(batch & (kSlots - 1)) * kBatch + k + __popc(take & ((1u << lane) - 1))] =
            make_int4(at_op + ll, off, ml, ll);
      k += __popc(take);
      if (k == kBatch) hand_over();
      ip += step;
      op = op_end;
    }
    if (ip >= clen) {
      err = 1;
      break;
    }
    r.need(ip, ip + 1);
    const int token = r.at(ip);
    int q = ip + 1;
    long long ll = token >> 4;
    if (ll == 15) ll += ring_vle(r, ip, q, clen, &last_b);
    if (q + ll > clen) {
      err = 1;
      break;
    }
    if (limit >= 0 && limit <= out_cap && op + ll >= limit) {  // the run reaches the limit
      copy_literals(r, src, q, limit - op, obuf + op);
      op = limit;
      stopped = true;
      break;
    }
    if (op + ll > out_cap) {
      err = 1;
      break;
    }
    const int lit_at = q;
    const int nlit = static_cast<int>(ll);
    q += nlit;
    if (q >= clen) {  // the last sequence: literals only
      copy_literals(r, src, lit_at, nlit, obuf + op);
      op += nlit;
      ip = q;
      break;
    }
    if (q + 2 > clen) {
      err = 1;
      break;
    }
    r.need(max(ip, q + 2 - kHold), q + 2);
    const int off = r.at(q) | (r.at(q + 1) << 8);
    q += 2;
    long long ml = (token & 15) + kMinMatch;
    if ((token & 15) == 15) {
      const int q0 = q;
      ml += ring_vle(r, ip, q, clen, &last_b);
      // an extension that runs out of input: no byte, or a last byte of 255
      if (limit >= 0 && (q == q0 || last_b == 255)) {
        err = 1;
        break;
      }
    }
    const bool last = limit >= 0 && limit <= out_cap && op + ll + ml >= limit;
    if (off == 0 || off > op + ll + dlen || (!last && op + ll + ml > out_cap)) {
      err = 1;
      break;
    }
    copy_literals(r, src, lit_at, nlit, obuf + op);
    op += nlit;
    const int m = last ? limit - op : static_cast<int>(ml);
    push(op, off, m, nlit);
    op += m;
    ip = q;
    if (last) {
      stopped = true;
      break;
    }
  }
  if (err == 0 && !stopped && ip != clen) err = 2;
  const int slot = batch & (kSlots - 1);
  if (k == 0 && batch >= kSlots) bar_sync(1 + kSlots + slot);
  if (lane == 0) {
    qcnt[slot] = k | kDone;
    res[0] = op;
    lens[row] = op;
    errs[row] = err;
  }
  __threadfence_block();
  bar_arrive(1 + slot);
  ++batch;
  // every slot handed over is released before the row is written out
  for (int b = max(0, batch - kSlots); b < batch; ++b) bar_sync(1 + kSlots + (b & (kSlots - 1)));
  cp_async_wait<0>();  // no copy into the ring outlives the CTA
}

// The copy warp of one row: every queued match in order.
__device__ void copy_row(uint8_t* obuf, const uint8_t* __restrict__ dict_row, uint8_t* mods,
                         const int4* queue, const int* qcnt) {
  const int lane = threadIdx.x & 31;
  const uint8_t* dend = dict_row ? dict_row + kDictCap : nullptr;
  for (int e = lane; e < kModBytes; e += 32) {  // `copy_match`'s lane table
    const int off = e >> 5, c = e & 31;
    mods[e] = off ? c % off : (c ? 32 % c : 0);
  }
  __syncwarp();
  for (int batch = 0;; ++batch) {
    const int slot = batch & (kSlots - 1);
    bar_sync(1 + slot);
    const int c = qcnt[slot];
    const int n = c & (kDone - 1);
    // Lane k takes match k of the batch.  A match that reads only bytes
    // final before any match of the batch is copied (below its first
    // destination, or from its own literal run) is copied by its lane
    // alone, beside the others; the rest follow in order, each by the
    // whole warp.
    const int4 e = queue[slot * kBatch + (lane < n ? lane : 0)];
    const int d = e.x, off = e.y, m = e.z;
    const int base = d - off;
    const int first = __shfl_sync(kAll, d, 0);
    const bool alone = lane < n && m <= kAloneMatch &&
                       (base + min(off, m) <= first || base >= d - e.w);
    if (alone) copy_alone(obuf, dend, d, off, m);
    __syncwarp();
    unsigned rest = __ballot_sync(kAll, lane < n && !alone);
    int k = rest ? __ffs(rest) - 1 : 0;
    int kd = __shfl_sync(kAll, d, k), koff = __shfl_sync(kAll, off, k), km = __shfl_sync(kAll, m, k);
    while (rest) {  // each match's parameters read while the one before copies
      rest &= rest - 1;
      k = rest ? __ffs(rest) - 1 : 0;
      const int nd = __shfl_sync(kAll, d, k), noff = __shfl_sync(kAll, off, k);
      const int nm = __shfl_sync(kAll, m, k);
      copy_match(obuf, dend, mods, kd, koff, km, lane);
      kd = nd;
      koff = noff;
      km = nm;
    }
    bar_arrive(1 + kSlots + slot);
    if (c & kDone) break;
  }
}

// kShared: the output in shared memory (out_cap <= kSharedOut).  Dynamic
// shared memory: `route_shared_bytes`.
template <bool kShared>
__global__ void __launch_bounds__(kRouteThreads) decode_rows(
    const uint8_t* __restrict__ comps, long long comp_stride,
    const int* __restrict__ comp_lens, uint8_t* out, int out_cap,
    const uint8_t* __restrict__ dicts, const int* __restrict__ dict_lens,
    const int* __restrict__ limits, int* __restrict__ lens,
    int* __restrict__ errs) {
  extern __shared__ __align__(16) uint8_t smem[];
  int4* queue = reinterpret_cast<int4*>(smem);
  int* qcnt = reinterpret_cast<int*>(smem + kQueueBytes);
  int* res = qcnt + kSlots;
  uint8_t* mods = smem + kQueueBytes + 32;
  uint8_t* ring = smem + kHeadBytes;
  uint8_t* obase = ring + kRing;
  const int row = blockIdx.x;
  uint8_t* gout = out + static_cast<long long>(row) * out_cap;
  // shared byte obase[a + j] holds output byte j: the 16-byte chunks of
  // shared memory and of the output row line up
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(gout) & 15);
  uint8_t* obuf = kShared ? obase + a : gout;
  const int dlen = dicts ? dict_lens[row] : 0;
  if (threadIdx.x < 32) {
    parse_row(comps + row * comp_stride, comp_lens[row], obuf, out_cap, dlen,
              limits ? limits[row] : -1, ring, queue, qcnt, res, lens, errs, row);
  } else {
    copy_row(obuf, dicts ? dicts + row * kDictCap : nullptr, mods, queue, qcnt);
  }
  if (!kShared) return;
  __syncthreads();
  const int produced = res[0];
  uint8_t* gal = gout - a;
  const int nch = (a + produced + 15) >> 4;
  for (int c = threadIdx.x; c < nch; c += kRouteThreads) {
    const int lo = (c << 4) - a;  // the output byte at the chunk's start
    if (lo >= 0 && lo + 16 <= produced) {
      *reinterpret_cast<uint4*>(gal + (c << 4)) = *reinterpret_cast<const uint4*>(obase + (c << 4));
    } else {
      for (int t = max(0, -lo); t < 16 && lo + t < produced; ++t) gout[lo + t] = obase[(c << 4) + t];
    }
  }
}

int route_shared_bytes(int out_cap) {
  return kHeadBytes + kRing + (out_cap <= kSharedOut ? ((out_cap + 15) & ~15) + 16 : 0);
}

template <bool kShared>
int launch_rows(const void* comps, long long comp_stride, const void* comp_lens, void* out,
                int out_cap, const void* dicts, const void* dict_lens, const void* limits,
                void* lens, void* errs, int nrows, cudaStream_t s) {
  const int bytes = route_shared_bytes(out_cap);
  auto* k = decode_rows<kShared>;
  // set on every launch: the attributes are the current device's
  cudaError_t rc = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess)  // as many CTAs an SM as the shared memory holds
    rc = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  k<<<nrows, kRouteThreads, bytes, s>>>(
      static_cast<const uint8_t*>(comps), comp_stride, static_cast<const int*>(comp_lens),
      static_cast<uint8_t*>(out), out_cap, static_cast<const uint8_t*>(dicts),
      static_cast<const int*>(dict_lens), static_cast<const int*>(limits),
      static_cast<int*>(lens), static_cast<int*>(errs));
  return static_cast<int>(cudaGetLastError());
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
  const auto s = static_cast<cudaStream_t>(stream);
  auto launch = out_cap <= kSharedOut ? launch_rows<true> : launch_rows<false>;
  return launch(comps, comp_stride, comp_lens, out, out_cap, dicts, dict_lens, limits, lens, errs,
                nrows, s);
}

// The one-warp route's dynamic shared memory a CTA, and the largest
// out_cap whose output it keeps in shared memory.
extern "C" int lz4t_decode_warp_shared(int out_cap) { return route_shared_bytes(out_cap); }

extern "C" int lz4t_decode_warp_shared_out() { return kSharedOut; }
