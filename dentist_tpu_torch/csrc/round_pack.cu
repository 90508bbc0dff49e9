// K4 and K4w: the result blocks of the consensus realign rounds.
//
// K4 replaces dentist_tpu/ops/consensus.py:_nw_round_packed_sparse (397)
// with _packbits_dev (372) and _scatter_events (381) as its sparse mode,
// and _nw_round_kernel (318) as its dense mode.  From K2p's per-lane
// fields on the card (sym, ins, jpath, spans, diffs, win, covered, the
// band centers) and the lane's 2-bit packed template it writes JAX's int32
// block bit for bit:
//   sparse (words _sparse_words(T, NWIN)): bytes [jpath 4-bit deltas over
//     the covered span, T/2 | u16 escapes of deltas > 14, 16 | divergence
//     bitmask vs the template, T/8 | 2-bit rank codes of the divergent
//     symbols, 3T/64 | insertion-boundary bitmask over T+32 columns,
//     T/8 + 4 | 12-bit insertion slot packs as u16, 3T/16], then the words
//     jp_base, s0, s1, diffs, covered, overflow and win;
//   dense: sym nibbles (T/2 bytes), ins16 (T+2 u16), jpath - center as
//     int16 (T+2), then spans, diffs, win, covered.
// K4w replaces _window_sparse_pack (1023) as its sparse mode (42 words,
// caps 32 / 24 / 4) and _window_dense_pack (914) as its dense mode (112
// words): the interior _ADV = 126 columns and 127 boundaries from loc0 on,
// cut from K2p's or K2r's fields, with the template read from the lane's
// packed row or, in resident mode, from the device store.
//
// What bounds it on the card: bytes.  A lane reads its dense fields once
// (about 10 bytes per template column) and writes a block of 1.2 (sparse)
// or 4.6 (dense) bytes per column; the arithmetic is a few integer ops
// per column.  At the main path's shapes (32-128 lanes of 2-8 k columns)
// the bytes take 0.3-2.5 us, below a launch's own floor, so what the
// design has to avoid is a chain of dependent loads.
//
// Design (K4): one CTA per lane, T/4 threads up to 1024, each holding
// kCols = 4 columns of a tile of blockDim * 4 columns; warp w owns a
// contiguous run of 128 of them, lane l column 32k + l of its run at
// step k, so every load is coalesced and every ballot word is 32 bits of
// JAX's little-endian bitmasks.  A thread loads its columns' fields once,
// all before any is used (sym, the template's 2-bit code, jpath with the
// next column's value from the neighbouring lane, a boundary's four ins
// bytes as one 32-bit word), forms the three event predicates
// (divergence, escape, insertion boundary) and keeps only their payloads.
// The per-warp event counts are scanned across the block in shared
// memory (one warp scans the warp totals), which gives each event JAX's
// cumsum - 1 slot; events at or past their cap are dropped.  Tiles past
// the first carry the three counts.  The lane's block is built in dynamic
// shared memory (zeroed there; the 2-bit codes of four slots share a byte
// and are OR-ed in with shared atomics) and written out with 16-byte
// stores.  No global atomics.  (8 columns a thread ran no faster at the
// main path's buckets and spilled under the 64 registers 1024 threads
// leave.)  A CTA's time grows with its threads (it issues ~100
// instructions per 32 columns), so where a launch leaves SMs idle (few
// lanes of 4 k columns and more) a lane is spread over a thread-block
// cluster of up to 8 CTAs, each one tile of T / CTAs columns: each CTA's
// carry is the lower ranks' totals, read through distributed shared
// memory, and the row is built in rank 0's shared memory, the others
// writing into it the same way.
// Dense mode is elementwise: each thread builds whole words of the row
// in shared memory (8 sym bytes, two boundaries' ins words, two jpath
// and center pairs), written out the same way.
//
// Design (K4w): kWLanes lanes per CTA, one warp each; a window is 128
// columns, so each thread holds 4 (column 32k + l).  The lane's loc0 (and
// in resident mode its store offset) is loaded first; the four columns'
// sym, jpath, ins words and template codes (centers, dense) then load
// with no further dependency.  The covered-column and valid-boundary
// ends come from the same register ballots as the events: one pass.
// The 168- or 448-byte row is built in shared memory and written with
// 16-byte stores where the row allows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include <cooperative_groups.h>

#include "pack2.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCapE = 16;                 // _CAP_E
constexpr int kAdv = 126;                 // _ADV
constexpr int kWCapS = 32, kWCapI = 24, kWCapE = 4;
constexpr int kWRowSparse = 42, kWRowDense = 112;
constexpr int kCols = 4;                  // K4: columns a thread holds
constexpr int kMaxThreads = 1024;         // K4: threads of a lane's CTA
constexpr int kMaxCluster = 8;            // K4 sparse: CTAs a lane at most
constexpr int kWLanes = 4;                // K4w: lanes (warps) a CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ unsigned lanes_below(int l) {
  return (1u << l) - 1u;
}

// the 12-bit slot pack of a boundary from its four int8 slots, loaded as
// one little-endian word: s0 | s1 << 3 | s2 << 6 | s3 << 9, each slot
// widened as JAX's astype(uint16), the sum cut to 16 bits
__device__ __forceinline__ int ins16_of(unsigned w) {
  const unsigned s0 = (uint16_t)(int8_t)(w & 0xFF);
  const unsigned s1 = (uint16_t)(int8_t)((w >> 8) & 0xFF);
  const unsigned s2 = (uint16_t)(int8_t)((w >> 16) & 0xFF);
  const unsigned s3 = (uint16_t)(int8_t)(w >> 24);
  return (int)((s0 | (s1 << 3) | (s2 << 6) | (s3 << 9)) & 0xFFFF);
}

// OR a 2-bit code (JAX: the slot's u8 code shifted into its byte, the
// byte truncated to 8 bits) into code byte idx of the shared region at
// `words`
__device__ __forceinline__ void or_code(int* words, int idx, int code) {
  const int byte_val = ((code & 0xFF) << (2 * (idx & 3))) & 0xFF;
  atomicOr(words + (idx >> 4), byte_val << (8 * ((idx >> 2) & 3)));
}

// the row staged at `s` (shared) to `g` (4-byte aligned): single words
// up to g's first 16-byte boundary, then 16-byte stores, then the tail
__device__ __forceinline__ void store_row(const int* s, int* g, int words,
                                          int tid, int nt) {
  int head = (int)(((16 - ((uintptr_t)g & 15)) & 15) >> 2);
  head = head < words ? head : words;
  const int body = (words - head) >> 2;
  for (int i = tid; i < head; i += nt) g[i] = s[i];
  int4* g4 = reinterpret_cast<int4*>(g + head);
  for (int i = tid; i < body; i += nt) {
    const int* p = s + head + 4 * i;
    g4[i] = make_int4(p[0], p[1], p[2], p[3]);
  }
  for (int i = head + 4 * body + tid; i < words; i += nt) g[i] = s[i];
}

// The lane's row (words ints, rounded up to 16 bytes), then the per-warp
// counts part[3][32] and the block's totals[3], in dynamic shared memory.
// kCluster: a lane spread over a cluster of CTAs, each taking T / CTAs
// columns as one tile; the row is built in rank 0's shared memory, the
// other CTAs writing into it through distributed shared memory, and each
// CTA's carry is the lower ranks' totals.
template <int C, bool kCluster>
__global__ void __launch_bounds__(kMaxThreads) round_pack_sparse_kernel(
    const uint8_t* __restrict__ chars, const int8_t* __restrict__ sym,
    const unsigned* __restrict__ ins, const int* __restrict__ jpath,
    const int* __restrict__ spans, const int* __restrict__ diffs,
    const int* __restrict__ win, const bool* __restrict__ covered,
    int* __restrict__ out, int T, int RL, int NWIN, int words) {
  extern __shared__ int4 smem4[];
  int* row = reinterpret_cast<int*>(smem4);
  int* part = row + ((words + 3) & ~3);  // per-warp counts, then their scan
  int* total = part + 3 * 32;
  unsigned rank = 0, ctas = 1;
  int* row0 = row;  // where the row is built
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = cluster.block_rank();
    ctas = cluster.dim_blocks().x;
    row0 = cluster.map_shared_rank(row, 0);
  }
  uint8_t* rowb = reinterpret_cast<uint8_t*>(row0);
  const int n = blockIdx.x / ctas, tid = threadIdx.x, nt = blockDim.x;
  const int w = tid >> 5, l = tid & 31, nw = nt >> 5;
  const int c_lo = rank * (T / ctas), c_hi = c_lo + T / ctas;
  const unsigned below = lanes_below(l);
  const int8_t* sy = sym + (size_t)n * T;
  const unsigned* in = ins + (size_t)n * (T + 1);
  const int* jp = jpath + (size_t)n * (T + 1);
  const uint8_t* tp = chars + (size_t)n * ((2 * T + RL) / 4);
  const int s0 = spans[2 * n], s1 = spans[2 * n + 1];
  const bool cov = covered[n];
  const int lo = cov ? s0 : 0, hi = cov ? s1 : 0;  // the covered span
  // the block's tail, loaded early: boundary T, jp_base, diffs, win
  unsigned in_T = 0;
  int jp_base = 0, diff = 0;
  if (tid == 0 && rank == 0) {
    in_T = in[T];
    jp_base = jp[clampi(s0, 0, T)];
    diff = diffs[n];
  }
  const int win0 = tid < NWIN && rank == 0 ? win[(size_t)n * NWIN + tid] : 0;

  const int cap_s = 3 * T / 16, cap_i = 3 * T / 16;
  const int off_esc = T / 2;
  const int off_sm = off_esc + 2 * kCapE;
  const int off_sc = off_sm + T / 8;
  const int off_im = off_sc + 3 * T / 64;
  const int off_iv = off_im + T / 8 + 4;
  const int nbytes = off_iv + 2 * cap_i;
  uint16_t* esc16 = reinterpret_cast<uint16_t*>(rowb + off_esc);
  uint16_t* ins16 = reinterpret_cast<uint16_t*>(rowb + off_iv);
  if (rank == 0)
    for (int i = tid; i < words; i += nt) row[i] = 0;
  if constexpr (kCluster)
    cg::this_cluster().sync();  // the row is zeroed before any CTA writes
  else
    __syncthreads();

  int carry_s = 0, carry_e = 0, carry_i = 0;  // events before this tile
  int all_s = 0, all_e = 0, all_i = 0;        // the cluster's totals
  for (int t0 = c_lo; t0 < c_hi; t0 += nt * C) {
    const int wb = t0 + w * 32 * C;  // the warp's first column
    const int steps = wb < c_hi ? min(C, (c_hi - wb) >> 5) : 0;
    // the fields of the thread's columns, each loaded once
    int sv[C], tv[C], jv[C];
    unsigned iw[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int c = wb + 32 * k + l;
      const bool ok = k < steps;
      sv[k] = ok ? sy[c] : 0;
      tv[k] = ok ? code2(tp, c) : 0;
      jv[k] = ok ? jp[c] : 0;
      iw[k] = ok ? in[c] : 0u;
    }
    // jpath at the column after the warp's last step (lane 31 needs it)
    const int jend = (l == 31 && steps > 0) ? jp[wb + 32 * steps] : 0;

    // the events and their payloads; the nibbles and bitmask words
    int code[C];
    unsigned pay[C];  // ins16 | escape << 16
    int cs = 0, ce = 0, ci = 0;
#pragma unroll
    for (int k = 0; k < C; ++k) {
      code[k] = 0;
      pay[k] = 0;
      if (k >= steps) continue;  // warp-uniform
      const int c = wb + 32 * k + l;
      const bool in_span = c >= lo && c < hi;
      const bool ev = in_span && sv[k] != tv[k];
      int jn = __shfl_down_sync(kFull, jv[k], 1);
      int first_next = jend;
      if (k + 1 < C) {
        const int f = __shfl_sync(kFull, jv[k + 1], 0);
        if (k + 1 < steps) first_next = f;
      }
      if (l == 31) jn = first_next;
      const int d = in_span ? jn - jv[k] : 0;
      const bool esc = d > 14;
      const int nib = esc ? 15 : d;
      const int nib_hi = __shfl_down_sync(kFull, nib, 1);
      if (!(l & 1)) rowb[c >> 1] = (uint8_t)(nib | (nib_hi << 4));
      const int v = ins16_of(iw[k]);
      const unsigned ms = __ballot_sync(kFull, ev);
      const unsigned me = __ballot_sync(kFull, esc);
      const unsigned mi = __ballot_sync(kFull, v != 0);
      if (l == 0) {
        row0[off_sm / 4 + (c >> 5)] = (int)ms;
        row0[off_im / 4 + (c >> 5)] = (int)mi;
      }
      cs += __popc(ms);
      ce += __popc(me);
      ci += __popc(mi);
      code[k] = ((sv[k] - (sv[k] > tv[k])) & 0xFF) | (ev ? 0x100 : 0);
      pay[k] = (unsigned)v | (esc ? (unsigned)clampi(d, 0, 65535) << 16 : 0u);
    }

    // the block-wide exclusive scan of the warps' three counts
    if (l == 0) {
      part[w] = cs;
      part[32 + w] = ce;
      part[64 + w] = ci;
    }
    __syncthreads();
    if (w == 0) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int x = l < nw ? part[32 * j + l] : 0;
        int s = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, s, o);
          if (l >= o) s += y;
        }
        if (l < nw) part[32 * j + l] = s - x;
        if (l == 31) total[j] = s;
      }
    }
    if constexpr (kCluster) {
      // every CTA's totals: the lower ranks' are this one's carry
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      for (unsigned q = 0; q < ctas; ++q) {
        const int* tq = cluster.map_shared_rank(total, q);
        const int a = tq[0], b = tq[1], c = tq[2];
        if (q < rank) {
          carry_s += a;
          carry_e += b;
          carry_i += c;
        }
        all_s += a;
        all_e += b;
        all_i += c;
      }
    } else {
      __syncthreads();
    }

    // each event to its slot: JAX's cumsum - 1, dropped at the cap
    int rs = carry_s + part[w], re = carry_e + part[32 + w];
    int ri = carry_i + part[64 + w];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (k >= steps) continue;
      const bool ev = code[k] & 0x100;
      const int v = pay[k] & 0xFFFF, e = pay[k] >> 16;
      const unsigned ms = __ballot_sync(kFull, ev);
      const unsigned me = __ballot_sync(kFull, e != 0);
      const unsigned mi = __ballot_sync(kFull, v != 0);
      const int idx = rs + __popc(ms & below);
      if (ev && idx < cap_s) or_code(row0 + off_sc / 4, idx, code[k]);
      const int eidx = re + __popc(me & below);
      if (e && eidx < kCapE) esc16[eidx] = (uint16_t)e;
      const int iidx = ri + __popc(mi & below);
      if (v && iidx < cap_i) ins16[iidx] = (uint16_t)v;
      rs += __popc(ms);
      re += __popc(me);
      ri += __popc(mi);
    }
    if constexpr (!kCluster) {
      carry_s += total[0];
      carry_e += total[1];
      carry_i += total[2];
      __syncthreads();  // the next tile rewrites part and total
    }
  }
  if constexpr (kCluster) {
    // every CTA's writes are in rank 0's row; no CTA reads another's
    // shared memory after this
    cg::this_cluster().sync();
    if (rank != 0) return;
    carry_s = all_s;
    carry_e = all_e;
    carry_i = all_i;
  }

  int* misc = row + nbytes / 4;
  if (tid == 0) {
    // boundary T, the last in column order; its mask bit opens the word
    // past the T columns' (the bitmask runs over T + 32 columns)
    const int v = ins16_of(in_T);
    if (v) {
      if (carry_i < cap_i) reinterpret_cast<uint16_t*>(
          reinterpret_cast<uint8_t*>(row) + off_iv)[carry_i] = (uint16_t)v;
      row[off_im / 4 + T / 32] = 1;
      ++carry_i;
    }
    misc[0] = jp_base;
    misc[1] = s0;
    misc[2] = s1;
    misc[3] = diff;
    misc[4] = cov;
    misc[5] = carry_s > cap_s || carry_i > cap_i || carry_e > kCapE;
  }
  if (tid < NWIN) misc[6 + tid] = win0;
  for (int k = tid + nt; k < NWIN; k += nt)
    misc[6 + k] = win[(size_t)n * NWIN + k];
  __syncthreads();
  store_row(row, out + (size_t)n * words, words, tid, nt);
}

// two sym bytes of a little-endian word, from bit 16p on, as one nibble
// byte: ((s[2i] & 0xFF) << 4 | (s[2i + 1] & 0xFF)) & 0xFF
__device__ __forceinline__ unsigned sym_pair(unsigned x, int p) {
  return ((((x >> (16 * p)) & 0xFF) << 4) | ((x >> (16 * p + 8)) & 0xFF)) &
         0xFF;
}

__global__ void __launch_bounds__(kMaxThreads) round_pack_dense_kernel(
    const int8_t* __restrict__ sym, const unsigned* __restrict__ ins,
    const int* __restrict__ jpath, const int* __restrict__ spans,
    const int* __restrict__ diffs, const int* __restrict__ win,
    const bool* __restrict__ covered, const int* __restrict__ centers,
    int* __restrict__ out, int T, int NWIN, int words) {
  extern __shared__ int4 smem4[];
  int* row = reinterpret_cast<int*>(smem4);
  const int n = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  // a sym row starts at n * T bytes, T a multiple of 256: 8-byte aligned
  const uint2* sy = reinterpret_cast<const uint2*>(sym + (size_t)n * T);
  const unsigned* in = ins + (size_t)n * (T + 1);
  const int* jp = jpath + (size_t)n * (T + 1);
  const int* cen = centers + (size_t)n * (T + 1);
  const int nsym = T / 8, nhalf = (T + 2) / 2;
  for (int i = tid; i < nsym; i += nt) {
    const uint2 s = sy[i];
    row[i] = (int)(sym_pair(s.x, 0) | (sym_pair(s.x, 1) << 8) |
                   (sym_pair(s.y, 0) << 16) | (sym_pair(s.y, 1) << 24));
  }
  for (int j = tid; j < nhalf; j += nt) {
    const int b = 2 * j;
    const unsigned i0 = b <= T ? (unsigned)ins16_of(in[b]) : 0u;
    const unsigned i1 = b + 1 <= T ? (unsigned)ins16_of(in[b + 1]) : 0u;
    row[nsym + j] = (int)(i0 | (i1 << 16));
    unsigned r0 = 0x8000u, r1 = 0x8000u;
    if (b <= T) {
      const int x = jp[b];
      if (x >= 0) r0 = (unsigned)(x - cen[b]) & 0xFFFF;
    }
    if (b + 1 <= T) {
      const int x = jp[b + 1];
      if (x >= 0) r1 = (unsigned)(x - cen[b + 1]) & 0xFFFF;
    }
    row[nsym + nhalf + j] = (int)(r0 | (r1 << 16));
  }
  int* tail = row + nsym + 2 * nhalf;
  if (tid == 0) {
    tail[0] = spans[2 * n];
    tail[1] = spans[2 * n + 1];
    tail[2] = diffs[n];
    tail[3 + NWIN] = covered[n];
  }
  for (int k = tid; k < NWIN; k += nt) tail[3 + k] = win[(size_t)n * NWIN + k];
  __syncthreads();
  store_row(row, out + (size_t)n * words, words, tid, nt);
}

// the first and last set positions over a run of ballot words
struct Ends {
  int first = -1, last = -1;
  __device__ void add(unsigned m, int base) {
    if (!m) return;
    if (first < 0) first = base + __ffs(m) - 1;
    last = base + 31 - __clz(m);
  }
};

template <bool kSparse, bool kResident>
__global__ void __launch_bounds__(32 * kWLanes) window_pack_kernel(
    const uint8_t* __restrict__ tsrc, const int* __restrict__ meta,
    const int8_t* __restrict__ sym, const unsigned* __restrict__ ins,
    const int* __restrict__ jpath, const int* __restrict__ centers,
    int* __restrict__ out, int store_len, int N, int T, int RL) {
  constexpr int kWords = kSparse ? kWRowSparse : kWRowDense;
  __shared__ int rows[kWLanes][kWords];
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int n = blockIdx.x * kWLanes + w;
  if (n >= N) return;  // whole warps: no block barrier below
  int* row = rows[w];
  uint8_t* rowb = reinterpret_cast<uint8_t*>(row);

  // the lane's coordinates first; its columns then load with no
  // further dependency
  const int loc0 = meta[(kResident ? 2 : 3) * N + n];
  int tl = 0;
  const uint8_t* tpl = nullptr;
  if constexpr (kSparse) {
    if constexpr (kResident) {
      tl = meta[n];
      tpl = tsrc + clampi(meta[3 * N + n], 0, store_len - T);
    } else {
      tpl = tsrc + (size_t)n * ((2 * T + RL) / 4);
    }
  }
  const int8_t* sy = sym + (size_t)n * T + loc0;
  const unsigned* in = ins + (size_t)n * (T + 1) + loc0;
  const int* jp = jpath + (size_t)n * (T + 1) + loc0;
  const int* cen = centers + (size_t)n * (T + 1) + loc0;
  int sv[4], jv[4], xv[4];  // xv: the template code (sparse), center (dense)
  unsigned iw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = 32 * k + l;
    sv[k] = c < kAdv ? sy[c] : 5;
    jv[k] = c <= kAdv ? jp[c] : -1;
    iw[k] = c <= kAdv ? in[c] : 0u;
    if constexpr (kSparse) {
      const int col = loc0 + c;
      if constexpr (kResident)
        xv[k] = c < kAdv && col < tl ? (tpl[col] & 3) : 0;
      else
        xv[k] = c < kAdv ? code2(tpl, col) : 0;
    } else {
      xv[k] = c <= kAdv ? cen[c] : 0;
    }
  }
  for (int i = l; i < kWords; i += 32) row[i] = 0;
  __syncwarp();

  if constexpr (!kSparse) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 32 * k + l;
      const int next = __shfl_down_sync(kFull, sv[k], 1);
      if (c < kAdv && !(c & 1))
        rowb[c >> 1] = (uint8_t)(((sv[k] & 0xFF) << 4) | (next & 0xFF));
      if (c <= kAdv) {
        reinterpret_cast<uint16_t*>(rowb + 64)[c] = (uint16_t)ins16_of(iw[k]);
        rowb[64 + 2 * (kAdv + 1) + c] =
            jv[k] >= 0 ? (uint8_t)clampi(jv[k] - xv[k] + 64, 0, 254) : 255;
      }
    }
    if (l == 0) rowb[64 + 3 * (kAdv + 1)] = 255;
  } else {
    // covered interior columns and valid boundaries are contiguous runs:
    // their ends from the same registers as the events
    Ends cc, bb;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 32 * k + l;
      cc.add(__ballot_sync(kFull, c < kAdv && sv[k] != 5), 32 * k);
      bb.add(__ballot_sync(kFull, c <= kAdv && jv[k] >= 0), 32 * k);
    }
    const bool any_b = bb.first >= 0;
    const int s0c = cc.first >= 0 ? cc.first : 0;
    const int s1c = cc.first >= 0 ? cc.last + 1 : 0;
    const int s0b = any_b ? bb.first : 0;
    const int s1b = any_b ? bb.last : 0;
    int pick = jv[0];
#pragma unroll
    for (int k = 1; k < 4; ++k)
      if ((s0b >> 5) == k) pick = jv[k];
    const int at_s0b = __shfl_sync(kFull, pick, s0b & 31);
    const int base_j = any_b ? clampi(at_s0b, 0, 65535) : 0;

    const unsigned below = lanes_below(l);
    uint16_t* ivals = reinterpret_cast<uint16_t*>(rowb + 118);
    uint16_t* evals = reinterpret_cast<uint16_t*>(rowb + 64);
    int run_s = 0, run_i = 0, run_e = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 32 * k + l;
      const bool ev = c < kAdv && sv[k] != 5 && sv[k] != xv[k];
      const unsigned m = __ballot_sync(kFull, ev);
      const int idx = run_s + __popc(m & below);
      if (ev && idx < kWCapS) or_code(row + 23, idx, sv[k] - (sv[k] > xv[k]));
      run_s += __popc(m);

      const int v = ins16_of(iw[k]);
      const unsigned mi = __ballot_sync(kFull, v != 0);
      const int iidx = run_i + __popc(mi & below);
      if (v && iidx < kWCapI) ivals[iidx] = (uint16_t)v;
      run_i += __popc(mi);
      if (l == 0) {
        row[19 + k] = (int)m;  // bytes 76..91
        uint16_t* m16 = reinterpret_cast<uint16_t*>(rowb + 102 + 4 * k);
        m16[0] = (uint16_t)(mi & 0xFFFF);
        m16[1] = (uint16_t)(mi >> 16);
      }

      int jn = __shfl_down_sync(kFull, jv[k], 1);
      if (k < 3) {
        const int f = __shfl_sync(kFull, jv[k + 1], 0);
        if (l == 31) jn = f;
      }
      const bool jd_in = c < kAdv && c >= s0b && c < s1b && any_b;
      const int d = jd_in ? jn - jv[k] : 0;
      const bool esc = d > 14;
      const int nib = esc ? 15 : d;
      const int nib_hi = __shfl_down_sync(kFull, nib, 1);
      if (c < kAdv && !(c & 1)) rowb[c >> 1] = (uint8_t)(nib | (nib_hi << 4));
      const unsigned me = __ballot_sync(kFull, esc);
      const int eidx = run_e + __popc(me & below);
      if (esc && eidx < kWCapE) evals[eidx] = (uint16_t)clampi(d, 0, 65535);
      run_e += __popc(me);
    }
    if (l == 0) {
      rowb[72] = (uint8_t)s0b;
      rowb[73] = (uint8_t)s1b;
      rowb[74] = (uint8_t)(base_j & 0xFF);
      rowb[75] = (uint8_t)(base_j >> 8);
      rowb[100] = (uint8_t)s0c;
      rowb[101] = (uint8_t)s1c;
      rowb[166] = run_s > kWCapS || run_i > kWCapI || run_e > kWCapE;
      rowb[167] = any_b;
    }
  }
  __syncwarp();
  store_row(row, out + (size_t)n * kWords, kWords, l, 32);
}

// Dynamic shared memory past 48 KB (dense rows from T = 12288 on) needs
// an opt-in per kernel and device, made once: up to the device's limit
// less the kernel's static shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes,
                       std::atomic<unsigned long long>& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && ((done.load() >> dev) & 1)) return cudaSuccess;
  int optin = 0;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - (int)attr.sharedSizeBytes);
  if (e == cudaSuccess && dev < 64) done.fetch_or(1ull << dev);
  return e;
}

std::atomic<unsigned long long> sparse_optin{0}, cluster_optin{0},
    dense_optin{0};

}  // namespace

// K4: chars (N, (2T + RL) / 4) K2p's packed rows (the template, sparse
// mode), K2p's fields, centers (N, T+1) (dense mode); out (N, words) int32
extern "C" int dentist_round_pack(
    const void* chars, const void* sym, const void* ins, const void* jpath,
    const void* spans, const void* diffs, const void* win,
    const void* covered, const void* centers, void* out, int N, int T,
    int RL, int NWIN, int words, int sparse, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (!sparse) {
    const int nt = T / kCols < 32 ? 32
                   : (T / kCols > kMaxThreads ? kMaxThreads : T / kCols);
    const size_t smem = (size_t)words * 4;
    auto k = &round_pack_dense_kernel;
    e = allow_smem(k, smem, dense_optin);
    if (e != cudaSuccess) return (int)e;
    k<<<N, nt, smem, st>>>(
        (const int8_t*)sym, (const unsigned*)ins, (const int*)jpath,
        (const int*)spans, (const int*)diffs, (const int*)win,
        (const bool*)covered, (const int*)centers, (int*)out, T, NWIN, words);
    return (int)cudaGetLastError();
  }
  // a lane over a cluster of CTAs where the launch leaves SMs idle: the
  // most CTAs (up to kMaxCluster) that split T into whole 256-column
  // parts of 2048 to kCols * kMaxThreads columns each (one tile), N
  // clusters of them fitting the card's SMs
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int ctas = 1;
  for (int c = kMaxCluster; c >= 2 && ctas == 1; --c)
    if ((T / 256) % c == 0 && T / c >= 2048 && T / c <= kCols * kMaxThreads &&
        (long long)N * c <= sms)
      ctas = c;
  const int cols = T / ctas;
  const int nt = cols / kCols < 32 ? 32
                 : (cols / kCols > kMaxThreads ? kMaxThreads : cols / kCols);
  const size_t smem = (size_t)(((words + 3) & ~3) + 3 * 32 + 3) * 4;
  const uint8_t* a0 = (const uint8_t*)chars;
  const int8_t* a1 = (const int8_t*)sym;
  const unsigned* a2 = (const unsigned*)ins;
  const int* a3 = (const int*)jpath;
  const int* a4 = (const int*)spans;
  const int* a5 = (const int*)diffs;
  const int* a6 = (const int*)win;
  const bool* a7 = (const bool*)covered;
  int* a8 = (int*)out;
  if (ctas == 1) {
    auto k = &round_pack_sparse_kernel<kCols, false>;
    e = allow_smem(k, smem, sparse_optin);
    if (e != cudaSuccess) return (int)e;
    k<<<N, nt, smem, st>>>(a0, a1, a2, a3, a4, a5, a6, a7, a8, T, RL, NWIN,
                           words);
    return (int)cudaGetLastError();
  }
  auto k = &round_pack_sparse_kernel<kCols, true>;
  e = allow_smem(k, smem, cluster_optin);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N * ctas, 1, 1);
  cfg.blockDim = dim3(nt, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k, a0, a1, a2, a3, a4, a5, a6, a7, a8, T, RL,
                         NWIN, words);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// K4w: tsrc the packed rows (host windows, meta (4, N)) or the store
// (resident, meta (5, N)); the window round's fields and centers;
// out (N, 42) sparse or (N, 112) dense int32
extern "C" int dentist_window_pack(
    const void* tsrc, const void* meta, const void* sym, const void* ins,
    const void* jpath, const void* centers, void* out, int resident,
    int sparse, int store_len, int N, int T, int RL, void* stream) {
  auto k = sparse ? (resident ? &window_pack_kernel<true, true>
                              : &window_pack_kernel<true, false>)
                  : (resident ? &window_pack_kernel<false, true>
                              : &window_pack_kernel<false, false>);
  k<<<(N + kWLanes - 1) / kWLanes, 32 * kWLanes, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tsrc, (const int*)meta, (const int8_t*)sym,
      (const unsigned*)ins, (const int*)jpath, (const int*)centers, (int*)out,
      store_len, N, T, RL);
  return (int)cudaGetLastError();
}
