// K3: exact global edit distance of short (template, read) pairs, the
// consensus polish scorer.
//
// Replaces dentist_tpu/ops/consensus.py:_nw_dist_full(global_ends=True)
// as called by _nw_dist_pair_packed (2065): every candidate edit v carries
// a base window and an edited window (<= TW = 34 template chars) and NB
// read segments (<= RW = 48 chars); both windows are scored against every
// segment, giving (2, V, NB) distances.  K3p, the packed mode (kPacked),
// takes the rows 2-bit packed, as _nw_dist_pair_packed does with its
// _unpack2bit; K3 takes one code a byte (& 3).
//
// The result of a pair is one integer, D[tl][rl], so any exact method
// gives JAX's value.  This one is bit-parallel: Myers's algorithm (J. ACM
// 46:395, 1999) in Hyyro's formulation with the top row anchored
// (D[i][0] = i), as Edlib's global mode runs it.  The read is the pattern,
// held as kWords 64-bit words (1 for RW <= 64, 2 up to 127): Pv / Mv mark
// the columns j where D[i][j] - D[i][j-1] is +1 / -1.  A template row is
// one step of about 15 word operations (an add, shifts, LOP3s), not RW + 1
// cells; after row tl, D[tl][rl] = tl + popc(Pv) - popc(Mv) over the
// read's rl bits.  Bits at and above rl are never read back (the add's
// carries and the shifts move only upward), so the words need no masking.
//
// Design:
// - One thread per (v, nb) read slot.  It decodes its read once, into two
//   bit planes (bit j of hi / lo is read[j]'s high / low code bit; the
//   match mask of code (t1, t0) is ~(hi ^ t1) & ~(lo ^ t0), each bit
//   spread over the word), and scores it
//   against both windows.  Consecutive threads take consecutive nb of one
//   v, so a warp's template loads are one broadcast address (NB >= 32).
// - Codes arrive 16 at a time (codes16: five byte loads and shifts;
//   planes16: a bit reverse and a 4-step unshuffle), at any char offset:
//   TWp and RW may be odd.  A template row's code is a constant shift of
//   its 16-code word, in a 16-row loop unrolled in registers.
// - Nothing is in local memory: the planes and Pv / Mv are kWords-word
//   arrays indexed only by unrolled loops.
// - JAX's INF cases are kept: tl <= 0, tl > TW (JAX scans TW rows, so row
//   tl is never reached), rl < 0, rl > RW.  rl = 0 gives tl.  Those slots,
//   and the slots the NB bucket pads with rl = 0, run no row.
//
// What bounds it: integer issue.  The recurrence needs 11 INT32
// operations per template row and 32 read columns (the match mask, the
// add, 7 LOP3s, 2 shifts: chip_smoke.py's bound); the compiled row loop
// issues about 35 per row on a 64-bit word (its SASS, which chip_smoke.py
// prints beside), the rest being the code's spread, the loads of the
// template's codes and the loop's control.  ~100 input bytes a slot.  At the main path's large launches
// (V = 4096, NB >= 32: 131 k threads or more) the card is full, and the
// slots a bucket pads (rl = 0) idle beside their warp's filled ones; at
// V = 256 (2 k to 8 k threads) one row's dependent chain and the launch
// set the time.
//
// K3f (nw_dist_full_kernel) and K3b (banded_nw_dist_kernel) are the two
// other scorer modes of the JAX package, on its general layout: templates
// (V, T), reads (V, N, RL), one template against its own N reads, either
// end mode (kGlobal: both ends anchored; else free-shift: the read may
// start and end anywhere in the template and the template anywhere in the
// read, at no cost).  No path of the JAX package calls them; they are
// held against their plain versions only.
// - K3f replaces consensus.py:_nw_dist_full, both end modes, RL <= 127:
//   K3's bit-parallel step on bytes compared whole.  One thread per (v, n)
//   pair, consecutive n of one v (a warp's template loads are one
//   broadcast address).  The read is ceil(RL / 32) 32-bit limbs (one to
//   four) in eight bit planes (plane b holds bit b of each byte), decoded
//   from aligned 4-byte loads by byte permutes and an 8 x 8 bit transpose
//   per byte lane, about 80 operations per 32 bytes; bits at and past rl
//   are 0.  Where every read byte of a warp is < 4 (a vote), the match
//   mask of a template byte is K3's two-plane compare, empty for a byte
//   >= 4; else it is the AND of eight plane compares.  Then K3's word
//   step (word_step, shared, on 32-bit limbs): the add's carry runs
//   across the limbs in one add.cc / addc chain, and the shifts take the
//   limb below's top bit.  The vote and the limbs are measured: on the
//   same inputs, eight planes always took 1.37x the vote's time at
//   V = 4096 and 1.08-1.16x at V = 256 on codes; 64-bit words in place of
//   the limbs took 1.15x on bytes at V = 256 (PERF.md section 6).  Global
//   mode is K3's recurrence (top row and column 0 anchored); free-shift
//   mode is the search form (both edges free: Pv = Mv = 0, nothing
//   shifted in at column 0), D[i][rl] kept on every row from the
//   horizontal deltas at column rl and folded into a running minimum.  JAX's own recurrence fixes the
//   free-shift answer at 0 wherever 1 <= t_len <= T and rl >= 0 (see the
//   kernel), so only pairs with t_len > T walk rows there.  Nothing is in
//   local memory.
// - K3b replaces consensus.py:_banded_nw_dist: one warp per pair, its
//   W-cell band (W <= 256) in registers, cell p = 32 k + lane in register
//   k < ceil(W / 32) of the lane; cells p >= W hold INF.  The band of row
//   i starts at read column off(i) = clip(i * rl / t_len - W/2, ...), so
//   a row reads the previous one shifted by s = off(i) - off(i-1), the
//   same for the whole warp: up = D_prev[p + s] is a rotation of each
//   register by s & 31 lanes (one shuffle; lanes past the wrap take the
//   next register's) and a move of the registers by s >> 5 (a
//   warp-uniform branch, taken only where the band moves by 32 cells or
//   more a row, through the warp's slice of shared memory); the diagonal
//   D_prev[p + s - 1] is one more shuffle from lane - 1.  The closure min
//   over q <= p of tmp[q] - q is an inclusive warp min-scan of each
//   register (five shuffles up) and the minimum of the lower registers'
//   totals (one redux.sync each, off the scan's chain).  A row's template
//   character and band offset are loaded and computed by the whole warp
//   alike (the same address, the same values), which keeps the shift and
//   its branches uniform; each register's read characters are 32
//   adjacent bytes.  Nothing is in local memory.
// K3f is bound by integer issue as K3 is: 11 INT32 operations per
// template row and 32 read columns (the free-shift search 4 more a row
// for its running minimum); chip_smoke.py prints its compiled row loop's
// SASS count beside K3's.  K3b's
// bound counts 6 operations a cell; the kernel
// issues a few dozen warp instructions per register and row for 32 cells,
// and each row waits on the one before through a chain of dependent
// shuffles (the rotation, the diagonal, five scan steps).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 28;
constexpr int kRwMax = 127;
constexpr int kBandMax = 256;

// 16 codes of a row from code k on, code k in bits 31..30; codes past the
// row's n_bytes bytes read as 0.  Packed rows hold four codes a byte, the
// first in the high bits (as pack2.cuh reads them); unpacked rows one
// code a byte.
template <bool kPacked>
__device__ __forceinline__ uint32_t codes16(const uint8_t* __restrict__ row,
                                            int k, int n_bytes) {
  if constexpr (kPacked) {
    const int b = k >> 2, s = 2 * (k & 3);
    uint32_t x = 0;  // bytes b .. b+3, the first on top
#pragma unroll
    for (int q = 0; q < 4; ++q)
      x = (x << 8) | (b + q < n_bytes ? __ldg(row + b + q) : 0u);
    const uint32_t next = b + 4 < n_bytes ? __ldg(row + b + 4) : 0u;
    return (x << s) | (next << s >> 8);
  } else {
    uint32_t x = 0;
#pragma unroll
    for (int q = 0; q < 16; ++q)
      x = (x << 2) | (k + q < n_bytes ? __ldg(row + k + q) & 3u : 0u);
    return x;
  }
}

// the 16 codes of w (codes16's order) as bit planes: bit j of the low half
// is code j's high bit, bit j of the high half its low bit
__device__ __forceinline__ uint32_t planes16(uint32_t w) {
  uint32_t x = __brev(w), t;  // code j's high bit at 2j, its low bit at 2j+1
  t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
  t = (x ^ (x >> 8)) & 0x0000FF00u; x ^= t ^ (t << 8);
  return x;
}

__device__ __forceinline__ int popc(uint32_t x) { return __popc(x); }
__device__ __forceinline__ int popc(uint64_t x) { return __popcll(x); }

// s = x + y over kWords words, the carry running upward: on 64-bit words
// from compares (K3), on 32-bit limbs through one add.cc / addc chain
// (K3f)
template <int kWords>
__device__ __forceinline__ void add_words(const uint64_t (&x)[kWords],
                                          const uint64_t (&y)[kWords],
                                          uint64_t (&s)[kWords]) {
  uint64_t carry = 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const uint64_t t = x[q] + y[q];
    s[q] = t + carry;
    carry = (uint64_t)(t < x[q]) | (uint64_t)(s[q] < t);
  }
}

template <int kLimbs>
__device__ __forceinline__ void add_words(const uint32_t (&x)[kLimbs],
                                          const uint32_t (&y)[kLimbs],
                                          uint32_t (&s)[kLimbs]) {
  if constexpr (kLimbs == 1) {
    s[0] = x[0] + y[0];
  } else if constexpr (kLimbs == 2) {
    asm("add.cc.u32 %0, %2, %4;\n\t"
        "addc.u32 %1, %3, %5;"
        : "=&r"(s[0]), "=&r"(s[1])
        : "r"(x[0]), "r"(x[1]), "r"(y[0]), "r"(y[1]));
  } else if constexpr (kLimbs == 3) {
    asm("add.cc.u32 %0, %3, %6;\n\t"
        "addc.cc.u32 %1, %4, %7;\n\t"
        "addc.u32 %2, %5, %8;"
        : "=&r"(s[0]), "=&r"(s[1]), "=&r"(s[2])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(y[0]), "r"(y[1]), "r"(y[2]));
  } else {
    static_assert(kLimbs == 4, "reads of at most 128 bytes");
    asm("add.cc.u32 %0, %4, %8;\n\t"
        "addc.cc.u32 %1, %5, %9;\n\t"
        "addc.cc.u32 %2, %6, %10;\n\t"
        "addc.u32 %3, %7, %11;"
        : "=&r"(s[0]), "=&r"(s[1]), "=&r"(s[2]), "=&r"(s[3])
        : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(y[0]), "r"(y[1]),
          "r"(y[2]), "r"(y[3]));
  }
}

// One Myers/Hyyro word step over kWords words W (bit j: read column
// j + 1), K3's and K3f's: row i - 1's vertical deltas pv / mv (+1 / -1
// where D[i][j] - D[i][j-1] is) become row i's, from the row's match mask
// eq.  The add's carry and the shifts run across the words.  ph_in is the
// horizontal delta shifted in at column 0: 1 where D[i][0] = i (the
// top-left anchored), 0 where D[i][0] = 0 (the search form).  ph / mh
// return the row's horizontal deltas (+1 / -1 where D[i][j] - D[i-1][j]
// is, at bit j - 1).
template <typename W, int kWords>
__device__ __forceinline__ void word_step(const W (&eq)[kWords],
                                          W (&pv)[kWords], W (&mv)[kWords],
                                          W ph_in, W (&ph)[kWords],
                                          W (&mh)[kWords]) {
  constexpr int kTop = 8 * sizeof(W) - 1;
  W a[kWords], s[kWords], mh_in = 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) a[q] = eq[q] & pv[q];
  add_words(a, pv, s);
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const W xv = eq[q] | mv[q];
    const W xh = (s[q] ^ pv[q]) | eq[q];
    ph[q] = mv[q] | ~(xh | pv[q]);
    mh[q] = pv[q] & xh;
    const W ph_s = (ph[q] << 1) | ph_in, mh_s = (mh[q] << 1) | mh_in;
    ph_in = ph[q] >> kTop;
    mh_in = mh[q] >> kTop;
    pv[q] = mh_s | ~(xv | ph_s);
    mv[q] = ph_s & xv;
  }
}

// D[i][rl] - D[i][0]: the vertical deltas of the read's rl columns
template <typename W, int kWords>
__device__ __forceinline__ int vertical_sum(const W (&pv)[kWords],
                                            const W (&mv)[kWords], int rl) {
  constexpr int kBits = 8 * sizeof(W);
  int d = 0;
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int n = rl - kBits * q;  // the read's bits in this word
    const W mask = n >= kBits ? ~W(0) : n > 0 ? (W(1) << n) - 1 : W(0);
    d += popc(pv[q] & mask) - popc(mv[q] & mask);
  }
  return d;
}

// D[tl][rl] of the template at code t0 of row (1 <= tl, 1 <= rl) against
// the read's planes: one word step per template row
template <bool kPacked, int kWords>
__device__ __forceinline__ int myers(const uint8_t* __restrict__ row, int t0,
                                     int tl, int rl, int n_bytes,
                                     const uint64_t (&hi)[kWords],
                                     const uint64_t (&lo)[kWords]) {
  uint64_t pv[kWords], mv[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) pv[q] = ~0ull, mv[q] = 0;  // D[0][j] = j
  for (int c = 0; c < tl; c += 16) {
    const uint32_t w = codes16<kPacked>(row, t0 + c, n_bytes);
    const int n = tl - c;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k >= n) break;
      // the code's high and low bits, each spread over a word (~0 or 0)
      const uint64_t b1 = (uint64_t)(int64_t)((int32_t)(w << (2 * k)) >> 31);
      const uint64_t b0 = (uint64_t)(int64_t)((int32_t)(w << (2 * k + 1)) >> 31);
      uint64_t eq[kWords], ph[kWords], mh[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        eq[q] = ~(hi[q] ^ b1) & ~(lo[q] ^ b0);  // read[j] == code
      word_step(eq, pv, mv, uint64_t{1}, ph, mh);  // D[i][0] = i
    }
  }
  return tl + vertical_sum(pv, mv, rl);  // D[tl][0] = tl
}

template <bool kPacked, int kWords>
__global__ void __launch_bounds__(128)
nw_dist_kernel(const uint8_t* __restrict__ buf,  // (V, L | L/4)
               const int* __restrict__ meta,     // (V, 2+NB)
               int* __restrict__ out,            // (2, V, NB)
               int V, int TW, int TWp, int RW, int NB) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long slots = (long long)V * NB;
  if (g >= slots) return;
  const int v = (int)(g / NB);
  const int nb = (int)(g % NB);
  const int L = 2 * TWp + NB * RW;
  const int n_bytes = kPacked ? L / 4 : L;
  const uint8_t* row = buf + (size_t)v * n_bytes;
  const int* m = meta + (size_t)v * (2 + NB);
  const int rl = m[2 + nb];
  const bool read_ok = rl >= 0 && rl <= RW;

  uint64_t hi[kWords], lo[kWords];
#pragma unroll
  for (int q = 0; q < kWords; ++q) hi[q] = lo[q] = 0;
  const int r0 = 2 * TWp + nb * RW;
#pragma unroll
  for (int c = 0; c < 4 * kWords; ++c) {
    if (read_ok && 16 * c < rl) {
      const uint32_t x = planes16(codes16<kPacked>(row, r0 + 16 * c, n_bytes));
      hi[c / 4] |= (uint64_t)(x & 0xFFFFu) << (16 * (c % 4));
      lo[c / 4] |= (uint64_t)(x >> 16) << (16 * (c % 4));
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tl = m[half];
    int d = kInf;
    if (read_ok && tl >= 1 && tl <= TW)
      d = rl == 0 ? tl
                  : myers<kPacked, kWords>(row, half * TWp, tl, rl, n_bytes,
                                           hi, lo);
    out[half * slots + g] = d;
  }
}

template <bool kPacked>
int launch_nw_dist(const void* buf, const void* meta, void* out, int V,
                   int TW, int TWp, int RW, int NB, void* stream) {
  const long long slots = (long long)V * NB;
  const int threads = 128;
  const unsigned blocks = (unsigned)((slots + threads - 1) / threads);
  auto k = RW <= 64 ? nw_dist_kernel<kPacked, 1> : nw_dist_kernel<kPacked, 2>;
  k<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int*)meta, (int*)out, V, TW, TWp, RW, NB);
  return (int)cudaGetLastError();
}

// ---- K3f: the general layout, bytes compared whole, 32-bit limbs ----

// 32 bytes of a read from byte k on (k a multiple of 32), as 8 bit
// planes: bit j of pl[b] is bit b of byte k + j; bytes at and past n
// (n > k) read as 0.  The bytes come from aligned 4-byte loads, only of
// words that hold a byte below n, and a funnel shift; 16 byte
// permutes gather r[q] = bytes q, 8 + q, 16 + q, 24 + q; then three
// rounds of delta swaps transpose each byte lane's 8 x 8 bits.
__device__ __forceinline__ void planes32(const uint8_t* __restrict__ rd, int k,
                                         int n, uint32_t (&pl)[8]) {
  const uintptr_t p = (uintptr_t)(rd + k);
  const uint32_t* w = (const uint32_t*)(p & ~(uintptr_t)3);
  const uintptr_t end = (uintptr_t)(rd + n);
  const int sh = 8 * (int)(p & 3);
  uint32_t x[9], b[8];
#pragma unroll
  for (int m = 0; m < 9; ++m) x[m] = (uintptr_t)(w + m) < end ? __ldg(w + m) : 0u;
#pragma unroll
  for (int m = 0; m < 8; ++m) b[m] = __funnelshift_r(x[m], x[m + 1], sh);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 4; q += 2) {
      const uint32_t sel = q | (4 + q) << 4 | (q + 1) << 8 | (5 + q) << 12;
      const uint32_t lo = __byte_perm(b[h], b[2 + h], sel);
      const uint32_t hi = __byte_perm(b[4 + h], b[6 + h], sel);
      pl[4 * h + q] = __byte_perm(lo, hi, 0x5410);
      pl[4 * h + q + 1] = __byte_perm(lo, hi, 0x7632);
    }
  }
  // bit 8 i + b of pl[q] is bit b of byte 8 i + q: swap q and b
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    const uint32_t m = d == 1 ? 0x55555555u : d == 2 ? 0x33333333u : 0x0F0F0F0Fu;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (q & d) continue;
      const uint32_t t = ((pl[q] >> d) ^ pl[q + d]) & m;
      pl[q + d] ^= t;
      pl[q] ^= t << d;
    }
  }
  const int left = n - k;
  const uint32_t keep = left >= 32 ? ~0u : (1u << left) - 1;
#pragma unroll
  for (int q = 0; q < 8; ++q) pl[q] &= keep;
}

// the match mask of template byte c: bit j where read byte j == c.
// kPlanes = 2 where every read byte of the warp is < 4 (planes 2..7 are
// zero): two planes, and no bit for c >= 4; else all eight planes
template <int kPlanes, int kLimbs>
__device__ __forceinline__ void match(const uint32_t (&pl)[8][kLimbs],
                                      uint32_t c, uint32_t (&eq)[kLimbs]) {
  if constexpr (kPlanes == 2) {
    const uint32_t s0 = 0u - (c & 1u), s1 = 0u - ((c >> 1) & 1u);
    const uint32_t small = c < 4 ? ~0u : 0u;
#pragma unroll
    for (int l = 0; l < kLimbs; ++l)
      eq[l] = ~(pl[0][l] ^ s0) & ~(pl[1][l] ^ s1) & small;
  } else {
    uint32_t s[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) s[b] = 0u - ((c >> b) & 1u);
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
      uint32_t e = ~(pl[0][l] ^ s[0]);
#pragma unroll
      for (int b = 1; b < 8; ++b) e &= ~(pl[b][l] ^ s[b]);
      eq[l] = e;
    }
  }
}

// D[i][rl] over template rows i of t (rows rows), the read's planes pl:
// one Myers/Hyyro word step per row on kLimbs limbs.  kGlobal: the top
// row and column 0 anchored (D[0][j] = j, D[i][0] = i; Pv = ~0, a +1
// shifted in at column 0), the result D[tl][rl] after row tl = rows from
// the vertical deltas of the read's rl columns.  Free-shift (the search
// form): both edges free (D[0][j] = 0, D[i][0] = 0; Pv = Mv = 0, nothing
// shifted in), the result min over rows of D[i][rl], kept from the
// horizontal deltas at column rl (bit rl - 1 of Ph and Mh) with D[0][rl]
// = 0.
template <bool kGlobal, int kPlanes, int kLimbs>
__device__ __forceinline__ int walk_rows(const uint8_t* __restrict__ t,
                                         int rows, int rl,
                                         const uint32_t (&pl)[8][kLimbs]) {
  uint32_t pv[kLimbs], mv[kLimbs], at[kLimbs];
#pragma unroll
  for (int l = 0; l < kLimbs; ++l) {
    pv[l] = kGlobal ? ~0u : 0u;
    mv[l] = 0;
    at[l] = ((rl - 1) >> 5) == l ? 1u << ((rl - 1) & 31) : 0u;  // column rl
  }
  int score = 0, best = kInf;
  for (int i0 = 0; i0 < rows; i0 += 8) {
    uint32_t c8[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) c8[k] = i0 + k < rows ? __ldg(t + i0 + k) : 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (i0 + k >= rows) break;
      uint32_t eq[kLimbs], ph[kLimbs], mh[kLimbs];
      match<kPlanes>(pl, c8[k], eq);
      word_step(eq, pv, mv, kGlobal ? 1u : 0u, ph, mh);
      if constexpr (!kGlobal) {
        uint32_t up = 0, down = 0;
#pragma unroll
        for (int l = 0; l < kLimbs; ++l) up |= ph[l] & at[l], down |= mh[l] & at[l];
        score += (int)(up != 0) - (int)(down != 0);
        best = min(best, score);
      }
    }
  }
  if constexpr (kGlobal) return rows + vertical_sum(pv, mv, rl);  // D[tl][0] = tl
  return best;
}

// K3f: templates (V, T), reads (V, N, RL <= 32 kLimbs) -> out (V, N),
// one thread per (v, n) pair
template <bool kGlobal, int kLimbs>
__global__ void __launch_bounds__(128)
nw_dist_full_kernel(const uint8_t* __restrict__ tpl,
                    const int* __restrict__ t_lens,
                    const uint8_t* __restrict__ reads,
                    const int* __restrict__ read_lens, int* __restrict__ out,
                    int V, int N, int T, int RL) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = g < (long long)V * N;  // the rest of the warp votes
  const int v = in ? (int)(g / N) : 0;
  const int tl = in ? __ldg(t_lens + v) : 0;
  const int rl = in ? __ldg(read_lens + g) : -1;
  // the pair's value where it needs no row, or whether it walks rows
  int d = kInf;
  bool walk = false;
  if (kGlobal) {  // D[tl][rl]: INF for tl outside [1, T], rl outside [0, RL]
    if (tl >= 1 && tl <= T && rl >= 0 && rl <= RL) d = tl, walk = rl > 0;
  } else if (tl >= 1 && rl >= 0) {
    // The closed form: JAX clamps up[..., :1] to 0 (consensus.py:1963-1966),
    // so D[i][0] = 0 on every row i <= t_len while rl >= 0, and its
    // answer takes row t_len's minimum over every valid j, j = 0 among
    // them (row_last, consensus.py:1977): 0 wherever row t_len exists.
    // Past T no row is t_len, and the answer is min over rows 1..T of
    // D[i][rl] (INF where rl > RL: no column is rl; 0 where rl = 0).
    if (tl <= T)
      d = 0;
    else if (rl <= RL && T >= 1)
      d = 0, walk = rl > 0;
  }

  uint32_t pl[8][kLimbs] = {};
  if (walk) {
    const uint8_t* rd = reads + (size_t)g * RL;
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) {
      if (32 * l >= rl) break;
      uint32_t x[8];
      planes32(rd, 32 * l, rl, x);
#pragma unroll
      for (int b = 0; b < 8; ++b) pl[b][l] = x[b];
    }
  }
  uint32_t high = 0;
#pragma unroll
  for (int b = 2; b < 8; ++b)
#pragma unroll
    for (int l = 0; l < kLimbs; ++l) high |= pl[b][l];
  const bool codes = __all_sync(0xffffffffu, high == 0);
  if (walk) {
    const uint8_t* t = tpl + (size_t)v * T;
    const int rows = kGlobal ? tl : T;
    d = codes ? walk_rows<kGlobal, 2>(t, rows, rl, pl)
              : walk_rows<kGlobal, 8>(t, rows, rl, pl);
  }
  if (in) out[g] = d;
}

template <bool kGlobal>
void launch_full(int limbs, unsigned blocks, cudaStream_t stream,
                 const uint8_t* tpl, const int* t_lens, const uint8_t* reads,
                 const int* read_lens, int* out, int V, int N, int T, int RL) {
  void (*k)(const uint8_t*, const int*, const uint8_t*, const int*, int*,
            int, int, int, int);
  switch (limbs) {
    case 1: k = nw_dist_full_kernel<kGlobal, 1>; break;
    case 2: k = nw_dist_full_kernel<kGlobal, 2>; break;
    case 3: k = nw_dist_full_kernel<kGlobal, 3>; break;
    default: k = nw_dist_full_kernel<kGlobal, 4>; break;
  }
  k<<<blocks, 128, 0, stream>>>(tpl, t_lens, reads, read_lens, out, V, N, T,
                                RL);
}

// Python's floor division for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// read column of band cell 0 on row i (consensus.py:2005-2007)
__device__ __forceinline__ int band_off(int i, int tl, int rl, int W) {
  const int c = floor_div((int)((unsigned)i * (unsigned)rl), max(tl, 1));
  const int lo = -((W + 1) / 2);  // Python's -W // 2
  const int hi = max(rl - W / 2, 0);
  return min(max(c - W / 2, lo), hi);
}

constexpr unsigned kFull = 0xffffffffu;

// K3b: templates (V, T), reads (V, N, RL) -> out (V, N), band width W <=
// 32 kRegs.  One warp per (v, n) pair, alone in its CTA: the pair, its
// lengths, the row loop, the shift and its branches are then uniform
// across the block, so the compiler emits the shuffles without the
// collective sequences it needs where a warp may have diverged.  Band
// cell p = 32 k + lane is register k of the lane.
template <bool kGlobal, int kRegs>
__global__ void banded_nw_dist_kernel(const uint8_t* __restrict__ tpl,
                                      const int* __restrict__ t_lens,
                                      const uint8_t* __restrict__ reads,
                                      const int* __restrict__ read_lens,
                                      int* __restrict__ out, int N, int T,
                                      int RL, int W) {
  // the registers, where the band moves by a whole register or more
  __shared__ int moved[kRegs + 1][32];
  const int lane = threadIdx.x;
  const int g = blockIdx.x;  // consecutive CTAs: consecutive n of one v
  const int v = g / N;
  const uint8_t* t = tpl + (size_t)v * T;
  const uint8_t* rd = reads + (size_t)g * RL;
  const int tl = __ldg(t_lens + v);
  const int rl = __ldg(read_lens + g);
  if (rl < 0) {  // no cell lies in the DP: every row is INF
    if (lane == 0) out[g] = kInf;
    return;
  }

  // read column j = off + p of cell p when cell 0 is at column off (JAX's
  // int32 wrap); the cell lies in the DP where p < W and 0 <= j <= rl
  int D[kRegs];
  int off = band_off(0, tl, rl, W);
#pragma unroll
  for (int k = 0; k < kRegs; ++k) {
    const int p = 32 * k + lane;
    const int j = (int)((unsigned)off + p);
    D[k] = p < W && (unsigned)j <= (unsigned)rl ? (kGlobal ? j : 0) : kInf;
  }

  int best = kInf;
  const int rows = tl < T ? tl : T;  // rows past t_len are all INF
  for (int i = 1; i <= rows; ++i) {
    const int t_ch = __ldg(t + i - 1);
    const int off_i = band_off(i, tl, rl, W);
    // the shift, warp-uniform and >= 0 unless i * rl wraps; a shift past
    // the band's 32 kRegs cells leaves only INF
    const long long ds = (long long)off_i - off;
    const int s = (int)(ds < -1024 ? -1024 : ds > 1024 ? 1024 : ds);
    const int a = s >> 5, b = s & 31;
    off = off_i;

    // E[k + 1] = D_prev[32 k + lane + s] for k in [-1, kRegs): rotate each
    // register by b lanes (lanes past the wrap take the next register),
    // then move the registers by a
    const bool wrap = lane + b >= 32;
    int X[kRegs + 2];  // X[k + 1] = shfl(D[k], lane + b); X[0], X[kRegs + 1] INF
    X[0] = X[kRegs + 1] = kInf;
#pragma unroll
    for (int k = 0; k < kRegs; ++k)
      X[k + 1] = b ? __shfl_sync(kFull, D[k], (lane + b) & 31) : D[k];
    int E[kRegs + 1];
#pragma unroll
    for (int m = 0; m <= kRegs; ++m) E[m] = wrap ? X[m + 1] : X[m];
    if (a != 0) {  // the band moves by 32 cells or more: E[m] = E[m + a]
#pragma unroll
      for (int m = 0; m <= kRegs; ++m) moved[m][lane] = E[m];
      __syncwarp();
#pragma unroll
      for (int m = 0; m <= kRegs; ++m) {
        const int src = m + a;
        E[m] = src >= 0 && src <= kRegs ? moved[src][lane] : kInf;
      }
      __syncwarp();
    }

    // tmp = min(diag, up) - p, then its prefix minimum over the band
    int u[kRegs], tot[kRegs];
#pragma unroll
    for (int k = 0; k < kRegs; ++k) {
      const int p = 32 * k + lane;
      const int j = (int)((unsigned)off + p);
      // D_prev[p + s - 1]: lane - 1's E, lane 0 taking lane 31's E[k - 1]
      const int e1 = __shfl_sync(kFull, lane == 31 ? E[k] : E[k + 1],
                                 (lane + 31) & 31);
      const int jr = (int)((unsigned)j - 1u);
      const int r_ch = __ldg(rd + (jr < 0 ? 0 : jr > RL - 1 ? RL - 1 : jr));
      const int diag = j >= 1 ? e1 + (r_ch != t_ch) : kInf;
      int up = E[k + 1] + 1;
      if (!kGlobal && j == 0) up = min(up, 0);  // free leading template gap
      int x = min(diag, up) - p;
      tot[k] = __reduce_min_sync(kFull, x);
      // lanes below d get their own x back from the shuffle
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) x = min(x, __shfl_up_sync(kFull, x, d));
      u[k] = x;
    }
    int carry = 0x7fffffff;  // the lower registers' minimum
#pragma unroll
    for (int k = 0; k < kRegs; ++k) {
      const int p = 32 * k + lane;
      const int j = (int)((unsigned)off + p);
      D[k] = p < W && (unsigned)j <= (unsigned)rl ? min(min(u[k], carry) + p, kInf)
                                                  : kInf;
      carry = min(carry, tot[k]);
      if (!kGlobal && j == rl) best = min(best, D[k]);  // the read's end
    }
  }
  // row t_len, where the loop ended on it: the read's end (global) or the
  // row's minimum (free-shift: the template's end anywhere in the read)
  if (rows == tl && tl >= 1) {
#pragma unroll
    for (int k = 0; k < kRegs; ++k)
      if (!kGlobal || (int)((unsigned)off + 32 * k + lane) == rl)
        best = min(best, D[k]);
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1)
    best = min(best, __shfl_xor_sync(kFull, best, d));
  if (lane == 0) out[g] = best;
}

template <bool kGlobal>
void launch_banded(int regs, unsigned blocks, cudaStream_t stream,
                   const uint8_t* tpl, const int* t_lens, const uint8_t* reads,
                   const int* read_lens, int* out, int N, int T, int RL,
                   int W) {
  void (*k)(const uint8_t*, const int*, const uint8_t*, const int*, int*,
            int, int, int, int);
  switch (regs) {
    case 1: k = banded_nw_dist_kernel<kGlobal, 1>; break;
    case 2: k = banded_nw_dist_kernel<kGlobal, 2>; break;
    case 3: k = banded_nw_dist_kernel<kGlobal, 3>; break;
    case 4: k = banded_nw_dist_kernel<kGlobal, 4>; break;
    case 5: k = banded_nw_dist_kernel<kGlobal, 5>; break;
    case 6: k = banded_nw_dist_kernel<kGlobal, 6>; break;
    case 7: k = banded_nw_dist_kernel<kGlobal, 7>; break;
    default: k = banded_nw_dist_kernel<kGlobal, 8>; break;
  }
  k<<<blocks, 32, 0, stream>>>(tpl, t_lens, reads, read_lens, out, N, T, RL,
                               W);
}

}  // namespace

extern "C" int dentist_nw_dist(const void* buf, const void* meta, void* out,
                               int V, int TW, int TWp, int RW, int NB,
                               void* stream) {
  return launch_nw_dist<false>(buf, meta, out, V, TW, TWp, RW, NB, stream);
}

// K3p: chars (V, (2 TWp + NB RW) / 4) packed rows
extern "C" int dentist_nw_dist_packed(const void* chars, const void* meta,
                                      void* out, int V, int TW, int TWp,
                                      int RW, int NB, void* stream) {
  return launch_nw_dist<true>(chars, meta, out, V, TW, TWp, RW, NB, stream);
}

// K3f: templates (V, T), reads (V, N, RL <= 127); global_ends 0 or 1
extern "C" int dentist_nw_dist_full(const void* tpl, const void* t_lens,
                                    const void* reads, const void* read_lens,
                                    void* out, int V, int N, int T, int RL,
                                    int global_ends, void* stream) {
  const long long pairs = (long long)V * N;
  if (RL < 0 || RL > kRwMax || T < 0) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((pairs + 127) / 128);
  auto launch = global_ends ? launch_full<true> : launch_full<false>;
  launch(RL <= 32 ? 1 : (RL + 31) / 32, blocks, (cudaStream_t)stream,
         (const uint8_t*)tpl, (const int*)t_lens, (const uint8_t*)reads,
         (const int*)read_lens, (int*)out, V, N, T, RL);
  return (int)cudaGetLastError();
}

// K3b: templates (V, T), reads (V, N, RL), band W <= 256; global_ends 0 or 1
extern "C" int dentist_banded_nw_dist(const void* tpl, const void* t_lens,
                                      const void* reads, const void* read_lens,
                                      void* out, int V, int N, int T, int RL,
                                      int W, int global_ends, void* stream) {
  const long long pairs = (long long)V * N;  // one CTA each
  if (W < 1 || W > kBandMax || pairs >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  auto launch = global_ends ? launch_banded<true> : launch_banded<false>;
  launch((W + 31) / 32, (unsigned)pairs, (cudaStream_t)stream,
         (const uint8_t*)tpl, (const int*)t_lens, (const uint8_t*)reads,
         (const int*)read_lens, (int*)out, N, T, RL, W);
  return (int)cudaGetLastError();
}
