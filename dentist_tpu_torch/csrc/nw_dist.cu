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
// - K3f replaces consensus.py:_nw_dist_full, both end modes: one thread
//   per pair walks a full-width row through local memory, RL <= 127.
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
// K3f is bound by arithmetic: a few integer ops per DP cell on a few
// bytes per row.  K3b's bound counts 6 operations a cell; the kernel
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
      uint64_t carry = 0, ph_in = 1, mh_in = 0;  // ph_in: D[i][0] = i
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const uint64_t eq = ~(hi[q] ^ b1) & ~(lo[q] ^ b0);  // read[j] == code
        const uint64_t xv = eq | mv[q];
        const uint64_t a = eq & pv[q];
        const uint64_t s = a + pv[q];
        const uint64_t s2 = s + carry;
        carry = (uint64_t)(s < a) | (uint64_t)(s2 < s);
        const uint64_t xh = (s2 ^ pv[q]) | eq;
        const uint64_t ph = mv[q] | ~(xh | pv[q]);
        const uint64_t mh = pv[q] & xh;
        const uint64_t ph_s = (ph << 1) | ph_in;
        const uint64_t mh_s = (mh << 1) | mh_in;
        ph_in = ph >> 63;
        mh_in = mh >> 63;
        pv[q] = mh_s | ~(xv | ph_s);
        mv[q] = ph_s & xv;
      }
    }
  }
  int d = tl;  // D[tl][0]
#pragma unroll
  for (int q = 0; q < kWords; ++q) {
    const int n = rl - 64 * q;  // the read's bits in this word
    const uint64_t mask = n >= 64 ? ~0ull : n > 0 ? (1ull << n) - 1 : 0ull;
    d += __popcll(pv[q] & mask) - __popcll(mv[q] & mask);
  }
  return d;
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

// K3f: templates (V, T), reads (V, N, RL) -> out (V, N)
template <bool kGlobal>
__global__ void nw_dist_full_kernel(const uint8_t* __restrict__ tpl,
                                    const int* __restrict__ t_lens,
                                    const uint8_t* __restrict__ reads,
                                    const int* __restrict__ read_lens,
                                    int* __restrict__ out, int V, int N, int T,
                                    int RL) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)V * N) return;
  const int v = (int)(g / N);
  const uint8_t* t = tpl + (size_t)v * T;
  const uint8_t* rd = reads + (size_t)g * RL;
  const int tl = t_lens[v];
  const int rl = read_lens[g];

  uint8_t r[kRwMax];
  int D[kRwMax + 1];
  // cells past rl are INF on every row and feed only each other: the
  // row loop stops at the read's end
  const int jmax = rl < RL ? rl : RL;
  for (int j = 0; j < jmax; ++j) r[j] = rd[j];
  for (int j = 0; j <= RL; ++j) D[j] = j <= rl ? (kGlobal ? j : 0) : kInf;

  int best = kInf;
  const int rows = tl < T ? tl : T;  // rows past t_len are all INF
  for (int i = 1; i <= rows; ++i) {
    const int t_ch = t[i - 1];
    int old_left = kInf;  // D of the previous row at j - 1
    int run = kInf;       // min over q <= j of tmp[q] - q
    int row_min = kInf;
    for (int j = 0; j <= jmax; ++j) {
      const int old = D[j];
      const int diag = j >= 1 ? old_left + (r[j - 1] != t_ch) : kInf;
      int up = old + 1;
      if (!kGlobal && j == 0) up = min(up, 0);  // free leading template gap
      const int tmp = min(diag, up);
      run = min(run, tmp - j);
      D[j] = min(min(tmp, run + j), kInf);
      row_min = min(row_min, D[j]);
      old_left = old;
    }
    // the read's end: on the template's last row, or (free-shift) any row
    if ((!kGlobal || i == tl) && rl >= 0 && rl <= RL) best = min(best, D[rl]);
    // free-shift: the template's end anywhere in the read
    if (!kGlobal && i == tl) best = min(best, row_min);
  }
  out[g] = best;
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
  const long long total = (long long)V * N;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  auto k = global_ends ? nw_dist_full_kernel<true> : nw_dist_full_kernel<false>;
  k<<<blocks, threads, 0, (cudaStream_t)stream>>>(
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
