// K1: seed-anchored banded extension DP, fed from a device sequence store.
//
// Replaces dentist_tpu/ops/banded.py:_extend_scan_v3 together with its
// resident gather _extend_scan_v3_resident: one DP row per A character,
// a W-cell band per row that follows the lane's linear schedule
// off_r = (r * num_k[lane_k]) / R - W/2 (floor), the horizontal closure
// D[p] = min_{q<=p} tmp[q] + (p - q), and per row the best cell under the
// packed key ((p - 6D) << 9) | (W-1-p), carried into the lane's best
// (r, j, d, s) and its (jm << 15 | dm) trace sample every 126 rows.
//
// K1p, the packed mode (kPacked), replaces _extend_scan_v3_packed and
// _extend_scan_v3_packed2 (banded.py:249, :519) with their _unpack2bit:
// each lane's host-assembled A window (R chars) and B window (BW chars)
// arrive as one 2-bit packed row, decoded at staging through pack2.cuh;
// the five per-lane ints are meta5 rows b_len, lane_k, a_len, diag_lo,
// diag_hi.  Both modes run the same DP loop.
//
// What bounds it on the card: the integer instruction rate.  Each lane is a
// chain of up to R = 32256 dependent rows of a W = 256-cell band, about a
// dozen integer operations per cell, and an SM sub-partition dispatches one
// integer warp instruction every two cycles (16 lanes a clock).  The main
// path's widest launches hold 1024 lanes, about 2 warps per sub-partition,
// which keeps that pipe busy; a launch of few live lanes is bound by one
// row's latency instead (its shuffle scan, then its instruction count).
// Bytes are few: W + 96 characters per 32 rows.
//
// Design: one warp per lane, four lanes per block, and no block-wide
// barrier anywhere.
// - Thread t holds the VT band cells t*VT .. t*VT+VT-1 in registers: VT
//   = 8 for W <= 256 (the aligner's W), 32 up to W = 1024, the cells past
//   W held unreachable.  The band's shift by s = off_r - off_{r-1} in
//   {0, 1, 2} takes at most two cells from the next thread and one from
//   the previous one (__shfl_down_sync, __shfl_up_sync); s is the same
//   for the whole warp, so each s has its own unrolled row body and no
//   per-cell select.  Rows whose band lies wholly inside the lane's valid
//   cells (j >= 1, j <= b_len, inside the diagonal bounds) have bodies
//   without the per-cell masks.
// - The band is held as u = D - p (below), so the horizontal closure is a
//   running minimum along the thread's cells, an exclusive 5-step shuffle
//   scan of the threads' minima, and one min per cell.  Integer min is
//   exact, so this is JAX's associative_scan bit for bit.
// - The row winner leaves the row's chain: each row computes the previous
//   row's best key per thread from the band before overwriting it, into a
//   per-warp table in shared memory.  After each chunk of 32 rows thread
//   i takes row i's maximum over the table, and warp scans give the
//   running jm and dm, a max and a ballot the first best row, exactly as
//   the row-by-row updates would.
// - Per chunk of 32 rows the warp stages into shared memory a row table
//   (each row's offset, shift, valid-cell bounds and A character) and the
//   32 * VT + 96 B columns the chunk's band can reach (it moves at most 2
//   columns a row), with reversal, the uint8 3 - x complement,
//   [c_lo, c_hi), [0, BW), the clamped window starts and the 2-bit decode
//   applied once there.  The next chunk's global loads are started into
//   registers before the current chunk's rows run and written to shared
//   memory after them, so no row waits on device memory; a row's table
//   entry and characters (VT/4 + 1 aligned words and a funnel shift) are
//   read one and two rows ahead.
// Unreachable cells hold values >= kInf that may drift up a little each
// row (the reference clamps them to kInf); only the test D < kInf reads
// them, so every reachable value and every output is unchanged.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "pack2.cuh"

namespace {

constexpr int kInf = 1 << 28;
constexpr int kNeg = -(1 << 30);
constexpr int kDiffPenalty = 6;
constexpr int kTrace = 126;
constexpr int kChunk = 32;  // rows per staged chunk (one A char per thread)
constexpr int kLanes = 4;   // lanes (warps) per block
constexpr int kBig = 1 << 29;  // scan identity: above every tmp - p
// u of a cell outside the band or not valid, as the row step reads it:
// u >= kInf - p + 1 - s holds for every p >= 0 and s >= 0, so the cells
// it reaches stay at D >= kInf
constexpr int kFill = kInf + 2;
constexpr int kWide = 1 << 30;  // |j|, |j - r| stay below it
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// dynamic_slice semantics: a window start is clamped into the store
__device__ __forceinline__ long long clamp_start(long long s, long long size,
                                                 long long store_len) {
  long long hi = store_len - size;
  if (s > hi) s = hi;
  if (s < 0) s = 0;
  return s;
}

// The band is kept as u[p] = D[p] - p: then the horizontal closure
// D[p] = min_{q<=p} tmp[q] + (p - q) is a plain running minimum of
// tmp - p, and a cell's step from the row above is
//   tmp[p] - p = (s - 1) + min(e1 + sub, e + 2),
// e = u_prev[p + s] (the cell above), e1 = u_prev[p + s - 1] (the
// diagonal), sub = (A char != B char) = min(A ^ B, 1).  A cell that is
// not reachable (D >= kInf in the reference) holds u >= kInf - p: the
// band stores kInf there, and the row step reads kFill past the band's
// ends and in place of a cell that is not valid.

// The thread's best row key from a band row u (kInf where a cell is not
// valid): the cell maximizing p - 6D, as JAX packs it,
// ((p - 6D) << 9) | (W-1-p) = ((-5p - 6u) << 9) | (W-1-p) in wrapping
// int32 arithmetic, over the cells with D < kInf, else kNeg.
template <int VT>
__device__ __forceinline__ int band_key(const int (&u)[VT], int p0, int W) {
  int key[VT];
#pragma unroll
  for (int i = 0; i < VT; ++i) {
    const int p = p0 + i;
    if constexpr (VT <= 8) {
      // W <= 256: W-1-p has 9 bits, so | equals + below the shifted M
      key[i] = (int)((unsigned)(W - 1 - 2561 * p) +
                     (unsigned)u[i] * (unsigned)-3072);
    } else {
      key[i] = (int)(((unsigned)(-2560 * p) + (unsigned)u[i] * (unsigned)-3072) |
                     (unsigned)(W - 1 - p));
    }
    if (u[i] >= kInf - p) key[i] = kNeg;
  }
#pragma unroll
  for (int h = 1; h < VT; h <<= 1)
#pragma unroll
    for (int i = 0; i + h < VT; i += 2 * h) key[i] = max(key[i], key[i + h]);
  return key[0];
}

// One DP row for the thread's VT cells.  S is the band's shift, FULL
// says every cell of the band is valid with j >= 1; bw holds the
// thread's B characters, a the row's A character; pj1, plo, phi bound
// the cells with j >= 1 and the valid cells (read when !FULL).  The
// previous row's best key is taken from the band before it is
// overwritten, off this row's chain.  Returns that key.
template <int VT, int S, bool FULL>
__device__ __forceinline__ int row_step(int (&u)[VT],
                                        const uint32_t (&bw)[(VT + 3) / 4],
                                        int a, int t, int p0, int W, int pj1,
                                        int plo, int phi) {
  constexpr int NOUT = (VT + 3) / 4;
  int pv = kFill, nx0 = kFill, nx1 = kFill;
  if (S == 0) {
    pv = __shfl_up_sync(kAll, u[VT - 1], 1);
    if (t == 0) pv = kFill;
  } else {
    nx0 = __shfl_down_sync(kAll, u[0], 1);
    if (t == 31) nx0 = kFill;
    if (S == 2) {
      nx1 = __shfl_down_sync(kAll, u[1], 1);
      if (t == 31) nx1 = kFill;
    }
  }
  // ext(k): k = 0 the previous thread's last cell, 1..VT own cells,
  // VT+1 and VT+2 the next cells; e[i] = ext(i+S+1), e1[i] = ext(i+S)
  auto ext = [&](int k) {
    return k == 0 ? pv : k <= VT ? u[k - 1] : k == VT + 1 ? nx0 : nx1;
  };

  const int kprev = band_key<VT>(u, p0, W);

  // B ^ A, four characters a word: byte i is 0 where they match
  uint32_t x[NOUT];
#pragma unroll
  for (int k = 0; k < NOUT; ++k) x[k] = bw[k] ^ ((uint32_t)a * 0x01010101u);

  // pm[i] = min_{j <= i} min(e1 + sub, e + 2) along the thread's cells
  int pm[VT];
  int run = kBig;
#pragma unroll
  for (int i = 0; i < VT; ++i) {
    const int p = p0 + i;
    const int e1 = ext(i + S), e = ext(i + S + 1);
    const int b = (int)__byte_perm(x[i >> 2], 0, 0x4440 | (i & 3));
    int v = min(e1 + b, min(e1 + 1, e + 2));
    if (!FULL && p < pj1) v = e + 2;  // j < 1: no diagonal
    if (!FULL && (p < plo || p > phi)) v = kFill;
    run = min(run, v);
    pm[i] = run;
  }

  // exclusive scan of the threads' minima across the warp (a lane below
  // the shuffle's distance gets its own value back: min keeps it)
  int ex = __shfl_up_sync(kAll, run, 1);
  if (t == 0) ex = kBig;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) ex = min(ex, __shfl_up_sync(kAll, ex, o));

#pragma unroll
  for (int i = 0; i < VT; ++i) {
    const int next = min(ex, pm[i]) + (S - 1);
    u[i] = (FULL || (p0 + i >= plo && p0 + i <= phi)) ? next : kInf;
  }
  return kprev;
}

template <bool kPacked, int VT>
__global__ void __launch_bounds__(32 * kLanes)
    extend_kernel(const uint8_t* __restrict__ src, long long src_len,
                  const int* __restrict__ meta,   // (12 | 5, N)
                  const int* __restrict__ num_k,  // (K,)
                  int N, int R, int W, int BW,
                  int* __restrict__ out) {  // (4 + R/126, N)
  constexpr int NB = VT + 3;          // staged B columns per thread
  constexpr int NOUT = (VT + 3) / 4;  // words holding a thread's VT chars
  constexpr int KS = kChunk + 1;      // row stride of the key table
  __shared__ uint32_t sB[kLanes][8 * NB];
  // per row of the chunk: off, s | full << 2 | A char << 8, plo, phi
  __shared__ int4 sR[kLanes][kChunk + 2];
  __shared__ int sK[kLanes][32 * KS];  // [thread][row of the chunk]
  // what staging reads once a chunk: A char ai at a_base + a_step * ai,
  // B column c at b_base + b_step * c (store mode; packed: the lane's
  // row, steps 1), c inside [col_lo, col_hi)
  struct Stage {
    long long a_base, b_base;
    int a_step, b_step, b_flip, col_lo, col_hi;
  };
  __shared__ Stage sS[kLanes];

  const int w = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int n = blockIdx.x * kLanes + w;
  if (n >= N) return;  // a whole warp: no barrier follows
  uint8_t* const sb = reinterpret_cast<uint8_t*>(sB[w]);
  int4* const rows = sR[w];
  int* const sk = sK[w];

  // store mode: 12 coordinates into the store; packed mode: the lane's
  // row of [A window | B window] codes, the whole B window valid
  long long a_start = 0, b_start = 0;
  int a_rev = 0, b_rev = 0, b_flip = 0, c_lo = 0, c_hi = BW;
  int a_len, b_len, num, diag_lo, diag_hi;
  if constexpr (kPacked) {
    b_len = meta[0 * N + n];
    num = num_k[meta[1 * N + n]];
    a_len = meta[2 * N + n];
    diag_lo = meta[3 * N + n];
    diag_hi = meta[4 * N + n];
  } else {
    a_start = clamp_start(meta[0 * N + n], R, src_len);
    a_rev = meta[1 * N + n];
    a_len = meta[2 * N + n];
    b_start = clamp_start(meta[3 * N + n], BW, src_len);
    b_rev = meta[4 * N + n];
    b_flip = meta[5 * N + n];
    c_lo = meta[6 * N + n];
    c_hi = meta[7 * N + n];
    b_len = meta[8 * N + n];
    num = num_k[meta[9 * N + n]];
    diag_lo = meta[10 * N + n];
    diag_hi = meta[11 * N + n];
  }
  if (t == 0) {
    Stage& g = sS[w];
    if constexpr (kPacked) {
      g.a_base = g.b_base = (long long)n * ((R + BW) / 4);
    } else {
      g.a_base = a_start + (a_rev ? R - 1 : 0);
      g.b_base = b_start + (b_rev ? BW - 1 : 0);
    }
    g.a_step = a_rev ? -1 : 1;
    g.b_step = b_rev ? -1 : 1;
    g.b_flip = b_flip;
    g.col_lo = max(c_lo, 0);
    g.col_hi = min(c_hi, BW);
  }
  __syncwarp();
  const Stage& lane = sS[w];
  // every j and j - r lies inside (-kWide, kWide): clamping the bounds
  // there changes no comparison and keeps the row ranges from overflowing
  b_len = max(-kWide, min(b_len, kWide));
  diag_lo = max(-kWide, min(diag_lo, kWide));
  diag_hi = max(-kWide, min(diag_hi, kWide));
  const int half = W / 2;
  const int p0 = t * VT;

  // row 0: D = j = p - W/2 where valid, so u = -W/2
  int u[VT];
#pragma unroll
  for (int i = 0; i < VT; ++i) {
    const int j0 = p0 + i - half;
    const bool ok0 = p0 + i < W && j0 >= 0 && j0 <= b_len && j0 >= diag_lo &&
                     j0 <= diag_hi;
    u[i] = ok0 ? -half : kInf;
  }
  int jm = 0, dm = 0, best_s = -kInf, best_r = 0, best_j = 0, best_d = 0;

  // rows past a_len cannot change the result: stop there and repeat the
  // final trace sample in the remaining trace rows
  const int r_end = min(R, max(a_len, 0));
  // the schedule's offset of row r, floor(r * num / R) - W/2 (r <= R + 32)
  auto off_at = [&](int r) {
    if (R <= 46000)  // r * num < 2^32
      return (int)((unsigned)r * (unsigned)num / (unsigned)R) - half;
    return (int)(((long long)r * num) / R) - half;
  };

  // staging: the chunk of rows r0 .. r0+31 reads A chars r0-1 .. r0+30
  // and B columns cb .. cb + 32*NB - 1, cb = off(r0) - 1 + W
  int rawA = 0, rawB[NB];
  auto fetch = [&](int r0, int cb) {
    const int ai = r0 - 1 + t;
    rawA = 0;
    if (ai < r_end) {
      if constexpr (kPacked)
        rawA = src[lane.a_base + (ai >> 2)];
      else
        rawA = src[lane.a_base + (long long)lane.a_step * ai];
    }
    const int lo = lane.col_lo, hi = lane.col_hi;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int c = cb + t + 32 * k;
      rawB[k] = 0;
      if (c >= lo && c < hi) {
        if constexpr (kPacked)
          rawB[k] = src[lane.b_base + ((R + c) >> 2)];
        else
          rawB[k] = src[lane.b_base + (long long)lane.b_step * c];
      }
    }
  };
  // writes the chunk's B columns and its row table (thread t: row r0+t)
  auto commit = [&](int r0, int cb) {
    const int flip = lane.b_flip, lo = lane.col_lo, hi = lane.col_hi;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int c = cb + t + 32 * k;
      int v = rawB[k];
      if constexpr (kPacked) {
        v = code2_of(v, R + c);
      } else if (flip && c >= lo && c < hi) {
        v = (uint8_t)(3 - v);
      }
      sb[t + 32 * k] = (uint8_t)v;
    }
    const int r = r0 + t;
    int a = rawA;
    if constexpr (kPacked) a = code2_of(a, r - 1);
    const int off = off_at(r);
    // valid cells: 0 <= j <= b_len, diag_lo <= j - r <= diag_hi
    const int plo = max(-off, diag_lo + r - off);
    const int phi = min(min(b_len - off, diag_hi + r - off), W - 1);
    const bool full = W == 32 * VT && off >= 1 && plo <= 0 && phi >= W - 1;
    rows[t] = make_int4(off, (off - off_at(r - 1)) | (full << 2) | (a << 8),
                        plo, phi);
    // rows 32 and 33 hold only an offset: the loop reads their characters
    // ahead, inside the staged columns, and reloads them after the chunk
    if (t < 2) rows[kChunk + t] = make_int4(off_at(r + kChunk), 0, 0, 0);
  };
  // the thread's VT B characters of a row whose offset is off
  auto chars = [&](int off, int cb, uint32_t (&bw)[NOUT]) {
    const int x = off - (cb + 1 - W) + p0;  // staged index of p0's column
    const uint32_t* wb = sB[w] + (x >> 2);
    const int sh = 8 * (x & 3);
    uint32_t lo = wb[0];
#pragma unroll
    for (int k = 0; k < NOUT; ++k) {
      const uint32_t hi = wb[k + 1];
      bw[k] = __funnelshift_r(lo, hi, sh);
      lo = hi;
    }
  };

  // the row winners of a chunk, rows r0 .. r1-1, one row per thread:
  // running maxima jm, dm by warp scans, the first best row by a max
  // and a ballot, the trace samples of the chunk's rows
  auto winners = [&](int r0, int r1) {
    const int nrows = r1 - r0;
    const int rr = r0 + t;
    int k = kNeg;
#pragma unroll 8
    for (int v = 0; v < 32; ++v) k = max(k, sk[v * KS + t]);
    const bool ok = t < nrows && k != kNeg;
    const int o = rows[t].x;
    const int row_m = k >> 9;
    const int row_p = (W - 1) - (k & (2 * W - 1));
    int pj = ok ? o + row_p : INT_MIN;
    int pd = ok ? floordiv(row_p - row_m, kDiffPenalty) : INT_MIN;
    const int ps = ok ? rr + o + row_m : INT_MIN;
#pragma unroll
    for (int h = 1; h < 32; h <<= 1) {
      pj = max(pj, __shfl_up_sync(kAll, pj, h));
      pd = max(pd, __shfl_up_sync(kAll, pd, h));
    }
    const int jm_t = max(jm, pj), dm_t = max(dm, pd);
    if (t < nrows && rr % kTrace == 0)
      out[(4 + rr / kTrace - 1) * N + n] =
          (jm_t << 15) | min(dm_t, (1 << 15) - 1);
    const int top = __reduce_max_sync(kAll, ps);
    if (top > best_s) {
      const int first = __ffs(__ballot_sync(kAll, ps == top)) - 1;
      best_s = top;
      best_r = r0 + first;
      best_j = __shfl_sync(kAll, jm_t, first);
      best_d = __shfl_sync(kAll, dm_t, first);
    }
    jm = __shfl_sync(kAll, jm_t, nrows - 1);
    dm = __shfl_sync(kAll, dm_t, nrows - 1);
  };

  int r0 = 1, cb = off_at(1) - 1 + W;
  // the row about to run (rec), the next one (rec1), rec's characters
  int4 rec = make_int4(0, 0, 0, 0), rec1 = rec;
  uint32_t bw[NOUT];
  if (r_end > 0) {
    fetch(r0, cb);
    commit(r0, cb);
    __syncwarp();
    rec = rows[0];
    rec1 = rows[1];
    chars(rec.x, cb, bw);
  }
  while (r0 <= r_end) {
    const int r1 = min(r0 + kChunk, r_end + 1);  // this chunk: [r0, r1)
    const int cb_next = r1 <= r_end ? off_at(r1) - 1 + W : 0;
    if (r1 <= r_end) fetch(r1, cb_next);

    for (int r = r0; r < r1; ++r) {
      const int slot = r - r0;
      // the rows ahead: their table entries and characters load while
      // this row runs (past the chunk's end they are reloaded below)
      const int4 rec2 = rows[slot + 2];
      uint32_t bw1[NOUT];
      chars(rec1.x, cb, bw1);

      const int s = rec.y & 3, a = rec.y >> 8;
      const int off = rec.x, plo = rec.z, phi = rec.w, pj1 = 1 - off;
      int kmax;
      if (rec.y & 4) {
        if (s == 0)
          kmax = row_step<VT, 0, true>(u, bw, a, t, p0, W, pj1, plo, phi);
        else if (s == 1)
          kmax = row_step<VT, 1, true>(u, bw, a, t, p0, W, pj1, plo, phi);
        else
          kmax = row_step<VT, 2, true>(u, bw, a, t, p0, W, pj1, plo, phi);
      } else {
        if (s == 0)
          kmax = row_step<VT, 0, false>(u, bw, a, t, p0, W, pj1, plo, phi);
        else if (s == 1)
          kmax = row_step<VT, 1, false>(u, bw, a, t, p0, W, pj1, plo, phi);
        else
          kmax = row_step<VT, 2, false>(u, bw, a, t, p0, W, pj1, plo, phi);
      }
      // the key row_step returns is the previous row's; the previous
      // chunk's last row was written before its winners (slot 32: unused)
      sk[t * KS + (slot > 0 ? slot - 1 : kChunk)] = kmax;
      rec = rec1;
      rec1 = rec2;
#pragma unroll
      for (int k = 0; k < NOUT; ++k) bw[k] = bw1[k];
    }

    sk[t * KS + (r1 - 1 - r0)] = band_key<VT>(u, p0, W);
    __syncwarp();  // the chunk's keys are written, its chars all read
    winners(r0, r1);
    __syncwarp();  // the row table is read
    if (r1 <= r_end) {
      commit(r1, cb_next);
      __syncwarp();
      rec = rows[0];
      rec1 = rows[1];
      chars(rec.x, cb_next, bw);
    }
    r0 = r1;
    cb = cb_next;
  }

  const int jd = (jm << 15) | min(dm, (1 << 15) - 1);
  for (int k = r_end / kTrace + 1 + t; k <= R / kTrace; k += 32)
    out[(4 + k - 1) * N + n] = jd;
  if (t == 0) {
    out[0 * N + n] = best_r;
    out[1 * N + n] = best_j;
    out[2 * N + n] = best_d;
    out[3 * N + n] = best_s;
  }
}

// VT = 8 for W <= 256 (the aligner's W), 32 for the rest (W <= 1024)
template <bool kPacked>
int launch(const void* src, long long src_len, const void* meta,
           const void* num_k, void* out, int N, int R, int W, int BW,
           void* stream) {
  const dim3 grid((N + kLanes - 1) / kLanes), block(32 * kLanes);
  const cudaStream_t st = (cudaStream_t)stream;
  const auto* s = (const uint8_t*)src;
  const auto* m = (const int*)meta;
  const auto* k = (const int*)num_k;
  auto* o = (int*)out;
  if (W <= 256)
    extend_kernel<kPacked, 8><<<grid, block, 0, st>>>(s, src_len, m, k, N, R,
                                                      W, BW, o);
  else
    extend_kernel<kPacked, 32><<<grid, block, 0, st>>>(s, src_len, m, k, N,
                                                       R, W, BW, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dentist_extend(const void* store, const void* meta,
                              const void* num_k, void* out, int store_len,
                              int N, int R, int W, int BW, void* stream) {
  return launch<false>(store, store_len, meta, num_k, out, N, R, W, BW,
                       stream);
}

// K1p: chars (N, (R + BW) / 4) packed rows, meta5 (5, N)
extern "C" int dentist_extend_packed(const void* chars, const void* meta5,
                                     const void* num_k, void* out, int N,
                                     int R, int W, int BW, void* stream) {
  return launch<true>(chars, (long long)N * ((R + BW) / 4), meta5, num_k,
                      out, N, R, W, BW, stream);
}
