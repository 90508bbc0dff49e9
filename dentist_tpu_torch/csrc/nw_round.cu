// K2: banded free-shift NW realign round with the traceback on the card.
//
// Replaces dentist_tpu/ops/consensus.py:_nw_round_parts, which the JAX
// package wraps as _nw_round_kernel (full-template rounds) and
// _nw_window_round / _window_dense_pack (192-row windowed rounds).  Per
// lane: a W-cell band per template row whose offset follows the clamped
// band centers, ties broken diag > up > left, a free leading template gap
// and lead_free free leading read characters; the end row is the FIRST
// row with the least cost at j == read_len; the traceback walks the move
// codes back and reduces the path into sym / ins / jpath / win columns.
//
// K2p, the packed mode (kPacked), replaces _nw_round_packed
// (consensus.py:491) and the 2-bit input of _nw_window_round (:887): a
// lane's [template T | read RL | band-center steps T] arrive as one 2-bit
// packed row (pack2.cuh), meta holds t_lens, read_lens and the first band
// center as rows, and the centers are the running sum of the steps.
// K2r, the resident window mode (kResident), replaces
// consensus.py:_window_resident_inputs (945) with the DP of
// _nw_window_round_resident (1009) and _nw_window_round_resident_dense
// (972): five int32 coordinates per lane (meta rows t_lens, seg_lens,
// loc0, tpl_start, seg_start) locate both windows in the device store,
// starts clamped as jax.lax.dynamic_slice clamps them, and the centers
// are JAX's proportional schedule c(i) = c(i-1) + clip(p(i) - p(i-1), 0,
// 2), p(r) = min(r, t) * seg_len / t, t = max(t_len, 1).  Both modes
// write the centers to centers_out, which K4w reads.
//
// What bounds it on the card: one warp's instruction rate and latency
// per row.  A lane is a chain of T dependent rows, each a prefix minimum
// across the band, then a chain of up to T + RL dependent traceback
// steps.  The main path's launches hold tens to a few thousand lanes, so
// a warp mostly has its SM sub-partition to itself and nothing hides its
// stalls: a row of the W = 128 band is about a hundred instructions (on
// an H100 the integer ones go out every second cycle) and 7 dependent
// shuffles.  Bytes are few: 2 bits of move per cell are written once, a
// few per step read back.
//
// Design: one warp per lane, four lanes per block, no block barrier.
// - Thread t holds the V band cells t*V .. t*V+V-1 in registers (V = 4
//   for W <= 128, the consensus band; 32 up to W = 1024); cells past W
//   are held unreachable (kInf), so every W in [1, 1024] runs.
// - The band's shift s = off - off_prev is 0, 1 or 2 on every row the
//   host builds (clamped centers; K2p and K2r build no other): the cells
//   above come from the thread's registers and one or two shuffles, one
//   unrolled row body per s and per row whose band fills the warp with
//   j >= 1 (no masks; cells past read_len are never read).  kStore takes
//   any centers: a row with another shift goes through a per-warp band in
//   shared memory (__syncwarp only) and then the s = 0 body.
// - The horizontal closure D[p] = min(tmp[p], min_{q<p} tmp[q] + p - q)
//   is a running minimum of tmp - p along the thread's cells, a 6-shuffle
//   exclusive warp scan and one min per cell: integer min is exact.
// - Each thread keeps its own first best (cost, row) at j == read_len;
//   one warp reduction after the last row takes the lexicographic least.
// - Per chunk of 32 rows the warp computes a row table (offset, shift,
//   template character; K2p scans its 2-bit steps, K2r its proportional
//   steps, both store the chunk's centers coalesced) and stages the read
//   characters the chunk's band can reach, clamped and decoded once.
// - A cell stores only its 2-bit move (diag, up, left, none): V/4 bytes a
//   thread, one coalesced 8V-byte row a warp, (N, T, 8V) bytes a launch.
//   The read character and mismatch of a step are recomputed from (i, j).
// - The traceback: all 32 threads walk the same path, so every collective
//   is warp-uniform, and lane 0 writes.  When the walk leaves the staged
//   rows the warp stages the next 32 rows below it (their moves, offsets
//   and template characters, and the read characters they can reach) in
//   coalesced loads: the step loop reads shared memory and registers only.
//   Outputs start at their identities; each sym and jpath column and each
//   ins slot is written at most once on a path (a diag or up move lowers
//   i, a left run raises its rank), so plain stores equal JAX's scatter
//   min / max; the win count of the current window lives in a register
//   and is added (atomicAdd) when the window changes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "pack2.cuh"

namespace {

constexpr int kInf = 1 << 28;
constexpr int kBig = 1 << 30;  // scan identity: above every tmp - p
constexpr int kDiag = 0, kUp = 1, kLeft = 2, kNone = 3;
constexpr int kLanes = 4;  // lanes (warps) per block
constexpr int kChunk = 32;  // rows per staged chunk
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The three input modes of one DP.
enum Mode { kStore = 0, kPacked = 1, kResident = 2 };

// Per-warp shared memory.  kCap staged read characters cover a band of
// 32 V cells over rows whose offsets span at most kCap - 32 V = 128.
template <int V>
struct LaneSmem {
  static constexpr int kCap = 32 * V + 128;
  uint32_t chars[kCap / 4 + 2];
  int4 rows[kChunk + 1];  // forward: off, s, tch | full << 8; walk: off, tch
  union {
    int band[32 * V];             // the generic shift's band
    uint4 mv[kChunk * 2 * V / 4];  // the walk's 32 staged move rows
  } u;
};

// One DP row for the thread's V cells.  S is the band's shift (0, 1 or
// 2).  FULL says the band fills the warp and every cell has j >= 1: no
// cell is masked.  Cells with j > read_len are then left unmasked too:
// nothing reads them (the closure runs rightwards, the end row and the
// traceback stay at j <= read_len), and an unreachable cell holds a value
// >= kInf, unclamped, which stays far below the scan identity kBig.
// D holds the previous row, rc the thread's V read characters, four a
// word; edge is the cell left of the band, which thread 0 reads when S ==
// 0 (kInf but after a generic shift).  Returns the V moves, 2 bits a
// cell, in mw.
template <int V, int S, bool FULL>
__device__ __forceinline__ void row_step(int (&D)[V],
                                         const uint32_t (&rc)[V / 4], int tch,
                                         int t, int p0, int off, int rl, int W,
                                         int edge, int i, int& best_c,
                                         int& best_r,
                                         uint32_t (&mw)[(V + 15) / 16]) {
  int pv = kInf, nx0 = kInf, nx1 = kInf;
  if (S == 0) {
    pv = __shfl_up_sync(kAll, D[V - 1], 1);
    if (t == 0) pv = edge;
  } else {
    nx0 = __shfl_down_sync(kAll, D[0], 1);
    if (t == 31) nx0 = kInf;
    if (S == 2) {
      nx1 = __shfl_down_sync(kAll, D[1], 1);
      if (t == 31) nx1 = kInf;
    }
  }
  // ext(k): k = 0 the previous thread's last cell, 1..V own cells, V+1
  // and V+2 the next thread's first two; E = ext(k+S+1), E1 = ext(k+S)
  auto ext = [&](int k) {
    return k == 0 ? pv : k <= V ? D[k - 1] : k == V + 1 ? nx0 : nx1;
  };
  // read ^ template, four characters a word: byte k is 0 where they match
  uint32_t x[V / 4];
#pragma unroll
  for (int k = 0; k < V / 4; ++k) x[k] = rc[k] ^ ((uint32_t)tch * 0x01010101u);

  const int plo = max(-off, 0), phi = min(rl - off, W - 1);
  int tmp[V], pm[V];
  uint32_t up_bits = 0;
  int run = kBig;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int p = p0 + k;
    const int e1 = ext(k + S), e = ext(k + S + 1);
    const int b = (int)__byte_perm(x[k >> 2], 0, 0x4440 | (k & 3));
    int diag = min(e1 + b, e1 + 1);  // b is 0 where the characters match
    int up = e + 1;
    if (!FULL) {
      if (p < 1 - off) diag = kInf;  // j < 1: no diagonal
      if (p == -off) up = min(up, 0);  // j == 0: the free template gap
    }
    tmp[k] = min(diag, up);
    if (up < diag) up_bits |= 1u << k;
    run = min(run, tmp[k] - p);
    pm[k] = run;
  }
  // the exclusive prefix minimum of the threads' minima (a lane below the
  // shuffle's distance gets its own value back: min keeps it)
  int ex = __shfl_up_sync(kAll, run, 1);
  if (t == 0) ex = kBig;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) ex = min(ex, __shfl_up_sync(kAll, ex, o));

#pragma unroll
  for (int k = 0; k < (V + 15) / 16; ++k) mw[k] = 0;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int p = p0 + k;
    int d = min(ex, pm[k]) + p;
    uint32_t mv = d < tmp[k] ? kLeft : ((up_bits >> k) & 1);
    if (!FULL) {
      const bool valid = p >= plo && p <= phi;
      d = valid ? min(d, kInf) : kInf;
      if (!valid) mv = kNone;
    }
    D[k] = d;
    mw[k >> 4] |= mv << (2 * (k & 15));
  }
  // the end row: the cell with j == rl where it is one of this thread's
  // (a cell that is not valid or not reachable holds >= kInf: no win)
  if (rl - off < W) {
  const int q = rl - off - p0;
  int cand = kInf;
#pragma unroll
  for (int k = 0; k < V; ++k) cand = k == q ? D[k] : cand;
  best_r = cand < best_c ? i : best_r;  // the first row wins ties
  best_c = min(best_c, cand);
  }
}

// kStore: tpl (N, T), t_lens (N,), reads (N, RL), read_lens (N,) and
// centers (N, T+1) as given.  kPacked: tpl is the (N, (2T + RL)/4) packed
// rows, t_lens the (3 | 4, N) meta rows, reads and read_lens unused,
// centers a row per lane that the kernel fills.  kResident: tpl is the
// store of store_len bytes, t_lens the (5, N) meta rows, reads and
// read_lens unused, centers a row per lane that the kernel fills.
template <int kMode, int V>
__global__ void __launch_bounds__(32 * kLanes) nw_round_kernel(
    const uint8_t* __restrict__ tpl,
    const int* __restrict__ t_lens,
    const uint8_t* __restrict__ reads,
    const int* __restrict__ read_lens,
    int* __restrict__ centers,
    uint8_t* __restrict__ moves,          // (N, T, 8V) scratch
    int8_t* __restrict__ sym,             // (N, T)
    int8_t* __restrict__ ins,             // (N, T+1, 4)
    int* __restrict__ jpath,              // (N, T+1)
    int* __restrict__ spans,              // (N, 2)
    int* __restrict__ diffs,              // (N,)
    int* __restrict__ win,                // (N, NWIN)
    bool* __restrict__ covered,           // (N,)
    int N, int T, int RL, int W, int S, int NWIN, int lead_free, int trace,
    int store_len) {
  constexpr bool kFromMeta = kMode != kStore;
  constexpr int kCap = LaneSmem<V>::kCap;
  constexpr int kSpan = kCap - 32 * V;  // the offsets a staging may span
  constexpr int kRow = 8 * V;           // move bytes per row
  constexpr int NW = (V + 15) / 16;
  __shared__ LaneSmem<V> smem[kLanes];

  const int t = threadIdx.x & 31;
  const int n = blockIdx.x * kLanes + (threadIdx.x >> 5);
  if (n >= N) return;  // a whole warp: no barrier follows
  LaneSmem<V>& L = smem[threadIdx.x >> 5];
  uint8_t* const sc = reinterpret_cast<uint8_t*>(L.chars);

  const int rl = kFromMeta ? t_lens[N + n] : read_lens[n];
  const int tl = t_lens[n];
  const int half = W / 2;
  const int rl_clip = max(rl - half, 0);
  int* const cen = centers + (size_t)n * (T + 1);
  const uint8_t* row =
      kMode == kPacked ? tpl + (size_t)n * ((2 * T + RL) / 4) : nullptr;
  const uint8_t* rd = kMode == kStore ? reads + (size_t)n * RL : nullptr;
  const uint8_t* tp = kMode == kStore ? tpl + (size_t)n * T : nullptr;
  // kResident: the lane's windows in the store, starts clamped as
  // jax.lax.dynamic_slice clamps them
  const uint8_t* t_res = nullptr;
  const uint8_t* s_res = nullptr;
  const int tl1 = max(tl, 1);
  if constexpr (kMode == kResident) {
    t_res = tpl + clampi(t_lens[3 * N + n], 0, store_len - T);
    s_res = tpl + clampi(t_lens[4 * N + n], 0, store_len - RL);
  }
  uint8_t* const mv_lane = moves + (size_t)n * T * kRow;

  auto off_from = [&](int c) { return min(max(c - half, -half), rl_clip); };
  auto t_char = [&](int k) -> int {
    if constexpr (kMode == kPacked) return code2(row, k);
    else if constexpr (kMode == kResident) return k < tl ? t_res[k] & 3 : 0;
    else return tp[k] & 3;
  };
  auto r_char = [&](int k) -> int {
    if constexpr (kMode == kPacked) return code2(row, (long long)T + k);
    else if constexpr (kMode == kResident) return k < rl ? s_res[k] & 3 : 0;
    else return rd[k] & 3;
  };
  // kResident: the proportional schedule p(r) = min(r, t) * seg_len / t
  auto prop = [&](int r) { return min(r, tl1) * rl / tl1; };

  // the read characters [mn - 1, mn - 1 + kCap), indices clamped into
  // the read, into the lane's staging buffer
  auto stage_chars = [&](int mn) {
#pragma unroll
    for (int m = 0; m < kCap / 32; ++m) {
      const int x = t + 32 * m;
      sc[x] = (uint8_t)r_char(clampi(mn - 1 + x, 0, RL - 1));
    }
  };
  // the thread's V read characters of a row whose offset is off
  const int p0 = t * V;
  auto chars_of = [&](int off, int mn, uint32_t (&rc)[V / 4]) {
    const int x = off - mn + p0;
    const uint32_t* wb = L.chars + (x >> 2);
    const int sh = 8 * (x & 3);
    uint32_t lo = wb[0];
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const uint32_t hi = wb[k + 1];
      rc[k] = __funnelshift_r(lo, hi, sh);
      lo = hi;
    }
  };
  // rows 0 .. nv-1 of a staging, one a thread, with offsets off: the
  // count of leading rows whose offsets span at most kSpan (all of them
  // but where kStore's own centers jump) and their least offset mn
  auto fit = [&](int off, int nv, int& mn) {
    const bool in = t < nv;
    mn = __reduce_min_sync(kAll, in ? off : INT_MAX);
    const int mx = __reduce_max_sync(kAll, in ? off : INT_MIN);
    if (mx - mn <= kSpan) return nv;
    int lo = off, hi = off;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a = __shfl_up_sync(kAll, lo, o);
      const int b = __shfl_up_sync(kAll, hi, o);
      if (t >= o) {
        lo = min(lo, a);
        hi = max(hi, b);
      }
    }
    const int nr = __ffs(__ballot_sync(kAll, !in || hi - lo > kSpan)) - 1;
    mn = __shfl_sync(kAll, lo, nr - 1);
    return nr;
  };

  // row 0: the free leading template gap, lead_free free read chars
  int c_run = kMode == kPacked ? t_lens[2 * N + n]
              : kMode == kResident ? 0 : cen[0];
  if (kFromMeta && t == 0) cen[0] = c_run;
  int off_carry = off_from(c_run);
  int D[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int p = p0 + k, j0 = off_carry + p;
    const int d_init = lead_free < 0 ? 0 : max(j0 - lead_free, 0);
    D[k] = (p < W && j0 >= 0 && j0 <= rl) ? d_init : kInf;
  }
  int best_c = kInf, best_r = 0;

  // rows past the template cannot be valid: the DP stops there; K2p and
  // K2r still write every row's center
  const int T_eff = min(T, max(tl, 0));
  const int i_end = kFromMeta ? T : T_eff;
  for (int i0 = 1; i0 <= i_end;) {
    const int i = i0 + t;
    const bool in = i <= T;
    int c;
    if constexpr (kMode == kStore) {
      c = in ? cen[i] : 0;
    } else {
      int step = 0;
      if (in) {
        if constexpr (kMode == kPacked)
          step = code2(row, (long long)T + RL + i - 1);
        else
          step = clampi(prop(i) - prop(i - 1), 0, 2);
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, step, o);
        if (t >= o) step += y;
      }
      c = c_run + step;
      if (in) cen[i] = c;  // coalesced; read back by the traceback
    }
    const int off = off_from(c);
    int prev = __shfl_up_sync(kAll, off, 1);
    if (t == 0) prev = off_carry;
    const int nd0 = min(kChunk, T_eff - i0 + 1);  // DP rows of the chunk
    int adv = kChunk;
    if (nd0 > 0) {
      const int tch = in ? t_char(i - 1) : 0;
      int mn;
      const int nd = fit(off, nd0, mn);
      if (nd < nd0) adv = nd;
      const int full = W == 32 * V && off >= 1;
      const int4 rec_t = make_int4(off, off - prev, tch | (full << 8), 0);
      if (t < nd) L.rows[t] = rec_t;
      if (t == nd - 1) L.rows[nd] = rec_t;  // read ahead by the last row
      stage_chars(mn);
      __syncwarp();

      int4 rec = L.rows[0];
      uint32_t rc[V / 4];
      chars_of(rec.x, mn, rc);
      for (int r = 0; r < nd; ++r) {
        // the next row's entry and characters load while this one runs
        const int4 rec1 = L.rows[r + 1];
        uint32_t rc1[V / 4];
        chars_of(rec1.x, mn, rc1);
        const int ro = rec.x, s = rec.y, tc = rec.z & 0xff;
        const bool fl = rec.z >> 8;
        const int ii = i0 + r;
        int edge = kInf;
        if ((unsigned)s > 2u) {
          // kStore's other shifts: the band moves through shared memory,
          // then the s = 0 body runs on it (kInf outside [0, W))
#pragma unroll
          for (int k = 0; k < V; ++k) L.u.band[p0 + k] = D[k];
          __syncwarp();
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int q = p0 + k + s;
            D[k] = (q >= 0 && q < W) ? L.u.band[q] : kInf;
          }
          edge = (s - 1 >= 0 && s - 1 < W) ? L.u.band[s - 1] : kInf;
          __syncwarp();
        }
        uint32_t mw[NW];
#define K2_ROW(S_, FULL_)                                                     \
  row_step<V, S_, FULL_>(D, rc, tc, t, p0, ro, rl, W, edge, ii, best_c, best_r, \
                         mw)
        if (s == 1) {
          if (fl) K2_ROW(1, true); else K2_ROW(1, false);
        } else if (s == 2) {
          if (fl) K2_ROW(2, true); else K2_ROW(2, false);
        } else {
          if (fl) K2_ROW(0, true); else K2_ROW(0, false);
        }
#undef K2_ROW
        uint8_t* dst = mv_lane + (size_t)(ii - 1) * kRow;
        if constexpr (V == 4)
          dst[t] = (uint8_t)mw[0];
        else
          reinterpret_cast<uint2*>(dst)[t] = make_uint2(mw[0], mw[NW - 1]);
        rec = rec1;
#pragma unroll
        for (int k = 0; k < V / 4; ++k) rc[k] = rc1[k];
      }
      __syncwarp();  // the chunk's table and characters are read
    }
    c_run = __shfl_sync(kAll, c, adv - 1);
    off_carry = __shfl_sync(kAll, off, adv - 1);
    i0 += adv;
  }

  // the first least end cost over the warp
  const int dmin = __reduce_min_sync(kAll, best_c);
  const int i_best = __reduce_min_sync(kAll, best_c == dmin ? best_r : INT_MAX);
  const bool cov = dmin < kInf;

  // outputs at their reduction identities, written by the whole warp
  int8_t* const sy = sym + (size_t)n * T;
  int8_t* const in8 = ins + (size_t)n * 4 * (T + 1);
  int* const in32 = reinterpret_cast<int*>(in8);
  int* const jp = jpath + (size_t)n * (T + 1);
  int* const wi = win + (size_t)n * NWIN;
  for (int c = t; c < T; c += 32) sy[c] = 5;
  for (int c = t; c <= T; c += 32) {
    in32[c] = 0;
    jp[c] = -1;
  }
  for (int c = t; c < NWIN; c += 32) wi[c] = 0;
  __syncwarp();

  const int i_start = cov ? i_best : 0;
  const int j_start = cov ? rl : 0;
  if (cov && t == 0) jp[clampi(i_start, 0, T)] = max(-1, j_start);

  // the traceback: every thread walks the same path; lane 0 writes.  The
  // move rows [lo, hi) are staged: row r's offset (of DP row r + 1) and
  // template character in rows[hi - 1 - r], its moves at (r - lo) * kRow
  int lo = INT_MAX, hi = 0, mn = 0;
  auto restage = [&](int top) {  // the rows below top
    __syncwarp();  // the staged rows are read
    const int nv = min(kChunk, top);
    const int r = top - 1 - t;
    int off = 0, tch = 0;
    if (t < nv) {
      off = off_from(cen[r + 1]);
      tch = t_char(r);
    }
    const int nr = fit(off, nv, mn);
    hi = top;
    lo = top - nr;
    if (t < nr) L.rows[t] = make_int4(off, tch, 0, 0);
    stage_chars(mn);
    const uint4* g = reinterpret_cast<const uint4*>(mv_lane + (size_t)lo * kRow);
    for (int k = t; k < nr * (kRow / 16); k += 32) L.u.mv[k] = g[k];
    __syncwarp();
  };
  const uint8_t* const smv = reinterpret_cast<const uint8_t*>(L.u.mv);
  int i = i_start, j = j_start, run = 0;
  int cur_w = 0, cnt = 0;  // the current window's count, not yet added
  bool active = cov && i_start > 0 && j_start > 0;
  for (int step = 0; step < S && active; ++step) {
    if (i - 1 < lo) restage(i);
    const int4 rw = L.rows[hi - i];
    const int pp = j - rw.x;
    const bool inb = (unsigned)pp < (unsigned)W;
    const int byte = smv[(i - 1 - lo) * kRow + (inb ? pp >> 2 : 0)];
    const int mv = inb ? (byte >> (2 * (pp & 3))) & 3 : kNone;
    // the read character of the step, r_char(clamp(j - 1, 0, RL - 1))
    const int base = sc[clampi(j - mn, 0, kCap - 1)];
    if (t == 0) {
      if (mv == kDiag || mv == kUp) {
        sy[i - 1] = (int8_t)(mv == kDiag ? base : 4);
        jp[i - 1] = j - (mv == kDiag);
      } else if (mv == kLeft && run < 4) {
        in8[i * 4 + run] = (int8_t)(base + 1);
      }
    }
    if ((mv == kDiag && base != rw.y) || mv == kUp || mv == kLeft) {
      const int w = clampi(
          floordiv(mv == kLeft ? min(i, tl - 1) : i - 1, trace), 0, NWIN - 1);
      if (w != cur_w) {
        if (t == 0 && cnt) atomicAdd(wi + cur_w, cnt);
        cur_w = w;
        cnt = 0;
      }
      ++cnt;
    }
    const int i2 = i - (mv == kDiag || mv == kUp);
    const int j2 = j - (mv == kDiag || mv == kLeft);
    run = mv == kLeft ? run + 1 : 0;
    active = mv != kNone && i2 > 0 && j2 > 0;
    i = i2;
    j = j2;
  }
  if (t == 0) {
    if (cnt) atomicAdd(wi + cur_w, cnt);
    spans[2 * n] = cov ? i : 0;
    spans[2 * n + 1] = cov ? i_start : 0;
    diffs[n] = cov ? dmin : 0;
    covered[n] = cov;
  }
}

// V = 4 for W <= 128 (the consensus band), 32 for the rest (W <= 1024)
template <int kMode>
int launch(const void* tpl, const void* t_lens, const void* reads,
           const void* read_lens, void* centers, void* moves, void* sym,
           void* ins, void* jpath, void* spans, void* diffs, void* win,
           void* covered, int N, int T, int RL, int W, int S, int NWIN,
           int lead_free, int trace, int store_len, void* stream) {
  const dim3 grid((N + kLanes - 1) / kLanes), block(32 * kLanes);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* a = (const uint8_t*)tpl;
  auto* b = (const int*)t_lens;
  auto* c = (const uint8_t*)reads;
  auto* d = (const int*)read_lens;
  if (W <= 128)
    nw_round_kernel<kMode, 4><<<grid, block, 0, st>>>(
        a, b, c, d, (int*)centers, (uint8_t*)moves, (int8_t*)sym,
        (int8_t*)ins, (int*)jpath, (int*)spans, (int*)diffs, (int*)win,
        (bool*)covered, N, T, RL, W, S, NWIN, lead_free, trace, store_len);
  else
    nw_round_kernel<kMode, 32><<<grid, block, 0, st>>>(
        a, b, c, d, (int*)centers, (uint8_t*)moves, (int8_t*)sym,
        (int8_t*)ins, (int*)jpath, (int*)spans, (int*)diffs, (int*)win,
        (bool*)covered, N, T, RL, W, S, NWIN, lead_free, trace, store_len);
  return (int)cudaGetLastError();
}

}  // namespace

// moves: (N, T, 32) bytes for W <= 128, (N, T, 256) for wider bands
extern "C" int dentist_nw_round(
    const void* tpl, const void* t_lens, const void* reads,
    const void* read_lens, const void* centers, void* moves, void* sym,
    void* ins, void* jpath, void* spans, void* diffs, void* win,
    void* covered, int N, int T, int RL, int W, int S, int NWIN,
    int lead_free, int trace, void* stream) {
  return launch<kStore>(tpl, t_lens, reads, read_lens, (void*)centers, moves,
                        sym, ins, jpath, spans, diffs, win, covered, N, T, RL,
                        W, S, NWIN, lead_free, trace, 0, stream);
}

// K2p: chars (N, (2T + RL) / 4) packed rows, meta (3 | 4, N) with rows
// t_lens, read_lens, first band center; centers (N, T+1) int32, filled
extern "C" int dentist_nw_round_packed(
    const void* chars, const void* meta, void* centers, void* moves,
    void* sym, void* ins, void* jpath, void* spans, void* diffs, void* win,
    void* covered, int N, int T, int RL, int W, int S, int NWIN,
    int lead_free, int trace, void* stream) {
  return launch<kPacked>(chars, meta, nullptr, nullptr, centers, moves, sym,
                         ins, jpath, spans, diffs, win, covered, N, T, RL, W,
                         S, NWIN, lead_free, trace, 0, stream);
}

// K2r: store (store_len,) uint8, meta (5, N) with rows t_lens, seg_lens,
// loc0, tpl_start, seg_start; centers (N, T+1) int32, filled for K4w
extern "C" int dentist_nw_round_resident(
    const void* store, const void* meta, void* centers, void* moves,
    void* sym, void* ins, void* jpath, void* spans, void* diffs, void* win,
    void* covered, int store_len, int N, int T, int RL, int W, int S,
    int NWIN, int lead_free, int trace, void* stream) {
  return launch<kResident>(store, meta, nullptr, nullptr, centers, moves, sym,
                           ins, jpath, spans, diffs, win, covered, N, T, RL,
                           W, S, NWIN, lead_free, trace, store_len, stream);
}
