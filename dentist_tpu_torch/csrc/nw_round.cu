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
// What bounds it on the card: latency.  A lane is a chain of T dependent
// rows (two block-wide steps each) followed by a chain of up to T + RL
// dependent traceback steps, each one a byte load from the move buffer.
// Bytes: W move bytes per row are written once and about one per step is
// read back; arithmetic per cell is a handful of integer ops.
//
// Design: one block per lane, one thread per band cell (W = 128).  The
// band is double-buffered in shared memory; the horizontal closure is a
// warp shuffle prefix-min plus one shared word per warp.  Each cell
// writes its move code (bits 0-1 move, 2-3 read char, 4 mismatch) to a
// (N, T, W) global scratch buffer.  After the forward pass one thread
// per lane walks the path and writes the lane's outputs in order: a lane
// is written by one thread only, so the JAX scatter-min / max / add
// reductions become plain read-modify-writes and no atomics are needed
// (CUDA has no int8 atomics).  Lanes run in parallel across the SMs.
//
// K2p, the packed mode (kPacked), replaces _nw_round_packed
// (consensus.py:491) and the 2-bit input of _nw_window_round (:887): a
// lane's [template T | read RL | band-center steps T] arrive as one 2-bit
// packed row and meta holds t_lens, read_lens and the first band center
// as rows.  Every thread decodes its characters through pack2.cuh and
// rebuilds the band centers as the running sum of the steps, row by row;
// thread 0 also stores them in a per-lane scratch row for its traceback.
//
// K2r, the resident window mode (kResident), replaces
// consensus.py:_window_resident_inputs (945) together with the DP of
// _nw_window_round_resident (1009) and _nw_window_round_resident_dense
// (972): a windowed lane arrives as five int32 coordinates (meta rows
// t_lens, seg_lens, loc0, tpl_start, seg_start) and every thread reads
// its characters straight from the device store, tpl[k] = store[tpl_start
// + k] (0 past t_len) and seg[k] = store[seg_start + k] (0 past seg_len),
// with the starts clamped into the store as JAX's dynamic_slice clamps
// them.  The band centers are JAX's proportional schedule, rebuilt row by
// row as c(0) = 0, c(i) = c(i-1) + clip(p(i) - p(i-1), 0, 2) with p(r) =
// min(r, t) * seg_len / t and t = max(t_len, 1); thread 0 stores them for
// the traceback and for K4w, which packs the result rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pack2.cuh"

namespace {

constexpr int kInf = 1 << 28;
constexpr int kDiag = 0, kUp = 1, kLeft = 2, kNone = 3;

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

// kStore: tpl (N, T), t_lens (N,), reads (N, RL), read_lens (N,) and
// centers (N, T+1) as given.  kPacked: tpl is the (N, (2T + RL)/4) packed
// rows, t_lens the (3 | 4, N) meta rows, reads and read_lens unused,
// centers a scratch row per lane that the kernel fills.  kResident: tpl
// is the store of store_len bytes, t_lens the (5, N) meta rows, reads and
// read_lens unused, centers a scratch row per lane that the kernel fills.
template <int kMode>
__global__ void nw_round_kernel(
    const uint8_t* __restrict__ tpl,
    const int* __restrict__ t_lens,
    const uint8_t* __restrict__ reads,
    const int* __restrict__ read_lens,
    int* __restrict__ centers,
    uint8_t* __restrict__ moves,          // (N, T, W) scratch
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
  extern __shared__ int sh[];
  int* dbuf = sh;               // 2 * W
  int* wmin = sh + 2 * W;       // W / 32
  int* best = wmin + W / 32;    // [0] least end cost, [1] its row

  const int n = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int rl = kFromMeta ? t_lens[N + n] : read_lens[n];
  const int tl = t_lens[n];
  const int rl_clip = max(rl - W / 2, 0);
  int* cen = centers + (size_t)n * (T + 1);
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
  uint8_t* mv_lane = moves + (size_t)n * T * W;

  auto off_from = [&](int c) { return min(max(c - W / 2, -(W / 2)), rl_clip); };
  auto t_char = [&](int k) {
    if constexpr (kMode == kPacked) return code2(row, k);
    else if constexpr (kMode == kResident) return k < tl ? t_res[k] & 3 : 0;
    else return tp[k] & 3;
  };
  auto r_char = [&](int k) {
    if constexpr (kMode == kPacked) return code2(row, T + k);
    else if constexpr (kMode == kResident) return k < rl ? s_res[k] & 3 : 0;
    else return rd[k] & 3;
  };
  // kResident: the proportional schedule p(r) = min(r, t) * seg_len / t
  auto prop = [&](int r) { return min(r, tl1) * rl / tl1; };

  int c_run = kMode == kPacked ? t_lens[2 * N + n]
              : kMode == kResident ? 0 : cen[0];
  if (kFromMeta && p == 0) cen[0] = c_run;
  int off_prev = off_from(c_run);
  {
    const int j0 = off_prev + p;
    const int d_init = lead_free < 0 ? 0 : max(j0 - lead_free, 0);
    dbuf[p] = (j0 >= 0 && j0 <= rl) ? d_init : kInf;
  }
  if (p == 0) {
    best[0] = kInf;
    best[1] = 0;
  }
  __syncthreads();

  for (int i = 1; i <= T; ++i) {
    const int* dprev = dbuf + ((i - 1) & 1) * W;
    int* dcur = dbuf + (i & 1) * W;
    if constexpr (kMode == kPacked) {
      c_run += code2(row, T + RL + i - 1);
      if (p == 0) cen[i] = c_run;  // read back by this thread's traceback
    } else if constexpr (kMode == kResident) {
      c_run += clampi(prop(i) - prop(i - 1), 0, 2);
      if (p == 0) cen[i] = c_run;
    } else {
      c_run = cen[i];
    }
    const int off = off_from(c_run);
    const int s = off - off_prev;
    off_prev = off;
    const int ei = p + s;
    const int E = (ei >= 0 && ei < W) ? dprev[ei] : kInf;
    const int E1 = (ei - 1 >= 0 && ei - 1 < W) ? dprev[ei - 1] : kInf;

    const int t_ch = t_char(i - 1);
    const int r_ch = r_char(clampi(off - 1 + p, 0, RL - 1));
    const int j = off + p;
    const int sub = r_ch != t_ch;
    const int diag = j >= 1 ? E1 + sub : kInf;
    int up = E + 1;
    if (j == 0) up = min(up, 0);
    const int tmp = min(diag, up);
    const bool choose_up = up < diag;

    int x = tmp - p;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x = min(x, y);
    }
    if (lane == 31) wmin[warp] = x;
    __syncthreads();
    for (int w = 0; w < warp; ++w) x = min(x, wmin[w]);
    const int D = x + p;
    const bool from_left = D < tmp;
    const bool valid = j >= 0 && j <= rl && i <= tl;
    const int Dn = valid ? min(D, kInf) : kInf;
    int move = from_left ? kLeft : (choose_up ? kUp : kDiag);
    move |= (r_ch << 2) | (sub << 4);
    mv_lane[(size_t)(i - 1) * W + p] = (uint8_t)(valid ? move : kNone);
    if (valid && j == rl && Dn < best[0]) {  // first row wins ties
      best[0] = Dn;
      best[1] = i;
    }
    dcur[p] = Dn;
    __syncthreads();
  }

  // outputs start at their reduction identities
  for (int c = p; c < T; c += W) sym[(size_t)n * T + c] = 5;
  for (int c = p; c < 4 * (T + 1); c += W) ins[(size_t)n * 4 * (T + 1) + c] = 0;
  for (int c = p; c <= T; c += W) jpath[(size_t)n * (T + 1) + c] = -1;
  for (int c = p; c < NWIN; c += W) win[(size_t)n * NWIN + c] = 0;
  __syncthreads();
  if (p != 0) return;

  int8_t* sy = sym + (size_t)n * T;
  int8_t* in = ins + (size_t)n * 4 * (T + 1);
  int* jp = jpath + (size_t)n * (T + 1);
  int* wi = win + (size_t)n * NWIN;
  const int dmin = best[0];
  const bool cov = dmin < kInf;
  const int i0 = cov ? best[1] : 0;
  const int j_start = cov ? rl : 0;
  if (cov) {
    int b = clampi(i0, 0, T);
    jp[b] = max(jp[b], j_start);
  }
  int i = i0, j = j_start, run = 0;
  bool active = cov && i0 > 0 && j_start > 0;
  for (int step = 0; step < S && active; ++step) {
    const int off = off_from(cen[clampi(i, 0, T)]);
    const int pp = j - off;
    int mv_raw = kNone;
    if (pp >= 0 && pp < W && i >= 1)
      mv_raw = mv_lane[(size_t)clampi(i - 1, 0, T - 1) * W + pp];
    const int mv = mv_raw & 3;
    const int base = (mv_raw >> 2) & 3;
    if (mv == kDiag || mv == kUp) {
      const int c = clampi(i - 1, 0, T - 1);
      const int val = mv == kDiag ? base : 4;
      if (val < sy[c]) sy[c] = (int8_t)val;
      const int b = clampi(i - 1, 0, T);
      jp[b] = max(jp[b], j - (mv == kDiag));
    } else if (mv == kLeft && run < 4) {
      int8_t* slot = in + clampi(i, 0, T) * 4 + run;
      if (base + 1 > *slot) *slot = (int8_t)(base + 1);
    }
    const bool mism = mv == kDiag && ((mv_raw >> 4) & 1);
    if (mism || mv == kUp || mv == kLeft) {
      const int w = floordiv(mv == kLeft ? min(i, tl - 1) : i - 1, trace);
      wi[clampi(w, 0, NWIN - 1)] += 1;
    }
    const int i2 = i - (mv == kDiag || mv == kUp);
    const int j2 = j - (mv == kDiag || mv == kLeft);
    run = mv == kLeft ? run + 1 : 0;
    active = mv != kNone && i2 > 0 && j2 > 0;
    i = i2;
    j = j2;
  }
  spans[2 * n] = cov ? i : 0;
  spans[2 * n + 1] = cov ? i0 : 0;
  diffs[n] = cov ? dmin : 0;
  covered[n] = cov;
}

}  // namespace

extern "C" int dentist_nw_round(
    const void* tpl, const void* t_lens, const void* reads,
    const void* read_lens, const void* centers, void* moves, void* sym,
    void* ins, void* jpath, void* spans, void* diffs, void* win,
    void* covered, int N, int T, int RL, int W, int S, int NWIN,
    int lead_free, int trace, void* stream) {
  const size_t smem = (2 * W + W / 32 + 2) * sizeof(int);
  nw_round_kernel<kStore><<<N, W, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)tpl, (const int*)t_lens, (const uint8_t*)reads,
      (const int*)read_lens, (int*)centers, (uint8_t*)moves,
      (int8_t*)sym, (int8_t*)ins, (int*)jpath, (int*)spans, (int*)diffs,
      (int*)win, (bool*)covered, N, T, RL, W, S, NWIN, lead_free, trace, 0);
  return (int)cudaGetLastError();
}

// K2p: chars (N, (2T + RL) / 4) packed rows, meta (3 | 4, N) with rows
// t_lens, read_lens, first band center; centers (N, T+1) int32 scratch
extern "C" int dentist_nw_round_packed(
    const void* chars, const void* meta, void* centers, void* moves,
    void* sym, void* ins, void* jpath, void* spans, void* diffs, void* win,
    void* covered, int N, int T, int RL, int W, int S, int NWIN,
    int lead_free, int trace, void* stream) {
  const size_t smem = (2 * W + W / 32 + 2) * sizeof(int);
  nw_round_kernel<kPacked><<<N, W, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (const int*)meta, nullptr, nullptr,
      (int*)centers, (uint8_t*)moves, (int8_t*)sym, (int8_t*)ins,
      (int*)jpath, (int*)spans, (int*)diffs, (int*)win, (bool*)covered, N,
      T, RL, W, S, NWIN, lead_free, trace, 0);
  return (int)cudaGetLastError();
}

// K2r: store (store_len,) uint8, meta (5, N) with rows t_lens, seg_lens,
// loc0, tpl_start, seg_start; centers (N, T+1) int32 scratch, kept for K4w
extern "C" int dentist_nw_round_resident(
    const void* store, const void* meta, void* centers, void* moves,
    void* sym, void* ins, void* jpath, void* spans, void* diffs, void* win,
    void* covered, int store_len, int N, int T, int RL, int W, int S,
    int NWIN, int lead_free, int trace, void* stream) {
  const size_t smem = (2 * W + W / 32 + 2) * sizeof(int);
  nw_round_kernel<kResident><<<N, W, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)store, (const int*)meta, nullptr, nullptr,
      (int*)centers, (uint8_t*)moves, (int8_t*)sym, (int8_t*)ins,
      (int*)jpath, (int*)spans, (int*)diffs, (int*)win, (bool*)covered, N,
      T, RL, W, S, NWIN, lead_free, trace, store_len);
  return (int)cudaGetLastError();
}
