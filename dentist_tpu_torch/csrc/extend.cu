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
// What bounds it on the card: latency.  Each lane is a chain of R rows
// (up to 32256) with two block-wide dependencies per row (the prefix-min
// and the row-best max); the arithmetic per row is tiny and the bytes per
// row are W store characters plus one A character.
//
// Design: one block per lane, one thread per band cell (W = 256 threads).
// The band lives in shared memory, double-buffered across rows.  The
// prefix-min is a warp shuffle scan plus one shared word per warp; the
// row winner is a warp max plus one shared word per warp, so a row costs
// two __syncthreads.  Each thread reads its A and B characters straight
// from the store through the lane's 12 coordinates (reversal, 3 - x
// complement, zero outside [c_lo, c_hi) and past a_len), so the host
// window gather and the TPU's chunked B-window refill disappear.  Lanes
// run in parallel across the SMs; the row loop is the latency chain.
//
// K1p, the packed mode (kPacked), replaces _extend_scan_v3_packed and
// _extend_scan_v3_packed2 (banded.py:249, :519) with their _unpack2bit:
// each lane's host-assembled A window (R chars) and B window (BW chars)
// arrive as one 2-bit packed row, and each thread decodes the characters
// it reads through pack2.cuh; the five per-lane ints are meta5 rows
// b_len, lane_k, a_len, diag_lo, diag_hi.  The DP loop is the same code.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pack2.cuh"

namespace {

constexpr int kInf = 1 << 28;
constexpr int kNeg = -(1 << 30);
constexpr int kDiffPenalty = 6;
constexpr int kTrace = 126;

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

template <bool kPacked>
__global__ void extend_kernel(const uint8_t* __restrict__ store,
                              long long store_len,
                              const int* __restrict__ meta,  // (12 | 5, N)
                              const int* __restrict__ num_k,  // (K,)
                              int N, int R, int W, int BW,
                              int* __restrict__ out) {  // (4 + R/126, N)
  extern __shared__ int sh[];
  int* dbuf = sh;                 // 2 * W
  int* wmin = sh + 2 * W;         // W / 32
  int* wmax = wmin + W / 32;      // W / 32

  const int n = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int nwarp = W >> 5;

  // store mode: 12 coordinates into the store; packed mode: the lane's
  // row of [A window | B window] codes, the whole B window valid
  long long a_start = 0, b_start = 0;
  int a_rev = 0, b_rev = 0, b_flip = 0, c_lo = 0, c_hi = BW;
  int a_len, b_len, num, diag_lo, diag_hi;
  const uint8_t* row = nullptr;
  if constexpr (kPacked) {
    b_len = meta[0 * N + n];
    num = num_k[meta[1 * N + n]];
    a_len = meta[2 * N + n];
    diag_lo = meta[3 * N + n];
    diag_hi = meta[4 * N + n];
    row = store + (size_t)n * ((R + BW) / 4);
  } else {
    a_start = clamp_start(meta[0 * N + n], R, store_len);
    a_rev = meta[1 * N + n];
    a_len = meta[2 * N + n];
    b_start = clamp_start(meta[3 * N + n], BW, store_len);
    b_rev = meta[4 * N + n];
    b_flip = meta[5 * N + n];
    c_lo = meta[6 * N + n];
    c_hi = meta[7 * N + n];
    b_len = meta[8 * N + n];
    num = num_k[meta[9 * N + n]];
    diag_lo = meta[10 * N + n];
    diag_hi = meta[11 * N + n];
  }

  // row 0: j = p - W/2
  int off_prev = -(W / 2);
  {
    int j0 = off_prev + p;
    bool ok0 = j0 >= 0 && j0 <= b_len && j0 >= diag_lo && j0 <= diag_hi;
    dbuf[p] = ok0 ? j0 : kInf;
  }
  int jm = 0, dm = 0, best_s = -kInf, best_r = 0, best_j = 0, best_d = 0;
  __syncthreads();

  // rows past a_len cannot change the result: stop there and repeat the
  // final trace sample in the remaining trace rows
  const int r_end = min(R, max(a_len, 0));
  for (int r = 1; r <= r_end; ++r) {
    const int* dprev = dbuf + ((r - 1) & 1) * W;
    int* dcur = dbuf + (r & 1) * W;
    const int off = (int)(((long long)r * num) / R) - W / 2;
    const int s = off - off_prev;
    off_prev = off;

    const int ei = p + s;
    const int E = ei < W ? dprev[ei] : kInf;
    const int E1 = (ei - 1 >= 0 && ei - 1 < W) ? dprev[ei - 1] : kInf;

    // A character of row r, B character of band cell p
    const int ai = r - 1;  // < a_len inside the loop
    int a_ch;
    if constexpr (kPacked)
      a_ch = code2(row, ai);
    else
      a_ch = store[a_start + (a_rev ? (R - 1 - ai) : ai)];
    const int c = off + p - 1 + W;
    int b_ch = 0;
    if (c >= c_lo && c < c_hi && c >= 0 && c < BW) {
      if constexpr (kPacked) {
        b_ch = code2(row, R + c);
      } else {
        uint8_t v = store[b_start + (b_rev ? (BW - 1 - c) : c)];
        if (b_flip) v = (uint8_t)(3 - v);
        b_ch = v;
      }
    }
    const int sub = a_ch != b_ch;
    const int j = off + p;
    const int diag = j >= 1 ? E1 + sub : kInf;
    int tmp = min(diag, E + 1);
    const bool valid = j >= 0 && j <= b_len && (j - r) >= diag_lo &&
                       (j - r) <= diag_hi;
    if (!valid) tmp = kInf;

    // horizontal closure: prefix-min of tmp - p across the band
    int x = tmp - p;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x = min(x, y);
    }
    if (lane == 31) wmin[warp] = x;
    __syncthreads();
    for (int w = 0; w < warp; ++w) x = min(x, wmin[w]);
    int D = min(tmp, x + p);

    // row winner: first cell maximizing p - 6D
    int key = kNeg;
    if (valid && D < kInf)
      key = (int)(((unsigned)(p - kDiffPenalty * D) << 9) |
                  (unsigned)(W - 1 - p));
    int kmax = __reduce_max_sync(0xffffffffu, key);
    if (lane == 0) wmax[warp] = kmax;
    dcur[p] = valid ? min(D, kInf) : kInf;
    __syncthreads();

    int row_key = wmax[0];
    for (int w = 1; w < nwarp; ++w) row_key = max(row_key, wmax[w]);
    if (row_key != kNeg) {
      const int row_m = row_key >> 9;
      const int row_p = (W - 1) - (row_key & (2 * W - 1));
      const int row_s = r + off + row_m;
      const int row_j = off + row_p;
      const int row_d = floordiv(row_p - row_m, kDiffPenalty);
      jm = max(jm, row_j);
      dm = max(dm, row_d);
      if (row_s > best_s) {
        best_s = row_s;
        best_r = r;
        best_j = jm;
        best_d = dm;
      }
    }
    if (p == 0 && r % kTrace == 0)
      out[(4 + r / kTrace - 1) * N + n] = (jm << 15) | min(dm, (1 << 15) - 1);
  }
  if (p == 0) {
    for (int k = r_end / kTrace + 1; k <= R / kTrace; ++k)
      out[(4 + k - 1) * N + n] = (jm << 15) | min(dm, (1 << 15) - 1);
    out[0 * N + n] = best_r;
    out[1 * N + n] = best_j;
    out[2 * N + n] = best_d;
    out[3 * N + n] = best_s;
  }
}

}  // namespace

extern "C" int dentist_extend(const void* store, const void* meta,
                              const void* num_k, void* out, int store_len,
                              int N, int R, int W, int BW, void* stream) {
  const size_t smem = (2 * W + 2 * (W / 32)) * sizeof(int);
  extend_kernel<false><<<N, W, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)store, store_len, (const int*)meta, (const int*)num_k,
      N, R, W, BW, (int*)out);
  return (int)cudaGetLastError();
}

// K1p: chars (N, (R + BW) / 4) packed rows, meta5 (5, N)
extern "C" int dentist_extend_packed(const void* chars, const void* meta5,
                                     const void* num_k, void* out, int N,
                                     int R, int W, int BW, void* stream) {
  const size_t smem = (2 * W + 2 * (W / 32)) * sizeof(int);
  extend_kernel<true><<<N, W, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (long long)N * ((R + BW) / 4),
      (const int*)meta5, (const int*)num_k, N, R, W, BW, (int*)out);
  return (int)cudaGetLastError();
}
