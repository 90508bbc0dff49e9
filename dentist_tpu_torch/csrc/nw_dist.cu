// K3: exact global edit distance of short (template, read) pairs, the
// consensus polish scorer.
//
// Replaces dentist_tpu/ops/consensus.py:_nw_dist_full(global_ends=True)
// as called by _nw_dist_pair_packed: every candidate edit v carries a base
// window and an edited window (<= TW = 34 template chars) and NB read
// segments (<= RW = 48 chars); both windows are scored against every
// segment, giving (2, V, NB) distances.
//
// What bounds it on the card: arithmetic and occupancy, not bytes.  A pair
// is TW x (RW + 1) cells of a few integer ops on ~100 input bytes, and a
// dispatch holds up to 2 x 4096 x 128 = 1 M pairs.
//
// Design: one thread per pair.  The thread keeps its DP row in local
// memory and walks each template row left to right, so the horizontal
// closure D[j] = min(tmp[j], D[j-1] + 1) is a running minimum and needs no
// scan or shuffle; rows past the template length cannot change the
// result, so the loop stops there.  Neighbouring threads score the same
// candidate against neighbouring segments, so they share the template
// window through the cache.  Reads up to 127 chars are accepted.
//
// K3p, the packed mode (kPacked), replaces _nw_dist_pair_packed
// (consensus.py:2065) with its _unpack2bit: a candidate's [base window |
// edited window | NB read segments] arrive as one 2-bit packed row, and
// each thread decodes its template and read characters through
// pack2.cuh.  The DP is the same code.
//
// K3f (nw_dist_full_kernel) and K3b (banded_nw_dist_kernel) are the two
// other scorer modes of the JAX package, on its general layout: templates
// (V, T), reads (V, N, RL), one template against its own N reads, either
// end mode (kGlobal: both ends anchored; else free-shift: the read may
// start and end anywhere in the template and the template anywhere in the
// read, at no cost).  No path of the JAX package calls them; they are
// held against their plain versions only.
// - K3f replaces consensus.py:_nw_dist_full, both end modes: K3's
//   one-thread-per-pair full-width row, RL <= 127.
// - K3b replaces consensus.py:_banded_nw_dist: one thread per pair keeps
//   a W-cell band (W <= 256) of its row in local memory; the band of row
//   i starts at read column off(i) = clip(i * rl / t_len - W/2, ...), so
//   a row reads the previous one shifted by s = off(i) - off(i-1) >= 0.
//   Walking the band left to right in place, cell p reads the old cells
//   p + s (up) and p + s - 1 (diagonal): the first is not yet overwritten
//   because s >= 0, and the second is the first of cell p - 1, carried in
//   a register.  Any read length is accepted; reads are read from device
//   memory cell by cell.
// Both are bound by arithmetic, as K3: a few integer ops per DP cell on a
// few bytes per row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pack2.cuh"

namespace {

constexpr int kInf = 1 << 28;
constexpr int kRwMax = 127;
constexpr int kBandMax = 256;

template <bool kPacked>
__global__ void nw_dist_kernel(const uint8_t* __restrict__ buf,  // (V, L | L/4)
                               const int* __restrict__ meta,     // (V, 2+NB)
                               int* __restrict__ out,            // (2, V, NB)
                               int V, int TW, int TWp, int RW, int NB) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = 2LL * V * NB;
  if (g >= total) return;
  const int half = (int)(g / ((long long)V * NB));
  const int v = (int)((g / NB) % V);
  const int nb = (int)(g % NB);
  const int L = 2 * TWp + NB * RW;
  const uint8_t* row = buf + (size_t)v * (kPacked ? L / 4 : L);
  const int t0 = half * TWp;              // template offset in the row
  const int r0 = 2 * TWp + nb * RW;       // read segment offset in the row
  auto ch = [&](int k) {
    if constexpr (kPacked) return code2(row, k);
    else return row[k] & 3;
  };
  const int tl = meta[(size_t)v * (2 + NB) + half];
  const int rl = meta[(size_t)v * (2 + NB) + 2 + nb];

  uint8_t r[kRwMax];
  int D[kRwMax + 1];
  for (int j = 0; j < RW; ++j) r[j] = (uint8_t)ch(r0 + j);
  for (int j = 0; j <= RW; ++j) D[j] = j <= rl ? j : kInf;

  int best = kInf;
  const int rows = tl < TW ? tl : TW;
  for (int i = 1; i <= rows; ++i) {
    const int t_ch = ch(t0 + i - 1);
    int old_left = kInf;  // D of the previous row at j - 1
    int run = kInf;       // min over q <= j of tmp[q] - q
    for (int j = 0; j <= RW; ++j) {
      const int old = D[j];
      const int diag = j >= 1 ? old_left + (r[j - 1] != t_ch) : kInf;
      int tmp = min(diag, old + 1);
      const bool ok = j <= rl;
      if (!ok) tmp = kInf;
      run = min(run, tmp - j);
      D[j] = ok ? min(min(tmp, run + j), kInf) : kInf;
      old_left = old;
    }
    if (i == tl && rl >= 0 && rl <= RW) best = min(best, D[rl]);
  }
  out[g] = best;
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

// K3b: templates (V, T), reads (V, N, RL) -> out (V, N), band width W
template <bool kGlobal>
__global__ void banded_nw_dist_kernel(const uint8_t* __restrict__ tpl,
                                      const int* __restrict__ t_lens,
                                      const uint8_t* __restrict__ reads,
                                      const int* __restrict__ read_lens,
                                      int* __restrict__ out, int V, int N,
                                      int T, int RL, int W) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)V * N) return;
  const int v = (int)(g / N);
  const uint8_t* t = tpl + (size_t)v * T;
  const uint8_t* rd = reads + (size_t)g * RL;
  const int tl = t_lens[v];
  const int rl = read_lens[g];

  int D[kBandMax];
  int off_prev = band_off(0, tl, rl, W);
  for (int p = 0; p < W; ++p) {
    const int j = off_prev + p;
    D[p] = (j >= 0 && j <= rl) ? (kGlobal ? j : 0) : kInf;
  }

  int best = kInf;
  const int rows = tl < T ? tl : T;  // rows past t_len are all INF
  for (int i = 1; i <= rows; ++i) {
    const int off = band_off(i, tl, rl, W);
    const int s = off - off_prev;  // >= 0: off is nondecreasing in i
    const int t_ch = t[i - 1];
    // the previous row at p + s - 1, for p = 0; later the last "up" read
    int e_left = (s >= 1 && s - 1 < W) ? D[s - 1] : kInf;
    int run = kInf, row_min = kInf, at_end = kInf;
    for (int p = 0; p < W; ++p) {
      const int q = p + s;
      const int e = (q >= 0 && q < W) ? D[q] : kInf;
      const int j = off + p;
      const int r_ch = rd[min(max(j - 1, 0), RL - 1)];
      const int diag = j >= 1 ? e_left + (r_ch != t_ch) : kInf;
      int up = e + 1;
      if (!kGlobal && j == 0) up = min(up, 0);
      run = min(run, min(diag, up) - p);
      const int d = (j >= 0 && j <= rl) ? min(run + p, kInf) : kInf;
      D[p] = d;
      e_left = e;
      row_min = min(row_min, d);
      if (j == rl) at_end = d;
    }
    off_prev = off;
    if (!kGlobal || i == tl) best = min(best, at_end);
    if (!kGlobal && i == tl) best = min(best, row_min);
  }
  out[g] = best;
}

}  // namespace

extern "C" int dentist_nw_dist(const void* buf, const void* meta, void* out,
                               int V, int TW, int TWp, int RW, int NB,
                               void* stream) {
  const long long total = 2LL * V * NB;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  nw_dist_kernel<false><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int*)meta, (int*)out, V, TW, TWp, RW, NB);
  return (int)cudaGetLastError();
}

// K3p: chars (V, (2 TWp + NB RW) / 4) packed rows
extern "C" int dentist_nw_dist_packed(const void* chars, const void* meta,
                                      void* out, int V, int TW, int TWp,
                                      int RW, int NB, void* stream) {
  const long long total = 2LL * V * NB;
  const int threads = 128;
  const long long blocks = (total + threads - 1) / threads;
  nw_dist_kernel<true><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (const int*)meta, (int*)out, V, TW, TWp, RW, NB);
  return (int)cudaGetLastError();
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
  const long long total = (long long)V * N;
  const int threads = 128;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  auto k = global_ends ? banded_nw_dist_kernel<true>
                       : banded_nw_dist_kernel<false>;
  k<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tpl, (const int*)t_lens, (const uint8_t*)reads,
      (const int*)read_lens, (int*)out, V, N, T, RL, W);
  return (int)cudaGetLastError();
}
