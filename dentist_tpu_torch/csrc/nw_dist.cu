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

#include <cuda_runtime.h>
#include <stdint.h>

#include "pack2.cuh"

namespace {

constexpr int kInf = 1 << 28;
constexpr int kRwMax = 127;

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
