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
// per column.
//
// Design: one warp per lane, 32 columns per step.  Events are compacted
// in column order with a warp ballot: an event's slot is the running
// count plus the population count of the ballot below its lane, so the
// slots match JAX's cumulative-sum scatter; a ballot word is also 32 bits
// of JAX's little-endian bitmask.  2-bit codes of four slots share a byte,
// so they are OR-ed into words of the (zeroed) output row with atomicOr;
// those words hold nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pack2.cuh"

namespace {

constexpr int kCapE = 16;                 // _CAP_E
constexpr int kAdv = 126;                 // _ADV
constexpr int kWCapS = 32, kWCapI = 24, kWCapE = 4;
constexpr int kWRowSparse = 42, kWRowDense = 112;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ unsigned lanes_below(int l) {
  return (1u << l) - 1u;
}

// the 12-bit slot pack of boundary b: ins[b, 0] | ins[b, 1] << 3 | ...
__device__ __forceinline__ int ins16_of(const int8_t* in, int b) {
  const int8_t* s = in + 4 * b;
  return ((uint16_t)s[0] | ((uint16_t)s[1] << 3) | ((uint16_t)s[2] << 6) |
          ((uint16_t)s[3] << 9)) & 0xFFFF;
}

// OR a 2-bit code (JAX: the slot's u8 code shifted into its byte, the
// byte truncated to 8 bits) into code byte idx of the region at `words`
__device__ __forceinline__ void or_code(int* words, int idx, int code) {
  const int byte_val = ((code & 0xFF) << (2 * (idx & 3))) & 0xFF;
  atomicOr(words + (idx >> 4), byte_val << (8 * ((idx >> 2) & 3)));
}

template <bool kSparse>
__global__ void round_pack_kernel(
    const uint8_t* __restrict__ chars, const int8_t* __restrict__ sym,
    const int8_t* __restrict__ ins, const int* __restrict__ jpath,
    const int* __restrict__ spans, const int* __restrict__ diffs,
    const int* __restrict__ win, const bool* __restrict__ covered,
    const int* __restrict__ centers, int* __restrict__ out, int N, int T,
    int RL, int NWIN, int words) {
  const int n = blockIdx.x;
  const int l = threadIdx.x;
  int* o = out + (size_t)n * words;
  uint8_t* ob = reinterpret_cast<uint8_t*>(o);
  for (int w = l; w < words; w += 32) o[w] = 0;
  __syncwarp();
  const int8_t* sy = sym + (size_t)n * T;
  const int8_t* in = ins + (size_t)n * 4 * (T + 1);
  const int* jp = jpath + (size_t)n * (T + 1);
  const bool cov = covered[n];
  const int s0 = spans[2 * n], s1 = spans[2 * n + 1];

  if constexpr (!kSparse) {
    const int* cen = centers + (size_t)n * (T + 1);
    for (int i = l; i < T / 2; i += 32)
      ob[i] = (uint8_t)((((uint8_t)sy[2 * i]) << 4) | (uint8_t)sy[2 * i + 1]);
    uint16_t* i16 = reinterpret_cast<uint16_t*>(ob + T / 2);
    int16_t* j16 = reinterpret_cast<int16_t*>(ob + T / 2 + 2 * (T + 2));
    for (int b = l; b < T + 2; b += 32) {
      i16[b] = b <= T ? (uint16_t)ins16_of(in, b) : 0;
      j16[b] = (b <= T && jp[b] >= 0) ? (int16_t)(jp[b] - cen[b])
                                        : (int16_t)-32768;
    }
    int* tail = o + T / 8 + (T + 2);
    for (int k = l; k < NWIN; k += 32) tail[3 + k] = win[(size_t)n * NWIN + k];
    if (l == 0) {
      tail[0] = s0;
      tail[1] = s1;
      tail[2] = diffs[n];
      tail[3 + NWIN] = cov;
    }
    return;
  }

  const int cap_s = 3 * T / 16, cap_i = 3 * T / 16;
  const int off_esc = T / 2;
  const int off_sm = off_esc + 2 * kCapE;
  const int off_sc = off_sm + T / 8;
  const int off_im = off_sc + 3 * T / 64;
  const int off_iv = off_im + T / 8 + 4;
  const int nbytes = off_iv + 2 * cap_i;
  const uint8_t* tp = chars + (size_t)n * ((2 * T + RL) / 4);
  const unsigned below = lanes_below(l);
  int run_s = 0, run_e = 0, run_i = 0;
  for (int base = 0; base < T; base += 32) {
    const int c = base + l;
    const bool in_span = c >= s0 && c < s1 && cov;
    const int sv = sy[c], tv = code2(tp, c);
    // divergence events and their rank codes
    const bool ev = in_span && sv != tv;
    const unsigned m = __ballot_sync(0xffffffffu, ev);
    const int idx = run_s + __popc(m & below);
    if (ev && idx < cap_s)
      or_code(reinterpret_cast<int*>(ob + off_sc), idx, sv - (sv > tv));
    if (l == 0) *reinterpret_cast<unsigned*>(ob + off_sm + base / 8) = m;
    run_s += __popc(m);
    // jpath deltas, masked to the span; escapes past 14
    const int d = in_span ? jp[c + 1] - jp[c] : 0;
    const bool esc = d > 14;
    const int nib = esc ? 15 : d;
    const int nib_hi = __shfl_down_sync(0xffffffffu, nib, 1);
    if (!(l & 1)) ob[c / 2] = (uint8_t)(nib | (nib_hi << 4));
    const unsigned me = __ballot_sync(0xffffffffu, esc);
    const int eidx = run_e + __popc(me & below);
    if (esc && eidx < kCapE)
      reinterpret_cast<uint16_t*>(ob + off_esc)[eidx] =
          (uint16_t)clampi(d, 0, 65535);
    run_e += __popc(me);
  }
  // insertion boundaries 0..T, the bitmask padded to T + 32 columns
  for (int base = 0; base <= T; base += 32) {
    const int b = base + l;
    const int v = b <= T ? ins16_of(in, b) : 0;
    const bool iev = v != 0;
    const unsigned mi = __ballot_sync(0xffffffffu, iev);
    const int iidx = run_i + __popc(mi & below);
    if (iev && iidx < cap_i)
      reinterpret_cast<uint16_t*>(ob + off_iv)[iidx] = (uint16_t)v;
    if (l == 0) *reinterpret_cast<unsigned*>(ob + off_im + base / 8) = mi;
    run_i += __popc(mi);
  }
  if (l == 0) {
    int* misc = o + nbytes / 4;
    misc[0] = jp[clampi(s0, 0, T)];
    misc[1] = s0;
    misc[2] = s1;
    misc[3] = diffs[n];
    misc[4] = cov;
    misc[5] = run_s > cap_s || run_i > cap_i || run_e > kCapE;
  }
  for (int k = l; k < NWIN; k += 32)
    o[nbytes / 4 + 6 + k] = win[(size_t)n * NWIN + k];
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
__global__ void window_pack_kernel(
    const uint8_t* __restrict__ tsrc, const int* __restrict__ meta,
    const int8_t* __restrict__ sym, const int8_t* __restrict__ ins,
    const int* __restrict__ jpath, const int* __restrict__ centers,
    int* __restrict__ out, int store_len, int N, int T, int RL) {
  const int n = blockIdx.x;
  const int l = threadIdx.x;
  const int words = kSparse ? kWRowSparse : kWRowDense;
  int* o = out + (size_t)n * words;
  uint8_t* ob = reinterpret_cast<uint8_t*>(o);
  for (int w = l; w < words; w += 32) o[w] = 0;
  __syncwarp();
  const int loc0 = meta[(kResident ? 2 : 3) * N + n];
  const int8_t* sy = sym + (size_t)n * T + loc0;
  const int8_t* in = ins + (size_t)n * 4 * (T + 1) + 4 * loc0;
  const int* jp = jpath + (size_t)n * (T + 1) + loc0;

  if constexpr (!kSparse) {
    const int* cen = centers + (size_t)n * (T + 1) + loc0;
    for (int k = l; k < kAdv / 2; k += 32)
      ob[k] = (uint8_t)((((uint8_t)sy[2 * k]) << 4) | (uint8_t)sy[2 * k + 1]);
    uint16_t* i16 = reinterpret_cast<uint16_t*>(ob + 64);
    for (int b = l; b <= kAdv; b += 32) {
      i16[b] = (uint16_t)ins16_of(in, b);
      ob[64 + 2 * (kAdv + 1) + b] =
          jp[b] >= 0 ? (uint8_t)clampi(jp[b] - cen[b] + 64, 0, 254) : 255;
    }
    if (l == 0) ob[64 + 3 * (kAdv + 1)] = 255;
    return;
  }

  // the template at interior column c
  const int tl = kResident ? meta[n] : 0;
  const uint8_t* t_res = nullptr;
  const uint8_t* t_row = nullptr;
  if constexpr (kResident)
    t_res = tsrc + clampi(meta[3 * N + n], 0, store_len - T);
  else
    t_row = tsrc + (size_t)n * ((2 * T + RL) / 4);
  auto tpl_at = [&](int col) {
    if constexpr (kResident) return col < tl ? (int)(t_res[col] & 3) : 0;
    else return code2(t_row, col);
  };

  // covered interior columns and valid boundaries are contiguous runs
  Ends cc, bb;
  for (int base = 0; base < 128; base += 32) {
    const int c = base + l;
    cc.add(__ballot_sync(0xffffffffu, c < kAdv && sy[c] != 5), base);
    bb.add(__ballot_sync(0xffffffffu, c <= kAdv && jp[c] >= 0), base);
  }
  const bool any_b = bb.first >= 0;
  const int s0c = cc.first >= 0 ? cc.first : 0;
  const int s1c = cc.first >= 0 ? cc.last + 1 : 0;
  const int s0b = any_b ? bb.first : 0;
  const int s1b = any_b ? bb.last : 0;
  const int base_j = any_b ? clampi(jp[s0b], 0, 65535) : 0;

  const unsigned below = lanes_below(l);
  int run_s = 0, run_i = 0, run_e = 0;
  for (int base = 0; base < 128; base += 32) {
    const int c = base + l;
    const bool col = c < kAdv;
    const int sv = col ? sy[c] : 5;
    const int tv = col ? tpl_at(loc0 + c) : 0;
    const bool ev = col && sv != 5 && sv != tv;
    const unsigned m = __ballot_sync(0xffffffffu, ev);
    const int idx = run_s + __popc(m & below);
    if (ev && idx < kWCapS)
      or_code(reinterpret_cast<int*>(ob + 92), idx, sv - (sv > tv));
    if (l == 0) *reinterpret_cast<unsigned*>(ob + 76 + base / 8) = m;
    run_s += __popc(m);

    const int v = c <= kAdv ? ins16_of(in, c) : 0;
    const bool iev = v != 0;
    const unsigned mi = __ballot_sync(0xffffffffu, iev);
    const int iidx = run_i + __popc(mi & below);
    if (iev && iidx < kWCapI)
      reinterpret_cast<uint16_t*>(ob + 118)[iidx] = (uint16_t)v;
    if (l == 0)
      for (int k = 0; k < 4; ++k) ob[102 + base / 8 + k] = (mi >> (8 * k)) & 0xFF;
    run_i += __popc(mi);

    const bool jd_in = col && c >= s0b && c < s1b && any_b;
    const int d = jd_in ? jp[c + 1] - jp[c] : 0;
    const bool esc = d > 14;
    const int nib = esc ? 15 : d;
    const int nib_hi = __shfl_down_sync(0xffffffffu, nib, 1);
    if (col && !(l & 1)) ob[c / 2] = (uint8_t)(nib | (nib_hi << 4));
    const unsigned me = __ballot_sync(0xffffffffu, esc);
    const int eidx = run_e + __popc(me & below);
    if (esc && eidx < kWCapE)
      reinterpret_cast<uint16_t*>(ob + 64)[eidx] = (uint16_t)clampi(d, 0, 65535);
    run_e += __popc(me);
  }
  if (l == 0) {
    ob[72] = (uint8_t)s0b;
    ob[73] = (uint8_t)s1b;
    ob[74] = (uint8_t)(base_j & 0xFF);
    ob[75] = (uint8_t)(base_j >> 8);
    ob[100] = (uint8_t)s0c;
    ob[101] = (uint8_t)s1c;
    ob[166] = run_s > kWCapS || run_i > kWCapI || run_e > kWCapE;
    ob[167] = any_b;
  }
}

}  // namespace

// K4: chars (N, (2T + RL) / 4) K2p's packed rows (the template, sparse
// mode), K2p's fields, centers (N, T+1) (dense mode); out (N, words) int32
extern "C" int dentist_round_pack(
    const void* chars, const void* sym, const void* ins, const void* jpath,
    const void* spans, const void* diffs, const void* win,
    const void* covered, const void* centers, void* out, int N, int T,
    int RL, int NWIN, int words, int sparse, void* stream) {
  auto k = sparse ? &round_pack_kernel<true> : &round_pack_kernel<false>;
  k<<<N, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)chars, (const int8_t*)sym, (const int8_t*)ins,
      (const int*)jpath, (const int*)spans, (const int*)diffs,
      (const int*)win, (const bool*)covered, (const int*)centers, (int*)out,
      N, T, RL, NWIN, words);
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
  k<<<N, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)tsrc, (const int*)meta, (const int8_t*)sym,
      (const int8_t*)ins, (const int*)jpath, (const int*)centers, (int*)out,
      store_len, N, T, RL);
  return (int)cudaGetLastError();
}
