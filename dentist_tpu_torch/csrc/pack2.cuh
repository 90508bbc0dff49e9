// The 2-bit decode shared by the packed modes of K1, K2 and K4 (K3p
// decodes 16 codes at a time into bit planes: nw_dist.cu:codes16).
//
// Replaces dentist_tpu/ops/banded.py:_unpack2bit, which unpacks a whole
// (N, X/4) block into an (N, X) array before the DP runs.  Here each
// thread decodes only the characters it reads, at load time (K2, K4) or
// when it stages them (K1), so the unpacked array never exists: four
// codes per byte, the first in the high bits (the Dazzler Compress_Read
// order), as dentist_tpu_torch/ops/pack2.py:pack2bit writes them.

#pragma once

#include <stdint.h>

// code i of a packed row, from the row's byte i >> 2
__device__ __forceinline__ int code2_of(int byte, long long i) {
  return (byte >> (6 - 2 * (int)(i & 3))) & 3;
}

// code i of the packed row p: (p[i >> 2] >> (6 - 2 (i & 3))) & 3
__device__ __forceinline__ int code2(const uint8_t* __restrict__ p,
                                     long long i) {
  return code2_of(p[i >> 2], i);
}
