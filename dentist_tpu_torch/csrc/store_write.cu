// K5: a 2-bit packed upload into the device sequence store.
//
// Replaces dentist_tpu/ops/banded.py:_arena_write_chunk (448):
// store[off + i] = (packed[i >> 2] >> (6 - 2 (i & 3))) & 3 for the n
// characters of an upload.  The host packs a store with ops/pack2.pack2bit
// and only the packed bytes cross to the card.  JAX wrote an upload in
// chunks of _ARENA_CHUNK = 4 Mi characters, one program call each (a 1-D
// unpack: a (X, 4) intermediate is tile-padded 32x on the TPU), the last
// chunk's tail writing zeros over store bytes that were already zero; here
// one launch writes the upload's own n characters and no tail.
//
// What bounds it on the card: bytes, one read per packed byte and four
// written.  The JAX version copied the whole arena per chunk (its arrays
// are immutable); here the store is written in place, on the stream that
// every kernel reading the store runs on, so a kernel launched before the
// write reads the store as it was.
//
// Design: a grid-stride loop over 16-character groups, sized from the SM
// count.  A thread reads a group's 4 packed bytes as one 32-bit load
// (adjacent lanes on adjacent words) and spreads them into 16 characters,
// written as one 16-byte store where the destination is 16-byte aligned
// (every upload of the main path: the store starts aligned, RESIDENT_PAD
// and the length buckets are multiples of 16), and byte by byte elsewhere;
// the branch is the same for the whole grid.  The last n % 16 characters
// (n is a multiple of 4) are written by one thread, its up to 3 packed
// bytes loaded together.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the four characters of packed byte x, the first in the low byte (the
// lowest address)
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return ((x >> 6) & 3u) | (((x >> 4) & 3u) << 8) | (((x >> 2) & 3u) << 16) |
         ((x & 3u) << 24);
}

__device__ __forceinline__ void put4(uint8_t* dst, uint32_t w, bool aligned) {
  if (aligned) {
    *reinterpret_cast<uint32_t*>(dst) = w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[q] = (uint8_t)(w >> (8 * q));
  }
}

// aligned: store + off on 16 bytes and packed on 4
__global__ void store_write_kernel(const uint8_t* __restrict__ packed,
                                   uint8_t* __restrict__ store, int off, int n,
                                   bool aligned) {
  const int groups = n >> 4;
  const int stride = gridDim.x * blockDim.x;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  uint8_t* dst = store + off;
  for (int g = gid; g < groups; g += stride) {
    uint32_t x;
    if (aligned) {
      x = __ldg(reinterpret_cast<const uint32_t*>(packed) + g);
    } else {
      const uint8_t* p = packed + 4 * g;
      x = __ldg(p) | (__ldg(p + 1) << 8) | (__ldg(p + 2) << 16) |
          ((uint32_t)__ldg(p + 3) << 24);
    }
    const uint4 w = make_uint4(spread4(x & 0xffu), spread4((x >> 8) & 0xffu),
                               spread4((x >> 16) & 0xffu), spread4(x >> 24));
    uint8_t* d = dst + 16 * g;
    if (aligned) {
      *reinterpret_cast<uint4*>(d) = w;
    } else {
      put4(d, w.x, false);
      put4(d + 4, w.y, false);
      put4(d + 8, w.z, false);
      put4(d + 12, w.w, false);
    }
  }
  // the last n % 16 characters: up to 3 packed bytes, loaded together by
  // the thread after the last group's (one without a group of its own
  // unless the groups fill the grid's first pass exactly)
  const int tail = (n >> 2) & 3;
  if (tail && gid == groups % stride) {
    uint32_t x[3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
      x[q] = q < tail ? __ldg(packed + 4 * groups + q) : 0u;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      if (q < tail) put4(dst + 16 * groups + 4 * q, spread4(x[q]), aligned);
  }
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return sms;
}

}  // namespace

// packed (n / 4,) uint8; store written at [off, off + n); n % 4 == 0,
// 0 <= n < 2^31
extern "C" int dentist_store_write(const void* packed, void* store, int off,
                                   int n, void* stream) {
  const int threads = 256;
  const long long groups = n >> 4;
  long long blocks = (groups + threads - 1) / threads;
  // one pass covers 128 CTAs an SM (69 M characters on 132 SMs): with a
  // tighter cap the main path's largest upload (60 M characters) loops,
  // and runs slower
  const long long cap = 128LL * sm_count();
  blocks = blocks < 1 ? 1 : blocks > cap ? cap : blocks;
  const bool aligned = ((uintptr_t)store + (uintptr_t)off) % 16 == 0 &&
                       (uintptr_t)packed % 4 == 0;
  store_write_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (uint8_t*)store, off, n, aligned);
  return (int)cudaGetLastError();
}
