// K5: one chunk of a 2-bit packed upload into the device sequence store.
//
// Replaces dentist_tpu/ops/banded.py:_arena_write_chunk (448):
// store[off + i] = (packed[i >> 2] >> (6 - 2 (i & 3))) & 3 for the n
// characters of one chunk.  The host packs a store with ops/pack2.pack2bit
// and uploads it in chunks of _ARENA_CHUNK = 4 Mi characters (1 MiB
// packed); only the packed bytes cross to the card.
//
// What bounds it on the card: bytes, one read per packed byte and four
// written.  The JAX version copied the whole arena per chunk (its arrays
// are immutable); here the store is written in place, on the stream that
// every kernel reading the store runs on, so a kernel launched before the
// write reads the store as it was.
//
// Design: a grid-stride loop, one thread per packed byte, which writes its
// four characters as one 4-byte store when the destination is aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void store_write_kernel(const uint8_t* __restrict__ packed,
                                   uint8_t* __restrict__ store, int off,
                                   int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n / 4; i += stride) {
    const uint8_t p = packed[i];
    const uchar4 v = make_uchar4((p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3,
                                 p & 3);
    uint8_t* dst = store + off + 4 * i;
    if ((off & 3) == 0) {
      *reinterpret_cast<uchar4*>(dst) = v;
    } else {
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  }
}

}  // namespace

// packed (n / 4,) uint8; store written at [off, off + n); n % 4 == 0
extern "C" int dentist_store_write(const void* packed, void* store, int off,
                                   int n, void* stream) {
  const int threads = 256;
  const int blocks = n / 4 > 0 ? (n / 4 + threads - 1) / threads : 1;
  store_write_kernel<<<blocks < 4096 ? blocks : 4096, threads, 0,
                       (cudaStream_t)stream>>>((const uint8_t*)packed,
                                               (uint8_t*)store, off, n);
  return (int)cudaGetLastError();
}
