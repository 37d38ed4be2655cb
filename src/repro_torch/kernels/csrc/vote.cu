// Triple-modular-redundancy vote for Hopper (sm_90a): vote3_tiles.
//
// Replaces the Pallas kernel src/repro/kernels/vote.py:27 (`vote3_tiles`,
// kernel body `_vote_kernel` at :20): out = (a & b) | (a & c) | (b & c)
// over the flat int32 views of three copies of a leaf, so each output bit
// is the majority of the three input bits and any single-copy corruption
// is erased.  The recovery ladder's replica_vote rung runs it through
// ops.vote3.  On the TPU the wrapper padded the copies to whole
// (256, 128) tiles and the grid walked the tiles; here the wrapper passes
// the unpadded flat views and their length, and the kernel masks the
// ragged tail itself.
//   Bound: bytes (three 4 B reads and one 4 B write per word; two ANDs,
//   two ORs per word are nothing beside them).  Design: a grid-stride
//   loop over int4 words (16 B per thread per operand, neighbouring
//   threads on neighbouring addresses) when all four bases are 16-byte
//   aligned, then a scalar tail; any unaligned base takes the scalar
//   path for the whole vector.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void vote3_tiles_kernel(const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ b,
                                   const int32_t* __restrict__ c,
                                   int32_t* __restrict__ out, long long n,
                                   int vec) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = vec ? n / 4 : 0;
  const int4* __restrict__ a4 = reinterpret_cast<const int4*>(a);
  const int4* __restrict__ b4 = reinterpret_cast<const int4*>(b);
  const int4* __restrict__ c4 = reinterpret_cast<const int4*>(c);
  int4* __restrict__ o4 = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    const int4 x = a4[i], y = b4[i], z = c4[i];
    o4[i] = make_int4((x.x & y.x) | (x.x & z.x) | (y.x & z.x),
                      (x.y & y.y) | (x.y & z.y) | (y.y & z.y),
                      (x.z & y.z) | (x.z & z.z) | (y.z & z.z),
                      (x.w & y.w) | (x.w & z.w) | (y.w & z.w));
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) {
    const int32_t x = a[i], y = b[i], z = c[i];
    out[i] = (x & y) | (x & z) | (y & z);
  }
}

extern "C" int repro_vote3_tiles(const void* a, const void* b, const void* c,
                                 void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c) |
                          reinterpret_cast<uintptr_t>(out);
  const int vec = (bases & 15) == 0;
  long long blocks = ((vec ? n / 4 : n) + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 CTAs of 256 per SM
  vote3_tiles_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, (const int32_t*)c,
      (int32_t*)out, n, vec);
  return (int)cudaGetLastError();
}
