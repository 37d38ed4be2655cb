// XOR parity for Hopper (sm_90a): xor_fold_tiles and xor_update_tiles.
//
// Replace the Pallas kernels src/repro/kernels/parity.py:30
// (`xor_fold_tiles`, kernel body `_xor_fold_kernel` at :20) and :52
// (`xor_update_tiles`, `_xor_update_kernel` at :44).  The parity layer
// (core/parity.py) lays the covered state out as D row-aligned blocks per
// leaf, one stream row per block, padded to whole (256, 128) int32 tiles:
//
//   xor_fold_tiles   out[i]     = x[0][i] ^ x[1][i] ^ ... ^ x[R-1][i]
//                    (the parity build and rebuild, ops.xor_fold)
//   xor_update_tiles parity[i] ^= x[0][i] ^ ... ^ x[D-1][i]
//                    (every training step: x holds the per-block deltas
//                    old ^ new; parity is updated in place, the torch form
//                    of the TPU kernel's input_output_aliases={1: 0})
//
// x is (R or D, n) row-major with n = nt * 32768 words, so every row
// starts 16-byte aligned when the base is (the wrapper checks the base).
// On the TPU the grid walked the tiles in order with all R replicas of
// one tile in VMEM; here the tile structure does not matter: each
// element is independent, so the kernels walk the flat words.
//   Bound: bytes (R + 1 or D + 2 words of 4 B moved per word position;
//   R - 1 or D XORs are nothing beside them).  Design: a grid-stride loop
//   over int4 words (16 B per thread per row, neighbouring threads on
//   neighbouring addresses); the row loop is unrolled by 4, so a thread's
//   loads of one position issue together and a warp keeps several
//   16-byte requests in flight.  When n % 4 != 0 the rows after the first
//   are not 16-byte aligned, and the scalar loop takes every word.
#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ int4 xor4(int4 a, int4 b) {
  return make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// x: rows x n words; out: n words, overlapping no row of x.
// ACC 0: out = XOR of the rows; ACC 1: out ^= XOR of the rows.
template <int ACC>
static __device__ __forceinline__ void xor_rows(
    const int32_t* __restrict__ x, long long rows, long long n,
    int32_t* __restrict__ out) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = n % 4 == 0 ? n / 4 : 0;
  const int4* __restrict__ x4 = reinterpret_cast<const int4*>(x);
  int4* __restrict__ o4 = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    int4 acc = ACC ? o4[i] : x4[i];
#pragma unroll 4
    for (long long r = ACC ? 0 : 1; r < rows; ++r)
      acc = xor4(acc, x4[r * n4 + i]);
    o4[i] = acc;
  }
  for (long long i = n4 * 4 + tid; i < n; i += stride) {
    int32_t acc = ACC ? out[i] : x[i];
    for (long long r = ACC ? 0 : 1; r < rows; ++r) acc ^= x[r * n + i];
    out[i] = acc;
  }
}

__global__ void xor_fold_tiles_kernel(const int32_t* __restrict__ x,
                                      long long rows, long long n,
                                      int32_t* __restrict__ out) {
  xor_rows<0>(x, rows, n, out);
}

__global__ void xor_update_tiles_kernel(const int32_t* __restrict__ x,
                                        long long rows, long long n,
                                        int32_t* __restrict__ parity) {
  xor_rows<1>(x, rows, n, parity);
}

static unsigned grid_for(long long n) {
  long long blocks = (n / 4 + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 16) blocks = 132 * 16;   // 16 CTAs of 256 per SM
  return (unsigned)blocks;
}

extern "C" int repro_xor_fold_tiles(const void* x, long long rows, long long n,
                                    void* out, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  xor_fold_tiles_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, rows, n, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int repro_xor_update_tiles(const void* x, long long rows,
                                      long long n, void* parity,
                                      void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  xor_update_tiles_kernel<<<grid_for(n), 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, rows, n, (int32_t*)parity);
  return (int)cudaGetLastError();
}
