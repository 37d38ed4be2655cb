// Paged-KV block gather for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/paged_kv.py:52
// (`gather_blocks`, body :73): out[s, j] = pool[bt[s, j]] for a block pool
// (n_blocks, block_words) of 4-byte words and a block table (S, max_blocks)
// int32 — a pure copy, which is what keeps the paged engine bit-exact.
// On the TPU the table rode scalar prefetch into the BlockSpec index map;
// the card has no scalar prefetch, so each CTA reads its own table entry.
//   Bound: bytes (each gathered block read once, each output block written
//   once; no arithmetic).  Design: grid.y = (s, j) pair, grid.x splits the
//   block's words into 16-byte (int4) copies so that one (s, j) pair spreads
//   over several SMs; a block whose size is not a multiple of 4 words takes
//   the scalar path.  A table entry outside [0, n_blocks) yields zeros
//   rather than reading outside the pool.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void gather_blocks_kernel(const int32_t* __restrict__ pool,
                                     const int32_t* __restrict__ bt,
                                     int32_t* __restrict__ out,
                                     int n_blocks, long long block_words) {
  const long long sj = blockIdx.y;
  const int b = bt[sj];
  int32_t* __restrict__ dst = out + sj * block_words;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (b < 0 || b >= n_blocks) {
    for (long long i = tid; i < block_words; i += stride) dst[i] = 0;
    return;
  }
  const int32_t* __restrict__ src = pool + (long long)b * block_words;
  const long long n4 = (block_words % 4 == 0) ? block_words / 4 : 0;
  const int4* __restrict__ s4 = reinterpret_cast<const int4*>(src);
  int4* __restrict__ d4 = reinterpret_cast<int4*>(dst);
  for (long long i = tid; i < n4; i += stride) d4[i] = s4[i];
  for (long long i = n4 * 4 + tid; i < block_words; i += stride)
    dst[i] = src[i];
}

extern "C" int repro_gather_blocks(const void* pool, const void* bt,
                                   void* out, int n_blocks, long long pairs,
                                   long long block_words, void* stream) {
  if (pairs <= 0 || block_words <= 0) return 0;
  long long blocks = (block_words / 4 + 255) / 256;
  if (blocks < 1) blocks = 1;
  if (blocks > 256) blocks = 256;
  dim3 grid((unsigned)blocks, (unsigned)pairs);
  gather_blocks_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pool, (const int32_t*)bt, (int32_t*)out, n_blocks,
      block_words);
  return (int)cudaGetLastError();
}
