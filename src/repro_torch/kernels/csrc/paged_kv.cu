// Paged-KV block gather for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/paged_kv.py:52
// (`gather_blocks`, body :73): out[s, j] = pool[bt[s, j]] for a block pool
// (n_blocks, block_words) of 4-byte words (a bf16 pool's blocks move as
// the words of their element pairs) and a block table (S, max_blocks)
// int32 — a pure copy, which is what keeps the paged engine bit-exact.
// On the TPU the table rode scalar prefetch into the BlockSpec index map;
// the card has no scalar prefetch, so the kernel reads each table entry
// itself.
//   Bound: bytes (each gathered block read once, each output block written
//   once; no arithmetic).  Design: the persistent bulk-async copy engine
//   of copy.cuh.  The chunk list is S * max_blocks (slot, block) pairs
//   times the chunks of one block (at most kChunk bytes each); chunk c
//   maps to its pair and its byte offset by division and reads bt[pair]
//   once.
//   Aligned chunks go through the shared-memory ring with 1-D bulk copies;
//   a block whose size is not a multiple of 16 bytes (its unaligned
//   neighbours and its ragged tail) is copied word by word by the same
//   launch.  A table entry outside [0, n_blocks) yields zeros rather than
//   reading outside the pool.
#include <cuda_runtime.h>
#include <stdint.h>

#include "copy.cuh"

struct GatherMap {
  const char* pool;
  const int32_t* bt;
  char* out;
  int n_blocks;
  long long block_bytes;
  long long per_pair;          // chunks of one block

  __device__ copy_engine::Span operator()(long long c) const {
    const long long pair = c / per_pair;
    long long off, len;
    copy_engine::chunk_span(c - pair * per_pair, block_bytes, off, len);
    char* dst = out + pair * block_bytes + off;
    const int b = __ldg(bt + pair);
    if (b < 0 || b >= n_blocks) return {nullptr, dst, len, 0};
    return {pool + (long long)b * block_bytes + off, dst, len, 0};
  }
};

__global__ void __launch_bounds__(copy_engine::kThreads)
gather_blocks_kernel(GatherMap map, long long n_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  copy_engine::run(map, n_chunks, smem);
}

namespace {
copy_engine::GridCache gather_grid;   // internal linkage: see copy.cuh
}

extern "C" int repro_gather_blocks(const void* pool, const void* bt,
                                   void* out, int n_blocks, long long pairs,
                                   long long block_words, void* stream) {
  if (pairs <= 0 || block_words <= 0) return 0;
  const long long block_bytes = 4 * block_words;
  const long long per_pair = copy_engine::chunk_count(block_bytes);
  const long long n_chunks = pairs * per_pair;
  unsigned grid = 0;
  cudaError_t e = copy_engine::persistent_grid(
      gather_blocks_kernel, copy_engine::kRingBytes, n_chunks, gather_grid,
      &grid);
  if (e != cudaSuccess) return (int)e;
  const GatherMap map{(const char*)pool, (const int32_t*)bt, (char*)out,
                      n_blocks, block_bytes, per_pair};
  gather_blocks_kernel<<<grid, copy_engine::kThreads, copy_engine::kRingBytes,
                         (cudaStream_t)stream>>>(map, n_chunks);
  return (int)cudaGetLastError();
}
