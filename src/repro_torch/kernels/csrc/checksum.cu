// Digest-engine kernels for Hopper (sm_90a): pack_rows and row_checksums.
//
// pack_rows replaces the Pallas kernel src/repro/kernels/checksum.py:85
// (`pack_rows`): it writes the int32 bit-streams of many leaves into one
// persistent packing buffer at row-aligned (512 B) element offsets, in one
// launch, leaving fill and pad words untouched (they stay zero for the
// buffer's life).  On the TPU the leaves were separate kernel operands
// aliased into the output; here a device descriptor table holds
// (src_ptr, n_words, dst_start, first_chunk) per leaf, so one launch
// covers every leaf of a canary slice without any per-leaf host work.
//   Bound: bytes.  Each leaf word is read once and written once (a
//   2-byte leaf: 2 B read and 4 B written per element); there is no
//   arithmetic.  Design: the persistent bulk-async copy engine of
//   copy.cuh.  Each leaf is cut into chunks of at most kChunk bytes
//   (never across a leaf); `first_chunk` is the prefix sum of the leaves'
//   chunk counts (kernels/checksum.py:pack_schedule), staged in shared
//   memory after the ring once per CTA (at most kMaxLeaves leaves per
//   launch, checked by the wrapper), and a chunk finds its leaf by binary
//   search over it.
//   Aligned chunks go through the shared-memory ring with 1-D bulk
//   copies; a `pos[u]` scalar view, an unaligned source or a leaf's
//   ragged tail is copied word by word by the same launch.
//   A 2-byte leaf (bf16 params, a bf16 KV cache) or a 1-byte one (the
//   int8 `q` of a quantised moment) is read in place: its descriptor
//   carries elem_bytes = 2 or 1, its chunks are cut over the words it
//   fills (4 * n_words bytes, 2 or 1 * n_words read), and the word path
//   zero-extends each value into its word (copy.cuh:widen_path), which
//   is what the reference's pack of to_i32 flats writes.  No widened
//   copy of the leaf is made, so a captured graph reads only storage
//   that lives as long as the state.
//
// row_checksums replaces src/repro/kernels/checksum.py:136 (`row_checksums`,
// kernel bodies :57 and :68): for every 128-lane int32 row it computes
// s1 = sum(x) and s2 = sum((lane+1) * x), both mod 2^32.
//   Bound: bytes (512 B read and 8 B written per row; 3 integer operations
//   per word).  Design: one warp per row — each lane loads one int4 (the
//   whole 512 B row in one coalesced transaction per warp), accumulates in
//   uint32_t (unsigned wraparound is defined; signed overflow is not), and
//   the warp reduces with shuffles.  Warps stride over rows, so a fixed
//   grid covers any buffer.
//
// checksum_tiles replaces src/repro/kernels/checksum.py:122
// (`checksum_tiles`, kernel body `_checksum_kernel` at :50): one Fletcher
// pair per 32,768-word tile of a flat int32 vector, s1 = sum(x) and
// s2 = sum((i+1) * x) with tile-local i, mod 2^32.  The disk checkpoint
// digests every state leaf through it (ops.checksum).  On the TPU the
// wrapper padded the leaf to whole tiles (jnp.pad) and the grid walked
// the tiles in order; here the wrapper passes the unpadded flat view and
// its length, and the kernel masks the ragged last tile itself.
//   Bound: bytes (4 B read per word, 8 B written per tile; 3 integer
//   operations per word, ~27x below the bytes bound on this card).
//   Design: one CTA per tile (tiles are independent, so 132 SMs take
//   them in any order), 256 threads each loading int4 words (16 B, the
//   CTA reads the 128 KiB tile in fully coalesced sweeps), uint32_t
//   accumulation (unsigned wraparound is defined), a warp-shuffle
//   reduction and a shared-memory pass across the CTA's 8 warps.  A
//   source that is not 16-byte aligned takes the scalar path.
#include <cuda_runtime.h>
#include <stdint.h>

#include "copy.cuh"

struct PackDesc {          // mirrors the wrapper's (n_leaves, 5) int64 table
  const char* src;
  long long n_words;       // words written (== the leaf's element count)
  long long dst_start;
  long long first_chunk;   // chunks of the leaves before this one
  long long elem_bytes;    // 4: copied as is; 2 or 1: zero-extended
};

// first_chunk column in shared memory: 64 KiB after the 128 KiB ring,
// inside the card's 227 KiB (kernels/checksum.py:MAX_PACK_LEAVES).
constexpr int kMaxLeaves = 8192;

// Chunk c of the pack: the leaf l with the largest first_chunk <= c (a
// leaf with no chunks shares its successor's first_chunk and is never
// picked), then chunk c - first_chunk[l] of the 4 * n_words bytes it
// writes; a 2-byte (1-byte) leaf's chunk reads from half (a quarter of)
// that offset.
struct PackMap {
  const PackDesc* desc;
  const long long* first;      // the first_chunk column, in shared memory
  int n_leaves;
  int32_t* buf;

  __device__ copy_engine::Span operator()(long long c) const {
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const PackDesc& d = desc[lo];
    long long off, len;
    copy_engine::chunk_span(c - first[lo], 4 * d.n_words, off, len);
    const int widen = d.elem_bytes == 2 ? 1 : d.elem_bytes == 1 ? 2 : 0;
    return {d.src + (off >> widen),
            reinterpret_cast<char*>(buf + d.dst_start) + off, len, widen};
  }
};

__global__ void __launch_bounds__(copy_engine::kThreads)
pack_rows_kernel(int32_t* __restrict__ buf, const PackDesc* __restrict__ desc,
                 int n_leaves, long long n_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long* first =
      reinterpret_cast<long long*>(smem + copy_engine::kRingBytes);
  for (int l = threadIdx.x; l < n_leaves; l += blockDim.x)
    first[l] = desc[l].first_chunk;
  __syncthreads();
  copy_engine::run(PackMap{desc, first, n_leaves, buf}, n_chunks, smem);
}

__global__ void row_checksums_kernel(const int4* __restrict__ x,
                                     int2* __restrict__ out,
                                     long long rows) {
  const unsigned lane = threadIdx.x & 31u;
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const uint32_t w = lane * 4u + 1u;   // weight of the lane's first word
  for (long long r = warp; r < rows; r += n_warps) {
    const int4 v = x[r * 32 + lane];
    const uint32_t a = (uint32_t)v.x, b = (uint32_t)v.y;
    const uint32_t c = (uint32_t)v.z, e = (uint32_t)v.w;
    uint32_t s1 = a + b + c + e;
    uint32_t s2 = a * w + b * (w + 1u) + c * (w + 2u) + e * (w + 3u);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) out[r] = make_int2((int)s1, (int)s2);
  }
}

constexpr int kTile = 256 * 128;        // words per checksum tile

__global__ void checksum_tiles_kernel(const int32_t* __restrict__ x,
                                      long long n,
                                      int2* __restrict__ out) {
  const long long base = (long long)blockIdx.x * kTile;
  const long long left = n - base;
  const int valid = left >= kTile ? kTile : (left > 0 ? (int)left : 0);
  const int32_t* __restrict__ t = x + base;
  uint32_t s1 = 0u, s2 = 0u;
  const int n4 =
      ((reinterpret_cast<uintptr_t>(t) & 15) == 0) ? valid / 4 : 0;
  const int4* __restrict__ t4 = reinterpret_cast<const int4*>(t);
#pragma unroll 4
  for (int j = threadIdx.x; j < n4; j += blockDim.x) {
    const int4 v = t4[j];
    const uint32_t a = (uint32_t)v.x, b = (uint32_t)v.y;
    const uint32_t c = (uint32_t)v.z, e = (uint32_t)v.w;
    const uint32_t w = 4u * (uint32_t)j + 1u;   // weight of word 4j
    s1 += a + b + c + e;
    s2 += a * w + b * (w + 1u) + c * (w + 2u) + e * (w + 3u);
  }
  for (int i = n4 * 4 + threadIdx.x; i < valid; i += blockDim.x) {
    const uint32_t v = (uint32_t)t[i];
    s1 += v;
    s2 += v * (uint32_t)(i + 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  __shared__ uint32_t part1[32], part2[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    part1[warp] = s1;
    part2[warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    s1 = lane < n_warps ? part1[lane] : 0u;
    s2 = lane < n_warps ? part2[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) out[blockIdx.x] = make_int2((int)s1, (int)s2);
  }
}

namespace {
copy_engine::GridCache pack_grid;   // internal linkage: see copy.cuh
}

extern "C" int repro_pack_rows(void* buf, const void* desc, int n_leaves,
                               long long n_chunks, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0) return 0;
  if (n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  cudaError_t e = copy_engine::persistent_grid(
      pack_rows_kernel, copy_engine::kRingBytes + 8 * kMaxLeaves, n_chunks,
      pack_grid, &grid);
  if (e != cudaSuccess) return (int)e;
  pack_rows_kernel<<<grid, copy_engine::kThreads,
                     copy_engine::kRingBytes + 8 * n_leaves,
                     (cudaStream_t)stream>>>(
      (int32_t*)buf, (const PackDesc*)desc, n_leaves, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int repro_row_checksums(const void* x, void* out, long long rows,
                                   void* stream) {
  if (rows <= 0) return 0;
  long long blocks = (rows + 7) / 8;      // 8 warps (rows) per block
  if (blocks > 132 * 32) blocks = 132 * 32;
  row_checksums_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)x, (int2*)out, rows);
  return (int)cudaGetLastError();
}

extern "C" int repro_checksum_tiles(const void* x, long long n, void* out,
                                    long long n_tiles, void* stream) {
  if (n_tiles <= 0) return 0;
  checksum_tiles_kernel<<<(unsigned)n_tiles, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, n, (int2*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
