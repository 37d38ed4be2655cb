// Persistent bulk-async copy engine for Hopper (sm_90a), shared by
// pack_rows (checksum.cu) and gather_blocks (paged_kv.cu).
//
// Both kernels are pure copies of many contiguous runs (a leaf into the
// packing buffer, a pool block into the gathered view); both are bound by
// bytes.  The work is one flat list of CHUNKS: a chunk is a contiguous run
// of at most kChunk bytes that never crosses a leaf or a block.  A run of
// n bytes is cut into ceil(body / kChunk) chunks over its 16-byte-multiple
// body (body = n rounded down to 16), then one tail chunk of the n - body
// ragged bytes when there are any (kernels/checksum.py:chunk_count mirrors
// this).  A persistent 1-D grid of min(n_chunks, SMs x CTAs-per-SM) CTAs
// walks the list with stride gridDim.x, so no CTA is empty and no grid
// dimension is sized by the largest leaf.
//
// Inside a CTA, thread 0 copies every chunk whose source, destination and
// size are 16-byte multiples with Hopper's 1-D bulk copies through a ring
// of kStages kChunk-byte stages in dynamic shared memory: a
// cp.async.bulk load completing on the stage's mbarrier, then a
// cp.async.bulk store committed as one bulk group, and the stage refilled
// only after wait_group.read has seen that store read it.  One thread thus
// keeps up to kStages x C bytes in flight and spends no registers on the
// data.  Warps 1-7 copy every other chunk (unaligned scalar views, a
// block of 21 words, a leaf's ragged tail) word by word, global to
// global, in the same launch.  A chunk with no source writes zeros.
// A widening chunk (pack_rows of a 2- or 1-byte leaf) reads bytes / 2
// or bytes / 4 source bytes and zero-extends each value into one 4-byte
// word; it never takes the bulk path (a bulk copy cannot widen), and
// warps 1-7 move it 4 values (8 or 4 B loaded, 16 B stored) a thread
// where both ends are aligned for that, value by value otherwise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace copy_engine {

// kChunk: 32 KiB was the fastest of 8, 16 and 32 KiB for the training
// canary's 1.2 GB pack on an H100 (PERF.md, the copy engine's findings);
// the CPU tests hold kernels/checksum.py:CHUNK_BYTES to this value.
constexpr int kChunk = 32768;
constexpr int kStages = 4;          // ring depth (stages of kChunk bytes)
constexpr int kLag = 1;             // store groups left reading at refill
constexpr int kThreads = 256;       // thread 0 issues bulk copies
constexpr int kWordThreads = kThreads - 32;   // warps 1-7: the word path
constexpr int kBarBytes = 64;       // kStages mbarriers, padded
constexpr int kRingBytes = kStages * kChunk + kBarBytes;
constexpr int kMaxDevices = 64;

// One chunk: `bytes` bytes from `src` to `dst`; a null `src` writes zeros.
// With `widen` = 1 (or 2), `src` holds bytes / 4 values of 2 bytes (of
// 1 byte), each written to `dst` as one zero-extended 4-byte word
// (`bytes` counts the destination; the source holds bytes >> widen).
struct Span {
  const char* src;
  char* dst;
  long long bytes;
  int widen;
};

__host__ __device__ inline long long chunk_count(long long n) {
  const long long body = n & ~15LL;
  return (body + kChunk - 1) / kChunk + (n != body ? 1 : 0);
}

// Byte range [off, off + len) of chunk k of a run of n bytes.
__device__ inline void chunk_span(long long k, long long n, long long& off,
                                  long long& len) {
  const long long body = n & ~15LL;
  off = k * kChunk;
  if (off < body) {
    len = body - off < kChunk ? body - off : kChunk;
  } else {
    off = body;
    len = n - body;
  }
}

__device__ inline bool bulk_ok(const Span& s) {
  return s.src != nullptr && !s.widen &&
         ((reinterpret_cast<uintptr_t>(s.src) |
           reinterpret_cast<uintptr_t>(s.dst) | (uintptr_t)s.bytes) & 15) ==
             0;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void bulk_load(uint32_t stage, const char* src,
                                 uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(stage), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// Spin until the barrier's phase of `parity` has completed.  A phase that
// never completes (seconds of polling) traps: a launch error, not a hang.
__device__ inline void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ inline void bulk_store(char* dst, uint32_t stage,
                                  uint32_t bytes) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(stage), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The first bulk chunk of this CTA at or after chunk c (c itself or
// c + k * gridDim.x); returns n when there is none.
template <class Map>
__device__ inline long long next_bulk(const Map& map, long long c,
                                      long long n, Span& s) {
  for (; c < n; c += gridDim.x) {
    s = map(c);
    if (bulk_ok(s)) return c;
  }
  return n;
}

// Thread 0: the bulk pipeline over this CTA's aligned chunks.  Loads run
// up to kStages chunks ahead of the stores; chunk i lives in stage
// i % kStages, whose mbarrier completes its (i / kStages)-th phase when
// the chunk has landed.  After the store of chunk i, the stage of chunk
// i - kLag is refilled (with chunk i - kLag + kStages) once every store
// group but the newest kLag has read its stage, so a refill never
// overwrites bytes a store still reads; kStages - kLag loads and up to
// kLag + 1 stores are then in flight.
template <class Map>
__device__ void bulk_pipeline(const Map& map, long long n,
                              unsigned char* ring, uint64_t* bars) {
  const uint32_t ring0 = smem_addr(ring), bar0 = smem_addr(bars);
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar0 + 8u * s) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  Span ls, ss;
  long long lc = next_bulk(map, blockIdx.x, n, ls);
  int issued = 0;
  for (; issued < kStages && lc < n; ++issued) {
    bulk_load(ring0 + issued * kChunk, ls.src, (uint32_t)ls.bytes,
              bar0 + 8u * issued);
    lc = next_bulk(map, lc + gridDim.x, n, ls);
  }
  long long sc = next_bulk(map, blockIdx.x, n, ss);
  for (int i = 0; sc < n; ++i) {
    const int st = i % kStages;
    wait_parity(bar0 + 8u * st, (uint32_t)(i / kStages) & 1u);
    bulk_store(ss.dst, ring0 + st * kChunk, (uint32_t)ss.bytes);
    if (i >= kLag && lc < n) {
      asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(kLag)
                   : "memory");
      const int rs = issued % kStages;      // == (i - kLag) % kStages
      bulk_load(ring0 + rs * kChunk, ls.src, (uint32_t)ls.bytes,
                bar0 + 8u * rs);
      ++issued;
      lc = next_bulk(map, lc + gridDim.x, n, ls);
    }
    sc = next_bulk(map, sc + gridDim.x, n, ss);
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A widening chunk of 1-byte values (int8 / uint8), by thread t of the
// word path: with a 4-byte aligned source and a 16-byte aligned
// destination a thread moves 4 values a step (one 4-byte load, one
// 16-byte store); the rest, and any chunk not so aligned (a source at
// any byte), go value by value.
__device__ inline void widen_bytes(const Span& s, int t) {
  const long long words = s.bytes >> 2;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(s.src) & 3) |
       (reinterpret_cast<uintptr_t>(s.dst) & 15)) == 0) {
    const uint32_t* __restrict__ src =
        reinterpret_cast<const uint32_t*>(s.src);
    uint4* __restrict__ dst = reinterpret_cast<uint4*>(s.dst);
    const long long quads = words >> 2;
#pragma unroll 4
    for (long long i = t; i < quads; i += kWordThreads) {
      const uint32_t v = __ldg(src + i);
      dst[i] = make_uint4(v & 0xffu, (v >> 8) & 0xffu, (v >> 16) & 0xffu,
                          v >> 24);
    }
    done = quads << 2;
  }
  const uint8_t* src = reinterpret_cast<const uint8_t*>(s.src);
  uint32_t* dst = reinterpret_cast<uint32_t*>(s.dst);
  for (long long i = done + t; i < words; i += kWordThreads) dst[i] = src[i];
}

// A widening chunk, by thread t of the word path: bytes / 4 values of 2
// bytes (1 byte: widen_bytes), each zero-extended into one destination
// word.  With an 8-byte aligned source and a 16-byte aligned destination
// a thread moves 4 values a step (one 8-byte load, one 16-byte store);
// the rest, and any chunk not so aligned, go value by value.
__device__ inline void widen_path(const Span& s, int t) {
  if (s.widen == 2) {
    widen_bytes(s, t);
    return;
  }
  const long long words = s.bytes >> 2;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(s.src) & 7) |
       (reinterpret_cast<uintptr_t>(s.dst) & 15)) == 0) {
    const uint2* __restrict__ src = reinterpret_cast<const uint2*>(s.src);
    uint4* __restrict__ dst = reinterpret_cast<uint4*>(s.dst);
    const long long quads = words >> 2;
#pragma unroll 4
    for (long long i = t; i < quads; i += kWordThreads) {
      const uint2 v = __ldg(src + i);
      dst[i] = make_uint4(v.x & 0xffffu, v.x >> 16, v.y & 0xffffu,
                          v.y >> 16);
    }
    done = quads << 2;
  }
  const uint16_t* src = reinterpret_cast<const uint16_t*>(s.src);
  uint32_t* dst = reinterpret_cast<uint32_t*>(s.dst);
  for (long long i = done + t; i < words; i += kWordThreads) dst[i] = src[i];
}

// Warps 1-7: every chunk of this CTA the bulk path does not take, one
// 4-byte word per thread per step (every run here is whole 4-byte words),
// or a widening chunk through widen_path.
template <class Map>
__device__ void word_path(const Map& map, long long n) {
  const int t = threadIdx.x - 32;
  for (long long c = blockIdx.x; c < n; c += gridDim.x) {
    const Span s = map(c);
    if (bulk_ok(s)) continue;
    if (s.widen) {
      widen_path(s, t);
      continue;
    }
    const int32_t* src = reinterpret_cast<const int32_t*>(s.src);
    int32_t* dst = reinterpret_cast<int32_t*>(s.dst);
    const long long words = s.bytes >> 2;
    if (src != nullptr) {
      for (long long i = t; i < words; i += kWordThreads) dst[i] = src[i];
    } else {
      for (long long i = t; i < words; i += kWordThreads) dst[i] = 0;
    }
  }
}

// The engine's body: `map(c)` gives chunk c's Span.  `smem` is the
// kernel's 128-byte-aligned dynamic shared memory: the ring, then the
// barriers (kRingBytes), then whatever the kernel keeps after them.
template <class Map>
__device__ inline void run(const Map& map, long long n_chunks,
                           unsigned char* smem) {
  if (threadIdx.x == 0)
    bulk_pipeline(map, n_chunks, smem,
                  reinterpret_cast<uint64_t*>(smem + kStages * kChunk));
  else if (threadIdx.x >= 32)
    word_path(map, n_chunks);
}

// Host side: the persistent grid for `kernel` with at most `smem` bytes
// of dynamic shared memory, min(n_chunks, SMs x CTAs-per-SM).  The
// shared-memory limit is raised and the occupancy read once per device.
// Each source keeps its cache at namespace scope in an anonymous
// namespace: a function-local static of a template or inline function
// is a GNU-unique symbol, which the dynamic linker merges across every
// library of the process, so a second build of the library loaded next
// to the first would skip the attribute call and fail its launches
// above 48 KB of shared memory.
struct GridCache {
  int ctas[kMaxDevices];            // zero-initialised (static storage)
};

template <class Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int smem,
                                   long long n_chunks, GridCache& cache,
                                   unsigned* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache.ctas[dev] == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache.ctas[dev] = sms * per_sm;
  }
  const long long g = cache.ctas[dev];
  *grid = (unsigned)(n_chunks < g ? n_chunks : g);
  return cudaSuccess;
}

}  // namespace copy_engine
