// Flash attention for Hopper (sm_90a) on the tensor cores, f32-accurate:
// flash_attention_bhsd.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:106
// (`flash_attention_bhsd`, kernel body `_flash_kernel` at :44): attention
// over q (BH, Sq, D) and k/v (BKV, Sk, D), GQA through the kv row bh / G
// (G = BH / BKV, no duplicated kv), causal (top-left aligned) and
// sliding-window masks, tanh soft-capping before the mask, an online
// softmax with f32 m, l and acc per query row, l clamped at 1e-37 before
// the divide.  Inputs are f32 or bf16; the output has q's dtype (bf16
// rounded to nearest even).
//
// Differences from the TPU kernel, none of them in the function computed:
//   * The TPU grid walked the key blocks in order and carried m/l/acc in
//     VMEM scratch between grid steps.  Here one CTA owns a (bh, BQ-row q
//     tile) and loops over BK-key tiles itself; blocks run in any order,
//     the heaviest causal q tile first.
//   * Keys are bounds-checked against the true key count `seq_k`, so the
//     caller pads nothing (the reference's ops wrapper padded Sk with zero
//     keys that a non-causal call then attended to; this kernel computes
//     the dense oracle `ref.flash_attention_ref`).
//   * A masked score enters the online softmax as an exact 0 weight
//     instead of exp(-2^30 - m).  A row with no live key at all gets what
//     the oracle's softmax over uniformly -2^30 scores gives it, the mean
//     of v over all seq_k keys, from a plain pass over v in global memory
//     that runs only for such rows (a window with Sq > Sk, or seq_k == 0
//     where the result is 0).
//   * Key tiles that no row of the q tile can see (above the causal
//     diagonal, before the window) are not loaded, as the reference's
//     `block_live` skips them; a consumer warpgroup skips the products of
//     a loaded tile that none of its own 64 rows can see.
//
// Bounds.  4·D operations per live (q, k) pair (two products of D
// multiply-adds each): at iterpro-100m's long context (12 heads, S = 8192,
// D = 64, causal) 1.03e11 operations against 67 MB of HBM traffic
// (0.02 ms).  On the CUDA cores in IEEE f32 that is 1.54 ms at 67 TFLOP/s
// (the previous, SIMT design of this kernel ran at 44 % of it).  The
// tensor cores take TF32, which keeps 11 significant bits and alone is
// ~1e-3 off the reference's 2e-5 f32 tolerance, so every product runs as
// three TF32 products of a split x = big + small, big = rna_tf32(x),
// small = rna_tf32(x - big): a_b·b_s + a_s·b_b + a_b·b_b (small products
// first), f32 accumulation, as close to the f64 oracle as plain f32
// (ref.flash_attention_3xtf32 emulates it).  Three passes at 494.7 TFLOP/s
// bound the call at 0.625 ms.  bf16 inputs are exact in TF32: their small
// parts are 0 and those products are skipped (one pass for Q·K^T, two
// for P·V, P being f32).
//
// Design.
//   * Layout kernel (flash_layout_kernel, its own launch): splits K and V
//     once per call into a scratch the wrapper allocates, one record per
//     (kv row, key tile) of [K big | K small | V^T big | V^T small] (bf16:
//     no small parts), each part in the no-swizzle K-major layout that
//     wgmma reads (Smem below).  TF32 wgmma takes K-major operands only,
//     so V goes in transposed (rows d, columns keys).  Keys past seq_k
//     are written as 0, so the ragged last tile needs no path of its own.
//     Every q tile of a head reads the same records, so the split is done
//     once per call, not once per CTA.
//   * Attention kernel: one CTA per (q head, BQ-row q tile), BQ / 64
//     warpgroups of 64 rows each and no producer warps.  Each record's K
//     half and V half come into rings of 2 stages with one 1-D
//     cp.async.bulk each, completing on the stage's mbarrier (copy.cuh's
//     bulk_load / wait_parity); thread 0 starts the first two tiles, and
//     the last warpgroup done with a stage (an atomic count) refills it
//     with the tile two on, so no thread ever waits for a free stage.
//     (A producer warpgroup with setmaxnreg left the consumers at the
//     168 registers of a 384-thread CTA: ptxas did not let them use more,
//     and they spilled.)
//   * Q: loaded once by its warpgroup, split and written to shared memory;
//     S = Q·K^T is wgmma m64n{BK}k8 with both operands from shared memory,
//     one k-step per 8 head-dim columns.
//   * Round i of a warpgroup issues S(i + 1) and P(i)·V(i) as two wgmma
//     groups and runs the softmax of S(i + 1) once the first is in, under
//     its own P·V.  The two warpgroups also take the tensor core in turns
//     (FA3's ping-pong: named barriers 3 and 4), so one's softmax runs
//     under the other's products.  On the H100 the turns made the call
//     clearly faster; the overlap inside a warpgroup did not.
//   * The S accumulator holds, for thread (g = lane / 4, t = lane % 4) of
//     warp w, rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1;
//     the row max takes 2 shuffles in the quad.  The scale, softcap, mask
//     (skipped on tiles every row sees whole) and online softmax run on
//     that fragment with expf / tanhf (no fast math).
//   * P·V is wgmma with A = P from registers.  A TF32 A-fragment holds
//     columns t and t + 4 where the accumulator holds 2t and 2t + 1;
//     instead of shuffling P, the layout kernel stores the keys of every
//     8-key group of V^T in the order 0 2 4 6 1 3 5 7, so the accumulator
//     registers are the A-fragment as they are.  N = D runs as wgmma of
//     64 / 32 / 16 columns (D = 48 and 160 are not multiples of 64).
//   * The tensor core's accumulation rounds toward zero: accumulated over
//     a whole long row (S = 8192) it drifted well past plain f32's error,
//     though inside the tolerance.  So P·V of each tile goes into a
//     zeroed accumulator and is added to acc in f32 on the CUDA cores,
//     which brings the call back to plain f32's level.
//   * Per D (Cfg): BQ = 128, BK = 64 up to D = 64; BQ = 64 and BK = 32 /
//     16 / 8 for D = 128 / 160 / 256, where Q's two parts and 2-stage
//     rings of f32 records fill the 227 KB of shared memory.
//   * Every wgmma sits under conditions the compiler can see are uniform
//     (the warpgroup index comes from a shuffle): under a branch it takes
//     for divergent, ptxas serializes the wgmmas.
//   * Where the rest of the time goes is not measured inside the kernel.
//     Without the K/V loads the call was barely faster, and dropping two
//     of the three passes saved less than their share of the bound.  Both
//     products read B (and Q·K^T also A) from shared memory: 352 KB a
//     round of two warpgroups against 96 wgmma of 32 cycles each, near
//     the 128 bytes a cycle shared memory gives.  Q held in registers
//     would take 64 more (242 are in use at D = 64).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "copy.cuh"

namespace {

using copy_engine::bulk_load;
using copy_engine::smem_addr;
using copy_engine::wait_parity;

constexpr float NEG = -1073741824.0f;   // -2^30, the reference's mask value
constexpr int kMaxDevices = 64;
constexpr int kLayoutThreads = 256;

// Tiles per head dim: BQ query rows (64 per consumer warpgroup), BK keys.
template <int D> struct Cfg { static constexpr int BQ = 128, BK = 64; };
template <> struct Cfg<128> { static constexpr int BQ = 64, BK = 32; };
template <> struct Cfg<160> { static constexpr int BQ = 64, BK = 16; };
template <> struct Cfg<256> { static constexpr int BQ = 64, BK = 8; };

// TF32 parts per value: big and small for f32, big alone for bf16.
template <typename T>
constexpr int kParts = std::is_same<T, float>::value ? 2 : 1;

// f32 words of one scratch record: K and V^T, each in kParts parts.
template <int D, typename T>
__host__ __device__ constexpr int record_words() {
  return 2 * kParts<T> * Cfg<D>::BK * D;
}

template <int D, typename T>
constexpr size_t attention_smem() {
  return sizeof(float) * (size_t(kParts<T>) * Cfg<D>::BQ * D +
                          2 * size_t(record_words<D, T>())) +
         4 * sizeof(uint64_t) + 4 * sizeof(int);
}

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Round to TF32 (10 mantissa bits), to nearest with ties away from zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The shared-memory layout of a K-major wgmma operand of R rows (M or N)
// and K columns, both multiples of 8, without swizzle: 8-row x 16-byte
// core matrices of 128 contiguous bytes, core (r / 8, c / 4) at
// (c / 4) · R/8 + r / 8 cores, so LBO = R · 16 bytes along K and SBO =
// 128 bytes along M/N.  (A 128/64/32-byte swizzle of the same operands ran
// no faster on the H100.)
template <int R>
struct Smem {
  __device__ static int word(int r, int c) {
    return (c >> 2) * (4 * R) + (r >> 3) * 32 + (r & 7) * 4 + (c & 3);
  }
  __device__ static void elem(int w, int& r, int& c) {
    const int cb = w / (4 * R), rem = w - cb * 4 * R;
    r = (rem >> 5) * 8 + ((rem >> 2) & 7);
    c = cb * 4 + (rem & 3);
  }
  // descriptor of the operand at `base`; k-step kk (columns 8kk ..
  // 8kk + 7) from row m0 is desc(base) + step(kk, m0), the start address
  // counting 16 bytes
  __device__ static uint64_t desc(uint32_t base) {
    return (uint64_t)((base & 0x3FFFF) >> 4) |
           ((uint64_t)(R * 16 >> 4) << 16) | ((uint64_t)(128 >> 4) << 32);
  }
  __device__ static constexpr int step(int kk, int m0) {
    return 2 * kk * R + m0;
  }
};

// Key (within its tile) stored at column `col` of V^T: each 8-key group
// holds keys 0 2 4 6 1 3 5 7, the order of P's accumulator registers.
__device__ __forceinline__ int vt_key(int col) {
  return (col & ~7) | ((col & 3) << 1) | ((col >> 2) & 1);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from touching registers a wgmma still reads or writes
// before the wait above.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma m64nNk8, f32 += tf32 · tf32, both operands K-major.  _ss: A and B
// from shared memory; _rs: A from four registers per thread (rows g and
// g + 8, columns t and t + 4).  d: the N / 2 accumulator registers.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<8>(float* d, uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, uint32_t a0,
                                                  uint32_t a1, uint32_t a2,
                                                  uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// acc (64 x N) += A (64 x 8, registers) · B (8 x N), B the 8 x N block of
// V^T whose descriptor is `b`, as wgmma of 64, 32 and 16 columns.
template <int N>
__device__ __forceinline__ void pv(float* acc, uint32_t a0, uint32_t a1,
                                   uint32_t a2, uint32_t a3, uint64_t b) {
#pragma unroll
  for (int n0 = 0; n0 + 64 <= N; n0 += 64)
    wgmma_rs<64>(acc + n0 / 2, a0, a1, a2, a3, b + n0);
  constexpr int R = N % 64;
  if constexpr (R >= 32)
    wgmma_rs<32>(acc + (N - R) / 2, a0, a1, a2, a3, b + (N - R));
  if constexpr (R % 32 == 16)
    wgmma_rs<16>(acc + (N - 16) / 2, a0, a1, a2, a3, b + (N - 16));
}

// One CTA per (kv row, key tile): rows k0 .. k0 + BK - 1 of K and V (0
// past seq_k) staged as f32, then written split, K as is and V^T, into
// the tile's record.
template <int D, typename T>
__global__ void __launch_bounds__(kLayoutThreads)
flash_layout_kernel(const T* __restrict__ k, const T* __restrict__ v,
                    float* __restrict__ records, int Sk, int seq_k) {
  constexpr int BK = Cfg<D>::BK, P = kParts<T>, E = BK * D, RS = D + 1;
  extern __shared__ float raw[];   // [2][BK][RS]: K rows, then V rows
  const int kt = blockIdx.x, b = blockIdx.y;
  const int rows = min(BK, seq_k - kt * BK);
  const long long src = ((long long)b * Sk + (long long)kt * BK) * D;
  for (int e = threadIdx.x; e < E; e += kLayoutThreads) {
    const int r = e / D, c = e - r * D;
    const bool in = r < rows;
    raw[r * RS + c] = in ? load(k + src + e) : 0.f;
    raw[(BK + r) * RS + c] = in ? load(v + src + e) : 0.f;
  }
  __syncthreads();
  float* out = records + ((long long)b * gridDim.x + kt) * (2 * P * E);
  for (int w = threadIdx.x; w < E; w += kLayoutThreads) {
    int row, col;
    Smem<BK>::elem(w, row, col);             // K: row key, col d
    float x = raw[row * RS + col];
    uint32_t hi = tf32(x);
    out[w] = __uint_as_float(hi);
    if constexpr (P == 2)
      out[E + w] = __uint_as_float(tf32(x - __uint_as_float(hi)));
    Smem<D>::elem(w, row, col);             // V^T: row d, col key
    x = raw[(BK + vt_key(col)) * RS + row];
    hi = tf32(x);
    out[P * E + w] = __uint_as_float(hi);
    if constexpr (P == 2)
      out[P * E + E + w] = __uint_as_float(tf32(x - __uint_as_float(hi)));
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(Cfg<D>::BQ / 64 * 128, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ v,
                       const float* __restrict__ records, T* __restrict__ o,
                       int G, int Sq, int Sk, int seq_k, int causal,
                       int window, float softcap, float scale) {
  constexpr int BQ = Cfg<D>::BQ, BK = Cfg<D>::BK, NC = BQ / 64;
  constexpr int P = kParts<T>, QW = BQ * D, E = BK * D;
  constexpr int RW = record_words<D, T>();
  constexpr uint32_t HALF = RW / 2 * 4;    // bytes of the K or V half
  extern __shared__ __align__(128) float smem[];
  // Q [P][QW]; rings of 2 K halves and 2 V halves of a record; mbarriers
  // full[half][stage]; counters used[half][stage] of warpgroups done
  float* sQ = smem;
  const uint32_t q_addr = smem_addr(sQ), ring = smem_addr(smem + P * QW);
  const uint32_t full0 = ring + 4 * HALF;
  int* used = reinterpret_cast<int*>(smem + P * QW + 2 * RW + 8);
  auto ring_at = [&](int half, int t) {
    return ring + (2 * half + (t & 1)) * HALF;
  };
  auto full_at = [&](int half, int t) {
    return full0 + 8u * (2 * half + (t & 1));
  };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tile first
  const int q_rows = min(BQ, Sq - q0);
  // key tiles some row of this q tile can see
  const int n_tiles = (seq_k + BK - 1) / BK;
  int kt_end = n_tiles;
  if (causal) kt_end = min(n_tiles, (q0 + q_rows - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;
  const int n_kt = max(0, kt_end - kt_begin);

  // Half `half` (0 = K, 1 = V) of tile t into its stage: one bulk copy.
  const char* src = reinterpret_cast<const char*>(
      records + ((long long)(bh / G) * n_tiles + kt_begin) * RW);
  auto feed = [&](int half, int t) {
    bulk_load(ring_at(half, t), src + ((long long)t * 2 + half) * HALF, HALF,
              full_at(half, t));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 4; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(full0 + 8u * s) : "memory");
      used[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < min(2, n_kt); ++t) {
      feed(0, t);
      feed(1, t);
    }
  }
  __syncthreads();

  // warpgroup index, read from lane 0 so that the compiler knows it is
  // uniform: a wgmma under a branch it takes for divergent is serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int u = threadIdx.x & 127, g = (u & 31) >> 2, t4 = u & 3;
  // This warpgroup is done with half `half` of tile t; the last of the NC
  // refills its stage with tile t + 2.  No thread waits for a free stage.
  auto release = [&](int half, int t) {
    if (u != 0) return;
    const int n = atomicAdd(&used[2 * half + (t & 1)], 1);
    if (n == NC * ((t >> 1) + 1) - 1 && t + 2 < n_kt) feed(half, t + 2);
  };
  const int r0 = 64 * wg + 16 * (u >> 5) + g;   // rows r0 and r0 + 8
  const int qp[2] = {q0 + r0, q0 + r0 + 8};
  const int wg_lo = q0 + 64 * wg;
  const int wg_hi = q0 + min(q_rows, 64 * wg + 64) - 1;

  {  // this warpgroup's 64 rows of Q, split into shared memory
    const T* qs = q + ((long long)bh * Sq + wg_lo) * D;
    const int rows = q_rows - 64 * wg;
    for (int e = u; e < 64 * D; e += 128) {
      const int r = e / D, c = e - r * D;
      const float x = r < rows ? load(qs + e) : 0.f;
      const int w = Smem<BQ>::word(64 * wg + r, c);
      const uint32_t hi = tf32(x);
      sQ[w] = __uint_as_float(hi);
      if constexpr (P == 2)
        sQ[QW + w] = __uint_as_float(tf32(x - __uint_as_float(hi)));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

  float acc[D / 2], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  bool seen[2] = {false, false};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // columns per P·V pass: acc, pv_t, S and P fit the registers
  constexpr int PW = D <= 64 ? D : (D % 64 == 0 ? 64 : D / 2);
  float s[BK / 2], pv_t[PW / 2];
  uint32_t pb[BK / 2], ps[BK / 2];

  // Can a row of this warpgroup see a key of tile t?
  auto live_at = [&](int t) {
    const int k0 = (kt_begin + t) * BK;
    return wg_lo <= wg_hi && !(causal && k0 > wg_hi) &&
           !(window > 0 && k0 + BK - 1 <= wg_lo - window);
  };
  // With two consumer warpgroups the tensor core is taken in turns: a
  // warpgroup issues its products between bar.sync on its own barrier
  // and bar.arrive on the other's, so one's softmax runs under the
  // other's products.  Warpgroup 0 goes first.
  if constexpr (NC == 2)
    if (wg == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");

  // acc(64 x PW) += P(i)·V(i), columns c0 .. c0 + PW - 1: k-step kk =
  // keys 8kk .. 8kk + 7, whose A-fragment is registers 4kk + {0, 2, 1, 3}
  // (see vt_key); small products first
  auto issue_pv = [&](int i, int c0) {
    using V = Smem<D>;
    const uint64_t dv = V::desc(ring_at(1, i));
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      pv<PW>(pv_t, ps[4 * kk], ps[4 * kk + 2], ps[4 * kk + 1],
             ps[4 * kk + 3], dv + V::step(kk, c0));
    if constexpr (P == 2) {
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        pv<PW>(pv_t, pb[4 * kk], pb[4 * kk + 2], pb[4 * kk + 1],
               pb[4 * kk + 3], dv + E / 4 + V::step(kk, c0));
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      pv<PW>(pv_t, pb[4 * kk], pb[4 * kk + 2], pb[4 * kk + 1],
             pb[4 * kk + 3], dv + V::step(kk, c0));
  };
  // S(t) = Q·K(t)^T, one k-step per 8 head-dim columns, small first
  auto issue_s = [&](int t) {
    using Q = Smem<BQ>;
    using K = Smem<BK>;
    const uint64_t dk = K::desc(ring_at(0, t));
    // Q's address through a volatile move, so that its D/8 x P
    // descriptors are rebuilt each round instead of held in registers
    uint32_t q0a;
    asm volatile("mov.u32 %0, %1;\n" : "=r"(q0a) : "r"(q_addr));
    const uint64_t dq = Q::desc(q0a) + Q::step(0, 64 * wg);
    if constexpr (P == 2) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        wgmma_ss<BK>(s, dq + QW / 4 + Q::step(kk, 0), dk + K::step(kk, 0));
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk)
        wgmma_ss<BK>(s, dq + Q::step(kk, 0), dk + E / 4 + K::step(kk, 0));
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_ss<BK>(s, dq + Q::step(kk, 0), dk + K::step(kk, 0));
  };
  auto commit = [] {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };

  // Round i: S(i + 1) = Q·K(i + 1)^T and P(i)·V(i) on the tensor core; the
  // softmax of S(i + 1) runs as soon as S is in, under P(i)·V(i); then
  // P(i + 1) is split.  P·V of each tile is summed apart and added to acc
  // in f32 on the CUDA cores: the tensor core's own accumulation rounds
  // toward zero, which over thousands of k-steps drifts past the f32
  // tolerance.
  bool live = false;
  for (int i = -1; i < n_kt; ++i) {
    const int nx = i + 1;
    const bool live_nx = nx < n_kt && live_at(nx);
    if (nx < n_kt) wait_parity(full_at(0, nx), (nx >> 1) & 1);
    if (i >= 0) wait_parity(full_at(1, i), (i >> 1) & 1);
    if (live_nx) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) s[j] = 0.f;
    }
    if (live) {
#pragma unroll
      for (int j = 0; j < PW / 2; ++j) pv_t[j] = 0.f;
    }
    if constexpr (NC == 2)
      asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
    wgmma_fence();
    if (live_nx) issue_s(nx);
    commit();
    if (live) issue_pv(i, 0);
    commit();
    if constexpr (NC == 2)
      if (!(wg == 1 && i == n_kt - 1))   // balance the head start
        asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    pin(s);

    // softmax of S(nx) into s: scale, softcap, mask, online max and sum
    float corr[2] = {1.f, 1.f};
    if (live_nx) {
      const int k0 = (kt_begin + nx) * BK;
      // every row of this warpgroup sees every key of the tile
      const bool whole = k0 + BK <= seq_k &&
                         (!causal || k0 + BK - 1 <= wg_lo) &&
                         (window <= 0 || wg_hi - k0 < window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          float x = s[4 * j + e] * scale;
          if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
          if (!whole) {
            const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
            const bool ok = kp < seq_k && (!causal || qp[h] >= kp) &&
                            (window <= 0 || qp[h] - kp < window);
            seen[h] = seen[h] || ok;
            x = ok ? x : -INFINITY;
          }
          s[4 * j + e] = x;
          mx[h] = fmaxf(mx[h], x);
        }
      if (whole) seen[0] = seen[1] = true;
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        s[j] = expf(s[j] - m[(j >> 1) & 1]);   // 0 for a masked key
        sum[(j >> 1) & 1] += s[j];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
    }

    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(pv_t);
    pin(pb);
    pin(ps);
    if (live) {
      // P·V runs in passes of PW head-dim columns (one up to D = 64)
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += PW) {
        if (c0 > 0) {
#pragma unroll
          for (int j = 0; j < PW / 2; ++j) pv_t[j] = 0.f;
          wgmma_fence();
          issue_pv(i, c0);
          commit();
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          pin(pv_t);
        }
#pragma unroll
        for (int j = 0; j < PW / 2; ++j) acc[c0 / 2 + j] += pv_t[j];
      }
    }
    if (nx < n_kt) release(0, nx);   // K(i + 1) and V(i) consumed
    if (i >= 0) release(1, i);
    live = live_nx;
    if (!live_nx) continue;
    // P(nx), split for the next round's P·V
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j >> 1) & 1];
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      pb[j] = tf32(s[j]);
      ps[j] = tf32(s[j] - __uint_as_float(pb[j]));
    }
  }

  // rows' totals across the quad that shares them
  bool dead[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    int sv = seen[h];
    sv |= __shfl_xor_sync(0xffffffffu, sv, 1);
    sv |= __shfl_xor_sync(0xffffffffu, sv, 2);
    dead[h] = !sv && r0 + 8 * h < q_rows;
  }
  // rows with no live key: the mean of v over all seq_k keys
  if (dead[0] || dead[1]) {
    const T* vb = v + (long long)(bh / G) * Sk * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!dead[h]) continue;
      l[h] = (float)seq_k;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float a = 0.f, b = 0.f;
        for (int key = 0; key < seq_k; ++key) {
          a += load(vb + (long long)key * D + 8 * j + 2 * t4);
          b += load(vb + (long long)key * D + 8 * j + 2 * t4 + 1);
        }
        acc[4 * j + 2 * h] = a;
        acc[4 * j + 2 * h + 1] = b;
      }
    }
  }

  T* ob = o + ((long long)bh * Sq + q0) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= q_rows) continue;
    const float den = fmaxf(l[h], 1e-37f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(ob + (long long)r * D + 8 * j + 2 * t4,
             acc[4 * j + 2 * h] / den, acc[4 * j + 2 * h + 1] / den);
  }
}

// Host side.  The attention kernel's shared-memory limit is raised once
// per (device, dtype, D) into this table; it lives at namespace scope in
// the anonymous namespace, not as a function-local static of the
// template (a GNU-unique symbol, which the dynamic linker would share
// with a second build of this library loaded in the same process).
constexpr int kHeadDims[] = {16, 32, 48, 64, 128, 160, 256};
constexpr int kNumHeadDims = sizeof(kHeadDims) / sizeof(kHeadDims[0]);
bool g_smem_raised[kMaxDevices][2][kNumHeadDims];

template <int D>
constexpr int head_dim_slot() {
  for (int i = 0; i < kNumHeadDims; ++i)
    if (kHeadDims[i] == D) return i;
  return -1;
}

template <int D, typename T>
int launch_layout(const void* k, const void* v, void* records, int bkv,
                  int sk, int seq_k, cudaStream_t stream) {
  constexpr int BK = Cfg<D>::BK;
  const int n_tiles = (seq_k + BK - 1) / BK;
  if (n_tiles == 0 || bkv == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * BK * (D + 1);
  flash_layout_kernel<D, T><<<dim3(n_tiles, bkv), kLayoutThreads, smem,
                              stream>>>((const T*)k, (const T*)v,
                                        (float*)records, sk, seq_k);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_attention(const void* q, const void* v, const void* records,
                     void* o, int bh, int bkv, int sq, int sk, int seq_k,
                     int causal, int window, float softcap, float scale,
                     cudaStream_t stream) {
  constexpr int BQ = Cfg<D>::BQ;
  constexpr size_t smem = attention_smem<D, T>();
  static_assert(smem <= 232448, "shared memory of one CTA");
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  bool& raised = g_smem_raised[dev][std::is_same<T, float>::value ? 0 : 1]
                              [head_dim_slot<D>()];
  if (!raised) {
    err = cudaFuncSetAttribute(flash_attention_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const dim3 grid((unsigned)bh, (unsigned)((sq + BQ - 1) / BQ));
  flash_attention_kernel<D, T><<<grid, BQ / 64 * 128, smem, stream>>>(
      (const T*)q, (const T*)v, (const float*)records, (T*)o, bh / bkv, sq,
      sk, seq_k, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, D>{}, T{}) for a built D and dtype (0 =
// float32, 1 = bfloat16); `bad` otherwise.
template <typename R, class F>
R with_kernel(int d, int dtype, R bad, F&& f) {
  auto by_type = [&](auto dc) -> R {
    if (dtype == 0) return f(dc, float{});
    if (dtype == 1) return f(dc, __nv_bfloat16{});
    return bad;
  };
  switch (d) {
    case 16: return by_type(std::integral_constant<int, 16>{});
    case 32: return by_type(std::integral_constant<int, 32>{});
    case 48: return by_type(std::integral_constant<int, 48>{});
    case 64: return by_type(std::integral_constant<int, 64>{});
    case 128: return by_type(std::integral_constant<int, 128>{});
    case 160: return by_type(std::integral_constant<int, 160>{});
    case 256: return by_type(std::integral_constant<int, 256>{});
    default: return bad;
  }
}

}  // namespace

// The scratch of repro_flash_layout_kv at head dim d (dtype: 0 =
// float32, 1 = bfloat16): keys per record and f32 words per record, one
// record per (kv row, key tile); -1 for a d or dtype that is not built.
extern "C" int repro_flash_tile_keys(int d, int dtype) {
  return with_kernel(d, dtype, -1, [&](auto dc, auto) {
    return Cfg<decltype(dc)::value>::BK;
  });
}

extern "C" int repro_flash_record_words(int d, int dtype) {
  return with_kernel(d, dtype, -1, [&](auto dc, auto t) {
    return record_words<decltype(dc)::value, decltype(t)>();
  });
}

// k, v (BKV, Sk, D) -> the records of their first seq_k keys, BKV x
// ceil(seq_k / tile_keys) of them (one launch; refused when there are
// none).
extern "C" int repro_flash_layout_kv(const void* k, const void* v,
                                     void* records, int bkv, int sk,
                                     int seq_k, int d, int dtype,
                                     void* stream) {
  if (bkv < 0 || seq_k < 0 || seq_k > sk) return (int)cudaErrorInvalidValue;
  return with_kernel(d, dtype, (int)cudaErrorInvalidValue,
                     [&](auto dc, auto t) {
    return launch_layout<decltype(dc)::value, decltype(t)>(
        k, v, records, bkv, sk, seq_k, (cudaStream_t)stream);
  });
}

// q (BH, Sq, D), v (BKV, Sk, D) (read only for rows with no live key),
// records from repro_flash_layout_kv over the same k, v and seq_k.
extern "C" int repro_flash_attention_bhsd(
    const void* q, const void* v, const void* records, void* o, int bh,
    int bkv, int sq, int sk, int seq_k, int d, int dtype, int causal,
    int window, float softcap, float scale, void* stream) {
  if (bkv <= 0 || bh % bkv != 0 || seq_k < 0 || seq_k > sk)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  return with_kernel(d, dtype, (int)cudaErrorInvalidValue,
                     [&](auto dc, auto t) {
    return launch_attention<decltype(dc)::value, decltype(t)>(
        q, v, records, o, bh, bkv, sq, sk, seq_k, causal, window, softcap,
        scale, (cudaStream_t)stream);
  });
}
