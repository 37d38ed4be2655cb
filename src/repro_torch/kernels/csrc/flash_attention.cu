// Flash attention for Hopper (sm_90a): flash_attention_bhsd.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py:106
// (`flash_attention_bhsd`, kernel body `_flash_kernel` at :44): attention
// over q (BH, Sq, D) and k/v (BKV, Sk, D), GQA through the kv row bh / G
// (G = BH / BKV, no duplicated kv), causal (top-left aligned) and
// sliding-window masks, tanh soft-capping, masked scores at -2^30, an online
// softmax with f32 m, l and acc per query row, l clamped at 1e-37 before
// the divide.  Inputs are f32 or bf16, widened to f32 on load; the output
// has q's dtype (bf16 rounded to nearest even).
//
// Differences from the TPU kernel, none of them in the function computed:
//   * The TPU grid walked the key blocks in order and carried m/l/acc in
//     VMEM scratch between grid steps.  Here one CTA owns a (bh, 64-row q
//     tile) and loops over 64-key tiles itself; blocks run in any order.
//   * Keys are bounds-checked against the true key count `seq_k`, so the
//     caller pads nothing.  (The reference's ops wrapper padded Sk with zero
//     keys and the kernel then masked against the padded length, so a
//     non-causal call with a ragged Sk attended to the zero keys; this
//     kernel computes the dense oracle `ref.flash_attention_ref`.)
//   * A masked score enters the online softmax as an exact 0 weight
//     instead of exp(-2^30 - m): the weights of live keys are the same,
//     and no "all masked so far" row has to be corrected later.  A row
//     with no live key at all gets what the oracle's softmax over
//     uniformly -2^30 scores gives it, the mean of v over all seq_k keys,
//     in a second pass that runs only in CTAs holding such a row (a window
//     with Sq > Sk, or seq_k == 0 where the result is 0).
//   * Key tiles that no row of the q tile can see (above the causal
//     diagonal, before the window) are skipped, as the reference's
//     `block_live` does.  CTAs are issued heaviest causal q tile first.
//
// Bound: operations.  4·D f32 operations per live (q, k) pair (two
// products of D FMAs each); at iterpro-100m's long context (12 heads,
// S = 8192, D = 64, causal) that is 1.03e11 operations (1.54 ms at 67
// TFLOP/s) against 67 MB of HBM traffic (0.02 ms).  The products are IEEE
// f32 FMAs on the CUDA cores, not TF32 tensor cores (the reference's 2e-5
// tolerance), with expf/tanhf (no fast math).  Design for that: 256
// threads as 16 x 16; thread (ty, tx) owns query rows 4ty..4ty+3 and, for
// the scores, keys 4tx..4tx+3, for acc the head-dim columns
// (tx + 16 jj)·VW + v.  Q, K^T, V and the probability tile P sit in
// dynamic shared memory as f32 (219 KB at D = 256, hence the raised
// limit); each inner step reads float4s from shared memory and does 4x4
// FMAs per pair of loads.  The row max is reduced across the 16 threads
// of a row with shuffles once per tile; l stays a per-thread partial sum
// (every thread of a row scales it by the same corr) and is reduced once
// at the end.  wgmma/TMA and 3xTF32 are work for later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int PAD = 4;         // floats of row padding (keeps float4 rows)
constexpr int KS = BK + PAD;   // row stride of K^T and P
constexpr float NEG = -1073741824.0f;   // -2^30, the reference's mask value

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + PAD) + size_t(D) * KS + size_t(BK) * D +
          size_t(BQ) * KS);
}

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (VW == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int G,
                       int Sq, int Sk, int seq_k, int causal, int window,
                       float softcap, float scale) {
  constexpr int QS = D + PAD;
  constexpr int DPT = D / 16;           // acc columns per thread
  constexpr int VW = DPT % 4 == 0 ? 4 : (DPT % 2 == 0 ? 2 : 1);  // per load
  constexpr int NV = DPT / VW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // [BQ][QS]
  float* sKt = sQ + BQ * QS;                     // [D][KS]   (K transposed)
  float* sV = sKt + D * KS;                      // [BK][D]
  float* sP = sV + BK * D;                       // [BQ][KS]

  const int bh = blockIdx.x;
  const int iq = gridDim.y - 1 - blockIdx.y;     // heaviest causal tile first
  const int q0 = iq * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q_rows = min(BQ, Sq - q0);

  const T* qb = q + ((long long)bh * Sq + q0) * D;
  const T* kb = k + (long long)(bh / G) * Sk * D;
  const T* vb = v + (long long)(bh / G) * Sk * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e - r * D;
    sQ[r * QS + d] = r < q_rows ? load(qb + e) : 0.f;
  }

  // key tiles some row of this q tile can see
  const int n_tiles = (seq_k + BK - 1) / BK;
  int kt_end = n_tiles;
  if (causal) kt_end = min(n_tiles, (q0 + q_rows - 1) / BK + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  float m[4], l[4], acc[4][DPT];
  bool seen[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
    seen[i] = false;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int k_rows = min(BK, seq_k - k0);
    __syncthreads();   // the previous tile's K^T, V and P are consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int c = e / D, d = e - c * D;
      const bool in = c < k_rows;
      sKt[d * KS + c] = in ? load(kb + (long long)k0 * D + e) : 0.f;
      sV[e] = in ? load(vb + (long long)k0 * D + e) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float qr[4][4], kr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(&sQ[(ty * 4 + i) * QS + d], qr[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) load_vec<4>(&sKt[(d + u) * KS + tx * 4], kr[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = fmaf(qr[i][u], kr[u][j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mc = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
        bool live = kp < seq_k;
        if (causal) live = live && qp >= kp;
        if (window > 0) live = live && qp - kp < window;
        seen[i] = seen[i] || live;
        s[i][j] = live ? x : -INFINITY;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float corr = expf(m[i] - mc);
      m[i] = mc;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - mc);   // exactly 0 for a masked key
        ps += s[i][j];
      }
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
      *reinterpret_cast<float4*>(&sP[(ty * 4 + i) * KS + tx * 4]) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_vec<4>(&sP[(ty * 4 + i) * KS + c], pr[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int jj = 0; jj < NV; ++jj) {
          float vr[VW];
          load_vec<VW>(&sV[(c + u) * D + (tx + 16 * jj) * VW], vr);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int w = 0; w < VW; ++w)
              acc[i][jj * VW + w] = fmaf(pr[i][u], vr[w], acc[i][jj * VW + w]);
        }
      }
    }
  }

  // rows' totals across the 16 threads that share them
  bool dead[4];
  int any_dead = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int sv = seen[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
      sv |= __shfl_xor_sync(0xffffffffu, sv, off);
    }
    dead[i] = !sv && ty * 4 + i < q_rows;
    any_dead |= dead[i];
  }

  // rows with no live key: the mean of v over all seq_k keys
  if (__syncthreads_or(any_dead)) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (dead[i]) {
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
        l[i] = (float)seq_k;
      }
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * BK;
      const int k_rows = min(BK, seq_k - k0);
      __syncthreads();
      for (int e = tid; e < BK * D; e += THREADS)
        sV[e] = e / D < k_rows ? load(vb + (long long)k0 * D + e) : 0.f;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!dead[i]) continue;
        for (int c = 0; c < BK; ++c)
#pragma unroll
          for (int jj = 0; jj < NV; ++jj) {
            float vr[VW];
            load_vec<VW>(&sV[c * D + (tx + 16 * jj) * VW], vr);
#pragma unroll
            for (int w = 0; w < VW; ++w) acc[i][jj * VW + w] += vr[w];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    const float den = fmaxf(l[i], 1e-37f);
    T* orow = o + ((long long)bh * Sq + q0 + r) * D;
#pragma unroll
    for (int jj = 0; jj < NV; ++jj)
#pragma unroll
      for (int w = 0; w < VW; ++w)
        store(orow + (tx + 16 * jj) * VW + w, acc[i][jj * VW + w] / den);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int bkv, int sq, int sk, int seq_k, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)bh, (unsigned)((sq + BQ - 1) / BQ));
  flash_attention_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, bh / bkv, sq, sk, seq_k,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o,
             int bh, int bkv, int sq, int sk, int seq_k, int causal,
             int window, float softcap, float scale, cudaStream_t stream) {
#define REPRO_FLASH_D(DIM)                                                 \
  case DIM:                                                                \
    return launch<DIM, T>(q, k, v, o, bh, bkv, sq, sk, seq_k, causal,      \
                          window, softcap, scale, stream);
  switch (d) {
    REPRO_FLASH_D(16)
    REPRO_FLASH_D(32)
    REPRO_FLASH_D(48)
    REPRO_FLASH_D(64)
    REPRO_FLASH_D(128)
    REPRO_FLASH_D(160)
    REPRO_FLASH_D(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_D
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
extern "C" int repro_flash_attention_bhsd(
    const void* q, const void* k, const void* v, void* o, int bh, int bkv,
    int sq, int sk, int seq_k, int d, int dtype, int causal, int window,
    float softcap, float scale, void* stream) {
  if (bkv <= 0 || bh % bkv != 0 || seq_k < 0 || seq_k > sk)
    return (int)cudaErrorInvalidValue;
  if (bh == 0 || sq == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, o, bh, bkv, sq, sk, seq_k, causal,
                           window, softcap, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, bh, bkv, sq, sk, seq_k,
                                   causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
