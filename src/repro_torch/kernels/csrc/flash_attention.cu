// Flash-attention forward for Hopper (sm_90a), FFMA on the CUDA cores.
//
// Replaces the TPU kernel flash_attention (_flash_kernel) of
// src/repro/kernels/flash_attention.py: causal or full softmax attention
// with an online softmax, fp32 accumulation, q.dtype out.
//
//   o[bh, i] = softmax_j(sm_scale * q[bh, i] . k[kv, j]  masked) @ v[kv]
//   kv = bh / group   (GQA: the kernel indexes the shared kv head, so the
//                      wrapper makes no head-repeated copy of k and v)
//
// Numerics follow the TPU kernel exactly: q is scaled by sm_scale in fp32
// before the dot, a causally masked score is -1e30 (not -inf), the
// running max starts at -1e30, and the denominator is clamped at 1e-30.
// Like the TPU kernel it takes whole tiles only: sq and sk multiples of
// 64 (the wrapper's dispatch sends every other shape to the reference),
// and head dims up to 128.
//
// Grid: one block per (bh, q tile of 64 rows).  The TPU kernel holds the
// whole K/V of a head in VMEM; a Hopper block has 227 KB of shared
// memory, so K/V stream through it in tiles of 64 keys.  Causal blocks
// stop at the last K tile their rows can see (n_kt_eff of the TPU
// kernel).  256 threads, thread (ty, tx) of a 16x16 layout owns query
// rows ty + 16i (i < 4), score columns tx + 16j (j < 4) and output
// columns tx + 16c (c < FA_DC): the row statistics (running max,
// denominator) of a row live in the 16 threads of one half-warp and are
// combined with shuffles.  Q, K and P are kept transposed in shared
// memory with a row stride of 65 floats, so the inner loops read without
// bank conflicts.
//
// What bounds it on the H100: at the serve shapes (qwen3-4b prefill,
// bh 128, s 512, d 128, bf16) the function moves 42 MB and does 8.6e9
// multiply-adds of the causal half, so the roofline bound is the bytes,
// 12.5 us at 3.35 TB/s.  This kernel does its products as FFMA on the
// CUDA cores (67 TFLOP/s peak, not the 989 of bf16 wgmma) with two
// shared loads per two FFMA in the inner loops, so it is bound by
// shared-memory bandwidth and the FFMA rate, far above the bound.  It is
// the simple kernel that is right first: wgmma with the tiles in
// registers, TMA loads of K/V and a producer warp come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_NT 256
#define FA_PAD 65  // row stride, in floats, of the transposed tiles
#define FA_MAX_D 128
#define FA_DC (FA_MAX_D / 16)  // output columns per thread
#define FA_MASKED (-1e30f)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as astype does
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

static size_t fa_smem_bytes(int d) {
  // Qt[d][65], Kt[d][65], V[64][d], Pt[64][65]
  return sizeof(float) *
         ((size_t)2 * d * FA_PAD + (size_t)FA_BK * d + (size_t)FA_BK * FA_PAD);
}

template <typename T>
__global__ void __launch_bounds__(FA_NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int sq,
                       int sk, int d, int group, int q_offset, float sm_scale,
                       int causal) {
  extern __shared__ float smem[];
  float* qt = smem;                    // [d][FA_PAD]: q rows, scaled
  float* kt = qt + d * FA_PAD;         // [d][FA_PAD]: k rows of the tile
  float* vs = kt + d * FA_PAD;         // [FA_BK][d]
  float* pt = vs + FA_BK * d;          // [FA_BK][FA_PAD]: probabilities

  const int n_qt = sq / FA_BQ;
  const long long bh = blockIdx.x / n_qt;
  const int q0 = (int)(blockIdx.x % n_qt) * FA_BQ;
  const long long kvh = bh / group;
  const T* qb = q + bh * sq * (long long)d;
  const T* kb = k + kvh * sk * (long long)d;
  const T* vb = v + kvh * sk * (long long)d;
  T* ob = o + bh * sq * (long long)d;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;

  for (int e = tid; e < FA_BQ * d; e += FA_NT) {
    const int r = e / d, f = e - r * d;
    qt[f * FA_PAD + r] = fa_load(qb + (long long)(q0 + r) * d + f) * sm_scale;
  }

  int n_kt = sk / FA_BK;
  if (causal) {
    // only K tiles at or before this Q tile's last row participate
    const int last = q_offset + q0 + FA_BQ;  // last q pos + 1
    n_kt = min(n_kt, (last + FA_BK - 1) / FA_BK);
  }

  float m[4], l[4], acc[4][FA_DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int e = tid; e < FA_BK * d; e += FA_NT) {
      const int r = e / d, f = e - r * d;
      kt[f * FA_PAD + r] = fa_load(kb + (long long)(k0 + r) * d + f);
      vs[r * d + f] = fa_load(vb + (long long)(k0 + r) * d + f);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int f = 0; f < d; ++f) {
      float qr[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[i] = qt[f * FA_PAD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = kt[f * FA_PAD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = FA_MASKED;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (causal && qpos < k0 + tx + 16 * j) s[i][j] = FA_MASKED;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum = half_warp_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < FA_DC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pt[(tx + 16 * j) * FA_PAD + ty + 16 * i] = s[i][j];
    }
    __syncthreads();

    for (int j = 0; j < FA_BK; ++j) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = pt[j * FA_PAD + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < FA_DC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < d ? vs[j * d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) fa_store(ob + (long long)r * d + col, acc[i][c] * inv);
    }
  }
}

template <typename T>
static cudaError_t fa_launch(const void* q, const void* k, const void* v,
                             void* o, long long bhq, int sq, int sk, int d,
                             int group, int q_offset, float sm_scale,
                             int causal, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = bhq * (sq / FA_BQ);
  flash_attention_kernel<T><<<(unsigned)blocks, FA_NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, sk, d, group,
      q_offset, sm_scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------- C interface
// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success).

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int bf16,
                                     long long bhq, int sq, int sk, int d,
                                     int group, int q_offset, float sm_scale,
                                     int causal, void* stream) {
  const long long blocks = bhq * (sq / FA_BQ);
  if (blocks <= 0 || blocks > 0x7fffffffLL || sq % FA_BQ || sk < FA_BK ||
      sk % FA_BK || d < 1 || d > FA_MAX_D || group < 1 || bhq % group != 0 ||
      q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      bf16 ? fa_launch<__nv_bfloat16>(q, k, v, o, bhq, sq, sk, d, group,
                                      q_offset, sm_scale, causal, st)
           : fa_launch<float>(q, k, v, o, bhq, sq, sk, d, group, q_offset,
                              sm_scale, causal, st);
  return (int)err;
}
