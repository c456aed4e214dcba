// Flash attention for Hopper (sm_90a).  Forward: bf16 on wgmma fed by
// TMA, fp32 by FFMA on the CUDA cores; both may also write each row's
// logsumexp (fp32, natural log of the scaled scores) for the backward,
// which serving does not ask for.  Backward (the training path), routed
// by dtype as the forward: bf16 on the tensor cores (mma.sync, "backward,
// bf16 on mma" below), fp32 by FFMA ("backward" below; it also takes
// bf16 when the wrapper is asked for route "simt").
//
// Replaces the TPU kernel flash_attention (_flash_kernel) of
// src/repro/kernels/flash_attention.py: causal or full softmax attention
// with an online softmax, fp32 accumulation, q.dtype out.
//
//   o[bh, i] = softmax_j(sm_scale * q[bh, i] . k[kv, j]  masked) @ v[kv]
//   kv = bh / group   (GQA: the kernel indexes the shared kv head, so the
//                      wrapper makes no head-repeated copy of k and v)
//
// masked: key j hidden from query position p = q_offset + i where
// causal and j > p, or, with a sliding window (window > 0, the reference
// model's jnp blockwise_attention; its Pallas kernel has none), where
// j <= p - window.  Both are selects before exp.  Both forward kernels
// start a query block at the key tile of its first row's first visible
// key (p0 - window + 1) and mask only the tiles that reach below some
// row's window, so a window of w keys costs O(w) per row, as the
// reference's blockwise loop skips the blocks before its `lo`.  Beyond
// the window every query tile visits the same number of key tiles, so
// the last-q-tile-first launch order still puts a heaviest tile first.
//
// Like the TPU kernel it takes whole tiles only (sq and sk multiples of
// 64; the wrapper's dispatch sends every other shape to the reference)
// and head dims up to 128.  The route is chosen by dtype, not by
// fallback:
//
//   bf16 -> flash_attention_wgmma_kernel (below): tensor cores.
//   fp32 -> flash_attention_kernel: FFMA.  fp32 on tensor cores would be
//           TF32 and lose the 1e-4 agreement the fp32 serve check holds.
//
// What bounds it on the H100: at the serve shapes (qwen3-4b prefill,
// bh 128, s 512, d 128, bf16) the function moves 42 MB and does 8.6e9
// multiply-adds of the causal half, so the roofline bound is the bytes,
// 12.5 us at 3.35 TB/s; the operations take 8.7 us at 989 TFLOP/s.
//
// bf16 design.  One block per (bh, 128 query rows): two consumer
// warpgroups of 64 rows and one producer warp (288 threads, 160 KB of
// shared memory, one block per SM).  The producer TMA-loads the Q tile
// once and streams K and V tiles of 128 keys through a ring of 2 stages
// (mbarriers: full per stage for K and for V, empty per stage released by
// both consumers).  The K/V of a kv head is read by `group` blocks that
// run side by side (block index = q tile * bh + bh), so L2 serves the
// repeats.  Tiles are 128-byte-swizzled panels of 64 head-dim columns (a
// head dim of 128 is two panels; TMA zero-fills a narrower head).
//   S = Q.K^T: wgmma m64n128k16, both operands K-major in shared memory.
//   softmax:   in the registers of the S fragment; a row's 32 values per
//              thread combine across the 4 threads of a quad (shuffles).
//   O += P.V:  wgmma m64n64k16 per head-dim panel, P from registers (the
//              S fragment cast to bf16 is the A fragment), V MN-major
//              through the transpose bit.
// Causal blocks stop at their last visible K tile; only a tile that
// reaches past the first row of a warpgroup, or past sk, is masked.
// Blocks are launched heaviest causal q tile first.  Tiles: 128 keys
// fill one m64n128 product per k16 step and halve the per-tile softmax
// and barrier work of 64; 2 stages of 128-key K and V (128 KB) beside
// the 32 KB Q tile keep one tile in flight while one is consumed.
//
// bf16 numerics are the reference's (mask -1e30, running max from
// -1e30, denominator clamped at 1e-30, l summed over fp32 p) apart from
// two points that follow from bf16 tensor cores:
//   1. sm_scale multiplies the fp32 S after the product, not q before it;
//      a bf16.bf16 product is exact in fp32, so this is one fp32 rounding;
//   2. P enters P.V rounded to bf16 (relative error 2^-9 per element),
//      where the reference keeps fp32.
// and one of evaluation: the scores are scaled by sm_scale * log2(e) and
// p = 2^(x - m) is one SFU ex2.approx (relative error ~2^-22, with the
// rounding of the folded scale), where expf spends several more FP32
// instructions per element; the mask, the running max and the clamp
// keep their values in that domain.
//
// fp32 design (unchanged): one block per (bh, q tile of 64 rows), K/V
// streamed in tiles of 64 keys, 256 threads, thread (ty, tx) of a 16x16
// layout owns query rows ty + 16i (i < 4), score columns tx + 16j
// (j < 4) and output columns tx + 16c (c < FA_DC): the row statistics of
// a row live in the 16 threads of one half-warp and are combined with
// shuffles.  Q, K and P are kept transposed in shared memory with a row
// stride of 65 floats.  q is scaled by sm_scale before the dot, as in
// the reference.  Bound by the FFMA rate and shared-memory bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define FA_BQ 64
#define FA_BK 64
#define FA_NT 256
#define FA_PAD 65  // row stride, in floats, of the transposed tiles
#define FA_MAX_D 128
#define FA_DC (FA_MAX_D / 16)  // output columns per thread
#define FA_MASKED (-1e30f)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ void fa_store(float* p, float v) { *p = v; }

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
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int sq, int sk, int d,
                       int group, int q_offset, float sm_scale, int causal,
                       int window) {
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
  // with a window, from the tile of the first row's first visible key
  const int t0 =
      window > 0 ? min(max(0, q_offset + q0 - window + 1) / FA_BK, n_kt - 1)
                 : 0;

  float m[4], l[4], acc[4][FA_DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t0; t < n_kt; ++t) {
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
        const int key = k0 + tx + 16 * j;
        if ((causal && qpos < key) || (window > 0 && key <= qpos - window))
          s[i][j] = FA_MASKED;
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
    // the row's logsumexp of the scaled scores, for the backward
    if (lse != nullptr && tx == 0) lse[bh * sq + r] = m[i] + logf(l[i]);
  }
}

template <typename T>
static cudaError_t fa_launch(const void* q, const void* k, const void* v,
                             void* o, float* lse, long long bhq, int sq,
                             int sk, int d, int group, int q_offset,
                             float sm_scale, int causal, int window,
                             cudaStream_t stream) {
  const size_t smem = fa_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = bhq * (sq / FA_BQ);
  flash_attention_kernel<T><<<(unsigned)blocks, FA_NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, sq, sk, d, group,
      q_offset, sm_scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
#define FW_BQ 128                       // query rows per block
#define FW_BKV 128                      // keys per K/V tile
#define FW_THREADS 288                  // 2 consumer warpgroups + 1 warp
#define FW_PANEL_Q (FW_BQ * 128)        // bytes of a 64-column Q panel
#define FW_PANEL_KV (FW_BKV * 128)      // bytes of a 64-column K/V panel
#define FW_STAGES 2                     // K/V ring depth

static size_t fw_smem_bytes(int panels) {
  // Q, then the stages of K, then those of V; + alignment slack
  return (size_t)panels * (FW_PANEL_Q + 2 * FW_STAGES * FW_PANEL_KV) + 1024;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the SFU (relative error ~2^-22); scores are kept in the log2
// domain, so this is the exp of the natural-domain score
__device__ __forceinline__ float fw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// DP: 64-column panels of the head dim (1 for d <= 64, else 2).
template <int DP>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse, int bhq, int sq, int sk,
                             int d, int group, int q_offset, float sm_scale,
                             int causal, int window) {
  extern __shared__ uint8_t fw_smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[FW_STAGES],
      v_full[FW_STAGES], kv_empty[FW_STAGES];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fw_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + DP * FW_PANEL_Q;       // stage s: ks + s*DP*FW_PANEL_KV
  uint8_t* vs = ks + FW_STAGES * DP * FW_PANEL_KV;

  const int nqb = (sq + FW_BQ - 1) / FW_BQ;
  const int bh = blockIdx.x % bhq;
  const int q0 = (nqb - 1 - (int)(blockIdx.x / bhq)) * FW_BQ;
  const int rows = min(FW_BQ, sq - q0);  // 64 or 128
  int n_kt = (sk + FW_BKV - 1) / FW_BKV;
  if (causal) n_kt = min(n_kt, (q_offset + q0 + rows + FW_BKV - 1) / FW_BKV);
  // with a window, from the tile of the block's first visible key; the
  // ring's stage and phase count tiles from t0
  const int t0 =
      window > 0 ? min(max(0, q_offset + q0 - window + 1) / FW_BKV, n_kt - 1)
                 : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&kv_empty[s], 2);  // one arrival per consumer
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer warp
    if (threadIdx.x == 256) {
      const int kvh = bh / group;
      hopper::mbar_arrive_expect_tx(&q_full, DP * FW_PANEL_Q);
      for (int p = 0; p < DP; ++p)
        hopper::tma_load_3d(qs + p * FW_PANEL_Q, &mq, &q_full, 64 * p, q0, bh);
      for (int t = t0; t < n_kt; ++t) {
        const int s = (t - t0) % FW_STAGES;
        if (t - t0 >= FW_STAGES)
          hopper::mbar_wait(&kv_empty[s], (((t - t0) / FW_STAGES) - 1) & 1);
        uint8_t* kst = ks + s * DP * FW_PANEL_KV;
        uint8_t* vst = vs + s * DP * FW_PANEL_KV;
        hopper::mbar_arrive_expect_tx(&k_full[s], DP * FW_PANEL_KV);
        for (int p = 0; p < DP; ++p)
          hopper::tma_load_3d(kst + p * FW_PANEL_KV, &mk, &k_full[s], 64 * p,
                              t * FW_BKV, kvh);
        hopper::mbar_arrive_expect_tx(&v_full[s], DP * FW_PANEL_KV);
        for (int p = 0; p < DP; ++p)
          hopper::tma_load_3d(vst + p * FW_PANEL_KV, &mv, &v_full[s], 64 * p,
                              t * FW_BKV, kvh);
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows q0 + 64*wg .. +63.  Fragment of a
  // thread (warp w, lane l): rows 16w + l/4 (h = 0) and +8 (h = 1); in
  // each n8 block j, columns 8j + 2(l%4) and +1; register 4j + 2h + c.
  const int t128 = threadIdx.x % 128, w = t128 / 32, lane = t128 % 32;
  const int r0 = 64 * wg + 16 * w + lane / 4;  // row in the block (h = 0)
  const int qpos[2] = {q_offset + q0 + r0, q_offset + q0 + r0 + 8};
  const int qmin = q_offset + q0 + 64 * wg;  // the warpgroup's first row

  float m[2] = {FA_MASKED, FA_MASKED}, l[2] = {0.f, 0.f};
  float sc[64], oacc[DP][32];
#pragma unroll
  for (int p = 0; p < DP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[p][i] = 0.f;

  const float x_scale = sm_scale * 1.4426950408889634f;  // times log2(e)
  hopper::mbar_wait(&q_full, 0);
  const uint8_t* qw = qs + 64 * wg * 128;  // the warpgroup's 64 rows
  for (int t = t0; t < n_kt; ++t) {
    const int s = (t - t0) % FW_STAGES;
    const uint32_t parity = ((t - t0) / FW_STAGES) & 1;
    const uint8_t* kst = ks + s * DP * FW_PANEL_KV;
    const uint8_t* vst = vs + s * DP * FW_PANEL_KV;

    // S = Q.K^T over the head dim, k16 steps inside 64-column panels
    // (sc starts from zero, which also ends the previous tile's values)
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
    hopper::mbar_wait(&k_full[s], parity);
    hopper::wgmma_fence();
    hopper::fence_regs(sc);
#pragma unroll
    for (int kk = 0; kk < 4 * DP; ++kk)
      hopper::wgmma_m64n128k16_bf16_ss(
          sc, hopper::desc_kmajor(qw + (kk / 4) * FW_PANEL_Q + 32 * (kk % 4)),
          hopper::desc_kmajor(kst + (kk / 4) * FW_PANEL_KV + 32 * (kk % 4)),
          kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale (into the log2 domain), mask, online softmax over the
    // quad's 128 columns.  A tile needs the mask if it reaches past the
    // warpgroup's first row (causal), past sk, or below its last row's
    // window.  A row whose first visited tiles are all masked takes p = 1
    // there; its first visible tile's alpha = 2^(-1e30 - m) = 0 then
    // clears that sum, as in the reference's online softmax.
    const int k0 = t * FW_BKV;
    const bool edge = (causal && k0 + FW_BKV - 1 > qmin) || k0 + FW_BKV > sk ||
                      (window > 0 && k0 <= qmin + 63 - window);
    float mx[2] = {FA_MASKED, FA_MASKED};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[4 * j + 2 * h + c] * x_scale;
          if (edge) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + c;
            if ((causal && key > qpos[h]) || key >= sk ||
                (window > 0 && key <= qpos[h] - window))
              x = FA_MASKED;
          }
          sc[4 * j + 2 * h + c] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = fw_exp2(sc[4 * j + 2 * h + c] - m_new);
          sc[4 * j + 2 * h + c] = p;
          sum += p;
        }
      alpha[h] = fw_exp2(m[h] - m_new);
      l[h] = alpha[h] * l[h] + quad_sum(sum);
      m[h] = m_new;
    }
#pragma unroll
    for (int p = 0; p < DP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) oacc[p][4 * j + 2 * h + c] *= alpha[h];

    // P as bf16 A fragments: k16 slice kk is n8 blocks 2kk and 2kk+1
    uint32_t pa[FW_BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < FW_BKV / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P.V, one m64n64 product per head-dim panel and k16 step
    hopper::mbar_wait(&v_full[s], parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int p = 0; p < DP; ++p) hopper::fence_regs(oacc[p]);
#pragma unroll
    for (int kk = 0; kk < FW_BKV / 16; ++kk)
#pragma unroll
      for (int p = 0; p < DP; ++p)
        hopper::wgmma_m64n64k16_bf16_rs(
            oacc[p], pa[kk],
            hopper::desc_mnmajor(vst + p * FW_PANEL_KV + kk * 16 * 128), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < DP; ++p) hopper::fence_regs(oacc[p]);
    if (t128 == 0) hopper::mbar_arrive(&kv_empty[s]);
  }

  // rows past sq (the second warpgroup of a 64-row last tile) store nothing
  __nv_bfloat16* ob = o + (long long)bh * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + r0 + 8 * h;
    if (r >= sq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    // logsumexp of the natural-domain scaled scores: m and l are in the
    // log2 domain, so (m + log2 l) ln 2
    if (lse != nullptr && lane % 4 == 0)
      lse[(long long)bh * sq + r] = (m[h] + log2f(l[h])) * 0.6931471805599453f;
#pragma unroll
    for (int p = 0; p < DP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * (lane % 4);
        if (col < d)
          *reinterpret_cast<uint32_t*>(ob + (long long)r * d + col) =
              pack_bf16(oacc[p][4 * j + 2 * h] * inv,
                        oacc[p][4 * j + 2 * h + 1] * inv);
      }
  }
}

template <int DP>
static cudaError_t fw_launch(const void* q, const void* k, const void* v,
                             void* o, float* lse, long long bhq, int sq,
                             int sk, int d, int group, int q_offset,
                             float sm_scale, int causal, int window,
                             cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* base[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int rows = i == 0 ? sq : sk;
    const uint64_t dims[3] = {(uint64_t)d, (uint64_t)rows,
                              (uint64_t)(i == 0 ? bhq : bhq / group)};
    const uint64_t strides[2] = {(uint64_t)d * 2, (uint64_t)rows * d * 2};
    const uint32_t box[3] = {64, (uint32_t)(i == 0 ? FW_BQ : FW_BKV), 1};
    cudaError_t err = hopper::make_tensor_map(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base[i], dims, strides,
        box);
    if (err != cudaSuccess) return err;
  }
  const size_t smem = fw_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = bhq * ((sq + FW_BQ - 1) / FW_BQ);
  flash_attention_wgmma_kernel<DP><<<(unsigned)blocks, FW_THREADS, smem,
                                     stream>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)o, lse, (int)bhq, sq, sk, d,
      group, q_offset, sm_scale, causal, window);
  return cudaGetLastError();
}

// ------------------------------------------------------------ backward
// Three FFMA kernels on the CUDA cores, bf16 or fp32 in (fp32 sums),
// q.dtype out.  The reference differentiates its jnp blockwise attention
// (src/repro/models/layers.py); it has no backward kernel to replace.
// With P = exp(scale * Q.K^T - lse) recomputed from the forward's row
// logsumexp (never the softmax statistics again):
//
//   fa_bwd_dot_kernel   D_i = rowsum(dO_i * O_i), one warp a row
//   fa_bwd_dkdv_kernel  one block per (query head, 64 keys), key tile 0
//                       (the most query tiles) first: over the visible
//                       query tiles in order, dV += P^T dO, dS = P *
//                       (dO.V^T - D), dK += dS^T Q, written as the head's
//                       fp32 share of its kv head's dK and dV
//   fa_bwd_group_sum_kernel  each kv head's dK, dV: its group's shares
//                       summed in head order (one block per kv head would
//                       walk the group's heads in series, four times the
//                       critical path at qwen3-4b's group of 4)
//   fa_bwd_dq_kernel    one block per (query head, 64 rows), the last
//                       rows first: a second pass over the visible key
//                       tiles, dQ += dS K
//
// No atomics: every gradient element is one ordered sum, so two runs give
// the same bits.  Layout as the fp32 forward: thread (ty, tx) of a 16x16
// grid owns score rows ty + 16i and columns tx + 16j (i, j < 4), and
// output columns tx + 16c (c < FA_DC); operands sit transposed in shared
// memory with a row stride of 65 floats.  The causal mask is a select (P
// = 0 where a query precedes a key), taken before exp, never a product.
// A sliding window (window > 0) is the forward's: the same select also
// hides key j from query p where j <= p - window.  Both routes then walk
// only the band: a dK/dV block the query tiles from its key tile's
// diagonal to the tile of position k0 + 63 + window - 1, a dQ block the
// key tiles from its first row's first visible key (the forward's t0);
// only tiles an edge of the band crosses are masked (fa_band_edge).  At
// zamba2-7b's shape (s 8192, window 4096) the band holds 25.2 M of the
// causal triangle's 33.6 M pairs (3/8 of all 8192^2).  The ordering below
// (key tile 0, and the last query tile, first) stays as it is: past the
// window every tile's walk is equally long.
// What bounds it on the H100: at qwen3-4b's training shape (bh 64 on 16
// kv heads, s 512, d 128, causal) the least work is five products over
// the causal pairs, 10.8 GFLOP (10.9 us at bf16's 989 TFLOP/s), against
// 42.1 MB of inputs and outputs, 12.6 us at 3.35 TB/s: the bytes bound
// it, as chip_smoke.py reckons.  These kernels do seven products over
// whole 64 x 64 causal tiles, 16.9 GFLOP, by FFMA from shared memory at
// a fraction of FP32's 67 TFLOP/s, and move 67 MB of fp32 shares besides
// (written, then read by the group sum): far slower than the bound.
__device__ __forceinline__ float fa_f32(float v) { return v; }
__device__ __forceinline__ float fa_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void fa_put(float* p, float v) { *p = v; }
__device__ __forceinline__ void fa_put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The band of both backward routes, the forward's rule: key kp is
// visible to query qp unless causal and kp > qp, or, with a window, kp <=
// qp - window.  Tiles are 64 x 64.  A tile that no row's band edge
// crosses is not masked; in one that is, a hidden pair is a select (P =
// 0) before exp, so a tile whose pairs are all hidden adds exactly zero.
__device__ __forceinline__ bool fa_hidden(int qp, int kp, int causal,
                                          int window) {
  return (causal && qp < kp) || (window > 0 && kp <= qp - window);
}

// Whether the tile of queries qp0.. and keys k0.. holds a hidden pair.
__device__ __forceinline__ bool fa_band_edge(int qp0, int k0, int causal,
                                             int window) {
  return (causal && qp0 < k0 + 63) ||
         (window > 0 && (long long)k0 <= (long long)qp0 + 63 - window);
}

// One past the last query tile (of `tile` rows, the first at position
// q_offset) that sees a key of the tile at k0: the band of its last key
// ends at position k0 + 63 + window - 1 (every tile without a window).
__device__ __forceinline__ int fa_band_end(int k0, int sq, int q_offset,
                                           int window, int tile) {
  if (window <= 0) return sq / tile;
  const long long last = (long long)k0 + 63 + window - 1 - q_offset;
  return last < 0 ? 0 : (int)min((long long)sq / tile, last / tile + 1);
}

// The first key tile a query tile at position qp0 visits: the tile of its
// first row's first visible key, at most the last tile (the forward's t0).
__device__ __forceinline__ int fa_first_tile(int qp0, int window, int n_kt) {
  return window > 0 ? min(max(0, qp0 - window + 1) / 64, n_kt - 1) : 0;
}

static size_t fa_bwd_smem_bytes(int d, int score_tiles) {
  // four transposed [d][65] operand tiles, score_tiles [64][65] tiles, and
  // the 64 rows' lse and D
  return sizeof(float) * ((size_t)4 * d * FA_PAD +
                          (size_t)score_tiles * FA_BK * FA_PAD + 2 * FA_BQ);
}

template <typename T>
__global__ void __launch_bounds__(FA_NT)
fa_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                  float* __restrict__ dsum, long long rows, int d) {
  const long long row = (long long)blockIdx.x * (FA_NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* ob = o + row * d;
  const T* gb = dout + row * d;
  float v = 0.f;
  for (int f = lane; f < d; f += 32) v = fmaf(fa_f32(gb[f]), fa_f32(ob[f]), v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) dsum[row] = v;
}

template <typename T>
__global__ void __launch_bounds__(FA_NT)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, float* __restrict__ dk_part,
                   float* __restrict__ dv_part, long long bhq, int sq, int sk,
                   int d, int group, int q_offset, float sm_scale, int causal,
                   int window) {
  extern __shared__ float smem[];
  float* kt = smem;                 // [d][65]: the block's keys
  float* vt = kt + d * FA_PAD;      // [d][65]: their values
  float* qt = vt + d * FA_PAD;      // [d][65]: the query tile
  float* gt = qt + d * FA_PAD;      // [d][65]: its dO rows
  float* ps = gt + d * FA_PAD;      // [64 queries][65]: P^T
  float* dss = ps + FA_BQ * FA_PAD; // [64 queries][65]: dS^T
  float* ls = dss + FA_BQ * FA_PAD; // [64]: lse of the tile's rows
  float* ds_ = ls + FA_BQ;          // [64]: D of the tile's rows

  // key tile 0 sees the most query tiles: launched first
  const int k0 = (int)(blockIdx.x / bhq) * FA_BK;
  const long long bh = blockIdx.x % bhq;
  const long long kvh = bh / group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* kb = k + kvh * sk * (long long)d;
  const T* vb = v + kvh * sk * (long long)d;
  for (int e = tid; e < FA_BK * d; e += FA_NT) {
    const int r = e / d, f = e - r * d;
    kt[f * FA_PAD + r] = fa_f32(kb[(long long)(k0 + r) * d + f]);
    vt[f * FA_PAD + r] = fa_f32(vb[(long long)(k0 + r) * d + f]);
  }

  // the first query tile that sees key k0: q_offset + q0 + 63 >= k0;
  // with a window, the end of the tiles the band reaches
  int q_first = 0;
  if (causal) {
    const int t = k0 - q_offset - (FA_BQ - 1);
    q_first = t > 0 ? (t + FA_BQ - 1) / FA_BQ * FA_BQ : 0;
  }
  const int q_end = fa_band_end(k0, sq, q_offset, window, FA_BQ) * FA_BQ;

  float adk[4][FA_DC], adv[4][FA_DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) adk[i][c] = adv[i][c] = 0.f;

  const T* qb = q + bh * sq * (long long)d;
  const T* gb = dout + bh * sq * (long long)d;
  for (int q0 = q_first; q0 < q_end; q0 += FA_BQ) {
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < FA_BQ * d; e += FA_NT) {
      const int r = e / d, f = e - r * d;
      qt[f * FA_PAD + r] = fa_f32(qb[(long long)(q0 + r) * d + f]);
      gt[f * FA_PAD + r] = fa_f32(gb[(long long)(q0 + r) * d + f]);
    }
    for (int r = tid; r < FA_BQ; r += FA_NT) {
      ls[r] = lse[bh * sq + q0 + r];
      ds_[r] = dsum[bh * sq + q0 + r];
    }
    __syncthreads();

    // S^T (keys x queries) and dP^T = V.dO^T
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int f = 0; f < d; ++f) {
      float kr[4], vr[4], qc[4], gc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kr[i] = kt[f * FA_PAD + ty + 16 * i];
        vr[i] = vt[f * FA_PAD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qc[j] = qt[f * FA_PAD + tx + 16 * j];
        gc[j] = gt[f * FA_PAD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kr[i], qc[j], s[i][j]);
          dp[i][j] = fmaf(vr[i], gc[j], dp[i][j]);
        }
    }
    const bool edge = fa_band_edge(q_offset + q0, k0, causal, window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + ty + 16 * i, qr = tx + 16 * j;
        const bool hidden =
            edge && fa_hidden(q_offset + q0 + qr, key, causal, window);
        const float p = hidden ? 0.f : expf(s[i][j] * sm_scale - ls[qr]);
        ps[qr * FA_PAD + ty + 16 * i] = p;
        dss[qr * FA_PAD + ty + 16 * i] = p * (dp[i][j] - ds_[qr]);
      }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's 64 queries, in order
    for (int r = 0; r < FA_BQ; ++r) {
      float pr[4], dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = ps[r * FA_PAD + ty + 16 * i];
        dr[i] = dss[r * FA_PAD + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < FA_DC; ++c) {
        const int col = tx + 16 * c;
        const float gv = col < d ? gt[col * FA_PAD + r] : 0.f;
        const float qv = col < d ? qt[col * FA_PAD + r] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          adv[i][c] = fmaf(pr[i], gv, adv[i][c]);
          adk[i][c] = fmaf(dr[i], qv, adk[i][c]);
        }
      }
    }
  }

  // this query head's share of its kv head's dK and dV
  float* dkb = dk_part + bh * sk * (long long)d;
  float* dvb = dv_part + bh * sk * (long long)d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = k0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) {
        dkb[r * d + col] = adk[i][c] * sm_scale;
        dvb[r * d + col] = adv[i][c];
      }
    }
  }
}

// dK, dV of kv head h: the sum of its group's shares, heads in order
template <typename T>
__global__ void fa_bwd_group_sum_kernel(const float* __restrict__ dk_part,
                                        const float* __restrict__ dv_part,
                                        T* __restrict__ dk, T* __restrict__ dv,
                                        long long per_head, long long total,
                                        int group) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long h = e / per_head, r = e - h * per_head;
  const float* pk = dk_part + h * group * per_head + r;
  const float* pv = dv_part + h * group * per_head + r;
  float vk = 0.f, vv = 0.f;
  for (int g = 0; g < group; ++g) {
    vk += pk[g * per_head];
    vv += pv[g * per_head];
  }
  fa_put(dk + e, vk);
  fa_put(dv + e, vv);
}

template <typename T>
__global__ void __launch_bounds__(FA_NT)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dsum,
                 T* __restrict__ dq, int sq, int sk, int d, int group,
                 int q_offset, float sm_scale, int causal, int window) {
  extern __shared__ float smem[];
  float* qt = smem;                 // [d][65]: the block's query rows
  float* gt = qt + d * FA_PAD;      // [d][65]: their dO rows
  float* kt = gt + d * FA_PAD;      // [d][65]: the key tile
  float* vt = kt + d * FA_PAD;      // [d][65]: its values
  float* dss = vt + d * FA_PAD;     // [64 keys][65]: dS^T
  float* ls = dss + FA_BK * FA_PAD; // [64]
  float* ds_ = ls + FA_BQ;          // [64]

  // the last query tile sees the most key tiles: launched first
  const int n_qt = sq / FA_BQ;
  const long long bhq = gridDim.x / n_qt;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / bhq)) * FA_BQ;
  const long long bh = blockIdx.x % bhq;
  const long long kvh = bh / group;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const T* qb = q + bh * sq * (long long)d;
  const T* gb = dout + bh * sq * (long long)d;
  const T* kb = k + kvh * sk * (long long)d;
  const T* vb = v + kvh * sk * (long long)d;
  for (int e = tid; e < FA_BQ * d; e += FA_NT) {
    const int r = e / d, f = e - r * d;
    qt[f * FA_PAD + r] = fa_f32(qb[(long long)(q0 + r) * d + f]);
    gt[f * FA_PAD + r] = fa_f32(gb[(long long)(q0 + r) * d + f]);
  }
  for (int r = tid; r < FA_BQ; r += FA_NT) {
    ls[r] = lse[bh * sq + q0 + r];
    ds_[r] = dsum[bh * sq + q0 + r];
  }
  int n_kt = sk / FA_BK;
  if (causal) n_kt = min(n_kt, (q_offset + q0 + FA_BQ + FA_BK - 1) / FA_BK);
  const int t0 = fa_first_tile(q_offset + q0, window, n_kt);

  float adq[4][FA_DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) adq[i][c] = 0.f;

  for (int t = t0; t < n_kt; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();  // the previous tile is consumed (and Q is loaded)
    for (int e = tid; e < FA_BK * d; e += FA_NT) {
      const int r = e / d, f = e - r * d;
      kt[f * FA_PAD + r] = fa_f32(kb[(long long)(k0 + r) * d + f]);
      vt[f * FA_PAD + r] = fa_f32(vb[(long long)(k0 + r) * d + f]);
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int f = 0; f < d; ++f) {
      float qr[4], gr[4], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[i] = qt[f * FA_PAD + ty + 16 * i];
        gr[i] = gt[f * FA_PAD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = kt[f * FA_PAD + tx + 16 * j];
        vc[j] = vt[f * FA_PAD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(gr[i], vc[j], dp[i][j]);
        }
    }
    const bool edge = fa_band_edge(q_offset + q0, k0, causal, window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = ty + 16 * i, key = k0 + tx + 16 * j;
        const bool hidden =
            edge && fa_hidden(q_offset + q0 + qr, key, causal, window);
        const float p = hidden ? 0.f : expf(s[i][j] * sm_scale - ls[qr]);
        dss[(tx + 16 * j) * FA_PAD + qr] = p * (dp[i][j] - ds_[qr]);
      }
    __syncthreads();

    // dQ += dS K over the tile's 64 keys, in order
    for (int r = 0; r < FA_BK; ++r) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[r * FA_PAD + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < FA_DC; ++c) {
        const int col = tx + 16 * c;
        const float kv = col < d ? kt[col * FA_PAD + r] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) adq[i][c] = fmaf(dr[i], kv, adq[i][c]);
      }
    }
  }

  T* dqb = dq + bh * sq * (long long)d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = q0 + ty + 16 * i;
#pragma unroll
    for (int c = 0; c < FA_DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) fa_put(dqb + r * d + col, adq[i][c] * sm_scale);
    }
  }
}

template <typename T>
static cudaError_t fa_bwd_launch(const void* q, const void* k, const void* v,
                                 const void* o, const float* lse,
                                 const void* dout, void* dq, void* dk, void* dv,
                                 float* dsum, float* dk_part, float* dv_part,
                                 long long bhq, int sq, int sk, int d,
                                 int group, int q_offset, float sm_scale,
                                 int causal, int window, cudaStream_t stream) {
  const size_t smem_kv = fa_bwd_smem_bytes(d, 2);
  const size_t smem_q = fa_bwd_smem_bytes(d, 1);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return err;
  const long long rows = bhq * sq;
  const int warps = FA_NT / 32;
  fa_bwd_dot_kernel<T><<<(unsigned)((rows + warps - 1) / warps), FA_NT, 0,
                         stream>>>((const T*)o, (const T*)dout, dsum, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<T><<<(unsigned)(bhq * (sk / FA_BK)), FA_NT, smem_kv,
                          stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      dk_part, dv_part, bhq, sq, sk, d, group, q_offset, sm_scale, causal,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long per_head = (long long)sk * d;
  const long long total = bhq / group * per_head;
  fa_bwd_group_sum_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0,
                               stream>>>(dk_part, dv_part, (T*)dk, (T*)dv,
                                         per_head, total, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq_kernel<T><<<(unsigned)(bhq * (sq / FA_BQ)), FA_NT, smem_q,
                        stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      (T*)dq, sq, sk, d, group, q_offset, sm_scale, causal, window);
  return cudaGetLastError();
}

// ------------------------------------------------- backward, bf16 on mma
// The bf16 route of the backward ("mma"): the same function, every product
// on the tensor cores, and no per-head shares.  Two launches:
//
//   fa_bwd_dot_kernel   D_i = rowsum(dO_i * O_i), as above
//   fa_bwd_mma_kernel   the dK/dV blocks, then the dQ blocks, in one grid
//
// dK/dV: one block per (kv head, 64 keys), key tile 0 (the most visible
//   queries) first: at qwen3-4b's training shape 16 x 8 = 128 blocks, one
//   wave.  The block walks its group's query heads in head order and, for
//   each, the visible 64-row query tiles (Q, dO, lse and D double-buffered
//   by cp.async), and keeps dK and dV in fp32 registers across all of
//   them: each kv head's gradient is one ordered sum, with no fp32 share
//   per query head and no group-sum pass.  Per query tile, 8 warps:
//     S^T = K.Q^T and dP^T = V.dO^T, warp (kw, h) taking keys 16kw..+15
//       and queries 32h..+31; P^T = exp(scale S^T - lse) where the query
//       sees the key (a select before exp: 0 elsewhere), dS^T = P^T (dP^T
//       - D); both rounded to bf16 into shared memory;
//     dV += P^T.dO and dK += dS^T.Q, warp (kw, h) taking keys 16kw..+15
//       and head-dim columns h*DK/2..+DK/2-1, P^T and dS^T as A fragments.
// dQ: one block per (query head, 64 rows), the last rows (the most keys)
//   first: over the visible key tiles (K, V double-buffered), S = Q.K^T,
//   dP = dO.V^T, dS as above into shared memory, then dQ += dS.K.  An
//   atomic dQ in the dK/dV blocks would make dQ's sum order vary.
// The dQ blocks follow the dK/dV blocks in the grid, so they fill the SMs
// that the short key tiles free while the long ones run.
//
// Why mma.sync (m16n8k16, bf16 in, fp32 sums) and not wgmma: every
// product of the backward reads one operand transposed (K^T, V^T, Q^T,
// dO^T, P^T, dS^T by turns).  ldmatrix(.trans) reads each of them from
// one padded row-major tile, where wgmma would need a second, transposed
// or swizzled copy of Q, dO, K and V per tile; P^T and dS^T go from the
// score fragments to shared memory once and come back as A fragments.
// At these sizes mma.sync's rate is not the limit (below).
//
// What bounds it on the H100: at qwen3-4b's training shape (bh 64 on 16
// kv heads, s 512, d 128, causal) the least work is five products over
// the causal pairs (S, dP, dV, dK, dQ), 10.8 GFLOP, 10.9 us at bf16's 989
// TFLOP/s, against 42.1 MB of inputs and outputs (q, k, v, o, dO, dq, dk,
// dv in bf16, lse in fp32), 12.6 us at 3.35 TB/s: the bytes.  This route
// does seven products over whole causal 64 x 64 tiles (S and dP twice),
// 16.9 GFLOP; the FFMA route does the same seven and moves 67 MB of fp32
// shares besides.  Their times are in PERF.md.
#define FM_THREADS 256

template <int DK>
struct FmSmem {
  static constexpr int ROW = (DK + 8) * 2;   // bytes of a padded bf16 row
  static constexpr int TILE = 64 * ROW;      // a 64-row operand tile
  static constexpr int SROW = (64 + 8) * 2;  // a padded row of 64 scores
  static constexpr int STILE = 64 * SROW;
  // six operand tiles, two score tiles, four vectors of 64 floats
  static constexpr int VEC = 6 * TILE + 2 * STILE;
  static constexpr int TOTAL = VEC + 4 * 64 * 4;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of row l % 8 of
// matrix l / 8.  Without .trans, register i holds (row lane / 4, columns
// 2 (lane % 4), +1) of matrix i; with .trans, of its transpose.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16x8, fp32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Address for ldsm_x4 of the A fragment (16 rows x 16 k) at (row, k) of a
// row-major tile, or of two B fragments (16 n x 16 k) stored [n][k].
__device__ __forceinline__ uint32_t fm_a_addr(uint32_t tile, int row_bytes,
                                              int row, int k, int lane) {
  return tile + (row + lane % 16) * row_bytes + (k + (lane / 16) * 8) * 2;
}

__device__ __forceinline__ uint32_t fm_b_addr(uint32_t tile, int row_bytes,
                                              int n, int k, int lane) {
  return tile + (n + (lane / 16) * 8 + lane % 8) * row_bytes +
         (k + ((lane / 8) % 2) * 8) * 2;
}

// Address for ldsm_x4_t of two B fragments (16 k x 16 n) stored [k][n].
__device__ __forceinline__ uint32_t fm_bt_addr(uint32_t tile, int row_bytes,
                                               int k, int n, int lane) {
  return tile + (k + ((lane / 8) % 2) * 8 + lane % 8) * row_bytes +
         (n + (lane / 16) * 8) * 2;
}

// 64 rows of d bf16 values (row stride d) into a padded tile, by cp.async;
// columns past d keep the zeros the block wrote at its start.
template <int DK>
__device__ __forceinline__ void fm_load_rows(uint32_t tile,
                                             const __nv_bfloat16* src, int d) {
  const int per_row = d / 8;
  for (int e = threadIdx.x; e < 64 * per_row; e += FM_THREADS) {
    const int r = e / per_row, c = e - r * per_row;
    cp_async16(tile + r * FmSmem<DK>::ROW + c * 16, src + (long long)r * d + c * 8);
  }
}

__device__ __forceinline__ void fm_load_vec(uint32_t dst, const float* src) {
  if (threadIdx.x < 16) cp_async16(dst + threadIdx.x * 16, src + threadIdx.x * 4);
}

template <int DK>
__device__ __forceinline__ void fm_zero(uint8_t* sm) {
  for (int e = threadIdx.x; e < FmSmem<DK>::VEC / 16; e += FM_THREADS)
    reinterpret_cast<uint4*>(sm)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
}

// Scores of a 16 x 32 warp tile (acc[nt][r]: row 16*rw + g + 8 (r / 2),
// column 32*ch + 8 nt + 2 (lane % 4) + r % 2) into P and dS = P (dP - D),
// rounded to bf16 into the score tiles (p_tile may be 0: dS only).  The
// score rows are `rows` and its columns `cols`; which of the two is the
// query decides the mask, the lse and D.
template <bool KEY_ROWS>
__device__ __forceinline__ void fm_scores(const float (&s)[4][4],
                                          const float (&dp)[4][4],
                                          uint8_t* p_tile, uint8_t* ds_tile,
                                          const float* lse, const float* dsum,
                                          int rw, int ch, int k_base,
                                          int q_base, float sl2, int causal,
                                          int window) {
  const bool edge = fa_band_edge(q_base, k_base, causal, window);
  const int lane = threadIdx.x % 32;
  const float l2e = 1.4426950408889634f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * rw + lane / 4 + 8 * h;
      const int col = 32 * ch + 8 * nt + 2 * (lane % 4);
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int ql = KEY_ROWS ? col + c : row;   // query in its tile
        const int kl = KEY_ROWS ? row : col + c;   // key in its tile
        const bool hidden =
            edge && fa_hidden(q_base + ql, k_base + kl, causal, window);
        const float x = s[nt][2 * h + c] * sl2 - lse[ql] * l2e;
        p[c] = hidden ? 0.f : fw_exp2(x);
        ds[c] = p[c] * (dp[nt][2 * h + c] - dsum[ql]);
      }
      const int off = row * FmSmem<64>::SROW + col * 2;
      if (p_tile != nullptr)
        *reinterpret_cast<uint32_t*>(p_tile + off) = pack_bf16(p[0], p[1]);
      *reinterpret_cast<uint32_t*>(ds_tile + off) = pack_bf16(ds[0], ds[1]);
    }
}

// acc (16 rows x DK/2 columns of the warp, fp32) * scale as bf16 into
// out (row stride d), columns past d skipped.
template <int DK>
__device__ __forceinline__ void fm_store(const float (&acc)[DK / 16][4],
                                         __nv_bfloat16* out, long long row0,
                                         int col0, int d, float scale) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int nt = 0; nt < DK / 16; ++nt) {
    const int col = col0 + 8 * nt + 2 * (lane % 4);
    if (col >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row0 + lane / 4 + 8 * h;
      *reinterpret_cast<uint32_t*>(out + r * d + col) =
          pack_bf16(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
    }
  }
}

template <int DK>
__device__ void fm_dkdv(uint8_t* sm, const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        __nv_bfloat16* __restrict__ dk,
                        __nv_bfloat16* __restrict__ dv, int blk, int bhkv,
                        int sq, int sk, int d, int group, int q_offset,
                        float sm_scale, int causal, int window) {
  using L = FmSmem<DK>;
  const uint32_t base = hopper::smem_u32(sm);
  const uint32_t ks = base, vs = base + L::TILE;
  const uint32_t qs = base + 2 * L::TILE, gs = base + 4 * L::TILE;  // x2 each
  uint8_t* ps = sm + 6 * L::TILE;
  uint8_t* dss = ps + L::STILE;
  float* vec = reinterpret_cast<float*>(sm + L::VEC);  // lse[2][64], D[2][64]

  const int k0 = (blk / bhkv) * 64;  // key tile 0 first
  const int kvh = blk % bhkv;
  int q_first = 0;  // the first query tile that sees key k0
  if (causal) {
    const int t = k0 - q_offset - 63;
    q_first = t > 0 ? (t + 63) / 64 : 0;
  }
  // the query tiles its band reaches: from the diagonal's to the tile of
  // position k0 + 63 + window - 1 (every later tile without a window)
  const int q_end = fa_band_end(k0, sq, q_offset, window, 64);
  const int per_head = max(q_end - q_first, 0);
  const int n_it = group * per_head;
  auto load = [&](int it, int buf) {
    const int bh = kvh * group + it / per_head;
    const int q0 = (q_first + it % per_head) * 64;
    const long long row = (long long)bh * sq + q0;
    fm_load_rows<DK>(qs + buf * L::TILE, q + row * d, d);
    fm_load_rows<DK>(gs + buf * L::TILE, dout + row * d, d);
    fm_load_vec(hopper::smem_u32(vec + 64 * buf), lse + row);
    fm_load_vec(hopper::smem_u32(vec + 128 + 64 * buf), dsum + row);
  };

  fm_zero<DK>(sm);
  fm_load_rows<DK>(ks, k + ((long long)kvh * sk + k0) * d, d);
  fm_load_rows<DK>(vs, v + ((long long)kvh * sk + k0) * d, d);
  if (n_it > 0) load(0, 0);
  cp_async_commit();

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = w % 4, hw = w / 4;
  const float sl2 = sm_scale * 1.4426950408889634f;
  float adk[DK / 16][4], adv[DK / 16][4];
#pragma unroll
  for (int nt = 0; nt < DK / 16; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) adk[nt][r] = adv[nt][r] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) load(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t qb = qs + buf * L::TILE, gb = gs + buf * L::TILE;

    // S^T = K.Q^T and dP^T = V.dO^T: keys 16kw.., queries 32hw..
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[nt][r] = dpt[nt][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, fm_a_addr(ks, L::ROW, 16 * kw, 16 * kk, lane));
      ldsm_x4(av, fm_a_addr(vs, L::ROW, 16 * kw, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bg[4];
        ldsm_x4(bq, fm_b_addr(qb, L::ROW, 32 * hw + 16 * np, 16 * kk, lane));
        ldsm_x4(bg, fm_b_addr(gb, L::ROW, 32 * hw + 16 * np, 16 * kk, lane));
        mma_bf16(st[2 * np], ak, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ak, bq[2], bq[3]);
        mma_bf16(dpt[2 * np], av, bg[0], bg[1]);
        mma_bf16(dpt[2 * np + 1], av, bg[2], bg[3]);
      }
    }
    const int q0 = (q_first + it % per_head) * 64;
    fm_scores<true>(st, dpt, ps, dss, vec + 64 * buf, vec + 128 + 64 * buf,
                    kw, hw, k0, q_offset + q0, sl2, causal, window);
    __syncthreads();

    // dV += P^T.dO, dK += dS^T.Q: keys 16kw.., columns hw*DK/2..
    const uint32_t pb = hopper::smem_u32(ps), db = hopper::smem_u32(dss);
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t ap[4], ad[4];
      ldsm_x4(ap, fm_a_addr(pb, L::SROW, 16 * kw, 16 * kq, lane));
      ldsm_x4(ad, fm_a_addr(db, L::SROW, 16 * kw, 16 * kq, lane));
#pragma unroll
      for (int np = 0; np < DK / 32; ++np) {
        uint32_t bg[4], bq[4];
        const int n = hw * (DK / 2) + 16 * np;
        ldsm_x4_t(bg, fm_bt_addr(gb, L::ROW, 16 * kq, n, lane));
        ldsm_x4_t(bq, fm_bt_addr(qb, L::ROW, 16 * kq, n, lane));
        mma_bf16(adv[2 * np], ap, bg[0], bg[1]);
        mma_bf16(adv[2 * np + 1], ap, bg[2], bg[3]);
        mma_bf16(adk[2 * np], ad, bq[0], bq[1]);
        mma_bf16(adk[2 * np + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the scores and this buffer are free again
  }
  cp_async_wait<0>();

  const long long row0 = (long long)kvh * sk + k0 + 16 * kw;
  fm_store<DK>(adk, dk, row0, hw * (DK / 2), d, sm_scale);
  fm_store<DK>(adv, dv, row0, hw * (DK / 2), d, 1.f);
}

template <int DK>
__device__ void fm_dq(uint8_t* sm, const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dsum,
                      __nv_bfloat16* __restrict__ dq, int blk, int bhq, int sq,
                      int sk, int d, int group, int q_offset, float sm_scale,
                      int causal, int window) {
  using L = FmSmem<DK>;
  const uint32_t base = hopper::smem_u32(sm);
  const uint32_t qs = base, gs = base + L::TILE;
  const uint32_t ks = base + 2 * L::TILE, vs = base + 4 * L::TILE;  // x2 each
  uint8_t* dss = sm + 6 * L::TILE;
  float* vec = reinterpret_cast<float*>(sm + L::VEC);  // lse[64], D[64]

  const int nqt = sq / 64;
  const int q0 = (nqt - 1 - blk / bhq) * 64;  // the last rows first
  const int bh = blk % bhq, kvh = bh / group;
  int n_kt = sk / 64;
  if (causal) n_kt = min(n_kt, (q_offset + q0 + 64 + 63) / 64);
  // from the tile of the first row's first visible key (0 without a window)
  const int t0 = fa_first_tile(q_offset + q0, window, n_kt);
  auto load = [&](int t, int buf) {
    const long long row = (long long)kvh * sk + 64 * t;
    fm_load_rows<DK>(ks + buf * L::TILE, k + row * d, d);
    fm_load_rows<DK>(vs + buf * L::TILE, v + row * d, d);
  };

  fm_zero<DK>(sm);
  const long long qrow = (long long)bh * sq + q0;
  fm_load_rows<DK>(qs, q + qrow * d, d);
  fm_load_rows<DK>(gs, dout + qrow * d, d);
  fm_load_vec(hopper::smem_u32(vec), lse + qrow);
  fm_load_vec(hopper::smem_u32(vec + 64), dsum + qrow);
  load(t0, 0);
  cp_async_commit();

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qw = w % 4, hw = w / 4;
  const float sl2 = sm_scale * 1.4426950408889634f;
  float adq[DK / 16][4];
#pragma unroll
  for (int nt = 0; nt < DK / 16; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) adq[nt][r] = 0.f;

  for (int t = t0; t < n_kt; ++t) {
    const int buf = (t - t0) & 1;
    if (t + 1 < n_kt) load(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t kb = ks + buf * L::TILE, vb = vs + buf * L::TILE;

    // S = Q.K^T and dP = dO.V^T: queries 16qw.., keys 32hw..
    float s[4][4], dp[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = dp[nt][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk) {
      uint32_t aq[4], ag[4];
      ldsm_x4(aq, fm_a_addr(qs, L::ROW, 16 * qw, 16 * kk, lane));
      ldsm_x4(ag, fm_a_addr(gs, L::ROW, 16 * qw, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, fm_b_addr(kb, L::ROW, 32 * hw + 16 * np, 16 * kk, lane));
        ldsm_x4(bv, fm_b_addr(vb, L::ROW, 32 * hw + 16 * np, 16 * kk, lane));
        mma_bf16(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * np], ag, bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }
    fm_scores<false>(s, dp, nullptr, dss, vec, vec + 64, qw, hw, 64 * t,
                     q_offset + q0, sl2, causal, window);
    __syncthreads();

    // dQ += dS.K: queries 16qw.., columns hw*DK/2..
    const uint32_t db = hopper::smem_u32(dss);
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t ad[4];
      ldsm_x4(ad, fm_a_addr(db, L::SROW, 16 * qw, 16 * kq, lane));
#pragma unroll
      for (int np = 0; np < DK / 32; ++np) {
        uint32_t bk[4];
        ldsm_x4_t(bk, fm_bt_addr(kb, L::ROW, 16 * kq, hw * (DK / 2) + 16 * np,
                                 lane));
        mma_bf16(adq[2 * np], ad, bk[0], bk[1]);
        mma_bf16(adq[2 * np + 1], ad, bk[2], bk[3]);
      }
    }
    __syncthreads();  // dS and this buffer are free again
  }
  cp_async_wait<0>();
  fm_store<DK>(adq, dq, qrow + 16 * qw, hw * (DK / 2), d, sm_scale);
}

// Blocks [0, n_dkdv) are the dK/dV blocks, the rest the dQ blocks.
template <int DK>
__global__ void __launch_bounds__(FM_THREADS, 1)
fa_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ dsum,
                  __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int n_dkdv, int bhq, int sq,
                  int sk, int d, int group, int q_offset, float sm_scale,
                  int causal, int window) {
  extern __shared__ __align__(16) uint8_t fm_smem[];
  const int blk = blockIdx.x;
  if (blk < n_dkdv)
    fm_dkdv<DK>(fm_smem, q, k, v, dout, lse, dsum, dk, dv, blk, bhq / group,
                sq, sk, d, group, q_offset, sm_scale, causal, window);
  else
    fm_dq<DK>(fm_smem, q, k, v, dout, lse, dsum, dq, blk - n_dkdv, bhq, sq,
              sk, d, group, q_offset, sm_scale, causal, window);
}

template <int DK>
static cudaError_t fm_launch(const void* q, const void* k, const void* v,
                            const void* o, const float* lse, const void* dout,
                            void* dq, void* dk, void* dv, float* dsum,
                            long long bhq, int sq, int sk, int d, int group,
                            int q_offset, float sm_scale, int causal,
                            int window, cudaStream_t stream) {
  typedef __nv_bfloat16 bf;
  const int smem = FmSmem<DK>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_mma_kernel<DK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long rows = bhq * sq;
  const int warps = FA_NT / 32;
  fa_bwd_dot_kernel<bf><<<(unsigned)((rows + warps - 1) / warps), FA_NT, 0,
                          stream>>>((const bf*)o, (const bf*)dout, dsum, rows,
                                    d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_dkdv = bhq / group * (sk / 64);
  const long long blocks = n_dkdv + bhq * (sq / 64);
  fa_bwd_mma_kernel<DK><<<(unsigned)blocks, FM_THREADS, smem, stream>>>(
      (const bf*)q, (const bf*)k, (const bf*)v, (const bf*)dout, lse, dsum,
      (bf*)dq, (bf*)dk, (bf*)dv, (int)n_dkdv, (int)bhq, sq, sk, d, group,
      q_offset, sm_scale, causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------- C interface
// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success).

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse,
                                     int bf16,
                                     long long bhq, int sq, int sk, int d,
                                     int group, int q_offset, float sm_scale,
                                     int causal, int window, void* stream) {
  const long long blocks = bhq * (sq / FA_BQ);
  if (blocks <= 0 || blocks > 0x7fffffffLL || sq % FA_BQ || sk < FA_BK ||
      sk % FA_BK || d < 1 || d > FA_MAX_D || group < 1 || bhq % group != 0 ||
      q_offset < 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!bf16)
    return (int)fa_launch<float>(q, k, v, o, lse, bhq, sq, sk, d, group,
                                 q_offset, sm_scale, causal, window, st);
  // TMA reads rows of d bf16 values: 16-byte strides need d % 8 == 0
  if (d % 8 || bhq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return (int)(d > 64 ? fw_launch<2>(q, k, v, o, lse, bhq, sq, sk, d, group,
                                     q_offset, sm_scale, causal, window, st)
                      : fw_launch<1>(q, k, v, o, lse, bhq, sq, sk, d, group,
                                     q_offset, sm_scale, causal, window, st));
}

// The backward: dq (bh, sq, d), dk and dv (bh / group, sk, d) in q's type,
// from q, k, v, the forward's o and fp32 lse (bh, sq), and dout; fp32
// scratch: dsum (bh * sq), dk_part and dv_part (bh * sk * d each, every
// query head's share).  The same tiles, causal rule, window, q_offset and
// GQA as the forward.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* dsum, float* dk_part, float* dv_part, int bf16, long long bhq,
    int sq, int sk, int d, int group, int q_offset, float sm_scale, int causal,
    int window, void* stream) {
  const long long rows = bhq * sq;
  if (bhq <= 0 || rows > 0x7fffffffLL * (FA_NT / 32) ||
      bhq * (sq / FA_BQ) > 0x7fffffffLL || bhq * (sk / FA_BK) > 0x7fffffffLL ||
      bhq / group * sk * (long long)d > 0x7fffffffLL * 256LL ||
      sq < FA_BQ || sq % FA_BQ || sk < FA_BK || sk % FA_BK || d < 1 ||
      d > FA_MAX_D || group < 1 || bhq % group != 0 || q_offset < 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)fa_bwd_launch<__nv_bfloat16>(
        q, k, v, o, lse, dout, dq, dk, dv, dsum, dk_part, dv_part, bhq, sq, sk,
        d, group, q_offset, sm_scale, causal, window, st);
  return (int)fa_bwd_launch<float>(q, k, v, o, lse, dout, dq, dk, dv, dsum,
                                   dk_part, dv_part, bhq, sq, sk, d, group,
                                   q_offset, sm_scale, causal, window, st);
}

// The bf16 backward on the tensor cores: the same outputs, inputs, tiles
// and rules as repro_flash_attention_bwd (d a multiple of 8 up to 128, as
// the bf16 forward), fp32 scratch dsum (bh * sq) only.
extern "C" int repro_flash_attention_bwd_mma(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* dsum, long long bhq, int sq, int sk, int d, int group,
    int q_offset, float sm_scale, int causal, int window, void* stream) {
  if (bhq <= 0 || group < 1 || bhq % group != 0 || sq < 64 || sq % 64 ||
      sk < 64 || sk % 64 || d < 8 || d > FA_MAX_D || d % 8 || q_offset < 0 ||
      window < 0 ||
      bhq * sq > 0x7fffffffLL || bhq / group * sk > 0x7fffffffLL ||
      bhq / group * (sk / 64) + bhq * (sq / 64) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(d > 64 ? fm_launch<128>(q, k, v, o, lse, dout, dq, dk, dv, dsum,
                                       bhq, sq, sk, d, group, q_offset,
                                       sm_scale, causal, window, st)
                      : fm_launch<64>(q, k, v, o, lse, dout, dq, dk, dv, dsum,
                                      bhq, sq, sk, d, group, q_offset,
                                      sm_scale, causal, window, st));
}
