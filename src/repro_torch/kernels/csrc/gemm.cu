// Contraction GEMM kernels for Hopper (sm_90a), fp32 contract.
//
// Three kernels, one per TPU kernel of src/repro/kernels/contract_gemm.py:
//
//   tf32x3_gemm_kernel <- tiled_matmul (_matmul_kernel)
//       C[b] = A[b] @ B[b] in fp32, as 3xTF32 on wgmma fed by TMA: each
//       product is split into TF32 hi and lo parts on the host side
//       (a.b ~= a_hi.b_hi + a_hi.b_lo + a_lo.b_hi), which keeps about 22
//       of fp32's 24 mantissa bits per product; see the note at the
//       kernel.
//   fused_gemm_kernel  <- fused_transpose_matmul (_fused_kernel)
//       one contraction step on operands in their native tree layouts:
//       every element address is a sum of per-role offsets read from
//       tables built on the host, so no transposed copy is made; the
//       output is written straight into the step's inds_out layout.
//   chain_gemm_kernel  <- fused_chain_matmul (_chain_kernel, _run_chain)
//       a run of adjacent steps in one cooperative persistent launch:
//       blocks share each step's output tiles, a grid barrier separates
//       the steps, and interior carries live in a device workspace laid
//       out by the planner's slot assignment.
//
// K2 and K3 share one tile routine: 64x64 output tile, K in slices of 16,
// 256 threads each holding a 4x4 register block, FFMA only (no TF32 mma),
// one ordered sum over K per output element (no split-K, no atomics), so
// the result does not depend on the launch geometry.  Complex steps run
// the 3-real-GEMM Karatsuba on split re/im planes inside the tile:
//   P1 = Ar.Br, P2 = Ai.Bi, P3 = (Ar+Ai).(Br+Bi)
//   C_re = P1 - P2, C_im = (P3 - P1) - P2.
//
// What bounds them on the H100.  K1 does three TF32 products per fp32
// product, so its least time is its operations at a third of the 495
// TFLOP/s TF32 peak (165 TFLOP/s fp32-accurate); its operands are four
// planes written by the wrapper (twice the bytes of A and B, read once by
// TMA), and its tile loop issues three wgmmas per k8 step on 128x128
// tiles and waits once per 32-wide k-tile to add that tile's sum in
// fp32 while the other consumer warpgroup's products run.  K2 and K3
// issue 2 FFMA per 2 shared loads, well short of the 67 TFLOP/s fp32
// peak, and gather their operands element by element through the
// offset tables, which costs uncoalesced loads when the native layout's
// fastest axis is not the tile's fastest axis.  The chain steps are
// mostly small GEMMs, so the chain kernel is bound by the grid barriers
// and by too few tiles per step to fill 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef long long i64;

#define BM 64
#define BN 64
#define BK 16
#define NT 256
#define APAD 4
#define MAX_CHAIN 32

// A step descriptor: 31 int64 words followed by its offset tables, all in
// one device buffer.  Each role r of an operand maps a flat role index i
// to an element offset: tab[hi + i / lo_n] + tab[lo + i % lo_n].
enum {
  D_B = 0, D_M, D_N, D_K,
  D_AB = 4,   // A batch role: hi, lo, lo_n
  D_AM = 7,   // A m role
  D_AK = 10,  // A k role
  D_BB = 13,  // B batch role
  D_BK = 16,  // B k role
  D_BN = 19,  // B n role
  D_OB = 22,  // output batch role
  D_OM = 25,  // output m role
  D_ON = 28,  // output n role
  D_WORDS = 31
};

struct Smem {
  float a[3][BK][BM + APAD];  // A planes: re, im, re+im
  float b[3][BK][BN];         // B planes: re, im, re+im
  i64 arow[BM];               // A offset of (batch, m) per tile row
  i64 bcol[BN];               // B offset of (batch, n) per tile column
  i64 crow[BM];               // output offset of (batch, m)
  i64 ccol[BN];               // output offset of n
  i64 ak[BK];                 // A offset of k
  i64 bk[BK];                 // B offset of k
  i64 desc[32];
};

__device__ __forceinline__ i64 role_off(const i64* __restrict__ d,
                                        const i64* sd, int r, i64 i) {
  const i64 lo_n = sd[r + 2];
  return d[sd[r] + i / lo_n] + d[sd[r + 1] + i % lo_n];
}

template <bool CG>
__device__ __forceinline__ float ld(const float* p) {
  // the chain kernel reads carries that other blocks wrote during this
  // launch: bypass L1, which is not coherent across SMs
  return CG ? __ldcg(p) : __ldg(p);
}

// One output tile of one step.  `d` is the step's descriptor in device
// memory, its first D_WORDS words already copied to s.desc.
template <bool KARA, bool CG>
__device__ void gemm_tile(Smem& s, const i64* __restrict__ d, i64 tile,
                          const float* a0, const float* a1,
                          const float* b0, const float* b1,
                          float* c0, float* c1) {
  const i64* sd = s.desc;
  const i64 M = sd[D_M], N = sd[D_N], K = sd[D_K];
  const i64 tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const i64 nt = tile % tiles_n;
  const i64 mt = (tile / tiles_n) % tiles_m;
  const i64 bt = tile / (tiles_n * tiles_m);
  const i64 m0 = mt * BM, n0 = nt * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  __syncthreads();  // the previous tile is done with the shared tables
  const i64 a_b = role_off(d, sd, D_AB, bt);
  const i64 b_b = role_off(d, sd, D_BB, bt);
  const i64 o_b = role_off(d, sd, D_OB, bt);
  for (int i = tid; i < BM; i += NT) {
    const i64 m = m0 + i;
    s.arow[i] = m < M ? a_b + role_off(d, sd, D_AM, m) : -1;
    s.crow[i] = m < M ? o_b + role_off(d, sd, D_OM, m) : -1;
  }
  for (int j = tid; j < BN; j += NT) {
    const i64 n = n0 + j;
    s.bcol[j] = n < N ? b_b + role_off(d, sd, D_BN, n) : -1;
    s.ccol[j] = n < N ? role_off(d, sd, D_ON, n) : -1;
  }
  __syncthreads();

  float acc1[4][4], acc2[4][4], acc3[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc1[i][j] = acc2[i][j] = acc3[i][j] = 0.f;

  for (i64 k0 = 0; k0 < K; k0 += BK) {
    if (tid < BK) {
      const i64 k = k0 + tid;
      s.ak[tid] = k < K ? role_off(d, sd, D_AK, k) : -1;
    } else if (tid < 2 * BK) {
      const i64 k = k0 + tid - BK;
      s.bk[tid - BK] = k < K ? role_off(d, sd, D_BK, k) : -1;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < (BM * BK) / NT; ++r) {
      const int e = tid + NT * r;
      const int mi = e / BK, ki = e % BK;
      const i64 ra = s.arow[mi], ka = s.ak[ki];
      const bool oka = ra >= 0 && ka >= 0;
      const float x0 = oka ? ld<CG>(a0 + ra + ka) : 0.f;
      s.a[0][ki][mi] = x0;
      if (KARA) {
        const float x1 = oka ? ld<CG>(a1 + ra + ka) : 0.f;
        s.a[1][ki][mi] = x1;
        s.a[2][ki][mi] = x0 + x1;
      }
      const int kj = e / BN, ni = e % BN;
      const i64 kb = s.bk[kj], cb = s.bcol[ni];
      const bool okb = kb >= 0 && cb >= 0;
      const float y0 = okb ? ld<CG>(b0 + kb + cb) : 0.f;
      s.b[0][kj][ni] = y0;
      if (KARA) {
        const float y1 = okb ? ld<CG>(b1 + kb + cb) : 0.f;
        s.b[1][kj][ni] = y1;
        s.b[2][kj][ni] = y0 + y1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int ki = 0; ki < BK; ++ki) {
      float xa[4], yb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = s.a[0][ki][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) yb[j] = s.b[0][ki][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc1[i][j] = fmaf(xa[i], yb[j], acc1[i][j]);
      if (KARA) {
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i] = s.a[1][ki][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) yb[j] = s.b[1][ki][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(xa[i], yb[j], acc2[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) xa[i] = s.a[2][ki][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) yb[j] = s.b[2][ki][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc3[i][j] = fmaf(xa[i], yb[j], acc3[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const i64 ro = s.crow[ty + 16 * i];
    if (ro < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const i64 co = s.ccol[tx + 16 * j];
      if (co < 0) continue;
      if (KARA) {
        c0[ro + co] = acc1[i][j] - acc2[i][j];
        c1[ro + co] = (acc3[i][j] - acc1[i][j]) - acc2[i][j];
      } else {
        c0[ro + co] = acc1[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------- K1
// C[b] = A[b] @ B[b] as 3xTF32 on wgmma.  The wrapper hands over four
// K-major planes, K padded to a multiple of 4 with zeros: A_hi, A_lo
// (batch*M rows of Kp) and Bt_hi, Bt_lo (batch*N rows of Kp), where
// x_hi = tf32(x) and x_lo = tf32(x - x_hi) (cvt.rna), and
//   a.b ~= a_hi.b_hi + a_hi.b_lo + a_lo.b_hi
// on the TF32 tensor cores, accumulated in fp32 (a_lo.b_lo, below 2^-22
// of a.b, is dropped).  TF32 wgmma takes K-major operands only, hence Bt.
//
// Block: a 128x128 tile of C, K in steps of 32 fp32 (one 128-byte row of
// each plane), three stages of four 16 KB tiles (192 KB).  Warp 8 is the
// producer: its lane 0 TMA-loads the four tiles of a stage and waits for
// a stage to be released before refilling it.  Warpgroups 0 and 1 are
// the consumers, each owning 64 rows of the tile (a 64x128 fp32
// accumulator, 64 registers a thread): per k8 step they issue three
// m64n128k8 wgmmas into a fresh sum per k-tile, wait for them, release
// the stage and add the sum into the fp32 accumulator (the other
// consumer's products fill the tensor cores meanwhile).  TMA fills the
// ragged M, N and K edges with zeros: a tile's rows past M (or N) read
// the next batch cell's rows or zeros, and only ever reach output rows
// (columns) that the epilogue masks.  One ordered sum over K per output,
// no split-K, no atomics.
#define G_BM 128
#define G_BN 128
#define G_BK 32
#define G_STAGES 3
#define G_THREADS 288                          // 2 consumer warpgroups + 1 warp
#define G_TILE_BYTES (G_BM * G_BK * 4)         // 16 KB, one plane's tile
#define G_STAGE_BYTES (4 * G_TILE_BYTES)
#define G_SMEM (G_STAGES * G_STAGE_BYTES + 1024)  // + alignment slack

__global__ void __launch_bounds__(G_THREADS, 1)
tf32x3_gemm_kernel(const __grid_constant__ CUtensorMap a_hi,
                   const __grid_constant__ CUtensorMap a_lo,
                   const __grid_constant__ CUtensorMap b_hi,
                   const __grid_constant__ CUtensorMap b_lo,
                   float* __restrict__ C, int M, int N, int Kp) {
  extern __shared__ uint8_t g_smem_raw[];
  __shared__ __align__(8) uint64_t full[G_STAGES], empty[G_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(g_smem_raw) + 1023) & ~uintptr_t(1023));

  const int tiles_m = (M + G_BM - 1) / G_BM, tiles_n = (N + G_BN - 1) / G_BN;
  const int tile = blockIdx.x;
  const int nt = tile % tiles_n;
  const int mt = (tile / tiles_n) % tiles_m;
  const int bt = tile / (tiles_n * tiles_m);
  const int m0 = mt * G_BM, n0 = nt * G_BN;
  const int nk = (Kp + G_BK - 1) / G_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer warp
    if (threadIdx.x == 256) {
      const int ra = bt * M + m0, rb = bt * N + n0;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % G_STAGES;
        if (kt >= G_STAGES)
          hopper::mbar_wait(&empty[s], ((kt / G_STAGES) - 1) & 1);
        uint8_t* st = smem + s * G_STAGE_BYTES;
        hopper::mbar_arrive_expect_tx(&full[s], G_STAGE_BYTES);
        const int k0 = kt * G_BK;
        hopper::tma_load_2d(st, &a_hi, &full[s], k0, ra);
        hopper::tma_load_2d(st + G_TILE_BYTES, &a_lo, &full[s], k0, ra);
        hopper::tma_load_2d(st + 2 * G_TILE_BYTES, &b_hi, &full[s], k0, rb);
        hopper::tma_load_2d(st + 3 * G_TILE_BYTES, &b_lo, &full[s], k0, rb);
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64*wg .. 64*wg+63 of the tile.  The
  // tensor cores' fp32 accumulation is not rounded to nearest, and its
  // error grows with the length of one wgmma sum (one sum over K = 1000
  // was off by 1e-3 on outputs near 30 on the H100), so each k-tile's
  // twelve products go to a fresh wgmma sum that is then added into the
  // fp32 accumulator by FADD, rounded to nearest.
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int a_off = wg * 64 * (G_BK * 4);  // 64 rows of 128 bytes
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % G_STAGES;
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
    hopper::mbar_wait(&full[s], (kt / G_STAGES) & 1);
    const uint8_t* st = smem + s * G_STAGE_BYTES;
    hopper::wgmma_fence();
    hopper::fence_regs(part);
#pragma unroll
    for (int k = 0; k < G_BK / 8; ++k) {
      const uint8_t* a = st + a_off + 32 * k;  // k8 step: 32 bytes along K
      const uint8_t* b = st + 2 * G_TILE_BYTES + 32 * k;
      const uint64_t ah = hopper::desc_kmajor(a);
      const uint64_t al = hopper::desc_kmajor(a + G_TILE_BYTES);
      const uint64_t bh = hopper::desc_kmajor(b);
      const uint64_t bl = hopper::desc_kmajor(b + G_TILE_BYTES);
      // the small products first, the large one last
      hopper::wgmma_m64n128k8_tf32_ss(part, al, bh, k > 0);
      hopper::wgmma_m64n128k8_tf32_ss(part, ah, bl, 1);
      hopper::wgmma_m64n128k8_tf32_ss(part, ah, bh, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(part);
    if (threadIdx.x % 128 == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // accumulator fragment: warp w, lane l holds rows 16w + l/4 (+8) and,
  // for each n8 block j, columns 8j + 2(l%4) (+1)
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  float* Cb = C + (long long)bt * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg * 64 + 16 * w + lane / 4 + 8 * h;
    if (m >= M) continue;
    float* row = Cb + (long long)m * N;
#pragma unroll
    for (int j = 0; j < G_BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (n + 1 < N && (N % 2) == 0) {
        *reinterpret_cast<float2*>(row + n) = make_float2(x, y);
      } else {
        if (n < N) row[n] = x;
        if (n + 1 < N) row[n + 1] = y;
      }
    }
  }
}

// ---------------------------------------------------------------- K2
template <bool KARA>
__global__ void __launch_bounds__(NT)
fused_gemm_kernel(const i64* __restrict__ d, const float* a0, const float* a1,
                  const float* b0, const float* b1, float* c0, float* c1) {
  __shared__ Smem s;
  if (threadIdx.x < D_WORDS) s.desc[threadIdx.x] = d[threadIdx.x];
  __syncthreads();
  gemm_tile<KARA, false>(s, d, blockIdx.x, a0, a1, b0, b1, c0, c1);
}

// ---------------------------------------------------------------- K3
struct ChainArgs {
  const i64* desc[MAX_CHAIN];
  const float* a0[MAX_CHAIN];
  const float* a1[MAX_CHAIN];
  const float* b0[MAX_CHAIN];
  const float* b1[MAX_CHAIN];
  float* c0[MAX_CHAIN];
  float* c1[MAX_CHAIN];
  i64 tiles[MAX_CHAIN];
  int nsteps;
};

// Sense-free grid barrier on two counters: bar[0] counts arrivals and is
// reset by the last block to arrive, which then bumps the generation
// bar[1] that the others wait on.  Valid only when every block of the
// grid is resident, which the cooperative launch guarantees.
__device__ void grid_barrier(unsigned int* bar, unsigned int nblocks) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

template <bool KARA>
__global__ void __launch_bounds__(NT)
chain_gemm_kernel(ChainArgs args, unsigned int* bar) {
  __shared__ Smem s;
  for (int t = 0; t < args.nsteps; ++t) {
    const i64* d = args.desc[t];
    __syncthreads();  // every thread is done with the previous descriptor
    if (threadIdx.x < D_WORDS) s.desc[threadIdx.x] = d[threadIdx.x];
    __syncthreads();
    for (i64 tile = blockIdx.x; tile < args.tiles[t]; tile += gridDim.x)
      gemm_tile<KARA, true>(s, d, tile, args.a0[t], args.a1[t], args.b0[t],
                            args.b1[t], args.c0[t], args.c1[t]);
    if (t + 1 < args.nsteps) grid_barrier(bar, gridDim.x);
  }
}

// ---------------------------------------------------------- C interface
// Each entry point launches on the given stream, does not synchronise,
// and returns cudaGetLastError() (0 on success).

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1 on the four planes the wrapper wrote (see tf32x3_gemm_kernel).
extern "C" int repro_tiled_gemm(const float* a_hi, const float* a_lo,
                                const float* bt_hi, const float* bt_lo,
                                float* C, i64 batch, i64 M, i64 N, i64 Kp,
                                void* stream) {
  const i64 tiles = batch * ((M + G_BM - 1) / G_BM) * ((N + G_BN - 1) / G_BN);
  if (tiles <= 0 || tiles > 0x7fffffffLL || Kp <= 0 || Kp % 4 ||
      batch * M > 0x7fffffffLL || batch * N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const float* planes[4] = {a_hi, a_lo, bt_hi, bt_lo};
  for (int i = 0; i < 4; ++i) {
    const uint64_t rows = (uint64_t)(batch * (i < 2 ? M : N));
    const uint64_t dims[2] = {(uint64_t)Kp, rows};
    const uint64_t strides[1] = {(uint64_t)Kp * 4};
    const uint32_t box[2] = {G_BK, (uint32_t)(i < 2 ? G_BM : G_BN)};
    cudaError_t err = hopper::make_tensor_map(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, planes[i], dims, strides,
        box);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      tf32x3_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err != cudaSuccess) return (int)err;
  tf32x3_gemm_kernel<<<(unsigned)tiles, G_THREADS, G_SMEM,
                       (cudaStream_t)stream>>>(maps[0], maps[1], maps[2],
                                               maps[3], C, (int)M, (int)N,
                                               (int)Kp);
  return (int)cudaGetLastError();
}

extern "C" int repro_fused_gemm(const i64* desc, i64 tiles, int kara,
                                const float* a0, const float* a1,
                                const float* b0, const float* b1, float* c0,
                                float* c1, void* stream) {
  if (tiles <= 0 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (kara)
    fused_gemm_kernel<true><<<(unsigned)tiles, NT, 0, st>>>(desc, a0, a1, b0,
                                                          b1, c0, c1);
  else
    fused_gemm_kernel<false><<<(unsigned)tiles, NT, 0, st>>>(desc, a0, a1, b0,
                                                           b1, c0, c1);
  return (int)cudaGetLastError();
}

// Blocks of the persistent chain grid: as many as can be resident at
// once, but no more than the largest step has tiles.
extern "C" int repro_chain_grid(int kara, i64 max_tiles, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = kara ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &per_sm, chain_gemm_kernel<true>, NT, 0)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &per_sm, chain_gemm_kernel<false>, NT, 0);
  if (err != cudaSuccess) return (int)err;
  i64 g = (i64)sms * per_sm;
  if (max_tiles < g) g = max_tiles;
  *grid = g < 1 ? 1 : (int)g;
  return 0;
}

extern "C" int repro_chain_gemm(int nsteps, int kara, const i64* const* descs,
                                const i64* tiles, const float* const* a0,
                                const float* const* a1, const float* const* b0,
                                const float* const* b1, float* const* c0,
                                float* const* c1, unsigned int* bar, int grid,
                                void* stream) {
  if (nsteps < 1 || nsteps > MAX_CHAIN || grid < 1)
    return (int)cudaErrorInvalidValue;
  ChainArgs args;
  for (int t = 0; t < nsteps; ++t) {
    args.desc[t] = descs[t];
    args.tiles[t] = tiles[t];
    args.a0[t] = a0[t];
    args.a1[t] = a1[t];
    args.b0[t] = b0[t];
    args.b1[t] = b1[t];
    args.c0[t] = c0[t];
    args.c1[t] = c1[t];
  }
  args.nsteps = nsteps;
  void* params[] = {&args, &bar};
  const void* fn = kara ? (const void*)chain_gemm_kernel<true>
                        : (const void*)chain_gemm_kernel<false>;
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(NT),
                                                params, 0,
                                                (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
