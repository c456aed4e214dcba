// Contraction GEMM kernels for Hopper (sm_90a), exact fp32 on the CUDA cores.
//
// Three kernels, one per TPU kernel of src/repro/kernels/contract_gemm.py:
//
//   tiled_gemm_kernel  <- tiled_matmul (_matmul_kernel)
//       C[b] = A[b] @ B[b], row-major fp32, masked at the ragged edge.
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
// All three share one tile routine: 64x64 output tile, K in slices of 16,
// 256 threads each holding a 4x4 register block, FFMA only (no TF32 mma),
// one ordered sum over K per output element (no split-K, no atomics), so
// the result does not depend on the launch geometry.  Complex steps run
// the 3-real-GEMM Karatsuba on split re/im planes inside the tile:
//   P1 = Ar.Br, P2 = Ai.Bi, P3 = (Ar+Ai).(Br+Bi)
//   C_re = P1 - P2, C_im = (P3 - P1) - P2.
//
// What bounds them on the H100: the tile loop issues 2 FFMA per 2 shared
// loads, well short of the 67 TFLOP/s fp32 peak; the fused and chain
// kernels also gather their operands element by element through the
// offset tables, which costs uncoalesced loads when the native layout's
// fastest axis is not the tile's fastest axis.  The chain steps are
// mostly small GEMMs, so the chain kernel is bound by the grid barriers
// and by too few tiles per step to fill 132 SMs.  These are simple
// kernels that are right first; wgmma/TMA and speed come later.

#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void __launch_bounds__(NT)
tiled_gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, i64 M, i64 N, i64 K) {
  __shared__ float As[BK][BM + APAD];
  __shared__ float Bs[BK][BN];
  const i64 tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const i64 tile = blockIdx.x;
  const i64 nt = tile % tiles_n;
  const i64 mt = (tile / tiles_n) % tiles_m;
  const i64 bt = tile / (tiles_n * tiles_m);
  const i64 m0 = mt * BM, n0 = nt * BN;
  const float* Ab = A + bt * M * K;
  const float* Bb = B + bt * K * N;
  float* Cb = C + bt * M * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (i64 k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / NT; ++r) {
      const int e = tid + NT * r;
      const int mi = e / BK, ki = e % BK;
      const i64 m = m0 + mi, k = k0 + ki;
      As[ki][mi] = (m < M && k < K) ? __ldg(Ab + m * K + k) : 0.f;
      const int kj = e / BN, ni = e % BN;
      const i64 kk = k0 + kj, n = n0 + ni;
      Bs[kj][ni] = (kk < K && n < N) ? __ldg(Bb + kk * N + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int ki = 0; ki < BK; ++ki) {
      float xa[4], yb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = As[ki][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) yb[j] = Bs[ki][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xa[i], yb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const i64 m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const i64 n = n0 + tx + 16 * j;
      if (n < N) Cb[m * N + n] = acc[i][j];
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

extern "C" int repro_tiled_gemm(const float* A, const float* B, float* C,
                                i64 batch, i64 M, i64 N, i64 K,
                                void* stream) {
  const i64 tiles = batch * ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (tiles <= 0 || tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tiled_gemm_kernel<<<(unsigned)tiles, NT, 0, (cudaStream_t)stream>>>(
      A, B, C, M, N, K);
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
