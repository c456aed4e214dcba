// Mamba-2 SSD intra-chunk kernel for Hopper (sm_90a), fp32 FFMA.
//
// Replaces the TPU kernel ssd_intra_chunk (_ssd_chunk_kernel) of
// src/repro/kernels/mamba2_ssd.py.  For one (bh, chunk) cell with chunk
// length L, head dim D and state size S:
//
//   cum[i]   = a[0] + ... + a[i]                        (in-chunk cumsum)
//   Lmat[i,j] = exp(cum[i] - cum[j]) if i >= j else 0   (decay matrix)
//   y        = ((C B^T) * Lmat) @ (dt * X)              (L x D)
//   state    = sum_j exp(cum[L-1] - cum[j]) B_j^T (dt_j X_j)   (S x D)
//
// The decay matrix is masked with a select, as the TPU kernel's where:
// above the diagonal exp(cum[i] - cum[j]) has a positive exponent and may
// overflow, and inf * 0 would give NaN.
//
// Head-free B/C: in the model B and C have no head axis (ngroups = 1).
// The kernel takes them with a leading group axis G that divides BH and
// reads group bh / (BH / G), so the wrapper never materialises one copy
// per head.  With G = BH this is the TPU kernel's function exactly.
//
// Grid: one block per (bh, chunk), 256 threads.  The cell's B, C, dt*X
// and the L x L score tile sit in shared memory (at mamba2-130m, L = 64,
// D = 64, S = 128: about 100 KB in fp32), rows padded to S + 1 and L + 1
// floats so the dot products read without bank conflicts.  The cumsum is
// one ordered sum by one thread (64 adds).
//
// What bounds it on the H100: at the serve shapes (BH 96, 8 chunks of 64,
// D 64, S 128, head-free B/C) the function needs 1.4e9 fp32 operations
// (the lower triangle of C B^T and of the y product, the full state
// product) and moves 53 MB (x, y and the chunk states dominate), so the
// bound is the operations, 21 us at 67 TFLOP/s, just above the bytes'
// 16 us.  Each output element here is one dot product read from shared
// memory (one shared load per FFMA, half the score threads idle above
// the diagonal), so the kernel is bound by shared-memory bandwidth.
// Simple and right first: register tiles and wgmma for the three
// products come later.

#include <cuda_runtime.h>
#include <stdint.h>

#define SSD_NT 256

static size_t ssd_smem_bytes(int L, int D, int S) {
  // cum[L], dec[L], xdt[L][D], b[L][S+1], c[L][S+1], sc[L][L+1]
  return sizeof(float) * ((size_t)2 * L + (size_t)L * D +
                          (size_t)2 * L * (S + 1) + (size_t)L * (L + 1));
}

__global__ void __launch_bounds__(SSD_NT)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ c, float* __restrict__ y,
                 float* __restrict__ st, int C, int L, int D, int S,
                 int heads_per_group) {
  extern __shared__ float smem[];
  float* cum = smem;                 // [L]
  float* dec = cum + L;              // [L] exp(cum[L-1] - cum[j])
  float* xdt = dec + L;              // [L][D]
  float* bs = xdt + L * D;           // [L][S+1]
  float* cs = bs + L * (S + 1);      // [L][S+1]
  float* sc = cs + L * (S + 1);      // [L][L+1]

  const long long cell = blockIdx.x;  // bh * C + chunk
  const long long bh = cell / C;
  const long long chunk = cell - bh * C;
  const long long gcell = (bh / heads_per_group) * C + chunk;
  const float* xb = x + cell * L * D;
  const float* dtb = dt + cell * L;
  const float* ab = a + cell * L;
  const float* bb = b + gcell * L * S;
  const float* cb = c + gcell * L * S;
  float* yb = y + cell * L * D;
  float* sb = st + cell * (long long)S * D;
  const int tid = threadIdx.x;

  for (int i = tid; i < L; i += SSD_NT) cum[i] = ab[i];
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < L; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  for (int e = tid; e < L * D; e += SSD_NT) {
    const int i = e / D;
    xdt[e] = xb[e] * dtb[i];
  }
  for (int e = tid; e < L * S; e += SSD_NT) {
    const int i = e / S, s = e - i * S;
    bs[i * (S + 1) + s] = bb[e];
    cs[i * (S + 1) + s] = cb[e];
  }
  __syncthreads();
  for (int j = tid; j < L; j += SSD_NT) dec[j] = expf(cum[L - 1] - cum[j]);

  // scores = (C B^T) * Lmat, masked by select
  for (int e = tid; e < L * L; e += SSD_NT) {
    const int i = e / L, j = e - i * L;
    float v = 0.f;
    if (i >= j) {
      const float* ci = cs + i * (S + 1);
      const float* bj = bs + j * (S + 1);
      for (int s = 0; s < S; ++s) v = fmaf(ci[s], bj[s], v);
      v *= expf(cum[i] - cum[j]);
    }
    sc[i * (L + 1) + j] = v;
  }
  __syncthreads();

  // y = scores @ xdt (zeros above the diagonal are skipped)
  for (int e = tid; e < L * D; e += SSD_NT) {
    const int i = e / D, dd = e - i * D;
    const float* si = sc + i * (L + 1);
    float v = 0.f;
    for (int j = 0; j <= i; ++j) v = fmaf(si[j], xdt[j * D + dd], v);
    yb[e] = v;
  }

  // state = (B * dec)^T @ xdt
  for (int e = tid; e < S * D; e += SSD_NT) {
    const int s = e / D, dd = e - s * D;
    float v = 0.f;
    for (int j = 0; j < L; ++j)
      v = fmaf(bs[j * (S + 1) + s] * dec[j], xdt[j * D + dd], v);
    sb[e] = v;
  }
}

// ---------------------------------------------------------- C interface
// Launches on the given stream, does not synchronise, and returns
// cudaGetLastError() (0 on success).

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" long long repro_ssd_chunk_smem(int L, int D, int S) {
  return (long long)ssd_smem_bytes(L, D, S);
}

extern "C" int repro_ssd_chunk(const float* x, const float* dt,
                               const float* a, const float* b, const float* c,
                               float* y, float* st, long long cells, int C,
                               int L, int D, int S, int heads_per_group,
                               void* stream) {
  if (cells <= 0 || cells > 0x7fffffffLL || C < 1 || L < 1 || D < 1 ||
      S < 1 || heads_per_group < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ssd_smem_bytes(L, D, S);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<<<(unsigned)cells, SSD_NT, smem, (cudaStream_t)stream>>>(
      x, dt, a, b, c, y, st, C, L, D, S, heads_per_group);
  return (int)cudaGetLastError();
}
