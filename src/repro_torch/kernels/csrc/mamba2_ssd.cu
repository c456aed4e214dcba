// Mamba-2 SSD intra-chunk kernels for Hopper (sm_90a).
//
// Replace the TPU kernel ssd_intra_chunk (_ssd_chunk_kernel) of
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
// The kernels take them with a leading group axis G that divides BH and
// read group bh / (BH / G), so the wrapper never materialises one copy
// per head.  With G = BH this is the TPU kernel's function exactly.
//
// Two kernels, chosen by shape in the wrapper (mamba2_ssd.ssd_route):
//
//   ssd_chunk_wgmma_kernel  L = 64, D a multiple of 64, S = 64 or 128
//       (the model's shapes): 3xTF32 on wgmma fed by TMA, one block per
//       (group, chunk, block of heads of that group); see its note.
//   ssd_chunk_kernel        every other shape (the tests' small ones):
//       fp32 FFMA, one block per (bh, chunk).
//
// The training path's backward is routed by the same rule:
// ssd_chunk_bwd_wgmma_kernel (3xTF32 wgmma, one block per (group, chunk,
// block of heads), "backward, wgmma" below) for the wgmma shapes,
// ssd_chunk_bwd_kernel (FFMA, one block per cell, "backward" below) for
// every other shape whose cell fits one block's shared memory.
//
// What bounds K5 on the H100: at the serve shape (BH 96, 8 chunks of 64,
// D 64, S 128, 4 head-free B/C groups) the function moves 52.8 MB (x, y
// and the chunk states dominate): 15.8 us at 3.35 TB/s.  With C B^T once
// per (group, chunk) its products are ~1.0 GFLOP, 6.3 us as 3xTF32 at a
// third of the 495 TFLOP/s TF32 peak, so the bound is the bytes.  The
// FFMA kernel recomputes C B^T for every head and reads every operand of
// each product from shared memory, so it is bound by shared-memory
// bandwidth far above that.  The wgmma kernel runs at about twice the
// bound; launch/ssd_variants.py times it with its parts taken out (no
// one part holds it: each block works through its heads one after the
// other, and a head's planes, products and stores each cost about the
// same).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// ---------------------------------------------------------------- simt
// One block per (bh, chunk), 256 threads.  The cell's B, C, dt*X and the
// L x L score tile sit in shared memory, rows padded to S + 1 and L + 1
// floats so the dot products read without bank conflicts; the cumsum is
// one ordered sum by one thread.  Each output element is one dot product
// read from shared memory.
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

// ---------------------------------------------------------------- wgmma
// One block per work item (group g, chunk c, a block of up to `hb`
// heads of g), 384 threads in three warpgroups:
//
//   WG2, producers.  Thread 0 TMA-loads the chunk's C and B (64 x S fp32,
//     128-byte-swizzled K-major tiles of 32 floats) and keeps the loads
//     of the next two units in flight (a unit is one head and one 64-wide
//     tile of its head dim: x's 64 x 64 tile by TMA, dt and a by bulk
//     copy).  The warpgroup splits C and B into TF32 hi/lo planes (hi
//     over the raw values, in place) and, after a barrier of the
//     warpgroup (each thread's B^T column crosses every other warp's
//     split), writes B^T's planes (the state product's A operand, M = S,
//     K = j), shared by every head of the item.  Per unit: warp 0 takes the cumsum as a warp scan and dec_j
//     = exp(cum[L-1] - cum[j]); all write the K-major planes of
//     xdt^T[d][j] and (dec * xdt)^T[d][j], hi and lo, into one stage of a
//     two-stage ring (folding dec_j into xdt's rows is exact algebra and
//     keeps B^T head-free).  Stores are fenced (fence.proxy.async)
//     before a stage is signalled.
//   WG0, y.  Once per item, C B^T (M = N = L, K = S) as 3xTF32 into
//     registers, where it stays.  Per unit the masked scores are taken by
//     select from those registers (exp(cum_i - cum_j) if i >= j, else 0;
//     the select comes before the hi/lo split, as inf - inf is NaN) and
//     fed to wgmma as A from registers.  The accumulator holds columns
//     2q, 2q+1 of each 8-block where the A fragment holds k slots q, q+4,
//     so k is permuted: slot p of every 8-block of k holds j = 2p (p < 4)
//     or 2(p - 4) + 1, and the producers write their planes in that
//     order.
//   WG1, state.  Per unit, for each 64-row tile of S: B^T . (dec xdt),
//     3xTF32 from shared memory.
//
// As in K1 and K2 each 32-wide k-tile's products go to a fresh wgmma
// partial added by FADD: the tensor cores' accumulation does not round
// to nearest.  setmaxnreg gives the producers 72 registers and the
// consumers 216.  Every mbarrier wait traps after ~8.7 s.
//
// Shared memory (S = 128): B^T planes 64 KB, two stages of four 16 KB
// planes (128 KB; C's and B's planes occupy them before the first unit),
// the x ring 2 x 16 KB, the dt/a ring, cum, dec and the barriers:
// 232,320 bytes of the 232,448 a block may use.
#define W_THREADS 384
// registers a thread after setmaxnreg: ptxas gives a kernel that uses it
// the launch bound's 168, and 128 x 72 + 256 x 216 = 384 x 168
#define W_PREG 72
#define W_CREG 216
#define W_SUB 8192                  // 64 rows x 128 bytes, one k-subtile
#define W_PLANE (2 * W_SUB)         // 64 rows x 64 k
#define W_STAGE (4 * W_PLANE)       // xdt^T hi, lo, (dec xdt)^T hi, lo
#define W_XTILE (2 * W_SUB)         // x: 64 rows x 64 floats

enum { B_CB_FULL, B_CB_READY, B_CB_DONE, B_BT_READY, B_XFULL, B_FULL = 6,
       B_EMPTY = 8, B_COUNT = 10 };

struct WgmmaSmem {
  int bt, stg, xr, da, cum, dec, bar, total;
  __host__ __device__ explicit WgmmaSmem(int S) {
    bt = 0;                        // B^T hi, lo: S rows x 64 k each
    stg = S * 512;
    xr = stg + 2 * W_STAGE;
    da = xr + 2 * W_XTILE;         // per stage: dt[64], a[64]
    cum = da + 2 * 512;            // per stage: cum[64]
    dec = cum + 2 * 256;
    bar = dec + 256;
    total = bar + 8 * B_COUNT + 1024;  // + alignment slack
  }
};

// Byte offset of element (row, k) in a 128-byte-swizzled K-major tile of
// fp32 with 32 k per row (the layout TMA's SWIZZLE_128B writes).
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + ((k & 3) << 2);
}

// Byte offset of 16-byte chunk c (k slots 4c .. 4c+3, c < 16) of row
// `row` in a K-major operand of 64 k: two subtiles of `rows` rows.
__device__ __forceinline__ int chunk_off(int row, int c, int rows) {
  return (c >> 3) * rows * 128 + row * 128 + ((((c & 7) ^ row) & 7) << 4);
}

// The j held by k slot 4 (c & 1) + k of 8-block c >> 1 (k < 4).
__device__ __forceinline__ int slot_j(int c, int k) {
  return 8 * (c >> 1) + (c & 1) + 2 * k;
}

__device__ __forceinline__ void split4(const float (&x)[4], float4& hi,
                                       float4& lo) {
  hi = make_float4(hopper::tf32_rna(x[0]), hopper::tf32_rna(x[1]),
                   hopper::tf32_rna(x[2]), hopper::tf32_rna(x[3]));
  lo = make_float4(hopper::tf32_rna(x[0] - hi.x), hopper::tf32_rna(x[1] - hi.y),
                   hopper::tf32_rna(x[2] - hi.z), hopper::tf32_rna(x[3] - hi.w));
}

// One 32-wide k-tile (four k8 steps) as three TF32 products from shared
// memory into a fresh sum: d = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.  a, b:
// the k-tile's hi planes; their lo planes lie a_lo, b_lo bytes further.
__device__ __forceinline__ void ktile_ss(float (&d)[32], const uint8_t* a,
                                         int a_lo, const uint8_t* b,
                                         int b_lo) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t ah = hopper::desc_kmajor(a + 32 * k);
    const uint64_t al = hopper::desc_kmajor(a + a_lo + 32 * k);
    const uint64_t bh = hopper::desc_kmajor(b + 32 * k);
    const uint64_t bl = hopper::desc_kmajor(b + b_lo + 32 * k);
    hopper::wgmma_m64n64k8_tf32_ss<1>(d, al, bh, k > 0 ? 1 : 0);
    hopper::wgmma_m64n64k8_tf32_ss<1>(d, ah, bl, 1);
    hopper::wgmma_m64n64k8_tf32_ss<1>(d, ah, bh, 1);
  }
}

// The same with A from registers: four k8 steps' hi and lo fragments.
__device__ __forceinline__ void ktile_rs(float (&d)[32],
                                         const uint32_t (&ah)[4][4],
                                         const uint32_t (&al)[4][4],
                                         const uint8_t* b, int b_lo) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t bh = hopper::desc_kmajor(b + 32 * k);
    const uint64_t bl = hopper::desc_kmajor(b + b_lo + 32 * k);
    hopper::wgmma_m64n64k8_tf32_rs(d, al[k], bh, k > 0 ? 1 : 0);
    hopper::wgmma_m64n64k8_tf32_rs(d, ah[k], bl, 1);
    hopper::wgmma_m64n64k8_tf32_rs(d, ah[k], bh, 1);
  }
}

// A 64 x 64 accumulator (this thread: rows r0 and r0 + 8, columns 2q and
// 2q + 1 of each n8 block) into `out` (row stride ld floats).
__device__ __forceinline__ void store_tile(float* out, long long ld,
                                           const float (&acc)[32], int r0,
                                           int q) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* row = out + (long long)(r0 + 8 * h) * ld + 2 * q;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
      *reinterpret_cast<float2*>(row + 8 * jb) =
          make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
  }
}

__global__ void __launch_bounds__(W_THREADS, 1)
ssd_chunk_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap cmap,
                       const __grid_constant__ CUtensorMap bmap,
                       const float* __restrict__ dt,
                       const float* __restrict__ a, float* __restrict__ y,
                       float* __restrict__ st, int C, int D, int S, int hpg,
                       int hb) {
  extern __shared__ uint8_t w_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(w_smem_raw) + 1023) & ~uintptr_t(1023));
  const WgmmaSmem lay(S);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bar);
  float* cums = reinterpret_cast<float*>(smem + lay.cum);
  float* decs = reinterpret_cast<float*>(smem + lay.dec);
  uint8_t* stg = smem + lay.stg;

  const int nhb = (hpg + hb - 1) / hb;
  const int gc = blockIdx.x / nhb;  // g * C + c
  const int c = gc % C, g = gc / C;
  const int h0 = (blockIdx.x % nhb) * hb;
  const int dtiles = D / 64;
  const int units = min(hb, hpg - h0) * dtiles;
  const int plane_c = S * 256;  // C's (and B's) hi plane; lo follows

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars[B_CB_FULL], 1);
    hopper::mbar_init(&bars[B_CB_READY], 128);  // every producer thread
    hopper::mbar_init(&bars[B_CB_DONE], 1);
    hopper::mbar_init(&bars[B_BT_READY], 128);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&bars[B_XFULL + s], 1);
      hopper::mbar_init(&bars[B_FULL + s], 128);
      hopper::mbar_init(&bars[B_EMPTY + s], 2);  // each consumer warpgroup
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  // unit u: head h0 + u / dtiles, head-dim tile u % dtiles, ring slot u & 1
  auto cell_of = [&](int u) {
    return (long long)(g * hpg + h0 + u / dtiles) * C + c;
  };
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(W_PREG));
    auto load_unit = [&](int u) {
      const int s = u & 1;
      const long long cell = cell_of(u);
      const int d0 = 64 * (u % dtiles);
      uint64_t* bar = &bars[B_XFULL + s];
      uint8_t* xs = smem + lay.xr + s * W_XTILE;
      uint8_t* da = smem + lay.da + s * 512;
      hopper::mbar_arrive_expect_tx(bar, W_XTILE + 512);
      hopper::tma_load_2d(xs, &xmap, bar, d0, (int)(cell * 64));
      hopper::tma_load_2d(xs + W_SUB, &xmap, bar, d0 + 32, (int)(cell * 64));
      hopper::bulk_load(da, dt + cell * 64, 256, bar);
      hopper::bulk_load(da + 256, a + cell * 64, 256, bar);
    };
    if (t == 0) {
      uint64_t* bar = &bars[B_CB_FULL];
      hopper::mbar_arrive_expect_tx(bar, 2 * plane_c);
      for (int k = 0; k < S / 32; ++k) {
        hopper::tma_load_2d(stg + k * W_SUB, &cmap, bar, 32 * k, gc * 64);
        hopper::tma_load_2d(stg + 2 * plane_c + k * W_SUB, &bmap, bar, 32 * k,
                            gc * 64);
      }
      for (int u = 0; u < 2 && u < units; ++u) load_unit(u);
    }
    // C and B into TF32 hi (in place) and lo planes
    hopper::mbar_wait(&bars[B_CB_FULL], 0);
    for (int e = t; e < 2 * S * 16; e += 128) {
      const int m = e / (S * 16), f = e % (S * 16);  // matrix, float4
      uint8_t* p = stg + 2 * m * plane_c + 16 * f;
      const float4 v = *reinterpret_cast<const float4*>(p);
      const float x[4] = {v.x, v.y, v.z, v.w};
      float4 hi, lo;
      split4(x, hi, lo);
      hopper::sts_v4(hopper::smem_u32(p), hi);
      hopper::sts_v4(hopper::smem_u32(p + plane_c), lo);
    }
    hopper::fence_proxy_async();
    hopper::mbar_arrive(&bars[B_CB_READY]);
    // a thread's B^T column reads elements other warps split
    hopper::named_barrier(1, 128);
    // B^T planes: row s of S, k slots in the permuted j order
    const uint8_t* bpl = stg + 2 * plane_c;
    for (int e = t; e < S * 16; e += 128) {
      const int sr = e % S, ch = e / S;
      float xh[4], xl[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int off = (sr >> 5) * W_SUB + swz(slot_j(ch, k), sr & 31);
        xh[k] = *reinterpret_cast<const float*>(bpl + off);
        xl[k] = *reinterpret_cast<const float*>(bpl + plane_c + off);
      }
      const uint32_t o = hopper::smem_u32(smem + lay.bt + chunk_off(sr, ch, S));
      hopper::sts_v4(o, make_float4(xh[0], xh[1], xh[2], xh[3]));
      hopper::sts_v4(o + S * 256, make_float4(xl[0], xl[1], xl[2], xl[3]));
    }
    hopper::fence_proxy_async();
    hopper::mbar_arrive(&bars[B_BT_READY]);
    // the stages overwrite C's and B's planes once C B^T is done
    hopper::mbar_wait(&bars[B_CB_DONE], 0);
    for (int u = 0; u < units; ++u) {
      const int s = u & 1;
      hopper::mbar_wait(&bars[B_XFULL + s], (u >> 1) & 1);
      if (u >= 2) hopper::mbar_wait(&bars[B_EMPTY + s], ((u >> 1) - 1) & 1);
      const float* dts = reinterpret_cast<const float*>(smem + lay.da + s * 512);
      if (w == 0) {
        // cumsum as a warp scan: lane l holds a[2l] and a[2l+1]
        const float a0 = dts[64 + 2 * lane], a1 = dts[64 + 2 * lane + 1];
        float run = a0 + a1;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float n = __shfl_up_sync(0xffffffffu, run, off);
          if (lane >= off) run += n;
        }
        float excl = __shfl_up_sync(0xffffffffu, run, 1);
        if (lane == 0) excl = 0.f;
        const float c0 = excl + a0, c1 = c0 + a1;
        const float last = __shfl_sync(0xffffffffu, c1, 31);
        cums[64 * s + 2 * lane] = c0;
        cums[64 * s + 2 * lane + 1] = c1;
        decs[2 * lane] = expf(last - c0);
        decs[2 * lane + 1] = expf(last - c1);
      }
      hopper::named_barrier(1, 128);
      // xdt^T and (dec xdt)^T: chunk (d, ch) reads x[j][d] down a column;
      // a warp's lanes take 32 consecutive d (one row of x, no conflicts)
      const uint8_t* xs = smem + lay.xr + s * W_XTILE;
      uint8_t* sp = stg + s * W_STAGE;
#pragma unroll 2
      for (int r = 0; r < 8; ++r) {
        const int e = t + 128 * r;
        const int d = e & 63, ch = e >> 6;
        const uint8_t* xb = xs + (d >> 5) * W_SUB;
        float xv[4], vv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = slot_j(ch, k);
          xv[k] = *reinterpret_cast<const float*>(xb + swz(j, d & 31)) * dts[j];
          vv[k] = xv[k] * decs[j];
        }
        const uint32_t o = hopper::smem_u32(sp + chunk_off(d, ch, 64));
        float4 hi, lo;
        split4(xv, hi, lo);
        hopper::sts_v4(o, hi);
        hopper::sts_v4(o + W_PLANE, lo);
        split4(vv, hi, lo);
        hopper::sts_v4(o + 2 * W_PLANE, hi);
        hopper::sts_v4(o + 3 * W_PLANE, lo);
      }
      hopper::fence_proxy_async();
      hopper::mbar_arrive(&bars[B_FULL + s]);
      hopper::named_barrier(1, 128);  // x, dt and a of slot s are read
      if (t == 0 && u + 2 < units) load_unit(u + 2);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(W_CREG));
  const int q = lane % 4;
  const int r0 = 16 * w + lane / 4;  // this thread's rows: r0 and r0 + 8
  float acc[32], part[32];
  if (wg == 0) {
    // C B^T, a fresh partial per 32-wide k-tile of S
    float cbt[32];
    hopper::mbar_wait(&bars[B_CB_READY], 0);
    hopper::wgmma_fence();
    hopper::fence_regs(cbt);
    ktile_ss(cbt, stg, plane_c, stg + 2 * plane_c, plane_c);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(cbt);
    for (int kt = 1; kt < S / 32; ++kt) {
      hopper::wgmma_fence();
      hopper::fence_regs(part);
      ktile_ss(part, stg + kt * W_SUB, plane_c, stg + 2 * plane_c + kt * W_SUB,
               plane_c);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) cbt[i] += part[i];
    }
    if (t == 0) hopper::mbar_arrive(&bars[B_CB_DONE]);

    for (int u = 0; u < units; ++u) {
      const int s = u & 1;
      hopper::mbar_wait(&bars[B_FULL + s], (u >> 1) & 1);
      const float* cum = cums + 64 * s;
      const float ci[2] = {cum[r0], cum[r0 + 8]};
      // masked scores as A fragments: the accumulator's n8 block kk is k8
      // step kk, its columns (2q, 2q + 1) the slots (q, q + 4)
      uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int j = 8 * kk + 2 * q;
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        float v[4];  // a0..a3: (r0, j), (r0 + 8, j), (r0, j+1), (r0 + 8, j+1)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = r0 + 8 * h;
          v[h] = i >= j ? cbt[4 * kk + 2 * h] * expf(ci[h] - cj.x) : 0.f;
          v[2 + h] =
              i > j ? cbt[4 * kk + 2 * h + 1] * expf(ci[h] - cj.y) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float hi = hopper::tf32_rna(v[r]);
          ah[kk >> 2][kk & 3][r] = __float_as_uint(hi);
          al[kk >> 2][kk & 3][r] = __float_as_uint(hopper::tf32_rna(v[r] - hi));
        }
      }
      const uint8_t* xp = stg + s * W_STAGE;  // xdt^T hi; lo a plane further
      hopper::wgmma_fence();
      hopper::fence_regs(acc);
      hopper::fence_regs(part);
      ktile_rs(acc, ah[0], al[0], xp, W_PLANE);
      ktile_rs(part, ah[1], al[1], xp + W_SUB, W_PLANE);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(part);
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          hopper::fence_regs(ah[kt][kk]);
          hopper::fence_regs(al[kt][kk]);
        }
      if (t == 0) hopper::mbar_arrive(&bars[B_EMPTY + s]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
      store_tile(y + cell_of(u) * 64 * D + 64 * (u % dtiles), D, acc, r0, q);
    }
    return;
  }

  // WG1: chunk states, B^T . (dec xdt) per 64-row tile of S
  hopper::mbar_wait(&bars[B_BT_READY], 0);
  const uint8_t* bt = smem + lay.bt;
  for (int u = 0; u < units; ++u) {
    const int s = u & 1;
    hopper::mbar_wait(&bars[B_FULL + s], (u >> 1) & 1);
    const uint8_t* vp = stg + s * W_STAGE + 2 * W_PLANE;  // (dec xdt)^T hi
    float* out = st + cell_of(u) * S * D + 64 * (u % dtiles);
    for (int mt = 0; mt < S / 64; ++mt) {
      const uint8_t* am = bt + mt * W_SUB;
      hopper::wgmma_fence();
      hopper::fence_regs(acc);
      hopper::fence_regs(part);
      ktile_ss(acc, am, S * 256, vp, W_PLANE);
      ktile_ss(part, am + S * 128, S * 256, vp + W_SUB, W_PLANE);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(part);
      if (t == 0 && mt == S / 64 - 1) hopper::mbar_arrive(&bars[B_EMPTY + s]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[i];
      store_tile(out + (long long)64 * mt * D, D, acc, r0, q);
    }
  }
}

// ------------------------------------------------------------ backward
// The training path's gradient of the intra-chunk function, FFMA on the
// CUDA cores, one block per (bh, chunk) cell, 512 threads.  The reference
// differentiates its jnp chunked SSD (src/repro/models/layers.py); there
// is no TPU kernel to replace.  With Xd = dt * X, M = (C B^T) * Lmat,
// w_j = exp(cum[L-1] - cum[j]) and the incoming gy (L x D), gst (S x D):
//
//   gXd   = M^T gy + w * (B gst)          gM = gy Xd^T  (lower triangle)
//   G     = gM * Lmat                     gC = G B,  gB = G^T C + w * (Xd gst^T)
//   gcum  = rowsum(gM * M) - colsum(gM * M) - gw * w  (+ sum(gw * w) at L-1),
//           gw_j = B_j . (gst Xd_j)
//   ga    = reverse cumsum of gcum;  gdt = rowsum(gXd * X);  gx = gXd * dt
//
// Lmat is taken by select before exp (exp(cum_i - cum_j) only where
// i >= j): after exp a select would still give 0 * inf = NaN where the
// exponent overflows above the diagonal.  gB and gC are written per head
// (the cell's share); ssd_bwd_group_sum_kernel then sums a group's heads
// in head order.  No atomics: every element is one ordered sum.
//
// What bounds it on the H100: at mamba2-130m's training shape (BH 96,
// 8 chunks of 64, D 64, S 128, 4 B/C groups) the function moves 68 MB
// (x, dt, a, b, c, gy, gst in; gx, gdt, ga, gb, gc out), 20.3 us at 3.35
// TB/s, as chip_smoke.py reckons; this kernel moves 100 MB more (the
// per-head gB/gC shares, 50 MB, written and read back by the group sum)
// and runs its products by FFMA from shared memory, far slower than that
// (time and bound in PERF.md).
#define SSD_BWD_NT 512

static size_t ssd_bwd_smem_bytes(int L, int D, int S) {
  // cum, w, dt, gw, gcum [L]; xd, gy, gxd, bg [L][D+1]; gst [S][D+1];
  // b, c [L][S+1]; M, G, Q [L][L+1].  Every row is padded by one float,
  // so a warp reading down a column hits 32 banks
  return sizeof(float) * ((size_t)5 * L + (size_t)4 * L * (D + 1) +
                          (size_t)S * (D + 1) + (size_t)2 * L * (S + 1) +
                          (size_t)3 * L * (L + 1));
}

__global__ void __launch_bounds__(SSD_BWD_NT)
ssd_chunk_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ c,
                     const float* __restrict__ gy,
                     const float* __restrict__ gst, float* __restrict__ gx,
                     float* __restrict__ gdt, float* __restrict__ ga,
                     float* __restrict__ gb_part, float* __restrict__ gc_part,
                     int C, int L, int D, int S, int heads_per_group) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* cum = smem;              // [L]
  float* w = cum + L;             // [L] exp(cum[L-1] - cum[j])
  float* dts = w + L;             // [L]
  float* gw = dts + L;            // [L]
  float* gcum = gw + L;           // [L]
  float* xd = gcum + L;           // [L][D+1]
  float* gys = xd + L * DP;       // [L][D+1]
  float* gxd = gys + L * DP;      // [L][D+1]
  float* bg = gxd + L * DP;       // [L][D+1]: B gst
  float* gs = bg + L * DP;        // [S][D+1]: gst
  float* bs = gs + S * DP;        // [L][S+1]
  float* cs = bs + L * (S + 1);   // [L][S+1]
  float* ms = cs + L * (S + 1);   // [L][L+1]: M
  float* gm = ms + L * (L + 1);   // [L][L+1]: G = gM * Lmat
  float* qm = gm + L * (L + 1);   // [L][L+1]: gM * M

  const long long cell = blockIdx.x;  // bh * C + chunk
  const long long bh = cell / C;
  const long long chunk = cell - bh * C;
  const long long gcell = (bh / heads_per_group) * C + chunk;
  const float* xb = x + cell * L * D;
  const float* bb = b + gcell * L * S;
  const float* cb = c + gcell * L * S;
  const float* gyb = gy + cell * L * D;
  const float* gsb = gst + cell * (long long)S * D;
  const int tid = threadIdx.x;

  for (int i = tid; i < L; i += SSD_BWD_NT) {
    cum[i] = a[cell * L + i];
    dts[i] = dt[cell * L + i];
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.f;
    for (int i = 0; i < L; ++i) {
      run += cum[i];
      cum[i] = run;
    }
  }
  for (int e = tid; e < L * D; e += SSD_BWD_NT) {
    const int i = e / D, dd = e - i * D;
    xd[i * DP + dd] = xb[e] * dts[i];
    gys[i * DP + dd] = gyb[e];
  }
  for (int e = tid; e < S * D; e += SSD_BWD_NT) {
    const int s = e / D, dd = e - s * D;
    gs[s * DP + dd] = gsb[e];
  }
  for (int e = tid; e < L * S; e += SSD_BWD_NT) {
    const int i = e / S, s = e - i * S;
    bs[i * (S + 1) + s] = bb[e];
    cs[i * (S + 1) + s] = cb[e];
  }
  __syncthreads();
  for (int j = tid; j < L; j += SSD_BWD_NT) w[j] = expf(cum[L - 1] - cum[j]);

  // M, G and gM * M on the lower triangle, zeros above it
  for (int e = tid; e < L * L; e += SSD_BWD_NT) {
    const int i = e / L, j = e - i * L;
    float m = 0.f, g = 0.f, qv = 0.f;
    if (i >= j) {
      float cbv = 0.f, gmv = 0.f;
      const float* ci = cs + i * (S + 1);
      const float* bj = bs + j * (S + 1);
      for (int s = 0; s < S; ++s) cbv = fmaf(ci[s], bj[s], cbv);
      const float* gi = gys + i * DP;
      const float* xj = xd + j * DP;
      for (int dd = 0; dd < D; ++dd) gmv = fmaf(gi[dd], xj[dd], gmv);
      const float lm = expf(cum[i] - cum[j]);
      m = cbv * lm;
      g = gmv * lm;
      qv = gmv * m;
    }
    ms[i * (L + 1) + j] = m;
    gm[i * (L + 1) + j] = g;
    qm[i * (L + 1) + j] = qv;
  }
  __syncthreads();

  // gXd = M^T gy + w * (B gst)
  for (int e = tid; e < L * D; e += SSD_BWD_NT) {
    const int j = e / D, dd = e - j * D;
    float v = 0.f, bgv = 0.f;
    for (int i = j; i < L; ++i)
      v = fmaf(ms[i * (L + 1) + j], gys[i * DP + dd], v);
    const float* bj = bs + j * (S + 1);
    for (int s = 0; s < S; ++s) bgv = fmaf(bj[s], gs[s * DP + dd], bgv);
    bg[j * DP + dd] = bgv;
    gxd[j * DP + dd] = fmaf(w[j], bgv, v);
  }
  // this head's share of gC = G B and gB = G^T C + w * (Xd gst^T)
  float* gcp = gc_part + cell * L * S;
  float* gbp = gb_part + cell * L * S;
  for (int e = tid; e < L * S; e += SSD_BWD_NT) {
    const int r = e / S, s = e - r * S;
    float vc = 0.f, vb = 0.f, ev = 0.f;
    for (int j = 0; j <= r; ++j)
      vc = fmaf(gm[r * (L + 1) + j], bs[j * (S + 1) + s], vc);
    for (int i = r; i < L; ++i)
      vb = fmaf(gm[i * (L + 1) + r], cs[i * (S + 1) + s], vb);
    const float* xr = xd + r * DP;
    const float* gsr = gs + s * DP;
    for (int dd = 0; dd < D; ++dd) ev = fmaf(xr[dd], gsr[dd], ev);
    gcp[e] = vc;
    gbp[e] = fmaf(w[r], ev, vb);
  }
  __syncthreads();

  // per row, one warp: gdt = rowsum(gXd * X), gw = rowsum(Xd * B gst);
  // gx = gXd * dt
  const int warp = tid / 32, lane = tid % 32;
  for (int j = warp; j < L; j += SSD_BWD_NT / 32) {
    float vdt = 0.f, vw = 0.f;
    for (int dd = lane; dd < D; dd += 32) {
      const float g = gxd[j * DP + dd];
      vdt = fmaf(g, xb[j * D + dd], vdt);
      vw = fmaf(xd[j * DP + dd], bg[j * DP + dd], vw);
      gx[cell * L * D + j * D + dd] = g * dts[j];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      vdt += __shfl_xor_sync(0xffffffffu, vdt, off);
      vw += __shfl_xor_sync(0xffffffffu, vw, off);
    }
    if (lane == 0) {
      gdt[cell * L + j] = vdt;
      gw[j] = vw;
    }
  }
  __syncthreads();
  for (int t = tid; t < L; t += SSD_BWD_NT) {
    float row = 0.f, col = 0.f;
    for (int j = 0; j < L; ++j) row += qm[t * (L + 1) + j];
    for (int i = 0; i < L; ++i) col += qm[i * (L + 1) + t];
    gcum[t] = row - col - gw[t] * w[t];
  }
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int j = 0; j < L; ++j) tot = fmaf(gw[j], w[j], tot);
    gcum[L - 1] += tot;
    float run = 0.f;
    for (int i = L - 1; i >= 0; --i) {
      run += gcum[i];
      ga[cell * L + i] = run;
    }
  }
}

// gb[g] = sum over the group's heads h, in order, of part[g * hpg + h]
__global__ void ssd_bwd_group_sum_kernel(const float* __restrict__ gb_part,
                                         const float* __restrict__ gc_part,
                                         float* __restrict__ gb,
                                         float* __restrict__ gc,
                                         long long per_head, long long total,
                                         int heads_per_group) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long g = e / per_head, r = e - g * per_head;
  const float* pb = gb_part + g * heads_per_group * per_head + r;
  const float* pc = gc_part + g * heads_per_group * per_head + r;
  float vb = 0.f, vc = 0.f;
  for (int h = 0; h < heads_per_group; ++h) {
    vb += pb[h * per_head];
    vc += pc[h * per_head];
  }
  gb[e] = vb;
  gc[e] = vc;
}

// ------------------------------------------------------ backward, wgmma
// The backward for the wgmma route's shapes (L = 64, D a multiple of 64,
// S = 64 or 128), 3xTF32 on wgmma as the forward, with its block shape:
// one block per (group g, chunk c, a block of up to hb heads of g), so
// the group's B (and C) are split once and serve all the block's heads,
// and gB, gC are summed over the block's heads in registers.  One share
// of gB and of gC per block is written (4 per (group, chunk) at
// mamba2-130m's shape, against 24 per-head shares on the FFMA route) and
// ssd_bwd_group_sum_kernel sums them in block order; with one block a
// group the block writes gB and gC itself.
//
// Operands.  wgmma's TF32 operands are K-major in shared memory, and the
// backward contracts each of its matrices over both of its axes, so A
// always comes from registers (any layout can be read there): each
// thread loads its A fragment of fp32 values from device memory (x, gy,
// gst, B, C: L2-resident) and splits it to TF32 hi/lo in registers.  B
// operands are K-major hi/lo planes in shared memory, 128-byte swizzled:
//   Bn  rows j, k = s: the group's B, split once by the whole block;
//   Xd  rows j, k = d: dt * x of the head, one 64-wide d slice at a time;
//   Mt  rows j, k = i: M = (C B^T) * Lmat of the head, transposed;
//   Gt  rows j, k = i and Gn rows i, k = j: G = gM * Lmat of the head.
// Every product sums each 32-wide k-tile into a fresh partial, added by
// FADD in k order (the tensor cores' accumulation does not round to
// nearest).  Two warpgroups, 256 threads, one block per SM:
//
//   WG1 (rows i).  Once: C B^T (A = C, B = Bn) into shared memory.  Per
//     head: per d slice, Xd's planes, then gM += gy Xd^T and e^T = gst
//     Xd^T (rows s), gB^T += w_j e^T; then M and G from C B^T, gM and the
//     decay exp(cum_i - cum_j), taken only where i >= j (a select before
//     exp: above the diagonal the exponent may overflow), Q = gM * M with
//     its row and column sums, and the planes Mt, Gt, Gn; then gB^T +=
//     C^T-side product (A = C read transposed, B = Gt).
//   WG0 (rows d, then s).  Per head: per 64-wide d tile, bg^T = gst^T
//     B^T (A = gst read transposed, B = Bn), gw_j += Xd . bg, w_j bg
//     parked in gx; after WG1's planes, gXd^T = gy^T M (A = gy read
//     transposed, B = Mt) + w bg, gdt_j += gXd . x, gx = gXd dt; then
//     gC^T += B^T-side product (A = B read transposed, B = Gn).  Its warp
//     0 then sums gcum = rowsum Q - colsum Q - gw w (+ sum gw w at L-1)
//     and the reverse cumsum into ga.
// The two meet at two named barriers per head: WG1 arrives at B1 when
// the head's planes are written, WG0 at B2 when it is done reading them.
// Every sum has one order (no atomics), so two runs give the same bits.
//
// What bounds it on the H100: at mamba2-130m's training shape (BH 96, 8
// chunks of 64, D 64, S 128, 4 B/C groups) the function moves 68 MB (x,
// dt, a, b, c, gy, gst in; gx, gdt, ga, gb, gc out), 20.3 us at 3.35
// TB/s; its least products (C B^T once per (group, chunk), the masked
// L x L products and the full L x S x D ones per cell) as 3xTF32 take
// 17.3 us at the TF32 rate.  This route does ten 64^3 products a head as
// 3xTF32 (1.25e10 FLOP at the training shape, 25 us at the TF32 rate)
// and moves 16.8 MB of block shares besides (written, then read by the
// group sum).  It runs at several times that: each warpgroup is one chain
// of load, split, wgmma and wait, 255 registers a thread leave no room to
// keep two k-tiles in flight, and shared memory (217 KB) none to stage
// the A operands.  launch/ssd_bwd_variants.py times it with its parts
// taken out (PERF.md).
#define WB_THREADS 256

template <int S>
struct WbSmem {
  static constexpr int BN = 0;               // hi S * 256 bytes, lo after
  static constexpr int XD = BN + S * 512;    // hi 16 KB, lo after
  static constexpr int MT = XD + 32768;
  static constexpr int GT = MT + 32768;
  static constexpr int GN = GT + 32768;
  static constexpr int CBT = GN + 32768;     // C B^T fragments [32][128]
  static constexpr int VEC = CBT + 16384;
  // w0[2][64], dt0[2][64], cum1, w1, dt1 [64], qrow[2][64], qcol, gwp,
  // gdtp [2][4][64]
  static constexpr int NVEC = 4 * 64 + 3 * 64 + 2 * 64 + 3 * 512;
  static constexpr int TOTAL = VEC + NVEC * 4 + 1024;  // + alignment slack
};

// Byte offset of element (row, k) of a K-major plane of 64 rows.
__device__ __forceinline__ int wb_off(int row, int k) {
  return (k >> 5) * 8192 + swz(row, k & 31);
}

__device__ __forceinline__ void wb_put(uint8_t* plane, int lo, int off,
                                       float v) {
  const float hi = hopper::tf32_rna(v);
  hopper::sts_f32(hopper::smem_u32(plane + off), hi);
  hopper::sts_f32(hopper::smem_u32(plane + lo + off), hopper::tf32_rna(v - hi));
}

// This thread's fragment of k-tile kt (four k8 steps; rows r0 and r0 + 8,
// k slots q and q + 4 of each step) of a 64-row A whose element (m, k) is
// a[m * sm + k * sk] in device memory.  The loads are volatile asm, so the
// compiler keeps them ahead of the wgmma they overlap.
__device__ __forceinline__ void wb_load_a(float (&raw)[16], const float* a,
                                          int sm, int sk, int kt, int r0,
                                          int q) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = r0 + 8 * (r & 1), k = 32 * kt + 8 * s + q + 4 * (r >> 1);
      raw[4 * s + r] = hopper::ldg_f1(a + m * sm + k * sk);
    }
}

// res = A . B^T over KT 32-wide k-tiles, 3xTF32, one fresh partial per
// k-tile added in k order.  A as wb_load_a reads it, split to TF32 hi/lo
// in registers; B: K-major planes of 64 rows, hi at b (k-tiles 8192 bytes
// apart), lo b_lo bytes further.  The next k-tile's A is read while this
// one's wgmma run.
template <int KT>
__device__ __forceinline__ void wb_prod(float (&res)[32], float (&part)[32],
                                        const float* a, int sm, int sk,
                                        const uint8_t* b, int b_lo, int r0,
                                        int q) {
  float raw[16];
  wb_load_a(raw, a, sm, sk, 0, r0, q);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float hi = hopper::tf32_rna(raw[4 * s + r]);
        ah[s][r] = __float_as_uint(hi);
        al[s][r] = __float_as_uint(hopper::tf32_rna(raw[4 * s + r] - hi));
      }
    if (kt + 1 < KT) wb_load_a(raw, a, sm, sk, kt + 1, r0, q);
    hopper::wgmma_fence();
    if (kt == 0) {
      hopper::fence_regs(res);
      ktile_rs(res, ah, al, b, b_lo);
    } else {
      hopper::fence_regs(part);
      ktile_rs(part, ah, al, b + kt * 8192, b_lo);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(res);
    hopper::fence_regs(part);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      hopper::fence_regs(ah[s]);
      hopper::fence_regs(al[s]);
    }
    if (kt > 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) res[i] += part[i];
    }
  }
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Sum over the 8 lanes of a warp that share lane % 4.
__device__ __forceinline__ float wb_col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// One warp: the cell's in-chunk cumsum of a (lane l holds 2l, 2l+1) and
// the end-state weights w_j = exp(cum[63] - cum_j); dt copied beside.
__device__ __forceinline__ void wb_scan(const float* a, const float* dt,
                                        float* cum, float* w, float* dts) {
  const int lane = threadIdx.x % 32;
  const float a0 = a[2 * lane], a1 = a[2 * lane + 1];
  float run = a0 + a1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += n;
  }
  float excl = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) excl = 0.f;
  const float c0 = excl + a0, c1 = c0 + a1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  if (cum != nullptr) {
    cum[2 * lane] = c0;
    cum[2 * lane + 1] = c1;
  }
  w[2 * lane] = expf(last - c0);
  w[2 * lane + 1] = expf(last - c1);
  dts[2 * lane] = dt[2 * lane];
  dts[2 * lane + 1] = dt[2 * lane + 1];
}

template <int S>
__global__ void __launch_bounds__(WB_THREADS, 1)
ssd_chunk_bwd_wgmma_kernel(const float* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const float* __restrict__ b,
                           const float* __restrict__ c,
                           const float* __restrict__ gy,
                           const float* __restrict__ gst, float* gx,
                           float* __restrict__ gdt, float* __restrict__ ga,
                           float* __restrict__ gb_out,
                           float* __restrict__ gc_out, int C, int D, int hpg,
                           int hb) {
  using LY = WbSmem<S>;
  constexpr int SM = S / 64;  // 64-row tiles of the state
  extern __shared__ uint8_t wb_smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wb_smem_raw) + 1023) & ~uintptr_t(1023));
  float* w0 = reinterpret_cast<float*>(sm + LY::VEC);  // [2][64]
  float* dt0 = w0 + 128;                               // [2][64]
  float* cum1 = dt0 + 128;
  float* w1 = cum1 + 64;
  float* dt1 = w1 + 64;
  float* qrow = dt1 + 64;     // [2][64]
  float* qcol = qrow + 128;   // [2][4][64]
  float* gwp = qcol + 512;    // [2][4][64]
  float* gdtp = gwp + 512;    // [2][4][64]

  const int nhb = (hpg + hb - 1) / hb;
  const int gc = blockIdx.x / nhb, hbi = blockIdx.x % nhb;
  const int cc = gc % C, g = gc / C;
  const int h0 = hbi * hb, nh = min(hb, hpg - h0);
  const float* bg = b + (long long)gc * 64 * S;  // B, C of (g, c): 64 x S
  const float* cg = c + (long long)gc * 64 * S;
  const long long out = (nhb > 1 ? (long long)gc * nhb + hbi : gc) * 64 * S;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int w = t / 32, lane = t % 32, q = lane % 4;
  const int r0 = 16 * w + lane / 4;
  auto cell_of = [&](int hh) {
    return (long long)(g * hpg + h0 + hh) * C + cc;
  };

  // the group's B as K-major hi/lo planes (rows j, k = s), every thread
  for (int e = threadIdx.x; e < 16 * S; e += WB_THREADS) {
    const int j = e / (S / 4), s4 = (e % (S / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(bg + j * S + s4);
    const float xs[4] = {v.x, v.y, v.z, v.w};
    float4 hi, lo;
    split4(xs, hi, lo);
    const int off = wb_off(j, s4);
    hopper::sts_v4(hopper::smem_u32(sm + LY::BN + off), hi);
    hopper::sts_v4(hopper::smem_u32(sm + LY::BN + S * 256 + off), lo);
  }
  hopper::fence_proxy_async();
  __syncthreads();

  float res[32], part[32];
  if (wg == 1) {
    // C B^T (rows i, columns j), kept as this thread's fragment
    float* cbt = reinterpret_cast<float*>(sm + LY::CBT);
    wb_prod<S / 32>(res, part, cg, S, 1, sm + LY::BN, S * 256, r0, q);
#pragma unroll
    for (int i = 0; i < 32; ++i) cbt[i * 128 + t] = res[i];
    float gbt[SM][32];  // gB^T: rows s, columns j
#pragma unroll
    for (int mt = 0; mt < SM; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) gbt[mt][i] = 0.f;

    for (int hh = 0; hh < nh; ++hh) {
      const int p = hh & 1;
      const long long cell = cell_of(hh);
      const float* xh = x + cell * 64 * D;
      const float* gyh = gy + cell * 64 * D;
      const float* gsth = gst + cell * S * D;
      if (w == 0) wb_scan(a + cell * 64, dt + cell * 64, cum1, w1, dt1);
      hopper::named_barrier(4, 128);
      float gm[32];
      for (int ds = 0; ds < D / 64; ++ds) {
        if (ds > 0) hopper::named_barrier(4, 128);  // the last slice is read
        // Xd's planes of this d slice: rows j, k = d
        for (int e = t; e < 1024; e += 128) {
          const int j = e >> 4, d4 = (e & 15) * 4;
          const float4 v =
              *reinterpret_cast<const float4*>(xh + j * D + 64 * ds + d4);
          const float xs[4] = {v.x * dt1[j], v.y * dt1[j], v.z * dt1[j],
                               v.w * dt1[j]};
          float4 hi, lo;
          split4(xs, hi, lo);
          const int off = wb_off(j, d4);
          hopper::sts_v4(hopper::smem_u32(sm + LY::XD + off), hi);
          hopper::sts_v4(hopper::smem_u32(sm + LY::XD + 16384 + off), lo);
        }
        hopper::fence_proxy_async();
        hopper::named_barrier(4, 128);
        // gM (rows i, columns j) += gy[:, slice] . Xd^T
        if (ds == 0) {
          wb_prod<2>(gm, part, gyh, D, 1, sm + LY::XD, 16384, r0, q);
        } else {
          wb_prod<2>(res, part, gyh + 64 * ds, D, 1, sm + LY::XD,
                     16384, r0, q);
#pragma unroll
          for (int i = 0; i < 32; ++i) gm[i] += res[i];
        }
        // e^T (rows s, columns j) = gst[:, slice] . Xd^T; gB^T += w_j e^T
#pragma unroll
        for (int mt = 0; mt < SM; ++mt) {
          wb_prod<2>(res, part,
                     gsth + (long long)64 * mt * D + 64 * ds, D, 1,
                     sm + LY::XD, 16384, r0, q);
#pragma unroll
          for (int jb = 0; jb < 8; ++jb)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              gbt[mt][4 * jb + i] +=
                  w1[8 * jb + 2 * q + (i & 1)] * res[4 * jb + i];
        }
      }
      // M, G, Q = gM * M on this thread's fragment
      const float ci[2] = {cum1[r0], cum1[r0 + 8]};
      float qr[2] = {0.f, 0.f}, qc[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) qc[i] = 0.f;
      if (hh > 0) hopper::named_barrier(2, 256);  // WG0 read the last planes
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int cj = 0; cj < 2; ++cj) {
            const int idx = 4 * jb + 2 * hf + cj;
            const int i = r0 + 8 * hf, j = 8 * jb + 2 * q + cj;
            const bool low = i >= j;
            const float lm = low ? expf(ci[hf] - cum1[j]) : 0.f;
            const float m = low ? cbt[idx * 128 + t] * lm : 0.f;
            const float gv = low ? gm[idx] * lm : 0.f;
            const float qv = gm[idx] * m;
            qr[hf] += qv;
            qc[2 * jb + cj] += qv;
            wb_put(sm + LY::MT, 16384, wb_off(j, i), m);
            wb_put(sm + LY::GT, 16384, wb_off(j, i), gv);
            wb_put(sm + LY::GN, 16384, wb_off(i, j), gv);
          }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float v = qr[hf];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (q == 0) qrow[64 * p + r0 + 8 * hf] = v;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float v = wb_col_sum(qc[i]);
        if (lane < 4) qcol[256 * p + 64 * w + 8 * (i / 2) + 2 * q + (i & 1)] = v;
      }
      hopper::fence_proxy_async();
      named_arrive(1, 256);            // B1: this head's planes are written
      hopper::named_barrier(4, 128);   // and visible to WG1's own wgmma
      // gB^T (rows s) += C^T G: A (s, i) = C[i, s], B = Gt
#pragma unroll
      for (int mt = 0; mt < SM; ++mt) {
        wb_prod<2>(res, part, cg + 64 * mt, 1, S, sm + LY::GT, 16384,
                   r0, q);
#pragma unroll
        for (int i = 0; i < 32; ++i) gbt[mt][i] += res[i];
      }
    }
    hopper::named_barrier(2, 256);  // WG0's last B2
#pragma unroll
    for (int mt = 0; mt < SM; ++mt)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = 64 * mt + r0 + 8 * (i >> 1), j = 8 * jb + 2 * q + (i & 1);
          gb_out[out + j * S + s] = gbt[mt][4 * jb + i];
        }
    return;
  }

  // WG0
  float gct[SM][32];  // gC^T: rows s, columns i
#pragma unroll
  for (int mt = 0; mt < SM; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) gct[mt][i] = 0.f;
  for (int hh = 0; hh < nh; ++hh) {
    const int p = hh & 1;
    const long long cell = cell_of(hh);
    const float* xh = x + cell * 64 * D;
    const float* gyh = gy + cell * 64 * D;
    const float* gsth = gst + cell * S * D;
    float* gxh = gx + cell * 64 * D;
    const float* wv = w0 + 64 * p;
    const float* dv = dt0 + 64 * p;
    // warp 1 scans (warp 0 may still be finishing the last head's ga)
    if (w == 1)
      wb_scan(a + cell * 64, dt + cell * 64, nullptr, w0 + 64 * p, dt0 + 64 * p);
    hopper::named_barrier(3, 128);
    // bg^T (rows d, columns j) = gst^T B^T per d tile; gw; w bg into gx
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    for (int dtl = 0; dtl < D / 64; ++dtl) {
      wb_prod<S / 32>(res, part, gsth + 64 * dtl, 1, D, sm + LY::BN,
                      S * 256, r0, q);
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = 64 * dtl + r0 + 8 * (i >> 1), j = 8 * jb + 2 * q + (i & 1);
          const float bgv = res[4 * jb + i];
          acc[2 * jb + (i & 1)] += xh[j * D + d] * dv[j] * bgv;
          gxh[j * D + d] = wv[j] * bgv;
        }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float v = wb_col_sum(acc[i]);
      if (lane < 4) gwp[256 * p + 64 * w + 8 * (i / 2) + 2 * q + (i & 1)] = v;
      acc[i] = 0.f;
    }
    hopper::named_barrier(1, 256);  // B1: WG1's planes of this head
    // gXd^T (rows d) = gy^T M + w bg; gdt_j += gXd . x; gx = gXd dt
    for (int dtl = 0; dtl < D / 64; ++dtl) {
      wb_prod<2>(res, part, gyh + 64 * dtl, 1, D, sm + LY::MT, 16384,
                 r0, q);
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = 64 * dtl + r0 + 8 * (i >> 1), j = 8 * jb + 2 * q + (i & 1);
          const float gxd = res[4 * jb + i] + gxh[j * D + d];
          acc[2 * jb + (i & 1)] += gxd * xh[j * D + d];
          gxh[j * D + d] = gxd * dv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float v = wb_col_sum(acc[i]);
      if (lane < 4) gdtp[256 * p + 64 * w + 8 * (i / 2) + 2 * q + (i & 1)] = v;
    }
    // gC^T (rows s) += B^T G^T: A (s, j) = B[j, s], B = Gn
#pragma unroll
    for (int mt = 0; mt < SM; ++mt) {
      wb_prod<2>(res, part, bg + 64 * mt, 1, S, sm + LY::GN, 16384,
                 r0, q);
#pragma unroll
      for (int i = 0; i < 32; ++i) gct[mt][i] += res[i];
    }
    hopper::named_barrier(3, 128);  // every warp of WG0 is done with them
    named_arrive(2, 256);           // B2
    if (w == 0) {
      // gcum, then ga = its reverse cumsum; gdt (lane l: rows 2l, 2l+1)
      float gcum[2], tot = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * lane + u;
        float gw = 0.f, qcs = 0.f, gd = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          gw += gwp[256 * p + 64 * k4 + j];
          qcs += qcol[256 * p + 64 * k4 + j];
          gd += gdtp[256 * p + 64 * k4 + j];
        }
        gcum[u] = qrow[64 * p + j] - qcs - gw * wv[j];
        tot = fmaf(gw, wv[j], tot);
        gdt[cell * 64 + j] = gd;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tot += __shfl_xor_sync(0xffffffffu, tot, off);
      if (lane == 31) gcum[1] += tot;
      const float pair = gcum[0] + gcum[1];
      float run = pair;  // sum over lanes >= this one
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_down_sync(0xffffffffu, run, off);
        if (lane + off < 32) run += n;
      }
      float excl = __shfl_down_sync(0xffffffffu, run, 1);
      if (lane == 31) excl = 0.f;
      const float g1 = excl + gcum[1];
      ga[cell * 64 + 2 * lane + 1] = g1;
      ga[cell * 64 + 2 * lane] = g1 + gcum[0];
    }
  }
#pragma unroll
  for (int mt = 0; mt < SM; ++mt)
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = 64 * mt + r0 + 8 * (i >> 1), ii = 8 * jb + 2 * q + (i & 1);
        gc_out[out + ii * S + s] = gct[mt][4 * jb + i];
      }
}

template <int S>
static cudaError_t wb_launch(const float* x, const float* dt, const float* a,
                             const float* b, const float* c, const float* gy,
                             const float* gst, float* gx, float* gdt,
                             float* ga, float* gb_out, float* gc_out,
                             long long blocks, int C, int D, int hpg, int hb,
                             cudaStream_t stream) {
  const int smem = WbSmem<S>::TOTAL;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_wgmma_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_bwd_wgmma_kernel<S><<<(unsigned)blocks, WB_THREADS, smem,
                                  stream>>>(x, dt, a, b, c, gy, gst, gx, gdt,
                                            ga, gb_out, gc_out, C, D, hpg, hb);
  return cudaGetLastError();
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

// The wgmma kernel: L = 64, D a multiple of 64, S = 64 or 128, x/b/c/dt/a
// 16-byte aligned; G groups of BH / G heads, up to hb heads a block.
extern "C" int repro_ssd_chunk_wgmma(const float* x, const float* dt,
                                     const float* a, const float* b,
                                     const float* c, float* y, float* st,
                                     long long BH, int C, int L, int D, int S,
                                     long long G, int hb, void* stream) {
  if (L != 64 || D < 64 || D % 64 || (S != 64 && S != 128) || C < 1 ||
      G < 1 || BH % G || hb < 1)
    return (int)cudaErrorInvalidValue;
  const long long hpg = BH / G;
  const long long blocks = G * C * ((hpg + hb - 1) / hb);
  if (blocks > 0x7fffffffLL || BH * C * 64 > 0x7fffffffLL ||
      G * C * 64 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)dt, (const void*)a})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const float* srcs[3] = {x, c, b};
  for (int i = 0; i < 3; ++i) {
    const uint64_t cols = i == 0 ? D : S;
    const uint64_t dims[2] = {cols, (uint64_t)((i == 0 ? BH : G) * C * 64)};
    const uint64_t strides[1] = {cols * 4};
    const uint32_t box[2] = {32, 64};
    cudaError_t err = hopper::make_tensor_map(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, srcs[i], dims, strides,
        box);
    if (err != cudaSuccess) return (int)err;
  }
  static bool ready = false;  // the attribute, once, for the largest S
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WgmmaSmem(128).total);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int smem = WgmmaSmem(S).total;
  ssd_chunk_wgmma_kernel<<<(unsigned)blocks, W_THREADS, smem,
                           (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], dt, a, y, st, C, D, S, (int)hpg, hb);
  return (int)cudaGetLastError();
}

extern "C" long long repro_ssd_chunk_bwd_smem(int L, int D, int S) {
  return (long long)ssd_bwd_smem_bytes(L, D, S);
}

// The backward of repro_ssd_chunk: gx (BH,C,L,D), gdt and ga (BH,C,L),
// the per-head partials gb_part and gc_part (BH,C,L,S), then, with more
// than one head a group, their group sums gb and gc (G,C,L,S).
extern "C" int repro_ssd_chunk_bwd(
    const float* x, const float* dt, const float* a, const float* b,
    const float* c, const float* gy, const float* gst, float* gx, float* gdt,
    float* ga, float* gb_part, float* gc_part, float* gb, float* gc,
    long long cells, int C, int L, int D, int S, int heads_per_group,
    void* stream) {
  if (cells <= 0 || cells > 0x7fffffffLL || C < 1 || L < 1 || D < 1 ||
      S < 1 || heads_per_group < 1 || (cells / C) % heads_per_group)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ssd_bwd_smem_bytes(L, D, S);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  ssd_chunk_bwd_kernel<<<(unsigned)cells, SSD_BWD_NT, smem, st>>>(
      x, dt, a, b, c, gy, gst, gx, gdt, ga, gb_part, gc_part, C, L, D, S,
      heads_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess || heads_per_group == 1) return (int)err;
  const long long per_head = (long long)C * L * S;
  const long long total = cells / heads_per_group * L * S;
  const long long blocks = (total + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssd_bwd_group_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      gb_part, gc_part, gb, gc, per_head, total, heads_per_group);
  return (int)cudaGetLastError();
}

extern "C" long long repro_ssd_chunk_bwd_wgmma_smem(int S) {
  return S == 64 ? WbSmem<64>::TOTAL : S == 128 ? WbSmem<128>::TOTAL : -1;
}

// The backward on the wgmma route's shapes (L = 64, D a multiple of 64,
// S = 64 or 128; x and b 16-byte aligned): gx (BH,C,L,D), gdt and ga
// (BH,C,L), gb and gc (G,C,L,S); G groups of BH / G heads, up to hb heads
// a block.  With more than one block a group, each block's share goes to
// gb_part and gc_part (G*C, blocks a group, L, S), summed in block order.
extern "C" int repro_ssd_chunk_bwd_wgmma(
    const float* x, const float* dt, const float* a, const float* b,
    const float* c, const float* gy, const float* gst, float* gx, float* gdt,
    float* ga, float* gb, float* gc, float* gb_part, float* gc_part,
    long long BH, int C, int L, int D, int S, long long G, int hb,
    void* stream) {
  if (L != 64 || D < 64 || D % 64 || (S != 64 && S != 128) || C < 1 ||
      G < 1 || BH % G || hb < 1)
    return (int)cudaErrorInvalidValue;
  const long long hpg = BH / G, nhb = (hpg + hb - 1) / hb;
  const long long blocks = G * C * nhb;
  if (blocks > 0x7fffffffLL || BH * C * 64 * D > 0x7fffffffLL ||
      BH * C * (long long)S * D > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {(const void*)x, (const void*)b})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* gb_out = nhb > 1 ? gb_part : gb;
  float* gc_out = nhb > 1 ? gc_part : gc;
  cudaError_t err =
      S == 64 ? wb_launch<64>(x, dt, a, b, c, gy, gst, gx, gdt, ga, gb_out,
                              gc_out, blocks, C, D, (int)hpg, hb, st)
              : wb_launch<128>(x, dt, a, b, c, gy, gst, gx, gdt, ga, gb_out,
                               gc_out, blocks, C, D, (int)hpg, hb, st);
  if (err != cudaSuccess || nhb == 1) return (int)err;
  const long long total = G * C * 64 * S;
  ssd_bwd_group_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      gb_part, gc_part, gb, gc, 64LL * S, total, (int)nhb);
  return (int)cudaGetLastError();
}
