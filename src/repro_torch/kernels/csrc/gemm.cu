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
//       one contraction step on operands in their native tree layouts,
//       complex64 read and written in place: producer warps gather each
//       tile through a map of its elements in ascending native offset
//       (coalesced), split them into TF32 hi/lo planes in shared memory,
//       and two consumer warpgroups run 3xTF32 wgmma on them; the output
//       is written straight into the step's inds_out layout.
//   chain_gemm_kernel  <- fused_chain_matmul (_chain_kernel, _run_chain)
//       a run of adjacent steps in one thread-block cluster: the blocks
//       share each step's output tiles, a cluster barrier separates the
//       steps, and interior carries live in a device workspace laid out
//       by the planner's slot assignment.
//
// Every kernel keeps one ordered sum over K per output element (no
// split-K, no atomics), so its result does not depend on the launch
// geometry.
//
// What bounds them on the H100.  K1 does three TF32 products per fp32
// product, so its least time is its operations at a third of the 495
// TFLOP/s TF32 peak (165 TFLOP/s fp32-accurate).  K2 on the path's steps
// (M up to 2^20 rows, N <= 128, K = 64..1024) reads its large operand
// once: its bytes (8 per complex element of A, B and C) at 3.35 TB/s and
// its 3xTF32 operations take about the same time, so the gather must keep
// enough loads in flight to stream A at the HBM rate while the tensor
// cores run; the gather and the TF32 split cost shared-memory bandwidth
// beside wgmma's own reads (see the note at the kernel).  K3's steps are
// tiny (a few thousand outputs, K = 1..16 on most), so it is bound by
// latency: the launch, one barrier per step, and the dependent loads of
// each step's addressing, which it stages in shared memory before the
// first step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef long long i64;

#define MAX_CHAIN 32

// K2's step descriptor: 33 int64 words followed by its offset tables, all
// in one device buffer.  Each role r of an operand maps a flat role index
// i to an element offset: tab[hi + i / lo_n] + tab[lo + i % lo_n].  The
// host orients the step before it writes the descriptor (A is the
// operand whose rows are the wgmma M side), so M, N and the roles below
// are the kernel's, not necessarily the form's.
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
  D_KA = 31,  // position of A's k-tile offsets (one per 32-wide k-tile)
  D_KB = 32,  // position of B's
  D_WORDS = 33
};

__device__ __forceinline__ i64 role_off(const i64* __restrict__ d, int r,
                                        i64 i) {
  const i64 lo_n = d[r + 2];
  return __ldg(d + d[r] + i / lo_n) + __ldg(d + d[r + 1] + i % lo_n);
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
// One contraction step on operands in their native layouts, as 3xTF32 on
// wgmma.  The host orients the step so that the larger of M and N is the
// wgmma M side (Ct = Bt.At: the operands and the output's m/n role tables
// swap, so no transposed copy appears), and picks the tile: 128 rows x 64
// columns when N <= 64, else 64 x 128, so the large operand is read from
// device memory once wherever N <= 128.
//
// Block: a persistent loop over output tiles, 512 threads.  Warpgroups 2
// and 3 are the producers: for each 32-wide k-tile they gather the A and
// B tiles with plain loads (8-byte (re, im) pairs for complex64, read in
// place), split every element into TF32 hi and lo parts (round to
// nearest, ties away, as cvt.rna) and store them into four
// 128-byte-swizzled K-major planes per operand (re_hi, re_lo, im_hi,
// im_lo), one stage of a two-stage ring guarded by mbarriers; the
// generic-proxy stores are fenced for wgmma's async proxy before the
// stage is signalled.  The gather walks a map built once per step form
// on the host: the tile's elements in ascending native offset relative
// to the tile's base, each with its (row, k) slot, so the lanes of a warp
// read consecutive entries and a contiguous native run is one coalesced
// transaction.  The map is the same for every tile when the tile extents
// are products of trailing axes of their roles (every RQC form: all
// bonds are 2); on whole tiles the producers read it in 16-byte chunks
// (four consecutive k of one row, one vector store per plane), and it
// splits per producer thread, so a thread holds its chunks' offsets as
// one number plus shared deltas ("uniform").  Other forms ("general")
// address each element through per-tile row and k offset tables and use
// the map only for its order.
// The producers need few registers and the consumers many: setmaxnreg
// moves them (96 and 160 a thread).  The producers set the kernel's time:
// launch/fused_variants.py times this source with one, two and four
// producer warpgroups and with the producers or the wgmmas taken out.
//
// Warpgroups 0 and 1 are the consumers, each owning a 64x64 block of the
// tile.  Complex products take the direct form, C_re = Ar.Br - Ai.Bi and
// C_im = Ar.Bi + Ai.Br, each real product as three TF32 products
// (hi.hi + hi.lo + lo.hi), the minus sign as wgmma's imm-scale-a: two
// 32-register accumulators and two partial sums a thread (Karatsuba's
// three of each would not fit beside them).  Each k-tile's products go to
// fresh wgmma partial sums that are added into the fp32 accumulators by
// FADD, as in K1.  The epilogue writes (re, im) pairs straight into the
// output's inds_out layout through its role tables.
#define F_BK 32            // k per stage: one 128-byte row of a TF32 plane
#define F_ROWS 192         // rows of A and B in a stage, either tile shape
#define F_STAGES 2
#define F_PWG 2            // producer warpgroups
#define F_PT (128 * F_PWG)  // producer threads
#define F_THREADS (256 + F_PT)  // 2 consumer warpgroups + the producers
// registers a thread (setmaxnreg): producers give theirs up to consumers
#define F_PREG 96
#define F_CREG 160
#define F_STAGE_BYTES (4 * F_ROWS * 128)             // 96 KB
#define F_SMEM (F_STAGES * F_STAGE_BYTES + 1024)     // + alignment slack

template <bool WIDE>
struct FusedTile {
  static constexpr int BM = WIDE ? 64 : 128;
  static constexpr int BN = WIDE ? 128 : 64;
};

struct FusedArgs {
  const i64* desc;  // oriented step descriptor
  const int* maps;  // A offsets, A slots (BM*F_BK each; uniform: per
                    // chunk, slots as swizzled byte offsets), B's (BN*F_BK
                    // each), the output's tile-local row (BM) and column
                    // (BN) offsets, then A's and B's k-run offsets (4 each)
  const float* a;
  const float* b;
  float* c;
  i64 tiles;
  int uniform;      // the maps hold every tile's offsets, output included
};

// Byte offset of element (row, k) in a 128-byte-swizzled K-major plane of
// fp32: rows of 32 values, 16-byte chunks permuted by the row's index
// within its 8-row group (the layout TMA's SWIZZLE_128B writes).
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + ((k & 3) << 2);
}

// Producer half of K2: one operand's R x F_BK tile into its planes.
//
// Uniform maps walk the tile in 16-byte chunks, four consecutive k of one
// row: chunk t + F_PT c of the host's list (chunks in ascending native
// offset) starts at offset rel_t + drel[c] from the tile's base and its k
// run adds kj[0..3]; its swizzled byte offset in a plane is sw_t ^ dsw[c]
// (the host checks both splits).  A thread keeps its two numbers and kj in
// registers, reads the deltas from shared memory, issues every load before
// the first is used, and stores each chunk's four TF32 values with one
// 16-byte store per plane.  General maps give each element's slot, read
// through the per-tile row and k offset tables; elements outside the
// operand are stored as zeros.
template <bool CPLX>
__device__ __forceinline__ void store_split(uint32_t planes, int plane, int o,
                                            float x, float y) {
  const float rh = hopper::tf32_rna(x);
  hopper::sts_f32(planes + o, rh);
  hopper::sts_f32(planes + plane + o, hopper::tf32_rna(x - rh));
  if (CPLX) {
    const float ih = hopper::tf32_rna(y);
    hopper::sts_f32(planes + 2 * plane + o, ih);
    hopper::sts_f32(planes + 3 * plane + o, hopper::tf32_rna(y - ih));
  }
}

__device__ __forceinline__ void split4(const float (&x)[4], float4& hi,
                                       float4& lo) {
  hi = make_float4(hopper::tf32_rna(x[0]), hopper::tf32_rna(x[1]),
                   hopper::tf32_rna(x[2]), hopper::tf32_rna(x[3]));
  lo = make_float4(hopper::tf32_rna(x[0] - hi.x), hopper::tf32_rna(x[1] - hi.y),
                   hopper::tf32_rna(x[2] - hi.z), hopper::tf32_rna(x[3] - hi.w));
}

template <bool CPLX, int R>
__device__ __forceinline__ void gather_tile(
    uint8_t* planes, const float* __restrict__ src, i64 base, bool uniform,
    int rel_t, int sw_t, const int (&kj)[4], const int* drel, const int* dsw,
    const int* __restrict__ slot, const i64* rows, const i64* ks, int t) {
  constexpr int PLANE = R * 128;
  const float2* src2 = reinterpret_cast<const float2*>(src);
  const uint32_t dst = hopper::smem_u32(planes);
  if (uniform) {
    constexpr int CPER = R * (F_BK / 4) / F_PT;  // chunks a thread
    float2 v[CPER][4];
    const i64 b = base + rel_t;
#pragma unroll
    for (int c = 0; c < CPER; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[c][j] = CPLX ? hopper::ldg_f2(src2 + b + drel[c] + kj[j])
                       : make_float2(
                             hopper::ldg_f1(src + b + drel[c] + kj[j]),
                             0.f);
#pragma unroll
    for (int c = 0; c < CPER; ++c) {
      const uint32_t o = dst + (sw_t ^ dsw[c]);
      float4 hi, lo;
      const float re[4] = {v[c][0].x, v[c][1].x, v[c][2].x, v[c][3].x};
      split4(re, hi, lo);
      hopper::sts_v4(o, hi);
      hopper::sts_v4(o + PLANE, lo);
      if (CPLX) {
        const float im[4] = {v[c][0].y, v[c][1].y, v[c][2].y, v[c][3].y};
        split4(im, hi, lo);
        hopper::sts_v4(o + 2 * PLANE, hi);
        hopper::sts_v4(o + 3 * PLANE, lo);
      }
    }
    return;
  }
  constexpr int PER = R * F_BK / F_PT;
  float2 v[PER];
  int sl[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) sl[i] = __ldg(slot + t + F_PT * i);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const i64 ro = rows[sl[i] >> 5], ko = ks[sl[i] & 31];
    const bool ok = ro >= 0 && ko >= 0;
    v[i] = CPLX ? __ldg(src2 + (ok ? ro + ko : 0))
                : make_float2(__ldg(src + (ok ? ro + ko : 0)), 0.f);
    if (!ok) v[i] = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i)
    store_split<CPLX>(dst, PLANE, swz(sl[i] >> 5, sl[i] & 31), v[i].x,
                      v[i].y);
}

template <bool CPLX, bool WIDE>
__global__ void __launch_bounds__(F_THREADS, 1)
fused_gemm_kernel(const __grid_constant__ FusedArgs p) {
  constexpr int BM = FusedTile<WIDE>::BM, BN = FusedTile<WIDE>::BN;
  constexpr int A_PLANE = BM * 128, B_PLANE = BN * 128;
  extern __shared__ uint8_t f_smem_raw[];
  __shared__ __align__(8) uint64_t full[F_STAGES], empty[F_STAGES];
  __shared__ i64 rows_a[BM], rows_b[BN], ks_a[F_BK], ks_b[F_BK];
  __shared__ int deltas[4][8];  // uniform maps: A's drel, dsw, then B's
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(f_smem_raw) + 1023) & ~uintptr_t(1023));

  const i64* d = p.desc;
  const i64 M = __ldg(d + D_M), N = __ldg(d + D_N), K = __ldg(d + D_K);
  const i64 tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int nk = (int)((K + F_BK - 1) / F_BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      hopper::mbar_init(&full[s], F_PT);  // every producer thread arrives
      hopper::mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg >= 2) {
    // producer warpgroups
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(F_PREG));
    const int t = threadIdx.x - 256;
    const int* a_rel = p.maps;
    const int* a_slot = a_rel + BM * F_BK;
    const int* b_rel = a_slot + BM * F_BK;
    const int* b_slot = b_rel + BN * F_BK;
    const i64* ka = d + __ldg(d + D_KA);
    const i64* kb = d + __ldg(d + D_KB);
    // uniform maps: this thread's chunks are t + F_PT c; each chunk's
    // slot is held as its swizzled byte offset
    const int* kjs = p.maps + 2 * (BM + BN) * F_BK + BM + BN;
    const int rel_ta = __ldg(a_rel + t), sw_ta = __ldg(a_slot + t);
    const int rel_tb = __ldg(b_rel + t), sw_tb = __ldg(b_slot + t);
    int kj_a[4], kj_b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kj_a[j] = __ldg(kjs + j);
      kj_b[j] = __ldg(kjs + 4 + j);
    }
    if (t < BM * (F_BK / 4) / F_PT) {
      deltas[0][t] = __ldg(a_rel + F_PT * t);
      deltas[1][t] = __ldg(a_slot + F_PT * t);
    }
    if (t < BN * (F_BK / 4) / F_PT) {
      deltas[2][t] = __ldg(b_rel + F_PT * t);
      deltas[3][t] = __ldg(b_slot + F_PT * t);
    }
    hopper::named_barrier(1, F_PT);
    int it = 0;
    for (i64 tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const i64 nt = tile % tiles_n, mt = (tile / tiles_n) % tiles_m;
      const i64 bt = tile / (tiles_n * tiles_m);
      const i64 m0 = mt * BM, n0 = nt * BN;
      const i64 a_bt = role_off(d, D_AB, bt), b_bt = role_off(d, D_BB, bt);
      const i64 a_tile = p.uniform ? a_bt + role_off(d, D_AM, m0) : 0;
      const i64 b_tile = p.uniform ? b_bt + role_off(d, D_BN, n0) : 0;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % F_STAGES;
        if (it >= F_STAGES)
          hopper::mbar_wait(&empty[s], ((it / F_STAGES) - 1) & 1);
        const i64 k0 = (i64)kt * F_BK;
        i64 a_base = 0, b_base = 0;
        if (p.uniform) {
          a_base = a_tile + __ldg(ka + kt);
          b_base = b_tile + __ldg(kb + kt);
        } else {
          hopper::named_barrier(1, F_PT);  // done with the last tables
          if (kt == 0) {
            if (t < BM) {
              const i64 m = m0 + t;
              rows_a[t] = m < M ? a_bt + role_off(d, D_AM, m) : -1;
            }
            if (t < BN) {
              const i64 n = n0 + t;
              rows_b[t] = n < N ? b_bt + role_off(d, D_BN, n) : -1;
            }
          }
          if (t < F_BK) {
            const i64 k = k0 + t;
            ks_a[t] = k < K ? role_off(d, D_AK, k) : -1;
          } else if (t < 2 * F_BK) {
            const i64 k = k0 + t - F_BK;
            ks_b[t - F_BK] = k < K ? role_off(d, D_BK, k) : -1;
          }
          hopper::named_barrier(1, F_PT);
        }
        uint8_t* st = smem + s * F_STAGE_BYTES;
        gather_tile<CPLX, BM>(st, p.a, a_base, p.uniform, rel_ta, sw_ta, kj_a,
                              deltas[0], deltas[1], a_slot, rows_a, ks_a, t);
        gather_tile<CPLX, BN>(st + 4 * A_PLANE, p.b, b_base, p.uniform, rel_tb,
                              sw_tb, kj_b, deltas[2], deltas[3], b_slot,
                              rows_b, ks_b, t);
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup wg: a 64x64 block of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(F_CREG));
  const int a_row0 = WIDE ? 0 : 64 * wg;
  const int b_row0 = WIDE ? 64 * wg : 0;
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  float acc_r[32], acc_i[32], pr[32], pi[32];
  int it = 0;
  for (i64 tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const i64 nt = tile % tiles_n, mt = (tile / tiles_n) % tiles_m;
    const i64 bt = tile / (tiles_n * tiles_m);
    const i64 m0 = mt * BM, n0 = nt * BN;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_r[i] = acc_i[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % F_STAGES;
      hopper::mbar_wait(&full[s], (it / F_STAGES) & 1);
      const uint8_t* A = smem + s * F_STAGE_BYTES + a_row0 * 128;
      const uint8_t* B = smem + s * F_STAGE_BYTES + 4 * A_PLANE + b_row0 * 128;
      hopper::wgmma_fence();
      hopper::fence_regs(pr);
      if (CPLX) hopper::fence_regs(pi);
#pragma unroll
      for (int k = 0; k < F_BK / 8; ++k) {
        const int kb = 32 * k;  // k8 step: 32 bytes along K
        const uint64_t arh = hopper::desc_kmajor(A + kb);
        const uint64_t arl = hopper::desc_kmajor(A + A_PLANE + kb);
        const uint64_t brh = hopper::desc_kmajor(B + kb);
        const uint64_t brl = hopper::desc_kmajor(B + B_PLANE + kb);
        // the small products first, the large one last
        if (CPLX) {
          const uint64_t aih = hopper::desc_kmajor(A + 2 * A_PLANE + kb);
          const uint64_t ail = hopper::desc_kmajor(A + 3 * A_PLANE + kb);
          const uint64_t bih = hopper::desc_kmajor(B + 2 * B_PLANE + kb);
          const uint64_t bil = hopper::desc_kmajor(B + 3 * B_PLANE + kb);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pr, arl, brh, k > 0);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pr, arh, brl, 1);
          hopper::wgmma_m64n64k8_tf32_ss<-1>(pr, ail, bih, 1);
          hopper::wgmma_m64n64k8_tf32_ss<-1>(pr, aih, bil, 1);
          hopper::wgmma_m64n64k8_tf32_ss<-1>(pr, aih, bih, 1);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pr, arh, brh, 1);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pi, arl, bih, k > 0);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pi, arh, bil, 1);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pi, ail, brh, 1);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pi, aih, brl, 1);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pi, aih, brh, 1);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pi, arh, bih, 1);
        } else {
          hopper::wgmma_m64n64k8_tf32_ss<1>(pr, arl, brh, k > 0);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pr, arh, brl, 1);
          hopper::wgmma_m64n64k8_tf32_ss<1>(pr, arh, brh, 1);
        }
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(pr);
      if (CPLX) hopper::fence_regs(pi);
      if (t == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc_r[i] += pr[i];
        if (CPLX) acc_i[i] += pi[i];
      }
    }

    // accumulator fragment: warp w, lane l holds rows 16w + l/4 (+8) and,
    // for each n8 block j, columns 8j + 2(l%4) (+1).  A uniform output
    // adds tile-local row and column offsets (maps) to the tile's base.
    const int* o_row = p.maps + 2 * (BM + BN) * F_BK;
    const int* o_col = o_row + BM;
    i64 ro[2], co[16];
    if (p.uniform) {
      const i64 o_base = role_off(d, D_OB, bt) + role_off(d, D_OM, m0) +
                         role_off(d, D_ON, n0);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ro[h] = o_base + __ldg(o_row + a_row0 + 16 * w + lane / 4 + 8 * h);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        co[j] = __ldg(o_col + b_row0 + 8 * (j / 2) + 2 * (lane % 4) + j % 2);
    } else {
      const i64 o_bt = role_off(d, D_OB, bt);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const i64 m = m0 + a_row0 + 16 * w + lane / 4 + 8 * h;
        ro[h] = m < M ? o_bt + role_off(d, D_OM, m) : 0;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const i64 n = n0 + b_row0 + 8 * (j / 2) + 2 * (lane % 4) + j % 2;
        co[j] = n < N ? role_off(d, D_ON, n) : 0;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m0 + a_row0 + 16 * w + lane / 4 + 8 * h >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (n0 + b_row0 + 8 * (j / 2) + 2 * (lane % 4) + j % 2 >= N) continue;
        const int r = 4 * (j / 2) + 2 * h + j % 2;
        if (CPLX)
          reinterpret_cast<float2*>(p.c)[ro[h] + co[j]] =
              make_float2(acc_r[r], acc_i[r]);
        else
          p.c[ro[h] + co[j]] = acc_r[r];
      }
    }
  }
}

// ---------------------------------------------------------------- K3
// A chain of adjacent steps in one thread-block cluster (one launch per
// chain of up to MAX_CHAIN steps).  The host packs every step's words and
// its 32-bit offset tables into one buffer, built once per chain; each
// block copies it into shared memory before the first step, so the step
// loop makes no dependent global loads and divides nothing wider than 32
// bits.  A role's offset at tile t, local index i is lo/hi split at the
// tile extent (64 rows or columns, 16 k, 1 batch cell), hi[t] + lo[i],
// when the extent is a product of trailing axes of the role (every RQC
// form), else a full table read at t * extent + i.
//
// The cluster (16 blocks where the card schedules a non-portable cluster
// of 16, else 8; never more than the chain's largest step has tiles)
// shares each step's 64x64 output tiles (a step with more tiles than the
// cluster has blocks loops over them), and its blocks meet at a cluster
// barrier (release/acquire) between steps.  Carries stay in the device
// workspace, in L2, read with ld.global.cg after the barrier.  Steps have
// K = 1..16 on most of the path, too short for a k8 TF32 wgmma that
// would be mostly padding, so each thread sums a 4x4 block of complex
// outputs on the CUDA cores (direct form, FFMA), the k loop sized by the
// step's K.  Complex operands are (re, im) pairs read in place.  On the
// H100 (chip_smoke.py) a launch costs 0.87 us of device time, a cluster
// barrier 0.54 us and a small step about 2.4 us, the latency of its
// staged loads.
#define C_BM 64
#define C_BN 64
#define C_KC 16
#define C_NT 256
#define C_HDR 4       // words before the first step's words
#define C_SWORDS 40   // words per step
#define C_MAX_EXT (MAX_CHAIN + 1)

// Step words: B, M, N, K, tiles_m, tiles_n, tiles, a_src, b_src, c_dst,
// then (hi, lo, full) for the nine roles in K2's order (AB, AM, AK, BB,
// BK, BN, OB, OM, ON).  A source >= 0 is an external; one < 0 is the
// workspace at element -src - 1.  c_dst -1 is the chain's output, else a
// workspace element offset.
enum { S_TILES = 6, S_ASRC = 7, S_BSRC = 8, S_CDST = 9, S_ROLES = 10 };

struct ChainParams {
  const int* tab;
  const float* ext[C_MAX_EXT];
  float* out;
  float* work;
  int tab_words;  // a multiple of 4
  int nsteps;
};

struct ChainSmem {
  float2 a[C_KC][C_BM];
  float2 b[C_KC][C_BN];
  int arow[C_BM], bcol[C_BN], crow[C_BM], ccol[C_BN], ak[C_KC], bk[C_KC];
};

__device__ __forceinline__ int tab_off(const int* tab, const int* h, int r,
                                       int t, int i) {
  const int hi = h[S_ROLES + 3 * r], lo = h[S_ROLES + 3 * r + 1];
  const int full = h[S_ROLES + 3 * r + 2];
  return full ? tab[hi + t * full + i] : tab[hi + t] + tab[lo + i];
}

template <bool CPLX>
__device__ __forceinline__ float2 ld_elem(const float* p, int off) {
  // carries were written by other blocks during this launch: read them
  // from L2 (L1 is not coherent across SMs)
  if (CPLX) return __ldcg(reinterpret_cast<const float2*>(p) + off);
  return make_float2(__ldcg(p + off), 0.f);
}

template <bool CPLX>
__device__ void chain_tile(ChainSmem& s, const int* tab, const int* h,
                           int tile, const float* A, const float* B,
                           float* C) {
  const int M = h[1], N = h[2], K = h[3], tiles_m = h[4], tiles_n = h[5];
  const int nt = tile % tiles_n, q = tile / tiles_n;
  const int mt = q % tiles_m, bt = q / tiles_m;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  __syncthreads();  // the previous tile is done with the shared tiles
  if (tid < C_BM) {
    const int m = mt * C_BM + tid;
    s.arow[tid] = m < M ? tab_off(tab, h, 0, bt, 0) + tab_off(tab, h, 1, mt, tid) : -1;
    s.crow[tid] = m < M ? tab_off(tab, h, 6, bt, 0) + tab_off(tab, h, 7, mt, tid) : -1;
  } else if (tid < C_BM + C_BN) {
    const int j = tid - C_BM, n = nt * C_BN + j;
    s.bcol[j] = n < N ? tab_off(tab, h, 3, bt, 0) + tab_off(tab, h, 5, nt, j) : -1;
    s.ccol[j] = n < N ? tab_off(tab, h, 8, nt, j) : -1;
  }

  float ar[4][4], ai[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ar[i][j] = ai[i][j] = 0.f;

  const int nkt = (K + C_KC - 1) / C_KC;
  for (int kt = 0; kt < nkt; ++kt) {
    const int kc = min(C_KC, K - kt * C_KC);
    if (tid < C_KC) {
      s.ak[tid] = tid < kc ? tab_off(tab, h, 2, kt, tid) : -1;
    } else if (tid < 2 * C_KC) {
      const int k = tid - C_KC;
      s.bk[k] = k < kc ? tab_off(tab, h, 4, kt, k) : -1;
    }
    __syncthreads();
    const int li = tid & 63;
    for (int ki = tid >> 6; ki < kc; ki += C_NT / 64) {
      const int ra = s.arow[li], cb = s.bcol[li];
      s.a[ki][li] = ra >= 0 ? ld_elem<CPLX>(A, ra + s.ak[ki]) : make_float2(0.f, 0.f);
      s.b[ki][li] = cb >= 0 ? ld_elem<CPLX>(B, cb + s.bk[ki]) : make_float2(0.f, 0.f);
    }
    __syncthreads();
    for (int ki = 0; ki < kc; ++ki) {
      float2 xa[4], yb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xa[i] = s.a[ki][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) yb[j] = s.b[ki][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ar[i][j] = fmaf(xa[i].x, yb[j].x, ar[i][j]);
          if (CPLX) {
            ar[i][j] = fmaf(-xa[i].y, yb[j].y, ar[i][j]);
            ai[i][j] = fmaf(xa[i].x, yb[j].y, ai[i][j]);
            ai[i][j] = fmaf(xa[i].y, yb[j].x, ai[i][j]);
          }
        }
    }
    __syncthreads();
  }
  if (nkt == 0) __syncthreads();  // the row tables, written above

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ro = s.crow[ty + 16 * i];
    if (ro < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = s.ccol[tx + 16 * j];
      if (co < 0) continue;
      if (CPLX)
        reinterpret_cast<float2*>(C)[ro + co] = make_float2(ar[i][j], ai[i][j]);
      else
        C[ro + co] = ar[i][j];
    }
  }
}

template <bool CPLX>
__device__ __forceinline__ const float* chain_src(const ChainParams& p,
                                                  int src) {
  return src >= 0 ? p.ext[src] : p.work + (CPLX ? 2 : 1) * (i64)(-src - 1);
}

template <bool CPLX>
__global__ void __launch_bounds__(C_NT)
chain_gemm_kernel(const __grid_constant__ ChainParams p) {
  extern __shared__ int4 c_smem[];
  const int words4 = p.tab_words / 4;
  for (int i = threadIdx.x; i < words4; i += C_NT)
    c_smem[i] = __ldg(reinterpret_cast<const int4*>(p.tab) + i);
  const int* tab = reinterpret_cast<const int*>(c_smem);
  ChainSmem& s = *reinterpret_cast<ChainSmem*>(c_smem + words4);
  __syncthreads();
  // the grid is one cluster: block b is the cluster's rank b
  for (int t = 0; t < p.nsteps; ++t) {
    const int* h = tab + C_HDR + t * C_SWORDS;
    const float* A = chain_src<CPLX>(p, h[S_ASRC]);
    const float* B = chain_src<CPLX>(p, h[S_BSRC]);
    float* C = h[S_CDST] < 0 ? p.out : p.work + (CPLX ? 2 : 1) * (i64)h[S_CDST];
    for (int tile = blockIdx.x; tile < h[S_TILES]; tile += gridDim.x)
      chain_tile<CPLX>(s, tab, h, tile, A, B, C);
    if (t + 1 < p.nsteps) hopper::cluster_sync();
  }
}

// The floor of one K3 launch, for its timing: a cluster that only meets
// at `barriers` cluster barriers.
__global__ void empty_cluster_kernel(int barriers) {
  for (int i = 0; i < barriers; ++i) hopper::cluster_sync();
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


static int sm_count(int* n) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  *n = cached;
  return 0;
}

template <bool CPLX, bool WIDE>
static int launch_fused(const FusedArgs& args, cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_gemm_kernel<CPLX, WIDE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  const i64 grid = args.tiles < sms ? args.tiles : sms;
  fused_gemm_kernel<CPLX, WIDE><<<(unsigned)grid, F_THREADS, F_SMEM, stream>>>(
      args);
  return (int)cudaGetLastError();
}

// K2 on an oriented descriptor and its gather maps (see fused_gemm_kernel):
// complex64 operands as (re, im) float pairs when cplx, fp32 otherwise.
extern "C" int repro_fused_gemm(const i64* desc, const int* maps, int uniform,
                                int wide, int cplx, i64 tiles, const float* a,
                                const float* b, float* c, void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  const FusedArgs args{desc, maps, a, b, c, tiles, uniform};
  cudaStream_t st = (cudaStream_t)stream;
  if (cplx)
    return wide ? launch_fused<true, true>(args, st)
                : launch_fused<true, false>(args, st);
  return wide ? launch_fused<false, true>(args, st)
              : launch_fused<false, false>(args, st);
}

// Launch `fn` as one cluster of `cluster` blocks of `threads`.
static int launch_cluster(const void* fn, int cluster, int threads, int smem,
                          void** args, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Shared memory of a chain launch: its tables, then the tiles.
extern "C" int repro_chain_smem(int tab_words) {
  return tab_words * 4 + (int)sizeof(ChainSmem);
}

// K3: one segment of a chain (p->nsteps <= MAX_CHAIN steps) as one
// cluster of `cluster` blocks (1..16; above 8 needs the non-portable
// cluster size).
extern "C" int repro_chain_gemm(const ChainParams* p, int cplx, int cluster,
                                void* stream) {
  if (p->nsteps < 1 || p->nsteps > MAX_CHAIN || cluster < 1 || cluster > 16 ||
      p->tab_words % 4)
    return (int)cudaErrorInvalidValue;
  static int smem_ok[2] = {48 << 10, 48 << 10};
  static bool wide_ok[2] = {false, false};
  const void* fn = cplx ? (const void*)chain_gemm_kernel<true>
                        : (const void*)chain_gemm_kernel<false>;
  const int smem = repro_chain_smem(p->tab_words);
  cudaError_t err = cudaSuccess;
  if (smem > smem_ok[cplx]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_ok[cplx] = smem;
  }
  if (cluster > 8 && !wide_ok[cplx]) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    wide_ok[cplx] = true;
  }
  void* args[] = {const_cast<ChainParams*>(p)};
  return launch_cluster(fn, cluster, C_NT, smem, args, (cudaStream_t)stream);
}

// The largest cluster K3 launches with `smem` bytes of shared memory a
// block: 16 blocks (non-portable) where the card can schedule such a
// cluster, else 8 (the portable size, which every Hopper card takes).
extern "C" int repro_chain_cluster_max(int smem, int* out) {
  const void* fn = (const void*)chain_gemm_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > (48 << 10))
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(C_NT);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 16;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  *out = clusters > 0 ? 16 : 8;
  return 0;
}

// An empty kernel launched as one cluster of `cluster` blocks of C_NT
// (1..16) that meets at `barriers` cluster barriers.
extern "C" int repro_empty_cluster(int cluster, int barriers, void* stream) {
  if (cluster < 1 || cluster > 16 || barriers < 0)
    return (int)cudaErrorInvalidValue;
  static bool wide_ok = false;
  if (cluster > 8 && !wide_ok) {
    cudaError_t err = cudaFuncSetAttribute(
        (const void*)empty_cluster_kernel,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    wide_ok = true;
  }
  void* args[] = {&barriers};
  return launch_cluster((const void*)empty_cluster_kernel, cluster, C_NT, 0,
                        args, (cudaStream_t)stream);
}
