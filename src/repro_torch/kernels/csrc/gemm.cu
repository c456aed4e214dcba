// Contraction GEMM kernels for Hopper (sm_90a): fp32 (3xTF32) and bf16
// routes.
//
// Three kernels, one per TPU kernel of src/repro/kernels/contract_gemm.py:
//
//   tiled_gemm_kernel  <- tiled_matmul (_matmul_kernel)
//       C[b] = A[b] @ B[b]: K2's body (below) on the step in GEMM order,
//       real or complex64 operands read in place and split to TF32 hi/lo
//       (a.b ~= a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, about 22 of fp32's 24
//       mantissa bits per product), or rounded to bf16, in its producer
//       warps.
//   fused_gemm_kernel  <- fused_transpose_matmul (_fused_kernel)
//       one contraction step on operands in their native tree layouts,
//       complex64 read and written in place: producer warps gather each
//       tile through a map of its elements in ascending native offset
//       (coalesced), split them into TF32 hi/lo planes (or round them to
//       bf16) in shared memory, and two consumer warpgroups run 3xTF32 (or
//       bf16) wgmma on them; the output is written straight into the
//       step's inds_out layout, at full width or as bf16.
//   chain_gemm_kernel  <- fused_chain_matmul (_chain_kernel, _run_chain)
//       a run of adjacent steps in one thread-block cluster: the blocks
//       share each step's output tiles, a cluster barrier separates the
//       steps, and interior carries live in a device workspace laid out
//       by the planner's slot assignment; each step fp32, or bf16 inputs.
//
// Every kernel keeps one ordered sum over K per output element (no
// split-K, no atomics), so its result does not depend on the launch
// geometry.  The bf16 routes round each operand component to bf16 at the
// kernel's load (round to nearest even) and accumulate in fp32; a bf16
// product is exact in fp32, so they match their plain versions (round,
// then the fp32 product) up to the order of the sum.
//
// What bounds them on the H100.  K1 does three TF32 products per fp32
// product, so its least time is its operations at a third of the 495
// TFLOP/s TF32 peak (165 TFLOP/s fp32-accurate); its bf16 route runs at
// the bf16 rate.  K2 on the path's steps (M up to 2^20 rows, N <= 128, K
// = 64..1024) reads its large operand once: its bytes (8 per complex
// element of A, B and C) at 3.35 TB/s and its 3xTF32 operations take
// about the same time, so the gather must keep enough loads in flight to
// stream A at the HBM rate while the tensor cores run; the gather and the
// TF32 split cost shared-memory bandwidth beside wgmma's own reads (see
// the note at the kernel).  K3's steps are tiny (a few thousand outputs,
// K = 1..16 on most), so it is bound by latency: the launch, one barrier
// per step, and the dependent loads of each step's addressing, which it
// stages in shared memory before the first step.

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
// FADD, rounded to nearest: the tensor cores' own fp32 accumulation is
// not, and its error grows with the length of one wgmma sum (one sum over
// K = 1000 was off by 1e-3 on outputs near 30 on the H100).  The epilogue writes (re, im) pairs straight into the
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
  const void* a;
  const void* b;
  void* c;
  i64 tiles;
  int uniform;      // the maps hold every tile's offsets, output included
  int flags;        // F_A16 | F_B16 | F_C16: operands and output held as
                    // bf16 (bf16 (re, im) pairs when complex)
};

enum { F_A16 = 2, F_B16 = 4, F_C16 = 8 };

// Byte offset of element (row, k) in a 128-byte-swizzled K-major plane of
// fp32: rows of 32 values, 16-byte chunks permuted by the row's index
// within its 8-row group (the layout TMA's SWIZZLE_128B writes).
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 2) ^ row) & 7) << 4) + ((k & 3) << 2);
}

// The same for a plane of bf16: rows of 64 values (k in 0..63), 16-byte
// chunks of eight, permuted the same way.
__device__ __forceinline__ int swz16(int row, int k) {
  return row * 128 + ((((k >> 3) ^ row) & 7) << 4) + ((k & 7) << 1);
}

// One element (re, im) of an operand at element offset `off`: fp32 or
// complex64 (re, im) floats, or bf16 / bf16 (re, im) pairs (IN16).
template <bool CPLX, bool IN16>
__device__ __forceinline__ float2 ld_val(const void* src, i64 off) {
  if (IN16) {
    if (CPLX)
      return hopper::bf16x2_float2(
          hopper::ldg_b32(static_cast<const uint32_t*>(src) + off));
    return make_float2(
        __uint_as_float(
            hopper::ldg_b16(static_cast<const unsigned short*>(src) + off)
            << 16),
        0.f);
  }
  if (CPLX) return hopper::ldg_f2(static_cast<const float2*>(src) + off);
  return make_float2(hopper::ldg_f1(static_cast<const float*>(src) + off),
                     0.f);
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
//
// The bf16 route (BF) stores each element rounded to bf16 into one plane
// per component (re, im) of rows of 64 k, two 32-wide k-tiles a stage:
// `half` says which 32 k of the row this tile fills.  A tile past the
// operand's K (`valid` false) is stored as zeros.
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

template <bool CPLX, int R, bool BF, bool IN16>
__device__ __forceinline__ void gather_tile(
    uint8_t* planes, const void* src, i64 base, bool uniform, int rel_t,
    int sw_t, const int (&kj)[4], const int* drel, const int* dsw,
    const int* __restrict__ slot, const i64* rows, const i64* ks, int t,
    int half, bool valid) {
  constexpr int PLANE = R * 128;
  const uint32_t dst = hopper::smem_u32(planes);
  if (uniform) {
    constexpr int CPER = R * (F_BK / 4) / F_PT;  // chunks a thread
    float2 v[CPER][4];
    const i64 b = base + rel_t;
#pragma unroll
    for (int c = 0; c < CPER; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[c][j] = valid ? ld_val<CPLX, IN16>(src, b + drel[c] + kj[j])
                        : make_float2(0.f, 0.f);
#pragma unroll
    for (int c = 0; c < CPER; ++c) {
      const int o32 = sw_t ^ dsw[c];
      const float re[4] = {v[c][0].x, v[c][1].x, v[c][2].x, v[c][3].x};
      const float im[4] = {v[c][0].y, v[c][1].y, v[c][2].y, v[c][3].y};
      if (BF) {
        // the chunk's row and first k, from its fp32-plane offset
        const int row = o32 >> 7;
        const int k0 = ((((o32 >> 4) ^ row) & 7) << 2) + 32 * half;
        const uint32_t o = dst + swz16(row, k0);
        hopper::sts_v2(o, hopper::bf16x2_bits(re[0], re[1]),
                       hopper::bf16x2_bits(re[2], re[3]));
        if (CPLX)
          hopper::sts_v2(o + PLANE, hopper::bf16x2_bits(im[0], im[1]),
                         hopper::bf16x2_bits(im[2], im[3]));
      } else {
        const uint32_t o = dst + o32;
        float4 hi, lo;
        split4(re, hi, lo);
        hopper::sts_v4(o, hi);
        hopper::sts_v4(o + PLANE, lo);
        if (CPLX) {
          split4(im, hi, lo);
          hopper::sts_v4(o + 2 * PLANE, hi);
          hopper::sts_v4(o + 3 * PLANE, lo);
        }
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
    const bool ok = valid && ro >= 0 && ko >= 0;
    v[i] = ld_val<CPLX, IN16>(src, ok ? ro + ko : 0);
    if (!ok) v[i] = make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (BF) {
      const uint32_t o = dst + swz16(sl[i] >> 5, (sl[i] & 31) + 32 * half);
      hopper::sts_b16(o, hopper::bf16_bits(v[i].x));
      if (CPLX) hopper::sts_b16(o + PLANE, hopper::bf16_bits(v[i].y));
    } else {
      store_split<CPLX>(dst, PLANE, swz(sl[i] >> 5, sl[i] & 31), v[i].x,
                        v[i].y);
    }
  }
}

template <bool CPLX, int R, bool BF>
__device__ __forceinline__ void gather_operand(
    bool in16, uint8_t* planes, const void* src, i64 base, bool uniform,
    int rel_t, int sw_t, const int (&kj)[4], const int* drel, const int* dsw,
    const int* __restrict__ slot, const i64* rows, const i64* ks, int t,
    int half, bool valid) {
  if (in16)
    gather_tile<CPLX, R, BF, true>(planes, src, base, uniform, rel_t, sw_t, kj,
                                   drel, dsw, slot, rows, ks, t, half, valid);
  else
    gather_tile<CPLX, R, BF, false>(planes, src, base, uniform, rel_t, sw_t,
                                    kj, drel, dsw, slot, rows, ks, t, half,
                                    valid);
}

// The kernel body, shared by K2 (fused_gemm_kernel: a tree step in its
// native layouts) and K1's in-place route (tiled_gemm_kernel: the step in
// GEMM order, whose maps describe plain row-major operands).  BF: the
// bf16 route, each stage two 32-wide k-tiles as bf16 planes (re, im) of
// 64 k a row, read by bf16 wgmma m64n64k16 (four k16 steps a stage);
// otherwise 3xTF32 on four TF32 planes a complex operand, one k-tile a
// stage.  Either way each stage's products go to fresh partial sums
// added into the fp32 accumulators.
template <bool CPLX, bool WIDE, bool BF>
__device__ __forceinline__ void fused_body(const FusedArgs& p) {
  constexpr int BM = FusedTile<WIDE>::BM, BN = FusedTile<WIDE>::BN;
  constexpr int A_PLANE = BM * 128, B_PLANE = BN * 128;
  constexpr int HALVES = BF ? 2 : 1;  // 32-wide k-tiles a stage
  extern __shared__ uint8_t f_smem_raw[];
  __shared__ __align__(8) uint64_t full[F_STAGES], empty[F_STAGES];
  __shared__ i64 rows_a[BM], rows_b[BN], ks_a[F_BK], ks_b[F_BK];
  __shared__ int deltas[4][8];  // uniform maps: A's drel, dsw, then B's
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(f_smem_raw) + 1023) & ~uintptr_t(1023));

  const i64* d = p.desc;
  const i64 M = __ldg(d + D_M), N = __ldg(d + D_N), K = __ldg(d + D_K);
  const i64 tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int nk = (int)((K + F_BK - 1) / F_BK);     // 32-wide k-tiles
  const int nst = (nk + HALVES - 1) / HALVES;      // stages a tile

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
    const bool a16 = p.flags & F_A16, b16 = p.flags & F_B16;
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
      for (int st = 0; st < nst; ++st, ++it) {
        const int s = it % F_STAGES;
        if (it >= F_STAGES)
          hopper::mbar_wait(&empty[s], ((it / F_STAGES) - 1) & 1);
        uint8_t* stage = smem + s * F_STAGE_BYTES;
#pragma unroll
        for (int h = 0; h < HALVES; ++h) {
          const int kt = st * HALVES + h;
          const bool valid = kt < nk;
          const i64 k0 = (i64)kt * F_BK;
          i64 a_base = 0, b_base = 0;
          if (p.uniform) {
            if (valid) {
              a_base = a_tile + __ldg(ka + kt);
              b_base = b_tile + __ldg(kb + kt);
            }
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
          gather_operand<CPLX, BM, BF>(a16, stage, p.a, a_base, p.uniform,
                                       rel_ta, sw_ta, kj_a, deltas[0],
                                       deltas[1], a_slot, rows_a, ks_a, t, h,
                                       valid);
          gather_operand<CPLX, BN, BF>(b16, stage + 4 * A_PLANE, p.b, b_base,
                                       p.uniform, rel_tb, sw_tb, kj_b,
                                       deltas[2], deltas[3], b_slot, rows_b,
                                       ks_b, t, h, valid);
        }
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
    for (int st = 0; st < nst; ++st, ++it) {
      const int s = it % F_STAGES;
      hopper::mbar_wait(&full[s], (it / F_STAGES) & 1);
      const uint8_t* A = smem + s * F_STAGE_BYTES + a_row0 * 128;
      const uint8_t* B = smem + s * F_STAGE_BYTES + 4 * A_PLANE + b_row0 * 128;
      hopper::wgmma_fence();
      hopper::fence_regs(pr);
      if (CPLX) hopper::fence_regs(pi);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // a k8 (TF32) or k16 (bf16) step: 32 bytes along the row
        const int kb = 32 * k;
        const uint64_t arh = hopper::desc_kmajor(A + kb);
        const uint64_t brh = hopper::desc_kmajor(B + kb);
        if (BF) {
          // bf16 planes: re at 0, im at one plane further
          if (CPLX) {
            const uint64_t aih = hopper::desc_kmajor(A + A_PLANE + kb);
            const uint64_t bih = hopper::desc_kmajor(B + B_PLANE + kb);
            hopper::wgmma_m64n64k16_bf16_ss<1>(pr, arh, brh, k > 0);
            hopper::wgmma_m64n64k16_bf16_ss<-1>(pr, aih, bih, 1);
            hopper::wgmma_m64n64k16_bf16_ss<1>(pi, arh, bih, k > 0);
            hopper::wgmma_m64n64k16_bf16_ss<1>(pi, aih, brh, 1);
          } else {
            hopper::wgmma_m64n64k16_bf16_ss<1>(pr, arh, brh, k > 0);
          }
          continue;
        }
        const uint64_t arl = hopper::desc_kmajor(A + A_PLANE + kb);
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
    const bool c16 = p.flags & F_C16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m0 + a_row0 + 16 * w + lane / 4 + 8 * h >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (n0 + b_row0 + 8 * (j / 2) + 2 * (lane % 4) + j % 2 >= N) continue;
        const int r = 4 * (j / 2) + 2 * h + j % 2;
        const i64 o = ro[h] + co[j];
        if (c16) {
          if (CPLX)
            static_cast<uint32_t*>(p.c)[o] =
                hopper::bf16x2_bits(acc_r[r], acc_i[r]);
          else
            static_cast<unsigned short*>(p.c)[o] =
                (unsigned short)hopper::bf16_bits(acc_r[r]);
        } else if (CPLX) {
          static_cast<float2*>(p.c)[o] = make_float2(acc_r[r], acc_i[r]);
        } else {
          static_cast<float*>(p.c)[o] = acc_r[r];
        }
      }
    }
  }
}

template <bool CPLX, bool WIDE, bool BF>
__global__ void __launch_bounds__(F_THREADS, 1)
fused_gemm_kernel(const __grid_constant__ FusedArgs p) {
  fused_body<CPLX, WIDE, BF>(p);
}

// K1's in-place route: the same body on the step in GEMM order (see
// repro_fused_gemm).
template <bool CPLX, bool WIDE, bool BF>
__global__ void __launch_bounds__(F_THREADS, 1)
tiled_gemm_kernel(const __grid_constant__ FusedArgs p) {
  fused_body<CPLX, WIDE, BF>(p);
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
// step's K.  Complex operands are (re, im) pairs read in place.  A bf16
// step rounds each operand element to bf16 as it is staged (the products
// of bf16 values are exact in fp32, so this is bf16 inputs with fp32
// accumulation on the CUDA cores: K3 is bound by latency, not by its
// arithmetic, so it takes no tensor-core route), and reads or writes
// bf16 where an external, a workspace slot or the output is held so.  On the
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
// BK, BN, OB, OM, ON), then the step's flags.  A source >= 0 is an
// external; one < 0 is the workspace at element -src - 1.  c_dst -1 is
// the chain's output, else a workspace element offset.  Workspace
// offsets count full-width elements; a bf16 slot holds its values as
// bf16 from there.
enum { S_TILES = 6, S_ASRC = 7, S_BSRC = 8, S_CDST = 9, S_ROLES = 10,
       S_FLAGS = 37 };
// S_FLAGS: S_BF (the step reads bf16: each operand element is rounded to
// bf16 as it is staged, and the FFMA products of bf16 values are exact),
// and F_A16 / F_B16 / F_C16 (A, B or the output held as bf16, in a bf16
// workspace slot, a half-width external or the chain's output).
enum { S_BF = 1 };

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
__device__ __forceinline__ float2 ld_elem(const float* p, int off, bool h16,
                                          bool bf) {
  // carries were written by other blocks during this launch: read them
  // from L2 (L1 is not coherent across SMs)
  float2 v;
  if (h16) {
    v = CPLX ? hopper::bf16x2_float2(
                   __ldcg(reinterpret_cast<const unsigned int*>(p) + off))
             : make_float2(
                   __uint_as_float(
                       (uint32_t)__ldcg(
                           reinterpret_cast<const unsigned short*>(p) + off)
                       << 16),
                   0.f);
  } else {
    v = CPLX ? __ldcg(reinterpret_cast<const float2*>(p) + off)
             : make_float2(__ldcg(p + off), 0.f);
  }
  if (bf) v = make_float2(hopper::bf16_round(v.x), hopper::bf16_round(v.y));
  return v;
}

// MIXED: the launch has a step with flags (a bf16 step or a half-width
// operand or output); otherwise every flag is known to be 0 and the loads
// and stores are the fp32 ones, with no branch on the widths.
template <bool CPLX, bool MIXED>
__device__ void chain_tile(ChainSmem& s, const int* tab, const int* h,
                           int tile, const float* A, const float* B,
                           float* C) {
  const int M = h[1], N = h[2], K = h[3], tiles_m = h[4], tiles_n = h[5];
  const int flags = MIXED ? h[S_FLAGS] : 0;
  const bool bf = flags & S_BF, a16 = flags & F_A16, b16 = flags & F_B16;
  const bool c16 = flags & F_C16;
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
      s.a[ki][li] = ra >= 0 ? ld_elem<CPLX>(A, ra + s.ak[ki], a16, bf)
                            : make_float2(0.f, 0.f);
      s.b[ki][li] = cb >= 0 ? ld_elem<CPLX>(B, cb + s.bk[ki], b16, bf)
                            : make_float2(0.f, 0.f);
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
      if (c16) {
        if (CPLX)
          reinterpret_cast<uint32_t*>(C)[ro + co] =
              hopper::bf16x2_bits(ar[i][j], ai[i][j]);
        else
          reinterpret_cast<unsigned short*>(C)[ro + co] =
              (unsigned short)hopper::bf16_bits(ar[i][j]);
      } else if (CPLX) {
        reinterpret_cast<float2*>(C)[ro + co] = make_float2(ar[i][j], ai[i][j]);
      } else {
        C[ro + co] = ar[i][j];
      }
    }
  }
}

template <bool CPLX>
__device__ __forceinline__ const float* chain_src(const ChainParams& p,
                                                  int src) {
  return src >= 0 ? p.ext[src] : p.work + (CPLX ? 2 : 1) * (i64)(-src - 1);
}

template <bool CPLX, bool MIXED>
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
      chain_tile<CPLX, MIXED>(s, tab, h, tile, A, B, C);
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

template <bool CPLX, bool WIDE, bool BF, bool TILED>
static int launch_fused(const FusedArgs& args, cudaStream_t stream) {
  static bool ready = false;
  const void* fn = TILED ? (const void*)tiled_gemm_kernel<CPLX, WIDE, BF>
                         : (const void*)fused_gemm_kernel<CPLX, WIDE, BF>;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc) return rc;
  const i64 grid = args.tiles < sms ? args.tiles : sms;
  void* kargs[] = {const_cast<FusedArgs*>(&args)};
  cudaError_t err = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(F_THREADS),
                                     kargs, F_SMEM, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool CPLX, bool WIDE, bool BF>
static int launch_fused(const FusedArgs& args, int tiled, cudaStream_t st) {
  return tiled ? launch_fused<CPLX, WIDE, BF, true>(args, st)
               : launch_fused<CPLX, WIDE, BF, false>(args, st);
}

template <bool CPLX, bool WIDE>
static int launch_fused(const FusedArgs& args, int bf, int tiled,
                        cudaStream_t st) {
  return bf ? launch_fused<CPLX, WIDE, true>(args, tiled, st)
            : launch_fused<CPLX, WIDE, false>(args, tiled, st);
}

// K2 (tiled = 0) or K1's in-place route (tiled = 1) on an oriented
// descriptor and its gather maps (see fused_body): complex operands as
// (re, im) pairs when cplx, real otherwise.  flags: 1 the bf16 route,
// F_A16 / F_B16 / F_C16 the operands and output held as bf16.
extern "C" int repro_fused_gemm(const i64* desc, const int* maps, int uniform,
                                int wide, int cplx, i64 tiles, const void* a,
                                const void* b, void* c, int flags, int tiled,
                                void* stream) {
  if (tiles <= 0) return (int)cudaErrorInvalidValue;
  const FusedArgs args{desc, maps, a, b, c, tiles, uniform, flags};
  cudaStream_t st = (cudaStream_t)stream;
  const int bf = flags & 1;
  if (cplx)
    return wide ? launch_fused<true, true>(args, bf, tiled, st)
                : launch_fused<true, false>(args, bf, tiled, st);
  return wide ? launch_fused<false, true>(args, bf, tiled, st)
              : launch_fused<false, false>(args, bf, tiled, st);
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
// cluster size); `mixed` when a step of it has flags.
extern "C" int repro_chain_gemm(const ChainParams* p, int cplx, int mixed,
                                int cluster, void* stream) {
  if (p->nsteps < 1 || p->nsteps > MAX_CHAIN || cluster < 1 || cluster > 16 ||
      p->tab_words % 4)
    return (int)cudaErrorInvalidValue;
  static int smem_ok[2][2] = {{48 << 10, 48 << 10}, {48 << 10, 48 << 10}};
  static bool wide_ok[2][2] = {{false, false}, {false, false}};
  const void* fns[2][2] = {
      {(const void*)chain_gemm_kernel<false, false>,
       (const void*)chain_gemm_kernel<false, true>},
      {(const void*)chain_gemm_kernel<true, false>,
       (const void*)chain_gemm_kernel<true, true>}};
  cplx = cplx != 0;
  mixed = mixed != 0;
  const void* fn = fns[cplx][mixed];
  const int smem = repro_chain_smem(p->tab_words);
  cudaError_t err = cudaSuccess;
  if (smem > smem_ok[cplx][mixed]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    smem_ok[cplx][mixed] = smem;
  }
  if (cluster > 8 && !wide_ok[cplx][mixed]) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    wide_ok[cplx][mixed] = true;
  }
  void* args[] = {const_cast<ChainParams*>(p)};
  return launch_cluster(fn, cluster, C_NT, smem, args, (cudaStream_t)stream);
}

// The largest cluster K3 launches with `smem` bytes of shared memory a
// block: 16 blocks (non-portable) where the card can schedule such a
// cluster, else 8 (the portable size, which every Hopper card takes).
extern "C" int repro_chain_cluster_max(int smem, int* out) {
  const void* fn = (const void*)chain_gemm_kernel<true, false>;
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
