// Hopper (sm_90a) building blocks shared by the wgmma kernels of this
// directory: mbarriers, TMA tile loads and bulk copies, wgmma
// shared-memory descriptors and the wgmma shapes the kernels use, and
// the host-side encoding of a TMA tensor map.
//
// Conventions.  Every tile a wgmma reads from shared memory is written by
// TMA with CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes, groups of 8 rows
// (1024 bytes) that repeat the swizzle pattern, so every tile starts on a
// 1024-byte boundary.  A K-major operand (K contiguous) advances along K
// by moving the descriptor's start address 32 bytes per 16-byte-type k16
// (or tf32 k8) step inside the 128-byte row; the stride between 8-row
// groups (SBO) is 1024 bytes.  An MN-major 16-bit operand (the transpose
// bit set) holds 64 MN elements per 128-byte row and 8 K rows per group,
// so a k16 step is two groups: SBO 1024 bytes, and a wgmma of N = 64 reads
// one 128-byte column of groups.
//
// cuTensorMapEncodeTiled lives in libcuda, not in the CUDA runtime.  It
// is fetched at run time through cudaGetDriverEntryPoint, so the
// libraries link the CUDA runtime only (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------ mbarriers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the inits, before any thread or the TMA unit uses the barriers
// (followed by a __syncthreads()).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed (phases count
// from 0; a barrier used for the u-th time completes phase u).  A wait
// that lasts ~10 s (a load that never lands) traps, so a fault ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

// Tiles stored into shared memory by threads (the generic proxy) and read
// by wgmma (the async proxy): each storing thread fences before it
// signals the tile's mbarrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over the first `count` threads that reach it, a
// multiple of 32; id 0 is __syncthreads().
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Every thread of every block of the cluster: writes before the arrive
// (global memory included) are visible to reads after the wait.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Plain loads and shared stores as volatile asm, so the compiler keeps
// them in program order: a producer that issues a batch of loads before
// its first store keeps them all in flight at once.  The loads go through
// L1, where the other loads of the same sectors in the batch find them.
__device__ __forceinline__ float2 ldg_f2(const float2* p) {
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
  return v;
}

__device__ __forceinline__ float ldg_f1(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ldg_b32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ldg_b16(const void* p) {
  unsigned short v;
  asm volatile("ld.global.nc.b16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void sts_b16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"((unsigned short)v)
               : "memory");
}

__device__ __forceinline__ void sts_v2(uint32_t addr, uint32_t lo,
                                       uint32_t hi) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(lo),
               "r"(hi)
               : "memory");
}

// bf16 <-> fp32.  bf16_bits rounds to nearest even (finite x), as
// torch's conversion does; a bf16 value widens exactly.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __uint_as_float(bf16_bits(x) << 16);
}

// Two bf16 values in one 32-bit word, `lo` at the lower address.
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

__device__ __forceinline__ float2 bf16x2_float2(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void sts_v4(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
// away from zero, as an fp32 value: what cvt.rna.tf32.f32 gives for finite
// x, by two integer operations at the full integer rate (half the dropped
// field added to the magnitude bits, then the 13 dropped bits cleared).
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// ------------------------------------------------------------ TMA loads
// Box at element coordinates (c0 innermost) of the tensor map into shared
// memory at `dst`; completion is counted in bytes on `bar`.  Elements out
// of the tensor's bounds arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------ wgmma
// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout type 1
// (SWIZZLE_128B) in bits 62-63, base offset 0 (tiles are 1024-aligned).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major tile: K inside the 128-byte row, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return desc_sw128(p, 16, 1024);
}

// MN-major 16-bit tile read 64 MN elements wide (one 128-byte row per K
// index): the 8-row K groups lie 1024 bytes apart.  No second MN column
// is read, so both offsets carry the group stride.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* p) {
  return desc_sw128(p, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64x128, fp32) (+)= A(64x16, bf16, smem, K-major) . B(16x128, bf16,
// smem, K-major: stored 128 rows of N with K contiguous).
__device__ __forceinline__ void wgmma_m64n128k16_bf16_ss(float (&d)[64],
                                                         uint64_t desc_a,
                                                         uint64_t desc_b,
                                                         int scale_d) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));

}

// D(64x64, fp32) (+)= SA * A(64x16, bf16, smem, K-major) . B(16x64, bf16,
// smem, K-major), SA = +1 or -1 (imm-scale-a).
template <int SA>
__device__ __forceinline__ void wgmma_m64n64k16_bf16_ss(float (&d)[32],
                                                        uint64_t desc_a,
                                                        uint64_t desc_b,
                                                        int scale_d) {
  static_assert(SA == 1 || SA == -1, "imm-scale-a is +1 or -1");
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, %35, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(SA));
}

// D(64x64, fp32) (+)= A(64x16, bf16, registers) . B(16x64, bf16, smem,
// MN-major: the transpose bit).  A's four registers per thread hold the
// fragment of mma.sync's m16n8k16 A operand for the thread's warp rows.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32],
                                                        const uint32_t (&a)[4],
                                                        uint64_t desc_b,
                                                        int scale_d) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));

}

// D(64x64, fp32) (+)= SA * A(64x8, tf32, smem, K-major) . B(8x64, tf32,
// smem, K-major), SA = +1 or -1 (the instruction's imm-scale-a, so a
// negated product costs nothing).
template <int SA>
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ss(float (&d)[32],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int scale_d) {
  static_assert(SA == 1 || SA == -1, "imm-scale-a is +1 or -1");
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, %35, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(SA));

}

// D(64x64, fp32) (+)= A(64x8, tf32, registers) . B(8x64, tf32, smem,
// K-major).  A's four registers per thread hold the fragment of
// mma.sync's m16n8k8 tf32 A operand for the thread's warp rows: with
// g = lane / 4 and q = lane % 4, a0 = (g, q), a1 = (g + 8, q),
// a2 = (g, q + 4), a3 = (g + 8, q + 4).  The registers are read while
// the wgmma runs: keep them alive (fence_regs) until its wait.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_rs(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b,
                                                       int scale_d) {
  asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));

}

// ------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn lookup_encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  return reinterpret_cast<EncodeTiledFn>(fn);
}

// A tiled tensor map of rank 2 or 3 over `base`: `dims` innermost first
// (elements), `strides` the byte strides of dims 1..rank-1 (multiples of
// 16), `box` the tile in elements (inner box 128 bytes for the swizzle).
// 128-byte swizzle, zeros out of bounds.  Returns a CUDA error code.
static inline cudaError_t make_tensor_map(CUtensorMap* map,
                                          CUtensorMapDataType type, int rank,
                                          const void* base,
                                          const uint64_t* dims,
                                          const uint64_t* strides,
                                          const uint32_t* box) {
  static const EncodeTiledFn encode = lookup_encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (rank < 2 || rank > 3 || reinterpret_cast<uintptr_t>(base) % 16)
    return cudaErrorInvalidValue;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t bdim[3], estride[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) {
    if (strides[i] % 16) return cudaErrorInvalidValue;
    gstride[i] = strides[i];
  }
  const CUresult res = encode(
      map, type, (cuuint32_t)rank, const_cast<void*>(base), gdim, gstride,
      bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
