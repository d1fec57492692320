// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma kernels
// (gemm_bf16.cu, mips_topk.cu, t5_attention_fwd.cu): mbarriers, 2-D and 4-D
// TMA loads, wgmma shared-memory descriptors and instructions (A from
// shared memory or from registers), register reallocation, and the
// host-side tensor maps.
//
// The pipeline these pieces make, in the GEMM and K5/K6: one producer warpgroup
// whose first thread keeps TMA loads in flight into a ring of shared-memory
// stages (each stage guarded by a "full" mbarrier, armed with the bytes it
// expects, and an "empty" one that the consumers release), and consumer
// warpgroups that run wgmma on the stages that have landed. Tiles are 128
// bytes wide along K and loaded with the 128-byte swizzle, which is the
// layout the wgmma descriptors below name (layout type 1), so wgmma reads
// them without bank conflicts. setmaxnreg moves registers from the
// producer (which needs few) to the consumers (accumulators).
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, fetched
// through the runtime's driver entry point so that the library needs no
// -lcuda, and passed to the kernels as __grid_constant__ parameters.
//
// Also the attention kernels' tensor maps (q/k/v/g as 4-D maps bounded per
// dimension, pos as 32 x 64 fp32 boxes) and their 64-row tile loads.
//
// Replaces no TPU kernel by itself: its users port the projections of
// _v3_fwd_kernel (pacednegatives_tpu/ops/flash_v3.py:94-147, bound here by
// the tensor cores) and the scores of _mips_block_kernel (ops/mips.py:
// 73-138, bound here by the bytes of the docs). Against both bounds these
// pieces keep loads off the threads (TMA), the tensor cores at their full
// rate (wgmma from swizzled shared memory) and loads under products (the
// ring).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// Device side
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier how many bytes its TMA loads
// will deliver in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// 2-D TMA load of one box at element coordinates (x inner, y outer); the
// barrier's transaction count drops by the box's bytes when it lands
// (out-of-bounds elements are zero-filled and counted).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// 4-D TMA load of one box at element coordinates (x innermost .. w).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y, int z,
                                            int w) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y),
      "r"(z), "r"(w)
      : "memory");
}

// 2-D TMA store of one box from shared memory (out-of-bounds elements are
// not written), tracked by the issuing thread's bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until this thread's stores have read their shared-memory sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until this thread's stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 8 b16 matrices from registers to shared memory: r[i] holds this
// lane's pair (row lane / 4, columns 2 * (lane % 4) + 0, 1) of matrix i, the
// layout of an mma / wgmma accumulator fragment; lane l gives the address
// of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr,
                                            const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// Barrier `id` (1..15) over `threads` threads, e.g. one warpgroup.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Addresses and
// offsets in bytes (encoded in 16-byte units). K-major operands (rows of
// 128 bytes along K): the stride between 8-row groups is 1024, the leading
// offset unused. MN-major operands (rows of 128 bytes along M or N, one
// row per k): lbo = the stride between 64-element MN blocks, sbo = the
// stride between groups of 8 k-rows. The swizzle pattern repeats every
// 1024 bytes, so tiles start 1024-aligned and a k-step moves the start
// address inside the pattern (+32 bytes along a K-major row).
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(smem) & 0x3FFFFu) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
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

// Keeps the compiler from moving accumulator registers across the
// asynchronous wgmma issue and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// fp32 -> tf32 rounded to nearest (the low 13 bits cleared).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Accumulator layout of an m64nN fp32 wgmma, per thread of the warpgroup:
// d[4j + 2h + e] holds row 16 * warp + lane / 4 + 8 * h, column
// 8 * j + 2 * (lane % 4) + e.
//
// C[64 x 256] += A[64 x 16] . B[16 x 256], bf16, A K-major from shared
// memory, B MN-major (N contiguous) from shared memory.
__device__ __forceinline__ void wgmma_m64n256k16_bf16_tb(float (&d)[128],
                                                         uint64_t desc_a,
                                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// C[64 x 64] += A[64 x 8] . B[8 x 64], tf32, A from registers (the
// m16n8k8 tf32 fragment of each warp's 16 rows), B K-major from shared
// memory.
__device__ __forceinline__ void wgmma_m64n64k8_tf32_ra(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// C[64 x 64] += A[64 x 16] . B[16 x 64], bf16, both K-major from shared
// memory.
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32],
                                                     uint64_t desc_a,
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// bf16 A operand from registers: each warp's 16 rows as the m16n8k16 A
// fragment, a[0] = (row lane / 4, columns 2 * (lane % 4) + 0, 1), a[1] the
// same columns 8 rows down, a[2] / a[3] those rows at columns + 8 (low half
// = lower column). For a 16-column slice of an fp32 accumulator that is
// a[0] = d[8i + 0, 1], a[1] = d[8i + 2, 3], a[2] = d[8i + 4, 5],
// a[3] = d[8i + 6, 7], rounded to bf16 pairs. TRANS_B 0: B K-major from
// shared memory; 1: B MN-major (N contiguous).
//
// C[64 x 64] += A[64 x 16] . B[16 x 64].
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_bf16_ra(float (&d)[32],
                                                        const uint32_t (&a)[4],
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// C[64 x 16] += A[64 x 16] . B[16 x 16], A from registers as above.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n16k16_bf16_ra(float (&d)[8],
                                                        const uint32_t (&a)[4],
                                                        uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "%14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// C[64 x 128] += A[64 x 16] . B[16 x 128], A from registers as above.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_bf16_ra(float (&d)[64],
                                                         const uint32_t (&a)[4],
                                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// Keeps the compiler from reusing registers that an asynchronous wgmma may
// still be reading (A fragments) before its wait.
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (outer x inner) matrix at `base` with `row_bytes` between
// rows, cut into boxes of (box_outer x box_inner) elements, 128-byte
// swizzle (box_inner * element size must be 128), zero fill out of bounds.
// Returns 0 or a cudaError_t.
inline int make_map_2d(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, uint64_t inner, uint64_t outer,
                       uint64_t row_bytes, uint32_t box_inner,
                       uint32_t box_outer) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
                  elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A 4-D tensor at `base`: dims[0] contiguous, strides (bytes, multiples of
// 16) of dims 1..3, boxes of box[0..3] elements (box[0] * element size must
// be 128), 128-byte swizzle, zero fill out of bounds (each dimension is
// bounded on its own, so a box that runs past the end of one dimension
// reads zeros, never the next slice's elements).
inline int make_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                       const void* base, const uint64_t (&dims)[4],
                       const uint64_t (&stride_bytes)[3],
                       const uint32_t (&box)[4]) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t s[3] = {stride_bytes[0], stride_bytes[1], stride_bytes[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = fn(map, type, 4, const_cast<void*>(base), d, s, bx, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A bf16 (batch, head, row, dk) tensor addressed through (batch, head, row)
// strides in elements, dk contiguous (q, k, v or g of the attention
// kernels), as a 4-D map of 64 x 64 boxes with the rows and heads
// dimensions in ascending stride order; *rows_inner says which comes first.
inline int qkv_map(CUtensorMap* map, const void* base, int dk, int L, int H,
                   int B, long long sb, long long sh, long long sl,
                   int* rows_inner) {
  const bool ri = sl <= sh;
  *rows_inner = ri;
  const uint64_t dims[4] = {static_cast<uint64_t>(dk),
                            static_cast<uint64_t>(ri ? L : H),
                            static_cast<uint64_t>(ri ? H : L),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(ri ? sl : sh) * 2,
                               static_cast<uint64_t>(ri ? sh : sl) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {64, ri ? 64u : 1u, ri ? 1u : 64u, 1};
  return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims,
                     strides, box);
}

// The (H, Lq, Lk) fp32 position bias as a (Lk, Lq, H) map of 32 x 64 boxes
// (a 64 x 64 tile is two boxes, 8 KB apart). Its rows must be 16-byte
// multiples: returns -1 (no map) where they are not, else 0 or an error.
inline int pos_map(CUtensorMap* map, const void* pos, int H, int Lq, int Lk) {
  if (Lk % 4 != 0 || reinterpret_cast<uintptr_t>(pos) % 16 != 0) return -1;
  const uint64_t row = static_cast<uint64_t>(Lk) * 4;
  const uint64_t dims[4] = {static_cast<uint64_t>(Lk),
                            static_cast<uint64_t>(Lq),
                            static_cast<uint64_t>(H), 1};
  const uint64_t strides[3] = {row, row * Lq, row * Lq * H};
  const uint32_t box[4] = {32, 64, 1, 1};
  return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, pos, dims, strides,
                     box);
}

// One 64-row tile of a qkv_map tensor: DK / 64 boxes of 64 x 64 (8 KB
// each) at `dst`, completing on `bar`.
template <int DK>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const CUtensorMap* map,
                                          bool rows_inner, uint64_t* bar,
                                          int row, int h, int b) {
#pragma unroll
  for (int c = 0; c < DK / 64; ++c) {
    if (rows_inner)
      tma_load_4d(dst + c * 8192, map, bar, 64 * c, row, h, b);
    else
      tma_load_4d(dst + c * 8192, map, bar, 64 * c, h, row, b);
  }
}

// Streaming multiprocessors of the current device (the persistent grids).
inline int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess || n <= 0)
    n = 132;
  return n;
}

}  // namespace hopper
