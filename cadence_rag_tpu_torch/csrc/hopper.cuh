// Hopper building blocks shared by the scan kernels (fused_scan.cu, K1, and
// dense_scan.cu, K2): mbarriers, cp.async and TMA copies, wgmma with the A
// operand from registers (rs) or shared memory (ss), the 64- and
// 128-byte-swizzle shared-memory descriptors, and the host-side TMA
// descriptor of a query slab. Every function sits in an anonymous namespace: each kernel source
// includes its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKS = 32;                           // K elements per ring stage

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and asynchronous copies ----------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one warp's release of a barrier counted in warps
__device__ __forceinline__ void warp_arrive(uint32_t bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// hold `bar`'s phase until this thread's earlier cp.async copies have
// landed, without counting as one of its arrivals
__device__ __forceinline__ void cp_async_hold(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// a 3-d TMA box global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar)
      : "memory");
}

// a 4-d TMA box global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
         "r"(bar)
      : "memory");
}

// a 2-d TMA box global -> shared, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// -- wgmma --------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(kPending) : "memory");
}
// keeps the compiler from reusing or reading registers that an asynchronous
// wgmma still reads or writes
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

// shared-memory descriptor of a K-major operand in the 64-byte swizzle:
// 64-byte rows, 8-row atoms of 512 bytes (SBO); LBO is unused
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(512 >> 4) << 32)
         | (static_cast<uint64_t>(2) << 62);
}

// the same in the 128-byte swizzle: 128-byte rows, 8-row atoms of 1024 bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

// The accumulator operands of one wgmma: CK_DREGS_n the placeholders of
// operands [n, n + 32), CK_Dn(i) the f32 outputs d[i .. i + n).
#define CK_DREGS_0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define CK_DREGS_32 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define CK_DREGS_64 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define CK_DREGS_96 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define CK_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define CK_D32(i) CK_D8(i), CK_D8(i + 8), CK_D8(i + 16), CK_D8(i + 24)
#define CK_D64(i) CK_D32(i), CK_D32(i + 32)
#define CK_D128(i) CK_D64(i), CK_D64(i + 64)

// D(64 x N, f32) (+)= A(64 x 16, registers) * B(16 x N, shared, K-major), A
// and B both of type TY ("bf16" or "f16"); scale_d == 0 overwrites D. AB
// names the operands of A's registers and B's descriptor, SCALE scale_d's.
#define CK_WGMMA_RS(N, TY, DREGS, AB, SCALE, DOPS)                                   \
  asm volatile("{\n.reg .pred p;\n"                                                   \
               "setp.ne.b32 p, " SCALE ", 0;\n"                                       \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "         \
               "{" DREGS "}, " AB ", p, 1, 1, 0;\n}\n"                                 \
               : DOPS                                                                 \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)  \
               : "memory")

// the register-A product in bf16, or with kF16 in fp16. One overload per N
// (64, 128, 256).
template <bool kF16 = false>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  if constexpr (kF16) {
    CK_WGMMA_RS(64, "f16", CK_DREGS_0, "{%32, %33, %34, %35}, %36", "%37", CK_D32(0));
  } else {
    CK_WGMMA_RS(64, "bf16", CK_DREGS_0, "{%32, %33, %34, %35}, %36", "%37", CK_D32(0));
  }
}

template <bool kF16 = false>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  if constexpr (kF16) {
    CK_WGMMA_RS(128, "f16", CK_DREGS_0 ", " CK_DREGS_32, "{%64, %65, %66, %67}, %68",
                "%69", CK_D64(0));
  } else {
    CK_WGMMA_RS(128, "bf16", CK_DREGS_0 ", " CK_DREGS_32, "{%64, %65, %66, %67}, %68",
                "%69", CK_D64(0));
  }
}

template <bool kF16 = false>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  if constexpr (kF16) {
    CK_WGMMA_RS(256, "f16", CK_DREGS_0 ", " CK_DREGS_32 ", " CK_DREGS_64 ", " CK_DREGS_96,
                "{%128, %129, %130, %131}, %132", "%133", CK_D128(0));
  } else {
    CK_WGMMA_RS(256, "bf16", CK_DREGS_0 ", " CK_DREGS_32 ", " CK_DREGS_64 ", " CK_DREGS_96,
                "{%128, %129, %130, %131}, %132", "%133", CK_D128(0));
  }
}

// D(64 x N, f32) (+)= A(64 x 16, bf16 shared, K-major) * B(16 x N, bf16
// shared, K-major), both by shared-memory descriptors; scale_d == 0
// overwrites D. One overload per N (64, 128).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a_desc, uint64_t b_desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a_desc, uint64_t b_desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d)
      : "memory");
}

// -- host side ------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime so
// that nothing links libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (pieces, batch, k_dim) 16-bit queries (`type` bf16 or fp16); box (32 K,
// n_box queries, one piece), 64-byte swizzle, queries past batch read as
// zeros
bool encode_queries(CUtensorMap* map, const void* q, int pieces, int batch, int k_dim,
                    int n_box, CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k_dim), static_cast<cuuint64_t>(batch),
                              static_cast<cuuint64_t>(pieces)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k_dim) * 2,
                                 static_cast<cuuint64_t>(batch) * k_dim * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kKS), static_cast<cuuint32_t>(n_box), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3, const_cast<void*>(q),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
