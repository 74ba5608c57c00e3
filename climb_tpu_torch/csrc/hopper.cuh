// Hopper (sm_90a) building blocks of the bf16 GEMM in gemm.cuh, the FFN
// backward's recompute (mlp_bwd.cu) and the bf16 attention forward
// (attention.cu) and backward (attention_bwd.cu):
// mbarriers and the full/empty ring of streamed tiles, TMA tile loads
// described by a CUtensorMap, warpgroup MMA (wgmma) with its shared-memory
// descriptors and fences, the register handoff between warpgroups
// (setmaxnreg) and named barriers, as PTX; the quad reductions and the ex2
// of the online softmax. Host side: encoding tensor maps for a K-major bf16
// operand and for a strided (B, S, H, 64) bf16 tensor.
//
// Layout contract (PTX ISA, "Asynchronous Warpgroup Level Matrix Shared
// Memory Layout"): a TMA box of 64 bf16 (128 bytes) by R rows, loaded with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned tile, is the K-major
// 128-byte-swizzled layout that a wgmma descriptor with layout type 1 reads:
// rows 128 bytes apart, 8-row groups 1024 bytes apart (the descriptor's
// stride byte offset). The k-th 16-deep slice of the box starts 32 * k bytes
// into the tile; the hardware applies the swizzle to that address: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8) of that row.
//
// The same tile read as an MN-major operand (wgmma's transposed B): a 64 x 64
// bf16 tile whose rows are the reduction axis K and whose 128-byte rows run
// along N is the MN-major 128-byte-swizzled layout ((8, 8), (8, k)) :
// ((1, 8), (64, SBO)) in elements: eight rows of K 128 bytes apart, 8-row
// groups 1024 bytes apart (SBO), and N = 64 in one swizzle atom. The leading
// byte offset is the stride between 64-wide N blocks: unused at N = 64; at N =
// 128 two such tiles 8192 bytes apart (wgmma_m64n128k16_mn). The k-th
// 16-deep slice starts 16 rows, 2048 bytes, into the tile.
//
// The accumulator of wgmma m64nNk16 with f32 D, for thread t of the
// warpgroup with w = t / 32, l = t % 32: d[4j + 2h + e] holds
// D[16w + l/4 + 8h][8j + 2(l%4) + e] for h, e in {0, 1}; a row's values sit
// in the four lanes of one quad (quad_max, quad_sum). An A operand taken
// from registers (m64k16, bf16) has four 32-bit registers of two bf16 each:
// a0 = A[16w + l/4][2(l%4) + {0, 1}], a1 the same 8 rows down, a2 and a3 the
// same 8 columns on. So the accumulator's columns 16kk .. 16kk + 15 rounded
// to bf16 pairs are the A operand of k-slice kk of the next product: a =
// {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], d[8kk+5]},
// {d[8kk+6], d[8kk+7]} (a_from_acc).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace climb {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory from its first 1024-byte boundary (the 128-byte
// swizzle's period): a generic pointer, and the shared-space address in `addr`
__device__ __forceinline__ unsigned char* aligned_smem(unsigned& addr) {
  extern __shared__ unsigned char hopper_smem[];
  const unsigned raw = smem_u32(hopper_smem);
  addr = (raw + 1023u) & ~1023u;
  return hopper_smem + (addr - raw);
}

// max and sum over the four lanes of a quad (one row of an accumulator)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scores kept in log2 units (s * scale * log2 e + bias * log2 e), so that
// exp(s - m) is one ex2 of the SFU: what __expf computes after scaling its
// argument by log2 e.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// makes the initialized barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive and expect `bytes` more from copies that complete_tx on this barrier
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The barriers of a ring of STAGES streamed stages from shared-space address
// `at`: full and empty per stage, and one for the tiles a block loads once.
// full: the producer warp's 32 lanes arrive (lane 0's arrival carries the
// stage's TMA bytes); empty: one arrival per consumer warp that works.
template <int STAGES>
struct RingBarriers {
  unsigned full, empty, ready;
  __device__ explicit RingBarriers(unsigned at) {
    full = at;
    empty = full + 8 * STAGES;
    ready = empty + 8 * STAGES;
  }
  static constexpr unsigned kBytes = (2 * STAGES + 1) * 8;
  __device__ void init(int working_wgs) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, 4 * working_wgs);
    }
    mbar_init(ready, 1);
    mbar_init_fence();
  }
  // a consumer warp is done with stage s (its wgmma groups have completed and
  // its lanes have read the stage's values)
  __device__ void release(int s, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
};

// barrier `id` (1-15; 0 is __syncthreads's) over the `count` threads that use it
__device__ __forceinline__ void bar_sync_named(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- TMA ----------------------------------------------------------------------

// the box of `map` at element coordinates (c0 along the contiguous axis, c1
// along rows) into shared memory at `dst`; completes bytes on `bar`.
// Elements outside the tensor are zero-filled and still counted.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the box of a 4-D `map` at element coordinates (c0 innermost .. c3) into
// shared memory at `dst`; completes bytes on `bar`. Out-of-bounds elements as
// tma_load_2d.
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, unsigned bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------------

// descriptor of a K-major, 128-byte-swizzled operand tile starting at `addr`
// (shared-space byte address): start >> 4 in bits 0-13, leading byte offset
// 16 (unused by swizzled K-major layouts) in 16-29, stride byte offset 1024
// in 32-45, base offset 0, layout type 1 (128-byte swizzle) in 62-63
__device__ __forceinline__ unsigned long long sw128_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<unsigned long long>(1024 >> 4) << 32) | (1ull << 62);
}

// descriptor of an MN-major, 128-byte-swizzled operand tile starting at
// `addr` (the layout above): leading byte offset 8192 (the next 64-wide N
// block, unused at N = 64),
// stride byte offset 1024, layout type 1; read with the transpose bit set
__device__ __forceinline__ unsigned long long sw128_mn_desc(unsigned addr) {
  return static_cast<unsigned long long>((addr & 0x3FFFF) >> 4) | ((8192ull >> 4) << 16) |
         (static_cast<unsigned long long>(1024 >> 4) << 32) | (1ull << 62);
}

// keeps the compiler from moving other reads or writes of a wgmma
// accumulator across this point: around the wgmma instructions that use it
__device__ __forceinline__ void fence_operand(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// hand registers between the warpgroups of a block (the counts are per
// thread); all four warps of a warpgroup must exist and execute it: a block
// whose last warpgroup is one lone warp hangs there
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32) += A (64 x 16) . B (128 x 16)^T, both bf16 and K-major in
// shared memory, by the whole warpgroup
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], unsigned long long a,
                                                 unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, bf16, K-major in shared memory) . B (16 x
// 128, bf16, MN-major in shared memory: two 64-wide N blocks of the layout
// above, 8192 bytes apart, read by sw128_mn_desc), by the whole warpgroup
__device__ __forceinline__ void wgmma_m64n128k16_mn(float (&d)[64], unsigned long long a,
                                                    unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

#define CLIMB_WGMMA_D32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), \
  "+f"(d[31])
#define CLIMB_WGMMA_D32_OUT \
  "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), \
  "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), \
  "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), \
  "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), \
  "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), \
  "=f"(d[31])

// d (64 x 64, f32) = A (64 x 16) . B (64 x 16)^T, both bf16 and K-major in
// shared memory, by the whole warpgroup; d's earlier values are not read (so
// no other instruction that wrote them is tied to this one)
__device__ __forceinline__ void wgmma_m64n64k16_ss_first(float (&d)[32], unsigned long long a,
                                                         unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : CLIMB_WGMMA_D32_OUT
      : "l"(a), "l"(b), "r"(0));
}

// d (64 x 64, f32) += A (64 x 16) . B (64 x 16)^T, both bf16 and K-major in
// shared memory, by the whole warpgroup
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], unsigned long long a,
                                                   unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : CLIMB_WGMMA_D32
      : "l"(a), "l"(b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16, from registers in the layout above) .
// B (16 x 64, bf16, MN-major in shared memory: sw128_mn_desc), by the whole
// warpgroup. A's registers must not change until the group has completed.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const unsigned (&a)[4],
                                                   unsigned long long b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : CLIMB_WGMMA_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef CLIMB_WGMMA_D32
#undef CLIMB_WGMMA_D32_OUT

// the A operand of k-slice kk (accumulator columns 16kk .. 16kk + 15) of a
// 64 x 64 f32 accumulator, rounded to bf16 pairs (the layouts above)
__device__ __forceinline__ void a_from_acc(unsigned (&a)[4], const float (&d)[32], int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    __nv_bfloat162 v = __floats2bfloat162_rn(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
    a[r] = *reinterpret_cast<unsigned*>(&v);
  }
}

// ---- host: tensor maps --------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point so
// that the library needs no link against libcuda
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// map of a row-major (rows, K) bf16 operand, contiguous along K, read in
// boxes of box_k x box_rows with 128-byte swizzle; out-of-bounds rows read as
// zeros. Needs a 16-byte aligned base and K % 8 == 0; returns a cudaError_t.
inline int encode_kmajor_bf16(CUtensorMap* map, const void* base, int rows, int K, int box_k,
                              int box_rows) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_k), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// map of a (B, S, H, 64) bf16 tensor with element strides st = {B, S, H} and
// a contiguous last axis, read in boxes of 64 rows of S for one (b, h) with
// 128-byte swizzle (dims {64, H, S, B}): rows past S within each batch read
// as zeros. Needs a 16-byte aligned base and strides in multiples of 8
// elements; returns a cudaError_t.
inline int encode_bshd_bf16(CUtensorMap* map, const void* base, int B, int S, int H,
                            const long long* st) {
  EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {64, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * sizeof(__nv_bfloat16),
                                 static_cast<cuuint64_t>(st[1]) * sizeof(__nv_bfloat16),
                                 static_cast<cuuint64_t>(st[0]) * sizeof(__nv_bfloat16)};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace climb
