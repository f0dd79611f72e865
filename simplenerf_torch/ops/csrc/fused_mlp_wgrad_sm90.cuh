// Weight pass of the bf16 fused-MLP backward for Hopper (sm_90a): the
// device code of fused_mlp_bwd_wgrad_kernel in fused_mlp_bwd.cu, the part
// of the CUDA counterpart of simplenerf_tpu/ops/fused_mlp.py `_bwd_kernel`
// and `_ens_bwd_kernel` that sums every dW over the rows (the TPU kernels
// carry those sums in VMEM across grid steps). The row pass, the float32
// weight pass and the forward's engine do not use it.
//
// It forms every dW = round(h_prev)^T @ round(g) of the backward program
// from two slots of the stash that the row pass wrote to device memory
// (slot = an (n_rows, width) row-major bf16 array), summed over one chunk
// of stash rows into a float32 partials row per chunk; the column sums then
// add the chunks in order. What bounds it is bytes: for the published fine
// MLP the slots it reads hold 7.55 GB at the training step, ~2.3 ms at
// 3.35 TB/s, against ~0.9 ms of its FLOP at the bf16 peak. So the design
// reads each slot from device memory about once per launch:
//   * a task is a panel of one dW: up to 128 dW rows (two consumer
//     warpgroups x 64 rows, the k_in dimension, i.e. 64-column strips of A)
//     by the whole n_out (<= 256), over one chunk; a consumer keeps its
//     64 x N float32 sum in registers (N / 2 a thread, 128 at N = 256);
//   * the operands arrive by TMA (cp.async.bulk.tensor.2d, one tensor map
//     per stash slot, encoded on the host) as 64-row x 64-column boxes in
//     the 128-byte swizzle, into a ring of kStages stages with full/empty
//     mbarriers; rows past n_rows come back as zeros (the map's dims are
//     (width, n_rows)), so the ragged tail needs no masking;
//   * the products are wgmma.mma_async m64nNk16 with both operands
//     MN-major (imm-trans-a = imm-trans-b = 1): in A^T G the sum runs over
//     stash rows, so A (M = dW rows) and G (N = dW columns) both lie in
//     shared memory with M / N contiguous. A stage's four k16 steps (16
//     rows, 2 KB on in every box) are issued back to back, one group stays
//     in flight, and the slot of the stage before is released;
//   * each panel loads its own boxes. The two 128-row panels of a 256-row
//     dW read the same G over the same chunk; they run as one cluster of
//     two CTAs, which the hardware starts together on one GPC, so they
//     stream G in step and L2 serves the second read. The cluster only
//     schedules: its CTAs share no memory and no barrier. (Without it the
//     pass ran 8-14 % slower; multicasting G within it issues 3.4 GB less
//     per launch at the same speed: PERF.md.) So every slot is read from
//     device memory about once; the producers issue the lo slot (64
//     columns) once per dW that reads it and a G once per 128-row panel of
//     each dW on it (PERF.md counts the bytes).
//
// Block: 288 threads. Warpgroups 0 and 1 (warps 0-7) consume; warp 8
// produces (one thread issues the copies). With one producer warp instead
// of a warpgroup every thread may hold 224 registers (65,536 / 288), so a
// consumer's 128 float32 sums need no setmaxnreg (a 384-thread block is
// held to 168 a thread). Shared memory: kStages x 48 KB (two A boxes, four
// G boxes, 8 KB each) from a 1024-aligned base, then the barriers: 196,672
// bytes of the 232,448 a block can use (ops/fused_mlp.py `_WGRAD_SMEM`).
// The tensor maps are a __grid_constant__ kernel parameter (up to kMaxMaps
// of them, 16 KB: CUDA 12.1 allows 32,764 bytes of parameters), so a
// launch copies nothing from the host. Built with -DSNERF_WGRAD_WATCHDOG
// (tools/probe_fused_mlp_bwd.py's variants), a wait that lasts
// kTimeoutCycles traps, so a broken protocol ends the launch with an error
// instead of hanging the card.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgrad {

constexpr int kThreads = 288;          // two consumer warpgroups, then the producer warp
constexpr int kProducerWarp = 8;
constexpr int kBox = 64;                      // rows and columns of a TMA box
constexpr int kBoxBytes = kBox * kBox * 2;    // 8 KB
constexpr int kMaxA = 2, kMaxG = 4;
constexpr int kGBox = kMaxA;                   // box slots of a stage: A0 A1 G0 .. G3
constexpr int kStageBytes = (kMaxA + kMaxG) * kBoxBytes;
constexpr int kStages = 4;
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8;
constexpr int kMaxMaps = 128;
#ifdef SNERF_WGRAD_WATCHDOG
constexpr long long kTimeoutCycles = 1ll << 32;  // ~2 s: no wait of a sound launch comes near
#endif

// One CTA's task (9 ints; built by ops/fused_mlp.py `_wgrad_plan`).
struct Job {
  int chunk;             // stash rows [chunk * chunk_rows, +chunk_rows)
  int a_map, i0, n_a;    // A: n_a boxes of columns i0, i0 + 64 of map a_map (the panel's dW rows)
  int g_map, n_g;        // G: n_g boxes of columns 0, 64, .. of map g_map
  int dw_off, k_in, n_out;  // the dW (k_in, n_out) at dw_off of a partials row
};
constexpr int kJobWords = 9;
static_assert(sizeof(Job) == kJobWords * sizeof(int), "Job layout");

// One tensor map per stash slot the jobs read (encoded on the host).
struct Maps {
  CUtensorMap map[kMaxMaps];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
#ifdef SNERF_WGRAD_WATCHDOG
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kTimeoutCycles) __trap();
#else
  while (!mbar_try(bar, parity)) {
  }
#endif
}
// One 64 x 64 box (columns c0.., rows r0..) of `map` into this CTA's shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int r0,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma, both operands MN-major ----

// Descriptor of an MN-major operand in the 128-byte swizzle, as TMA leaves
// a box: each K row is 128 bytes of 64 MN-contiguous values, 8-row groups
// 1024 bytes apart (the stride byte offset, SBO), and the next 64 MN values
// (the next box) 8 KB on (the leading byte offset, LBO): the canonical
// MN-major B128 layout ((8,8,m),(8,k)):((1,8,LBO),(64,SBO)) in elements of
// the PTX ISA's matrix-descriptor tables. The next k16 step is 16 rows on:
// 2 KB, the start address field + 128.
constexpr uint64_t kLbo = kBoxBytes >> 4, kSbo = 1024 >> 4;
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (kLbo << 16) | (kSbo << 32) | (1ull << 62);
}
constexpr uint64_t kK16Step = 2048 >> 4;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int M> __device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] @ B[16 x N]; scale_d 0 overwrites d. Accumulator
// layout: thread (warp w, lane l) holds rows 16w + l/4 and 16w + l/4 + 8,
// columns 8j + 2(l%4) and + 1 of each n8 tile j, as d[4j .. 4j+3].
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_n192(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void mma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N> struct Mma;
template <> struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int s) { mma_n64(d, a, b, s); }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int s) { mma_n128(d, a, b, s); }
};
template <> struct Mma<192> {
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t a, uint64_t b, int s) { mma_n192(d, a, b, s); }
};
template <> struct Mma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b, int s) { mma_n256(d, a, b, s); }
};

// ---- the producer ----

// One stage's boxes (rows row.. of the chunk) into stage `st`, completing
// on `bar`: the panel's A strip, then G.
__device__ __forceinline__ void load_stage(const Job& j, unsigned char* st, const CUtensorMap* am,
                                           const CUtensorMap* gm, int row, uint64_t* bar) {
  for (int b = 0; b < j.n_a; ++b) tma_load(st + b * kBoxBytes, am, j.i0 + b * kBox, row, bar);
  for (int b = 0; b < j.n_g; ++b) tma_load(st + (kGBox + b) * kBoxBytes, gm, b * kBox, row, bar);
}

// One thread: every stage's boxes into the ring, once both consumers have
// released the stage.
__device__ __forceinline__ void produce(const Job& j, const Maps& maps, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int r_begin,
                                        int n_stages) {
  const CUtensorMap* am = &maps.map[j.a_map];
  const CUtensorMap* gm = &maps.map[j.g_map];
  const uint32_t bytes = (j.n_a + j.n_g) * kBoxBytes;
  int s = 0, phase = 0;
  for (int k = 0; k < n_stages; ++k) {
    mbar_wait(empty + s, phase ^ 1);
    unsigned char* st = ring + s * kStageBytes;
    mbar_expect_tx(full + s, bytes);
    load_stage(j, st, am, gm, r_begin + k * kBox, full + s);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// ---- the consumers ----

// Release a stage: one arrival of this warpgroup on its empty barrier.
__device__ __forceinline__ void release(uint64_t* bar, int t) {
  if (t == 0) mbar_arrive(bar);
}

// 64 rows x N columns of float32 sums into a chunk's partials row: dW row
// row0 + r, column col0 + c, rows < k_in and columns < n_out.
template <int N>
__device__ __forceinline__ void store_sums(const float (&acc)[N / 2], float* __restrict__ out,
                                           int row0, int col0, int k_in, int n_out, int t) {
  const int warp = t >> 5, lane = t & 31;
  const int r0 = row0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane & 3);
    if (col >= n_out) continue;  // n_out is even: col + 1 < n_out too
    if (r0 < k_in)
      *reinterpret_cast<float2*>(out + (size_t)r0 * n_out + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r1 < k_in)
      *reinterpret_cast<float2*>(out + (size_t)r1 * n_out + col) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// One consumer warpgroup: its A box `ab` against G boxes gb0 .. gb0 + N/64
// over every stage.
template <int N>
__device__ __forceinline__ void consume(const Job& j, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int n_stages, int ab, int gb0,
                                        float* __restrict__ out, int t) {
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int s = 0, phase = 0, prev = -1;
  for (int k = 0; k < n_stages; ++k) {
    mbar_wait(full + s, phase);
    const unsigned char* st = ring + s * kStageBytes;
    const uint64_t da = desc_mn(st + ab * kBoxBytes);
    const uint64_t db = desc_mn(st + (kGBox + gb0) * kBoxBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Mma<N>::run(acc, da + kk * kK16Step, db + kk * kK16Step, 1);
    wgmma_commit();
    wgmma_wait<1>();  // the group before this one has read its stage: release it
    if (prev >= 0) release(empty + prev, t);
    prev = s;
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0) release(empty + prev, t);
  store_sums<N>(acc, out + j.dw_off, j.i0 + ab * kBox, gb0 * kBox, j.k_in, j.n_out, t);
}

// A consumer with no boxes of its own (a 64-row panel whose G is one box):
// it releases every stage all the same, so the empty barriers' counts hold.
__device__ __forceinline__ void consume_idle(uint64_t* full, uint64_t* empty, int n_stages, int t) {
  int s = 0, phase = 0;
  for (int k = 0; k < n_stages; ++k) {
    mbar_wait(full + s, phase);
    release(empty + s, t);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

__device__ __forceinline__ void consume_n(int n, const Job& j, unsigned char* ring, uint64_t* full,
                                          uint64_t* empty, int n_stages, int ab, int gb0,
                                          float* out, int t) {
  if (n == 4)
    consume<256>(j, ring, full, empty, n_stages, ab, gb0, out, t);
  else if (n == 3)
    consume<192>(j, ring, full, empty, n_stages, ab, gb0, out, t);
  else if (n == 2)
    consume<128>(j, ring, full, empty, n_stages, ab, gb0, out, t);
  else
    consume<64>(j, ring, full, empty, n_stages, ab, gb0, out, t);
}

// The weight pass. Grid: one CTA per job, in clusters of two consecutive
// jobs; a CTA past the last job (an odd count's pad) has nothing to do.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
fused_mlp_bwd_wgrad_kernel(const Job* __restrict__ jobs, int n_jobs,
                           const __grid_constant__ Maps maps, int n_rows, int chunk_rows,
                           int dw_total, float* __restrict__ dw_part) {
  if (static_cast<int>(blockIdx.x) >= n_jobs) return;
  extern __shared__ __align__(1024) unsigned char wgrad_smem[];
  if (smem_u32(wgrad_smem) & 1023) __trap();  // the swizzle needs 1024-byte aligned boxes
  unsigned char* ring = wgrad_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const Job j = jobs[blockIdx.x];
  const int r_begin = j.chunk * chunk_rows;
  const int r_end = min(n_rows, r_begin + chunk_rows);
  const int n_stages = r_end > r_begin ? (r_end - r_begin + kBox - 1) / kBox : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);   // the producer's expect_tx arrival
      mbar_init(empty + s, 2);  // each consumer warpgroup's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before any copy or wait
  const int c = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x / 32 == kProducerWarp) {
    if (threadIdx.x % 32 == 0 && n_stages > 0)
      produce(j, maps, ring, full, empty, r_begin, n_stages);
  } else if (n_stages > 0) {
    float* out = dw_part + (size_t)j.chunk * dw_total;
    // Consumer c's boxes: a 128-row panel gives each consumer one A box and
    // all of G; a 64-row panel gives both the one A box and half of G each.
    int ab = c, gb0 = 0, gn = j.n_g;
    if (j.n_a == 1) {
      const int h = (j.n_g + 1) / 2;
      ab = 0;
      gb0 = c ? h : 0;
      gn = c ? j.n_g - h : h;
    }
    if (gn == 0)
      consume_idle(full, empty, n_stages, t);
    else
      consume_n(gn, j, ring, full, empty, n_stages, ab, gb0, out, t);
  }
}

}  // namespace wgrad
