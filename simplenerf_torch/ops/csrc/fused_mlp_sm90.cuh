// Warp-specialised engine of the bf16 fused MLP forward for Hopper (sm_90a):
// the device code of fused_mlp_fwd_sm90_kernel in fused_mlp_fwd.cu. The
// float32 forward runs the same engine on the 3xTF32 core of
// fused_mlp_tf32_sm90.cuh; the backward's row passes are built on it too.
//
// A block of 384 threads owns 128 rows: warpgroup 0 produces, warpgroups 1
// and 2 consume, 64 rows each. The producer gives up registers
// (setmaxnreg 40) and one of its threads streams the weights: every layer's
// transposed weight W^T (n_pad, K) is stored by ops/fused_mlp.py as the
// shared-memory image of its 64-deep K-slabs (128 bytes per row, 16-byte
// chunk c of row r at chunk c ^ (r % 8): the 128-byte swizzle; N padded
// with zero rows to 64, 128 or 256), so one cp.async.bulk copies a slab
// (at most 32 KB) into a ring of `stages` slots with full/empty mbarriers,
// with no tensor map. The ring runs on across layers and ensemble members.
//
// A consumer (setmaxnreg 232) keeps its 64 rows of the lo (and hi) input
// and one activation tile in shared memory, all in the same swizzled
// K-block layout, and runs every product as wgmma.mma_async
// m64nNk16.f32.bf16.bf16 with A (its tile) and B (the slab) read through
// 128-byte-swizzle descriptors: a slab's four k16 steps are issued back to
// back and committed as one group, and one group stays in flight, so the
// wait for slab i - 1 overlaps slab i; the slot of slab i - 1 is then
// released (one arrival per consumer). A skip join or a views-branch extra
// input is one more segment whose A descriptor points at the lo (hi) tile.
// Each layer starts cp.async copies of its bias and, in the hvx layer, of
// the hvx rows of the consumer's rays into the consumer's staging area
// before its products, so the epilogue reads them from shared memory. The
// epilogue works on the accumulators in registers, in passes that each
// test the layer's kind once (hvx; bias, ReLU, bf16 rounding and the store
// of the consumer's 64 rows into the swizzled activation tile; the head):
// a test inside the unrolled loop over the accumulators cost every layer
// (PERF.md). The head is folded into the layer it reads: each thread's
// float32 dot products of its rounded values with the head weights (staged
// in shared memory once per block by the producer's first bulk copy), two
// xor-shuffles over the quad of lanes that holds a row, one lane's store.
// Then fence.proxy.async and a 128-thread named barrier let the next
// layer's wgmma read the tile. The layer chain has no block-wide barrier;
// the two consumers meet only at the slab ring, which, as both read every
// slab, keeps them close to lockstep.
//
// Shared memory (bytes, from a 1024-aligned base; `sm90_plan` in
// ops/fused_mlp.py computes the same): the ring, stages x slot (slot = the
// widest layer's n_pad x 128, 32 KB at width 256, 4 stages where they fit,
// else 3); per consumer an activation tile of act_kb x 8 KB (64 x 256 bf16
// = 32 KB), a lo tile of lo_kb x 8 KB and a hi tile of hi_kb x 8 KB; the
// head weights; per consumer a staging area of the layer's bias (1 KB) and
// the hvx rows of up to hvx_rays rays; 9 mbarriers. The published fine MLP
// at 64 or 192 samples per ray: 128 + 2 x 40 + 2.5 + 2 x 2 KB = 214.6 KB of
// the 227 KB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kThreads = 384;                 // warpgroup 0 produces, 1 and 2 consume
constexpr int kRows = 64;                     // rows of one consumer warpgroup
constexpr int kBM = 2 * kRows;                // rows of a block
constexpr int kBlockBytes = kRows * 128;      // one 64-deep K block of a consumer's tile
constexpr int kMaxOps = 40;
constexpr int kMaxSeg = 3;
constexpr int kMaxStages = 4;
constexpr int kMaxHead = 4;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

enum { SRC_ACT = 0, SRC_LO = 1, SRC_HI = 2 };
enum { FLAG_RELU = 1, FLAG_HVX = 2 };

// One layer (16 ints; built by ops/fused_mlp.py `pack_program`):
// act = f(sum_s src[s] @ W_s + bias [+ hvx[hvx_slot]]), n real columns of
// n_pad computed, kb[s] 64-deep slabs per segment; with head_nout > 0 the
// head out[head_plane + o][row] = sum_k act[row][k] * heads[head_w + o * n_pad + k]
// + fpar[head_b + o] is folded into its epilogue.
struct Op {
  int n, n_pad, b_off, flags, nseg;
  int src[kMaxSeg];
  int kb[kMaxSeg];
  int hvx_slot, head_plane, head_nout, head_w, head_b;
};

// hvx_rays > 0: an hvx layer stages the hvx rows of its consumer's rays
// (at most hvx_rays) beside the bias; 0: the epilogue reads hvx from global
// memory. cst_floats: one consumer's staging area (bias, then hvx rows).
struct Program {
  int n_ops, n_rows, ns, in_lo, in_hi, lo_kb, hi_kb, act_kb, slot_bytes, stages, head_floats,
      hvx_rays, cst_floats, reserved;
  Op ops[kMaxOps];
};

constexpr int kHeaderWords = 14;
constexpr int kBiasFloats = 256;  // a layer's bias at the head of the staging area
static_assert(sizeof(Op) == 16 * sizeof(int), "Op layout");
static_assert(sizeof(Program) == (kHeaderWords + 16 * kMaxOps) * sizeof(int), "Program layout");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and bulk copies ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ---- wgmma ----

// Descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart (SBO), layout type 1 (B128). The
// next k16 step is 32 bytes on: the start address field + 2.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
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
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
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
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int s) { wgmma_m64n64(d, a, b, s); }
};
template <> struct Mma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int s) { wgmma_m64n128(d, a, b, s); }
};
template <> struct Mma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b, int s) { wgmma_m64n256(d, a, b, s); }
};

// ---- shared memory ----

// The 16-byte chunk of row r that holds logical chunk `chunk` (128-byte swizzle).
__device__ __forceinline__ int swz(int r, int chunk) { return chunk ^ (r & 7); }

// Byte offset of element (r, c) in a tile of 64-deep K blocks (64 rows x 128 bytes each).
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 6) * kBlockBytes + r * 128 + swz(r, (c >> 3) & 7) * 16 + (c & 7) * 2;
}

struct Smem {
  unsigned char* ring;  // stages slots, slot_bytes apart
  float* heads;
  float* cst;           // two consumers' staging areas, cst_floats apart
  uint64_t* full;
  uint64_t* empty;
  uint64_t* head_bar;
};

struct Tiles {  // one consumer's tiles
  unsigned char* act;
  unsigned char* lo;
  unsigned char* hi;
};

__device__ __forceinline__ int consumer_bytes(const Program& p) {
  return (p.act_kb + p.lo_kb + p.hi_kb) * kBlockBytes;
}

__device__ __forceinline__ Smem carve(unsigned char* base, const Program& p) {
  Smem s;
  s.ring = base;
  unsigned char* q = base + p.stages * p.slot_bytes + 2 * consumer_bytes(p);
  s.heads = reinterpret_cast<float*>(q);
  q += (p.head_floats * 4 + 15) & ~15;
  s.cst = reinterpret_cast<float*>(q);
  q += 2 * p.cst_floats * 4;
  s.full = reinterpret_cast<uint64_t*>(q);
  s.empty = s.full + kMaxStages;
  s.head_bar = s.empty + kMaxStages;
  return s;
}

__device__ __forceinline__ Tiles tiles_of(unsigned char* base, const Program& p, int c) {
  Tiles t;
  t.act = base + p.stages * p.slot_bytes + c * consumer_bytes(p);
  t.lo = t.act + p.act_kb * kBlockBytes;
  t.hi = t.lo + p.lo_kb * kBlockBytes;
  return t;
}

__device__ __forceinline__ void st_act(unsigned char* p, __nv_bfloat162 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// Rows row0 .. row0 + 63 of src (`cols` bf16 wide: rows are not 16-byte
// aligned, so no bulk copy takes them) into a tile of kb K blocks, one
// 16-byte chunk per thread and step; zeros past n_rows and past cols.
__device__ __forceinline__ void load_rows(unsigned char* tile, const __nv_bfloat16* __restrict__ src,
                                          int cols, int kb, int row0, int n_rows, int t) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  const int per_row = kb * 8, chunks = kRows * per_row;
#pragma unroll 4
  for (int i = t; i < chunks; i += 128) {
    const int r = i / per_row, cc = i - r * per_row, gr = row0 + r;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = cc * 8 + 2 * e;
      uint32_t a = 0, b = 0;
      if (gr < n_rows) {
        if (c < cols) a = __ldg(s + (size_t)gr * cols + c);
        if (c + 1 < cols) b = __ldg(s + (size_t)gr * cols + c + 1);
      }
      w[e] = a | (b << 16);
    }
    *reinterpret_cast<uint4*>(tile + tile_off(r, cc * 8)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---- the producer ----

// One thread: the head weights (the first head_floats of fpar), then every
// layer's slabs in program order into the ring.
__device__ __forceinline__ void produce(const Program& p, const Smem& s,
                                        const __nv_bfloat16* __restrict__ wts,
                                        const float* __restrict__ fpar) {
  if (p.head_floats) {
    mbar_expect_tx(s.head_bar, p.head_floats * 4);
    bulk_g2s(s.heads, fpar, p.head_floats * 4, s.head_bar);
  }
  const unsigned char* src = reinterpret_cast<const unsigned char*>(wts);
  int slot = 0, phase = 0, it = 0;
  for (int i = 0; i < p.n_ops; ++i) {
    const Op& op = p.ops[i];
    const uint32_t bytes = op.n_pad * 128;
    const int slabs = op.kb[0] + op.kb[1] + op.kb[2];
    for (int k = 0; k < slabs; ++k, ++it) {
      mbar_wait(s.empty + slot, phase ^ 1);
      mbar_expect_tx(s.full + slot, bytes);
      bulk_g2s(s.ring + slot * p.slot_bytes, src, bytes, s.full + slot);
      src += bytes;
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
}

// ---- the consumers ----

// Start copying the layer's bias (n_pad floats) and, for an hvx layer with
// staging, the hvx rows of the consumer's rays into its staging area; the
// copies land while the products run.
__device__ __forceinline__ void stage_consts(const Op& op, const Program& p, float* cst,
                                             const float* __restrict__ fpar,
                                             const float* __restrict__ hvx, int row0, int t) {
  for (int i = t; i < op.n_pad / 4; i += 128) cp16(cst + 4 * i, fpar + op.b_off + 4 * i);
  if ((op.flags & FLAG_HVX) && p.hvx_rays) {
    const int rays = p.n_rows / p.ns, first = row0 / p.ns;
    const int count = min(p.hvx_rays, rays - first) * op.n / 4;  // none past the last ray
    const float* src = hvx + ((size_t)op.hvx_slot * rays + first) * op.n;
    for (int i = t; i < count; i += 128) cp16(cst + kBiasFloats + 4 * i, src + 4 * i);
  }
}

// Bias, hvx, ReLU, bf16 rounding and the store of the warpgroup's rows into
// its activation tile, then the folded head from the rounded values. Each
// test that depends on the layer (hvx, ReLU, head) is taken once per pass,
// outside the unrolled loop over the accumulators: branches inside it cost
// every layer (PERF.md). kPre: the hvx layer also stores its products plus
// bias, before hvx, as float32 rows pre[row][n] (the secondary views'
// operand, fused_mlp_sec.cu); kPre false compiles to the plain engine.
template <int N, bool kPre>
__device__ __forceinline__ void epilogue(float (&acc)[N / 2], const Op& op, const Program& p,
                                         const Smem& s, const Tiles& tl, const float* cst,
                                         const float* __restrict__ hvx, float* __restrict__ out,
                                         const float* __restrict__ fpar, float* __restrict__ pre,
                                         int row0, int t) {
  const int warp = t >> 5, lane = t & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;  // the thread's two rows of the 64
  const int n_rows = p.n_rows, n = op.n;
  if (kPre && (op.flags & FLAG_HVX)) {
    const bool ok0 = row0 + r0 < n_rows, ok1 = row0 + r1 < n_rows;
    float* p0 = pre + (size_t)(row0 + r0) * n;
    float* p1 = pre + (size_t)(row0 + r1) * n;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      if (col >= n) continue;
      const float2 b = *reinterpret_cast<const float2*>(cst + col);
      if (ok0) __stcs(reinterpret_cast<float2*>(p0 + col), make_float2(acc[4 * j] + b.x, acc[4 * j + 1] + b.y));
      if (ok1) __stcs(reinterpret_cast<float2*>(p1 + col), make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y));
    }
  }
  if (op.flags & FLAG_HVX) {
    // Staged rows start at the consumer's first ray. A row past n_rows reads
    // the last row's ray: its values are never stored.
    const bool staged = p.hvx_rays > 0;
    const float* base = staged ? cst + kBiasFloats : hvx + (size_t)op.hvx_slot * (n_rows / p.ns) * n;
    const int first = staged ? row0 / p.ns : 0;
    const float* hv0 = base + (size_t)(min(row0 + r0, n_rows - 1) / p.ns - first) * n;
    const float* hv1 = base + (size_t)(min(row0 + r1, n_rows - 1) / p.ns - first) * n;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 zero = make_float2(0.f, 0.f);
      const float2 h0 = col < n ? *reinterpret_cast<const float2*>(hv0 + col) : zero;
      const float2 h1 = col < n ? *reinterpret_cast<const float2*>(hv1 + col) : zero;
      acc[4 * j] += h0.x;
      acc[4 * j + 1] += h0.y;
      acc[4 * j + 2] += h1.x;
      acc[4 * j + 3] += h1.y;
    }
  }
  const bool relu = op.flags & FLAG_RELU;  // a select on it, no branch
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(cst + col);
    float v[4] = {acc[4 * j] + b.x, acc[4 * j + 1] + b.y, acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = relu ? fmaxf(v[e], 0.f) : v[e];
    const __nv_bfloat162 x0 = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 x1 = __floats2bfloat162_rn(v[2], v[3]);
    st_act(tl.act + tile_off(r0, col), x0);
    st_act(tl.act + tile_off(r1, col), x1);
    const float2 f0 = __bfloat1622float2(x0), f1 = __bfloat1622float2(x1);
    acc[4 * j] = f0.x;  // the rounded values, for the head
    acc[4 * j + 1] = f0.y;
    acc[4 * j + 2] = f1.x;
    acc[4 * j + 3] = f1.y;
  }
  const int nout = op.head_nout;
  const bool has_head = nout > 0;
  if (!has_head) return;
  const float* hw = s.heads + op.head_w;
  float* plane = out + (size_t)op.head_plane * n_rows;
#pragma unroll
  for (int o = 0; o < kMaxHead; ++o) {
    if (o >= nout) break;
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 w = *reinterpret_cast<const float2*>(hw + o * N + col);
      a = fmaf(acc[4 * j + 1], w.y, fmaf(acc[4 * j], w.x, a));
      c = fmaf(acc[4 * j + 3], w.y, fmaf(acc[4 * j + 2], w.x, c));
    }
    // The quad of lanes 4g .. 4g + 3 holds rows r0 and r1: two xor steps sum
    // it in a fixed order; lane q == 0 writes.
    const float a1 = __shfl_xor_sync(0xffffffffu, a, 1), c1 = __shfl_xor_sync(0xffffffffu, c, 1);
    a += a1;
    c += c1;
    const float a2 = __shfl_xor_sync(0xffffffffu, a, 2), c2 = __shfl_xor_sync(0xffffffffu, c, 2);
    a += a2;
    c += c2;
    if (q == 0) {
      const float bo = __ldg(fpar + op.head_b + o);
      if (row0 + r0 < n_rows) plane[(size_t)o * n_rows + row0 + r0] = a + bo;
      if (row0 + r1 < n_rows) plane[(size_t)o * n_rows + row0 + r1] = c + bo;
    }
  }
}

// One layer for the warpgroup's 64 rows: its slabs from the ring, then the
// epilogue; slot and phase follow the ring across layers.
template <int N, bool kPre>
__device__ __forceinline__ void layer(const Op& op, const Program& p, const Smem& s, const Tiles& tl,
                                      const float* __restrict__ fpar, const float* __restrict__ hvx,
                                      float* __restrict__ out, float* __restrict__ pre, int row0, int t,
                                      int& slot, int& phase, int& it) {
  const int c = threadIdx.x / 128 - 1;  // the consumer
  float* cst = s.cst + c * p.cst_floats;
  stage_consts(op, p, cst, fpar, hvx, row0, t);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int prev = -1, first = 1;
  for (int seg = 0; seg < op.nseg; ++seg) {
    const unsigned char* a = op.src[seg] == SRC_LO ? tl.lo : op.src[seg] == SRC_HI ? tl.hi : tl.act;
    for (int k = 0; k < op.kb[seg]; ++k, ++it) {
      mbar_wait(s.full + slot, phase);
      const uint64_t da = desc_sw128(a + k * kBlockBytes);
      const uint64_t db = desc_sw128(s.ring + slot * p.slot_bytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<N>::run(acc, da + 2 * kk, db + 2 * kk, first == 0 || kk > 0);
      wgmma_commit();
      first = 0;
      wgmma_wait<1>();  // the group before this one has read its slab: release it
      if (prev >= 0 && t == 0) mbar_arrive(s.empty + prev);
      prev = slot;
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && t == 0) mbar_arrive(s.empty + prev);
  cp_commit_wait();
  named_sync(1 + c);  // every thread's staged constants have landed
  epilogue<N, kPre>(acc, op, p, s, tl, cst, hvx, out, fpar, pre, row0, t);
  fence_proxy_async();  // the tile's generic stores, before the next layer's wgmma reads them
}

// Consumer c (0 or 1) of the block: rows row0 .. row0 + 63.
template <bool kPre>
__device__ __forceinline__ void consume(const Program& p, unsigned char* base, const Smem& s, int c,
                                        const __nv_bfloat16* __restrict__ lo,
                                        const __nv_bfloat16* __restrict__ hi,
                                        const float* __restrict__ hvx, const float* __restrict__ fpar,
                                        float* __restrict__ out, float* __restrict__ pre) {
  const int t = threadIdx.x - 128 * (c + 1);
  const int row0 = blockIdx.x * kBM + c * kRows;
  const Tiles tl = tiles_of(base, p, c);
  load_rows(tl.lo, lo, p.in_lo, p.lo_kb, row0, p.n_rows, t);
  if (p.in_hi > 0) load_rows(tl.hi, hi, p.in_hi, p.hi_kb, row0, p.n_rows, t);
  fence_proxy_async();
  named_sync(1 + c);
  if (p.head_floats) mbar_wait(s.head_bar, 0);
  int slot = 0, phase = 0, it = 0;
  for (int i = 0; i < p.n_ops; ++i) {
    const Op& op = p.ops[i];
    if (op.n_pad == 256)
      layer<256, kPre>(op, p, s, tl, fpar, hvx, out, pre, row0, t, slot, phase, it);
    else if (op.n_pad == 128)
      layer<128, kPre>(op, p, s, tl, fpar, hvx, out, pre, row0, t, slot, phase, it);
    else
      layer<64, kPre>(op, p, s, tl, fpar, hvx, out, pre, row0, t, slot, phase, it);
    named_sync(1 + c);
  }
}

}  // namespace sm90
