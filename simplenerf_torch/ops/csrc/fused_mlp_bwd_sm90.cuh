// Row pass of the bf16 fused-MLP backward for Hopper (sm_90a): the device
// code of fused_mlp_bwd_rows_sm90_kernel in fused_mlp_bwd.cu, the part of
// the CUDA counterparts of simplenerf_tpu/ops/fused_mlp.py `_bwd_kernel`
// and `_ens_bwd_kernel` that recomputes the forward and walks the layers
// back over one tile of rows. The weight pass (fused_mlp_wgrad_sm90.cuh),
// the column sums and the float32 row pass (fused_mlp_bwd_tf32_sm90.cuh,
// this engine's walk back on the 3xTF32 core) are separate.
//
// What bounds it: per point of the published fine MLP the forward again
// and dX, (589,952 + 557,696) multiply-adds, 1.81 TFLOP at the training
// step (1.83 ms at the bf16 peak), and the bytes it must move, 8.14 GB
// (2.43 ms at 3.35 TB/s; chip_smoke.py `row_pass_bytes`): the stash slots
// the weight pass reads, 7.55 GB, the g32 planes for dhvx, 0.40 GB, its
// inputs and partials. Bytes, by a little; a slot that only feeds a head
// is not stored (map -1), as nothing reads it. Every 128-row
// block also reads the forward's and the backward's slab images (~2.3 MB)
// from L2. So the design keeps the tensor cores fed from L2 and takes
// everything else off their path, as the forward's engine
// (fused_mlp_sm90.cuh) does. On the card (PERF.md) the products alone
// take 2.3 ms and the epilogues, which both consumers run at once while
// the tensor cores wait, most of the rest: a lag between the consumers
// would need a layer's slabs more in the ring than shared memory holds,
// and a slab multicast to a cluster of two blocks, which halves the L2
// reads, measured slower. The parts:
//   * 384 threads: warpgroup 0 produces (setmaxnreg 40; one thread issues
//     every slab, forward and backward, by cp.async.bulk into a full/empty
//     mbarrier ring that runs on across ops and ensemble members);
//     warpgroups 1 and 2 consume 64 rows each (setmaxnreg 232). There is
//     no block-wide barrier after the start: a consumer syncs its own 128
//     threads with a named barrier around its tile, and the two consumers
//     meet at the ring and where a column sum adds their two halves;
//   * every product is wgmma.mma_async m64nNk16 from the consumer's
//     swizzled tile (A) and the slab (B), both through 128-byte-swizzle
//     descriptors, one group in flight. The backward's products
//     dh_prev = round(g) @ W^T read a slab image of W itself, packed once
//     per parameter version by ops/fused_mlp.py (`_bwd_plan`): K-major
//     like the forward's, so the backward runs the forward's own proven
//     descriptor and product loop (the forward's image read MN-major would
//     finish 64 output columns per slab, with four accumulator slices and
//     a transposed descriptor, for no fewer bytes);
//   * a forward op's epilogue adds bias (and hvx) in registers, applies
//     ReLU, rounds into the tile and packs the ReLU mask of its
//     accumulator fragment, bit 4j + e for element acc[4j + e] (4 words a
//     thread at width 256), to device memory; the backward op of that
//     layer loads the words back before its product, so they land while
//     it runs;
//   * a backward op's epilogue forms g = acc (+ the head's dp @ w) * mask
//     in registers, takes its column sums for db by shuffles over the
//     quads of lanes and then over the four warps, writes round(g) to the
//     tile and the stash, and g32 for dhvx where asked; its product then
//     reads the tile;
//   * a head's per-tile dW and db come from the rounded tile and the
//     staged dp rows, each thread summing a column pair over its 64 rows;
//   * every sum over rows keeps a fixed order: a consumer's 64 rows, then
//     consumer 1 hands its sums to consumer 0 through shared memory (an
//     mbarrier handshake, not a block barrier), which adds them to its own
//     and writes the block's partials row;
//   * the stash leaves through TMA stores from the swizzled tile (one
//     thread, one 64 x 64 box per K block, rows past n_rows clipped by the
//     tensor map, evict-first in L2), waited on (.read) before the tile is
//     written again.
//
// Shared memory (bytes, from a 1024-aligned base; `_bwd_plan` computes
// the same): the ring (stages x the widest op's n_pad x 128); per consumer
// an activation tile of act_kb x 8 KB, a lo tile and a hi tile; per
// consumer a staging area (bias, hvx rows) and a head's dp rows (64 x 4
// floats); the column sums' per-warp rows; the hand-over buffer; 10
// mbarriers. The published fine MLP: 4 x 32 + 2 x 40 + 4 + 2 + 8 + 4 KB =
// 226.1 KB of the 227 KB.

#pragma once

#include <cuda.h>

#include "fused_mlp_sm90.cuh"
#include "fused_mlp_wgrad_sm90.cuh"

namespace bwd90 {

using sm90::kBlockBytes;
using sm90::kBM;
using sm90::kRows;

constexpr int kThreads = 384;
constexpr int kMaxOps = 64;
constexpr int kMaxSeg = 3;
constexpr int kMaxStages = 4;
constexpr int kMaxHead = 4;
constexpr int kHeaderWords = 16;
constexpr int kOpWords = 22;
constexpr int kBiasFloats = 256;                    // a layer's bias at the head of the staging area
constexpr int kDpFloats = kRows * kMaxHead;         // a consumer's dp rows, [row][channel]
constexpr int kRedFloats = 2 * 4 * 256;             // [consumer][warp][column]
constexpr int kXferFloats = kMaxHead * 256 + kMaxHead;  // a head's dW row block, db
constexpr int kBarriers = 2 * kMaxStages + 2;
constexpr int kConsumerThreads = 128;
constexpr int kMaskThreads = 2 * kConsumerThreads;  // mask words: one uint4 per consumer thread

enum { F_IN = 0, F_LAYER = 1, H_LAYER = 2, B_LAYER = 3 };
enum { SRC_ACT = 0, SRC_LO = 1, SRC_HI = 2 };
enum { FLAG_RELU = 1, FLAG_HVX = 2 };

// One op (22 ints; built by ops/fused_mlp.py `_bwd_plan` from the layers of
// `_layers`, forward and then in reverse). Every op whose stash slot the
// weight pass reads writes its n columns there (stash + out_slot * n_rows;
// tensor map `map`, -1 for a slot it does not read).
//   F_IN:    the src[0] tile to the stash.
//   F_LAYER: act = f(sum_s src[s] @ W_s + bias [+ hvx[hvx_slot]]), n real
//            columns of n_pad, kb[s] slabs per segment; with RELU its mask
//            words at mask_slot; with head_nout > 0 the head's per-tile
//            partials, dW[q][c] = sum_rows act[row][c] * dp[plane + q][row]
//            at part, db[q] = sum_rows dp[plane + q][row] at part2.
//   H_LAYER: (float32 only) the partials of the head a layer feeds, as
//            F_LAYER forms them, from the layer's n activations that the
//            training forward stored at slot out_slot; stores nothing (map
//            -1). The float32 program has no F_IN or F_LAYER op: the
//            forward ran under autograd (fused_mlp_tf32_sm90.cuh kStash).
//   B_LAYER: acc = round(g_above) @ W^T over kb[0] slabs of the act tile
//            (nseg 1; nseg 0: acc = 0, the top of a chain); then g = (acc +
//            sum_q dp[plane + q] * fpar[head_w + q * n_pad + c]) * mask
//            (RELU, the words at mask_slot), g32[g32_slot] = g when >= 0,
//            db partial at part, round(g) to the tile.
struct Op {
  int kind, n, n_pad, b_off, flags, nseg;
  int src[kMaxSeg];
  int kb[kMaxSeg];
  int hvx_slot, out_slot, map, mask_slot, plane, head_nout, head_w, part, part2, g32_slot;
};

// hvx_rays > 0: an hvx layer stages the hvx rows of its consumer's rays;
// cst_floats: one consumer's staging area; n_maps: the row pass's tensor maps;
// hvx_w: the g32 planes' width (the column sums').
struct Program {
  int n_ops, n_rows, ns, in_lo, in_hi, lo_kb, hi_kb, act_kb, slot_bytes, stages, hvx_rays,
      cst_floats, part_w, n_masks, n_maps, hvx_w;
  Op ops[kMaxOps];
};
static_assert(sizeof(Op) == kOpWords * sizeof(int), "Op layout");
static_assert(sizeof(Program) == (kHeaderWords + kOpWords * kMaxOps) * sizeof(int), "Program layout");

using sm90::bulk_g2s;
using sm90::cp16;
using sm90::cp_commit_wait;
using sm90::desc_sw128;
using sm90::fence_acc;
using sm90::fence_proxy_async;
using sm90::Mma;
using sm90::named_sync;
using sm90::smem_u32;
using sm90::tile_off;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;
using wgrad::mbar_arrive;
using wgrad::mbar_expect_tx;
using wgrad::mbar_init;
using wgrad::mbar_wait;  // traps after ~2 s under -DSNERF_WGRAD_WATCHDOG

struct Smem {
  unsigned char* ring;
  float* cst;   // two consumers' staging areas, cst_floats apart
  float* dsm;   // two consumers' dp rows, kDpFloats apart
  float* red;   // kRedFloats
  float* xfer;  // kXferFloats
  uint64_t* full;
  uint64_t* empty;
  uint64_t* xfull;   // consumer 1's sums are in xfer (128 arrivals)
  uint64_t* xempty;  // consumer 0 has read them (128 arrivals)
};

struct Tiles {
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
  s.cst = reinterpret_cast<float*>(q);
  q += 2 * p.cst_floats * 4;
  s.dsm = reinterpret_cast<float*>(q);
  q += 2 * kDpFloats * 4;
  s.red = reinterpret_cast<float*>(q);
  q += kRedFloats * 4;
  s.xfer = reinterpret_cast<float*>(q);
  q += kXferFloats * 4;
  s.full = reinterpret_cast<uint64_t*>(q);
  s.empty = s.full + kMaxStages;
  s.xfull = s.empty + kMaxStages;
  s.xempty = s.xfull + 1;
  return s;
}

__device__ __forceinline__ Tiles tiles_of(unsigned char* base, const Program& p, int c) {
  Tiles t;
  t.act = base + p.stages * p.slot_bytes + c * consumer_bytes(p);
  t.lo = t.act + p.act_kb * kBlockBytes;
  t.hi = t.lo + p.lo_kb * kBlockBytes;
  return t;
}

__device__ __forceinline__ const unsigned char* source(const Tiles& tl, int src) {
  return src == SRC_LO ? tl.lo : src == SRC_HI ? tl.hi : tl.act;
}

// ---- TMA stores ----

// One 64 x 64 box of the swizzled tile to `map` at (column c0, row r0);
// rows and columns past the map's dims are not written. The stash is read
// only by the weight pass, after this kernel: evict-first in L2, so that it
// does not push out the weight slabs every block reads.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int r0, const void* src) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%1, %2}], [%3], %4;\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(r0), "r"(smem_u32(src)), "l"(policy)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// The stores issued so far have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// The consumer's 64 rows of a tile (`width` columns) to the op's stash
// slot, its tensor map maps.map[map]: one thread's TMA stores, one box per
// K block, after the tile's named barrier; none for map -1, a slot that the
// weight pass does not read. (16-byte stores from every thread measured
// slower: PERF.md.)
__device__ __forceinline__ void stash_out(const unsigned char* tile, int width, const wgrad::Maps& maps,
                                          int map, int row0, int t) {
  if (map < 0) return;
  if (t == 0) {
    for (int b = 0; b * 64 < width; ++b) tma_store(&maps.map[map], b * 64, row0, tile + b * kBlockBytes);
    bulk_commit();
  }
}

// ---- the producer ----

// One thread: every op's slabs in program order into the ring.
__device__ __forceinline__ void produce(const Program& p, const Smem& s,
                                        const __nv_bfloat16* __restrict__ wts) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(wts);
  int slot = 0, phase = 0;
  for (int i = 0; i < p.n_ops; ++i) {
    const Op& op = p.ops[i];
    const uint32_t bytes = op.n_pad * 128;
    const int slabs = op.kb[0] + op.kb[1] + op.kb[2];
    for (int k = 0; k < slabs; ++k) {
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

struct Ctx {  // one consumer's place in the block and in the ring
  const Program* p;
  const wgrad::Maps* maps;
  Smem s;
  Tiles tl;
  int c, t, row0;
  int slot, phase, k;  // the ring's next slot and phase; hand-overs so far
};

// acc = sum over the op's segments of src_seg @ slab image, the forward
// engine's loop: a slab's four k16 steps as one group, one group in
// flight, the slot of the slab before released by one arrival.
template <int N>
__device__ __forceinline__ void product(float (&acc)[N / 2], const Op& op, Ctx& x) {
  const Program& p = *x.p;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int prev = -1, first = 1;
  for (int seg = 0; seg < op.nseg; ++seg) {
    const unsigned char* a = source(x.tl, op.src[seg]);
    for (int k = 0; k < op.kb[seg]; ++k) {
      mbar_wait(x.s.full + x.slot, x.phase);
      const uint64_t da = desc_sw128(a + k * kBlockBytes);
      const uint64_t db = desc_sw128(x.s.ring + x.slot * p.slot_bytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Mma<N>::run(acc, da + 2 * kk, db + 2 * kk, first == 0 || kk > 0);
      wgmma_commit();
      first = 0;
      wgmma_wait<1>();  // the group before this one has read its slab: release it
      if (prev >= 0 && x.t == 0) mbar_arrive(x.s.empty + prev);
      prev = x.slot;
      if (++x.slot == p.stages) {
        x.slot = 0;
        x.phase ^= 1;
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && x.t == 0) mbar_arrive(x.s.empty + prev);
}

// Consumer 1 hands its sums to consumer 0 (the k-th hand-over): before
// writing, it waits until consumer 0 has read the one before.
__device__ __forceinline__ float* hand_over_begin(Ctx& x) {
  if (x.c == 1 && x.k > 0) mbar_wait(x.s.xempty, (x.k - 1) & 1);
  if (x.c == 0) mbar_wait(x.s.xfull, x.k & 1);
  return x.s.xfer;
}
__device__ __forceinline__ void hand_over_end(Ctx& x) {
  mbar_arrive(x.c == 1 ? x.s.xfull : x.s.xempty);
  ++x.k;
}

// Start copying the layer's bias (n_pad floats) and, for an hvx layer with
// staging, the hvx rows of the consumer's rays into its staging area.
__device__ __forceinline__ void stage_consts(const Op& op, const Program& p, float* cst,
                                             const float* __restrict__ fpar,
                                             const float* __restrict__ hvx, int row0, int t) {
  for (int i = t; i < op.n_pad / 4; i += kConsumerThreads) cp16(cst + 4 * i, fpar + op.b_off + 4 * i);
  if ((op.flags & FLAG_HVX) && p.hvx_rays) {
    const int rays = p.n_rows / p.ns, first = row0 / p.ns;
    const int count = min(p.hvx_rays, rays - first) * op.n / 4;
    const float* src = hvx + ((size_t)op.hvx_slot * rays + first) * op.n;
    for (int i = t; i < count; i += kConsumerThreads) cp16(cst + kBiasFloats + 4 * i, src + 4 * i);
  }
}

// Start copying the head's dp rows of the consumer's rows, dsm[row][q]
// (zeros past n_rows and for channels past head_nout).
__device__ __forceinline__ void stage_dp(const Op& op, const Program& p, float* dsm,
                                         const float* __restrict__ dplanes, int row0, int t) {
  for (int i = t; i < kDpFloats; i += kConsumerThreads) {
    const int r = i >> 2, q = i & 3;
    if (q < op.head_nout && row0 + r < p.n_rows)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dsm + i)),
                   "l"(dplanes + (size_t)(op.plane + q) * p.n_rows + row0 + r)
                   : "memory");
    else
      dsm[i] = 0.f;
  }
}

// A forward op's epilogue: bias, hvx, ReLU, bf16 rounding and the store of
// the consumer's rows into its activation tile, the ReLU mask of the
// rounded values (what the plain version tests on the stored activation)
// to `mask`. Each test that depends on the op is taken once per pass.
template <int N>
__device__ __forceinline__ void f_epilogue(float (&acc)[N / 2], const Op& op, const Ctx& x,
                                           const float* cst, const float* __restrict__ hvx,
                                           uint4* mask) {
  const Program& p = *x.p;
  const int warp = x.t >> 5, lane = x.t & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int n_rows = p.n_rows, n = op.n, row0 = x.row0;
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
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(cst + col);
    float v[4] = {acc[4 * j] + b.x, acc[4 * j + 1] + b.y, acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = relu ? fmaxf(v[e], 0.f) : v[e];
    const __nv_bfloat162 x0 = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 x1 = __floats2bfloat162_rn(v[2], v[3]);
    sm90::st_act(x.tl.act + tile_off(r0, col), x0);
    sm90::st_act(x.tl.act + tile_off(r1, col), x1);
    const float2 f0 = __bfloat1622float2(x0), f1 = __bfloat1622float2(x1);
    const float f[4] = {f0.x, f0.y, f1.x, f1.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) bits[j >> 3] |= (f[e] > 0.f ? 1u : 0u) << (4 * (j & 7) + e);
  }
  if (relu) *mask = make_uint4(bits[0], bits[1], bits[2], bits[3]);
}

// The per-tile partials of the head a forward op feeds, from the rounded
// tile and the staged dp rows: thread t sums columns 2t and 2t + 1 over the
// consumer's 64 rows in order; consumer 0 adds consumer 1's sums to its
// own and writes dW[q][c] at part, db[q] at part2.
__device__ __forceinline__ void head_partials(const Op& op, Ctx& x, float* __restrict__ part) {
  const int n = op.n, hn = op.head_nout, col = 2 * x.t;
  const float4* dsm = reinterpret_cast<const float4*>(x.s.dsm + x.c * kDpFloats);
  float w0[kMaxHead], w1[kMaxHead], db[kMaxHead], my_db = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxHead; ++q) w0[q] = w1[q] = db[q] = 0.f;
  const bool active = col < n;
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    const float4 d4 = dsm[r];
    const float d[kMaxHead] = {d4.x, d4.y, d4.z, d4.w};
    const float2 a = active ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                  x.tl.act + tile_off(r, col)))
                            : make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kMaxHead; ++q) {
      w0[q] = fmaf(a.x, d[q], w0[q]);
      w1[q] = fmaf(a.y, d[q], w1[q]);
      db[q] += d[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxHead; ++q) my_db = q == x.t ? db[q] : my_db;  // channel t's db
  float* buf = hand_over_begin(x);
  if (x.c == 1) {
#pragma unroll
    for (int q = 0; q < kMaxHead; ++q)
      if (q < hn && active) *reinterpret_cast<float2*>(buf + q * 256 + col) = make_float2(w0[q], w1[q]);
    if (x.t < hn) buf[kMaxHead * 256 + x.t] = my_db;
  } else {
#pragma unroll
    for (int q = 0; q < kMaxHead; ++q)
      if (q < hn && active) {
        const float2 o = *reinterpret_cast<const float2*>(buf + q * 256 + col);
        float* dst = part + op.part + q * n + col;  // partials' offsets may be odd: no float2
        dst[0] = w0[q] + o.x;
        dst[1] = w1[q] + o.y;
      }
    if (x.t < hn) part[op.part2 + x.t] = my_db + buf[kMaxHead * 256 + x.t];
  }
  hand_over_end(x);
  named_sync(1 + x.c);  // every thread has read dsm: the next head's stage_dp may overwrite it
}

// A forward op: its bias (and hvx rows, and a head's dp rows) staged while
// the product runs, the epilogue, the tile to the stash, the head's
// partials.
template <int N>
__device__ __forceinline__ void f_layer(const Op& op, Ctx& x, const float* __restrict__ fpar,
                                        const float* __restrict__ hvx,
                                        const float* __restrict__ dplanes, uint4* tmask,
                                        float* __restrict__ part) {
  const Program& p = *x.p;
  float* cst = x.s.cst + x.c * p.cst_floats;
  stage_consts(op, p, cst, fpar, hvx, x.row0, x.t);
  if (op.head_nout) stage_dp(op, p, x.s.dsm + x.c * kDpFloats, dplanes, x.row0, x.t);
  float acc[N / 2];
  product<N>(acc, op, x);
  cp_commit_wait();
  if (x.t == 0) bulk_wait_read();  // the last stash store has read the tile
  named_sync(1 + x.c);  // staged constants landed; every reader of the tile is done
  f_epilogue<N>(acc, op, x, cst, hvx, tmask + op.mask_slot * kMaskThreads);
  fence_proxy_async();  // the tile's generic stores, before the stash's TMA and the next wgmma read them
  named_sync(1 + x.c);
  stash_out(x.tl.act, op.n, *x.maps, op.map, x.row0, x.t);
  if (op.head_nout) head_partials(op, x, part);
}

// A backward op: the product from the g above (or zeros at the top of a
// chain), then g in registers, its column sums, round(g) to the tile and
// the stash. kSec: the hvx layer's g gains the secondary views' cotangent
// sec[row][n] (fused_mlp_sec.cu) after its g32 store, so that dhvx keeps
// the primary view's share; kSec false compiles to the plain engine.
template <int N, bool kSec>
__device__ __forceinline__ void b_layer(const Op& op, Ctx& x, const float* __restrict__ fpar,
                                        const float* __restrict__ dplanes, const uint4* tmask,
                                        float* __restrict__ g32, float* __restrict__ part,
                                        const float* __restrict__ sec) {
  const Program& p = *x.p;
  const int warp = x.t >> 5, lane = x.t & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int n_rows = p.n_rows, n = op.n, hn = op.head_nout;
  const bool ok0 = x.row0 + r0 < n_rows, ok1 = x.row0 + r1 < n_rows;
  // The mask words this thread packed in the layer's forward op, and the
  // head's dp of its two rows: loads in flight during the product.
  const bool relu = op.flags & FLAG_RELU;
  const uint4 mk = relu ? tmask[op.mask_slot * kMaskThreads] : make_uint4(~0u, ~0u, ~0u, ~0u);
  float d0[kMaxHead], d1[kMaxHead];
#pragma unroll
  for (int h = 0; h < kMaxHead; ++h) {
    const float* dp = dplanes + (size_t)(op.plane + h) * n_rows + x.row0;
    d0[h] = h < hn && ok0 ? dp[r0] : 0.f;
    d1[h] = h < hn && ok1 ? dp[r1] : 0.f;
  }
  float acc[N / 2];
  if (op.nseg) {
    product<N>(acc, op, x);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  if (x.t == 0) bulk_wait_read();  // the last stash store has read the tile
  named_sync(1 + x.c);  // every reader of the tile (stash stores, head partials) is done
  if (hn) {
    const float* hw = fpar + op.head_w;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < kMaxHead; ++h) {
        if (h >= hn) break;
        const float2 w = __ldg(reinterpret_cast<const float2*>(hw + h * N + col));
        acc[4 * j] = fmaf(d0[h], w.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(d0[h], w.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(d1[h], w.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(d1[h], w.y, acc[4 * j + 3]);
      }
    }
  }
  // g: the mask (rows past n_rows give 0).
  const uint32_t words[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on = ((words[j >> 3] >> (4 * (j & 7) + e)) & 1u) && (e < 2 ? ok0 : ok1);
      acc[4 * j + e] = on ? acc[4 * j + e] : 0.f;
    }
  }
  if (op.g32_slot >= 0) {  // streaming, as the stash
    float* g = g32 + (size_t)op.g32_slot * n_rows * n + (size_t)x.row0 * n;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      if (col >= n) continue;
      if (ok0) __stcs(reinterpret_cast<float2*>(g + (size_t)r0 * n + col), make_float2(acc[4 * j], acc[4 * j + 1]));
      if (ok1) __stcs(reinterpret_cast<float2*>(g + (size_t)r1 * n + col), make_float2(acc[4 * j + 2], acc[4 * j + 3]));
    }
  }
  if (kSec && op.g32_slot >= 0) {
    const float* s0 = sec + (size_t)(x.row0 + r0) * n;
    const float* s1 = sec + (size_t)(x.row0 + r1) * n;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      if (col >= n) continue;
      if (ok0) {
        const float2 v = __ldcs(reinterpret_cast<const float2*>(s0 + col));
        acc[4 * j] += v.x;
        acc[4 * j + 1] += v.y;
      }
      if (ok1) {
        const float2 v = __ldcs(reinterpret_cast<const float2*>(s1 + col));
        acc[4 * j + 2] += v.x;
        acc[4 * j + 3] += v.y;
      }
    }
  }
  // round(g) to the tile; the warp's column sums of g to its red row (the
  // thread's two rows, then xor-shuffles over the eight lanes of a column;
  // a butterfly that halves the shuffles measured slower: PERF.md).
  float* red = x.s.red + (x.c * 4 + warp) * 256;  // free: every reader passed the barrier above
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    sm90::st_act(x.tl.act + tile_off(r0, col), __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]));
    sm90::st_act(x.tl.act + tile_off(r1, col), __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]));
    float s0 = acc[4 * j] + acc[4 * j + 2], s1 = acc[4 * j + 1] + acc[4 * j + 3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane < 4) *reinterpret_cast<float2*>(red + col) = make_float2(s0, s1);
  }
  fence_proxy_async();
  named_sync(1 + x.c);  // the tile and the consumer's red rows are complete
  stash_out(x.tl.act, n, *x.maps, op.map, x.row0, x.t);
  // db: thread t takes columns 2t and 2t + 1, the four warps' rows in
  // order, then consumer 0 adds consumer 1's.
  const int col = 2 * x.t;
  const bool active = col < n;
  float2 s = make_float2(0.f, 0.f);
  if (active) {
    const float* mine = x.s.red + x.c * 4 * 256 + col;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(mine + w * 256);
      s.x += v.x;
      s.y += v.y;
    }
  }
  float* buf = hand_over_begin(x);
  if (active) {
    if (x.c == 1) {
      *reinterpret_cast<float2*>(buf + col) = s;
    } else {
      const float2 o = *reinterpret_cast<const float2*>(buf + col);
      part[op.part + col] = s.x + o.x;  // partials' offsets may be odd: no float2
      part[op.part + col + 1] = s.y + o.y;
    }
  }
  hand_over_end(x);
}

// Consumer c (0 or 1) of the block: rows row0 .. row0 + 63.
template <bool kSec>
__device__ __forceinline__ void consume(const Program& p, const wgrad::Maps& maps, unsigned char* base,
                                        const Smem& s, int c, const __nv_bfloat16* __restrict__ lo,
                                        const __nv_bfloat16* __restrict__ hi,
                                        const float* __restrict__ hvx,
                                        const float* __restrict__ dplanes,
                                        const float* __restrict__ fpar, float* __restrict__ g32,
                                        uint4* masks,
                                        float* __restrict__ parts, const float* __restrict__ sec) {
  Ctx x;
  x.p = &p;
  x.maps = &maps;
  x.s = s;
  x.c = c;
  x.t = threadIdx.x - kConsumerThreads * (c + 1);
  x.row0 = blockIdx.x * kBM + c * kRows;
  x.tl = tiles_of(base, p, c);
  x.slot = x.phase = x.k = 0;
  sm90::load_rows(x.tl.lo, lo, p.in_lo, p.lo_kb, x.row0, p.n_rows, x.t);
  if (p.in_hi > 0) sm90::load_rows(x.tl.hi, hi, p.in_hi, p.hi_kb, x.row0, p.n_rows, x.t);
  fence_proxy_async();
  named_sync(1 + c);
  uint4* tmask = masks + (size_t)blockIdx.x * p.n_masks * kMaskThreads + c * kConsumerThreads + x.t;
  float* part = parts + (size_t)blockIdx.x * p.part_w;
  for (int i = 0; i < p.n_ops; ++i) {
    const Op& op = p.ops[i];
    if (op.kind == F_IN) {
      stash_out(source(x.tl, op.src[0]), op.n, maps, op.map, x.row0, x.t);
    } else if (op.kind == F_LAYER) {
      if (op.n_pad == 256)
        f_layer<256>(op, x, fpar, hvx, dplanes, tmask, part);
      else if (op.n_pad == 128)
        f_layer<128>(op, x, fpar, hvx, dplanes, tmask, part);
      else
        f_layer<64>(op, x, fpar, hvx, dplanes, tmask, part);
    } else {
      if (op.n_pad == 256)
        b_layer<256, kSec>(op, x, fpar, dplanes, tmask, g32, part, sec);
      else if (op.n_pad == 128)
        b_layer<128, kSec>(op, x, fpar, dplanes, tmask, g32, part, sec);
      else
        b_layer<64, kSec>(op, x, fpar, dplanes, tmask, g32, part, sec);
    }
  }
  if (x.t == 0) bulk_wait_all();  // the stash is in device memory before the block ends
}

}  // namespace bwd90
