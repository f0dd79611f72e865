// Fused NeRF field MLP backward for Hopper (sm_90a).
//
// Replaces two TPU kernels of simplenerf_tpu/ops/fused_mlp.py: `_bwd_kernel`
// (the recompute VJP behind `fused_apply`) and `_ens_bwd_kernel` (behind
// `fused_apply_ensemble`). Given the raw head planes' cotangents it returns
// every kernel parameter's gradient in float32 and the per-ray hvx
// cotangent; the points get none. An ensemble is a longer program over the
// one shared lo tile.
//
// What bounds it: arithmetic. Per point the published 8x256 MLP needs the
// forward again (589,952 multiply-adds), dX (557,696) and dW (589,952):
// 3.5 MFLOP against a few hundred bytes. The TPU kernel carries its f32 dW
// sums from one sequential grid step to the next in VMEM; Hopper's blocks
// run in parallel and in no order, and a 256x256 float32 dW does not fit in
// a block, so the work is split in two passes with fixed-order reductions
// (the same result on every run; no atomics):
//   (a) row pass, one block per tile of rows (128 in bf16, 64 in f32): the
//       forward is recomputed with the forward kernel's code (shared tiles,
//       weight-slab ring, mma.sync), and each layer's rounded activation is
//       stashed in device memory. A ReLU layer's epilogue also packs its
//       mask as bits in the order of the thread's accumulator fragment (two
//       words a thread), and the layer that feeds a head sums the head's
//       per-tile dW and db from the tile it just wrote. Then the layers are
//       walked backward: g = dh * mask in float32 (the thread that packed
//       the bits loads them back ahead of the epilogue that needs them; the
//       head's contribution is added to the product's accumulators first),
//       its per-tile column sum (db) goes to a partials row of the tile,
//       round(g) is stored in the shared tile and stashed, and dh_prev =
//       round(g) @ W^T runs on the tensor cores with the weight stored
//       (K, N) streaming through the same ring. The views layer 0's float32
//       g is kept for dhvx. What the backward adds to the forward's
//       products is kept off the tensor cores' path (PERF.md): no mask is
//       read back through shared memory, no partial re-reads the stash, and
//       the stash goes out as streaming stores.
//   (b) weight pass: dW = round(h_prev)^T @ round(g) over a chunk of rows,
//       both operands from the stash, into a partials row per chunk. bf16:
//       fused_mlp_bwd_wgrad_kernel (fused_mlp_wgrad_sm90.cuh), panels of a
//       dW fed by TMA boxes, wgmma with both operands MN-major, the two
//       panels of a 256-row dW as a cluster of two that reads G in step, so
//       each stash slot crosses from device memory about once per launch;
//       float32:
//       one block per 128x128 tile of one dW and chunk (cp.async stages,
//       plain FMAs);
//   (c) fixed-order column sums: partials over tiles, dW partials over
//       chunks, and g over each ray's ns rows (dhvx). Each sum splits its
//       rows into a fixed number of slices (ops/fused_mlp.py
//       `_colsum_slices`) so that the card is full at every shape; each
//       thread sums 4 columns of one slice in row order with 16-byte loads,
//       and a second launch adds the slices in order.
// Every product rounds its operands to the compute type and accumulates in
// float32, as the TPU kernel's products do, so storing round(g) loses
// nothing. What bounds this design on the card (PERF.md): the products and
// the stash, about 2 x 4.9 KB per point in bf16 for the published MLP,
// written once by the row pass and read once by the weight pass.
//
// Plain C interface (ctypes): snerf_fused_mlp_bwd and snerf_fused_mlp_ens_bwd
// (and snerf_wgrad, snerf_colsum: the weight pass and the column sums
// alone) return the first CUDA error of their launches, 0 on success.

#include <type_traits>
#include <vector>

#include "fused_mlp_common.cuh"
#include "fused_mlp_wgrad_sm90.cuh"

namespace {

enum { F_IN = 0, F_LAYER = 1, B_LAYER = 3 };
constexpr int kMaxHead = 4;  // head channels (the views head's rgb + visibility)

// One step of the backward program (24 ints; built by ops/fused_mlp.py).
// The first 16 ints mean what they mean in the forward kernel's Op.
//   F_IN:    stash[out_slot] = the src[0] tile (gn columns).
//   F_LAYER: a forward layer; its activation (n columns) also to stash[out_slot].
//            With RELU each thread packs the ReLU mask of its accumulator
//            fragment into two words, bit set where the rounded activation
//            is > 0, at masks[tile][mask_slot][thread].
//            With head_nout > 0 it feeds a head, whose partials it forms from
//            the rounded activation: dW[j][k] = sum_rows act[row][k] *
//            dp[plane + j][row] at `part`, db[j] = sum_rows dp[plane + j][row]
//            at `part2`.
//   B_LAYER: g = ([ZERO] ? 0 : acc) [+ sum_j dp[plane + j] * fpar[head_w_off + j*gn + c]],
//            times the mask bits masks[tile][mask_slot][thread] when RELU (the
//            thread holds the same fragment elements of a layer of that
//            width as the F_LAYER's epilogue did); db partial at `part`; round(g)
//            to the tile and stash[out_slot]; float32 g to g32[g32_slot] when >= 0;
//            then, when nseg = 1, acc = round(g) @ W^T (W stored (n, kpad)).
struct BOp {
  int kind, n, b_off, flags, nseg;
  int src[kMaxSeg];
  int w_off[kMaxSeg];
  int kpad[kMaxSeg];
  int plane, hvx_slot;
  int out_slot, gn, mask_slot, head_nout, head_w_off, part, g32_slot, part2;
};
static_assert(sizeof(BOp) == 24 * sizeof(int), "BOp layout");

struct BProgram {
  int n_ops, n_rows, ns, in_lo, in_hi, lo_kpad, hi_kpad;
  int act_ld, lo_ld, hi_ld, slab_ld, slab_rows, slab_k;
  int part_w, hvx_w, n_masks;
  const BOp* ops;
  __device__ __forceinline__ const BOp& op(int i) const { return ops[i]; }
};
constexpr int kBHeaderWords = 16;

// Float32 weight-pass task: the 128x128 tile (i0, j0) of dW (k_in, n_out) =
// A^T G, A = stash slot a_slot (width a_w), G = stash slot g_slot (width g_w).
struct Task {
  int a_slot, a_w, g_slot, g_w, k_in, n_out, dw_off, i0, j0;
};
constexpr int kTaskWords = 9;
static_assert(sizeof(Task) == kTaskWords * sizeof(int), "Task layout");

template <typename T>
__device__ __forceinline__ T* slot_ptr(T* stash, int slot, int n_rows) {
  return stash + (size_t)slot * n_rows;
}

// Tile rows (ld apart) -> a stash slot of `width` columns, 16 bytes at a
// time, as streaming stores (evict first), so that the stash (~7.7 GB at the
// fine step) does not push out of the caches what the row pass reads again,
// such as the weights every block's slab ring reads from L2 (PERF.md).
template <typename T>
__device__ void copy_tile_out(const T* tile, int ld, int width, T* dst, int row0, int n_rows,
                              int tid) {
  constexpr int kElems = 16 / sizeof(T);
  const int per_row = width / kElems, total = Block<T>::BM * per_row;
  for (int i = tid; i < total; i += Block<T>::kThreads) {
    const int r = i / per_row, q = i - r * per_row;
    if (row0 + r < n_rows)
      __stcs(reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * width + q * kElems),
             *reinterpret_cast<const uint4*>(tile + r * ld + q * kElems));
  }
}

template <typename T> __device__ __forceinline__ float rounded(float v);
template <> __device__ __forceinline__ float rounded<float>(float v) { return v; }
template <> __device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The head's cotangent planes at the tile's rows into shared memory,
// dsm[q][r] (BM apart), 0 past n_rows and for channels q >= hn. Read after
// the next barrier.
template <typename T>
__device__ __forceinline__ void stage_head_rows(const BOp& op, const BProgram& p,
                                                const float* __restrict__ dplanes, float* dsm,
                                                int row0, int tid) {
  constexpr int BM = Block<T>::BM;
  const float* dp = dplanes + (size_t)op.plane * p.n_rows;
  for (int i = tid; i < kMaxHead * BM; i += Block<T>::kThreads) {
    const int q = i / BM, r = row0 + i - q * BM;
    dsm[i] = q < op.head_nout && r < p.n_rows ? dp[(size_t)q * p.n_rows + r] : 0.f;
  }
}

// Bit of fragment element (j, mt, h, e) in the thread's mask words: word j / 4.
__device__ __forceinline__ int mask_bit(int j, int mt, int h) {
  return (j & 3) * 8 + mt * 4 + h * 2;
}

// F_LAYER's epilogue: forward_epilogue's act = [ReLU](acc + bias [+ hvx]),
// rounded into the tile; with RELU the ReLU mask of the thread's fragment,
// bit set where the rounded value is > 0 (what the plain version tests on
// the stored activation), to the thread's two words at `mask`.
template <typename T>
__device__ __forceinline__ void recompute_epilogue(const float (&acc)[Traits<T>::MT][kNT][4],
                                                   const BOp& op, const BProgram& p,
                                                   const Tiles<T>& s, const float* __restrict__ fpar,
                                                   const float* __restrict__ hvx, uint2* mask,
                                                   int row0, int tid) {
  constexpr int MT = Traits<T>::MT;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int wrow = warp_m * MT * 16;
  const int n = op.n, flags = op.flags, act_ld = p.act_ld;
  const int g = lane >> 2, t = lane & 3;
  const int n_rows = p.n_rows, ns = p.ns;
  const float* bias = fpar + op.b_off;
  if (flags & FLAG_HVX) hvx += (size_t)op.hvx_slot * (n_rows / ns) * n;
  uint32_t bits[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = (warp_n + kWarpsN * j) * 8 + 2 * t;
    if (col >= n) continue;  // uniform across the warp: n is a multiple of 16
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wrow + mt * 16 + g + 8 * h;
        float v0 = acc[mt][j][2 * h] + b0;
        float v1 = acc[mt][j][2 * h + 1] + b1;
        if ((flags & FLAG_HVX) && row0 + r < n_rows) {
          const float2 hv =
              *reinterpret_cast<const float2*>(hvx + (size_t)((row0 + r) / ns) * n + col);
          v0 += hv.x;
          v1 += hv.y;
        }
        if (flags & FLAG_RELU) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          const int b = mask_bit(j, mt, h);
          bits[j >> 2] |= (rounded<T>(v0) > 0.f ? 1u : 0u) << b |
                          (rounded<T>(v1) > 0.f ? 1u : 0u) << (b + 1);
        }
        store2(s.act + r * act_ld + col, v0, v1);
      }
    }
  }
  if (flags & FLAG_RELU) *mask = make_uint2(bits[0], bits[1]);
}

// The per-tile partials of the head that an F_LAYER feeds (head_nout
// channels at `plane`, staged in dsm), from the rounded activation in the
// tile after the barrier that follows the epilogue: each (row block sp of
// BM / WM rows, column c) pair sums its rows, act[row][c] * dp[q][row] into
// red[sp][q][c] and dp[q][row] into red_db[sp][q]. Every thread takes a
// pair; nothing is held in registers across the epilogue.
template <typename T>
__device__ __forceinline__ void head_partials_tile(const BOp& op, const BProgram& p,
                                                   const Tiles<T>& s, const float* dsm, float* red,
                                                   int tid) {
  constexpr int BM = Block<T>::BM, WM = Traits<T>::WM, kRows = BM / WM;
  const int n = op.n, hn = op.head_nout, act_ld = p.act_ld;
  for (int pr = tid; pr < WM * n; pr += Block<T>::kThreads) {
    const int sp = pr / n, c = pr - sp * n;
    float sw[kMaxHead], sb[kMaxHead];
#pragma unroll
    for (int q = 0; q < kMaxHead; ++q) sw[q] = sb[q] = 0.f;
    const T* a = s.act + sp * kRows * act_ld + c;
    const float* d = dsm + sp * kRows;
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float v = to_float(a[r * act_ld]);
#pragma unroll
      for (int q = 0; q < kMaxHead; ++q) {
        if (q >= hn) break;
        const float dq = d[q * BM + r];
        sw[q] += v * dq;
        sb[q] += dq;
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxHead; ++q) {
      if (q >= hn) break;
      red[(sp * kMaxHead + q) * 256 + c] = sw[q];
      if (c == 0) red[WM * kMaxHead * 256 + sp * kMaxHead + q] = sb[q];
    }
  }
}

// After head_partials_tile and a barrier: the head's per-tile partials,
// dW[q][c] at `part` and db[q] at `part2`, the row blocks' sums added in order.
template <typename T>
__device__ __forceinline__ void head_partials(const BOp& op, const float* red, float* part, int tid) {
  constexpr int WM = Traits<T>::WM;
  const int n = op.n, hn = op.head_nout;
  for (int i = tid; i < hn * n; i += Block<T>::kThreads) {
    const int q = i / n, c = i - q * n;
    float sum = 0.f;
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) sum += red[(wm * kMaxHead + q) * 256 + c];
    part[op.part + i] = sum;
  }
  if (tid < hn) {
    float sum = 0.f;
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) sum += red[WM * kMaxHead * 256 + wm * kMaxHead + tid];
    part[op.part2 + tid] = sum;
  }
}

// acc += the head's contribution sum_q dp[q][row] * wt[q][col] (dp staged in dsm).
template <typename T>
__device__ __forceinline__ void add_head(float (&acc)[Traits<T>::MT][kNT][4], const BOp& op,
                                         const float* __restrict__ fpar, const float* dsm, int tid) {
  constexpr int MT = Traits<T>::MT, BM = Block<T>::BM;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int g = lane >> 2, t = lane & 3;
  const int n = op.gn, hn = op.head_nout;
  const float* hw = fpar + op.head_w_off;
  const float* drow = dsm + warp_m * MT * 16 + g;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = (warp_n + kWarpsN * j) * 8 + 2 * t;
    if (col >= n) continue;
    float w0[kMaxHead], w1[kMaxHead];
#pragma unroll
    for (int q = 0; q < kMaxHead; ++q) {
      w0[q] = q < hn ? hw[q * n + col] : 0.f;
      w1[q] = q < hn ? hw[q * n + col + 1] : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float h0 = 0.f, h1 = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxHead; ++q) {
          const float dq = drow[q * BM + mt * 16 + 8 * h];
          h0 += dq * w0[q];
          h1 += dq * w1[q];
        }
        acc[mt][j][2 * h] += h0;
        acc[mt][j][2 * h + 1] += h1;
      }
  }
}

// B_LAYER's epilogue: g from acc (the head's contribution already added),
// into the tile (rounded) and g32; the warp's column sums of g into
// red[warp_m][col]. With RELU g takes the mask bits `mk` that this thread
// packed in the layer's F_LAYER: it holds the same fragment elements of a
// layer of the same width.
template <typename T>
__device__ __forceinline__ void backward_epilogue(const float (&acc)[Traits<T>::MT][kNT][4],
                                                  const BOp& op, const BProgram& p,
                                                  const Tiles<T>& s, float* g32, float* red,
                                                  uint2 mk, int row0, int tid) {
  constexpr int MT = Traits<T>::MT;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int wrow = warp_m * MT * 16;
  const int g = lane >> 2, t = lane & 3;
  const int n = op.gn, flags = op.flags, n_rows = p.n_rows, act_ld = p.act_ld;
  float* g32p = op.g32_slot >= 0 ? g32 + (size_t)op.g32_slot * n_rows * n : nullptr;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = (warp_n + kWarpsN * j) * 8 + 2 * t;
    if (col >= n) continue;  // uniform across the warp: n is a multiple of 16
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wrow + mt * 16 + g + 8 * h;
        const int gr = row0 + r;
        float v0 = 0.f, v1 = 0.f;
        if (gr < n_rows) {
          v0 = acc[mt][j][2 * h];
          v1 = acc[mt][j][2 * h + 1];
          if (flags & FLAG_RELU) {
            const uint32_t w = j < 4 ? mk.x : mk.y;
            const int b = mask_bit(j, mt, h);
            if (!((w >> b) & 1u)) v0 = 0.f;
            if (!((w >> (b + 1)) & 1u)) v1 = 0.f;
          }
          if (g32p)  // streaming, as the stash
            __stcs(reinterpret_cast<float2*>(g32p + (size_t)gr * n + col), make_float2(v0, v1));
        }
        store2(s.act + r * act_ld + col, v0, v1);
        s0 += v0;
        s1 += v1;
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (g == 0) {
      red[warp_m * 256 + col] = s0;
      red[warp_m * 256 + col + 1] = s1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Block<T>::kThreads, 1)
fused_mlp_bwd_rows_kernel(const __grid_constant__ BProgram p, const T* __restrict__ lo,
                          const T* __restrict__ hi, const float* __restrict__ hvx,
                          const float* __restrict__ dplanes, const T* __restrict__ wts,
                          const float* __restrict__ fpar, T* stash, float* g32, uint2* masks,
                          float* parts) {
  constexpr int BM = Block<T>::BM;
  constexpr int WM = Traits<T>::WM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<T> s;
  float* red = reinterpret_cast<float*>(carve_tiles(s, smem_raw, p));
  float* dsm = red + WM * kMaxHead * (256 + 1);  // a head's dp rows (stage_head_rows)

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int n_rows = p.n_rows;
  float* part = parts + (size_t)blockIdx.x * p.part_w;
  Cursor cur;
  start_ring(s, wts, p, cur, tid);
  load_tile(s.lo, p.lo_ld, p.lo_kpad, lo, p.in_lo, row0, BM, n_rows, tid);
  if (p.in_hi > 0) load_tile(s.hi, p.hi_ld, p.hi_kpad, hi, p.in_hi, row0, BM, n_rows, tid);

  // This block's mask words: [mask_slot][thread]. Each thread reads back only
  // the words it wrote (program order: no barrier, no fence); plain loads,
  // as the kernel writes them.
  uint2* tile_masks = masks + (size_t)blockIdx.x * p.n_masks * Block<T>::kThreads + tid;
  uint2 mk = make_uint2(0u, 0u);  // the next ReLU B_LAYER's words, loaded ahead of its epilogue
  auto load_next_mask = [&](int i) {
    if (i < p.n_ops && p.op(i).kind == B_LAYER && (p.op(i).flags & FLAG_RELU))
      mk = tile_masks[p.op(i).mask_slot * Block<T>::kThreads];
  };

  int it = 0;  // slabs consumed so far
  float acc[Traits<T>::MT][kNT][4];
  for (int i = 0; i < p.n_ops; ++i) {
    const BOp& op = p.op(i);
    const int kind = op.kind;
    if (kind == F_IN) {
      __syncthreads();  // the input tiles are loaded
      int ld;
      const T* tile = source(s, p, op.src[0], &ld);
      copy_tile_out(tile, ld, op.gn, slot_ptr(stash, op.out_slot, n_rows), row0, n_rows, tid);
    } else if (kind == F_LAYER) {
      const bool head = op.head_nout > 0;
      if (head) stage_head_rows<T>(op, p, dplanes, dsm, row0, tid);  // read after the product
      op_product(acc, op, p, s, wts, cur, it, tid);
      uint2* mask = tile_masks + op.mask_slot * Block<T>::kThreads;
      recompute_epilogue(acc, op, p, s, fpar, hvx, mask, row0, tid);
      load_next_mask(i + 1);
      __syncthreads();
      copy_tile_out(s.act, p.act_ld, op.n, slot_ptr(stash, op.out_slot, n_rows), row0, n_rows, tid);
      if (head) {
        head_partials_tile<T>(op, p, s, dsm, red, tid);
        __syncthreads();
        head_partials<T>(op, red, part, tid);
      }
    } else {
      if (op.head_nout > 0) stage_head_rows<T>(op, p, dplanes, dsm, row0, tid);
      __syncthreads();  // every warp is done with the tile and with red; dsm is staged
      if (op.flags & FLAG_ZERO) {
#pragma unroll
        for (int mt = 0; mt < Traits<T>::MT; ++mt)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
      }
      if (op.head_nout > 0) add_head<T>(acc, op, fpar, dsm, tid);
      backward_epilogue(acc, op, p, s, g32, red, mk, row0, tid);
      load_next_mask(i + 1);
      __syncthreads();
      const int gn = op.gn;
      copy_tile_out(s.act, p.act_ld, gn, slot_ptr(stash, op.out_slot, n_rows), row0, n_rows, tid);
      for (int c = tid; c < gn; c += Block<T>::kThreads) {
        float sum = 0.f;
#pragma unroll
        for (int wm = 0; wm < WM; ++wm) sum += red[wm * 256 + c];
        part[op.part + c] = sum;
      }
      if (op.nseg > 0) op_product(acc, op, p, s, wts, cur, it, tid);
    }
  }
}

// Float32 weight pass: rows of the chunk in stages of KC, double-buffered by
// cp.async (the bf16 weight pass is fused_mlp_bwd_wgrad_kernel).
template <typename T> struct WTraits;
template <> struct WTraits<float> { static constexpr int KC = 16; };
constexpr int kWTile = 128, kWThreads = 256;

template <typename T>
__device__ __forceinline__ void load_stage(T* dst, int ld, const T* src, int width, int c0, int r0,
                                           int r_end, int tid) {
  constexpr int kElems = 16 / sizeof(T), kPerRow = kWTile / kElems;
  constexpr int KC = WTraits<T>::KC;
  for (int i = tid; i < KC * kPerRow; i += kWThreads) {
    const int rr = i / kPerRow, q = i - rr * kPerRow;
    const int r = r0 + rr, c = c0 + q * kElems;
    T* d = dst + rr * ld + q * kElems;
    if (r < r_end && c < width)
      cp_async16(d, src + (size_t)r * width + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// acc[mt][jt] += A_stage^T G_stage for the warp's 32 x 64 part of the tile.
__device__ __forceinline__ void stage_product(float (&acc)[2][8][4], const float* a,
                                              const float* gm, int ld, int warp_m, int warp_n,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < WTraits<float>::KC; ++k) {
    float av[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      av[mt][0] = a[k * ld + warp_m * 32 + mt * 16 + g];
      av[mt][1] = a[k * ld + warp_m * 32 + mt * 16 + g + 8];
    }
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const float b0 = gm[k * ld + warp_n * 64 + jt * 8 + 2 * t];
      const float b1 = gm[k * ld + warp_n * 64 + jt * 8 + 2 * t + 1];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[mt][jt][0] = fmaf(av[mt][0], b0, acc[mt][jt][0]);
        acc[mt][jt][1] = fmaf(av[mt][0], b1, acc[mt][jt][1]);
        acc[mt][jt][2] = fmaf(av[mt][1], b0, acc[mt][jt][2]);
        acc[mt][jt][3] = fmaf(av[mt][1], b1, acc[mt][jt][3]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWThreads)
fused_mlp_bwd_weights_kernel(const Task* __restrict__ tasks, const T* __restrict__ stash,
                             int n_rows, int chunk_rows, int dw_total, float* __restrict__ dw_part) {
  constexpr int KC = WTraits<T>::KC, LD = kWTile + 16 / sizeof(T);
  __shared__ __align__(16) T sa[2][KC * LD];
  __shared__ __align__(16) T sg[2][KC * LD];
  const Task task = tasks[blockIdx.x];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp >> 1, warp_n = warp & 1;
  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(n_rows, r_begin + chunk_rows);
  const T* a = slot_ptr(stash, task.a_slot, n_rows);
  const T* gm = slot_ptr(stash, task.g_slot, n_rows);

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][jt][e] = 0.f;

  const int n_steps = r_end > r_begin ? (r_end - r_begin + KC - 1) / KC : 0;
  if (n_steps > 0) {
    load_stage(sa[0], LD, a, task.a_w, task.i0, r_begin, r_end, tid);
    load_stage(sg[0], LD, gm, task.g_w, task.j0, r_begin, r_end, tid);
    cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < n_steps) {
      const int r0 = r_begin + (step + 1) * KC;
      load_stage(sa[buf ^ 1], LD, a, task.a_w, task.i0, r0, r_end, tid);
      load_stage(sg[buf ^ 1], LD, gm, task.g_w, task.j0, r0, r_end, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    stage_product(acc, sa[buf], sg[buf], LD, warp_m, warp_n, lane);
    __syncthreads();  // the buffer is free for the stage after next
  }

  const int g = lane >> 2, t = lane & 3;
  float* out = dw_part + (size_t)blockIdx.y * dw_total + task.dw_off;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = task.i0 + warp_m * 32 + mt * 16 + g + 8 * h;
        const int j = task.j0 + warp_n * 64 + jt * 8 + 2 * t;
        if (i >= task.k_in) continue;
        if (j < task.n_out) out[(size_t)i * task.n_out + j] = acc[mt][jt][2 * h];
        if (j + 1 < task.n_out) out[(size_t)i * task.n_out + j + 1] = acc[mt][jt][2 * h + 1];
      }
}

// The first `slices` ranges of `per` rows of in[s] (rows C floats apart),
// each summed in row order: out[s][slice][c]. Thread t takes V columns of
// one (slice, s), t = (slice * S + s) * (C / V) + column group, so a warp
// reads consecutive columns.
template <int V>
__global__ void colsum_kernel(const float* __restrict__ in, float* __restrict__ out, int S, int L,
                              int C, int slices, int per) {
  using Vec = typename std::conditional<V == 4, float4, float>::type;
  const int groups = C / V;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)slices * S * groups) return;
  const int g = static_cast<int>(t % groups);
  const long long rest = t / groups;
  const int s = static_cast<int>(rest % S), sl = static_cast<int>(rest / S);
  const int i0 = sl * per, i1 = min(L, i0 + per);
  const Vec* src = reinterpret_cast<const Vec*>(in + ((size_t)s * L + i0) * C) + g;
  const size_t step = C / V;
  if constexpr (V == 4) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = i0; i < i1; ++i, src += step) {
      const float4 v = __ldcs(src);  // read once: streaming
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    reinterpret_cast<float4*>(out + ((size_t)s * slices + sl) * C)[g] = sum;
  } else {
    float sum = 0.f;
    for (int i = i0; i < i1; ++i, src += step) sum += __ldcs(src);
    out[((size_t)s * slices + sl) * C + g] = sum;
  }
}

int colsum_launch(const float* in, float* out, int S, int L, int C, int slices, int per,
                  cudaStream_t stream) {
  const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const long long threads = (long long)slices * S * (vec ? C / 4 : C);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  if (vec)
    colsum_kernel<4><<<blocks, 256, 0, stream>>>(in, out, S, L, C, slices, per);
  else
    colsum_kernel<1><<<blocks, 256, 0, stream>>>(in, out, S, L, C, slices, per);
  return static_cast<int>(cudaGetLastError());
}

// out[s][c] = sum_{i < L} in[s][i][c] in a fixed order: with slices > 1 the
// rows go in `slices` ranges of ceil(L / slices) rows, each summed in order
// into scratch (S x slices x C floats), then the slices in order.
int colsum(const float* in, float* out, int S, int L, int C, int slices, float* scratch,
           cudaStream_t stream) {
  if (S <= 0 || C <= 0) return 0;
  if (slices < 1 || (slices > 1 && (scratch == nullptr || L < slices)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (slices == 1) return colsum_launch(in, out, S, L, C, 1, L, stream);
  const int rc = colsum_launch(in, scratch, S, L, C, slices, (L + slices - 1) / slices, stream);
  if (rc) return rc;
  return colsum_launch(scratch, out, S, slices, C, 1, slices, stream);
}

// The weight pass's tensor maps: for each of n_maps stash slots, int64
// (element offset in the stash, width, n_rows, row stride in bytes) ->
// a CUtensorMap of dims (width, n_rows), 64 x 64 boxes, 128-byte swizzle,
// zeros past the dims, into `out`, the kernel's parameter.
// cuTensorMapEncodeTiled is reached through the runtime's driver entry
// point, so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

int encode_maps(const __nv_bfloat16* stash, const long long* maps, int n_maps, wgrad::Maps* out) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (n_maps > wgrad::kMaxMaps) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_maps; ++i) {
    const long long* m = maps + 4 * i;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m[1]), static_cast<cuuint64_t>(m[2])};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m[3])};
    const cuuint32_t box[2] = {wgrad::kBox, wgrad::kBox}, elem[2] = {1, 1};
    const CUresult r = encode(&out->map[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                              const_cast<__nv_bfloat16*>(stash + m[0]), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The bf16 weight pass: the maps, then one CTA per job (clusters of two).
int wgrad_launch(const void* stash, const long long* maps, int n_maps, const void* jobs, int n_jobs,
                 int n_rows, int chunk_rows, int dw_total, float* dw_part, cudaStream_t stream) {
  if (n_jobs <= 0) return 0;
  if (chunk_rows % wgrad::kBox) return static_cast<int>(cudaErrorInvalidValue);
  wgrad::Maps params;  // 16 KB; the launch copies it into the kernel's parameters
  int rc = encode_maps(static_cast<const __nv_bfloat16*>(stash), maps, n_maps, &params);
  if (rc) return rc;
  auto kernel = wgrad::fused_mlp_bwd_wgrad_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         wgrad::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n_jobs + 1) / 2 * 2, wgrad::kThreads, wgrad::kSmemBytes, stream>>>(
      static_cast<const wgrad::Job*>(jobs), n_jobs, params, n_rows, chunk_rows, dw_total, dw_part);
  return static_cast<int>(cudaGetLastError());
}

struct Buffers {
  const void *ops, *lo, *hi, *hvx, *dplanes, *wts, *fpar, *tasks;
  void *stash, *g32, *masks, *parts, *part_out, *dw_part, *dw_out, *dhvx;
  const long long* maps;  // bf16: the weight pass's tensor-map parameters (host)
  int n_maps;
  const int* slices;      // the three column sums' slices (host)
  void* scratch;          // the column sums' slice sums
};

template <typename T>
int launch(BProgram p, const Buffers& b, int n_tasks, int n_chunks, int chunk_rows, int dw_total,
           int n_hvx_rows, int smem, cudaStream_t stream) {
  constexpr int BM = Block<T>::BM;
  if (p.slab_k != Traits<T>::kSlabK) return static_cast<int>(cudaErrorInvalidValue);
  p.ops = static_cast<const BOp*>(b.ops);
  auto rows = fused_mlp_bwd_rows_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (p.n_rows + BM - 1) / BM;
  rows<<<n_tiles, Block<T>::kThreads, smem, stream>>>(
      p, static_cast<const T*>(b.lo), static_cast<const T*>(b.hi),
      static_cast<const float*>(b.hvx), static_cast<const float*>(b.dplanes),
      static_cast<const T*>(b.wts), static_cast<const float*>(b.fpar), static_cast<T*>(b.stash),
      static_cast<float*>(b.g32), static_cast<uint2*>(b.masks), static_cast<float*>(b.parts));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int rc = 0;
  if (std::is_same<T, __nv_bfloat16>::value) {
    rc = wgrad_launch(b.stash, b.maps, b.n_maps, b.tasks, n_tasks, p.n_rows, chunk_rows,
                      dw_total, static_cast<float*>(b.dw_part), stream);
  } else if (n_tasks > 0) {
    fused_mlp_bwd_weights_kernel<float><<<dim3(n_tasks, n_chunks), kWThreads, 0, stream>>>(
        static_cast<const Task*>(b.tasks), static_cast<const float*>(b.stash), p.n_rows,
        chunk_rows, dw_total, static_cast<float*>(b.dw_part));
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc) return rc;
  float* scratch = static_cast<float*>(b.scratch);
  rc = colsum(static_cast<const float*>(b.parts), static_cast<float*>(b.part_out), 1, n_tiles,
              p.part_w, b.slices[0], scratch, stream);
  if (rc) return rc;
  rc = colsum(static_cast<const float*>(b.dw_part), static_cast<float*>(b.dw_out), 1, n_chunks,
              dw_total, b.slices[1], scratch, stream);
  if (rc) return rc;
  return colsum(static_cast<const float*>(b.g32), static_cast<float*>(b.dhvx), n_hvx_rows, p.ns,
                p.hvx_w, b.slices[2], scratch, stream);
}

int run(int dtype, const int* header, int n_header, const Buffers& b, int n_tasks, int n_chunks,
        int chunk_rows, int dw_total, int n_hvx_rows, int smem, void* stream) {
  if (n_header != kBHeaderWords) return static_cast<int>(cudaErrorInvalidValue);
  BProgram p;
  memset(&p, 0, sizeof(p));
  memcpy(&p, header, sizeof(int) * kBHeaderWords);
  if (p.n_rows <= 0 || n_chunks <= 0 || chunk_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem, s);
  return launch<float>(p, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem, s);
}

}  // namespace

// dtype: 1 = bfloat16 operands, 0 = float32. header: the program header
// (16 ints, host memory); ops: a device array of BOp; tasks: of Task
// (float32) or wgrad::Job (bf16, n_tasks jobs).
// Workspace and outputs are allocated by the caller: stash (cdtype), g32,
// masks (n_tiles x n_masks x threads x 8 bytes), parts (n_tiles x part_w),
// dw_part (n_chunks x dw_total), the outputs part_out (part_w), dw_out
// (dw_total), dhvx (n_hvx_rows x hvx_w); for bf16 the tensor maps' host
// parameters `maps` (n_maps x 4 int64, n_maps <= wgrad::kMaxMaps); the
// column sums' slices (3 ints, host) and their scratch (the largest
// S x slices x C of the three where slices > 1).
extern "C" int snerf_fused_mlp_bwd(int dtype, const int* header, int n_header, const void* ops,
                                   const void* lo, const void* hi, const void* hvx,
                                   const void* dplanes, const void* wts, const void* fpar,
                                   const void* tasks, int n_tasks, int n_chunks, int chunk_rows,
                                   int dw_total, int n_hvx_rows, void* stash, void* g32,
                                   void* masks, void* parts, void* part_out, void* dw_part,
                                   void* dw_out, void* dhvx, const long long* maps, int n_maps,
                                   const int* slices, void* scratch, int smem, void* stream) {
  const Buffers b{ops,   lo,    hi,       hvx,     dplanes, wts,    fpar,   tasks,
                  stash, g32,   masks,    parts,   part_out, dw_part, dw_out, dhvx,
                  maps,  n_maps, slices,  scratch};
  return run(dtype, header, n_header, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem,
             stream);
}

// The ensemble: one program over the members and the one shared lo (no hi),
// hvx and dhvx stacked (n_hvx, n_rows / ns, Wv).
extern "C" int snerf_fused_mlp_ens_bwd(int dtype, const int* header, int n_header, const void* ops,
                                       const void* lo, const void* hvx, const void* dplanes,
                                       const void* wts, const void* fpar, const void* tasks,
                                       int n_tasks, int n_chunks, int chunk_rows, int dw_total,
                                       int n_hvx_rows, void* stash, void* g32, void* masks,
                                       void* parts, void* part_out, void* dw_part, void* dw_out,
                                       void* dhvx, const long long* maps, int n_maps,
                                       const int* slices, void* scratch, int smem, void* stream) {
  const Buffers b{ops,   lo,    nullptr,  hvx,     dplanes, wts,    fpar,   tasks,
                  stash, g32,   masks,    parts,   part_out, dw_part, dw_out, dhvx,
                  maps,  n_maps, slices,  scratch};
  return run(dtype, header, n_header, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem,
             stream);
}

// The bf16 weight pass alone, on a stash the caller filled, then the column
// sum of its partials over the chunks: dw_out (dw_total).
extern "C" int snerf_wgrad(const void* stash, const long long* maps, int n_maps, const void* jobs,
                           int n_jobs, int n_rows, int chunk_rows, int n_chunks, int dw_total,
                           void* dw_part, void* dw_out, int slices, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = wgrad_launch(stash, maps, n_maps, jobs, n_jobs, n_rows, chunk_rows,
                              dw_total, static_cast<float*>(dw_part), s);
  if (rc) return rc;
  return colsum(static_cast<const float*>(dw_part), static_cast<float*>(dw_out), 1, n_chunks,
                dw_total, slices, static_cast<float*>(scratch), s);
}

// out[s][c] = sum_{i < L} in[s][i][c] (in: S x L x C floats), the column
// sums of the backward alone.
extern "C" int snerf_colsum(const void* in, void* out, int S, int L, int C, int slices,
                            void* scratch, void* stream) {
  return colsum(static_cast<const float*>(in), static_cast<float*>(out), S, L, C, slices,
                static_cast<float*>(scratch), static_cast<cudaStream_t>(stream));
}
