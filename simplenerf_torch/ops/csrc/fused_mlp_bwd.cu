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
//       stashed in device memory. Then the layers are walked backward:
//       g = dh * [h > 0] in float32 (the mask on the stashed activation,
//       copied back into the shared tile first),
//       its per-tile column sum (db) and the heads' per-tile dW and db go to
//       a partials row of the tile, round(g) is stored in the shared tile
//       and stashed, and dh_prev = round(g) @ W^T runs on the tensor cores
//       with the weight stored (K, N) streaming through the same ring. The
//       views layer 0's float32 g is kept for dhvx.
//   (b) weight pass, one block per 128x128 tile of one dW and chunk of rows:
//       dW = round(h_prev)^T @ round(g) over the chunk, both operands from
//       the stash (ldmatrix.trans fragments, mma.sync, float32 accumulators;
//       float32 operands as plain FMAs), into a partials row per chunk;
//   (c) fixed-order column sums: partials over tiles, dW partials over
//       chunks, and g over each ray's ns rows (dhvx).
// Every product rounds its operands to the compute type and accumulates in
// float32, as the TPU kernel's products do, so storing round(g) loses
// nothing. What bounds this design on the card (PERF.md): the stash, about
// 2 x 4.9 KB per point in bf16 for the published MLP, written once and read
// by the weight pass once per 128-wide output tile.
//
// Plain C interface (ctypes): snerf_fused_mlp_bwd and snerf_fused_mlp_ens_bwd
// return the first CUDA error of their launches, 0 on success.

#include "fused_mlp_common.cuh"

namespace {

enum { F_IN = 0, F_LAYER = 1, B_HEAD = 2, B_LAYER = 3 };

// One step of the backward program (24 ints; built by ops/fused_mlp.py).
// The first 16 ints mean what they mean in the forward kernel's Op.
//   F_IN:    stash[out_slot] = the src[0] tile (gn columns).
//   F_LAYER: a forward layer; its activation (n columns) also to stash[out_slot].
//   B_HEAD:  partials: dW[j][k] = sum_rows stash[mask_slot][row][k] * dp[plane + j][row]
//            at `part`, db[j] = sum_rows dp[plane + j][row] at `part2`.
//   B_LAYER: g = ([ZERO] ? 0 : acc) [+ sum_j dp[plane + j] * fpar[head_w_off + j*gn + c]],
//            times [stash[mask_slot] > 0] when RELU; db partial at `part`; round(g)
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
  int part_w, hvx_w;
  const BOp* ops;
  __device__ __forceinline__ const BOp& op(int i) const { return ops[i]; }
};
constexpr int kBHeaderWords = 15;

// Weight-pass task: the 128x128 tile (i0, j0) of dW (k_in, n_out) = A^T G,
// A = stash slot a_slot (width a_w), G = stash slot g_slot (width g_w).
struct Task {
  int a_slot, a_w, g_slot, g_w, k_in, n_out, dw_off, i0, j0;
};
constexpr int kTaskWords = 9;
static_assert(sizeof(Task) == kTaskWords * sizeof(int), "Task layout");

template <typename T>
__device__ __forceinline__ T* slot_ptr(T* stash, int slot, int n_rows) {
  return stash + (size_t)slot * n_rows;
}

// Tile rows (ld apart) -> a stash slot of `width` columns, 16 bytes at a time.
template <typename T>
__device__ void copy_tile_out(const T* tile, int ld, int width, T* dst, int row0, int n_rows,
                              int tid) {
  constexpr int kElems = 16 / sizeof(T);
  const int per_row = width / kElems, total = Block<T>::BM * per_row;
  for (int i = tid; i < total; i += Block<T>::kThreads) {
    const int r = i / per_row, q = i - r * per_row;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * width + q * kElems) =
          *reinterpret_cast<const uint4*>(tile + r * ld + q * kElems);
  }
}

// Stash slot rows of `width` columns -> tile rows (ld apart), 16 bytes at a time.
template <typename T>
__device__ void copy_tile_in(T* tile, int ld, int width, const T* src, int row0, int n_rows,
                             int tid) {
  constexpr int kElems = 16 / sizeof(T);
  const int per_row = width / kElems, total = Block<T>::BM * per_row;
  for (int i = tid; i < total; i += Block<T>::kThreads) {
    const int r = i / per_row, q = i - r * per_row;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(tile + r * ld + q * kElems) =
          *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * width + q * kElems);
  }
}

// B_HEAD: the head's per-tile dW and db partials, in float32.
template <typename T>
__device__ void head_partials(const BOp& op, const BProgram& p, const T* stash,
                              const float* __restrict__ dplanes, float* part, int row0, int tid) {
  constexpr int BM = Block<T>::BM;
  const int n_rows = p.n_rows, k = op.gn, hn = op.head_nout;
  const T* act = slot_ptr(stash, op.mask_slot, n_rows);
  const float* dp = dplanes + (size_t)op.plane * n_rows;
  const int rows = min(BM, n_rows - row0);
  for (int c = tid; c < k; c += Block<T>::kThreads) {
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < rows; ++r) {
      const float hv = to_float(act[(size_t)(row0 + r) * k + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < hn) sum[j] += hv * dp[(size_t)j * n_rows + row0 + r];
    }
    for (int j = 0; j < hn; ++j) part[op.part + j * k + c] = sum[j];
  }
  for (int j = tid; j < hn; j += Block<T>::kThreads) {
    float sum = 0.f;
    for (int r = 0; r < rows; ++r) sum += dp[(size_t)j * n_rows + row0 + r];
    part[op.part2 + j] = sum;
  }
}

// B_LAYER's epilogue: g from acc, into the tile (rounded) and g32; the
// warp's column sums of g into red[warp_m][col]. With RELU the tile holds
// this layer's stashed activation on entry: each element's mask is read
// by the thread that then overwrites it with g.
template <typename T>
__device__ __forceinline__ void backward_epilogue(const float (&acc)[Traits<T>::MT][kNT][4],
                                                  const BOp& op, const BProgram& p,
                                                  const Tiles<T>& s, const float* __restrict__ fpar,
                                                  const float* __restrict__ dplanes,
                                                  float* g32, float* red, int row0, int tid) {
  constexpr int MT = Traits<T>::MT;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int wrow = warp_m * MT * 16;
  const int g = lane >> 2, t = lane & 3;
  const int n = op.gn, flags = op.flags, n_rows = p.n_rows, act_ld = p.act_ld;
  const int hn = op.head_nout;
  const float* hw = fpar + op.head_w_off;
  const float* dp = dplanes + (size_t)(hn > 0 ? op.plane : 0) * n_rows;
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
          float h0 = 0.f, h1 = 0.f;
          for (int q = 0; q < hn; ++q) {
            const float d = dp[(size_t)q * n_rows + gr];
            h0 += d * hw[q * n + col];
            h1 += d * hw[q * n + col + 1];
          }
          if (flags & FLAG_ZERO) {
            v0 = h0;
            v1 = h1;
          } else {
            v0 = acc[mt][j][2 * h] + h0;
            v1 = acc[mt][j][2 * h + 1] + h1;
          }
          if (flags & FLAG_RELU) {
            const float2 hv = load2(s.act + r * act_ld + col);
            if (!(hv.x > 0.f)) v0 = 0.f;
            if (!(hv.y > 0.f)) v1 = 0.f;
          }
          if (g32p) store2(g32p + (size_t)gr * n + col, v0, v1);
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
                          const float* __restrict__ fpar, T* stash, float* g32, float* parts) {
  constexpr int BM = Block<T>::BM;
  constexpr int WM = Traits<T>::WM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<T> s;
  float* red = reinterpret_cast<float*>(carve_tiles(s, smem_raw, p));

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int n_rows = p.n_rows;
  float* part = parts + (size_t)blockIdx.x * p.part_w;
  Cursor cur;
  start_ring(s, wts, p, cur, tid);
  load_tile(s.lo, p.lo_ld, p.lo_kpad, lo, p.in_lo, row0, BM, n_rows, tid);
  if (p.in_hi > 0) load_tile(s.hi, p.hi_ld, p.hi_kpad, hi, p.in_hi, row0, BM, n_rows, tid);

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
      op_product(acc, op, p, s, wts, cur, it, tid);
      forward_epilogue(acc, op, p, s, fpar, hvx, row0, tid);
      __syncthreads();
      copy_tile_out(s.act, p.act_ld, op.n, slot_ptr(stash, op.out_slot, n_rows), row0, n_rows, tid);
    } else if (kind == B_HEAD) {
      __syncthreads();  // the stashed activation is written
      head_partials(op, p, stash, dplanes, part, row0, tid);
    } else {
      __syncthreads();  // every warp is done with the tile and with red
      if (op.flags & FLAG_RELU) {  // the activation whose mask g takes
        copy_tile_in(s.act, p.act_ld, op.gn, slot_ptr(stash, op.mask_slot, n_rows), row0, n_rows,
                     tid);
        __syncthreads();
      }
      backward_epilogue(acc, op, p, s, fpar, dplanes, g32, red, row0, tid);
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

// Weight pass: rows of the chunk in stages of KC, double-buffered by cp.async.
template <typename T> struct WTraits;
template <> struct WTraits<__nv_bfloat16> { static constexpr int KC = 32; };
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
__device__ __forceinline__ void stage_product(float (&acc)[2][8][4], const __nv_bfloat16* a,
                                              const __nv_bfloat16* gm, int ld, int warp_m,
                                              int warp_n, int lane) {
  const int r8 = lane & 7, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < WTraits<__nv_bfloat16>::KC; kk += 16) {
    uint32_t af[2][4], bf[4][4];
    // A^T fragments from A stored (rows, i): matrix mi covers i + (mi & 1) * 8,
    // rows kk + (mi >> 1) * 8; transposed on load.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4_trans(af[mt], a + (kk + (mi >> 1) * 8 + r8) * ld + warp_m * 32 + mt * 16 +
                                    (mi & 1) * 8);
    // G fragments from G stored (rows, j): matrix mi covers rows kk + (mi & 1) * 8,
    // columns j + (mi >> 1) * 8 (two n8 tiles).
#pragma unroll
    for (int jp = 0; jp < 4; ++jp)
      ldmatrix_x4_trans(bf[jp], gm + (kk + (mi & 1) * 8 + r8) * ld + warp_n * 64 + jp * 16 +
                                    (mi >> 1) * 8);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        mma_bf16(acc[mt][2 * jp], af[mt], bf[jp][0], bf[jp][1]);
        mma_bf16(acc[mt][2 * jp + 1], af[mt], bf[jp][2], bf[jp][3]);
      }
  }
}

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

// out[s][c] = sum_{i < L} in[s][i][c], i in order.
__global__ void colsum_kernel(const float* __restrict__ in, float* __restrict__ out, int S, int L,
                              int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const float* src = in + (size_t)s * L * C + c;
    float sum = 0.f;
    for (int i = 0; i < L; ++i) sum += src[(size_t)i * C];
    out[(size_t)s * C + c] = sum;
  }
}

int colsum(const float* in, float* out, int S, int L, int C, cudaStream_t stream) {
  if (S <= 0 || C <= 0) return 0;
  const dim3 grid((C + 255) / 256, min(S, 65535));
  colsum_kernel<<<grid, 256, 0, stream>>>(in, out, S, L, C);
  return static_cast<int>(cudaGetLastError());
}

struct Buffers {
  const void *ops, *lo, *hi, *hvx, *dplanes, *wts, *fpar, *tasks;
  void *stash, *g32, *parts, *part_out, *dw_part, *dw_out, *dhvx;
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
      static_cast<float*>(b.g32), static_cast<float*>(b.parts));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (n_tasks > 0) {
    fused_mlp_bwd_weights_kernel<T><<<dim3(n_tasks, n_chunks), kWThreads, 0, stream>>>(
        static_cast<const Task*>(b.tasks), static_cast<const T*>(b.stash), p.n_rows, chunk_rows,
        dw_total, static_cast<float*>(b.dw_part));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  int rc = colsum(static_cast<const float*>(b.parts), static_cast<float*>(b.part_out), 1, n_tiles,
                  p.part_w, stream);
  if (rc) return rc;
  rc = colsum(static_cast<const float*>(b.dw_part), static_cast<float*>(b.dw_out), 1, n_chunks,
              dw_total, stream);
  if (rc) return rc;
  return colsum(static_cast<const float*>(b.g32), static_cast<float*>(b.dhvx), n_hvx_rows, p.ns,
                p.hvx_w, stream);
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
// (15 ints, host memory); ops and tasks: device arrays of BOp and Task.
// Workspace and outputs are allocated by the caller: stash (cdtype), g32,
// parts (n_tiles x part_w), dw_part (n_chunks x dw_total) and the outputs
// part_out (part_w), dw_out (dw_total), dhvx (n_hvx_rows x hvx_w).
extern "C" int snerf_fused_mlp_bwd(int dtype, const int* header, int n_header, const void* ops,
                                   const void* lo, const void* hi, const void* hvx,
                                   const void* dplanes, const void* wts, const void* fpar,
                                   const void* tasks, int n_tasks, int n_chunks, int chunk_rows,
                                   int dw_total, int n_hvx_rows, void* stash, void* g32,
                                   void* parts, void* part_out, void* dw_part, void* dw_out,
                                   void* dhvx, int smem, void* stream) {
  const Buffers b{ops, lo, hi, hvx, dplanes, wts, fpar, tasks,
                  stash, g32, parts, part_out, dw_part, dw_out, dhvx};
  return run(dtype, header, n_header, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem,
             stream);
}

// The ensemble: one program over the members and the one shared lo (no hi),
// hvx and dhvx stacked (n_hvx, n_rows / ns, Wv).
extern "C" int snerf_fused_mlp_ens_bwd(int dtype, const int* header, int n_header, const void* ops,
                                       const void* lo, const void* hvx, const void* dplanes,
                                       const void* wts, const void* fpar, const void* tasks,
                                       int n_tasks, int n_chunks, int chunk_rows, int dw_total,
                                       int n_hvx_rows, void* stash, void* g32, void* parts,
                                       void* part_out, void* dw_part, void* dw_out, void* dhvx,
                                       int smem, void* stream) {
  const Buffers b{ops, lo, nullptr, hvx, dplanes, wts, fpar, tasks,
                  stash, g32, parts, part_out, dw_part, dw_out, dhvx};
  return run(dtype, header, n_header, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem,
             stream);
}
