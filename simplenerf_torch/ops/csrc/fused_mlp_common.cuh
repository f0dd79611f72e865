// Device code of the float32 fused MLP kernels for Hopper (sm_90a):
// fused_mlp_fwd.cu (forward, single MLP and ensemble) and fused_mlp_bwd.cu
// (backward's row pass, single MLP and ensemble). The bf16 kernels run on
// wgmma: fused_mlp_sm90.cuh (forward), fused_mlp_bwd_sm90.cuh (the
// backward's row pass), fused_mlp_wgrad_sm90.cuh (its weight pass).
//
// A kernel walks a program of ops built by simplenerf_torch/ops/fused_mlp.py.
// An op that multiplies reads up to three shared-memory tiles of the block's
// rows (the activation tile, the lo tile, the hi tile), each against a
// weight stored transposed as (n, kpad) rows in one weight buffer; the
// weights stream through a ring of K-slabs filled by cp.async. The ring runs
// on across ops, so the next op's first slabs load during this op's last
// ones. Products run as plain FMAs (no TF32, which would break float32
// parity).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarpsN = 4;   // column groups of warps
constexpr int kNT = 8;       // n8 tiles per warp: 4 column groups x 8 x 8 = 256 columns
constexpr int kStages = 3;   // weight slabs in flight
constexpr int kMaxSeg = 3;

enum { SRC_ACT = 0, SRC_LO = 1, SRC_HI = 2 };
enum { FLAG_RELU = 1, FLAG_HVX = 2, FLAG_ZERO = 4 };

// Per operand type: m16 tiles per warp (MT), row groups of warps (WM),
// slab depth; a block is WM x kWarpsN warps over BM = 16 * MT * WM rows.
template <typename T> struct Traits;
template <> struct Traits<float> { static constexpr int MT = 2, WM = 2, kSlabK = 32; };
template <typename T> struct Block {
  static constexpr int kThreads = 32 * Traits<T>::WM * kWarpsN;
  static constexpr int BM = 16 * Traits<T>::MT * Traits<T>::WM;
};

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T zero_val();
template <> __device__ __forceinline__ float zero_val<float>() { return 0.f; }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int MT>
__device__ __forceinline__ void slab_product(float (&acc)[MT][kNT][4], const float* a, int lda,
                                             int ka0, const float* w, int ldw, int kc, int n,
                                             int warp_n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int k = 0; k < kc; ++k) {
    float av[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      av[mt][0] = a[(mt * 16 + g) * lda + ka0 + k];
      av[mt][1] = a[(mt * 16 + g + 8) * lda + ka0 + k];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int nt = warp_n + kWarpsN * j;
      if (nt * 8 < n) {
        const float b0 = w[(nt * 8 + 2 * t) * ldw + k];
        const float b1 = w[(nt * 8 + 2 * t + 1) * ldw + k];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          acc[mt][j][0] = fmaf(av[mt][0], b0, acc[mt][j][0]);
          acc[mt][j][1] = fmaf(av[mt][0], b1, acc[mt][j][1]);
          acc[mt][j][2] = fmaf(av[mt][1], b0, acc[mt][j][2]);
          acc[mt][j][3] = fmaf(av[mt][1], b1, acc[mt][j][3]);
        }
      }
    }
  }
}

// The ring's slabs are found by arithmetic, not through an array of
// pointers: indexing such an array with the running slab count puts it in
// local memory, and the kernels then spill (ptxas; PERF.md).
template <typename T>
struct Tiles {
  T* act;
  T* lo;
  T* hi;
  T* ring;          // kStages slabs, ring_stride elements apart
  int ring_stride;
  __device__ __forceinline__ T* slab(int i) const { return ring + i * ring_stride; }
};

// The tiles of a block in dynamic shared memory: act, lo, hi, then the
// slab ring; returns the first byte past them.
template <typename T, typename P>
__device__ __forceinline__ unsigned char* carve_tiles(Tiles<T>& s, unsigned char* base, const P& p) {
  constexpr int BM = Block<T>::BM;
  s.act = reinterpret_cast<T*>(base);
  s.lo = s.act + BM * p.act_ld;
  s.hi = s.lo + BM * p.lo_ld;
  s.ring = s.hi + BM * p.hi_ld;
  s.ring_stride = p.slab_rows * p.slab_ld;
  return reinterpret_cast<unsigned char*>(s.ring + kStages * s.ring_stride);
}

template <typename T, typename P>
__device__ __forceinline__ const T* source(const Tiles<T>& s, const P& p, int src, int* ld) {
  if (src == SRC_LO) { *ld = p.lo_ld; return s.lo; }
  if (src == SRC_HI) { *ld = p.hi_ld; return s.hi; }
  *ld = p.act_ld;
  return s.act;
}

// The producer's place in the stream of weight slabs: every op with
// segments (nseg > 0) in program order, each segment cut into slab_k-deep
// slabs.
struct Cursor {
  int op, seg, k0;
};

template <typename P>
__device__ __forceinline__ void skip_unweighted(const P& p, Cursor& c) {
  while (c.op < p.n_ops && p.op(c.op).nseg == 0) ++c.op;
}

template <typename P>
__device__ __forceinline__ void advance(const P& p, Cursor& c) {
  const auto& op = p.op(c.op);
  c.k0 += p.slab_k;
  if (c.k0 >= op.kpad[c.seg]) {
    c.k0 = 0;
    if (++c.seg >= op.nseg) {
      c.seg = 0;
      ++c.op;
      skip_unweighted(p, c);
    }
  }
}

// Start copying the cursor's slab, W_seg[:, k0:k0+kc] (stored (n, kpad)),
// into a shared slab (n, slab_ld); commit one cp.async group either way, so
// that every thread counts the same groups.
template <typename T, typename P>
__device__ __forceinline__ void issue_slab(T* dst, const T* wts, const P& p, Cursor& c, int tid) {
  if (c.op < p.n_ops) {
    constexpr int kElems = 16 / sizeof(T);                  // per 16-byte copy
    constexpr int kCopies = Traits<T>::kSlabK / kElems;     // per full slab row: 8
    const auto& op = p.op(c.op);
    const int kpad = op.kpad[c.seg], copies = op.n * kCopies, ld = p.slab_ld;
    const int per_row = min(p.slab_k, kpad - c.k0) / kElems;
    const T* src = wts + op.w_off[c.seg] + c.k0;
    for (int i = tid; i < copies; i += Block<T>::kThreads) {
      const int r = i / kCopies, q = i % kCopies;
      if (q < per_row) cp_async16(dst + r * ld + q * kElems, src + (size_t)r * kpad + q * kElems);
    }
    advance(p, c);
  }
  cp_async_commit();
}

template <typename T, typename P>
__device__ __forceinline__ void start_ring(const Tiles<T>& s, const T* wts, const P& p, Cursor& cur,
                                           int tid) {
  cur = Cursor{0, 0, 0};
  skip_unweighted(p, cur);
  for (int i = 0; i < kStages - 1; ++i) issue_slab(s.slab(i), wts, p, cur, tid);
}

// acc = sum over the op's segments of src_seg @ W_seg^T for the warp's rows
// and column tiles. Ends with every warp done reading the tiles.
template <typename T, typename P, typename OpT>
__device__ __forceinline__ void op_product(float (&acc)[Traits<T>::MT][kNT][4], const OpT& op, const P& p,
                           const Tiles<T>& s, const T* wts, Cursor& cur, int& it, int tid) {
  constexpr int MT = Traits<T>::MT;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int wrow = warp_m * MT * 16;  // the warp's first row in the tile
  const int n = op.n, nseg = op.nseg;
  const int slab_k = p.slab_k, slab_ld = p.slab_ld;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int seg = 0; seg < nseg; ++seg) {
    int lda;
    const T* tile = source(s, p, op.src[seg], &lda);
    const T* a = tile + wrow * lda;
    const int kpad = op.kpad[seg];
    for (int k0 = 0; k0 < kpad; k0 += slab_k, ++it) {
      // Slab `it` has landed once all but the newest kStages - 2 groups
      // have; the barrier then also frees the ring entry read at it - 1.
      cp_async_wait<kStages - 2>();
      __syncthreads();
      issue_slab(s.slab((it + kStages - 1) % kStages), wts, p, cur, tid);
      slab_product<MT>(acc, a, lda, k0, s.slab(it % kStages), slab_ld, min(slab_k, kpad - k0), n,
                       warp_n, lane);
    }
  }

  __syncthreads();  // every warp has read the tiles the epilogue may overwrite
}

// Forward epilogue: act = [ReLU](acc + bias [+ hvx]), rounded to T, into the
// activation tile. Per-ray `hvx` is read as hvx[slot][row / ns].
template <typename T, typename P, typename OpT>
__device__ __forceinline__ void forward_epilogue(const float (&acc)[Traits<T>::MT][kNT][4], const OpT& op,
                                 const P& p, const Tiles<T>& s, const float* __restrict__ fpar,
                                 const float* __restrict__ hvx, int row0, int tid) {
  constexpr int MT = Traits<T>::MT;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int wrow = warp_m * MT * 16;
  const int n = op.n, flags = op.flags, act_ld = p.act_ld;
  const int g = lane >> 2, t = lane & 3;
  const int n_rows = p.n_rows, ns = p.ns;
  const float* bias = fpar + op.b_off;
  if (flags & FLAG_HVX) hvx += (size_t)op.hvx_slot * (n_rows / ns) * n;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = (warp_n + kWarpsN * j) * 8 + 2 * t;
    if (col >= n) continue;
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
        }
        store2(s.act + r * act_ld + col, v0, v1);
      }
    }
  }
}

// Rows of `cols` values (not 16-byte aligned) into a tile padded to kpad;
// each thread issues a batch of loads before it stores any.
template <typename T>
__device__ void load_tile(T* dst, int ld, int kpad, const T* __restrict__ src, int cols, int row0,
                          int rows, int n_rows, int tid) {
  constexpr int kThreads = Block<T>::kThreads, kBatch = 8;
  const int total = rows * kpad;
  for (int i0 = tid; i0 < total; i0 += kBatch * kThreads) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / kpad, c = i - r * kpad;
      v[u] = i < total && row0 + r < n_rows && c < cols ? src[(size_t)(row0 + r) * cols + c]
                                                        : zero_val<T>();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads, r = i / kpad, c = i - r * kpad;
      if (i < total) dst[r * ld + c] = v[u];
    }
  }
}

}  // namespace
