// Fused NeRF field MLP forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of simplenerf_tpu/ops/fused_mlp.py
// (the Pallas forward behind `fused_apply`). One launch evaluates one field
// MLP over n_rows points and writes the raw linear head channels as
// float32 planes out[plane][row] (row = ray * ns + sample).
//
// What bounds it: arithmetic. The published 8x256 MLP does ~1.18 MFLOP per
// point against ~142 bytes of device-memory traffic per point in bf16, so
// the design keeps every activation on chip:
//   * a block (16 warps over 128 rows in bf16, 8 warps over 64 rows in f32;
//     4 column groups of warps) keeps its lo/hi inputs and one activation
//     tile in shared memory for the whole layer chain; a layer accumulates
//     in registers and overwrites the tile in place once every warp has
//     read its input;
//   * the weights do not fit in shared memory (about 1.2 MB in bf16), so
//     every layer's transposed weight (N, Kpad) streams through a 3-stage
//     ring of K-slabs (64 deep in bf16, 32 in f32) filled by cp.async. The
//     ring runs on across layers, so the next layer's first slabs load
//     during this layer's last ones. All blocks read the same weights,
//     which stay resident in the 50 MB L2; the 128-row tile sets the L2
//     traffic at 128 FLOP per weight byte;
//   * bf16 products run on the tensor cores with mma.sync.m16n8k16 and
//     float32 accumulators, their fragments loaded with ldmatrix.x4; the
//     float32 path runs plain FMAs over the same fragment layout (no TF32,
//     which would break float32 parity);
//   * a warp owns 32 rows and the n8 column tiles warp_n, warp_n + 4, ...,
//     so any width that is a multiple of 16 up to 256 works;
//   * heads are float32 warp reductions of the activation row against the
//     float32 head weight.
// What still bounds it (H100 80GB HBM3 at 700 W, PERF.md): the epilogues,
// heads and barriers run while the tensor cores wait, as one block fills
// an SM; warpgroup MMAs and overlapping them is later work.
// The ragged last block is masked: rows past n_rows read zeros and write
// nothing. Per-ray `hvx` is read as hvx[row / ns].
//
// Plain C interface (ctypes): snerf_fused_mlp_fwd returns the CUDA error of
// the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarpsN = 4;   // column groups of warps
constexpr int kNT = 8;       // n8 tiles per warp: 4 column groups x 8 x 8 = 256 columns
constexpr int kStages = 3;   // weight slabs in flight
constexpr int kMaxOps = 40;
constexpr int kMaxSeg = 3;

enum { OP_LAYER = 0, OP_HEAD = 1 };
enum { SRC_ACT = 0, SRC_LO = 1, SRC_HI = 2 };
enum { FLAG_RELU = 1, FLAG_HVX = 2 };

// Per operand type: m16 tiles per warp (MT), row groups of warps (WM),
// slab depth; a block is WM x kWarpsN warps over BM = 16 * MT * WM rows.
template <typename T> struct Traits;
template <> struct Traits<__nv_bfloat16> { static constexpr int MT = 2, WM = 4, kSlabK = 64; };
template <> struct Traits<float> { static constexpr int MT = 2, WM = 2, kSlabK = 32; };
template <typename T> struct Block {
  static constexpr int kThreads = 32 * Traits<T>::WM * kWarpsN;
  static constexpr int BM = 16 * Traits<T>::MT * Traits<T>::WM;
};

// One step of the layer program (16 ints; built by ops/fused_mlp.py).
// LAYER: act = f(sum_s src[s] @ W_s + bias [+ hvx]); W_s stored (n, kpad[s]).
// HEAD:  out[plane + j][row] = sum_k act[row][k] * fpar[w_off[0] + j*kpad[0] + k] + fpar[b_off + j].
struct Op {
  int kind, n, b_off, flags, nseg;
  int src[kMaxSeg];
  int w_off[kMaxSeg];
  int kpad[kMaxSeg];
  int plane, reserved;
};

struct Program {
  int n_ops, n_rows, ns, in_lo, in_hi, lo_kpad, hi_kpad;
  int act_ld, lo_ld, hi_ld, slab_ld, slab_rows, slab_k;
  Op ops[kMaxOps];
};

constexpr int kHeaderWords = 13;
static_assert(sizeof(Op) == 16 * sizeof(int), "Op layout");
static_assert(sizeof(Program) == (kHeaderWords + 16 * kMaxOps) * sizeof(int), "Program layout");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero_val();
template <> __device__ __forceinline__ float zero_val<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_val<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A[warp rows, ka0:ka0+kc] @ slab^T for the warp's column tiles.
// `a` points at the warp's first row; the slab holds W^T rows (n, ldw).
// Fragment ownership (m16n8 accumulator): lane holds rows g and g+8,
// columns 2t and 2t+1 of each tile (g = lane / 4, t = lane % 4).
template <int MT>
__device__ __forceinline__ void slab_product(float (&acc)[MT][kNT][4], const __nv_bfloat16* a,
                                             int lda, int ka0, const __nv_bfloat16* w, int ldw,
                                             int kc, int n, int warp_n, int lane) {
  // ldmatrix.x4 addresses: lane l feeds row (l % 8) of 8x8 matrix l / 8.
  // A: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
  // (rows 8-15, k 8-15) = fragment registers a0..a3.
  const int r8 = lane & 7, mi = lane >> 3;
  const __nv_bfloat16* a_lane = a + ((mi & 1) * 8 + r8) * lda + ka0 + (mi >> 1) * 8;
  // B: a pair of column tiles (nt0, nt1 = nt0 + 4): matrices (nt0, k 0-7),
  // (nt0, k 8-15), (nt1, k 0-7), (nt1, k 8-15) = b0, b1 of nt0 then of nt1.
  // Lanes of an nt1 past n read nt0's rows (in the slab) and are not used.
  const int k_half = (mi & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < Traits<__nv_bfloat16>::kSlabK; kk += 16) {
    if (kk >= kc) break;
    // Every fragment of the k-step is requested before the first product,
    // so the loads' latencies overlap.
    uint32_t af[MT][4], bf[kNT / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(af[mt], a_lane + mt * 16 * lda + kk);
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      const int nt0 = warp_n + kWarpsN * 2 * jp, nt1 = nt0 + kWarpsN;
      const int nt = (mi >> 1) && nt1 * 8 < n ? nt1 : nt0;
      if (nt0 * 8 < n) ldmatrix_x4(bf[jp], w + (nt * 8 + r8) * ldw + kk + k_half);
    }
#pragma unroll
    for (int jp = 0; jp < kNT / 2; ++jp) {
      const int nt0 = warp_n + kWarpsN * 2 * jp, nt1 = nt0 + kWarpsN;
      if (nt0 * 8 >= n) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][2 * jp], af[mt], bf[jp][0], bf[jp][1]);
      if (nt1 * 8 < n) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][2 * jp + 1], af[mt], bf[jp][2], bf[jp][3]);
      }
    }
  }
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

template <typename T>
struct Tiles {
  T* act;
  T* lo;
  T* hi;
  T* slab[kStages];
};

template <typename T>
__device__ __forceinline__ const T* source(const Tiles<T>& s, const Program& p, int src, int* ld) {
  if (src == SRC_LO) { *ld = p.lo_ld; return s.lo; }
  if (src == SRC_HI) { *ld = p.hi_ld; return s.hi; }
  *ld = p.act_ld;
  return s.act;
}

// The producer's place in the stream of weight slabs: every LAYER op's
// segments in program order, each cut into slab_k-deep slabs.
struct Cursor {
  int op, seg, k0;
};

__device__ __forceinline__ void skip_heads(const Program& p, Cursor& c) {
  while (c.op < p.n_ops && p.ops[c.op].kind != OP_LAYER) ++c.op;
}

__device__ __forceinline__ void advance(const Program& p, Cursor& c) {
  const Op& op = p.ops[c.op];
  c.k0 += p.slab_k;
  if (c.k0 >= op.kpad[c.seg]) {
    c.k0 = 0;
    if (++c.seg >= op.nseg) {
      c.seg = 0;
      ++c.op;
      skip_heads(p, c);
    }
  }
}

// Start copying the cursor's slab, W_seg[:, k0:k0+kc] (stored (n, kpad)),
// into a shared slab (n, slab_ld); commit one cp.async group either way, so
// that every thread counts the same groups.
template <typename T>
__device__ __forceinline__ void issue_slab(T* dst, const T* wts, const Program& p, Cursor& c,
                                           int tid) {
  if (c.op < p.n_ops) {
    constexpr int kElems = 16 / sizeof(T);                  // per 16-byte copy
    constexpr int kCopies = Traits<T>::kSlabK / kElems;     // per full slab row: 8
    const Op& op = p.ops[c.op];
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

// The fields of `op` and `p` a loop needs are read into registers first:
// both live in parameter space, and a store to the shared tile through a
// generic pointer would otherwise force the compiler to read them again.
template <typename T>
__device__ void run_layer(const Op& op, const Program& p, const Tiles<T>& s, const T* wts,
                          const float* __restrict__ fpar, const float* __restrict__ hvx, int row0,
                          Cursor& cur, int& it, int tid) {
  constexpr int MT = Traits<T>::MT;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int wrow = warp_m * MT * 16;  // the warp's first row in the tile
  const int n = op.n, flags = op.flags, nseg = op.nseg;
  const int slab_k = p.slab_k, slab_ld = p.slab_ld, act_ld = p.act_ld;
  float acc[MT][kNT][4];
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
      issue_slab(s.slab[(it + kStages - 1) % kStages], wts, p, cur, tid);
      slab_product<MT>(acc, a, lda, k0, s.slab[it % kStages], slab_ld, min(slab_k, kpad - k0), n,
                       warp_n, lane);
    }
  }

  __syncthreads();  // every warp has read the activation tile it overwrites

  // Epilogue: + bias [+ hvx], [ReLU], round to T, store to the tile.
  const int g = lane >> 2, t = lane & 3;
  const int n_rows = p.n_rows, ns = p.ns;
  const float* bias = fpar + op.b_off;
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

template <typename T>
__device__ void run_head(const Op& op, const Program& p, const Tiles<T>& s, const float* fpar,
                         float* out, int row0, int tid) {
  constexpr int BM = Block<T>::BM;
  constexpr int kWarps = Block<T>::kThreads / 32;
  const int warp = tid >> 5, lane = tid & 31;
  __syncthreads();  // the tile was written by every warp's epilogue
  constexpr int kPerLane = 256 / 32;  // head inputs are at most 256 wide
  int lda;
  const T* a = source(s, p, op.src[0], &lda);
  const int k_len = op.kpad[0], n_out = op.n, n_rows = p.n_rows;
  const float* w_head = fpar + op.w_off[0];
  const float* b_head = fpar + op.b_off;
  float* plane = out + (size_t)op.plane * n_rows;
  for (int j = 0; j < n_out; ++j) {
    // Lane l holds the head weights of k = l, l + 32, ...; rows go to warps.
    float wl[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q)
      wl[q] = lane + 32 * q < k_len ? w_head[j * k_len + lane + 32 * q] : 0.f;
    const float bias = b_head[j];
#pragma unroll
    for (int r = warp; r < BM; r += kWarps) {  // independent rows interleave their reductions
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q)
        if (lane + 32 * q < k_len) sum += to_float(a[r * lda + lane + 32 * q]) * wl[q];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const int gr = row0 + r;
      if (lane == 0 && gr < n_rows) plane[(size_t)j * n_rows + gr] = sum + bias;
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

template <typename T>
__global__ void __launch_bounds__(Block<T>::kThreads, 1)
fused_mlp_fwd_kernel(const __grid_constant__ Program p, const T* __restrict__ lo,
                     const T* __restrict__ hi, const float* __restrict__ hvx,
                     const T* __restrict__ wts, const float* __restrict__ fpar,
                     float* __restrict__ out) {
  constexpr int BM = Block<T>::BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<T> s;
  s.act = reinterpret_cast<T*>(smem_raw);
  s.lo = s.act + BM * p.act_ld;
  s.hi = s.lo + BM * p.lo_ld;
  s.slab[0] = s.hi + BM * p.hi_ld;
  for (int i = 1; i < kStages; ++i) s.slab[i] = s.slab[i - 1] + p.slab_rows * p.slab_ld;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  Cursor cur{0, 0, 0};
  skip_heads(p, cur);
  for (int i = 0; i < kStages - 1; ++i) issue_slab(s.slab[i], wts, p, cur, tid);
  load_tile(s.lo, p.lo_ld, p.lo_kpad, lo, p.in_lo, row0, BM, p.n_rows, tid);
  if (p.in_hi > 0) load_tile(s.hi, p.hi_ld, p.hi_kpad, hi, p.in_hi, row0, BM, p.n_rows, tid);
  // The first layer's slab loop synchronises before any tile is read.

  int it = 0;  // slabs consumed so far
  for (int i = 0; i < p.n_ops; ++i) {
    const Op& op = p.ops[i];
    if (op.kind == OP_LAYER)
      run_layer<T>(op, p, s, wts, fpar, hvx, row0, cur, it, tid);
    else
      run_head<T>(op, p, s, fpar, out, row0, tid);
  }
}

template <typename T>
int launch(const Program& p, const void* lo, const void* hi, const void* hvx, const void* wts,
           const void* fpar, void* out, int smem, cudaStream_t stream) {
  constexpr int BM = Block<T>::BM;
  if (p.slab_k != Traits<T>::kSlabK) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_mlp_fwd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((p.n_rows + BM - 1) / BM);
  kernel<<<grid, Block<T>::kThreads, smem, stream>>>(
      p, static_cast<const T*>(lo), static_cast<const T*>(hi), static_cast<const float*>(hvx),
      static_cast<const T*>(wts), static_cast<const float*>(fpar), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 1 = bfloat16 operands, 0 = float32. words: the program (header + ops).
extern "C" int snerf_fused_mlp_fwd(int dtype, const int* words, int n_words, const void* lo,
                                   const void* hi, const void* hvx, const void* wts,
                                   const void* fpar, void* out, int smem, void* stream) {
  Program p;
  if (n_words < kHeaderWords || n_words > static_cast<int>(sizeof(Program) / sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  memset(&p, 0, sizeof(p));
  memcpy(&p, words, sizeof(int) * n_words);
  if (p.n_ops > kMaxOps || p.n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, lo, hi, hvx, wts, fpar, out, smem, s);
  return launch<float>(p, lo, hi, hvx, wts, fpar, out, smem, s);
}
