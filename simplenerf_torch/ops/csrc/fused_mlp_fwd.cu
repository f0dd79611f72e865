// Fused NeRF field MLP forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of simplenerf_tpu/ops/fused_mlp.py: `_fwd_kernel`
// (the Pallas forward behind `fused_apply`) and `_ens_fwd_kernel` (behind
// `fused_apply_ensemble`). One launch evaluates one field MLP, or the
// members of an ensemble one after another, over n_rows points and writes
// the raw linear head channels as float32 planes out[plane][row]
// (row = ray * ns + sample). An ensemble's program appends each member's
// ops: every member starts a new activation chain from the one shared lo
// tile (loaded once per block), its views-branch extra input reads that
// same tile, its hvx layer names its slot of the stacked hvx, and its heads
// write at the member's plane offset.
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
// nothing. Per-ray `hvx` is read as hvx[slot][row / ns].
//
// Plain C interface (ctypes): snerf_fused_mlp_fwd and snerf_fused_mlp_ens_fwd
// return the CUDA error of the launch, 0 on success.

#include "fused_mlp_common.cuh"

namespace {

constexpr int kMaxOps = 40;

enum { OP_LAYER = 0, OP_HEAD = 1 };

// One step of the layer program (16 ints; built by ops/fused_mlp.py).
// LAYER: act = f(sum_s src[s] @ W_s + bias [+ hvx[hvx_slot]]); W_s stored (n, kpad[s]).
// HEAD (nseg 0):  out[plane + j][row] = sum_k act[row][k] * fpar[w_off[0] + j*kpad[0] + k] + fpar[b_off + j].
struct Op {
  int kind, n, b_off, flags, nseg;
  int src[kMaxSeg];
  int w_off[kMaxSeg];
  int kpad[kMaxSeg];
  int plane, hvx_slot;
};

struct Program {
  int n_ops, n_rows, ns, in_lo, in_hi, lo_kpad, hi_kpad;
  int act_ld, lo_ld, hi_ld, slab_ld, slab_rows, slab_k;
  Op ops[kMaxOps];
  __device__ __forceinline__ const Op& op(int i) const { return ops[i]; }
};

constexpr int kHeaderWords = 13;
static_assert(sizeof(Op) == 16 * sizeof(int), "Op layout");
static_assert(sizeof(Program) == (kHeaderWords + 16 * kMaxOps) * sizeof(int), "Program layout");

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

template <typename T>
__global__ void __launch_bounds__(Block<T>::kThreads, 1)
fused_mlp_fwd_kernel(const __grid_constant__ Program p, const T* __restrict__ lo,
                     const T* __restrict__ hi, const float* __restrict__ hvx,
                     const T* __restrict__ wts, const float* __restrict__ fpar,
                     float* __restrict__ out) {
  constexpr int BM = Block<T>::BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<T> s;
  carve_tiles(s, smem_raw, p);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  Cursor cur;
  start_ring(s, wts, p, cur, tid);
  load_tile(s.lo, p.lo_ld, p.lo_kpad, lo, p.in_lo, row0, BM, p.n_rows, tid);
  if (p.in_hi > 0) load_tile(s.hi, p.hi_ld, p.hi_kpad, hi, p.in_hi, row0, BM, p.n_rows, tid);
  // The first layer's slab loop synchronises before any tile is read.

  int it = 0;  // slabs consumed so far
  float acc[Traits<T>::MT][kNT][4];
  for (int i = 0; i < p.n_ops; ++i) {
    const Op& op = p.ops[i];
    if (op.kind == OP_LAYER) {
      op_product(acc, op, p, s, wts, cur, it, tid);
      forward_epilogue(acc, op, p, s, fpar, hvx, row0, tid);
    } else {
      run_head<T>(op, p, s, fpar, out, row0, tid);
    }
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

int run_program(int dtype, const int* words, int n_words, const void* lo, const void* hi,
                const void* hvx, const void* wts, const void* fpar, void* out, int smem,
                void* stream) {
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

}  // namespace

// dtype: 1 = bfloat16 operands, 0 = float32. words: the program (header + ops).
extern "C" int snerf_fused_mlp_fwd(int dtype, const int* words, int n_words, const void* lo,
                                   const void* hi, const void* hvx, const void* wts,
                                   const void* fpar, void* out, int smem, void* stream) {
  return run_program(dtype, words, n_words, lo, hi, hvx, wts, fpar, out, smem, stream);
}

// The ensemble: one program over the members, hi unused (the members' extra
// input is the shared lo tile), hvx stacked (n_hvx, n_rows / ns, Wv).
extern "C" int snerf_fused_mlp_ens_fwd(int dtype, const int* words, int n_words, const void* lo,
                                       const void* hvx, const void* wts, const void* fpar,
                                       void* out, int smem, void* stream) {
  return run_program(dtype, words, n_words, lo, nullptr, hvx, wts, fpar, out, smem, stream);
}
