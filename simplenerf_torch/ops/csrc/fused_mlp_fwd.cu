// Fused NeRF field MLP forward for Hopper (sm_90a).
//
// Replaces two TPU kernels of simplenerf_tpu/ops/fused_mlp.py: `_fwd_kernel`
// (the Pallas forward behind `fused_apply`) and `_ens_fwd_kernel` (behind
// `fused_apply_ensemble`). One launch evaluates one field MLP, or the
// members of an ensemble one after another, over n_rows points and writes
// the raw linear head channels as float32 planes out[plane][row]
// (row = ray * ns + sample). An ensemble's program appends each member's
// layers: every member starts a new activation chain from the one shared lo
// tile (loaded once per block), its views-branch extra input reads that
// same tile, its hvx layer names its slot of the stacked hvx, and its heads
// write at the member's plane offset.
//
// What bounds it: arithmetic. The published 8x256 MLP does ~1.18 MFLOP per
// point against ~142 bytes of device-memory traffic per point in bf16, so
// every activation stays on chip and the weights (about 1.2 MB in bf16,
// more than shared memory holds) stream from L2 through a ring of K-slabs
// that runs on across layers; a 128-row tile sets the L2 traffic at 128
// FLOP per weight byte.
//
// Two engines, by operand type:
//   * bfloat16: fused_mlp_fwd_sm90_kernel (fused_mlp_sm90.cuh): a producer
//     warpgroup streams the slabs with cp.async.bulk into an mbarrier ring,
//     two consumer warpgroups of 64 rows run the products as wgmma from
//     shared-memory descriptors and fold the heads into their register
//     epilogues; no block-wide barrier in the layer chain;
//   * float32: fused_mlp_fwd_kernel<float> (fused_mlp_common.cuh), wgmma
//     having no float32 form: 8 warps over 64 rows, plain FMAs over the
//     mma fragment layout (no TF32, which would break float32 parity), a
//     3-stage cp.async ring of 32-deep slabs, heads as warp reductions of
//     the activation tile.
// The ragged last block is masked: rows past n_rows read zeros and write
// nothing. Per-ray `hvx` is read as hvx[slot][row / ns].
//
// Plain C interface (ctypes): snerf_fused_mlp_fwd and snerf_fused_mlp_ens_fwd
// return the CUDA error of the launch, 0 on success.

#include "fused_mlp_common.cuh"
#include "fused_mlp_sm90.cuh"

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

// The bf16 engine: warpgroup 0 produces (one thread issues the bulk
// copies), warpgroups 1 and 2 consume; the two roles never reconverge, so
// setmaxnreg moves registers from the producer to the consumers
// (128 x 40 + 256 x 232 = 64,512 of the SM's 65,536).
__global__ void __launch_bounds__(sm90::kThreads, 1)
fused_mlp_fwd_sm90_kernel(const __grid_constant__ sm90::Program p,
                          const __nv_bfloat16* __restrict__ lo, const __nv_bfloat16* __restrict__ hi,
                          const float* __restrict__ hvx, const __nv_bfloat16* __restrict__ wts,
                          const float* __restrict__ fpar, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char sm90_smem[];
  if (sm90::smem_u32(sm90_smem) & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
  const sm90::Smem s = sm90::carve(sm90_smem, p);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      sm90::mbar_init(s.full + i, 1);   // the producer's expect_tx arrival
      sm90::mbar_init(s.empty + i, 2);  // one arrival per consumer warpgroup
    }
    sm90::mbar_init(s.head_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(sm90::kProducerRegs));
    if (threadIdx.x == 0) sm90::produce(p, s, wts, fpar);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(sm90::kConsumerRegs));
    sm90::consume(p, sm90_smem, s, wg - 1, lo, hi, hvx, fpar, out);
  }
}

int launch_sm90(const int* words, int n_words, const void* lo, const void* hi, const void* hvx,
                const void* wts, const void* fpar, void* out, int smem, cudaStream_t stream) {
  sm90::Program p;
  if (n_words < sm90::kHeaderWords || n_words > static_cast<int>(sizeof(p) / sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  memset(&p, 0, sizeof(p));
  memcpy(&p, words, sizeof(int) * n_words);
  if (p.n_ops > sm90::kMaxOps || p.n_rows <= 0 || p.stages < 2 || p.stages > sm90::kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < p.n_ops; ++i) {
    const int np = p.ops[i].n_pad;
    if ((np != 64 && np != 128 && np != 256) || np * 128 > p.slot_bytes ||
        p.ops[i].head_nout > sm90::kMaxHead)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = fused_mlp_fwd_sm90_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((p.n_rows + sm90::kBM - 1) / sm90::kBM);
  kernel<<<grid, sm90::kThreads, smem, stream>>>(
      p, static_cast<const __nv_bfloat16*>(lo), static_cast<const __nv_bfloat16*>(hi),
      static_cast<const float*>(hvx), static_cast<const __nv_bfloat16*>(wts),
      static_cast<const float*>(fpar), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_sm90(words, n_words, lo, hi, hvx, wts, fpar, out, smem, s);
  Program p;
  if (n_words < kHeaderWords || n_words > static_cast<int>(sizeof(Program) / sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  memset(&p, 0, sizeof(p));
  memcpy(&p, words, sizeof(int) * n_words);
  if (p.n_ops > kMaxOps || p.n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(p, lo, hi, hvx, wts, fpar, out, smem, s);
}

}  // namespace

// dtype: 1 = bfloat16 operands (the sm90 program), 0 = float32 (Program).
// words: the program (header + ops).
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
