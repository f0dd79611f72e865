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
// Two engines, by operand type, one program (struct sm90::Program):
//   * bfloat16: fused_mlp_fwd_sm90_kernel (fused_mlp_sm90.cuh): a producer
//     warpgroup streams the slabs with cp.async.bulk into an mbarrier ring,
//     two consumer warpgroups of 64 rows keep their activations in
//     registers as the next layer's wgmma A operand, take turns on the
//     tensor cores one layer at a time (ping-pong: one's epilogue runs
//     under the other's products) and fold the heads into their register
//     epilogues; no block-wide barrier in the layer chain;
//   * float32: fused_mlp_fwd_tf32_kernel (fused_mlp_tf32_sm90.cuh), the same
//     engine on the tensor cores in 3xTF32 (each product as three TF32
//     products of the operands' big and small halves, float32-accurate):
//     64-row x 32-deep weight chunks, split on the card by
//     fused_mlp_tf32_split_kernel (snerf_tf32_split) into big and small
//     images, A split in registers. Under autograd its kStash instance,
//     fused_mlp_fwd_stash_tf32_kernel (snerf_fused_mlp_fwd_stash), also
//     stores what the float32 backward reads instead of recomputing the
//     forward: each layer's activations, lo (hi), the ReLU mask words.
// The ragged last block is masked: rows past n_rows read zeros and write
// nothing. Per-ray `hvx` is read as hvx[slot][row / ns].
//
// Plain C interface (ctypes): snerf_fused_mlp_fwd, snerf_fused_mlp_ens_fwd and
// snerf_tf32_split return the CUDA error of the launch, 0 on success.

#include <string.h>

#include "fused_mlp_sm90.cuh"
#include "fused_mlp_tf32_sm90.cuh"

namespace {

// The bf16 engine: warpgroup 0 produces (one thread issues the bulk
// copies), warpgroups 1 and 2 consume in ping-pong; the two roles never
// reconverge, so setmaxnreg moves registers from the producer to the
// consumers (128 x 24 + 256 x 240 = 64,512 of the SM's 65,536): a consumer
// holds 128 accumulators and 64 registers of activations.
template <bool kPre>
__global__ void __launch_bounds__(sm90::kThreads, 1)
fused_mlp_fwd_sm90_kernel(const __grid_constant__ sm90::Program p,
                          const __nv_bfloat16* __restrict__ lo, const __nv_bfloat16* __restrict__ hi,
                          const float* __restrict__ hvx, const __nv_bfloat16* __restrict__ wts,
                          const float* __restrict__ fpar, float* __restrict__ out,
                          float* __restrict__ pre) {
  extern __shared__ __align__(1024) unsigned char sm90_smem[];
  if (sm90::smem_u32(sm90_smem) & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
  const sm90::Smem s = sm90::carve<sm90::kMaxStagesBf16>(sm90_smem, p);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(sm90::kProducerRegsBf16));
    if (threadIdx.x == 0) sm90::produce(p, s, wts, fpar);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(sm90::kConsumerRegsBf16));
    sm90::consume<kPre>(p, sm90_smem, s, wg - 1, lo, hi, hvx, fpar, out, pre);
  }
}

// The float32 engine: the same roles on the 3xTF32 core; wts is the split
// image (snerf_tf32_split), one 16 KB slot per weight chunk. kStash: also
// the stash and mask words of `so` (the training forward).
template <bool kStash>
__device__ __forceinline__ void fwd_tf32(const sm90::Program& p, const float* __restrict__ lo,
                                         const float* __restrict__ hi, const float* __restrict__ hvx,
                                         const float* __restrict__ wts, const float* __restrict__ fpar,
                                         float* __restrict__ out, const tf32::StashOut& so) {
  extern __shared__ __align__(1024) unsigned char tf32_smem[];
  if (sm90::smem_u32(tf32_smem) & 1023) __trap();  // the swizzle needs 1024-byte aligned slots
  const sm90::Smem s = sm90::carve(tf32_smem, p);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      sm90::mbar_init(s.full + i, 1);
      sm90::mbar_init(s.empty + i, 2);
    }
    sm90::mbar_init(s.head_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(sm90::kProducerRegs));
    if (threadIdx.x == 0) {
      if (p.head_floats) {
        sm90::mbar_expect_tx(s.head_bar, p.head_floats * 4);
        sm90::bulk_g2s(s.heads, fpar, p.head_floats * 4, s.head_bar);
      }
      tf32::produce(p, s.ring, s.full, s.empty, wts);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(sm90::kConsumerRegs));
    tf32::consume_fwd<kStash>(p, tf32_smem, s, wg - 1, lo, hi, hvx, fpar, out, so);
  }
}

__global__ void __launch_bounds__(sm90::kThreads, 1)
fused_mlp_fwd_tf32_kernel(const __grid_constant__ sm90::Program p, const float* __restrict__ lo,
                          const float* __restrict__ hi, const float* __restrict__ hvx,
                          const float* __restrict__ wts, const float* __restrict__ fpar,
                          float* __restrict__ out) {
  fwd_tf32<false>(p, lo, hi, hvx, wts, fpar, out, tf32::StashOut{nullptr, nullptr, nullptr});
}

// The training forward: the planes, and the stash of `st` in acts and masks.
__global__ void __launch_bounds__(sm90::kThreads, 1)
fused_mlp_fwd_stash_tf32_kernel(const __grid_constant__ sm90::Program p, const float* __restrict__ lo,
                                const float* __restrict__ hi, const float* __restrict__ hvx,
                                const float* __restrict__ wts, const float* __restrict__ fpar,
                                float* __restrict__ out, const __grid_constant__ tf32::Stash st,
                                float* acts, uint4* masks) {
  fwd_tf32<true>(p, lo, hi, hvx, wts, fpar, out, tf32::StashOut{&st, acts, masks});
}

// dtype 1: the bf16 engine; 0: the float32 engine (3xTF32), with `st` (and
// acts, masks) its training instance.
int launch(int dtype, const int* words, int n_words, const void* lo, const void* hi, const void* hvx,
           const void* wts, const void* fpar, void* out, void* pre, int smem, cudaStream_t stream,
           const tf32::Stash* st = nullptr, void* acts = nullptr, void* masks = nullptr) {
  sm90::Program p;
  if (n_words < sm90::kHeaderWords || n_words > static_cast<int>(sizeof(p) / sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  memset(&p, 0, sizeof(p));
  memcpy(&p, words, sizeof(int) * n_words);
  const int max_stages = dtype == 1 ? sm90::kMaxStagesBf16 : sm90::kMaxStages;
  if (p.n_ops > sm90::kMaxOps || p.n_rows <= 0 || p.stages < 2 || p.stages > max_stages ||
      (dtype == 1 && p.act_kb != 0))  // the bf16 engine keeps activations in registers
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < p.n_ops; ++i) {
    const int np = p.ops[i].n_pad;
    const int slabs = p.ops[i].kb[0] + p.ops[i].kb[1] + p.ops[i].kb[2];
    if ((np != 64 && np != 128 && np != 256) ||
        (dtype == 1 ? np * 128 : tf32::kSlotBytes) > p.slot_bytes || p.ops[i].head_nout > sm90::kMaxHead ||
        (dtype == 1 && slabs > p.stages))  // both consumers' turns on a layer's slabs fit the ring
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned grid = static_cast<unsigned>((p.n_rows + sm90::kBM - 1) / sm90::kBM);
  if (dtype == 1) {
    auto kernel = pre ? fused_mlp_fwd_sm90_kernel<true> : fused_mlp_fwd_sm90_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, sm90::kThreads, smem, stream>>>(
        p, static_cast<const __nv_bfloat16*>(lo), static_cast<const __nv_bfloat16*>(hi),
        static_cast<const float*>(hvx), static_cast<const __nv_bfloat16*>(wts),
        static_cast<const float*>(fpar), static_cast<float*>(out), static_cast<float*>(pre));
  } else if (st == nullptr) {
    if (pre) return static_cast<int>(cudaErrorInvalidValue);  // no float32 secondary views
    auto kernel = fused_mlp_fwd_tf32_kernel;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, sm90::kThreads, smem, stream>>>(
        p, static_cast<const float*>(lo), static_cast<const float*>(hi), static_cast<const float*>(hvx),
        static_cast<const float*>(wts), static_cast<const float*>(fpar), static_cast<float*>(out));
  } else {
    auto kernel = fused_mlp_fwd_stash_tf32_kernel;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, sm90::kThreads, smem, stream>>>(
        p, static_cast<const float*>(lo), static_cast<const float*>(hi), static_cast<const float*>(hvx),
        static_cast<const float*>(wts), static_cast<const float*>(fpar), static_cast<float*>(out), *st,
        static_cast<float*>(acts), static_cast<uint4*>(masks));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 1 = bfloat16 operands, 0 = float32 (wts: the split image).
// words: the program (struct sm90::Program's header and ops).
extern "C" int snerf_fused_mlp_fwd(int dtype, const int* words, int n_words, const void* lo,
                                   const void* hi, const void* hvx, const void* wts,
                                   const void* fpar, void* out, int smem, void* stream) {
  return launch(dtype, words, n_words, lo, hi, hvx, wts, fpar, out, nullptr, smem,
                static_cast<cudaStream_t>(stream));
}

// snerf_fused_mlp_fwd (bf16 only) that also stores the hvx layer's products
// plus bias, before hvx, as pre (n_rows x views width float32): the
// secondary views' operand (fused_mlp_sec.cu).
extern "C" int snerf_fused_mlp_fwd_pre(int dtype, const int* words, int n_words, const void* lo,
                                       const void* hi, const void* hvx, const void* wts,
                                       const void* fpar, void* out, void* pre, int smem,
                                       void* stream) {
  if (!pre || dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(dtype, words, n_words, lo, hi, hvx, wts, fpar, out, pre, smem,
                static_cast<cudaStream_t>(stream));
}

// The float32 training forward (dtype 0 only) of a single MLP or an
// ensemble (hi null):
// snerf_fused_mlp_fwd (or snerf_fused_mlp_ens_fwd) that also stores what the
// row pass and the weight pass read, as `stash_words` (struct tf32::Stash)
// lays it out: the activation stash `acts` (float32, slots of
// tf32::stash_ld(n_rows) rows) and the mask words `masks` (n_tiles x
// n_masks x 256 consumer threads x 16 bytes).
extern "C" int snerf_fused_mlp_fwd_stash(int dtype, const int* words, int n_words, const void* lo,
                                         const void* hi, const void* hvx, const void* wts,
                                         const void* fpar, void* out, const int* stash_words,
                                         int n_stash_words, void* acts, void* masks, int smem,
                                         void* stream) {
  tf32::Stash st;
  if (dtype != 0 || n_stash_words * sizeof(int) != sizeof(st) || !acts || !masks)
    return static_cast<int>(cudaErrorInvalidValue);
  memcpy(&st, stash_words, sizeof(st));
  return launch(0, words, n_words, lo, hi, hvx, wts, fpar, out, nullptr, smem,
                static_cast<cudaStream_t>(stream), &st, acts, masks);
}

// The ensemble: one program over the members, hi unused (the members' extra
// input is the shared lo tile), hvx stacked (n_hvx, n_rows / ns, Wv).
extern "C" int snerf_fused_mlp_ens_fwd(int dtype, const int* words, int n_words, const void* lo,
                                       const void* hvx, const void* wts, const void* fpar,
                                       void* out, int smem, void* stream) {
  return launch(dtype, words, n_words, lo, nullptr, hvx, wts, fpar, out, nullptr, smem,
                static_cast<cudaStream_t>(stream));
}

// The float32 weight image (n floats, whole 8 KB chunks) -> each chunk's
// big and small TF32 images, one after the other, in dst (2n floats).
extern "C" int snerf_tf32_split(const void* src, void* dst, long long n, void* stream) {
  if (n <= 0) return 0;
  if (n % tf32::kChunkFloats) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  tf32::fused_mlp_tf32_split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), n);
  return static_cast<int>(cudaGetLastError());
}
