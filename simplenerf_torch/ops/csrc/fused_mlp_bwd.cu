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
//   (a) row pass, one block per tile of 128 rows: the forward is
//       recomputed (bf16; float32 reads it, below), and each layer's
//       activation (rounded to the compute type) is stashed in device
//       memory. One engine in both types, the
//       forward's warp-specialised one (bulk-copied weight ring, two
//       consumers of 64 rows) run forward and back on one program
//       (`_bwd_plan`): bf16, fused_mlp_bwd_rows_sm90_kernel
//       (fused_mlp_bwd_sm90.cuh), wgmma on bf16 slabs, the stash leaving by
//       TMA stores; float32, fused_mlp_bwd_rows_tf32_kernel
//       (fused_mlp_bwd_tf32_sm90.cuh), the walk back alone on the 3xTF32
//       core of fused_mlp_tf32_sm90.cuh (the weight image split into big
//       and small TF32 halves by snerf_tf32_split before the launch), g
//       leaving from registers: the float32 forward, run under autograd
//       (snerf_fused_mlp_fwd_stash), has already stored the activations
//       and the mask words, and the heads' partials read the activations
//       back (`acts`; a direct call runs that forward first). A ReLU
//       layer's epilogue also packs its
//       mask as bits in the order of the thread's accumulator fragment (four
//       words a consumer thread), and the layer that feeds a head sums the head's
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
//       float32: fused_mlp_bwd_wgrad_tf32_kernel
//       (fused_mlp_wgrad_tf32_sm90.cuh), the same work split, maps and
//       clusters on the 3xTF32 core, G read from slots that the float32 row
//       pass stores K-major (wgmma takes 32-bit operands from shared memory
//       only K-major) and split into big and small TF32 images in shared
//       memory, A split in registers;
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

#include <string.h>

#include <type_traits>
#include <vector>

#include "fused_mlp_bwd_sm90.cuh"
#include "fused_mlp_bwd_tf32_sm90.cuh"
#include "fused_mlp_wgrad_sm90.cuh"
#include "fused_mlp_wgrad_tf32_sm90.cuh"

namespace {

// The bf16 row pass (fused_mlp_bwd_sm90.cuh): warpgroup 0 produces (one
// thread issues the bulk copies), warpgroups 1 and 2 consume; the roles
// never reconverge, so setmaxnreg moves registers from the producer to the
// consumers (128 x 40 + 256 x 232 = 64,512 of the SM's 65,536).
template <bool kSec>
__global__ void __launch_bounds__(bwd90::kThreads, 1)
fused_mlp_bwd_rows_sm90_kernel(const __grid_constant__ bwd90::Program p,
                               const __grid_constant__ wgrad::Maps maps,
                               const __nv_bfloat16* __restrict__ lo,
                               const __nv_bfloat16* __restrict__ hi, const float* __restrict__ hvx,
                               const float* __restrict__ dplanes,
                               const __nv_bfloat16* __restrict__ wts,
                               const float* __restrict__ fpar, float* g32, uint4* masks,
                               float* parts, const float* __restrict__ sec) {
  extern __shared__ __align__(1024) unsigned char bwd90_smem[];
  if (sm90::smem_u32(bwd90_smem) & 1023) __trap();  // the swizzle needs 1024-byte aligned tiles
  const bwd90::Smem s = bwd90::carve(bwd90_smem, p);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      bwd90::mbar_init(s.full + i, 1);   // the producer's expect_tx arrival
      bwd90::mbar_init(s.empty + i, 2);  // one arrival per consumer warpgroup
    }
    bwd90::mbar_init(s.xfull, bwd90::kConsumerThreads);   // consumer 1's threads
    bwd90::mbar_init(s.xempty, bwd90::kConsumerThreads);  // consumer 0's threads
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(sm90::kProducerRegs));
    if (threadIdx.x == 0) bwd90::produce(p, s, wts);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(sm90::kConsumerRegs));
    bwd90::consume<kSec>(p, maps, bwd90_smem, s, wg - 1, lo, hi, hvx, dplanes, fpar, g32, masks,
                         parts, sec);
  }
}

// The float32 row pass (fused_mlp_bwd_tf32_sm90.cuh): the same roles on the
// 3xTF32 core; wts is the split image (snerf_tf32_split), one 16 KB slot
// per weight chunk; acts and masks are the training forward's.
__global__ void __launch_bounds__(bwd90::kThreads, 1)
fused_mlp_bwd_rows_tf32_kernel(const __grid_constant__ bwd90::Program p, const float* __restrict__ acts,
                               const float* __restrict__ dplanes, const float* __restrict__ wts,
                               const float* __restrict__ fpar, float* stash, float* g32,
                               const uint4* masks, float* parts) {
  extern __shared__ __align__(1024) unsigned char tf32_smem[];
  if (sm90::smem_u32(tf32_smem) & 1023) __trap();  // the swizzle needs 1024-byte aligned slots
  const bwd90::Smem s = bwd90::carve(tf32_smem, p);
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      bwd90::mbar_init(s.full + i, 1);
      bwd90::mbar_init(s.empty + i, 2);
    }
    bwd90::mbar_init(s.xfull, bwd90::kConsumerThreads);
    bwd90::mbar_init(s.xempty, bwd90::kConsumerThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(sm90::kProducerRegs));
    if (threadIdx.x == 0) tf32::produce(p, s.ring, s.full, s.empty, wts);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(sm90::kConsumerRegs));
    tf32::consume_rows(p, tf32_smem, s, wg - 1, acts, dplanes, fpar, stash, g32, masks, parts);
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

// The float32 weight pass's tensor maps: for each of n_maps slots, int64
// (element offset in its buffer, dim 0, dim 1, dim 1's stride in bytes, box
// 0, box 1, buffer: 0 acts, 1 stash) -> a float32 CUtensorMap, 128-byte
// swizzle, zeros past the dims (an A slot: (width, n_rows), 32 x 32 boxes;
// a K-major G slot: (n_rows, width), 32 rows x 64 columns).
int encode_maps_f32(const float* acts, const float* stash, const long long* maps, int n_maps,
                    wgrad::Maps* out) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (n_maps > wgrad::kMaxMaps) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_maps; ++i) {
    const long long* m = maps + wgrad32::kMapWords * i;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(m[1]), static_cast<cuuint64_t>(m[2])};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(m[3])};
    const cuuint32_t box[2] = {static_cast<cuuint32_t>(m[4]), static_cast<cuuint32_t>(m[5])};
    const cuuint32_t elem[2] = {1, 1};
    const float* base = m[6] ? stash : acts;
    const CUresult r = encode(&out->map[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                              const_cast<float*>(base + m[0]), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
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

// The weight pass (dtype 1: bf16, 0: float32): the maps, then one CTA per
// job (clusters of two). bf16 reads every slot from stash; float32 a map's
// buffer, acts or stash.
int wgrad_launch(int dtype, const void* acts, const void* stash, const long long* maps, int n_maps,
                 const void* jobs, int n_jobs, int n_rows, int chunk_rows, int dw_total, float* dw_part,
                 cudaStream_t stream) {
  if (n_jobs <= 0) return 0;
  const bool bf16 = dtype == 1;
  if (chunk_rows % (bf16 ? wgrad::kBox : wgrad32::kDepth)) return static_cast<int>(cudaErrorInvalidValue);
  wgrad::Maps params;  // 16 KB; the launch copies it into the kernel's parameters
  int rc = bf16 ? encode_maps(static_cast<const __nv_bfloat16*>(stash), maps, n_maps, &params)
                : encode_maps_f32(static_cast<const float*>(acts), static_cast<const float*>(stash),
                                  maps, n_maps, &params);
  if (rc) return rc;
  const unsigned grid = (n_jobs + 1) / 2 * 2;
  cudaError_t err;
  if (bf16) {
    auto kernel = wgrad::fused_mlp_bwd_wgrad_kernel;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wgrad::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, wgrad::kThreads, wgrad::kSmemBytes, stream>>>(
        static_cast<const wgrad::Job*>(jobs), n_jobs, params, n_rows, chunk_rows, dw_total, dw_part);
  } else {
    auto kernel = wgrad32::fused_mlp_bwd_wgrad_tf32_kernel;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wgrad32::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, wgrad32::kThreads, wgrad32::kSmemBytes, stream>>>(
        static_cast<const wgrad32::Job*>(jobs), n_jobs, params, n_rows, chunk_rows, dw_total, dw_part);
  }
  return static_cast<int>(cudaGetLastError());
}

struct Buffers {
  const void *lo, *hi, *hvx, *dplanes, *wts, *fpar, *tasks;
  const void* sec;   // the secondary views' cotangent of the hvx layer (bf16 only), or null
  const void* acts;  // float32: the training forward's activation stash (its masks: masks)
  void *stash, *g32, *masks, *parts, *part_out, *dw_part, *dw_out, *dhvx;
  const long long* maps;  // the tensor-map parameters (host)
  int n_maps;
  const int* slices;      // the three column sums' slices (host)
  void* scratch;          // the column sums' slice sums
};

// The three column sums after the weight pass: partials over the tiles, dW
// partials over the chunks, g32 over each ray's ns rows (dhvx).
int column_sums(const Buffers& b, int n_tiles, int part_w, int n_chunks, int dw_total,
                int n_hvx_rows, int ns, int hvx_w, cudaStream_t stream) {
  float* scratch = static_cast<float*>(b.scratch);
  int rc = colsum(static_cast<const float*>(b.parts), static_cast<float*>(b.part_out), 1, n_tiles,
                  part_w, b.slices[0], scratch, stream);
  if (rc) return rc;
  rc = colsum(static_cast<const float*>(b.dw_part), static_cast<float*>(b.dw_out), 1, n_chunks,
              dw_total, b.slices[1], scratch, stream);
  if (rc) return rc;
  return colsum(static_cast<const float*>(b.g32), static_cast<float*>(b.dhvx), n_hvx_rows, ns,
                hvx_w, b.slices[2], scratch, stream);
}

// The backward: the row pass (its program `words`: the bwd90 header and
// ops; bf16: its tensor maps the first n_maps of b.maps, the weight pass's
// the rest; float32: b.maps are the weight pass's), the weight pass (its
// jobs), the column sums. dtype 1: bf16; 0: float32 (wts: the split image).
int run(int dtype, const int* words, int n_words, const Buffers& b, int n_tasks, int n_chunks,
        int chunk_rows, int dw_total, int n_hvx_rows, int smem, cudaStream_t stream) {
  if (n_chunks <= 0 || chunk_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bwd90::Program p;
  if (n_words < bwd90::kHeaderWords || n_words > static_cast<int>(sizeof(p) / sizeof(int)))
    return static_cast<int>(cudaErrorInvalidValue);
  memset(&p, 0, sizeof(p));
  memcpy(&p, words, sizeof(int) * n_words);
  const bool bf16 = dtype == 1;
  const int n_maps = bf16 ? p.n_maps : 0;  // the float32 row pass stores every slot with map >= 0
  if (p.n_ops > bwd90::kMaxOps || p.n_rows <= 0 || p.stages < 2 || p.stages > bwd90::kMaxStages ||
      (bf16 && (p.n_maps > b.n_maps || p.n_maps > wgrad::kMaxMaps)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < p.n_ops; ++i) {
    const bwd90::Op& op = p.ops[i];
    if (op.map < -1 || (bf16 && op.map >= n_maps)) return static_cast<int>(cudaErrorInvalidValue);
    // bf16 recomputes the forward; float32 reads it (head ops) and walks back
    if (bf16 ? op.kind == bwd90::H_LAYER : op.kind != bwd90::H_LAYER && op.kind != bwd90::B_LAYER)
      return static_cast<int>(cudaErrorInvalidValue);
    if (op.kind == bwd90::F_IN) continue;
    if ((op.n_pad != 64 && op.n_pad != 128 && op.n_pad != 256) ||
        (bf16 ? op.n_pad * 128 : tf32::kSlotBytes) > p.slot_bytes || op.head_nout > bwd90::kMaxHead)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = (p.n_rows + bwd90::kBM - 1) / bwd90::kBM;
  cudaError_t err;
  int rc;
  if (bf16) {
    wgrad::Maps maps;  // 16 KB; the launch copies it into the kernel's parameters
    rc = encode_maps(static_cast<const __nv_bfloat16*>(b.stash), b.maps, p.n_maps, &maps);
    if (rc) return rc;
    auto rows = b.sec ? fused_mlp_bwd_rows_sm90_kernel<true> : fused_mlp_bwd_rows_sm90_kernel<false>;
    err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rows<<<n_tiles, bwd90::kThreads, smem, stream>>>(
        p, maps, static_cast<const __nv_bfloat16*>(b.lo), static_cast<const __nv_bfloat16*>(b.hi),
        static_cast<const float*>(b.hvx), static_cast<const float*>(b.dplanes),
        static_cast<const __nv_bfloat16*>(b.wts), static_cast<const float*>(b.fpar),
        static_cast<float*>(b.g32), static_cast<uint4*>(b.masks), static_cast<float*>(b.parts),
        static_cast<const float*>(b.sec));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    rc = wgrad_launch(1, b.stash, b.stash, b.maps + 4 * p.n_maps, b.n_maps - p.n_maps, b.tasks,
                      n_tasks, p.n_rows, chunk_rows, dw_total, static_cast<float*>(b.dw_part), stream);
    if (rc) return rc;
  } else {
    if (b.sec) return static_cast<int>(cudaErrorInvalidValue);  // no float32 secondary views
    if (!b.acts) return static_cast<int>(cudaErrorInvalidValue);  // the training forward's stash
    auto rows = fused_mlp_bwd_rows_tf32_kernel;
    err = cudaFuncSetAttribute(rows, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rows<<<n_tiles, bwd90::kThreads, smem, stream>>>(
        p, static_cast<const float*>(b.acts), static_cast<const float*>(b.dplanes),
        static_cast<const float*>(b.wts), static_cast<const float*>(b.fpar),
        static_cast<float*>(b.stash), static_cast<float*>(b.g32), static_cast<const uint4*>(b.masks),
        static_cast<float*>(b.parts));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    rc = wgrad_launch(0, b.acts, b.stash, b.maps, b.n_maps, b.tasks, n_tasks, p.n_rows, chunk_rows,
                      dw_total, static_cast<float*>(b.dw_part), stream);
    if (rc) return rc;
  }
  return column_sums(b, n_tiles, p.part_w, n_chunks, dw_total, n_hvx_rows, p.ns, p.hvx_w, stream);
}

}  // namespace

// dtype: 1 = bfloat16 operands, 0 = float32. words: the row pass's whole
// program (struct bwd90::Program's header and ops, host memory). tasks: the
// weight pass's n_tasks jobs (bf16 wgrad::Job, float32 wgrad32::Job).
// Workspace and outputs are allocated by the caller: stash (cdtype; float32:
// the backward ops' stash_cols x tf32::stash_ld(n_rows) floats), g32,
// masks (n_tiles x n_masks x 256 consumer threads x 16 bytes; float32: the
// training forward's, as acts, its activation stash; bf16: acts null),
// parts (n_tiles x part_w), dw_part (n_chunks x dw_total), the outputs
// part_out (part_w), dw_out (dw_total), dhvx (n_hvx_rows x hvx_w); the
// tensor maps' host parameters `maps` (bf16: n_maps x 4 int64, the row
// pass's stash slots, as many as its header names, then the weight pass's;
// float32: n_maps x 7, the weight pass's); the
// column sums' slices (3 ints, host) and their scratch (the largest
// S x slices x C of the three where slices > 1).
extern "C" int snerf_fused_mlp_bwd(int dtype, const int* words, int n_words, const void* lo,
                                   const void* hi, const void* hvx, const void* dplanes,
                                   const void* wts, const void* fpar, const void* tasks, int n_tasks,
                                   int n_chunks, int chunk_rows, int dw_total, int n_hvx_rows,
                                   void* stash, const void* acts, void* g32, void* masks, void* parts,
                                   void* part_out, void* dw_part, void* dw_out, void* dhvx,
                                   const long long* maps, int n_maps, const int* slices,
                                   void* scratch, int smem, void* stream) {
  const Buffers b{lo,    hi,      hvx,     dplanes, wts,      fpar,    tasks,   nullptr, acts,
                  stash, g32,     masks,   parts,   part_out, dw_part, dw_out, dhvx,
                  maps,  n_maps,  slices,  scratch};
  return run(dtype, words, n_words, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem,
             static_cast<cudaStream_t>(stream));
}

// snerf_fused_mlp_bwd (bf16 only) whose hvx layer's g also takes the
// secondary views' cotangent sec (n_rows x hvx_w float32, fused_mlp_sec.cu)
// after dhvx's g32 store.
extern "C" int snerf_fused_mlp_bwd_sec(int dtype, const int* words, int n_words, const void* lo,
                                       const void* hi, const void* hvx, const void* dplanes,
                                       const void* wts, const void* fpar, const void* tasks,
                                       int n_tasks, int n_chunks, int chunk_rows, int dw_total,
                                       int n_hvx_rows, void* stash, void* g32, void* masks,
                                       void* parts, void* part_out, void* dw_part, void* dw_out,
                                       void* dhvx, const long long* maps, int n_maps,
                                       const int* slices, void* scratch, int smem, const void* sec,
                                       void* stream) {
  if (!sec || dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Buffers b{lo,    hi,      hvx,     dplanes, wts,      fpar,    tasks,   sec, nullptr,
                  stash, g32,     masks,   parts,   part_out, dw_part, dw_out, dhvx,
                  maps,  n_maps,  slices,  scratch};
  return run(dtype, words, n_words, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem,
             static_cast<cudaStream_t>(stream));
}

// The ensemble: one program over the members and the one shared lo (no hi),
// hvx and dhvx stacked (n_hvx, n_rows / ns, Wv).
extern "C" int snerf_fused_mlp_ens_bwd(int dtype, const int* words, int n_words, const void* lo,
                                       const void* hvx, const void* dplanes, const void* wts,
                                       const void* fpar, const void* tasks, int n_tasks,
                                       int n_chunks, int chunk_rows, int dw_total, int n_hvx_rows,
                                       void* stash, const void* acts, void* g32, void* masks,
                                       void* parts, void* part_out, void* dw_part, void* dw_out,
                                       void* dhvx, const long long* maps, int n_maps,
                                       const int* slices, void* scratch, int smem, void* stream) {
  const Buffers b{lo,    nullptr, hvx,     dplanes, wts,      fpar,    tasks,   nullptr, acts,
                  stash, g32,     masks,   parts,   part_out, dw_part, dw_out, dhvx,
                  maps,  n_maps,  slices,  scratch};
  return run(dtype, words, n_words, b, n_tasks, n_chunks, chunk_rows, dw_total, n_hvx_rows, smem,
             static_cast<cudaStream_t>(stream));
}

// The weight pass alone (dtype 1: bf16, 0: float32), on a stash the caller
// filled (every map's buffer), then the column sum of its partials over the
// chunks: dw_out (dw_total).
extern "C" int snerf_wgrad(int dtype, const void* stash, const long long* maps, int n_maps,
                           const void* jobs, int n_jobs, int n_rows, int chunk_rows, int n_chunks,
                           int dw_total, void* dw_part, void* dw_out, int slices, void* scratch,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = wgrad_launch(dtype, stash, stash, maps, n_maps, jobs, n_jobs, n_rows, chunk_rows,
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
