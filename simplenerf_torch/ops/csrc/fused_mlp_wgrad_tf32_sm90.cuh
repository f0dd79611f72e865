// Weight pass of the float32 fused-MLP backward on Hopper's tensor cores
// (sm_90a): the device code of fused_mlp_bwd_wgrad_tf32_kernel in
// fused_mlp_bwd.cu, the float32 counterpart of the part of
// simplenerf_tpu/ops/fused_mlp.py `_bwd_kernel` and `_ens_bwd_kernel` that
// sums every dW over the rows (`_mm_tn`; the TPU kernels carry those sums
// in VMEM across grid steps). The bf16 weight pass is
// fused_mlp_wgrad_sm90.cuh; this one keeps its work split, its tensor maps
// and its clusters and runs the 3xTF32 product core of
// fused_mlp_tf32_sm90.cuh.
//
// It forms every dW = h_prev^T @ g of the backward program, in float32,
// from two stash slots, the activation h_prev that the training forward
// stored and the g that the float32 row pass stored, summed over
// one chunk of stash rows into a float32 partials row per chunk; the column
// sums then add the chunks in order. What bounds it: operations, and bytes
// close behind. For the published fine MLP at the training step the 3 x
// FLOP at the TF32 rate take 5.62 ms and the distinct slots it reads, 15.1
// GB, 4.51 ms at 3.35 TB/s. So the design reads each slot from device
// memory about once per launch, as the bf16 pass does, and keeps the
// tensor cores fed:
//   * wgmma takes 32-bit operands from shared memory only K-major, and in
//     A^T G the sum runs over stash rows (K). So the row pass stores every
//     slot that this pass reads as G K-major (a tensor map names its
//     buffer: the forward's activations or the row pass's cotangents):
//     element (r, c) at
//     slot * ld + c * ld + r (ld = n_rows rounded up to 8, so that every
//     slot and every column starts 32-byte aligned; TMA needs 16); the
//     activation (A) slots stay row-major, (r, c) at slot * ld + r * width
//     + c (`tf32::stash_ld`; ops/fused_mlp.py `_stash_ld`);
//   * a job is a tile of one dW: up to 128 dW rows (two consumer
//     warpgroups x 64 rows) by up to 128 columns (two G boxes of 64), over
//     one chunk; a panel of <= 64 rows gives both consumers the same rows
//     and one G box each. Two jobs that read the same G (the two panels of
//     a 256-row dW) or else the same A (the two halves of a 256-column dW)
//     run as a cluster of two CTAs, started together, so they read it in
//     step and L2 serves the second read (scheduling only: no shared
//     memory or barrier between them). The bf16 pass's jobs take the whole
//     n_out; here a consumer's 64 x 256 float32 sums, its partial sum and
//     its A fragments (128 + 32 + 32 registers) spilled 1.6 KB a thread
//     under the 168 registers ptxas gave the kernel, so A is read once per
//     128 columns of G instead (ops/fused_mlp.py `_wgrad_plan` counts the
//     bytes);
//   * the operands arrive by TMA in the 128-byte swizzle, 32 stash rows a
//     stage: A as 32-row x 32-column boxes as it is stored (4 KB), G as
//     64-column x 32-row boxes of its K-major slot, which land as 64 rows
//     of 128 bytes (32 K values), the layout of the float32 engines'
//     weight chunks (8 KB); rows past n_rows come back as zeros, so the
//     ragged tail needs no masking;
//   * the consumers split each landed G box in place into its big TF32
//     image and write the small image (tf32(x - big)) into a second buffer
//     (`split`: tf32::split's bits, cvt.rna's, by integer rounding), make the writes visible to the async proxy,
//     and meet at a named barrier; B is then each image through a K-major
//     descriptor, as in the float32 engines. Stage 0's G is split first;
//     stage k + 1's is split in pieces while stage k's products run on the
//     tensor cores (a piece after each G box's products are issued), so
//     the split is off the tensor cores' path but for the barrier;
//   * A comes from registers (wgmma's RS form): each thread loads its TF32
//     fragment (rows g and g + 8 of its warp's 16, K columns t and t + 4 of
//     each k8 step) from the A box and splits it there. Which dW row a
//     fragment row is, is free; it is chosen so that a warp's loads hit 32
//     banks: fragment row 16w + 8h + g of a consumer is dW row 32 (w / 2)
//     + 4 (p ^ 4 (g / 4)) + g % 4 of its 64, p = 2 (w % 2) + h, i.e. the
//     four lanes of a quad read 16 bytes, two quads 16-byte chunks p and
//     p ^ 4, and the swizzle's XOR with the row (t, t + 4) moves each
//     quad's chunk to a bank group of its own (`a_row`);
//   * per stage and 64-column G box each consumer runs 12 products (4 k8
//     steps x small.big + big.small + big.big, in that order) of
//     m64n64k8 into a partial sum, waits, and adds the partial to the
//     box's accumulators in float32: the tensor cores truncate as they
//     accumulate, and a chunk's rows (~80k at the fine step) in one
//     accumulator would drift from float32 (fused_mlp_tf32_sm90.cuh;
//     tools/probe_fused_mlp_bwd.py reads a one-accumulator variant);
//   * no atomics: each (dW element, chunk) is written by one thread, and
//     the column sums add the chunks in a fixed order.
//
// Block: 288 threads. Warpgroups 0 and 1 (warps 0-7) consume; warp 8
// produces (one thread issues the copies). A consumer holds 64
// accumulators (64 x 128), 32 of a partial sum and 32 of A fragments.
// Shared memory: kStages stages of 32 KB (four A boxes of 4 KB, two G
// boxes of 8 KB) from a 1024-aligned base, two small images of 16 KB (the
// per-stage barrier keeps a consumer from overwriting the image the other
// one still reads: it can be at most one stage behind), then the
// barriers: 196,688 bytes of the 232,448 a block can use (ops/fused_mlp.py
// `_WGRAD32_SMEM`). The tensor maps are the bf16 pass's __grid_constant__
// parameter (wgrad::Maps). Built with -DSNERF_WGRAD_WATCHDOG, a wait that
// lasts ~2 s traps, as in the bf16 pass.

#pragma once

#include "fused_mlp_tf32_sm90.cuh"
#include "fused_mlp_wgrad_sm90.cuh"

namespace wgrad32 {

constexpr int kThreads = 288;                  // two consumer warpgroups, then the producer warp
constexpr int kConsumers = 256;
constexpr int kProducerWarp = 8;
constexpr int kDepth = 32;                     // stash rows of a stage (K)
constexpr int kABox = 32;                      // columns of an A box
constexpr int kABoxBytes = kDepth * kABox * 4; // 4 KB
constexpr int kGBox = 64;                      // columns of a G box
constexpr int kGBoxBytes = kGBox * kDepth * 4; // 8 KB
constexpr int kMaxA = 4, kMaxG = 2;
constexpr int kStageBytes = kMaxA * kABoxBytes + kMaxG * kGBoxBytes;
constexpr int kStages = 5;
constexpr int kSmallBytes = kMaxG * kGBoxBytes;
constexpr int kSmalls = 2;
constexpr int kSmemBytes = kStages * kStageBytes + kSmalls * kSmallBytes + 2 * kStages * 8;
constexpr int kMapWords = 7;  // a tensor map's host parameters (ops/fused_mlp.py `_WGRAD32_MAP`)
constexpr int kSplitBar = 1;  // the consumers' named barrier

using tf32::kSteps;  // k8 steps of a stage

// x = big + small as tf32::split forms them (cvt.rna: round to nearest,
// ties away from zero), by integer rounding of the bits: the same bits for
// every finite x (ops/fused_mlp.py `_tf32_round`), in two integer
// operations a value where the conversion took longer (1.2 ms of the fine
// step's pass on the card: PERF.md).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xFFFFE000u;
}

// One CTA's job (10 ints; built by ops/fused_mlp.py `_wgrad_plan`).
struct Job {
  int chunk;              // stash rows [chunk * chunk_rows, +chunk_rows)
  int a_map, i0, n_a;     // A: n_a boxes of columns i0, i0 + 32, .. of map a_map (the panel's dW rows)
  int g_map, g0, n_g;     // G: n_g boxes of columns 64 g0, 64 (g0 + 1) of map g_map
  int dw_off, k_in, n_out;  // the dW (k_in, n_out) at dw_off of a partials row
};
constexpr int kJobWords = 10;
static_assert(sizeof(Job) == kJobWords * sizeof(int), "Job layout");

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kSplitBar), "n"(kConsumers) : "memory");
}

// ---- the producer ----

// One thread: each stage's A boxes (columns i0, i0 + 32, .. of the A map,
// rows row..) and G boxes (columns 64 g0, .. of the K-major G map) into
// the ring, once both consumers have released the stage.
__device__ __forceinline__ void produce(const Job& j, const wgrad::Maps& maps, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty, int r_begin, int n_stages) {
  const CUtensorMap* am = &maps.map[j.a_map];
  const CUtensorMap* gm = &maps.map[j.g_map];
  const uint32_t bytes = j.n_a * kABoxBytes + j.n_g * kGBoxBytes;
  int s = 0, phase = 0;
  for (int k = 0; k < n_stages; ++k) {
    wgrad::mbar_wait(empty + s, phase ^ 1);
    unsigned char* st = ring + s * kStageBytes;
    const int row = r_begin + k * kDepth;
    wgrad::mbar_expect_tx(full + s, bytes);
    for (int b = 0; b < j.n_a; ++b) wgrad::tma_load(st + b * kABoxBytes, am, j.i0 + b * kABox, row, full + s);
    for (int b = 0; b < j.n_g; ++b)
      wgrad::tma_load(st + kMaxA * kABoxBytes + b * kGBoxBytes, gm, row, (j.g0 + b) * kGBox, full + s);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

// ---- the consumers ----

// Piece `piece` of `pieces` of G's n_g boxes -> big in place, small into
// `small` (the same offsets): the 256 consumer threads, 16 bytes a step.
__device__ __forceinline__ void split_g(unsigned char* g, unsigned char* small, int n_g, int tid,
                                        int piece, int pieces) {
  float4* big4 = reinterpret_cast<float4*>(g);
  float4* small4 = reinterpret_cast<float4*>(small);
  const int steps = n_g * (kGBoxBytes / 16) / kConsumers;
  for (int m = piece; m < steps; m += pieces) {
    const int i = tid + m * kConsumers;
    const float4 x = big4[i];
    uint32_t b[4], s[4];
    split(x.x, b[0], s[0]);
    split(x.y, b[1], s[1]);
    split(x.z, b[2], s[2]);
    split(x.w, b[3], s[3]);
    big4[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                          __uint_as_float(b[3]));
    small4[i] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]), __uint_as_float(s[2]),
                            __uint_as_float(s[3]));
  }
}

// The 16-byte chunk of its A box that fragment row 16w + 8h + g reads
// (columns 4 chunk .. + 3; the thread takes column 4 chunk + g % 4).
__device__ __forceinline__ int a_chunk(int w, int h, int g) { return (2 * (w & 1) + h) ^ (4 * (g >> 2)); }
// The dW row of a consumer's 64 that fragment row 16w + 8h + g is.
__device__ __forceinline__ int a_row(int w, int h, int g) { return 32 * (w >> 1) + 4 * a_chunk(w, h, g) + (g & 3); }

// The thread's A fragments of a stage, split: a[s] = {(g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4)} of k8 step s, as rows (h) and K columns of
// the fragment; a fragment row's values lie in one 16-byte chunk of each
// 128-byte box row (the K index), moved by the swizzle (chunk ^ row % 8).
__device__ __forceinline__ void load_a(const unsigned char* box, uint32_t (&big)[kSteps][4],
                                       uint32_t (&small)[kSteps][4], int w, int g, int t) {
  const int c0 = a_chunk(w, 0, g), c1 = a_chunk(w, 1, g), in = (g & 3) * 4;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * s + t + 4 * e;
      const unsigned char* row = box + r * 128 + in;
      v[2 * e] = *reinterpret_cast<const float*>(row + ((c0 ^ (r & 7)) << 4));
      v[2 * e + 1] = *reinterpret_cast<const float*>(row + ((c1 ^ (r & 7)) << 4));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], big[s][i], small[s][i]);
  }
}

// 64 rows x 64 NG columns of float32 sums into a chunk's partials row:
// fragment rows through `a_row`, columns col0 + .., rows < k_in and
// columns < n_out.
template <int NG>
__device__ __forceinline__ void store_sums(const float (&acc)[NG][32], float* __restrict__ out,
                                           int row0, int col0, int k_in, int n_out, int t) {
  const int w = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  const int r0 = row0 + a_row(w, 0, g), r1 = row0 + a_row(w, 1, g);
#pragma unroll
  for (int jb = 0; jb < NG; ++jb) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 64 * jb + 8 * j + 2 * q;
      if (col >= n_out) continue;  // n_out is even: col + 1 < n_out too
      if (r0 < k_in)
        *reinterpret_cast<float2*>(out + (size_t)r0 * n_out + col) =
            make_float2(acc[jb][4 * j], acc[jb][4 * j + 1]);
      if (r1 < k_in)
        *reinterpret_cast<float2*>(out + (size_t)r1 * n_out + col) =
            make_float2(acc[jb][4 * j + 2], acc[jb][4 * j + 3]);
    }
  }
}

// One consumer warpgroup over every stage. With the other consumer it
// splits each stage's G: stage 0's first, then stage k + 1's in pieces
// while stage k's products run on the tensor cores, then the named
// barrier. NG > 0: it multiplies its A boxes ab, ab + 1 by the job's G
// boxes gb .. gb + NG - 1 and releases the stage; NG = 0: a consumer with
// no boxes of its own (a 64-row panel whose G is one box) splits, meets
// the barrier and releases all the same.
template <int NG>
__device__ __forceinline__ void consume(const Job& j, unsigned char* ring, unsigned char* smalls,
                                        uint64_t* full, uint64_t* empty, int n_stages, int ab, int gb,
                                        float* __restrict__ out, int tid) {
  constexpr int kPieces = NG > 0 ? NG : 1;
  const int t = tid & 127, w = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
  float acc[kPieces][32];
#pragma unroll
  for (int jb = 0; jb < kPieces; ++jb)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[jb][i] = 0.f;
  wgrad::mbar_wait(full, 0);
  split_g(ring + kMaxA * kABoxBytes, smalls, j.n_g, tid, 0, 1);
  sm90::fence_proxy_async();  // the images' generic stores, before wgmma reads them
  consumers_sync();
  int s = 0, s1 = 1 % kStages, phase1 = s1 == 0;  // stage k's slot; stage k + 1's slot and parity
  for (int k = 0; k < n_stages; ++k) {
    unsigned char* st = ring + s * kStageBytes;
    unsigned char* gbig = st + kMaxA * kABoxBytes;
    unsigned char* gsmall = smalls + (k & 1) * kSmallBytes;
    const bool next = k + 1 < n_stages;
    unsigned char* nbig = ring + s1 * kStageBytes + kMaxA * kABoxBytes;
    unsigned char* nsmall = smalls + ((k + 1) & 1) * kSmallBytes;
    if constexpr (NG > 0) {
      uint32_t big[kSteps][4], small[kSteps][4];
      load_a(st + (ab + (w >> 1)) * kABoxBytes, big, small, w, g, q);
#pragma unroll
      for (int jb = 0; jb < NG; ++jb) {
        const uint64_t db = sm90::desc_sw128(gbig + (gb + jb) * kGBoxBytes);
        const uint64_t ds = sm90::desc_sw128(gsmall + (gb + jb) * kGBoxBytes);
        float part[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) part[i] = 0.f;
        sm90::wgmma_fence();
#pragma unroll
        for (int s8 = 0; s8 < kSteps; ++s8) {  // a k8 step: 32 bytes on in each box row
          tf32::mma(part, small[s8], db + 2 * s8);
          tf32::mma(part, big[s8], ds + 2 * s8);
          tf32::mma(part, big[s8], db + 2 * s8);
        }
        sm90::wgmma_commit();
        if (next) {  // stage k + 1's G, a piece while each box's products run
          if (jb == 0) wgrad::mbar_wait(full + s1, phase1);
          split_g(nbig, nsmall, j.n_g, tid, jb, NG);
        }
        sm90::wgmma_wait<0>();
        sm90::fence_acc(part);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[jb][i] += part[i];
      }
    } else if (next) {
      wgrad::mbar_wait(full + s1, phase1);
      split_g(nbig, nsmall, j.n_g, tid, 0, 1);
    }
    if (t == 0) wgrad::mbar_arrive(empty + s);  // this consumer has read the stage
    if (next) {
      sm90::fence_proxy_async();
      consumers_sync();  // stage k + 1's images are whole; stage k's small image is read
    }
    s = s1;
    if (++s1 == kStages) {
      s1 = 0;
      phase1 ^= 1;
    }
  }
  if constexpr (NG > 0)
    store_sums<NG>(acc, out + j.dw_off, j.i0 + kABox * ab, kGBox * (j.g0 + gb), j.k_in, j.n_out, t);
}

// The weight pass. Grid: one CTA per job, in clusters of two consecutive
// jobs; a CTA past the last job (an odd count's pad) has nothing to do.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
fused_mlp_bwd_wgrad_tf32_kernel(const Job* __restrict__ jobs, int n_jobs,
                                const __grid_constant__ wgrad::Maps maps, int n_rows, int chunk_rows,
                                int dw_total, float* __restrict__ dw_part) {
  if (static_cast<int>(blockIdx.x) >= n_jobs) return;
  extern __shared__ __align__(1024) unsigned char wgrad32_smem[];
  if (sm90::smem_u32(wgrad32_smem) & 1023) __trap();  // the swizzle needs 1024-byte aligned boxes
  unsigned char* ring = wgrad32_smem;
  unsigned char* smalls = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smalls + kSmalls * kSmallBytes);
  uint64_t* empty = full + kStages;
  const Job j = jobs[blockIdx.x];
  const int r_begin = j.chunk * chunk_rows;
  const int r_end = min(n_rows, r_begin + chunk_rows);
  const int n_stages = r_end > r_begin ? (r_end - r_begin + kDepth - 1) / kDepth : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wgrad::mbar_init(full + s, 1);   // the producer's expect_tx arrival
      wgrad::mbar_init(empty + s, 2);  // each consumer warpgroup's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before any copy or wait
  if (threadIdx.x / 32 == kProducerWarp) {
    if (threadIdx.x % 32 == 0 && n_stages > 0) produce(j, maps, ring, full, empty, r_begin, n_stages);
    return;
  }
  if (n_stages == 0) return;
  const int c = threadIdx.x / 128;
  float* out = dw_part + (size_t)j.chunk * dw_total;
  // Consumer c's boxes: a panel of more than 64 rows gives each consumer
  // two A boxes (64 rows) and the job's G (<= 128 columns); one of <= 64
  // rows gives both its A boxes and one G box each.
  int ab = 2 * c, gb = 0, gn = j.n_g;
  if (j.n_a <= 2) {
    ab = 0;
    gb = c;
    gn = c < j.n_g ? 1 : 0;
  }
  const int tid = threadIdx.x;
  if (gn == 2)
    consume<2>(j, ring, smalls, full, empty, n_stages, ab, gb, out, tid);
  else if (gn == 1)
    consume<1>(j, ring, smalls, full, empty, n_stages, ab, gb, out, tid);
  else
    consume<0>(j, ring, smalls, full, empty, n_stages, ab, gb, out, tid);
}

}  // namespace wgrad32
