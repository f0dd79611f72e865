// The float32 fused MLP on Hopper's tensor cores (sm_90a): the product core
// and the forward's device code of fused_mlp_fwd_tf32_kernel (fused_mlp_fwd.cu,
// single MLP and ensemble); fused_mlp_bwd_tf32_sm90.cuh builds the backward's
// row pass, fused_mlp_bwd_rows_tf32_kernel (fused_mlp_bwd.cu), on the same
// core. They are the float32 counterparts of
// simplenerf_tpu/ops/fused_mlp.py `_fwd_kernel` / `_ens_fwd_kernel` and of
// the row half of `_bwd_kernel` / `_ens_bwd_kernel`.
//
// What bounds them: arithmetic. Float32 products on CUDA cores run at 67
// TFLOP/s; the tensor cores take TF32 (10 explicit mantissa bits) at 494.7.
// Each product is formed as three TF32 products (3xTF32): with x = big +
// small, big = tf32(x) and small = tf32(x - big) (cvt.rna, round to nearest,
// ties away), D += A_small B_big + A_big B_small + A_big B_big in float32,
// in that order; the dropped small x small term is below float32 rounding,
// where one TF32 product (big x big) leaves an error near 2^-11 relative.
// Bound: 3 x FLOP at the TF32 rate, 165 float32 TFLOP/s.
//
// The engines are the bf16 ones (fused_mlp_sm90.cuh, fused_mlp_bwd_sm90.cuh)
// with their programs (sm90::Program, bwd90::Program), their warp
// specialisation (warpgroup 0 produces: one thread bulk-copies the weight
// chunks into a full/empty mbarrier ring; warpgroups 1 and 2 consume 64 rows
// each; setmaxnreg 40 / 232), their register epilogues (bias, hvx, ReLU, the
// folded heads; in the row pass the mask words, g, db by shuffles and the
// consumers' hand-over, the head partials), and a float32 core:
//   * wgmma has no float32 form and takes 32-bit operands from shared memory
//     only K-major. B (the weights) is K-major already: every product's
//     weight is stored by ops/fused_mlp.py as 64-row x 32-deep chunks, rows
//     of 128 bytes in the 128-byte swizzle (16-byte group c of row r at
//     c ^ (r % 8)), and tf32_split (fused_mlp_tf32_split_kernel) turns each
//     8 KB chunk into its big image and then its small image, once a call, on
//     the card. A slot of the ring is one chunk's two images (16 KB).
//   * A comes from registers (wgmma's RS form): each thread loads its
//     fragment of the float32 activation tile, splits it in registers and
//     feeds big and small to three m64n64k8 products per k8 step, so the
//     tile holds float32 once. The TF32 A fragment of k8 step s holds
//     columns (t, t + 4) of the step for lane quad position t, rows g and
//     g + 8; the accumulator (and so the tile the epilogue writes) holds
//     column pairs (2t, 2t + 1). The packer permutes each 8-deep group of
//     every weight's K rows (slot p = 0 .. 7 holds the group's row
//     0 2 4 6 1 3 5 7), so that a thread's fragment is the float2 at
//     columns 2t, 2t + 1 of each row, no shuffle.
//   * the tiles (activation, lo, hi) are float32 in 32-column blocks of 64
//     rows x 128 bytes, the 32-byte group c of row r at c ^ (r % 4): the
//     fragment loads and the epilogue's float2 stores hit 32 banks per
//     half-warp.
//   * a layer of n_pad outputs takes n_pad / 64 chunks per 32-deep K slab;
//     a consumer loads and splits its A fragment of the slab once (4 k8
//     steps, 32 registers), then runs each chunk's 12 products as one group
//     into a partial sum, waits for it, releases the slot and adds the
//     partial to its 64-column slice of the accumulator in float32 (the
//     tensor cores truncate as they accumulate: one accumulator for a
//     layer's products was several times less accurate than float32
//     products); the other consumer's groups keep the tensor cores busy
//     meanwhile. The A registers are kept live until the slab's last group
//     is done.
//   * the row pass stores its stash from the epilogue's registers (float2,
//     streaming), in the row-major layout the float32 weight pass reads, and
//     copies the lo (hi) tile there for F_IN; no TMA.
//
// Shared memory (`sm90_plan` / `bwd90_plan` in ops/fused_mlp.py compute the
// same): the ring, stages x 16 KB; per consumer its tiles, 8 KB per 32-column
// block (a 256-wide activation 64 KB, a 63-wide lo 16 KB); then the bf16
// engines' regions. The published fine MLP: forward 3 x 16 + 2 x 80 + 2.5 +
// 2 x 2 KB = 214.6 KB; row pass 3 x 16 + 2 x 80 + 4 + 2 + 8 + 4 KB =
// 226.1 KB, of the 227 KB. The 64 KB slots a 256-wide 32-deep slab would
// take, or 16-deep slabs in the 64-byte swizzle, leave no room for two.

#pragma once

#include "fused_mlp_sm90.cuh"

namespace tf32 {

using sm90::kBlockBytes;  // one 32-column float32 block of a consumer's 64 rows
using sm90::kRows;

constexpr int kChunkRows = 64;                 // output rows of one weight chunk
constexpr int kChunkBytes = kChunkRows * 128;  // one image of a chunk: 64 x 32 floats
constexpr int kSlotBytes = 2 * kChunkBytes;    // a ring slot: big image, then small
constexpr int kSlabK = 32;                     // depth of a chunk
constexpr int kChunkFloats = kChunkBytes / 4;

// ---- the split ----

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// Each 8 KB chunk of src (n_chunks of them) -> its big image, then its
// small image, in dst.
__global__ void fused_mlp_tf32_split_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                            long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long chunk = i / kChunkFloats, e = i - chunk * kChunkFloats;
  uint32_t big, small;
  split(src[i], big, small);
  float* d = dst + chunk * 2 * kChunkFloats + e;
  d[0] = __uint_as_float(big);
  d[kChunkFloats] = __uint_as_float(small);
}

// ---- tiles ----

// Byte offset of element (r, c) in a float32 tile of 32-column blocks.
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 5) * kBlockBytes + r * 128 + ((((c >> 3) & 3) ^ (r & 3)) << 5) + (c & 7) * 4;
}

// Rows row0 .. row0 + 63 of src (`cols` floats wide: rows are not 16-byte
// aligned) into a tile of kb blocks, four floats per thread and step; zeros
// past n_rows and past cols.
__device__ __forceinline__ void load_rows(unsigned char* tile, const float* __restrict__ src, int cols,
                                          int kb, int row0, int n_rows, int t) {
  const int per_row = kb * 8, chunks = kRows * per_row;
#pragma unroll 4
  for (int i = t; i < chunks; i += 128) {
    const int r = i / per_row, cc = i - r * per_row, gr = row0 + r;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = cc * 4 + e;
      v[e] = gr < n_rows && c < cols ? __ldg(src + (size_t)gr * cols + c) : 0.f;
    }
    *reinterpret_cast<float4*>(tile + tile_off(r, cc * 4)) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void st2(unsigned char* tile, int r, int c, float a, float b) {
  *reinterpret_cast<float2*>(tile + tile_off(r, c)) = make_float2(a, b);
}
__device__ __forceinline__ float2 ld2(const unsigned char* tile, int r, int c) {
  return *reinterpret_cast<const float2*>(tile + tile_off(r, c));
}

// ---- the product core ----

// The ring's waits. Built with -DSNERF_WGRAD_WATCHDOG (the probes'
// variants), a wait that lasts ~2 s traps, as fused_mlp_wgrad_sm90.cuh's do.
__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred P;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P;\n}\n"
      : "=r"(ok)
      : "r"(sm90::smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void ring_wait(uint64_t* bar, int parity) {
#ifdef SNERF_WGRAD_WATCHDOG
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 32)) __trap();
#else
  while (!mbar_try(bar, parity)) {
  }
#endif
}

// d[0..31] += A[64 x 8] (registers) @ B[8 x 64] (descriptor); the
// accumulator layout of sm90::wgmma_m64n64.
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int kSteps = kSlabK / 8;  // k8 steps of a slab

__device__ __forceinline__ void keep_live(uint32_t (&v)[kSteps][4]) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(v[s][i])::"memory");
}

// The thread's A fragments of the four k8 steps of one 32-column block,
// split: a[s] = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)} of step s
// in the permuted K order, i.e. columns 2t, 2t + 1 of rows g and g + 8.
__device__ __forceinline__ void load_a(const unsigned char* block, uint32_t (&big)[kSteps][4],
                                       uint32_t (&small)[kSteps][4], int t) {
  const int r0 = (t >> 5) * 16 + ((t & 31) >> 2), q = t & 3;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float2 x0 = ld2(block, r0, 8 * s + 2 * q), x1 = ld2(block, r0 + 8, 8 * s + 2 * q);
    const float v[4] = {x0.x, x1.x, x0.y, x1.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], big[s][i], small[s][i]);
  }
}

// The ring as a consumer walks it.
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, slot, phase;
};

// acc = sum over the segments of tile_seg @ W_seg for the consumer's 64 rows
// and N columns (N / 64 chunks per 32-deep slab, in the producer's order).
// Each chunk's 12 products go to a partial sum of their own, which is then
// added to the accumulator in float32: the tensor cores' accumulation
// truncates, and a layer's 96 products in one accumulator left the
// gradients several times further from float64 than float32 products are
// (PERF.md); a slab's 12 keep its error at the float32 plain version's.
template <int N>
__device__ __forceinline__ void product(float (&acc)[N / 2], int nseg, const int* src, const int* kb,
                                        const unsigned char* const* tiles, Ring& rg, int t) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int seg = 0; seg < nseg; ++seg) {
    const unsigned char* a = tiles[src[seg]];
    for (int k = 0; k < kb[seg]; ++k) {
      uint32_t big[kSteps][4], small[kSteps][4];
      load_a(a + k * kBlockBytes, big, small, t);
#pragma unroll
      for (int ch = 0; ch < N / 64; ++ch) {
        ring_wait(rg.full + rg.slot, rg.phase);
        const unsigned char* w = rg.base + rg.slot * kSlotBytes;
        const uint64_t db = sm90::desc_sw128(w), ds = sm90::desc_sw128(w + kChunkBytes);
        float part[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) part[i] = 0.f;
        sm90::wgmma_fence();
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {  // a k8 step: 32 bytes on in the chunk's rows
          mma(part, small[s], db + 2 * s);
          mma(part, big[s], ds + 2 * s);
          mma(part, big[s], db + 2 * s);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_acc(part);
        if (t == 0) sm90::mbar_arrive(rg.empty + rg.slot);  // the slot is read: release it
        if (++rg.slot == rg.stages) {
          rg.slot = 0;
          rg.phase ^= 1;
        }
        float* d = acc + 32 * ch;
#pragma unroll
        for (int i = 0; i < 32; ++i) d[i] += part[i];
      }
      keep_live(big);  // the registers stay the products' until they are done
      keep_live(small);
    }
  }
}

// One thread: the head weights (forward programs with heads), then every
// op's chunks in program order into the ring.
template <typename Program>
__device__ __forceinline__ void produce(const Program& p, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, const float* __restrict__ wts) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(wts);
  int slot = 0, phase = 0;
  for (int i = 0; i < p.n_ops; ++i) {
    const auto& op = p.ops[i];
    const int units = (op.kb[0] + op.kb[1] + op.kb[2]) * (op.n_pad / kChunkRows);
    for (int u = 0; u < units; ++u) {
      ring_wait(empty + slot, phase ^ 1);
      sm90::mbar_expect_tx(full + slot, kSlotBytes);
      sm90::bulk_g2s(ring + slot * kSlotBytes, src, kSlotBytes, full + slot);
      src += kSlotBytes;
      if (++slot == p.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
}

// ---- the forward ----

// Bias, hvx, ReLU and the store of the consumer's rows into its activation
// tile, then the folded head; sm90::epilogue without the bf16 rounding.
template <int N>
__device__ __forceinline__ void fwd_epilogue(float (&acc)[N / 2], const sm90::Op& op,
                                             const sm90::Program& p, const sm90::Smem& s,
                                             unsigned char* act, const float* cst,
                                             const float* __restrict__ hvx, float* __restrict__ out,
                                             const float* __restrict__ fpar, int row0, int t) {
  const int warp = t >> 5, lane = t & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int n_rows = p.n_rows, n = op.n;
  if (op.flags & sm90::FLAG_HVX) {
    const bool staged = p.hvx_rays > 0;
    const float* base = staged ? cst + sm90::kBiasFloats : hvx + (size_t)op.hvx_slot * (n_rows / p.ns) * n;
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
  const bool relu = op.flags & sm90::FLAG_RELU;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 b = *reinterpret_cast<const float2*>(cst + col);
    float v[4] = {acc[4 * j] + b.x, acc[4 * j + 1] + b.y, acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = v[e] = relu ? fmaxf(v[e], 0.f) : v[e];
    st2(act, r0, col, v[0], v[1]);
    st2(act, r1, col, v[2], v[3]);
  }
  const int nout = op.head_nout;
  if (nout == 0) return;
  const float* hw = s.heads + op.head_w;
  float* plane = out + (size_t)op.head_plane * n_rows;
#pragma unroll
  for (int o = 0; o < sm90::kMaxHead; ++o) {
    if (o >= nout) break;
    float a = 0.f, c = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      const float2 w = *reinterpret_cast<const float2*>(hw + o * N + col);
      a = fmaf(acc[4 * j + 1], w.y, fmaf(acc[4 * j], w.x, a));
      c = fmaf(acc[4 * j + 3], w.y, fmaf(acc[4 * j + 2], w.x, c));
    }
    const float a1 = __shfl_xor_sync(0xffffffffu, a, 1), c1 = __shfl_xor_sync(0xffffffffu, c, 1);
    a += a1;
    c += c1;
    const float a2 = __shfl_xor_sync(0xffffffffu, a, 2), c2 = __shfl_xor_sync(0xffffffffu, c, 2);
    a += a2;
    c += c2;
    if (q == 0) {
      const float bo = __ldg(fpar + op.head_b + o);
      if (row0 + r0 < n_rows) plane[(size_t)o * n_rows + row0 + r0] = a + bo;
      if (row0 + r1 < n_rows) plane[(size_t)o * n_rows + row0 + r1] = c + bo;
    }
  }
}

template <int N>
__device__ __forceinline__ void fwd_layer(const sm90::Op& op, const sm90::Program& p, const sm90::Smem& s,
                                          const unsigned char* const* tiles, const float* __restrict__ fpar,
                                          const float* __restrict__ hvx, float* __restrict__ out, int row0,
                                          int t, Ring& rg) {
  const int c = threadIdx.x / 128 - 1;  // the consumer
  float* cst = s.cst + c * p.cst_floats;
  sm90::stage_consts(op, p, cst, fpar, hvx, row0, t);
  float acc[N / 2];
  product<N>(acc, op.nseg, op.src, op.kb, tiles, rg, t);
  sm90::cp_commit_wait();
  sm90::named_sync(1 + c);  // staged constants landed; every thread's reads of the tile are done
  fwd_epilogue<N>(acc, op, p, s, const_cast<unsigned char*>(tiles[sm90::SRC_ACT]), cst, hvx, out, fpar,
                  row0, t);
}

// Consumer c (0 or 1) of the block: rows row0 .. row0 + 63.
__device__ __forceinline__ void consume_fwd(const sm90::Program& p, unsigned char* base,
                                            const sm90::Smem& s, int c, const float* __restrict__ lo,
                                            const float* __restrict__ hi, const float* __restrict__ hvx,
                                            const float* __restrict__ fpar, float* __restrict__ out) {
  const int t = threadIdx.x - 128 * (c + 1);
  const int row0 = blockIdx.x * sm90::kBM + c * kRows;
  const sm90::Tiles tl = sm90::tiles_of(base, p, c);
  const unsigned char* const tiles[3] = {tl.act, tl.lo, tl.hi};  // by SRC_ACT, SRC_LO, SRC_HI
  load_rows(tl.lo, lo, p.in_lo, p.lo_kb, row0, p.n_rows, t);
  if (p.in_hi > 0) load_rows(tl.hi, hi, p.in_hi, p.hi_kb, row0, p.n_rows, t);
  sm90::named_sync(1 + c);
  if (p.head_floats) ring_wait(s.head_bar, 0);
  Ring rg{s.ring, s.full, s.empty, p.stages, 0, 0};
  for (int i = 0; i < p.n_ops; ++i) {
    const sm90::Op& op = p.ops[i];
    if (op.n_pad == 256)
      fwd_layer<256>(op, p, s, tiles, fpar, hvx, out, row0, t, rg);
    else if (op.n_pad == 128)
      fwd_layer<128>(op, p, s, tiles, fpar, hvx, out, row0, t, rg);
    else
      fwd_layer<64>(op, p, s, tiles, fpar, hvx, out, row0, t, rg);
    sm90::named_sync(1 + c);  // the tile is complete before the next layer reads it
  }
}

}  // namespace tf32
