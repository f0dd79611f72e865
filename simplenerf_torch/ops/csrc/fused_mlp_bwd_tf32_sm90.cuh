// Row pass of the float32 fused-MLP backward on Hopper's tensor cores
// (sm_90a): the device code of fused_mlp_bwd_rows_tf32_kernel in
// fused_mlp_bwd.cu, the float32 counterpart of the row half of
// simplenerf_tpu/ops/fused_mlp.py `_bwd_kernel` and `_ens_bwd_kernel`.
//
// It is the bf16 row pass (fused_mlp_bwd_sm90.cuh: its program, the
// forward recomputed, the walk back, the ReLU mask words, db from g, the
// head partials, the consumers' hand-over) on the 3xTF32 core of
// fused_mlp_tf32_sm90.cuh (see there: the split, the weight chunks, A from
// registers, the permuted K order, the float32 tiles, shared memory), with
// two changes that float32 brings: nothing is rounded (g, the activations
// and the stash are float32), and the stash leaves from the epilogues'
// registers as streaming float2 stores, row-major, as the float32 weight
// pass (fused_mlp_bwd_weights_kernel, fused_mlp_bwd.cu) reads it; no TMA.

#pragma once

#include "fused_mlp_bwd_sm90.cuh"
#include "fused_mlp_tf32_sm90.cuh"

namespace tf32 {

struct BCtx {  // one consumer's place in the block and in the ring
  bwd90::Ctx x;
  Ring rg;
  const unsigned char* tiles[3];
};

// The consumer's 64 rows of `v` pairs at (row, col) into the op's stash
// slot (row-major, n wide), streaming; rows past n_rows are not stored.
__device__ __forceinline__ void stash2(float* st, int n, int n_rows, int gr, int col, float a, float b) {
  if (gr < n_rows) __stcs(reinterpret_cast<float2*>(st + (size_t)gr * n + col), make_float2(a, b));
}

// F_IN: the consumer's rows of the lo (hi) tile, n columns, to the stash.
__device__ __forceinline__ void stash_tile(const unsigned char* tile, int n, float* st, int row0,
                                           int n_rows, int t) {
  const int per_row = n / 4;
  for (int i = t; i < kRows * per_row; i += 128) {
    const int r = i / per_row, c = (i - r * per_row) * 4;
    if (row0 + r < n_rows)
      __stcs(reinterpret_cast<float4*>(st + (size_t)(row0 + r) * n + c),
             *reinterpret_cast<const float4*>(tile + tile_off(r, c)));
  }
}

// A forward op's epilogue: bias, hvx, ReLU, the tile and the stash, the
// ReLU mask of the values to `mask` (bwd90::f_epilogue in float32).
template <int N>
__device__ __forceinline__ void f_epilogue(float (&acc)[N / 2], const bwd90::Op& op, const BCtx& b,
                                           const float* cst, const float* __restrict__ hvx,
                                           float* __restrict__ stash, uint4* mask) {
  const bwd90::Ctx& x = b.x;
  const bwd90::Program& p = *x.p;
  const int warp = x.t >> 5, lane = x.t & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int n_rows = p.n_rows, n = op.n, row0 = x.row0;
  if (op.flags & bwd90::FLAG_HVX) {
    const bool staged = p.hvx_rays > 0;
    const float* base =
        staged ? cst + bwd90::kBiasFloats : hvx + (size_t)op.hvx_slot * (n_rows / p.ns) * n;
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
  const bool relu = op.flags & bwd90::FLAG_RELU;
  float* st = op.map >= 0 ? stash + (size_t)op.out_slot * n_rows : nullptr;
  unsigned char* act = const_cast<unsigned char*>(b.tiles[bwd90::SRC_ACT]);
  uint32_t bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const float2 bb = *reinterpret_cast<const float2*>(cst + col);
    float v[4] = {acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y, acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = relu ? fmaxf(v[e], 0.f) : v[e];
    st2(act, r0, col, v[0], v[1]);
    st2(act, r1, col, v[2], v[3]);
    if (st && col < n) {
      stash2(st, n, n_rows, row0 + r0, col, v[0], v[1]);
      stash2(st, n, n_rows, row0 + r1, col, v[2], v[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) bits[j >> 3] |= (v[e] > 0.f ? 1u : 0u) << (4 * (j & 7) + e);
  }
  if (relu) *mask = make_uint4(bits[0], bits[1], bits[2], bits[3]);
}

// The per-tile partials of the head a forward op feeds (bwd90::head_partials
// reading the float32 tile).
__device__ __forceinline__ void head_partials(const bwd90::Op& op, BCtx& b, float* __restrict__ part) {
  bwd90::Ctx& x = b.x;
  const int n = op.n, hn = op.head_nout, col = 2 * x.t;
  const float4* dsm = reinterpret_cast<const float4*>(x.s.dsm + x.c * bwd90::kDpFloats);
  const unsigned char* act = b.tiles[bwd90::SRC_ACT];
  float w0[bwd90::kMaxHead], w1[bwd90::kMaxHead], db[bwd90::kMaxHead], my_db = 0.f;
#pragma unroll
  for (int q = 0; q < bwd90::kMaxHead; ++q) w0[q] = w1[q] = db[q] = 0.f;
  const bool active = col < n;
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    const float4 d4 = dsm[r];
    const float d[bwd90::kMaxHead] = {d4.x, d4.y, d4.z, d4.w};
    const float2 a = active ? ld2(act, r, col) : make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < bwd90::kMaxHead; ++q) {
      w0[q] = fmaf(a.x, d[q], w0[q]);
      w1[q] = fmaf(a.y, d[q], w1[q]);
      db[q] += d[q];
    }
  }
#pragma unroll
  for (int q = 0; q < bwd90::kMaxHead; ++q) my_db = q == x.t ? db[q] : my_db;
  float* buf = bwd90::hand_over_begin(x);
  if (x.c == 1) {
#pragma unroll
    for (int q = 0; q < bwd90::kMaxHead; ++q)
      if (q < hn && active) *reinterpret_cast<float2*>(buf + q * 256 + col) = make_float2(w0[q], w1[q]);
    if (x.t < hn) buf[bwd90::kMaxHead * 256 + x.t] = my_db;
  } else {
#pragma unroll
    for (int q = 0; q < bwd90::kMaxHead; ++q)
      if (q < hn && active) {
        const float2 o = *reinterpret_cast<const float2*>(buf + q * 256 + col);
        float* dst = part + op.part + q * n + col;
        dst[0] = w0[q] + o.x;
        dst[1] = w1[q] + o.y;
      }
    if (x.t < hn) part[op.part2 + x.t] = my_db + buf[bwd90::kMaxHead * 256 + x.t];
  }
  bwd90::hand_over_end(x);
  sm90::named_sync(1 + x.c);  // every thread has read dsm and the tile
}

template <int N>
__device__ __forceinline__ void f_layer(const bwd90::Op& op, BCtx& b, const float* __restrict__ fpar,
                                        const float* __restrict__ hvx,
                                        const float* __restrict__ dplanes, float* __restrict__ stash,
                                        uint4* tmask, float* __restrict__ part) {
  bwd90::Ctx& x = b.x;
  const bwd90::Program& p = *x.p;
  float* cst = x.s.cst + x.c * p.cst_floats;
  bwd90::stage_consts(op, p, cst, fpar, hvx, x.row0, x.t);
  if (op.head_nout) bwd90::stage_dp(op, p, x.s.dsm + x.c * bwd90::kDpFloats, dplanes, x.row0, x.t);
  float acc[N / 2];
  product<N>(acc, op.nseg, op.src, op.kb, b.tiles, b.rg, x.t);
  sm90::cp_commit_wait();
  sm90::named_sync(1 + x.c);  // staged constants landed; every reader of the tile is done
  f_epilogue<N>(acc, op, b, cst, hvx, stash, tmask + op.mask_slot * bwd90::kMaskThreads);
  sm90::named_sync(1 + x.c);  // the tile is complete
  if (op.head_nout) head_partials(op, b, part);
}

// A backward op (bwd90::b_layer in float32): the product from the g above
// (or zeros at the top of a chain), then g in registers, its column sums,
// g to the tile and the stash.
template <int N>
__device__ __forceinline__ void b_layer(const bwd90::Op& op, BCtx& b, const float* __restrict__ fpar,
                                        const float* __restrict__ dplanes, const uint4* tmask,
                                        float* __restrict__ stash, float* __restrict__ g32,
                                        float* __restrict__ part) {
  bwd90::Ctx& x = b.x;
  const bwd90::Program& p = *x.p;
  const int warp = x.t >> 5, lane = x.t & 31, q = lane & 3;
  const int r0 = warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int n_rows = p.n_rows, n = op.n, hn = op.head_nout;
  const bool ok0 = x.row0 + r0 < n_rows, ok1 = x.row0 + r1 < n_rows;
  float acc[N / 2];
  if (op.nseg) {
    product<N>(acc, op.nseg, op.src, op.kb, b.tiles, b.rg, x.t);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  }
  // The mask words this thread packed in the layer's forward op and the
  // head's dp of its two rows, loaded after the product: held across it,
  // their registers spilled the accumulators (ptxas; PERF.md).
  const bool relu = op.flags & bwd90::FLAG_RELU;
  const uint4 mk = relu ? tmask[op.mask_slot * bwd90::kMaskThreads] : make_uint4(~0u, ~0u, ~0u, ~0u);
  float d0[bwd90::kMaxHead], d1[bwd90::kMaxHead];
#pragma unroll
  for (int h = 0; h < bwd90::kMaxHead; ++h) {
    const float* dp = dplanes + (size_t)(op.plane + h) * n_rows + x.row0;
    d0[h] = h < hn && ok0 ? dp[r0] : 0.f;
    d1[h] = h < hn && ok1 ? dp[r1] : 0.f;
  }
  sm90::named_sync(1 + x.c);  // every reader of the tile (products, head partials) is done
  if (hn) {
    const float* hw = fpar + op.head_w;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      if (col >= n) continue;
#pragma unroll
      for (int h = 0; h < bwd90::kMaxHead; ++h) {
        if (h >= hn) break;
        const float2 w = __ldg(reinterpret_cast<const float2*>(hw + h * N + col));
        acc[4 * j] = fmaf(d0[h], w.x, acc[4 * j]);
        acc[4 * j + 1] = fmaf(d0[h], w.y, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(d1[h], w.x, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(d1[h], w.y, acc[4 * j + 3]);
      }
    }
  }
  const uint32_t words[4] = {mk.x, mk.y, mk.z, mk.w};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on = ((words[j >> 3] >> (4 * (j & 7) + e)) & 1u) && (e < 2 ? ok0 : ok1);
      acc[4 * j + e] = on ? acc[4 * j + e] : 0.f;
    }
  }
  if (op.g32_slot >= 0) {
    float* g = g32 + (size_t)op.g32_slot * n_rows * n + (size_t)x.row0 * n;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = 8 * j + 2 * q;
      if (col >= n) continue;
      if (ok0) __stcs(reinterpret_cast<float2*>(g + (size_t)r0 * n + col), make_float2(acc[4 * j], acc[4 * j + 1]));
      if (ok1) __stcs(reinterpret_cast<float2*>(g + (size_t)r1 * n + col), make_float2(acc[4 * j + 2], acc[4 * j + 3]));
    }
  }
  // g to the tile and the stash; the warp's column sums to its red row.
  float* st = op.map >= 0 ? stash + (size_t)op.out_slot * n_rows : nullptr;
  unsigned char* act = const_cast<unsigned char*>(b.tiles[bwd90::SRC_ACT]);
  float* red = x.s.red + (x.c * 4 + warp) * 256;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * q;
    st2(act, r0, col, acc[4 * j], acc[4 * j + 1]);
    st2(act, r1, col, acc[4 * j + 2], acc[4 * j + 3]);
    if (st && col < n) {
      stash2(st, n, n_rows, x.row0 + r0, col, acc[4 * j], acc[4 * j + 1]);
      stash2(st, n, n_rows, x.row0 + r1, col, acc[4 * j + 2], acc[4 * j + 3]);
    }
    float s0 = acc[4 * j] + acc[4 * j + 2], s1 = acc[4 * j + 1] + acc[4 * j + 3];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (lane < 4) *reinterpret_cast<float2*>(red + col) = make_float2(s0, s1);
  }
  sm90::named_sync(1 + x.c);  // the tile and the consumer's red rows are complete
  const int col = 2 * x.t;
  const bool active = col < n;
  float2 s = make_float2(0.f, 0.f);
  if (active) {
    const float* mine = x.s.red + x.c * 4 * 256 + col;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 v = *reinterpret_cast<const float2*>(mine + w * 256);
      s.x += v.x;
      s.y += v.y;
    }
  }
  float* buf = bwd90::hand_over_begin(x);
  if (active) {
    if (x.c == 1) {
      *reinterpret_cast<float2*>(buf + col) = s;
    } else {
      const float2 o = *reinterpret_cast<const float2*>(buf + col);
      part[op.part + col] = s.x + o.x;
      part[op.part + col + 1] = s.y + o.y;
    }
  }
  bwd90::hand_over_end(x);
}

// Consumer c (0 or 1) of the row pass's block: rows row0 .. row0 + 63.
__device__ __forceinline__ void consume_rows(const bwd90::Program& p, unsigned char* base,
                                             const bwd90::Smem& s, int c, const float* __restrict__ lo,
                                             const float* __restrict__ hi, const float* __restrict__ hvx,
                                             const float* __restrict__ dplanes,
                                             const float* __restrict__ fpar, float* __restrict__ stash,
                                             float* __restrict__ g32, uint4* masks,
                                             float* __restrict__ parts) {
  BCtx b;
  bwd90::Ctx& x = b.x;
  x.p = &p;
  x.maps = nullptr;
  x.s = s;
  x.c = c;
  x.t = threadIdx.x - bwd90::kConsumerThreads * (c + 1);
  x.row0 = blockIdx.x * sm90::kBM + c * kRows;
  x.tl = bwd90::tiles_of(base, p, c);
  x.slot = x.phase = x.k = 0;
  b.rg = Ring{s.ring, s.full, s.empty, p.stages, 0, 0};
  b.tiles[bwd90::SRC_ACT] = x.tl.act;
  b.tiles[bwd90::SRC_LO] = x.tl.lo;
  b.tiles[bwd90::SRC_HI] = x.tl.hi;
  load_rows(x.tl.lo, lo, p.in_lo, p.lo_kb, x.row0, p.n_rows, x.t);
  if (p.in_hi > 0) load_rows(x.tl.hi, hi, p.in_hi, p.hi_kb, x.row0, p.n_rows, x.t);
  sm90::named_sync(1 + c);
  uint4* tmask = masks + (size_t)blockIdx.x * p.n_masks * bwd90::kMaskThreads + c * bwd90::kConsumerThreads + x.t;
  float* part = parts + (size_t)blockIdx.x * p.part_w;
  for (int i = 0; i < p.n_ops; ++i) {
    const bwd90::Op& op = p.ops[i];
    if (op.kind == bwd90::F_IN) {
      if (op.map >= 0)
        stash_tile(b.tiles[op.src[0]], op.n, stash + (size_t)op.out_slot * p.n_rows, x.row0, p.n_rows, x.t);
    } else if (op.kind == bwd90::F_LAYER) {
      if (op.n_pad == 256)
        f_layer<256>(op, b, fpar, hvx, dplanes, stash, tmask, part);
      else if (op.n_pad == 128)
        f_layer<128>(op, b, fpar, hvx, dplanes, stash, tmask, part);
      else
        f_layer<64>(op, b, fpar, hvx, dplanes, stash, tmask, part);
    } else {
      if (op.n_pad == 256)
        b_layer<256>(op, b, fpar, dplanes, tmask, stash, g32, part);
      else if (op.n_pad == 128)
        b_layer<128>(op, b, fpar, dplanes, tmask, stash, g32, part);
      else
        b_layer<64>(op, b, fpar, dplanes, tmask, stash, g32, part);
    }
  }
}

}  // namespace tf32
