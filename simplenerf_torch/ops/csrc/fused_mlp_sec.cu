// Secondary-view visibility of the bf16 fused field MLP (ViP-NeRF's prior)
// for Hopper: the views branch evaluated again at each point for k other
// cameras' directions, the visibility row of its head only, and the
// backward of that.
//
// Replaces no TPU kernel: simplenerf_tpu evaluates secondary views through
// its concat-form reference only (`apply_reference`'s view_dirs2 branch).
// Per point i and other view j the views layer's pre-activation is
//   pre_ij = pre_i + pe_ij @ W_dir,
// where pre_i (n_rows x wv float32) is the layer's products plus bias
// without the primary view's hvx, stored by the forward kernel's hvx layer
// (fused_mlp_sm90.cuh, kPre), pe_ij the blocked PE of the direction from
// camera j to the point (bf16, pe_w <= kMaxPe channels, rows i * k + j) and
// W_dir the dirs rows of the views layer's weight (float32 holding bf16
// values). The raw plane is v_ij = sum_c bf16(relu(pre_ij))[c] * w_vis[c] +
// b_vis (head = [w_vis | b_vis], the views head's last channel). The
// backward takes dv (k x n_rows) and writes
//   sec_i = sum_j dv_ij * w_vis * [pre_ij > 0]       (n_rows x wv),
// which the row pass adds to the hvx layer's g after dhvx's g32
// (fused_mlp_bwd_sm90.cuh, kSec), and per block the partial sums of
// dW_dir = sum pe_ij^T dpre_ij, dw_vis = sum bf16(relu(pre_ij)) dv_ij and
// db_vis = sum dv_ij, in that order, which a fixed-order column sum reduces
// (snerf_colsum), so the gradients do not change from run to run.
//
// What bounds them: the per-pair products, pe_w x wv multiply-adds (27 x 128
// at the published widths) forward, that again and the direction rows'
// dW backward, run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// float32 accumulate); then the bytes, pre read once a point (and again,
// from L1, for each of its pairs), sec written once. A warp takes a tile of
// 16 / k points, their pairs the 16 rows of the tiles' A (row r = point
// r / k's pair r % k): the tile's PE rows are staged in shared memory
// (columns past pe_w and rows past the last pair zero), W_dir (K = 32,
// N = wv <= 128) is the B operand, held in registers as fragments. The
// forward's epilogue adds pre, rounds relu to bf16 and sums the head row
// per row (a fixed order: the thread's columns, then the quad of lanes).
// The backward forms dpre = dv w_vis [pre_ij > 0] in the accumulators,
// stages it in shared memory, sums each point's k rows into sec, and
// takes dW_dir += pe^T round(dpre) as a second product (M = the 32 PE
// channels, K = the tile's 16 pairs) into accumulators in shared memory;
// dw_vis and db_vis are float32 sums in registers. A block's partials are
// its warps' in warp order.
//
// Plain C interface (ctypes): snerf_sec_fwd, snerf_sec_bwd return the CUDA
// error of the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sec {

constexpr int kMaxPe = 32;   // PE channels of a direction: 3 + 6 x degree, two k16 steps
constexpr int kMaxWv = 128;  // views width: 16 n8 tiles
constexpr int kNt = kMaxWv / 8;
constexpr int kMaxViews = 8;
constexpr int kWarps = 4;
constexpr int kPeLd = kMaxPe + 8;    // bf16 a staged PE row (80 bytes: no bank conflicts)
constexpr int kDpLd = kMaxWv + 4;    // floats a staged dpre row
constexpr int kBwdSmem = kWarps * (16 * kDpLd + kMaxPe * kMaxWv) * 4;  // two blocks an SM

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d = a @ b + c: m16n8k16, bf16 operands, float32 accumulators. Fragments
// (g = lane / 4, t = lane % 4): a0 (row g, cols 2t, 2t+1), a1 (row g+8),
// a2 (row g, cols 2t+8, 2t+9), a3 (row g+8); b0 (rows 2t, 2t+1, col g), b1
// (rows 2t+8, 2t+9); c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// W_dir's B fragments (K = the PE channel, N = the column), zeros past pe_w and wv.
__device__ __forceinline__ void load_wfrag(uint32_t (&wf)[2][kNt][2], const float* __restrict__ w,
                                           int pe_w, int wv, int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto at = [&](int kk, int n) { return kk < pe_w && n < wv ? w[(size_t)kk * wv + n] : 0.f; };
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int kk = 16 * ks + 2 * t, n = 8 * nt + g;
      wf[ks][nt][0] = pack(at(kk, n), at(kk + 1, n));
      wf[ks][nt][1] = pack(at(kk + 8, n), at(kk + 9, n));
    }
}

// The tile's PE rows (rows of pairs row0 .. row0 + rows - 1, each pe_w
// bf16, contiguous in pe) into the warp's staging rows, zeros elsewhere.
__device__ __forceinline__ void stage_pe(__nv_bfloat16 (*ps)[kPeLd], const __nv_bfloat16* __restrict__ pe,
                                         size_t row0, int rows, int pe_w, int lane) {
  __syncwarp();  // the previous tile's rows are read
  uint32_t* z = reinterpret_cast<uint32_t*>(&ps[0][0]);
  for (int i = lane; i < 16 * kPeLd / 2; i += 32) z[i] = 0u;
  __syncwarp();
  const __nv_bfloat16* src = pe + row0 * pe_w;
  for (int e = lane; e < rows * pe_w; e += 32) ps[e / pe_w][e % pe_w] = src[e];
  __syncwarp();
}

// The A fragments of the tile's PE rows (M = the pair row, K = the channel).
__device__ __forceinline__ void pe_afrag(uint32_t (&a)[2][4], __nv_bfloat16 (*ps)[kPeLd], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int c = 16 * ks + 2 * t;
    a[ks][0] = *reinterpret_cast<const uint32_t*>(&ps[g][c]);
    a[ks][1] = *reinterpret_cast<const uint32_t*>(&ps[g + 8][c]);
    a[ks][2] = *reinterpret_cast<const uint32_t*>(&ps[g][c + 8]);
    a[ks][3] = *reinterpret_cast<const uint32_t*>(&ps[g + 8][c + 8]);
  }
}

// acc[nt] = the tile's 16 pair rows @ W_dir, columns 8 nt .. 8 nt + 7.
__device__ __forceinline__ void dirs_product(float (&acc)[kNt][4], const uint32_t (&a)[2][4],
                                             const uint32_t (&wf)[2][kNt][2]) {
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    mma(acc[nt], a[0], wf[0][nt][0], wf[0][nt][1]);
    mma(acc[nt], a[1], wf[1][nt][0], wf[1][nt][1]);
  }
}

__device__ __forceinline__ float2 ld2(const float* p, bool on) {
  return on ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
}

__global__ void __launch_bounds__(32 * kWarps, 2)
sec_fwd_kernel(const float* __restrict__ pre, const __nv_bfloat16* __restrict__ pe,
               const float* __restrict__ w, const float* __restrict__ head, float* __restrict__ out,
               int n_rows, int k, int pe_w, int wv) {
  __shared__ __align__(16) __nv_bfloat16 pe_rows[kWarps][16][kPeLd];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  uint32_t wf[2][kNt][2];
  load_wfrag(wf, w, pe_w, wv, lane);
  const float hb = head[wv];
  const int per = 16 / k, n_tiles = (n_rows + per - 1) / per;
  for (int ti = blockIdx.x * kWarps + wid; ti < n_tiles; ti += gridDim.x * kWarps) {
    const int p0 = ti * per, rows = min(per, n_rows - p0) * k;
    stage_pe(pe_rows[wid], pe, (size_t)p0 * k, rows, pe_w, lane);
    uint32_t a[2][4];
    pe_afrag(a, pe_rows[wid], lane);
    float acc[kNt][4];
    dirs_product(acc, a, wf);
    const int r[2] = {g, g + 8};
    float v[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = r[h] < rows;
      const float* pr = pre + (size_t)(p0 + (ok ? r[h] / k : 0)) * wv;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int col = 8 * nt + 2 * t;
        const bool on = ok && col < wv;
        const float2 pa = ld2(pr + col, on), hw = ld2(head + col, on);
        v[h] = fmaf(bf16r(fmaxf(acc[nt][2 * h] + pa.x, 0.f)), hw.x, v[h]);
        v[h] = fmaf(bf16r(fmaxf(acc[nt][2 * h + 1] + pa.y, 0.f)), hw.y, v[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
      if (t == 0 && r[h] < rows) out[(size_t)(r[h] % k) * n_rows + p0 + r[h] / k] = v[h] + hb;
    }
  }
}

__global__ void __launch_bounds__(32 * kWarps, 2)
sec_bwd_kernel(const float* __restrict__ pre, const __nv_bfloat16* __restrict__ pe,
               const float* __restrict__ w, const float* __restrict__ head,
               const float* __restrict__ dv, float* __restrict__ sec, float* __restrict__ part,
               int n_rows, int k, int pe_w, int wv) {
  __shared__ __align__(16) __nv_bfloat16 pe_rows[kWarps][16][kPeLd];
  __shared__ float vis[kMaxWv + 1];
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  float (*dp)[kDpLd] = reinterpret_cast<float (*)[kDpLd]>(sm + wid * 16 * kDpLd);
  float* dw0 = sm + kWarps * 16 * kDpLd;  // the warps' dW_dir sums, [channel][column] each
  float* dw = dw0 + wid * kMaxPe * kMaxWv;
  for (int i = lane; i < kMaxPe * kMaxWv; i += 32) dw[i] = 0.f;
  uint32_t wf[2][kNt][2];
  load_wfrag(wf, w, pe_w, wv, lane);
  float gh[kNt][2];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) gh[nt][0] = gh[nt][1] = 0.f;
  float gb = 0.f;
  const int per = 16 / k, n_tiles = (n_rows + per - 1) / per;
  for (int ti = blockIdx.x * kWarps + wid; ti < n_tiles; ti += gridDim.x * kWarps) {
    const int p0 = ti * per, rows = min(per, n_rows - p0) * k;
    stage_pe(pe_rows[wid], pe, (size_t)p0 * k, rows, pe_w, lane);
    uint32_t a[2][4];
    pe_afrag(a, pe_rows[wid], lane);
    float acc[kNt][4];
    dirs_product(acc, a, wf);
    const int r[2] = {g, g + 8};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = r[h] < rows;
      const int q = p0 + (ok ? r[h] / k : 0);
      const float* pr = pre + (size_t)q * wv;
      const float gr = ok ? dv[(size_t)(r[h] % k) * n_rows + q] : 0.f;
      if (t == 0) gb += gr;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int col = 8 * nt + 2 * t;
        const bool on = ok && col < wv;
        const float2 pa = ld2(pr + col, on), hw = ld2(head + col, on);
        const float x0 = acc[nt][2 * h] + pa.x, x1 = acc[nt][2 * h + 1] + pa.y;
        gh[nt][0] = fmaf(bf16r(fmaxf(x0, 0.f)), gr, gh[nt][0]);
        gh[nt][1] = fmaf(bf16r(fmaxf(x1, 0.f)), gr, gh[nt][1]);
        *reinterpret_cast<float2*>(&dp[r[h]][col]) =
            make_float2(x0 > 0.f ? gr * hw.x : 0.f, x1 > 0.f ? gr * hw.y : 0.f);
      }
    }
    __syncwarp();
    // sec: each point's k rows summed in order, four columns a lane.
    for (int pt = 0; pt * k < rows; ++pt) {
      const int c = 4 * lane;
      if (c < wv) {
        float4 sgm = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < k; ++j) {
          const float4 x = *reinterpret_cast<const float4*>(&dp[pt * k + j][c]);
          sgm.x += x.x, sgm.y += x.y, sgm.z += x.z, sgm.w += x.w;
        }
        __stcs(reinterpret_cast<float4*>(sec + (size_t)(p0 + pt) * wv + c), sgm);
      }
    }
    // dW_dir += pe^T round(dpre): M = the channel, K = the tile's pair rows.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (16 * mt >= pe_w) break;
      const int c0 = 16 * mt + g;
      uint32_t at[4];
      at[0] = pack2(pe_rows[wid][2 * t][c0], pe_rows[wid][2 * t + 1][c0]);
      at[1] = pack2(pe_rows[wid][2 * t][c0 + 8], pe_rows[wid][2 * t + 1][c0 + 8]);
      at[2] = pack2(pe_rows[wid][2 * t + 8][c0], pe_rows[wid][2 * t + 9][c0]);
      at[3] = pack2(pe_rows[wid][2 * t + 8][c0 + 8], pe_rows[wid][2 * t + 9][c0 + 8]);
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int n = 8 * nt + g;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        mma(d, at, pack(dp[2 * t][n], dp[2 * t + 1][n]), pack(dp[2 * t + 8][n], dp[2 * t + 9][n]));
        float* o0 = dw + (16 * mt + g) * kMaxWv + 8 * nt + 2 * t;
        float* o1 = o0 + 8 * kMaxWv;
        o0[0] += d[0], o0[1] += d[1], o1[0] += d[2], o1[1] += d[3];
      }
    }
  }
  // dw_vis over the warp's rows: the lanes of a column pair (same t) summed,
  // g in a fixed butterfly; db_vis over the warp.
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) gh[nt][e] += __shfl_xor_sync(0xffffffffu, gh[nt][e], o);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) gb += __shfl_xor_sync(0xffffffffu, gb, o);
  // The block's partials: the warps' sums added in warp order (each dW_dir
  // element by one thread, warp 0's, then 1's, ...; the rest at barriers).
  for (int i = threadIdx.x; i <= kMaxWv; i += blockDim.x) vis[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxPe * kMaxWv; i += blockDim.x)
    for (int v = 1; v < kWarps; ++v) dw0[i] += dw0[v * kMaxPe * kMaxWv + i];
  for (int v = 0; v < kWarps; ++v) {
    if (wid == v) {
      if (g == 0)
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int col = 8 * nt + 2 * t;
          if (col < wv) vis[col] += gh[nt][0], vis[col + 1] += gh[nt][1];
        }
      if (lane == 0) vis[kMaxWv] += gb;
    }
    __syncthreads();
  }
  const int n_part = pe_w * wv + wv + 1;
  float* out = part + (size_t)blockIdx.x * n_part;
  for (int i = threadIdx.x; i < n_part; i += blockDim.x)
    out[i] = i < pe_w * wv ? dw0[(i / wv) * kMaxWv + i % wv] : i < n_part - 1 ? vis[i - pe_w * wv] : vis[kMaxWv];
}

bool valid(int n_rows, int k, int pe_w, int wv) {
  return n_rows > 0 && k > 0 && k <= kMaxViews && pe_w > 0 && pe_w <= kMaxPe && wv > 0 &&
         wv <= kMaxWv && wv % 4 == 0;
}

}  // namespace sec

// Raw secondary visibility planes out (k x n_rows float32) of pre (n_rows x
// wv float32), pe ((n_rows k) x pe_w bf16), w (pe_w x wv float32), head
// (wv + 1 float32: the visibility row, its bias); `blocks` blocks of
// sec::kWarps warps, a warp a tile of 16 / k points at a time.
extern "C" int snerf_sec_fwd(const void* pre, const void* pe, const void* w, const void* head,
                             void* out, int n_rows, int k, int pe_w, int wv, int blocks,
                             void* stream) {
  if (!sec::valid(n_rows, k, pe_w, wv) || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sec::sec_fwd_kernel<<<blocks, 32 * sec::kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const __nv_bfloat16*>(pe),
      static_cast<const float*>(w), static_cast<const float*>(head), static_cast<float*>(out), n_rows,
      k, pe_w, wv);
  return static_cast<int>(cudaGetLastError());
}

// Its backward from dv (k x n_rows float32): sec (n_rows x wv float32) and
// part (blocks x (pe_w wv + wv + 1) float32), each block's partial sums of
// dW_dir, dw_vis and db_vis; the same `blocks` give the same bits.
extern "C" int snerf_sec_bwd(const void* pre, const void* pe, const void* w, const void* head,
                             const void* dv, void* sec_out, void* part, int n_rows, int k, int pe_w,
                             int wv, int blocks, void* stream) {
  if (!sec::valid(n_rows, k, pe_w, wv) || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(sec::sec_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         sec::kBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sec::sec_bwd_kernel<<<blocks, 32 * sec::kWarps, sec::kBwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const __nv_bfloat16*>(pe),
      static_cast<const float*>(w), static_cast<const float*>(head), static_cast<const float*>(dv),
      static_cast<float*>(sec_out), static_cast<float*>(part), n_rows, k, pe_w, wv);
  return static_cast<int>(cudaGetLastError());
}
