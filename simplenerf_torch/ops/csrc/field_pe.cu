// The fused field calls' positional-encoding operands, in one pass (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds the same block with jnp ops
// (fields/mlp.py `_trunk_inputs`, `ensemble_operands`) and leaves them to
// XLA; PyTorch runs them as a chain of kernels (a float32 product, sin,
// cos, three casts and a `torch.cat` of strided slices), each a round trip
// through device memory. This kernel writes the same tensors in one pass:
//   lo = [x | sin f<ds | cos f<ds]  (n, 3 + 6 ds)
//   hi = [sin f>=ds | cos f>=ds]    (n, 6 (d - ds)), where ds < d,
// with x = pts (n, 3) float32, the frequency-i block [sin|cos](x * 2^i) over
// the three coordinates, in the compute type (bfloat16 or float32). The
// ensemble's shared block is the same with ds = d.
//
// Numbers: the same as the PyTorch chain's, bit for bit. z = x * 2^i is an
// exact float32 product; sin and cos are the accurate sincosf (no fast-math
// flag, no __sinf, no angle doubling, which would compound rounding over the
// octaves); bfloat16 is __float2bfloat16_rn, which `.to(torch.bfloat16)` runs.
//
// What bounds it on an H100: bytes, with the arithmetic close behind. A
// point reads 12 B and writes (3 + 6 d) elements: 126 B in bfloat16 at
// d = 10, 27.8 GB for the 201 M points of a 756x1008 frame, 8.3 ms at
// 3.35 TB/s. It also takes 3 d sincosf (30 a point; at an estimated ~35
// FP32 instructions each on the fast path, ~6.3 ms at the SMs' FP32 rate).
// So the design moves each byte once, in full sectors, and keeps the sincosf
// streams of many blocks in flight beside the stores:
//   * a block takes a tile of kTile points (a multiple of 8, so a bfloat16
//     tile of rows starts on a 16-byte boundary whatever the row width; 4
//     rows would do in float32) with one thread per (point, coordinate):
//     thread u reads pts[tile * 3 + u], so the tile's xyz arrive in one
//     coalesced load and no thread reads a coordinate twice;
//   * each thread runs its coordinate's d octaves and writes x, sin and cos
//     into tiles in shared memory that already have the output layout;
//   * the block then copies each tile's contiguous span of lo (and of hi)
//     with 16-byte vector stores; only a ragged last tile's few trailing
//     elements are scalar stores.
//
// The integrated positional encoding of mip-NeRF (FreeNeRF's field) is a
// second kernel here, field_ipe_kernel: each point is a conical frustum,
// the interval [t_s, t_s+1] of its ray (o, d, base radius r) (nr rays of
// ns samples, edges t (nr, ns + 1)), approximated by a Gaussian of mean
// and diagonal variance (mip-NeRF's `conical_frustum_to_gaussian` with its
// stable form, `lift_gaussian` diag), and encoded with each octave's sine
// and cosine damped by exp(-1/2 4^l var):
//   lo = [mean | sin(2^l mean) e^(-4^l var / 2), l < L | cos(...) e^(...)]
// (n, 3 + 6 L), frequency-major as the PE block, each column times the
// step's frequency mask (FreeNeRF; none: ones). It reads each ray's o, d,
// r and its edges and writes lo once: 2 (3 + 6 L) bytes a point in
// bfloat16, 198 at L = 16, against 8 bytes of edges and 28 / ns of the
// ray. Numbers: the frustum moments are the float32 chain of
// `fused_mlp.ipe_operands_reference` in its order, each product and sum
// rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn: no contraction
// into FMAs; a division by a constant is the product with its float32
// reciprocal, as PyTorch runs a tensor over a scalar on the card), then
// sincosf and expf as the PE block's.
//
// Plain C interface (ctypes): snerf_field_pe and snerf_field_ipe return the
// CUDA error of the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;            // points a block
constexpr int kThreads = 3 * kTile;   // one thread per (point, coordinate)
constexpr int kSmemDefault = 48 * 1024;

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Copies `elems` elements of a tile from shared to device memory: 16-byte
// vectors over the whole span, then the elements past the last whole vector.
// Both spans start on a 16-byte boundary.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, const T* __restrict__ src,
                                           int elems) {
  constexpr int kVec = 16 / sizeof(T);
  const int vecs = elems / kVec;
  for (int v = threadIdx.x; v < vecs; v += blockDim.x)
    reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
  for (int e = vecs * kVec + threadIdx.x; e < elems; e += blockDim.x) dst[e] = src[e];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
field_pe_kernel(const float* __restrict__ pts, T* __restrict__ lo, T* __restrict__ hi,
                long long n, int d, int ds) {
  extern __shared__ __align__(16) unsigned char pe_smem[];
  const int w_lo = 3 + 6 * ds;
  const int w_hi = 6 * (d - ds);
  T* s_lo = reinterpret_cast<T*>(pe_smem);
  T* s_hi = s_lo + kTile * w_lo;  // kTile * w_lo * sizeof(T) is a multiple of 16

  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), n - t0));
  const int u = threadIdx.x;
  const int p = u / 3, j = u - 3 * (u / 3);
  if (p < rows) {
    const float x = pts[t0 * 3 + u];
    T* row_lo = s_lo + p * w_lo;
    row_lo[j] = to_out<T>(x);
    float scale = 1.0f;
    for (int i = 0; i < d; ++i, scale *= 2.0f) {
      float s, c;
      sincosf(x * scale, &s, &c);
      if (i < ds) {
        row_lo[3 + 3 * i + j] = to_out<T>(s);
        row_lo[3 + 3 * ds + 3 * i + j] = to_out<T>(c);
      } else {
        T* row_hi = s_hi + p * w_hi;
        row_hi[3 * (i - ds) + j] = to_out<T>(s);
        row_hi[3 * (d - ds) + 3 * (i - ds) + j] = to_out<T>(c);
      }
    }
  }
  __syncthreads();
  store_tile(lo + t0 * w_lo, s_lo, rows * w_lo);
  if (w_hi) store_tile(hi + t0 * w_hi, s_hi, rows * w_hi);
}

template <typename T>
int launch(const float* pts, void* lo, void* hi, long long n, int d, int ds, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTile) * (3 + 6 * d) * sizeof(T);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_pe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + kTile - 1) / kTile;
  field_pe_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      pts, static_cast<T*>(lo), static_cast<T*>(hi), n, d, ds);
  return static_cast<int>(cudaGetLastError());
}

// The frustum's Gaussian along its ray: (t_mean, t_var, r_var) of the
// interval [t0, t1] at base radius r (mip-NeRF's stable form).
__device__ __forceinline__ void frustum(float t0, float t1, float r, float& t_mean, float& t_var,
                                        float& r_var) {
  const float k13 = static_cast<float>(1.0 / 3.0), k415 = static_cast<float>(4.0 / 15.0),
              k512 = static_cast<float>(5.0 / 12.0);
  const float mu = __fmul_rn(__fadd_rn(t0, t1), 0.5f), hw = __fmul_rn(__fsub_rn(t1, t0), 0.5f);
  const float mu2 = __fmul_rn(mu, mu), hw2 = __fmul_rn(hw, hw);
  const float den = __fadd_rn(__fmul_rn(3.0f, mu2), hw2);
  const float hw4 = __fmul_rn(hw2, hw2);
  t_mean = __fadd_rn(mu, __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, mu), hw2), den));
  t_var = __fsub_rn(__fmul_rn(hw2, k13),
                    __fmul_rn(k415, __fdiv_rn(__fmul_rn(hw4, __fsub_rn(__fmul_rn(12.0f, mu2), hw2)),
                                              __fmul_rn(den, den))));
  r_var = __fmul_rn(__fmul_rn(r, r),
                    __fsub_rn(__fadd_rn(__fmul_rn(mu2, 0.25f), __fmul_rn(k512, hw2)),
                              __fdiv_rn(__fmul_rn(k415, hw4), den)));
}

// One thread per (point, coordinate), as field_pe_kernel; the tile of lo
// rows is assembled in shared memory and copied out in 16-byte vectors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
field_ipe_kernel(const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ radii, const float* __restrict__ t,
                 const float* __restrict__ mask, T* __restrict__ lo, long long n, int ns, int deg) {
  extern __shared__ __align__(16) unsigned char ipe_smem[];
  const int w_lo = 3 + 6 * deg;
  T* s_lo = reinterpret_cast<T*>(ipe_smem);
  const long long p0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = static_cast<int>(min(static_cast<long long>(kTile), n - p0));
  const int u = threadIdx.x;
  const int p = u / 3, j = u - 3 * (u / 3);
  if (p < rows) {
    const long long gp = p0 + p, ray = gp / ns;
    const long long e = ray * (ns + 1) + (gp - ray * ns);
    float t_mean, t_var, r_var;
    frustum(__ldg(t + e), __ldg(t + e + 1), __ldg(radii + ray), t_mean, t_var, r_var);
    const float d0 = __ldg(d + 3 * ray), d1 = __ldg(d + 3 * ray + 1), d2 = __ldg(d + 3 * ray + 2);
    const float dj = j == 0 ? d0 : j == 1 ? d1 : d2;
    const float ddj = __fmul_rn(dj, dj);
    const float mag = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)), __fmul_rn(d2, d2)),
                            1e-10f);
    const float mean = __fadd_rn(__ldg(o + 3 * ray + j), __fmul_rn(dj, t_mean));
    const float var = __fadd_rn(__fmul_rn(t_var, ddj), __fmul_rn(r_var, __fsub_rn(1.0f, __fdiv_rn(ddj, mag))));
    T* row = s_lo + p * w_lo;
    row[j] = to_out<T>(mask ? __fmul_rn(mean, __ldg(mask + j)) : mean);
    float scale = 1.0f, scale2 = 1.0f;
    for (int l = 0; l < deg; ++l, scale *= 2.0f, scale2 *= 4.0f) {
      float sn, cs;
      sincosf(mean * scale, &sn, &cs);
      const float damp = expf(-0.5f * (var * scale2));
      float vs = __fmul_rn(sn, damp), vc = __fmul_rn(cs, damp);
      if (mask) {
        vs = __fmul_rn(vs, __ldg(mask + 3 + 3 * l + j));
        vc = __fmul_rn(vc, __ldg(mask + 3 + 3 * deg + 3 * l + j));
      }
      row[3 + 3 * l + j] = to_out<T>(vs);
      row[3 + 3 * deg + 3 * l + j] = to_out<T>(vc);
    }
  }
  __syncthreads();
  store_tile(lo + p0 * w_lo, s_lo, rows * w_lo);
}

template <typename T>
int launch_ipe(const float* o, const float* d, const float* radii, const float* t, const float* mask,
               void* lo, long long n, int ns, int deg, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kTile) * (3 + 6 * deg) * sizeof(T);
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        field_ipe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (n + kTile - 1) / kTile;
  field_ipe_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      o, d, radii, t, mask, static_cast<T*>(lo), n, ns, deg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pts (n, 3) float32; lo (n, 3 + 6 ds) and, where ds < d, hi (n, 6 (d - ds)), in
// bfloat16 (bf16 = 1) or float32, every array contiguous, lo and hi on
// 16-byte boundaries. Launches on `stream`; nothing for n = 0.
extern "C" int snerf_field_pe(const void* pts, void* lo, void* hi, long long n, int d, int ds,
                              int bf16, void* stream) {
  if (n <= 0) return 0;
  if (ds < 0 || ds > d) return static_cast<int>(cudaErrorInvalidValue);
  const float* p = static_cast<const float*>(pts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, lo, hi, n, d, ds, s) : launch<float>(p, lo, hi, n, d, ds, s);
}

// The integrated PE of n = nr * ns frustums: o, d (nr, 3), radii (nr,) and
// edges t (nr, ns + 1) float32, mask (3 + 6 deg) float32 or null (ones); lo
// (n, 3 + 6 deg) in bfloat16 (bf16 = 1) or float32, on a 16-byte boundary.
// Launches on `stream`; nothing for n = 0.
extern "C" int snerf_field_ipe(const void* o, const void* d, const void* radii, const void* t,
                               const void* mask, void* lo, long long n, int ns, int deg, int bf16,
                               void* stream) {
  if (n <= 0) return 0;
  if (ns <= 0 || n % ns || deg < 0 || deg > 32) return static_cast<int>(cudaErrorInvalidValue);
  const float* args[5] = {static_cast<const float*>(o), static_cast<const float*>(d),
                          static_cast<const float*>(radii), static_cast<const float*>(t),
                          static_cast<const float*>(mask)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_ipe<__nv_bfloat16>(args[0], args[1], args[2], args[3], args[4], lo, n, ns, deg, s)
              : launch_ipe<float>(args[0], args[1], args[2], args[3], args[4], lo, n, ns, deg, s);
}
