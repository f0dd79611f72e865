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
// Plain C interface (ctypes): snerf_field_pe returns the CUDA error of the
// launch, 0 on success.

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
