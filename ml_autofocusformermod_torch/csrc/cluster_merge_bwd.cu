// Fused PointConv cluster merge, backward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// ml_autofocusformermod_tpu/ops/merge_pallas.py::_merge_bwd_kernel (called
// from _merge_bwd_impl, merge_pallas.py:596-638). For the forward
//   out[t, i, c] = sum_{j,s} w[t, j*cs + s, i] * feat[ncc[t, j]*cs + s, c]
// it computes, with g = d out:
//   dw[t, (j,s), i] = sum_c g[t, i, c] * feat[ncc[t, j]*cs + s, c]
//   dfeat[r, c]    += sum_i w[t, (j,s), i] * g[t, i, c]   (r = ncc*cs + s)
// Rows of the padded last cluster (r >= n) read zero: their dw is 0 and
// they receive nothing. dw has the weights' dtype; dfeat is accumulated in
// f32 (as merge_pallas.py:627), the wrapper casts it to feat's dtype.
//
// What bounds it on the H100: memory and atomics. Each (centre, slot) reads
// one gathered feature row and the centre's ic = 4 gradient rows, and
// scatters one row into dfeat. The design:
//   * one warp per (centre, slot), slots fastest, so a block's warps share
//     the centre's g rows (L1 reuse);
//   * lanes over channels (coalesced row reads); dw is 4 warp reductions,
//     written by lane 0; dfeat is an f32 atomicAdd per element.
// The atomics add in an order that changes from run to run, so dfeat is
// not bitwise reproducible (the plain CPU path is).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kIC = 4;     // ClusterMerging's weight_net width
constexpr int kWarps = 8;  // warps per block

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
cluster_merge_bwd_kernel(const T* __restrict__ w, const T* __restrict__ feat,
                         const int* __restrict__ ncc, const T* __restrict__ g,
                         T* __restrict__ dw, float* __restrict__ dfeat, int b,
                         int n, int n_, int c, int nnc, int cs) {
  const int m = nnc * cs;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(b) * n_ * m) return;  // whole warp
  const long long centre = task / m;
  const int s = static_cast<int>(task % m);
  const int bi = static_cast<int>(centre / n_);
  const int r = ncc[centre * nnc + s / cs] * cs + (s % cs);
  T* dwrow = dw + task * kIC;
  if (r < 0 || r >= n) {  // padded row: reads zero
    if (lane < kIC) dwrow[lane] = from_f<T>(0.f);
    return;
  }
  const T* wrow = w + task * kIC;
  float wv[kIC];
#pragma unroll
  for (int i = 0; i < kIC; ++i) wv[i] = to_f(wrow[i]);
  const long long frow = (static_cast<long long>(bi) * n + r) * c;
  const T* grow = g + centre * kIC * c;
  float acc[kIC] = {0.f, 0.f, 0.f, 0.f};
  for (int ch = lane; ch < c; ch += 32) {
    const float f = to_f(feat[frow + ch]);
    float df = 0.f;
#pragma unroll
    for (int i = 0; i < kIC; ++i) {
      const float gv = to_f(grow[i * c + ch]);
      acc[i] += gv * f;
      df += wv[i] * gv;
    }
    atomicAdd(dfeat + frow + ch, df);
  }
#pragma unroll
  for (int i = 0; i < kIC; ++i) acc[i] = warp_sum(acc[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kIC; ++i) dwrow[i] = from_f<T>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* w, const void* feat, const void* ncc,
                   const void* g, void* dw, void* dfeat, int b, int n, int n_,
                   int c, int nnc, int cs, cudaStream_t stream) {
  const long long tasks = static_cast<long long>(b) * n_ * nnc * cs;
  if (tasks == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((tasks + kWarps - 1) / kWarps);
  cluster_merge_bwd_kernel<T><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(feat),
      static_cast<const int*>(ncc), static_cast<const T*>(g),
      static_cast<T*>(dw), static_cast<float*>(dfeat), b, n, n_, c, nnc, cs);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w, feat, g and dw). dfeat (b, n, c) is
// float32 and must be zeroed by the caller. ic must be 4. Returns a
// cudaError_t.
extern "C" int cluster_merge_bwd(const void* w, const void* feat,
                                 const void* ncc, const void* g, void* dw,
                                 void* dfeat, int b, int n, int n_, int c,
                                 int nnc, int cs, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(w, feat, ncc, g, dw, dfeat, b, n, n_, c, nnc, cs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(w, feat, ncc, g, dw, dfeat, b, n, n_, c, nnc,
                                 cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
