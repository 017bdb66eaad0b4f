// Fused PointConv cluster merge, forward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// ml_autofocusformermod_tpu/ops/merge_pallas.py::_merge_fwd_kernel.
// Contract: fused_cluster_merge (merge_pallas.py:650), as wrapped by
// ml_autofocusformermod_torch/ops/cluster_merge.py:
//
//   out[t, i, c] = sum_j sum_s w[t, j*cs + s, i] * feat[ncc[t, j]*cs + s, c]
//
// with rows >= n (the padded last cluster) reading zero and f32
// accumulation; the output has the weights' dtype. ic (inner channels) = 4.
//
// What bounds it on the H100: memory. Each centre reads its (m, ic) weights
// and m = nnc*cs gathered feature rows and does 2*ic flops per gathered
// element; the floor is reading weights and feat once and writing out once.
// The TPU kernel kept the features resident in VMEM and gathered them with
// one-hot MXU matmuls; here a gather is native:
//   * one thread row (blockDim.x threads over c) per centre, several centres
//     per block; the centre's weights and token rows go to shared memory;
//   * each thread walks the m slots, reading one channel of each gathered
//     row (neighbouring threads read neighbouring channels: coalesced), and
//     keeps the ic sums in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kIC = 4;  // ClusterMerging's weight_net width

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

template <typename T>
__global__ void cluster_merge_fwd_kernel(const T* __restrict__ w,
                                         const T* __restrict__ feat,
                                         const int* __restrict__ ncc,
                                         T* __restrict__ out, int b, int n,
                                         int n_, int c, int nnc, int cs) {
  extern __shared__ float smem[];
  const int m = nnc * cs;
  float* s_w = smem + threadIdx.y * m * (kIC + 1);     // (m, ic) weights
  int* s_t = reinterpret_cast<int*>(s_w + m * kIC);    // token row, -1 = pad
  const long long centre =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  const bool active = centre < static_cast<long long>(b) * n_;
  const int bi = static_cast<int>(centre / n_);

  if (active) {
    const T* wrow = w + centre * m * kIC;
    for (int e = threadIdx.x; e < m * kIC; e += blockDim.x)
      s_w[e] = to_f(wrow[e]);
    const int* nrow = ncc + centre * nnc;
    for (int s = threadIdx.x; s < m; s += blockDim.x) {
      const int t = nrow[s / cs] * cs + (s % cs);
      s_t[s] = (t >= 0 && t < n) ? t : -1;
    }
  }
  __syncthreads();
  if (!active) return;

  const T* fb = feat + static_cast<long long>(bi) * n * c;
  T* orow = out + centre * kIC * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float acc[kIC] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < m; ++s) {
      const int t = s_t[s];
      if (t < 0) continue;
      const float f = to_f(fb[static_cast<long long>(t) * c + ch]);
#pragma unroll
      for (int i = 0; i < kIC; ++i) acc[i] += s_w[s * kIC + i] * f;
    }
#pragma unroll
    for (int i = 0; i < kIC; ++i) orow[i * c + ch] = from_f<T>(acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* w, const void* feat, const void* ncc,
                   void* out, int b, int n, int n_, int c, int nnc, int cs,
                   cudaStream_t stream) {
  const long long centres = static_cast<long long>(b) * n_;
  if (centres == 0 || c == 0) return cudaSuccess;
  int tx = ((c + 31) / 32) * 32;
  if (tx > 256) tx = 256;
  const int ty = 256 / tx;
  const dim3 block(tx, ty);
  const unsigned blocks = static_cast<unsigned>((centres + ty - 1) / ty);
  const size_t shmem = sizeof(float) * ty * nnc * cs * (kIC + 1);
  cluster_merge_fwd_kernel<T><<<blocks, block, shmem, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(feat),
      static_cast<const int*>(ncc), static_cast<T*>(out), b, n, n_, c, nnc,
      cs);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (weights, feat and out). ic must be 4.
// Returns a cudaError_t.
extern "C" int cluster_merge_fwd(const void* w, const void* feat,
                                 const void* ncc, void* out, int b, int n,
                                 int n_, int c, int nnc, int cs, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(w, feat, ncc, out, b, n, n_, c, nnc, cs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(w, feat, ncc, out, b, n, n_, c, nnc, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
