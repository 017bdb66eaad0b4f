// Fused local cluster attention, forward, for Hopper (sm_90a).
//
// Replaces both TPU Pallas kernels of the JAX package that compute this
// function: ml_autofocusformermod_tpu/ops/clusten_pallas.py::_fwd_kernel
// (windowed route, AFF stage 1) and ::_fwd_kernel_stacked (small-n route,
// stages 2 and 3). Contract: fused_cluster_attention
// (clusten_pallas.py:2942), as wrapped by
// ml_autofocusformermod_torch/ops/cluster_attention.py.
//
// Per query i, head hi (c_ = c / h, m = nnc * cs slots):
//   slot s = j*cs + r  ->  token t = ncc[i, j] * cs + r   (t >= n: padding)
//   logit_s = q_i . k_t + pe_kernel[:, hi] . (dx, dy, dist, sin, cos) + pe_bias[hi]
//   blank   = q_i . blank_k[:, hi]
//   out_i   = (sum_s e^(logit_s - mx) v_t + e^(blank - mx) blank_v[hi]) / denom
// Padded slots are excluded from the softmax (not weighted by exp(-100)).
// q is pre-scaled; kv holds per head k then v: channel (hi, 0|1, c_).
//
// What bounds it on the H100: memory and latency. Each query reads its
// 48 neighbour rows of k and v (a gather) and does ~4*m*c_ flops per head;
// the unique bytes (q, kv, out once each) are the floor. The TPU kernels'
// dense masked-plane formulation (clusten_pallas.py:8-17) existed to feed
// the MXU; here one warp gathers exactly the rows it needs:
//   * one warp per (image, query, head); the head index runs fastest, so a
//     block's warps share query rows and neighbouring queries share clusters
//     (L1/L2 reuse of the gathered rows);
//   * lanes over the m slots for the logits (16-byte vector loads of each k
//     row), geometry in f32 from the two positions;
//   * warp reductions of the max and the sum, joined with the blank logit;
//   * lanes over c_ for the AV sum (coalesced v-row reads).
// Loads are f32 or bf16, all math is f32, the output is q's dtype.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <type_traits>

namespace {

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

// elements of T in one 16-byte load
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  } else {
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(b2[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VEC: c_ * sizeof(T) is a multiple of 16 bytes, so every k row starts
// 16-byte aligned and is read with vector loads.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
cluster_attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ kv,
    const int* __restrict__ ncc, const float* __restrict__ pos,
    const float* __restrict__ pe_kernel, const float* __restrict__ pe_bias,
    const float* __restrict__ blank_k, const float* __restrict__ blank_v,
    T* __restrict__ out, int b, int n, int h, int c_, int nnc, int cs,
    int rel_width, int clamp_hi, long long ncc_bstride,
    long long pos_bstride) {
  extern __shared__ float smem[];
  const int m = nnc * cs;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_q = smem + warp * (c_ + 2 * m);  // the query row, f32
  float* s_p = s_q + c_;                    // logits, then probabilities
  int* s_t = reinterpret_cast<int*>(s_p + m);  // token row per slot, -1 = pad

  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(b) * n * h) return;  // whole warp
  const int hi = static_cast<int>(task % h);
  const long long bt = task / h;
  const int i = static_cast<int>(bt % n);
  const int bi = static_cast<int>(bt / n);
  const int c = h * c_;

  const T* qrow = q + (static_cast<long long>(bi) * n + i) * c + hi * c_;
  for (int ch = lane; ch < c_; ch += 32) s_q[ch] = to_f(qrow[ch]);
  __syncwarp();

  const float* posb = pos + bi * pos_bstride;
  const float pqx = posb[2 * i];
  const float pqy = posb[2 * i + 1];
  const int* nrow = ncc + bi * ncc_bstride + static_cast<long long>(i) * nnc;
  const float w0 = pe_kernel[0 * h + hi];
  const float w1 = pe_kernel[1 * h + hi];
  const float w2 = pe_kernel[2 * h + hi];
  const float w3 = pe_kernel[3 * h + hi];
  const float w4 = pe_kernel[4 * h + hi];
  const float pb_bias = pe_bias[hi];
  const float R = static_cast<float>(rel_width);
  const T* kvb = kv + static_cast<long long>(bi) * n * 2 * c;

  // --- logits: lanes over slots ---
  float mx = -INFINITY;
  for (int s = lane; s < m; s += 32) {
    int t = nrow[s / cs] * cs + (s % cs);
    float logit = -INFINITY;
    if (t >= 0 && t < n) {
      const T* krow = kvb + static_cast<long long>(t) * 2 * c + 2 * hi * c_;
      float acc = 0.f;
      if constexpr (VEC) {
        constexpr int N = Vec<T>::N;
        for (int ch = 0; ch < c_; ch += N) {
          float kf[N];
          load16(krow + ch, kf);
#pragma unroll
          for (int e = 0; e < N; ++e) acc += s_q[ch + e] * kf[e];
        }
      } else {
        for (int ch = 0; ch < c_; ++ch) acc += s_q[ch] * to_f(krow[ch]);
      }
      float dx = posb[2 * t] - pqx;
      float dy = posb[2 * t + 1] - pqy;
      if (clamp_hi >= 0) {  // MixRes clamp of table-frame coordinates
        dx = fminf(fmaxf(dx + R, 0.f), static_cast<float>(clamp_hi)) - R;
        dy = fminf(fmaxf(dy + R, 0.f), static_cast<float>(clamp_hi)) - R;
      }
      const float dist = sqrtf(dx * dx + dy * dy);
      float sn = 0.f, cn = 0.f;
      if (dist != 0.f) {
        sn = dy / dist;
        cn = dx / dist;
      }
      logit = acc + w0 * dx + w1 * dy + w2 * dist + w3 * sn + w4 * cn + pb_bias;
    } else {
      t = -1;
    }
    s_p[s] = logit;
    s_t[s] = t;
    mx = fmaxf(mx, logit);
  }

  // --- joint softmax with the blank logit ---
  float bl = 0.f;
  for (int ch = lane; ch < c_; ch += 32) bl += s_q[ch] * blank_k[ch * h + hi];
  bl = warp_sum(bl);
  mx = fmaxf(warp_max(mx), bl);
  float sum = 0.f;
  for (int s = lane; s < m; s += 32) {
    const float p = s_t[s] >= 0 ? expf(s_p[s] - mx) : 0.f;
    s_p[s] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  const float pb = expf(bl - mx);
  const float inv = 1.f / (sum + pb);
  __syncwarp();

  // --- AV: lanes over channels ---
  T* orow = out + (static_cast<long long>(bi) * n + i) * c + hi * c_;
  const T* vb = kvb + (2 * hi + 1) * c_;
  for (int ch = lane; ch < c_; ch += 32) {
    float acc = pb * blank_v[hi * c_ + ch];
    for (int s = 0; s < m; ++s) {
      const int t = s_t[s];
      if (t >= 0) acc += s_p[s] * to_f(vb[static_cast<long long>(t) * 2 * c + ch]);
    }
    orow[ch] = from_f<T>(acc * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kv, const void* ncc,
                   const void* pos, const void* pe_kernel, const void* pe_bias,
                   const void* blank_k, const void* blank_v, void* out, int b,
                   int n, int h, int c_, int nnc, int cs, int rel_width,
                   int clamp_width, long long ncc_bstride,
                   long long pos_bstride, cudaStream_t stream) {
  const long long tasks = static_cast<long long>(b) * n * h;
  if (tasks == 0) return cudaSuccess;
  const unsigned blocks = static_cast<unsigned>((tasks + kWarps - 1) / kWarps);
  const size_t shmem = sizeof(float) * kWarps * (c_ + 2 * nnc * cs);
  const int clamp_hi = clamp_width > 0 ? clamp_width - 1 : -1;
  const bool vec = (c_ * sizeof(T)) % 16 == 0;
#define CA_ARGS                                                             \
  static_cast<const T*>(q), static_cast<const T*>(kv),                      \
      static_cast<const int*>(ncc), static_cast<const float*>(pos),         \
      static_cast<const float*>(pe_kernel),                                 \
      static_cast<const float*>(pe_bias), static_cast<const float*>(blank_k), \
      static_cast<const float*>(blank_v), static_cast<T*>(out), b, n, h, c_, \
      nnc, cs, rel_width, clamp_hi, ncc_bstride, pos_bstride
  if (vec) {
    cluster_attention_fwd_kernel<T, true>
        <<<blocks, kWarps * 32, shmem, stream>>>(CA_ARGS);
  } else {
    cluster_attention_fwd_kernel<T, false>
        <<<blocks, kWarps * 32, shmem, stream>>>(CA_ARGS);
  }
#undef CA_ARGS
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, kv and out). Returns a cudaError_t.
extern "C" int cluster_attention_fwd(
    const void* q, const void* kv, const void* ncc, const void* pos,
    const void* pe_kernel, const void* pe_bias, const void* blank_k,
    const void* blank_v, void* out, int b, int n, int h, int c_, int nnc,
    int cs, int rel_width, int clamp_width, long long ncc_bstride,
    long long pos_bstride, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v,
                         out, b, n, h, c_, nnc, cs, rel_width, clamp_width,
                         ncc_bstride, pos_bstride, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                                 blank_v, out, b, n, h, c_, nnc, cs, rel_width,
                                 clamp_width, ncc_bstride, pos_bstride, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
