// Fused local cluster attention, backward, for Hopper (sm_90a).
//
// Replaces both TPU Pallas backward kernels of the JAX package:
// ml_autofocusformermod_tpu/ops/clusten_pallas.py::_bwd_kernel (large n,
// AFF stage 1) and ::_bwd_kernel_stacked (small n, stages 2 and 3). The
// algebra is the JAX package's oracle backward (clusten_pallas.py:3080-3149),
// as written out in ml_autofocusformermod_torch/ops/cluster_attention.py::
// cluster_attention_backward_reference. Per query i, head hi, with the
// softmax recomputed from q, kv and the geometry (flash-style recompute):
//
//   p_s, pb  = softmax over the m slots and the blank logit
//   dp_s     = g_i . v_t            dpb = g_i . blank_v[hi]
//   S        = sum_s dp_s p_s + dpb pb
//   dl_s     = p_s (dp_s - S)       dlb = pb (dpb - S)
//   dq_i     = sum_s dl_s k_t + dlb blank_k[:, hi]
//   dk_t    += dl_s q_i             dv_t += p_s g_i           (scatter)
//   d_pe_kernel[f, hi] += dl_s feat_f(s)   d_pe_bias[hi] += dl_s
//   d_blank_k[:, hi]   += dlb q_i          d_blank_v[hi]  += pb g_i
//
// Padded slots (token >= n) have p = 0 and contribute nothing.
//
// What bounds it on the H100: memory and atomics. Each query gathers its
// m = 48 neighbour rows of k and v, as in the forward, and scatters m rows
// of dk and dv back. The design:
//   * one warp per (image, query, head), head fastest, as in the forward;
//     blocks are persistent (a grid of at most what fits on the card at
//     once), each warp looping over tasks;
//   * pass 1, lanes over slots: the logit (q.k + rel-pos bias) and dp = g.v
//     of each slot, 16-byte vector loads of the k and v rows; warp
//     reductions give the softmax and S;
//   * dq, lanes over channels (coalesced k-row reads), written directly in
//     q's dtype;
//   * dk/dv, lanes over (slot, channel) pairs: f32 atomicAdd into a
//     zeroed (b, n, 2c) buffer, which the wrapper casts to kv's dtype;
//   * the 6h + 2c parameter gradients are reduced per block in shared
//     memory (shared atomics) and flushed with one global atomicAdd per
//     value per block, not one per slot.
// Atomics add in an order that changes from run to run, so dkv and the
// parameter gradients are not bitwise reproducible (the plain CPU path is).
// The 5 rel-pos features are recomputed with IEEE sqrtf and division, as
// the forward does.

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

// The 5 rel-pos features (dx, dy, dist, sin, cos) of token t seen from the
// query at (pqx, pqy); the same arithmetic as the forward kernel.
__device__ __forceinline__ void rel_feat(const float* posb, int t, float pqx,
                                         float pqy, float R, int clamp_hi,
                                         float* f) {
  float dx = posb[2 * t] - pqx;
  float dy = posb[2 * t + 1] - pqy;
  if (clamp_hi >= 0) {
    dx = fminf(fmaxf(dx + R, 0.f), static_cast<float>(clamp_hi)) - R;
    dy = fminf(fmaxf(dy + R, 0.f), static_cast<float>(clamp_hi)) - R;
  }
  const float dist = sqrtf(dx * dx + dy * dy);
  float sn = 0.f, cn = 0.f;
  if (dist != 0.f) {
    sn = dy / dist;
    cn = dx / dist;
  }
  f[0] = dx;
  f[1] = dy;
  f[2] = dist;
  f[3] = sn;
  f[4] = cn;
}

// dparams layout (6h + 2c floats): d_pe_kernel (5, h) | d_pe_bias (h) |
// d_blank_k (c_, h) | d_blank_v (h, c_).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
cluster_attention_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ kv,
    const int* __restrict__ ncc, const float* __restrict__ pos,
    const float* __restrict__ pe_kernel, const float* __restrict__ pe_bias,
    const float* __restrict__ blank_k, const float* __restrict__ blank_v,
    const T* __restrict__ g_out, T* __restrict__ dq, float* __restrict__ dkv,
    float* __restrict__ dparams, int b, int n, int h, int c_, int nnc, int cs,
    int rel_width, int clamp_hi, long long ncc_bstride,
    long long pos_bstride) {
  extern __shared__ float smem[];
  const int m = nnc * cs;
  const int c = h * c_;
  const int nparams = 6 * h + 2 * c;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* s_acc = smem;  // the block's parameter-gradient sums
  float* s_q = smem + nparams + warp * (2 * c_ + 3 * m);  // q row, f32
  float* s_g = s_q + c_;                                  // g_out row
  float* s_p = s_g + c_;   // logits, then probabilities
  float* s_d = s_p + m;    // dp, then dlogits
  int* s_t = reinterpret_cast<int*>(s_d + m);  // token per slot, -1 = pad

  for (int e = threadIdx.x; e < nparams; e += blockDim.x) s_acc[e] = 0.f;
  __syncthreads();

  const float R = static_cast<float>(rel_width);
  const long long tasks = static_cast<long long>(b) * n * h;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
       task < tasks; task += stride) {
    const int hi = static_cast<int>(task % h);
    const long long bt = task / h;
    const int i = static_cast<int>(bt % n);
    const int bi = static_cast<int>(bt / n);
    const long long row = (static_cast<long long>(bi) * n + i) * c + hi * c_;
    for (int ch = lane; ch < c_; ch += 32) {
      s_q[ch] = to_f(q[row + ch]);
      s_g[ch] = to_f(g_out[row + ch]);
    }
    __syncwarp();

    const float* posb = pos + bi * pos_bstride;
    const float pqx = posb[2 * i];
    const float pqy = posb[2 * i + 1];
    const int* nrow = ncc + bi * ncc_bstride + static_cast<long long>(i) * nnc;
    float w[5];
#pragma unroll
    for (int f = 0; f < 5; ++f) w[f] = pe_kernel[f * h + hi];
    const float bias0 = pe_bias[hi];
    const T* kvb = kv + static_cast<long long>(bi) * n * 2 * c;

    // --- pass 1, lanes over slots: logits and dp ---
    float mx = -INFINITY;
    for (int s = lane; s < m; s += 32) {
      int t = nrow[s / cs] * cs + (s % cs);
      float logit = -INFINITY, dp = 0.f;
      if (t >= 0 && t < n) {
        const T* krow = kvb + static_cast<long long>(t) * 2 * c + 2 * hi * c_;
        const T* vrow = krow + c_;
        float qk = 0.f;
        if constexpr (VEC) {
          constexpr int N = Vec<T>::N;
          for (int ch = 0; ch < c_; ch += N) {
            float kf[N], vf[N];
            load16(krow + ch, kf);
            load16(vrow + ch, vf);
#pragma unroll
            for (int e = 0; e < N; ++e) {
              qk += s_q[ch + e] * kf[e];
              dp += s_g[ch + e] * vf[e];
            }
          }
        } else {
          for (int ch = 0; ch < c_; ++ch) {
            qk += s_q[ch] * to_f(krow[ch]);
            dp += s_g[ch] * to_f(vrow[ch]);
          }
        }
        float f[5];
        rel_feat(posb, t, pqx, pqy, R, clamp_hi, f);
        logit = qk + w[0] * f[0] + w[1] * f[1] + w[2] * f[2] + w[3] * f[3] +
                w[4] * f[4] + bias0;
      } else {
        t = -1;
      }
      s_p[s] = logit;
      s_d[s] = dp;
      s_t[s] = t;
      mx = fmaxf(mx, logit);
    }

    // --- softmax joint with the blank logit; S ---
    float bl = 0.f, dpb = 0.f;
    for (int ch = lane; ch < c_; ch += 32) {
      bl += s_q[ch] * blank_k[ch * h + hi];
      dpb += s_g[ch] * blank_v[hi * c_ + ch];
    }
    bl = warp_sum(bl);
    dpb = warp_sum(dpb);
    mx = fmaxf(warp_max(mx), bl);
    float sum = 0.f;
    for (int s = lane; s < m; s += 32) {
      const float e = s_t[s] >= 0 ? expf(s_p[s] - mx) : 0.f;
      s_p[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    const float pbu = expf(bl - mx);
    const float inv = 1.f / (sum + pbu);
    const float pb = pbu * inv;
    float sdot = 0.f;
    for (int s = lane; s < m; s += 32) {
      const float p = s_p[s] * inv;
      s_p[s] = p;
      sdot += p * s_d[s];
    }
    const float S = warp_sum(sdot) + dpb * pb;
    const float dlb = pb * (dpb - S);

    // --- dlogits and the rel-pos parameter gradients, lanes over slots ---
    float a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int s = lane; s < m; s += 32) {
      const int t = s_t[s];
      float dl = 0.f;
      if (t >= 0) {
        dl = s_p[s] * (s_d[s] - S);
        float f[5];
        rel_feat(posb, t, pqx, pqy, R, clamp_hi, f);
#pragma unroll
        for (int k = 0; k < 5; ++k) a[k] += dl * f[k];
        a[5] += dl;
      }
      s_d[s] = dl;
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] = warp_sum(a[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 6; ++k) atomicAdd(&s_acc[k * h + hi], a[k]);
    }
    __syncwarp();

    // --- dq and the blank-token gradients, lanes over channels ---
    const T* kb = kvb + 2 * hi * c_;
    for (int ch = lane; ch < c_; ch += 32) {
      float acc = dlb * blank_k[ch * h + hi];
      for (int s = 0; s < m; ++s) {
        const int t = s_t[s];
        if (t >= 0) acc += s_d[s] * to_f(kb[static_cast<long long>(t) * 2 * c + ch]);
      }
      dq[row + ch] = from_f<T>(acc);
      atomicAdd(&s_acc[6 * h + ch * h + hi], s_q[ch] * dlb);
      atomicAdd(&s_acc[6 * h + c + hi * c_ + ch], pb * s_g[ch]);
    }

    // --- dk, dv: scatter, lanes over (slot, channel) ---
    float* dkvb = dkv + static_cast<long long>(bi) * n * 2 * c + 2 * hi * c_;
    for (int e = lane; e < m * c_; e += 32) {
      const int s = e / c_;
      const int ch = e - s * c_;
      const int t = s_t[s];
      if (t < 0) continue;
      float* drow = dkvb + static_cast<long long>(t) * 2 * c;
      atomicAdd(drow + ch, s_d[s] * s_q[ch]);
      atomicAdd(drow + c_ + ch, s_p[s] * s_g[ch]);
    }
    __syncwarp();  // the next task overwrites this warp's shared rows
  }

  __syncthreads();
  for (int e = threadIdx.x; e < nparams; e += blockDim.x)
    atomicAdd(&dparams[e], s_acc[e]);
}

template <typename T>
cudaError_t launch(const void* q, const void* kv, const void* ncc,
                   const void* pos, const void* pe_kernel, const void* pe_bias,
                   const void* blank_k, const void* blank_v, const void* g_out,
                   void* dq, void* dkv, void* dparams, int b, int n, int h,
                   int c_, int nnc, int cs, int rel_width, int clamp_width,
                   long long ncc_bstride, long long pos_bstride,
                   cudaStream_t stream) {
  const long long tasks = static_cast<long long>(b) * n * h;
  if (tasks == 0) return cudaSuccess;
  const int m = nnc * cs;
  const size_t shmem =
      sizeof(float) * (6 * h + 2 * h * c_ + kWarps * (2 * c_ + 3 * m));
  const int clamp_hi = clamp_width > 0 ? clamp_width - 1 : -1;
  const bool vec = (c_ * sizeof(T)) % 16 == 0;
  auto kernel = vec ? cluster_attention_bwd_kernel<T, true>
                    : cluster_attention_bwd_kernel<T, false>;
  // persistent blocks: as many as are resident on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWarps * 32, shmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = (tasks + kWarps - 1) / kWarps;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, shmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const int*>(ncc), static_cast<const float*>(pos),
      static_cast<const float*>(pe_kernel), static_cast<const float*>(pe_bias),
      static_cast<const float*>(blank_k), static_cast<const float*>(blank_v),
      static_cast<const T*>(g_out), static_cast<T*>(dq),
      static_cast<float*>(dkv), static_cast<float*>(dparams), b, n, h, c_,
      nnc, cs, rel_width, clamp_hi, ncc_bstride, pos_bstride);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, kv, g_out and dq). dkv (b, n, 2c)
// and dparams (6h + 2c) are float32 and must be zeroed by the caller.
// Returns a cudaError_t.
extern "C" int cluster_attention_bwd(
    const void* q, const void* kv, const void* ncc, const void* pos,
    const void* pe_kernel, const void* pe_bias, const void* blank_k,
    const void* blank_v, const void* g_out, void* dq, void* dkv,
    void* dparams, int b, int n, int h, int c_, int nnc, int cs,
    int rel_width, int clamp_width, long long ncc_bstride,
    long long pos_bstride, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v,
                         g_out, dq, dkv, dparams, b, n, h, c_, nnc, cs,
                         rel_width, clamp_width, ncc_bstride, pos_bstride, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                                 blank_v, g_out, dq, dkv, dparams, b, n, h, c_,
                                 nnc, cs, rel_width, clamp_width, ncc_bstride,
                                 pos_bstride, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
