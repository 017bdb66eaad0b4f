// LayerNorm in float32 with the fast variance, forward and backward, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package writes this LayerNorm
// (models/layers.py::LayerNormFp32) as array expressions and leaves their
// fusion to XLA. Written out in eager PyTorch it was about 14 kernels
// forward and 20-25 backward, each a pass over a float32 copy of the
// activation, and autograd kept three float32 copies of it. Contract
// (ml_autofocusformermod_torch/ops/layer_norm.py), over each row of C:
//
//   mean = sum(x) / C,  var = max(sum(x * x) / C - mean * mean, 0),
//   rstd = rsqrt(var + eps),  y = (x - mean) * rstd * w + b
//
// with both sums in f32, one pass; y in x's dtype (float32 or bfloat16),
// w and b float32. Per row the forward also writes mean and rstd (f32),
// rstd negated where the clamp took effect: the backward then leaves out
// the variance's path, as autograd of the clamp does. The backward takes x
// as it came, w, the saved mean and rstd and the output gradient g:
//
//   xhat = (x - mean) * |rstd|,  dxhat = g * w,
//   dx = |rstd| * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//
// (the last term only where rstd > 0), dx in x's dtype; dw = sum g * xhat
// and db = sum g over the rows, in f32, as per-block partial sums that a
// second kernel adds in a fixed order: no atomics, so the gradients are
// bitwise reproducible on one card.
//
// What bounds it on the H100: memory. The floor reads x once and writes y
// once (plus 8 bytes of statistics a row) forward, and reads x and g once
// and writes dx once backward. A row is read once, into registers:
//   * the row's width C picks the layout: vectors of V elements (16 bytes
//     where C allows), and a group of TPR threads per row, a power of two,
//     each holding K vectors of the row (K * V <= 16 elements). Rows of up
//     to 32 vectors share a warp between 32 / TPR rows (a row of 4 per
//     thread in weight_net, eight rows of 32 per warp in stage 1); wider
//     rows take a warp, or 2 to 8 warps that add their sums through shared
//     memory;
//   * a block of 256 threads walks over the rows (a grid of at most the
//     blocks the card holds at once), keeping w and b, and in the backward
//     its partial dw and db, in registers;
//   * a width that fits none of these (over 4096 elements at 16-byte
//     vectors, over 1024 at odd widths) takes the general path: a block
//     per row, reading the row twice from the cache.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 4;       // vectors per thread
constexpr int kMaxElems = 16;  // elements per thread (K * V)
constexpr int kMinIters = 4;   // rows per thread at least, backward
constexpr int kMaxDevices = 64;
constexpr int kRedRows = 8;    // the reduce kernel's slices of the parts

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// V elements read or written as one access of V * sizeof(T) bytes.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The sums (a, b) over the TPR threads of a row's group. Every thread of
// the block calls it (the shuffles take the whole warp, the shared-memory
// step the whole block); each thread of the group gets the same bits,
// since the butterfly adds the same two values on both sides.
__device__ __forceinline__ float2 row_sum(float2 v, int tpr, float2* red) {
  const int width = tpr < 32 ? tpr : 32;
  for (int o = width >> 1; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if (tpr > 32) {
    const int warp = threadIdx.x >> 5, per = tpr >> 5;
    const int first = warp / per * per;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    v = red[first];
    for (int i = 1; i < per; ++i) {
      v.x += red[first + i].x;
      v.y += red[first + i].y;
    }
    __syncthreads();
  }
  return v;
}

// The row statistics from the sums of x and x * x: mean, and rstd with its
// sign set where the clamp took effect (var_pre < 0; a NaN passes, as it
// does through clamp_min).
__device__ __forceinline__ void stats(float2 t, int C, float eps, float* mu,
                                      float* rs) {
  const float m = t.x / C;
  const float var_pre = t.y / C - m * m;
  const float r = rsqrtf((var_pre < 0.f ? 0.f : var_pre) + eps);
  *mu = m;
  *rs = var_pre < 0.f ? -r : r;
}

// Forward, registers: grid-stride over groups of kThreads / tpr rows.
template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads)
ln_fwd(const T* __restrict__ x, const float* __restrict__ w,
       const float* __restrict__ b, T* __restrict__ y,
       float* __restrict__ mean, float* __restrict__ rstd, long long R,
       int C, int tpr, float eps) {
  __shared__ float2 red[kWarps];
  const int nv = C / V, rb = kThreads / tpr;
  const int sub = threadIdx.x % tpr, slot = threadIdx.x / tpr;
  float wr[K][V], br[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = sub + k * tpr;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      wr[k][v] = j < nv ? w[j * V + v] : 0.f;
      br[k][v] = j < nv ? b[j * V + v] : 0.f;
    }
  }
  for (long long base = static_cast<long long>(blockIdx.x) * rb; base < R;
       base += static_cast<long long>(gridDim.x) * rb) {
    const long long row = base + slot;
    const bool live = row < R;
    const T* xr = x + row * C;
    float xv[K][V];
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sub + k * tpr;
      if (live && j < nv) {
        const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xr + j * V);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          xv[k][v] = to_f(p.v[v]);
          t.x += xv[k][v];
          t.y += xv[k][v] * xv[k][v];
        }
      }
    }
    t = row_sum(t, tpr, red);
    float mu, rs;
    stats(t, C, eps, &mu, &rs);
    if (!live) continue;
    const float r = fabsf(rs);
    T* yr = y + row * C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sub + k * tpr;
      if (j < nv) {
        Pack<T, V> p;
#pragma unroll
        for (int v = 0; v < V; ++v)
          p.v[v] = from_f<T>((xv[k][v] - mu) * r * wr[k][v] + br[k][v]);
        *reinterpret_cast<Pack<T, V>*>(yr + j * V) = p;
      }
    }
    if (sub == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

// Backward, registers: dx per row; the block's dw and db partial sums
// (row slots summed in order through shared memory) into part[blockIdx.x]
// = (dw[0:C], db[0:C]).
template <typename T, int V, int K>
__global__ void __launch_bounds__(kThreads)
ln_bwd(const T* __restrict__ x, const float* __restrict__ w,
       const float* __restrict__ mean, const float* __restrict__ rstd,
       const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ part,
       long long R, int C, int tpr) {
  __shared__ float2 red[kWarps];
  extern __shared__ float slots[];  // [rb][C] dw, then [rb][C] db
  const int nv = C / V, rb = kThreads / tpr;
  const int sub = threadIdx.x % tpr, slot = threadIdx.x / tpr;
  float wr[K][V], aw[K][V], ab[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = sub + k * tpr;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      wr[k][v] = j < nv ? w[j * V + v] : 0.f;
      aw[k][v] = 0.f;
      ab[k][v] = 0.f;
    }
  }
  for (long long base = static_cast<long long>(blockIdx.x) * rb; base < R;
       base += static_cast<long long>(gridDim.x) * rb) {
    const long long row = base + slot;
    const bool live = row < R;
    const float mu = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    const float r = fabsf(rs);
    float xh[K][V], dxh[K][V];
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sub + k * tpr;
      if (live && j < nv) {
        const Pack<T, V> px =
            *reinterpret_cast<const Pack<T, V>*>(x + row * C + j * V);
        const Pack<T, V> pg =
            *reinterpret_cast<const Pack<T, V>*>(g + row * C + j * V);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float gv = to_f(pg.v[v]);
          xh[k][v] = (to_f(px.v[v]) - mu) * r;
          dxh[k][v] = gv * wr[k][v];
          t.x += dxh[k][v];
          t.y += dxh[k][v] * xh[k][v];
          aw[k][v] += gv * xh[k][v];
          ab[k][v] += gv;
        }
      }
    }
    t = row_sum(t, tpr, red);
    if (!live) continue;
    const float m1 = t.x / C;
    const float m2 = rs < 0.f ? 0.f : t.y / C;
    T* dr = dx + row * C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = sub + k * tpr;
      if (j < nv) {
        Pack<T, V> p;
#pragma unroll
        for (int v = 0; v < V; ++v)
          p.v[v] = from_f<T>(r * (dxh[k][v] - m1 - xh[k][v] * m2));
        *reinterpret_cast<Pack<T, V>*>(dr + j * V) = p;
      }
    }
  }
  float* sw = slots;
  float* sb = slots + rb * C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = sub + k * tpr;
    if (j < nv) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sw[slot * C + j * V + v] = aw[k][v];
        sb[slot * C + j * V + v] = ab[k][v];
      }
    }
  }
  __syncthreads();
  float* pw = part + static_cast<long long>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float tw = 0.f, tb = 0.f;
    for (int i = 0; i < rb; ++i) {
      tw += sw[i * C + c];
      tb += sb[i * C + c];
    }
    pw[c] = tw;
    pw[C + c] = tb;
  }
}

// General path, any C: a block per row, the row read twice.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_rows(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ b, T* __restrict__ y,
            float* __restrict__ mean, float* __restrict__ rstd, long long R,
            int C, float eps) {
  __shared__ float2 red[kWarps];
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * C;
    float2 t = make_float2(0.f, 0.f);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float v = to_f(xr[c]);
      t.x += v;
      t.y += v * v;
    }
    t = row_sum(t, kThreads, red);
    float mu, rs;
    stats(t, C, eps, &mu, &rs);
    const float r = fabsf(rs);
    T* yr = y + row * C;
    for (int c = threadIdx.x; c < C; c += kThreads)
      yr[c] = from_f<T>((to_f(xr[c]) - mu) * r * w[c] + b[c]);
    if (threadIdx.x == 0) {
      mean[row] = mu;
      rstd[row] = rs;
    }
  }
}

// General path, backward: each thread owns columns threadIdx.x + i * 256
// of the block's partial sums and adds into them in global memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_rows(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ mean, const float* __restrict__ rstd,
            const T* __restrict__ g, T* __restrict__ dx,
            float* __restrict__ part, long long R, int C) {
  __shared__ float2 red[kWarps];
  float* pw = part + static_cast<long long>(blockIdx.x) * 2 * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    pw[c] = 0.f;
    pw[C + c] = 0.f;
  }
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * C;
    const T* gr = g + row * C;
    const float mu = mean[row], rs = rstd[row], r = fabsf(rs);
    float2 t = make_float2(0.f, 0.f);
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float xh = (to_f(xr[c]) - mu) * r;
      const float dxh = to_f(gr[c]) * w[c];
      t.x += dxh;
      t.y += dxh * xh;
    }
    t = row_sum(t, kThreads, red);
    const float m1 = t.x / C;
    const float m2 = rs < 0.f ? 0.f : t.y / C;
    T* dr = dx + row * C;
    for (int c = threadIdx.x; c < C; c += kThreads) {
      const float gv = to_f(gr[c]);
      const float xh = (to_f(xr[c]) - mu) * r;
      dr[c] = from_f<T>(r * (gv * w[c] - m1 - xh * m2));
      pw[c] += gv * xh;
      pw[C + c] += gv;
    }
  }
}

// dw[c] and db[c] (blockIdx.y = 0, 1): the P partial sums of column c,
// slice i adding parts i, i + 8, ... in order, then the slices in order.
__global__ void __launch_bounds__(32 * kRedRows)
ln_bwd_reduce(const float* __restrict__ part, float* __restrict__ dw,
              float* __restrict__ db, int P, int C) {
  __shared__ float s[kRedRows][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int which = blockIdx.y;
  float t = 0.f;
  if (c < C)
    for (int p = threadIdx.y; p < P; p += kRedRows)
      t += part[static_cast<long long>(p) * 2 * C + which * C + c];
  s[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float u = s[0][threadIdx.x];
    for (int i = 1; i < kRedRows; ++i) u += s[i][threadIdx.x];
    (which ? db : dw)[c] = u;
  }
}

// The layout of a row of C elements of T (see the note at the top).
struct Plan {
  int V, K, tpr;  // K == 0: the general path
};

inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
Plan plan_of(int C) {
  const int vmax = 16 / static_cast<int>(sizeof(T));
  int V = vmax;
  while (C % V != 0) V >>= 1;
  const int nv = C / V;
  const int kmax = kMaxElems / V < kMaxK ? kMaxElems / V : kMaxK;
  if (nv <= 32) return {V, 1, pow2_at_least(nv)};
  int tpr = pow2_at_least((nv + kmax - 1) / kmax);
  if (tpr < 32) tpr = 32;
  if (tpr > kThreads) return {1, 0, kThreads};
  int K = (nv + tpr - 1) / tpr;
  if (K == 3) K = 4;
  return {V, K, tpr};
}

// The SM count and the blocks of one kernel an SM holds at once, per
// device; each launcher keeps its own (zero-initialised, static).
struct Residency {
  int sms[kMaxDevices];
  int occ[kMaxDevices];
};

// The blocks of ``kernel`` that the card holds at once, with ``smem`` bytes
// of dynamic shared memory each.
template <class F>
cudaError_t resident_blocks(Residency& cache, F kernel, int smem,
                            long long* n) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache.sms[dev] == 0) {
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    cache.occ[dev] = occ < 1 ? 1 : occ;
    err = cudaDeviceGetAttribute(&cache.sms[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = cache.occ[dev];
  if (smem > 0) {  // 228 KB of shared memory an SM, 1 KB kept per block
    const int by_smem = (228 * 1024) / (smem + 1024);
    if (by_smem < per_sm) per_sm = by_smem < 1 ? 1 : by_smem;
  }
  *n = static_cast<long long>(cache.sms[dev]) * per_sm;
  return cudaSuccess;
}

template <typename T, int V, int K>
cudaError_t fwd_launch(const T* x, const float* w, const float* b, T* y,
                       float* mean, float* rstd, long long R, int C, int tpr,
                       float eps, cudaStream_t st) {
  static Residency cache;
  long long cap = 0;
  const cudaError_t err = resident_blocks(cache, ln_fwd<T, V, K>, 0, &cap);
  if (err != cudaSuccess) return err;
  const int rb = kThreads / tpr;
  long long blocks = (R + rb - 1) / rb;
  if (blocks > cap) blocks = cap;
  ln_fwd<T, V, K><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      x, w, b, y, mean, rstd, R, C, tpr, eps);
  return cudaGetLastError();
}

template <typename T, int V, int K>
cudaError_t bwd_launch(const T* x, const float* w, const float* mean,
                       const float* rstd, const T* g, T* dx, float* part,
                       int max_parts, long long R, int C, int tpr, int* P,
                       cudaStream_t st) {
  const int rb = kThreads / tpr;
  const int smem = 2 * rb * C * static_cast<int>(sizeof(float));
  static Residency cache;
  long long cap = 0;
  const cudaError_t err =
      resident_blocks(cache, ln_bwd<T, V, K>, smem, &cap);
  if (err != cudaSuccess) return err;
  long long blocks = (R + static_cast<long long>(rb) * kMinIters - 1) /
                     (static_cast<long long>(rb) * kMinIters);
  if (blocks > cap) blocks = cap;
  if (blocks > max_parts) blocks = max_parts;
  *P = static_cast<int>(blocks);
  ln_bwd<T, V, K><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      x, w, mean, rstd, g, dx, part, R, C, tpr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd(const void* x, const void* w, const void* b, void* y,
                void* mean, void* rstd, long long R, int C, float eps,
                cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  T* yp = static_cast<T*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  const Plan p = plan_of<T>(C);
#define LN_FWD(VV, KK)                                                  \
  if (p.V == VV && p.K == KK)                                           \
    return fwd_launch<T, (VV * sizeof(T) <= 16 ? VV : 1), KK>(          \
        xp, wp, bp, yp, mp, rp, R, C, p.tpr, eps, st);
  LN_FWD(1, 1) LN_FWD(1, 2) LN_FWD(1, 4)
  LN_FWD(2, 1) LN_FWD(2, 2) LN_FWD(2, 4)
  LN_FWD(4, 1) LN_FWD(4, 2) LN_FWD(4, 4)
  LN_FWD(8, 1) LN_FWD(8, 2)
#undef LN_FWD
  static Residency cache;
  long long cap = 0;
  const cudaError_t err = resident_blocks(cache, ln_fwd_rows<T>, 0, &cap);
  if (err != cudaSuccess) return err;
  const long long blocks = R < cap ? R : cap;
  ln_fwd_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      xp, wp, bp, yp, mp, rp, R, C, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* x, const void* w, const void* mean,
                const void* rstd, const void* g, void* dx, void* dw, void* db,
                void* part, int max_parts, long long R, int C,
                cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(part);
  const Plan p = plan_of<T>(C);
  int P = 0;
  cudaError_t err = cudaErrorInvalidValue;
  bool done = false;
#define LN_BWD(VV, KK)                                                    \
  if (!done && p.V == VV && p.K == KK) {                                  \
    err = bwd_launch<T, (VV * sizeof(T) <= 16 ? VV : 1), KK>(             \
        xp, wp, mp, rp, gp, dxp, pp, max_parts, R, C, p.tpr, &P, st);     \
    done = true;                                                          \
  }
  LN_BWD(1, 1) LN_BWD(1, 2) LN_BWD(1, 4)
  LN_BWD(2, 1) LN_BWD(2, 2) LN_BWD(2, 4)
  LN_BWD(4, 1) LN_BWD(4, 2) LN_BWD(4, 4)
  LN_BWD(8, 1) LN_BWD(8, 2)
#undef LN_BWD
  if (!done) {
    static Residency cache;
    long long cap = 0;
    err = resident_blocks(cache, ln_bwd_rows<T>, 0, &cap);
    if (err != cudaSuccess) return err;
    long long blocks = R < cap ? R : cap;
    if (blocks > max_parts) blocks = max_parts;
    P = static_cast<int>(blocks);
    ln_bwd_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        xp, wp, mp, rp, gp, dxp, pp, R, C);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((C + 31) / 32, 2);
  ln_bwd_reduce<<<grid, dim3(32, kRedRows), 0, st>>>(
      pp, static_cast<float*>(dw), static_cast<float*>(db), P, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y); w, b, mean and rstd float32.
// x is (rows, C) contiguous, 16-byte aligned. rows > 0, C > 0. Launches one
// kernel. Returns a cudaError_t.
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mean, void* rstd,
                              long long rows, int C, float eps, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, w, b, y, mean, rstd, rows, C, eps, st);
  if (dtype == 1) return fwd<bf16>(x, w, b, y, mean, rstd, rows, C, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype as above for x, g and dx; w, mean, rstd, dw and db float32. part is
// scratch of max_parts x 2 x C float32 (max_parts >= 1). x, g and dx are
// (rows, C) contiguous, 16-byte aligned. rows > 0, C > 0. Launches two
// kernels. Returns a cudaError_t.
extern "C" int layer_norm_bwd(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* g, void* dx,
                              void* dw, void* db, void* part, int max_parts,
                              long long rows, int C, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(x, w, mean, rstd, g, dx, dw, db, part, max_parts, rows,
                      C, st);
  if (dtype == 1)
    return bwd<bf16>(x, w, mean, rstd, g, dx, dw, db, part, max_parts, rows,
                     C, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
