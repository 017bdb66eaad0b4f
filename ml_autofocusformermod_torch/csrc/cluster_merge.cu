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
// What bounds it on the H100: memory. The floor reads weights and feat once
// and writes out once; each feature row is gathered by about 12 centres.
// The TPU kernel kept an image's features resident in VMEM; so does the
// resident path here (bf16, when a channel slice of the image fits in 227
// KB of shared memory: every AFF-Mini merge):
//   * a block owns one image, one slice of CW channels and a range of
//     centres; it stages the slice once with 16-byte cp.async copies,
//     XOR-swizzled so that 8 consecutive rows read conflict-free, and then
//     streams its centres' weights through two shared buffers (the next
//     group's copy runs under this group's products);
//   * a warp takes one centre at a time: out^T (CW x 8, ic = 4 padded) =
//     F_g^T (CW x m) . W (m x 8) on the tensor cores (mma.sync m16n8k16,
//     f32 accumulators), where ldmatrix.trans takes one row address per
//     lane, so the gather from shared memory is the operand load;
//   * the grid has a block per (image, slice), and more centre ranges per
//     image when that gives fewer blocks than the card has SMs.
// Every other shape - f32 (exact f32 FMAs, no TF32), and bf16 slices that
// do not fit - takes the direct path: a warp per (centre, 256 or 128
// channels), each lane gathering 16-byte row pieces straight from global
// memory. No shape is refused.

#include "cluster_merge_tile.cuh"

namespace {

using namespace cm;

constexpr int kThreads = 1024;  // resident path: 32 warps, one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kWBuf = 12288;   // bytes of one centre group's weights
constexpr int kMaxGroup = 64;  // centres per group at most
constexpr int kMTG = 4;        // 16-channel m-tiles per pass over the slots
constexpr int kDirectThreads = 256;

// Resident path: the staged slice of CW channels per row, swizzled.
struct Resident {
  int CW, nsl, groups, GC, off_w, off_n, wbytes, nbytes, bytes;
  Swizzle sw;
};

inline bool resident_plan(int b, int n, int n_, int c, int nnc, int cs,
                          int sms, Resident* p) {
  if (c % 8 != 0) return false;
  const int m = nnc * cs;
  int gc = kWBuf / (m * kIC * 2);
  p->GC = gc < 1 ? 1 : (gc > kMaxGroup ? kMaxGroup : gc);
  p->wbytes = round_up(p->GC * m * kIC * 2, 16);
  p->nbytes = round_up(p->GC * nnc * 4, 16);
  const int top = c <= 16 ? 16 : (c <= 32 ? 32 : round_up(c, 64));
  for (int CW = top; CW >= 16; CW = CW > 64 ? CW - 64 : CW / 2) {
    const long long feat = ((n + 1LL) * CW * 2 + 15) / 16 * 16;
    const long long total = feat + 2LL * (p->wbytes + p->nbytes);
    if (total > kMaxShmem) continue;
    p->CW = CW;
    p->nsl = (c + CW - 1) / CW;
    p->sw = Swizzle::of(CW);
    p->off_w = static_cast<int>(feat);
    p->off_n = p->off_w + 2 * p->wbytes;
    p->bytes = static_cast<int>(total);
    const int blocks = b * p->nsl;
    int groups = blocks >= sms ? 1 : sms / blocks;
    p->groups = groups > n_ ? (n_ > 0 ? n_ : 1) : groups;
    return true;
  }
  return false;
}

__global__ void __launch_bounds__(kThreads)
cluster_merge_fwd_resident(const bf16* __restrict__ w,
                           const bf16* __restrict__ feat,
                           const int* __restrict__ ncc,
                           bf16* __restrict__ out, int n, int n_, int c,
                           int nnc, int cs, Resident P) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sF = reinterpret_cast<bf16*>(smem);
  const int grp = blockIdx.x, sl = blockIdx.y, bi = blockIdx.z;
  const int t_begin = static_cast<int>(1LL * n_ * grp / P.groups);
  const int t_end = static_cast<int>(1LL * n_ * (grp + 1) / P.groups);
  const int c0 = sl * P.CW, cw = min(P.CW, c - c0);
  const int Q = P.CW / 8, m = nnc * cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the image's channel slice, and a zero row n for padded slots
  const bf16* fb = feat + static_cast<long long>(bi) * n * c + c0;
  for (int e = threadIdx.x; e < (n + 1) * Q; e += kThreads) {
    const int r = e / Q, q = e - r * Q;
    bf16* d = sF + P.sw.at(r, q, P.CW);
    if (r < n && q * 8 < cw)
      cp_async16(d, fb + static_cast<long long>(r) * c + q * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  auto stage_group = [&](int t0, int buf) {
    const int gc = min(P.GC, t_end - t0);
    bf16* sw = reinterpret_cast<bf16*>(smem + P.off_w + buf * P.wbytes);
    int* sn = reinterpret_cast<int*>(smem + P.off_n + buf * P.nbytes);
    const long long centre = static_cast<long long>(bi) * n_ + t0;
    const bf16* wsrc = w + centre * m * kIC;
    for (int e = threadIdx.x; e < gc * m; e += kThreads)
      cp_async_small<8>(sw + e * kIC, wsrc + e * kIC);
    const int* nsrc = ncc + centre * nnc;
    for (int e = threadIdx.x; e < gc * nnc; e += kThreads)
      cp_async_small<4>(sn + e, nsrc + e);
  };
  if (t_begin < t_end) stage_group(t_begin, 0);
  cp_async_commit();

  const int gq = lane >> 2, t2 = (lane & 3) * 2;
  const int ksteps = (m + 15) / 16;
  // this lane's ldmatrix row is slot 16 kk + s_lane: cluster j, member s
  // of it, stepped by 16 slots without a division
  const int s_lane = ((lane >> 4) << 3) + (lane & 7);
  const int j_first = s_lane / cs, s_first = s_lane - j_first * cs;
  const int j_step = 16 / cs, s_step = 16 - j_step * cs;
  int buf = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += P.GC, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();
    if (t0 + P.GC < t_end) {
      stage_group(t0 + P.GC, buf ^ 1);
      cp_async_commit();
    }
    const int gc = min(P.GC, t_end - t0);
    const bf16* sw = reinterpret_cast<const bf16*>(smem + P.off_w +
                                                   buf * P.wbytes);
    const int* sn = reinterpret_cast<const int*>(smem + P.off_n +
                                                 buf * P.nbytes);
    for (int ci = warp; ci < gc; ci += kWarps) {
      const bf16* wt = sw + ci * m * kIC;  // (m, ic)
      const int* nc = sn + ci * nnc;
      auto wbits = [&](int s) -> uint32_t {
        return s < m ? bits16(wt + s * kIC + (gq & 3)) : 0u;
      };
      bf16* orow = out + (static_cast<long long>(bi) * n_ + t0 + ci) * kIC * c;
      for (int mt0 = 0; mt0 < P.CW / 16; mt0 += kMTG) {
        float acc[kMTG][4] = {};
        int j = j_first, sm = s_first;
        for (int kk = 0; kk < ksteps; ++kk) {
          const int k0 = kk * 16;
          // this lane's row address for ldmatrix: slot k0 + 8 * (lane / 16)
          // + lane % 8, channel chunk 2 * mtile + (lane / 8) % 2
          int r = n;
          if (k0 + s_lane < m) {
            const int rr = nc[j] * cs + sm;
            if (rr >= 0 && rr < n) r = rr;
          }
          j += j_step;
          sm += s_step;
          if (sm >= cs) {
            sm -= cs;
            ++j;
          }
          const int half = (lane >> 3) & 1;
          const uint32_t b0 = wbits(k0 + t2) | (wbits(k0 + t2 + 1) << 16);
          const uint32_t b1 = wbits(k0 + t2 + 8) | (wbits(k0 + t2 + 9) << 16);
#pragma unroll
          for (int q = 0; q < kMTG; ++q) {
            if (mt0 + q < P.CW / 16) {
              uint32_t a[4];
              ldmatrix_x4_trans(a, sF + P.sw.at(r, (mt0 + q) * 2 + half,
                                                P.CW));
              mma_bf16_16816(acc[q], a, b0, b1);
            }
          }
        }
        // acc[q]: (channel 16 (mt0 + q) + gq (+8), inner channel t2 (+1)),
        // stored as channel pairs of inner channel t2 + gq % 2
        const int i = t2 + (gq & 1);
#pragma unroll
        for (int q = 0; q < kMTG; ++q) {
          if (mt0 + q < P.CW / 16) {
            const uint32_t v0 = row_pair(acc[q][0], acc[q][1]);
            const uint32_t v1 = row_pair(acc[q][2], acc[q][3]);
            const int ch = (mt0 + q) * 16 + (gq & ~1);
            uint32_t* o = reinterpret_cast<uint32_t*>(orow + i * c + c0 + ch);
            if (i < kIC && ch < cw) o[0] = v0;
            if (i < kIC && ch + 8 < cw) o[4] = v1;
          }
        }
      }
    }
  }
}

// Direct path: a warp per (centre, 32 pieces of P channels), P = 16 bytes
// of channels when rows allow 16-byte loads (VEC), else 1.
template <typename E, bool VEC>
__global__ void __launch_bounds__(kDirectThreads)
cluster_merge_fwd_direct(const E* __restrict__ w,
                         const E* __restrict__ feat,
                         const int* __restrict__ ncc, E* __restrict__ out,
                         int b, int n, int n_, int c, int nnc, int cs) {
  constexpr int P = VEC ? 16 / sizeof(E) : 1;
  const int lane = threadIdx.x & 31;
  const int m = nnc * cs;
  const int passes = (c + 32 * P - 1) / (32 * P);
  const long long tasks = static_cast<long long>(b) * n_ * passes;
  const long long stride = static_cast<long long>(gridDim.x) *
                           (kDirectThreads / 32);
  for (long long task = blockIdx.x * (kDirectThreads / 32) +
                        (threadIdx.x >> 5);
       task < tasks; task += stride) {
    const long long centre = task / passes;
    const int ch = (static_cast<int>(task % passes) * 32 + lane) * P;
    const bool active = ch < c;
    const int bi = static_cast<int>(centre / n_);
    const E* wrow = w + centre * m * kIC;
    const int* nrow = ncc + centre * nnc;
    const E* fb = feat + static_cast<long long>(bi) * n * c + ch;
    float acc[kIC][P] = {};
    for (int j = 0; j < nnc; ++j) {
      const int base = nrow[j] * cs;
      for (int s = 0; s < cs; ++s) {
        const int r = base + s;
        if (r < 0 || r >= n || !active) continue;
        float wv[kIC];
#pragma unroll
        for (int i = 0; i < kIC; ++i)
          wv[i] = to_f(wrow[(j * cs + s) * kIC + i]);
        alignas(16) E f[P];
        if constexpr (VEC) {
          *reinterpret_cast<uint4*>(f) = *reinterpret_cast<const uint4*>(
              fb + static_cast<long long>(r) * c);
        } else {
          f[0] = fb[static_cast<long long>(r) * c];
        }
#pragma unroll
        for (int i = 0; i < kIC; ++i)
#pragma unroll
          for (int p = 0; p < P; ++p) acc[i][p] += wv[i] * to_f(f[p]);
      }
    }
    if (!active) continue;
    E* orow = out + centre * kIC * c + ch;
#pragma unroll
    for (int i = 0; i < kIC; ++i) {
      alignas(16) E o[P];
#pragma unroll
      for (int p = 0; p < P; ++p) o[p] = from_f<E>(acc[i][p]);
      if constexpr (VEC)
        *reinterpret_cast<uint4*>(orow + i * c) = *reinterpret_cast<uint4*>(o);
      else
        orow[i * c] = o[0];
    }
  }
}

template <typename E>
cudaError_t launch(const void* w, const void* feat, const void* ncc,
                   void* out, int b, int n, int n_, int c, int nnc, int cs,
                   cudaStream_t stream) {
  if (static_cast<long long>(b) * n_ == 0 || c == 0) return cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  Resident R;
  if (std::is_same<E, bf16>::value &&
      resident_plan(b, n, n_, c, nnc, cs, sms, &R)) {
    err = allow_shmem(cluster_merge_fwd_resident, R.bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(R.groups, R.nsl, b);
    cluster_merge_fwd_resident<<<grid, kThreads, R.bytes, stream>>>(
        static_cast<const bf16*>(w), static_cast<const bf16*>(feat),
        static_cast<const int*>(ncc), static_cast<bf16*>(out), n, n_, c, nnc,
        cs, R);
    return cudaGetLastError();
  }
  const int P = 16 / static_cast<int>(sizeof(E));
  const bool vec = c % P == 0;
  const long long tasks =
      static_cast<long long>(b) * n_ * ((c + 32 * P - 1) / (32 * P));
  long long blocks = (tasks + kDirectThreads / 32 - 1) / (kDirectThreads / 32);
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  auto kernel = vec ? cluster_merge_fwd_direct<E, true>
                    : cluster_merge_fwd_direct<E, false>;
  kernel<<<static_cast<unsigned>(blocks), kDirectThreads, 0, stream>>>(
      static_cast<const E*>(w), static_cast<const E*>(feat),
      static_cast<const int*>(ncc), static_cast<E*>(out), b, n, n_, c, nnc,
      cs);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (weights, feat and out). ic must be 4;
// every pointer 16-byte aligned. Returns a cudaError_t.
extern "C" int cluster_merge_fwd(const void* w, const void* feat,
                                 const void* ncc, void* out, int b, int n,
                                 int n_, int c, int nnc, int cs, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(w, feat, ncc, out, b, n, n_, c, nnc, cs, st);
  if (dtype == 1)
    return launch<bf16>(w, feat, ncc, out, b, n, n_, c, nnc, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
