// Fused local cluster attention, backward, for Hopper (sm_90a).
//
// Replaces both TPU Pallas backward kernels of the JAX package:
// ml_autofocusformermod_tpu/ops/clusten_pallas.py::_bwd_kernel (large n,
// AFF stage 1) and ::_bwd_kernel_stacked (small n, stages 2 and 3). The
// algebra is the JAX package's oracle backward (clusten_pallas.py:3080-3149),
// as written out in ml_autofocusformermod_torch/ops/cluster_attention.py::
// cluster_attention_backward_reference. Per query i, head hi:
//
//   p_s, pb  = softmax over the m slots and the blank logit
//   dp_s     = g_i . v_t            dpb = g_i . blank_v[hi]
//   S        = sum_s dp_s p_s + dpb pb  =  g_i . out_i
//   dl_s     = p_s (dp_s - S)       dlb = pb (dpb - S)
//   dq_i     = sum_s dl_s k_t + dlb blank_k[:, hi]
//   dk_t    += dl_s q_i             dv_t += p_s g_i           (scatter)
//   d_pe_kernel[f, hi] += dl_s feat_f(s)   d_pe_bias[hi] += dl_s
//   d_blank_k[:, hi]   += dlb q_i          d_blank_v[hi]  += pb g_i
//
// Padded slots (token >= n) have p = 0 and contribute nothing.
//
// What bounds it on the H100: the bytes are q, kv, g once and dq, dkv
// once (0.05 ms for AFF-Mini stage 1 at b128 bf16). A kernel with one
// warp per (query, head) scatters dk/dv with one f32 global atomic per
// (query, slot, channel): b n m 2c atomics, 1.23e9 at stages 1 and 2,
// which ran at about 380 G atomics/s.
//
// The tiling (cluster_attention_tile.cuh): one block per (image, tile of
// 64 queries, group of G heads), recompute mode, two passes over the
// tile's union:
//   pass 1, per union chunk: q.k^T and g.v^T over the tile x chunk
//     (tensor cores for bf16, CUDA cores for f32), kept per (row, slot);
//     the online softmax gives (max, sum) per (query, head) and
//     S = sum_s p_s dp_s + pb dpb = g . out, exactly from the same p;
//   pass 2, per union chunk: the row pass (geometry once per (query,
//     slot) for all G heads) turns the kept logits and dP into P and dL
//     and sums the rel-pos parameter gradients; then dQ += dL K in shared
//     memory, and dK = dL^T Q and dV = P^T G as tile products whose sum
//     over the tile's 64 queries is taken inside the product. Each union
//     row then gets one float2 global atomic per channel pair per tile:
//     about (64 m) / (union rows) times fewer atomics than one per
//     (query, slot); atomics remain only where neighbouring tiles' unions
//     overlap.
// When the rows keep their logits per slot, pass 2 computes no product of
// pass 1 again and stages a chunk's k rows again only when the union spans
// several chunks; when they keep them per chunk position (a large m), it
// computes a chunk's q.k^T and g.v^T again. A head wider than 64 channels
// takes the products over channel chunks, one block per output slice. The
// 6h + 2c parameter gradients are reduced per block in shared memory and
// flushed with one global atomic per value.
// Atomics add in an order that changes from run to run, so dkv and the
// parameter gradients are not bitwise reproducible (the plain CPU path
// is).

#include "cluster_attention_tile.cuh"

namespace {

using namespace ca;

template <typename E, bool VEC, bool WIDE>
using Bwd = Block<E, VEC, true, WIDE>;

// After pass 1: S = g . out = (sum_s e_s dp_s + e_b dpb) / l with e the
// unnormalised softmax terms (in a_), dlb and pb per (head, row), from
// dpb = g . blank_v (in pb_); l_ becomes 1 / l.
template <typename E, bool VEC, bool WIDE>
__device__ __forceinline__ void deltas(Bwd<E, VEC, WIDE>& k) {
  for (int e = threadIdx.x; e < k.G * kTile; e += kThreads) {
    const float dpb = k.pb_[e];
    const float inv = 1.f / k.l_[e];
    const float eb = expf(k.bl_[e] - k.m_[e]);
    const float S = (k.a_[e] + eb * dpb) * inv;
    const float pb = eb * inv;
    k.l_[e] = inv;
    k.a_[e] = S;
    k.pb_[e] = pb;
    k.dlb_[e] = pb * (dpb - S);
  }
}

// The row pass of pass 2 over one chunk: P and dL at the row's slots (0
// elsewhere), from the logits and dP kept per slot (`raw`: q.k computed
// again, the bias still to add); the chunk's share of d_pe_kernel goes to
// the block's sums in shared memory. A cluster listed mult times counts
// mult times.
template <typename E, bool VEC, bool WIDE>
__device__ __forceinline__ void grad_chunk(Bwd<E, VEC, WIDE>& k, bool raw) {
  float acc[kMaxG][5];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int x = 0; x < 5; ++x) acc[g][x] = 0.f;
  float w[kMaxG][6];
  k.weights(w);
  const int i = threadIdx.x / kRow, q = threadIdx.x % kRow;
  k.zero_row(k.sp, i, q);
  k.zero_row(k.sdl, i, q);
  __syncwarp();
  k.for_slots(i, q, [&](int x, int pos, float mult) {
    float f[5];
    k.feat(i, pos, f);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < k.G) {
        const int at = k.st_at(g, i);
        const float lg = k.lrow(g, i)[x] + (raw ? k.bias(w, g, f) : 0.f);
        const float pr = expf(lg - k.m_[at]) * k.l_[at];
        const float dl = pr * (k.dprow(g, i)[x] - k.a_[at]);
        k.prow(g, i)[pos] = from_f<E>(mult * pr);
        k.dlrow(g, i)[pos] = from_f<E>(mult * dl);
#pragma unroll
        for (int y = 0; y < 5; ++y) acc[g][y] += mult * dl * f[y];
      }
    }
  });
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < k.G) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        const float v = warp_sum(acc[g][x]);
        if (lane == 0) atomicAdd(&k.acc[g * 6 + x], v);
      }
    }
  }
}

// dQ += dL K (shared memory); dK = dL^T Q and dV = P^T G, flushed to dkv
// with global atomics, one per channel pair of each chunk row; all over
// the block's channel slice.
template <typename E, bool VEC, bool WIDE>
__device__ __forceinline__ void products(Bwd<E, VEC, WIDE>& k) {
  constexpr bool TC = Bwd<E, VEC, WIDE>::TC;
  const Params& P = k.P;
  const int lds = k.L.lds, ldp = k.L.ldp, ldo = k.L.ldo, Uc = P.Uc;
  const int Ue = k.Ue;  // the chunk's width
  float* so = k.so;
  tile_mm<TC>(View<E, false>{k.sdl, ldp, kTile * ldp},
              View<E, false>{k.sk, lds, Uc * lds}, k.G, kTile, P.CP, Ue,
              [=](int g, int r, int col, float v0, float v1) {
                float2* o = reinterpret_cast<float2*>(
                    so + (g * kTile + r) * ldo + col);
                const float2 x = *o;
                *o = make_float2(x.x + v0, x.y + v1);
              },
              k.occupied_rk(), true);
  const int c_ = k.c_, cw = k.cws;
  const bool pairs = c_ % 2 == 0;
  const int* stok = k.stok;
  float* dkvb = P.dkv + static_cast<long long>(k.bi) * P.n * 2 * k.c +
                k.hg * k.G * 2 * c_ + k.chs;
  const long long c2 = 2 * k.c;
  auto flush = [=](int part) {
    return [=](int g, int r, int col, float v0, float v1) {
      const int tok = stok[r];
      if (tok < 0 || col >= cw) return;
      float* dst = dkvb + tok * c2 + (2 * g + part) * c_ + col;
      if (pairs) {
        atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v0, v1));
      } else {
        atomicAdd(dst, v0);
        if (col + 1 < cw) atomicAdd(dst + 1, v1);
      }
    };
  };
  tile_mm<TC>(View<E, true>{k.sdl, ldp, kTile * ldp},
              View<E, false>{k.sq, lds, kTile * lds}, k.G, Ue, P.CP, kTile,
              flush(0), k.occupied_pr(), true);
  tile_mm<TC>(View<E, true>{k.sp, ldp, kTile * ldp},
              View<E, false>{k.sg, lds, kTile * lds}, k.G, Ue, P.CP, kTile,
              flush(1), k.occupied_pr(), true);
}

// dq rows, the blank-token gradients and the rel-pos parameter gradients
// of the block's channel slice (the rel-pos ones from slice 0 only).
// d_pe_bias is the sum of dl over the slots, which is -dlb per row
// (sum p + pb = 1): summed so, without the cancellation of the slots'
// terms.
template <typename E, bool VEC, bool WIDE>
__device__ __forceinline__ void finish(Bwd<E, VEC, WIDE>& k) {
  const Params& P = k.P;
  const int c = k.c, c_ = k.c_, cw = k.cws, chs = k.chs, w = k.G * cw;
  const int h = P.h;
  E* dq = static_cast<E*>(P.dq) +
          (static_cast<long long>(k.bi) * P.n + k.q0) * c +
          k.hg * k.G * c_ + chs;
  for (int e = threadIdx.x; e < k.rows * w; e += kThreads) {
    const int i = e / w;
    const int r = e - i * w;
    const int g = r / cw, ch = r - g * cw;
    const float v =
        k.orow(g, i)[ch] +
        k.dlb_[k.st_at(g, i)] * P.blank_k[(chs + ch) * h + k.head(g)];
    dq[static_cast<long long>(i) * c + g * c_ + ch] = from_f<E>(v);
  }
  // d_blank_k and d_blank_v: a row group per (head, channel) pair, its
  // threads over the rows
  float* dp = P.dparams;
  const int q = threadIdx.x % kRow;
  for (int e0 = 0; e0 < w; e0 += kTile) {
    const int e = e0 + threadIdx.x / kRow;
    const int g = e < w ? e / cw : 0, ch = e < w ? e - g * cw : 0;
    float sk = 0.f, sv = 0.f;
    if (e < w) {
      for (int i = q; i < k.rows; i += kRow) {
        const int at = k.st_at(g, i);
        sk += k.dlb_[at] * to_f(k.sq[at * k.L.lds + ch]);
        sv += k.pb_[at] * to_f(k.sg[at * k.L.lds + ch]);
      }
    }
    sk = row_sum(sk);
    sv = row_sum(sv);
    if (e < w && q == 0) {
      atomicAdd(&dp[6 * h + (chs + ch) * h + k.head(g)], sk);
      atomicAdd(&dp[6 * h + c + k.head(g) * c_ + chs + ch], sv);
    }
  }
  if (k.sl != 0) return;  // block-uniform
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < k.G) {  // d_pe_bias: warp g sums -dlb over the rows
    float s = 0.f;
    for (int i = lane; i < k.rows; i += 32) s -= k.dlb_[k.st_at(warp, i)];
    s = warp_sum(s);
    if (lane == 0) k.acc[warp * 6 + 5] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 6 * k.G; e += kThreads) {
    const int g = e / 6, x = e - g * 6;
    atomicAdd(&dp[x < 5 ? x * h + k.head(g) : 5 * h + k.head(g)], k.acc[e]);
  }
}

template <typename E, bool VEC, bool WIDE>
__global__ void __launch_bounds__(kThreads, 1)
cluster_attention_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Bwd<E, VEC, WIDE> k(p, smem);
  k.begin();
  k.attend();  // pass 1: the softmax statistics and S = g . out
  deltas(k);
  __syncthreads();
  // pass 1 left the logits and dP of every slot kept per slot, or of the
  // last chunk; a union of one chunk is still staged. Else pass 2 stages
  // each chunk again: its k rows, or when the logits were kept per chunk
  // position, everything to compute them again.
  const bool one = k.UT <= p.Uc;
  const bool raw = !one && !k.keep();
  for (int p0 = 0; p0 < k.UT; p0 += p.Uc) {  // pass 2
    if (!one) {
      k.stage_meta(p0, raw);
      if (raw) {
        k.contract();
      } else if (k.nch() == 1) {
        k.stage_kv(0, true, false);
        cp_async_wait_all();
      }
      __syncthreads();
    }
    grad_chunk(k, raw);
    __syncthreads();
    if (k.nch() > 1) {  // the block's channel slice of q, g and k
      k.stage_tile(k.qb, k.sq, k.chs);
      k.stage_tile(k.gb, k.sg, k.chs);
      k.stage_kv(k.chs, true, false);
      cp_async_wait_all();
      __syncthreads();
    }
    products(k);
    __syncthreads();
  }
  if (k.nch() > 1 && k.UT == 0) {  // finish reads the slice of q and g
    k.stage_tile(k.qb, k.sq, k.chs);
    k.stage_tile(k.gb, k.sg, k.chs);
    cp_async_wait_all();
    __syncthreads();
  }
  finish(k);
}

template <typename E>
int launch(Params& p, int esize, bool vec, cudaStream_t stream) {
  int bytes;
  if (!apply_plan(p, esize, true, &bytes))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool wide = wide_plan(p);
  auto kernel = vec ? (wide ? cluster_attention_bwd_kernel<E, true, true>
                            : cluster_attention_bwd_kernel<E, true, false>)
                    : (wide ? cluster_attention_bwd_kernel<E, false, true>
                            : cluster_attention_bwd_kernel<E, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(p), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, kv, g_out and dq). dkv (b, n, 2c)
// and dparams (6h + 2c) are float32 and must be zeroed by the caller. The
// metadata is as for cluster_attention_fwd. Returns a cudaError_t.
extern "C" int cluster_attention_bwd(
    const void* q, const void* kv, const void* pos, const void* ucl,
    const void* ucount, const void* nidx, const void* pe_kernel,
    const void* pe_bias, const void* blank_k, const void* blank_v,
    const void* g_out, void* dq, void* dkv, void* dparams, int b, int n,
    int h, int c_, int nnc, int cs, int rel_width, int clamp_width,
    long long pos_bstride, int meta_batched, int dtype, void* stream) {
  if (static_cast<long long>(b) * n == 0) return cudaSuccess;
  Params p = {};
  p.q = q;
  p.kv = kv;
  p.pos = static_cast<const float*>(pos);
  p.ucl = static_cast<const int*>(ucl);
  p.ucount = static_cast<const int*>(ucount);
  p.nidx = static_cast<const int*>(nidx);
  p.pe_kernel = static_cast<const float*>(pe_kernel);
  p.pe_bias = static_cast<const float*>(pe_bias);
  p.blank_k = static_cast<const float*>(blank_k);
  p.blank_v = static_cast<const float*>(blank_v);
  p.g_out = g_out;
  p.dq = dq;
  p.dkv = static_cast<float*>(dkv);
  p.dparams = static_cast<float*>(dparams);
  p.b = b;
  p.n = n;
  p.h = h;
  p.c_ = c_;
  p.nnc = nnc;
  p.cs = cs;
  p.ntiles = (n + kTile - 1) / kTile;
  p.clamp_hi = clamp_width > 0 ? clamp_width - 1 : -1;
  p.R = static_cast<float>(rel_width);
  p.pos_bstride = pos_bstride;
  p.meta_batched = meta_batched;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(q) && aligned16(kv) && aligned16(g_out);
  if (dtype == 0)
    return launch<float>(p, 4, aligned && c_ % 4 == 0, st);
  if (dtype == 1)
    return launch<bf16>(p, 2, aligned && c_ % 8 == 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
