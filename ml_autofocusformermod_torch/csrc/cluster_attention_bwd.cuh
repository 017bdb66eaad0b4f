// The fused local cluster attention backward for Hopper (sm_90a): the
// device code its two kernels share, the recompute mode's
// (cluster_attention_bwd.cu) and the saved-stats mode's
// (cluster_attention_bwd_saved.cu), each built as a library of its own.
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
// Padded slots (token >= n) have p = 0 and contribute nothing. Under
// attention dropout (the forward's keep/scale M_s, M_b replayed by
// drop_keep): dp_s = M_s g_i . v_t, dpb = M_b g_i . blank_v[hi], dv_t +=
// M_s p_s g_i and d_blank_v += M_b pb g_i; S = g_i . out_i still holds.
//
// What bounds it on the H100: the bytes are q, kv, g once and dq, dkv
// once (0.05 ms for AFF-Mini stage 1 at b128 bf16), plus the tile
// partials of dk/dv below, written once and read once.
//
// The tiling (cluster_attention_tile.cuh): one block per (image, tile of
// 64 queries, group of G heads). In the saved mode (the JAX package's
// default, _fca_fwd, clusten_pallas.py:3011) the block reads the forward's
// max and denominator of each (query, head) and takes S = g . out from the
// tile's rows of g and of the forward's output (the delta trick); then one
// pass over the union: per chunk, q.k^T and g.v^T, the row pass turning
// them into P and dL with the saved statistics, and the products below
// (each chunk's logits and dP made once; no staging of k rows again). The
// recompute mode (cluster_attention_bwd.cu) takes two passes:
//   pass 1, per union chunk: q.k^T and g.v^T over the tile x chunk
//     (tensor cores for bf16, CUDA cores for f32), kept per (row, slot);
//     the online softmax gives (max, sum) per (query, head) and
//     S = sum_s p_s dp_s + pb dpb = g . out, exactly from the same p;
//   pass 2, per union chunk: the row pass (geometry once per (query,
//     slot) for all G heads) turns the kept logits and dP into P and dL
//     and sums the rel-pos parameter gradients; then dQ += dL K in shared
//     memory, and dK = dL^T Q and dV = P^T G as tile products whose sum
//     over the tile's 64 queries is taken inside the product.
// When the rows keep their logits per slot, pass 2 computes no product of
// pass 1 again and stages a chunk's k rows again only when the union spans
// several chunks; when they keep them per chunk position (a large m), it
// computes a chunk's q.k^T and g.v^T again. A head wider than 64 channels
// takes the products over channel chunks, one block per output slice.
//
// No float atomics: every sum is taken in an order fixed by the shapes
// alone, so a call repeated on the same inputs gives the same bits.
//   - dk/dv: a block writes its tile's sums, one row per union position,
//     to the partials dkv_part[image, tile, union position] (f32, written
//     once). A second kernel (dkv_owner_kernel) gives each cluster of each
//     image one block, which finds the tiles whose union names the
//     cluster (a binary search of each tile's sorted union) and sums their
//     rows in ascending tile order, writing dkv once in kv's dtype.
//   - the rel-pos gradients: each warp sums its rows' terms in a slot of
//     its own; the block adds the 16 slots in warp order.
//   - the 6h + 2c parameter gradients: each block writes its values to a
//     row of its own of dparams (b * ntiles rows); the caller sums the
//     rows (ops/cluster_attention.py, a torch sum over the rows).


#pragma once

#include "cluster_attention_tile.cuh"

namespace ca {

template <typename E, bool VEC, bool WIDE, bool DROP>
using Bwd = Block<E, VEC, true, WIDE, DROP>;

// After pass 1: S = g . out = (sum_s e_s dp_s + e_b dpb) / l with e the
// unnormalised softmax terms (in a_), dlb and pb per (head, row), from
// dpb = M_b g . blank_v (pb_ holds g . blank_v); l_ becomes 1 / l and pb_
// the dropped M_b pb of d_blank_v.
template <class K>
__device__ __forceinline__ void deltas(K& k) {
  for (int e = threadIdx.x; e < k.G * kTile; e += kThreads) {
    const float kb = k.keep_at(e / kTile, e % kTile, kBlankCol);
    const float dpb = k.pb_[e] * kb;
    const float inv = 1.f / k.l_[e];
    const float eb = expf(k.bl_[e] - k.m_[e]);
    const float S = (k.a_[e] + eb * dpb) * inv;
    const float pb = eb * inv;
    k.l_[e] = inv;
    k.a_[e] = S;
    k.pb_[e] = pb * kb;
    k.dlb_[e] = pb * (dpb - S);
  }
}

// The saved mode's statistics per (head, row): the forward's max m_ and
// 1 / denominator l_ (stats), S = g . out over the head's c_ channels of
// the tile's rows of g and of the forward's output (a_), then pb, dlb and
// M_b pb as deltas() makes them. A group of kRow threads per row.
template <class K>
__device__ __forceinline__ void saved_deltas(K& k) {
  using E = typename K::Elem;
  const Params& P = k.P;
  const int i = threadIdx.x / kRow, q = threadIdx.x % kRow;
  const E* ob = static_cast<const E*>(P.outp) +
                static_cast<long long>(k.bi) * P.nq * k.c + k.hg * k.G * k.c_;
  for (int g = 0; g < k.G; ++g) {
    float s = 0.f;
    if (i < k.rows) {
      const long long at = static_cast<long long>(k.q0 + i) * k.c + g * k.c_;
      for (int ch = q; ch < k.c_; ch += kRow)
        s += to_f(k.gb[at + ch]) * to_f(ob[at + ch]);
    }
    s = row_sum(s);
    if (q == 0) {
      const int e = k.st_at(g, i);
      float m = 0.f, inv = 1.f;
      if (i < k.rows) {
        const float* st =
            P.stats +
            (static_cast<long long>(k.bi) * P.nq + k.q0 + i) * 2 * P.h;
        m = st[k.head(g)];
        inv = 1.f / st[P.h + k.head(g)];
      }
      const float kb = k.keep_at(g, i, kBlankCol);
      const float dpb = k.pb_[e] * kb;
      const float pb = expf(k.bl_[e] - m) * inv;
      k.m_[e] = m;
      k.l_[e] = inv;
      k.a_[e] = s;
      k.pb_[e] = pb * kb;
      k.dlb_[e] = pb * (dpb - s);
    }
  }
}

// The row pass of pass 2 (or of the saved mode's one pass) over one
// chunk: P (times the dropout keep/scale, for dV) and dL at the row's
// slots (0 elsewhere), from the logits and dP kept per slot (`raw`: q.k
// as the contraction left it, the bias still to add); the chunk's share
// of d_pe_kernel go to the block's sums in shared memory. A cluster
// listed mult times counts mult times.
template <class K>
__device__ __forceinline__ void grad_chunk(K& k, bool raw) {
  using E = typename K::Elem;
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
    const int tok = k.stok[pos];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < k.G) {
        const int at = k.st_at(g, i);
        const float kp = k.keep_at(g, i, tok);  // 1 without dropout
        const float lg = k.lrow(g, i)[x] + (raw ? k.bias(w, g, f) : 0.f);
        const float pr = expf(lg - k.m_[at]) * k.l_[at];
        const float dp = k.dprow(g, i)[x];
        const float dl = pr * ((K::Drop ? dp * kp : dp) - k.a_[at]);
        k.prow(g, i)[pos] = from_f<E>(K::Drop ? mult * pr * kp : mult * pr);
        k.dlrow(g, i)[pos] = from_f<E>(mult * dl);
#pragma unroll
        for (int y = 0; y < 5; ++y) acc[g][y] += mult * dl * f[y];
      }
    }
  });
  const int lane = threadIdx.x & 31;
  float* mine = k.acc + (threadIdx.x >> 5) * 6 * k.G;  // this warp's slot
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < k.G) {
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        const float v = warp_sum(acc[g][x]);
        if (lane == 0) mine[g * 6 + x] += v;
      }
    }
  }
}

// dQ += dL K (shared memory); dK = dL^T Q and dV = P^T G, written to the
// tile's partials, one row per union position of the chunk; all over the
// block's channel slice.
template <class K>
__device__ __forceinline__ void products(K& k) {
  using E = typename K::Elem;
  constexpr bool TC = K::TC;
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
  const long long c2 = 2 * k.c;
  float* part = P.dkv_part +
                ((static_cast<long long>(k.bi) * P.ntiles + k.t) * P.ucap +
                 k.p0) * c2 +
                k.hg * k.G * 2 * c_ + k.chs;
  auto flush = [=](int part_) {
    return [=](int g, int r, int col, float v0, float v1) {
      if (stok[r] < 0 || col >= cw) return;
      float* dst = part + r * c2 + (2 * g + part_) * c_ + col;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        dst[0] = v0;
        if (col + 1 < cw) dst[1] = v1;
      }
    };
  };
  // every live position's row is written, zeros included (no skip_empty)
  tile_mm<TC>(View<E, true>{k.sdl, ldp, kTile * ldp},
              View<E, false>{k.sq, lds, kTile * lds}, k.G, Ue, P.CP, kTile,
              flush(0), k.occupied_pr(), false);
  tile_mm<TC>(View<E, true>{k.sp, ldp, kTile * ldp},
              View<E, false>{k.sg, lds, kTile * lds}, k.G, Ue, P.CP, kTile,
              flush(1), k.occupied_pr(), false);
}

// dq rows, the blank-token gradients and the rel-pos parameter gradients
// of the block's channel slice (the rel-pos ones from slice 0 only).
// d_pe_bias is the sum of dl over the slots, which is -dlb per row
// (sum p + pb = 1): summed so, without the cancellation of the slots'
// terms. In the saved mode, whose S = g . out carries the rounding of the
// stored output, -dlb differs from the slots' sum by pb times that
// rounding, where the sum of the slots' terms in f32 would lose the
// gradient to cancellation (about 1e-3 of it at m = 760).
template <class K>
__device__ __forceinline__ void finish(K& k) {
  using E = typename K::Elem;
  const Params& P = k.P;
  const int c = k.c, c_ = k.c_, cw = k.cws, chs = k.chs, w = k.G * cw;
  const int h = P.h;
  E* dq = static_cast<E*>(P.dq) +
          (static_cast<long long>(k.bi) * P.nq + k.q0) * c +
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
  // threads over the rows; the block's row of dparams
  float* dp = P.dparams + (static_cast<long long>(k.bi) * P.ntiles + k.t) *
                              (6 * h + 2 * c);
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
      dp[6 * h + (chs + ch) * h + k.head(g)] = sk;
      dp[6 * h + c + k.head(g) * c_ + chs + ch] = sv;
    }
  }
  if (k.sl != 0) return;  // block-uniform
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < k.G) {  // d_pe_bias: warp g sums -dlb over the rows
    float s = 0.f;
    for (int i = lane; i < k.rows; i += 32) s -= k.dlb_[k.st_at(warp, i)];
    s = warp_sum(s);
    if (lane == 0) dp[5 * h + k.head(warp)] = s;
  }
  // d_pe_kernel: the warps' slots added in warp order
  for (int e = threadIdx.x; e < 5 * k.G; e += kThreads) {
    const int g = e / 5, x = e - g * 5;
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s += k.acc[(wi * k.G + g) * 6 + x];
    dp[x * h + k.head(g)] = s;
  }
}

// dkv of one cluster of one image (block (cluster, image)): the rows of
// its cs tokens are the sums of the tile partials of every tile whose
// union names the cluster, in ascending tile order. Each tile's union is
// sorted, so a binary search finds the cluster's union index in it; the
// list of (tile, index) is compacted in tile order by warp 0. Every output
// element is summed by one thread in that order: the same bits on every
// run. A token that no tile names gets 0.
constexpr int kOwnThreads = 256;

template <typename E, bool VEC4>
__global__ void __launch_bounds__(kOwnThreads)
dkv_owner_kernel(const float* __restrict__ part, const int* __restrict__ ucl,
                 const int* __restrict__ ucount, E* __restrict__ dkv, int n,
                 int cs, int ntiles, int nnc, int ucap, int c2,
                 int meta_batched) {
  extern __shared__ int own[];  // [ntiles] found index, [ntiles] the list
  int* found = own;
  int* list = own + ntiles;
  __shared__ int count;
  const int cl = blockIdx.x, bi = blockIdx.y, tid = threadIdx.x;
  const long long mb = static_cast<long long>(meta_batched ? bi : 0) * ntiles;
  for (int t = tid; t < ntiles; t += kOwnThreads) {
    const int* u = ucl + (mb + t) * kTile * nnc;
    int lo = 0, hi = ucount[mb + t];  // the first id >= cl in [lo, hi)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(u + mid) < cl)
        lo = mid + 1;
      else
        hi = mid;
    }
    found[t] = lo < ucount[mb + t] && __ldg(u + lo) == cl ? lo : -1;
  }
  __syncthreads();
  if (tid < 32) {
    int at = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + tid;
      const int u = t < ntiles ? found[t] : -1;
      const unsigned has = __ballot_sync(0xffffffffu, u >= 0);
      if (u >= 0)
        list[at + __popc(has & ((1u << tid) - 1u))] = t * ucap + u * cs;
      at += __popc(has);
    }
    if (tid == 0) count = at;
  }
  __syncthreads();
  const int cnt = count;
  const int rows = min(cs, n - cl * cs);
  const float* src = part + static_cast<long long>(bi) * ntiles * ucap * c2;
  E* dst = dkv + (static_cast<long long>(bi) * n + cl * cs) * c2;
  if constexpr (VEC4) {
    const int per = c2 / 4;
    for (int e = tid; e < rows * per; e += kOwnThreads) {
      const int r = e / per, ch = (e - r * per) * 4;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = 0; i < cnt; ++i) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            src + static_cast<long long>(list[i] + r) * c2 + ch));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      E* o = dst + static_cast<long long>(r) * c2 + ch;
      o[0] = from_f<E>(s.x);
      o[1] = from_f<E>(s.y);
      o[2] = from_f<E>(s.z);
      o[3] = from_f<E>(s.w);
    }
  } else {
    for (int e = tid; e < rows * c2; e += kOwnThreads) {
      const int r = e / c2, ch = e - r * c2;
      float s = 0.f;
      for (int i = 0; i < cnt; ++i)
        s += src[static_cast<long long>(list[i] + r) * c2 + ch];
      dst[static_cast<long long>(r) * c2 + ch] = from_f<E>(s);
    }
  }
}

using KernelFn = void (*)(Params);

// The block kernel of `Pick` for the launch (the plan applied first),
// then the owner pass over the tile partials. Pick::kernel<E>(vec, wide,
// drop) names the instance, or null when none serves the launch.
template <typename E, class Pick>
int launch_bwd(Params& p, int esize, bool vec, void* dkv,
               cudaStream_t stream) {
  int bytes;
  if (!apply_plan(p, esize, true, &bytes))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const KernelFn kernel =
      Pick::template kernel<E>(vec, wide_plan(p), p.drop != 0);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(p), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int c2 = 2 * p.h * p.c_;
  const int clusters = (p.n + p.cs - 1) / p.cs;
  const int obytes = 2 * p.ntiles * static_cast<int>(sizeof(int));
  auto owner = c2 % 4 == 0 ? dkv_owner_kernel<E, true>
                           : dkv_owner_kernel<E, false>;
  err = cudaFuncSetAttribute(owner,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             obytes);
  if (err != cudaSuccess) return err;
  owner<<<dim3(clusters, p.b), kOwnThreads, obytes, stream>>>(
      p.dkv_part, p.ucl, p.ucount, static_cast<E*>(dkv), p.n, p.cs,
      p.ntiles, p.nnc, p.ucap, c2, p.meta_batched);
  return cudaGetLastError();
}

// The C entry of either mode: its arguments into Params, then the launch by
// dtype (0 = float32, 1 = bfloat16: q, kv, g_out, outp, dq and dkv). The query
// range (nq rows of q, g_out, outp, stats and dq from token qoff, 1 <= nq,
// qoff + nq <= n) and the metadata are as for cluster_attention_fwd; dkv has
// all n rows, the range's queries' share of the gradient (0 at tokens that no
// query of the range reads). outp and stats: the forward's output and (b, nq,
// 2h) f32 statistics (the saved mode reads them; the recompute mode takes
// null). drop, drop_seed, drop_thresh, drop_scale: the forward's dropout,
// replayed (c_ % 8 == 0 and 16-byte aligned rows, as the JAX package's fused
// dropout needs). dkv_part (b, ntiles, ucap, 2c) f32 holds the tiles' partial
// dk/dv, ucap >= cs * max(ucount) rows per tile; dparams (b * ntiles, 6h + 2c)
// f32 one row per (image, tile), whose sum over the rows is d_pe_kernel (5,
// h), d_pe_bias (h), d_blank_k (c_, h) and d_blank_v (h, c_). dq, dkv and both
// buffers are written in full: no zeroing needed. Returns a cudaError_t.
template <class Pick>
int bwd_entry(const void* q, const void* kv, const void* pos,
              const void* ucl, const void* ucount, const void* nidx,
              const void* pe_kernel, const void* pe_bias,
              const void* blank_k, const void* blank_v, const void* g_out,
              const void* outp, const void* stats, void* dq, void* dkv,
              void* dkv_part, void* dparams, int b, int n, int nq, int qoff,
              int h, int c_, int nnc, int cs, int rel_width, int clamp_width,
              long long pos_bstride, int meta_batched, int ucap, int dtype,
              int drop, int drop_seed, int drop_thresh, float drop_scale,
              void* stream) {
  if (static_cast<long long>(b) * n == 0) return cudaSuccess;
  if (qoff < 0 || nq < 1 || qoff + nq > n)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.outp = outp;
  p.stats = static_cast<float*>(const_cast<void*>(stats));
  p.drop = drop;
  p.drop_seed = drop_seed;
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
  p.dq = dq;
  p.dkv_part = static_cast<float*>(dkv_part);
  p.dparams = static_cast<float*>(dparams);
  p.b = b;
  p.n = n;
  p.nq = nq;
  p.qoff = qoff;
  p.h = h;
  p.c_ = c_;
  p.nnc = nnc;
  p.cs = cs;
  p.ntiles = (nq + kTile - 1) / kTile;
  p.clamp_hi = clamp_width > 0 ? clamp_width - 1 : -1;
  p.R = static_cast<float>(rel_width);
  p.pos_bstride = pos_bstride;
  p.meta_batched = meta_batched;
  p.ucap = ucap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(q) && aligned16(kv) && aligned16(g_out) &&
                       (outp == nullptr || aligned16(outp));
  if (dtype == 0)
    return launch_bwd<float, Pick>(p, 4, aligned && c_ % 4 == 0, dkv, st);
  if (dtype == 1)
    return launch_bwd<bf16, Pick>(p, 2, aligned && c_ % 8 == 0, dkv, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ca
