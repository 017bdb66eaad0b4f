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
// Optionally (the saved-stats mode, JAX _fca_fwd) the softmax max mx and
// denominator denom of each (query, head) go to stats (b, n, 2h) f32 (lane
// hi and h + hi, as JAX's _fwd_kernel writes them, clusten_pallas.py:
// 754-757), for the backward; and (attention dropout, JAX _fca_drop) each
// numerator e^(.) of a slot or the blank is multiplied by its keep/scale
// drop_keep(seed, image, head, query row i, token t or 65535) before P.V,
// the denominator undropped (clusten_pallas.py:940-957).
// q is pre-scaled; kv holds per head k then v: channel (hi, 0|1, c_).
//
// What bounds it on the H100: the bytes are q, kv and out once each
// (0.03 ms for AFF-Mini stage 1 at b128 bf16, 3.35 TB/s), and the work is
// ~4 m c_ flops per (query, head), far under the tensor cores' rate. A
// kernel that gathers each query's 48 rows pays instead a chain of
// dependent gathers per (query, head), with every row fetched again by
// each of the ~48 queries that share a cluster (a one-warp-per-(query,
// head) kernel took 2.3-2.6 ns per (image, query, head) task at every
// stage, whatever c_).
//
// The tiling (cluster_attention_tile.cuh): one block per (image, tile of
// 64 cluster-ordered queries, group of G heads, slice of at most 64 output
// channels). The tile's neighbour clusters are staged once into shared
// memory with cp.async, so each k/v row is read from L2/HBM once per tile;
// q.k^T and P.V run over the whole tile x union chunk on tensor cores
// (bf16, mma.sync, f32 accumulators) or CUDA cores (f32); the q.k^T
// epilogue keeps only each row's slots, and one row pass per chunk
// computes the geometry once per (query, slot) for all G heads and the
// online softmax, so any union size runs. A head wider than 64 channels
// takes q.k^T over channel chunks and one block per output slice, so any
// c_ runs too. Loads are f32 or bf16, the softmax and geometry f32, the
// output q's dtype.

#include "cluster_attention_tile.cuh"

namespace {

using namespace ca;

template <typename E, bool VEC, bool WIDE, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
cluster_attention_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Block<E, VEC, false, WIDE, DROP> blk(p, smem);
  blk.begin();
  blk.attend();
  const int c = blk.c, c_ = blk.c_, cw = blk.cws, w = blk.G * cw;
  E* out = static_cast<E*>(p.out) +
           (static_cast<long long>(blk.bi) * p.nq + blk.q0) * c +
           blk.hg * blk.G * c_ + blk.chs;
  for (int e = threadIdx.x; e < blk.rows * w; e += kThreads) {
    const int i = e / w;
    const int r = e - i * w;
    const int g = r / cw, ch = r - g * cw;
    const float o = blk.orow(g, i)[ch];
    out[static_cast<long long>(i) * c + g * c_ + ch] =
        from_f<E>(o / blk.l_[blk.st_at(g, i)]);
  }
  if (p.stats != nullptr && blk.sl == 0) {  // one channel slice writes them
    for (int e = threadIdx.x; e < blk.G * blk.rows; e += kThreads) {
      const int g = e / blk.rows, i = e - g * blk.rows;
      float* st = p.stats +
                  (static_cast<long long>(blk.bi) * p.nq + blk.q0 + i) * 2 *
                      p.h;
      st[blk.head(g)] = blk.m_[blk.st_at(g, i)];
      st[p.h + blk.head(g)] = blk.l_[blk.st_at(g, i)];
    }
  }
}

template <typename E>
int launch(Params& p, int esize, bool vec, cudaStream_t stream) {
  int bytes;
  if (!apply_plan(p, esize, false, &bytes))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool wide = wide_plan(p);
  // dropout only with vectorised rows (c_ % 8 == 0, aligned), as the JAX
  // package's fused dropout requires c_ % 8 == 0
  void (*kernel)(Params) = nullptr;
  if (p.drop && vec)
    kernel = wide ? cluster_attention_fwd_kernel<E, true, true, true>
                  : cluster_attention_fwd_kernel<E, true, false, true>;
  else if (!p.drop && vec)
    kernel = wide ? cluster_attention_fwd_kernel<E, true, true, false>
                  : cluster_attention_fwd_kernel<E, true, false, false>;
  else if (!p.drop)
    kernel = wide ? cluster_attention_fwd_kernel<E, false, true, false>
                  : cluster_attention_fwd_kernel<E, false, false, false>;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(p), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, kv and out). The query range: q,
// out and stats hold nq rows per image, the tokens [qoff, qoff + nq) of
// the n that kv and pos hold (qoff = 0, nq = n: every token); a query's
// position and its dropout row are those of its token. ucl, ucount, nidx:
// the tile metadata (ops/cluster_attention.py::tile_metadata) of the
// range's rows of ncc, batch-broadcast when meta_batched is 0. stats:
// (b, nq, 2h) f32, written when
// not null. drop: 1 for attention dropout with drop_seed, drop_thresh
// and drop_scale (drop_keep), for c_ % 8 == 0 and 16-byte aligned q and
// kv. Returns a cudaError_t.
extern "C" int cluster_attention_fwd(
    const void* q, const void* kv, const void* pos, const void* ucl,
    const void* ucount, const void* nidx, const void* pe_kernel,
    const void* pe_bias, const void* blank_k, const void* blank_v, void* out,
    void* stats, int b, int n, int nq, int qoff, int h, int c_, int nnc,
    int cs, int rel_width, int clamp_width, long long pos_bstride,
    int meta_batched, int dtype, int drop, int drop_seed, int drop_thresh,
    float drop_scale, void* stream) {
  if (static_cast<long long>(b) * nq == 0) return cudaSuccess;
  if (qoff < 0 || nq < 0 || qoff + nq > n)
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
  p.out = out;
  p.stats = static_cast<float*>(stats);
  p.drop = drop;
  p.drop_seed = drop_seed;
  p.drop_thresh = drop_thresh;
  p.drop_scale = drop_scale;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(q) && aligned16(kv);
  if (dtype == 0)
    return launch<float>(p, 4, aligned && c_ % 4 == 0, st);
  if (dtype == 1)
    return launch<bf16>(p, 2, aligned && c_ % 8 == 0, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
