// Fused local cluster attention, backward, saved-stats mode, for Hopper
// (sm_90a): the mode training runs (the JAX package's default, _fca_fwd,
// clusten_pallas.py:3011-3042; _bwd_kernel's saved branch at :1915,
// :1968, :2191, :2256, _bwd_kernel_stacked's at :1147, :1222). The block
// reads the forward's max and denominator of each (query, head) and takes
// S = g . out from the tile's rows of g and the forward's output (the
// delta trick), then walks the union once: per chunk, q.k^T and g.v^T,
// the row pass turning them into P and dL with the saved statistics, and
// the products. The algebra, the tiling and the owner pass:
// cluster_attention_bwd.cuh.

#include "cluster_attention_bwd.cuh"

namespace {

using namespace ca;

template <typename E, bool VEC, bool WIDE, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
cluster_attention_bwd_saved_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Bwd<E, VEC, WIDE, DROP> k(p, smem);
  k.begin();
  // one pass: each chunk's logits and dP made once
  saved_deltas(k);
  __syncthreads();
  for (int p0 = 0; p0 < k.UT; p0 += p.Uc) {
    k.stage_meta(p0, true);
    k.contract();
    __syncthreads();
    grad_chunk(k, true);
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

// The instance of a launch: dropout only with vectorised rows (c_ % 8 ==
// 0, aligned), as the JAX package's fused dropout requires c_ % 8 == 0.
struct Pick {
  template <typename E>
  static KernelFn kernel(bool vec, bool wide, bool drop) {
    if (drop && !vec) return nullptr;
    if (drop)
      return wide ? cluster_attention_bwd_saved_kernel<E, true, true, true>
                  : cluster_attention_bwd_saved_kernel<E, true, false, true>;
    if (vec)
      return wide ? cluster_attention_bwd_saved_kernel<E, true, true, false>
                  : cluster_attention_bwd_saved_kernel<E, true, false, false>;
    return wide ? cluster_attention_bwd_saved_kernel<E, false, true, false>
                : cluster_attention_bwd_saved_kernel<E, false, false, false>;
  }
};

}  // namespace

// The saved mode's entry (bwd_entry, cluster_attention_bwd.cuh); outp and
// stats must be given.
extern "C" int cluster_attention_bwd_saved(
    const void* q, const void* kv, const void* pos, const void* ucl,
    const void* ucount, const void* nidx, const void* pe_kernel,
    const void* pe_bias, const void* blank_k, const void* blank_v,
    const void* g_out, const void* outp, const void* stats, void* dq,
    void* dkv, void* dkv_part, void* dparams, int b, int n, int nq, int qoff,
    int h, int c_, int nnc, int cs, int rel_width, int clamp_width,
    long long pos_bstride, int meta_batched, int ucap, int dtype, int drop,
    int drop_seed, int drop_thresh, float drop_scale, void* stream) {
  if (outp == nullptr || stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return bwd_entry<Pick>(
      q, kv, pos, ucl, ucount, nidx, pe_kernel, pe_bias, blank_k, blank_v,
      g_out, outp, stats, dq, dkv, dkv_part, dparams, b, n, nq, qoff, h, c_,
      nnc, cs, rel_width, clamp_width, pos_bstride, meta_batched, ucap,
      dtype, drop, drop_seed, drop_thresh, drop_scale, stream);
}
