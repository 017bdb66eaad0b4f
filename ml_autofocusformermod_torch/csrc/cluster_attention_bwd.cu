// Fused local cluster attention, backward, recompute mode, for Hopper
// (sm_90a): the mode MLAFF_BWD_SAVED=0 selects (the JAX package's
// flash-style backward, nothing but the inputs saved). The algebra, the
// tiling and the owner pass: cluster_attention_bwd.cuh.

#include "cluster_attention_bwd.cuh"

namespace {

using namespace ca;

template <typename E, bool VEC, bool WIDE, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
cluster_attention_bwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  Bwd<E, VEC, WIDE, DROP> k(p, smem);
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

// The instance of a launch: dropout only with vectorised rows (c_ % 8 ==
// 0, aligned), as the JAX package's fused dropout requires c_ % 8 == 0.
struct Pick {
  template <typename E>
  static KernelFn kernel(bool vec, bool wide, bool drop) {
    if (drop && !vec) return nullptr;
    if (drop)
      return wide ? cluster_attention_bwd_kernel<E, true, true, true>
                  : cluster_attention_bwd_kernel<E, true, false, true>;
    if (vec)
      return wide ? cluster_attention_bwd_kernel<E, true, true, false>
                  : cluster_attention_bwd_kernel<E, true, false, false>;
    return wide ? cluster_attention_bwd_kernel<E, false, true, false>
                : cluster_attention_bwd_kernel<E, false, false, false>;
  }
};

}  // namespace

// The recompute mode's entry (bwd_entry, cluster_attention_bwd.cuh);
// outp and stats are not read.
extern "C" int cluster_attention_bwd(
    const void* q, const void* kv, const void* pos, const void* ucl,
    const void* ucount, const void* nidx, const void* pe_kernel,
    const void* pe_bias, const void* blank_k, const void* blank_v,
    const void* g_out, const void* outp, const void* stats, void* dq,
    void* dkv, void* dkv_part, void* dparams, int b, int n, int nq, int qoff,
    int h, int c_, int nnc, int cs, int rel_width, int clamp_width,
    long long pos_bstride, int meta_batched, int ucap, int dtype, int drop,
    int drop_seed, int drop_thresh, float drop_scale, void* stream) {
  return bwd_entry<Pick>(
      q, kv, pos, ucl, ucount, nidx, pe_kernel, pe_bias, blank_k, blank_v,
      g_out, outp, stats, dq, dkv, dkv_part, dparams, b, n, nq, qoff, h, c_,
      nnc, cs, rel_width, clamp_width, pos_bstride, meta_batched, ucap,
      dtype, drop, drop_seed, drop_thresh, drop_scale, stream);
}
