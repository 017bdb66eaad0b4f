// Fused PointConv cluster merge, backward, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel
// ml_autofocusformermod_tpu/ops/merge_pallas.py::_merge_bwd_kernel (called
// from _merge_bwd_impl, merge_pallas.py:596-638). For the forward
//   out[t, i, c] = sum_{j,s} w[t, j*cs + s, i] * feat[ncc[t, j]*cs + s, c]
// it computes, with g = d out:
//   dw[t, (j,s), i] = sum_c g[t, i, c] * feat[ncc[t, j]*cs + s, c]
//   dfeat[r, c]     = sum over the (t, j) with ncc[t, j]*cs + s = r of
//                     sum_i w[t, (j,s), i] * g[t, i, c]
// Rows of the padded last cluster (r >= n) read zero: their dw is 0 and
// they receive nothing. dw has the weights' dtype; dfeat is summed in f32
// and written once, in feat's dtype.
//
// What bounds it on the H100: memory. The floor reads w, feat and g once
// and writes dw and dfeat once. The design inverts the scatter so that
// nothing is added twice to one place: every cluster kappa of an image has
// one owner, which computes everything that touches its rows. The inverse
// index (ops/cluster_merge.py::merge_inverse_index, once per backward, by
// merge_index_kernel below: one launch, a stable counting sort) lists the
// (t, j) pairs that name kappa, in (t, j) order, so
// with the list entries l = (t_l, j_l), G the stacked gradient rows
// g[t_l, i, :] (L*4 x c), F the cluster's rows (cs x c) and
// W[s, (l, i)] = w[t_l, j_l*cs + s, i]:
//   dW^T (L*4 x cs) = G F^T   -> each dw entry written once;
//   dF^T (c x cs)   = G^T W^T -> the cluster's dfeat rows, summed in list
//                               order (bitwise reproducible), written once.
// Every centre's g rows are read by the nnc clusters it names, so, as the
// TPU kernel kept an image resident in VMEM, the resident path (bf16, when
// an image's g rows fit in shared memory: every AFF-Mini merge) stages
// them once per block; a warp then owns one cluster at a time and runs
// both products on the tensor cores (mma.sync m16n8k16, f32
// accumulators), its A operands gathered from shared memory by ldmatrix
// (one row address per lane, rows named by the list), its B operands (w
// pairs, feat pairs) loaded straight from global memory. No barrier
// follows the staging. A block takes one image, or a share of its
// clusters when that gives fewer blocks than the card has SMs.
//
// Every other shape (f32, with exact f32 FMAs on the CUDA cores; bf16
// images whose g rows do not fit) takes the staged path: a block per
// cluster stages the cluster's F, and G and W for up to Lc list entries
// at a time, in shared memory with cp.async. The channels go in slices of
// CW with CW * S8 <= 2048 (the dF accumulators stay in registers) and a
// cluster S <= 32 rows at a time; when the channels need more than one
// slice, dW, which sums over every channel, takes a second pass over the
// list (G is read twice). No shape is refused.

#include "cluster_merge_tile.cuh"

namespace {

using namespace cm;

constexpr int kThreads = 128;  // staged path: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 16;     // accumulator tiles (16 x 8) per block
constexpr int kTPW = kTiles / kWarps;
constexpr int kMaxS = 32;      // cluster rows per pass
constexpr int kMaxL = 16;      // list entries per step
constexpr int kGBytes = 20480;  // a step's G tile at most (Lc >= 4 aside)
constexpr int kResNT = 4;         // resident path: 8-row n-tiles at most

// Staged path: sizes and shared-memory offsets (bytes) of one block.
struct Plan {
  int S, S8, CW, nsl, Lc, ldf, ldg, ldw;
  int off_f, off_g, off_w, off_dw, off_df, bytes;
};

inline Plan make_plan(int esize, int c, int cs) {
  Plan p;
  p.S = cs < kMaxS ? cs : kMaxS;
  p.S8 = round_up(p.S, 8);
  // dF^T tiles: (CW / 16) * (S8 / 8) <= kTiles
  const int cw_max = kTiles * 128 / p.S8 / 16 * 16;
  p.CW = round_up(c, 16) < cw_max ? round_up(c, 16) : cw_max;
  p.nsl = (c + p.CW - 1) / p.CW;
  const int pad = 16 / esize;  // 16 bytes per row: alignment and banks
  p.ldf = p.CW + pad;
  p.ldg = p.CW + pad;
  const int lc = kGBytes / (kIC * p.ldg * esize) / 4 * 4;
  p.Lc = lc < 4 ? 4 : (lc > kMaxL ? kMaxL : lc);
  p.ldw = p.Lc * kIC + pad;
  int off = 0;
  auto take = [&](int bytes) {
    const int at = off;
    off += round_up(bytes, 16);
    return at;
  };
  p.off_f = take(p.S8 * p.ldf * esize);
  p.off_g = take(p.Lc * kIC * p.ldg * esize);
  p.off_w = take(p.S8 * p.ldw * esize);
  p.off_dw = take(p.Lc * p.S * kIC * esize);
  p.off_df = take(p.S * p.CW * esize);
  p.bytes = off;
  return p;
}

// dst rows [0, rows) of CWP elements (stride ld) get src(r)[0, cw) and
// zeros elsewhere; a row whose src is null gets zeros. VEC: 16-byte
// cp.async pieces (cw and every source row 16-byte aligned).
template <typename E, bool VEC, class Src>
__device__ __forceinline__ void stage_rows(E* dst, int ld, int rows, int CWP,
                                           int cw, Src src) {
  if constexpr (VEC) {
    constexpr int N = 16 / sizeof(E);
    const int per = CWP / N;
    for (int e = threadIdx.x; e < rows * per; e += kThreads) {
      const int r = e / per, at = (e - r * per) * N;
      const E* s = src(r);
      E* d = dst + r * ld + at;
      if (s != nullptr && at < cw)
        cp_async16(d, s + at);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int e = threadIdx.x; e < rows * CWP; e += kThreads) {
      const int r = e / CWP, at = e - r * CWP;
      const E* s = src(r);
      dst[r * ld + at] = s != nullptr && at < cw ? s[at] : from_f<E>(0.f);
    }
  }
}

// kIC contiguous elements: 8 bytes (bf16) or 16 (f32)
template <typename E>
__device__ __forceinline__ void copy_ic_async(E* dst, const E* src) {
  if constexpr (sizeof(E) == 2)
    cp_async_small<8>(dst, src);
  else
    cp_async16(dst, src);
}

template <typename E>
__device__ __forceinline__ void zero_ic(E* dst) {
  if constexpr (sizeof(E) == 2)
    *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

template <typename E>
__device__ __forceinline__ void copy_ic(E* dst, const E* src) {
  if constexpr (sizeof(E) == 2)
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  else
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// Staged path: one block's image and buffers, and the steps its walk is
// made of. A step is lc <= Lc list entries (list[0, lc)) of one cluster,
// rows [row0, row0 + S) of it, channels [c0, c0 + cw).
template <typename E, bool VEC>
struct Owner {
  static constexpr bool TC = std::is_same<E, bf16>::value;
  const Plan& P;
  unsigned char* smem;
  const E *w, *feat, *g;
  E *dw, *dfeat;
  int n, c, nnc, cs, m, warp;

  __device__ E* sF() const { return reinterpret_cast<E*>(smem + P.off_f); }
  __device__ E* sG() const { return reinterpret_cast<E*>(smem + P.off_g); }
  __device__ E* sW() const { return reinterpret_cast<E*>(smem + P.off_w); }
  __device__ E* sDw() const { return reinterpret_cast<E*>(smem + P.off_dw); }
  __device__ E* sDf() const { return reinterpret_cast<E*>(smem + P.off_df); }
  __device__ int valid(int row0, int S) const {
    return max(0, min(S, n - row0));  // rows < n
  }

  __device__ void stage_f(int row0, int S, int c0, int cw) const {
    const int v = valid(row0, S);
    stage_rows<E, VEC>(sF(), P.ldf, P.S8, P.CW, cw, [&](int r) -> const E* {
      return r < v ? feat + static_cast<long long>(row0 + r) * c + c0
                   : nullptr;
    });
  }
  __device__ void stage_g(const int* list, int lc, int c0,
                          int cw) const {
    stage_rows<E, VEC>(sG(), P.ldg, P.Lc * kIC, P.CW, cw,
                       [&](int r) -> const E* {
      const int l = r / kIC;
      if (l >= lc) return nullptr;
      const int t = list[l] / nnc;
      return g + (static_cast<long long>(t) * kIC + r % kIC) * c + c0;
    });
  }
  __device__ void stage_w(const int* list, int lc, int s0,
                          int S) const {
    for (int e = threadIdx.x; e < P.S8 * P.Lc; e += kThreads) {
      const int s = e / P.Lc, l = e - s * P.Lc;
      E* d = sW() + s * P.ldw + l * kIC;
      if (s < S && l < lc) {
        const int tj = list[l], t = tj / nnc, j = tj - t * nnc;
        copy_ic_async(d, w + (static_cast<long long>(t) * m + j * cs + s0 +
                              s) * kIC);
      } else {
        zero_ic(d);
      }
    }
  }

  // acc += dF^T (CW x S8) = G^T W^T of the step
  __device__ void dfeat_tiles(float (&acc)[kTPW][4], int lc) const {
    const int K = round_up(lc * kIC, 16), NT = P.S8 / 8;
    const View<E, true> Gt{sG(), P.ldg};
    const View<E, false> Wv{sW(), P.ldw};
#pragma unroll
    for (int q = 0; q < kTPW; ++q) {
      const int u = warp + kWarps * q;
      if (u < P.CW / 16 * NT)
        tile_16x8<TC>(acc[q], Gt, Wv, u / NT * 16, u % NT * 8, K);
    }
  }
  // acc += dW^T (lc*4 x S8) = G F^T of the step
  __device__ void dw_tiles(float (&acc)[kTPW][4], int lc) const {
    const int MT = round_up(lc * kIC, 16) / 16, NT = P.S8 / 8;
    const View<E, false> Gv{sG(), P.ldg}, Fv{sF(), P.ldf};
#pragma unroll
    for (int q = 0; q < kTPW; ++q) {
      const int u = warp + kWarps * q;
      if (u < MT * NT)
        tile_16x8<TC>(acc[q], Gv, Fv, u / NT * 16, u % NT * 8, P.CW);
    }
  }
  // dW tiles into sDw, as (l, s, i) rows of S * 4
  __device__ void keep_dw(const float (&acc)[kTPW][4], int lc, int S) const {
    const int MT = round_up(lc * kIC, 16) / 16, NT = P.S8 / 8;
    E* dst = sDw();
#pragma unroll
    for (int q = 0; q < kTPW; ++q) {
      const int u = warp + kWarps * q;
      if (u < MT * NT)
        tile_store(acc[q], u / NT * 16, u % NT * 8,
                   [&](int row, int s, float v) {
                     if (s < S && row < lc * kIC)
                       dst[((row / kIC) * S + s) * kIC + row % kIC] =
                           from_f<E>(v);
                   });
    }
  }
  __device__ void write_dw(const int* list, int lc, int s0, int S) const {
    for (int e = threadIdx.x; e < lc * S; e += kThreads) {
      const int l = e / S, s = e - l * S;
      const int tj = list[l], t = tj / nnc, j = tj - t * nnc;
      copy_ic(dw + (static_cast<long long>(t) * m + j * cs + s0 + s) * kIC,
              sDw() + (l * S + s) * kIC);
    }
  }
  // the rows' dfeat slice from the accumulators (two barriers inside)
  __device__ void write_dfeat(const float (&acc)[kTPW][4], int row0, int S,
                              int c0, int cw) const {
    const int NT = P.S8 / 8;
    E* buf = sDf();
#pragma unroll
    for (int q = 0; q < kTPW; ++q) {
      const int u = warp + kWarps * q;
      if (u < P.CW / 16 * NT)
        tile_store(acc[q], u / NT * 16, u % NT * 8,
                   [&](int ch, int s, float v) {
                     if (s < S) buf[s * P.CW + ch] = from_f<E>(v);
                   });
    }
    __syncthreads();
    const int v = valid(row0, S);
    if constexpr (VEC) {
      constexpr int N = 16 / sizeof(E);
      const int per = cw / N;
      for (int e = threadIdx.x; e < v * per; e += kThreads) {
        const int s = e / per, at = (e - s * per) * N;
        *reinterpret_cast<uint4*>(dfeat + static_cast<long long>(row0 + s) *
                                              c + c0 + at) =
            *reinterpret_cast<const uint4*>(buf + s * P.CW + at);
      }
    } else {
      for (int e = threadIdx.x; e < v * cw; e += kThreads) {
        const int s = e / cw, at = e - s * cw;
        dfeat[static_cast<long long>(row0 + s) * c + c0 + at] =
            buf[s * P.CW + at];
      }
    }
    __syncthreads();
  }
};

template <typename E, bool VEC>
__global__ void __launch_bounds__(kThreads)
cluster_merge_bwd_staged(const E* __restrict__ w,
                         const E* __restrict__ feat,
                         const E* __restrict__ g,
                         const int* __restrict__ entry,
                         const int* __restrict__ offset, E* __restrict__ dw,
                         E* __restrict__ dfeat, int n, int n_, int c,
                         int nnc, int cs, const __grid_constant__ Plan P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kap = blockIdx.x, bi = blockIdx.y, k = gridDim.x, m = nnc * cs;
  const long long wimg = static_cast<long long>(bi) * n_ * m * kIC;
  const long long fimg = static_cast<long long>(bi) * n * c;
  const Owner<E, VEC> O{P, smem, w + wimg, feat + fimg,
                        g + static_cast<long long>(bi) * n_ * kIC * c,
                        dw + wimg, dfeat + fimg, n, c, nnc, cs, m,
                        static_cast<int>(threadIdx.x >> 5)};
  const int lo = offset[bi * (k + 1) + kap];
  const int L = offset[bi * (k + 1) + kap + 1] - lo;
  const int* list = entry + static_cast<long long>(bi) * n_ * nnc + lo;
  for (int s0 = 0; s0 < cs; s0 += P.S) {
    const int S = min(P.S, cs - s0), row0 = kap * cs + s0;
    // pass 1: dF per channel slice (and dW when one slice holds c)
    for (int sl = 0; sl < P.nsl; ++sl) {
      const int c0 = sl * P.CW, cw = min(P.CW, c - c0);
      if (P.nsl == 1) O.stage_f(row0, S, c0, cw);
      float acc[kTPW][4] = {};
      for (int l0 = 0; l0 < L; l0 += P.Lc) {
        const int lc = min(P.Lc, L - l0);
        O.stage_g(list + l0, lc, c0, cw);
        O.stage_w(list + l0, lc, s0, S);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        O.dfeat_tiles(acc, lc);
        if (P.nsl == 1) {
          float d[kTPW][4] = {};
          O.dw_tiles(d, lc);
          O.keep_dw(d, lc, S);
        }
        __syncthreads();
        if (P.nsl == 1) O.write_dw(list + l0, lc, s0, S);
      }
      cp_async_commit();  // F alone, when the list is empty
      cp_async_wait_all();
      O.write_dfeat(acc, row0, S, c0, cw);
    }
    // pass 2 when the channels take several slices: dW summed over the
    // slices, step by step of the list
    if (P.nsl > 1) {
      for (int l0 = 0; l0 < L; l0 += P.Lc) {
        const int lc = min(P.Lc, L - l0);
        float d[kTPW][4] = {};
        for (int sl = 0; sl < P.nsl; ++sl) {
          const int c0 = sl * P.CW, cw = min(P.CW, c - c0);
          O.stage_f(row0, S, c0, cw);
          O.stage_g(list + l0, lc, c0, cw);
          cp_async_commit();
          cp_async_wait_all();
          __syncthreads();
          O.dw_tiles(d, lc);
          __syncthreads();
        }
        O.keep_dw(d, lc, S);
        __syncthreads();
        O.write_dw(list + l0, lc, s0, S);
        __syncthreads();
      }
    }
  }
}

// Resident path (bf16): grid (shares, b); the block stages image b's 4 n'
// g rows of c channels (swizzled) and a zero row, then each warp owns
// every (THREADS / 32)-th cluster of the block's share. Compiled for NT
// 8-row tiles of a cluster and MTW 16-channel tiles (the dF accumulators,
// MTW * NT <= kTiles), with 1024 threads when those are few. The compiled
// (NT, MTW) pairs, named NT * 100 + MTW:
enum ResidentShape {
  kR1x2 = 102, kR1x4 = 104, kR1x8 = 108, kR1x16 = 116,
  kR2x2 = 202, kR2x4 = 204, kR2x8 = 208,
  kR4x2 = 402, kR4x4 = 404,
};

struct Resident {
  ResidentShape shape;
  int shares, bytes;
  Swizzle sw;
};

inline bool resident_plan(int b, int n, int n_, int c, int cs, int sms,
                          Resident* r) {
  if (!Swizzle::fits(c)) return false;  // c = 16, 32 or a multiple of 64
  const int nt = cs <= 8 ? 1 : (cs <= 16 ? 2 : 4);
  const int mtw = c <= 32 ? 2 : (c <= 64 ? 4 : (c <= 128 ? 8 : 16));
  if (cs > 8 * kResNT || c / 16 > mtw || mtw * nt > kTiles) return false;
  const long long bytes = (4LL * n_ + 1) * c * 2;
  if (bytes > kMaxShmem) return false;
  r->shape = static_cast<ResidentShape>(nt * 100 + mtw);
  r->bytes = static_cast<int>(bytes);
  r->sw = Swizzle::of(c);
  const int k = (n + cs - 1) / cs;
  const int shares = b >= sms ? 1 : sms / b;
  r->shares = shares > k ? k : shares;
  return true;
}

template <int NT, int MTW, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
cluster_merge_bwd_resident(const bf16* __restrict__ w,
                           const bf16* __restrict__ feat,
                           const bf16* __restrict__ g,
                           const int* __restrict__ entry,
                           const int* __restrict__ offset,
                           bf16* __restrict__ dw, bf16* __restrict__ dfeat,
                           int n, int n_, int c, int nnc, int cs,
                           const __grid_constant__ Resident R) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sG = reinterpret_cast<bf16*>(smem);
  const int bi = blockIdx.y, k = (n + cs - 1) / cs, m = nnc * cs;
  const int Q = c / 8, zero = 4 * n_;  // the zero row
  const bf16* gb = g + static_cast<long long>(bi) * n_ * kIC * c;
  for (int e = threadIdx.x; e < (zero + 1) * Q; e += THREADS) {
    const int r = e / Q, q = e - r * Q;
    bf16* d = sG + R.sw.at(r, q, c);
    if (r < zero)
      cp_async16(d, gb + static_cast<long long>(r) * c + q * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t2 = (lane & 3) * 2;
  const int stride = THREADS / 32;  // a warp per cluster
  const int* off = offset + bi * (k + 1);
  const int* ent = entry + static_cast<long long>(bi) * n_ * nnc;
  const bf16* wb = w + static_cast<long long>(bi) * n_ * m * kIC;
  const bf16* fb = feat + static_cast<long long>(bi) * n * c;
  bf16* dwb = dw + static_cast<long long>(bi) * n_ * m * kIC;
  bf16* dfb = dfeat + static_cast<long long>(bi) * n * c;
  const int MT = c / 16;  // channel tiles, at most MTW
  constexpr int KD = MTW * NT >= 16 ? 2 : 8;  // W prefetch depth (steps)
  const int k_lo = static_cast<int>(1LL * k * blockIdx.x / R.shares);
  const int k_hi = static_cast<int>(1LL * k * (blockIdx.x + 1) / R.shares);
  auto ld32 = [](const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  };
  auto shfl = [](int v, int src) { return __shfl_sync(0xffffffffu, v, src); };
  // this lane's entry of list chunk [l0, l0 + 32): (t, j), or (0, 0)
  auto entry_of = [&](int lo, int L, int l0, int* t, int* j) {
    const int e = l0 + lane < L ? ent[lo + l0 + lane] : 0;
    *t = e / nnc;
    *j = e - *t * nnc;
  };

  int kap = k_lo + warp;
  int lo = kap < k_hi ? off[kap] : 0, L = kap < k_hi ? off[kap + 1] - lo : 0;
  int tn = 0, jn = 0;  // the first list chunk of the warp's next cluster
  if (kap < k_hi) entry_of(lo, L, 0, &tn, &jn);
  cp_async_wait_all();
  __syncthreads();

  for (; kap < k_hi; kap += stride) {
    // the next cluster's bounds, on their way during this one
    const int kn = kap + stride;
    const int lo_n = kn < k_hi ? off[kn] : 0;
    const int L_n = kn < k_hi ? off[kn + 1] - lo_n : 0;
    const int row0 = kap * cs, valid = max(0, min(cs, n - row0));
    float acc[MTW * NT][4] = {};
    for (int l0 = 0; l0 < L; l0 += 32) {  // 32 list entries, one per lane
      const int lc = min(32, L - l0);
      int tm = tn, jm = jn;
      if (l0 > 0) entry_of(lo, L, l0, &tm, &jm);
      const int K = round_up(lc * kIC, 16);  // rows (l, i), zero-padded
      // dF^T (c x 8 NT) += G^T (c x K) W^T (K x 8 NT), KD steps of 16
      // rows at a time: their W pairs are loaded first, so that the
      // latencies overlap
      const int half = (lane >> 3) & 1;
      for (int kg = 0; kg < K; kg += 16 * KD) {
        uint32_t wf[KD][NT][2];
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int k0 = kg + kk * 16;
          if (k0 >= K) break;
          const int ea = (k0 + t2) >> 2, eb = ea + 2, i = t2 & 3;
          const int ta = shfl(tm, ea), ja = shfl(jm, ea);
          const int tb = shfl(tm, eb), jb = shfl(jm, eb);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int s = nt * 8 + gq;
            wf[kk][nt][0] = s < cs && ea < lc
                ? ld32(wb + (static_cast<long long>(ta) * m + ja * cs + s) *
                                kIC + i)
                : 0u;
            wf[kk][nt][1] = s < cs && eb < lc
                ? ld32(wb + (static_cast<long long>(tb) * m + jb * cs + s) *
                                kIC + i)
                : 0u;
          }
        }
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          const int k0 = kg + kk * 16;
          if (k0 < K) {
            // ldmatrix.trans rows: k0 + lane % 8 + 8 (lane / 16)
            const int ar = k0 + (lane & 7) + ((lane >> 4) << 3);
            const int ta_r = shfl(tm, ar >> 2);
            const int grow = (ar >> 2) < lc ? ta_r * kIC + (ar & 3) : zero;
#pragma unroll
            for (int mt = 0; mt < MTW; ++mt) {
              if (mt < MT) {
                uint32_t a[4];
                ldmatrix_x4_trans(a, sG + R.sw.at(grow, mt * 2 + half, c));
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
                  mma_bf16_16816(acc[mt * NT + nt], a, wf[kk][nt][0],
                                 wf[kk][nt][1]);
              }
            }
          }
        }
      }
      if (l0 + 32 >= L && kn < k_hi)  // the last chunk: fetch the next list
        entry_of(lo_n, L_n, 0, &tn, &jn);
      // dW^T (K x 8 NT) = G (K x c) F^T (c x 8 NT), 16 rows at a time
      for (int m0 = 0; m0 < K; m0 += 16) {
        const int ar = m0 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int ta_r = shfl(tm, ar >> 2);
        const int grow = (ar >> 2) < lc ? ta_r * kIC + (ar & 3) : zero;
        const int cq = lane >> 4;
        float d[NT][4] = {};
        for (int k0 = 0; k0 < c; k0 += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, sG + R.sw.at(grow, k0 / 8 + cq, c));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int s = nt * 8 + gq;
            const bf16* fr = fb + static_cast<long long>(row0 + s) * c + k0;
            const uint32_t f0 = s < valid ? ld32(fr + t2) : 0u;
            const uint32_t f1 = s < valid ? ld32(fr + t2 + 8) : 0u;
            mma_bf16_16816(d[nt], a, f0, f1);
          }
        }
        // rows m0 + gq (+ 8): entries m0 / 4 + gq / 4 (+ 2), i = gq % 4,
        // stored as pairs (i, i + 1) of slot member t2 + gq % 2
        const int e0 = (m0 >> 2) + (gq >> 2), e1 = e0 + 2;
        const int t0 = shfl(tm, e0), j0 = shfl(jm, e0);
        const int t1 = shfl(tm, e1), j1 = shfl(jm, e1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint32_t v0 = row_pair(d[nt][0], d[nt][1]);
          const uint32_t v1 = row_pair(d[nt][2], d[nt][3]);
          const int s = nt * 8 + t2 + (gq & 1), i = gq & 2;
          if (e0 < lc && s < cs)
            *reinterpret_cast<uint32_t*>(
                dwb + (static_cast<long long>(t0) * m + j0 * cs + s) * kIC +
                i) = v0;
          if (e1 < lc && s < cs)
            *reinterpret_cast<uint32_t*>(
                dwb + (static_cast<long long>(t1) * m + j1 * cs + s) * kIC +
                i) = v1;
        }
      }
    }
    if (L == 0 && kn < k_hi) entry_of(lo_n, L_n, 0, &tn, &jn);
    // the cluster's dfeat rows: acc[mt * NT + nt] holds channels
    // 16 mt + gq (+ 8) of rows 8 nt + t2 (+ 1), stored as channel pairs of
    // row 8 nt + t2 + gq % 2
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (mt < MT) {
          const float* a = acc[mt * NT + nt];
          const uint32_t v0 = row_pair(a[0], a[1]);
          const uint32_t v1 = row_pair(a[2], a[3]);
          const int s = nt * 8 + t2 + (gq & 1);
          uint32_t* o = reinterpret_cast<uint32_t*>(
              dfb + static_cast<long long>(row0 + s) * c + mt * 16 +
              (gq & ~1));
          if (s < valid) {
            o[0] = v0;
            o[4] = v1;
          }
        }
      }
    }
    lo = lo_n;
    L = L_n;
  }
}

template <int NT, int MTW>
cudaError_t launch_resident(const Resident& R, const void* w, const void* feat,
                            const void* g, const void* entry,
                            const void* offset, void* dw, void* dfeat, int b,
                            int n, int n_, int c, int nnc, int cs,
                            cudaStream_t stream) {
  constexpr int kT = MTW * NT <= 2 ? 1024 : 512;
  auto kernel = cluster_merge_bwd_resident<NT, MTW, kT>;
  const cudaError_t err = allow_shmem(kernel, R.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(R.shares, b), kT, R.bytes, stream>>>(
      static_cast<const bf16*>(w), static_cast<const bf16*>(feat),
      static_cast<const bf16*>(g), static_cast<const int*>(entry),
      static_cast<const int*>(offset), static_cast<bf16*>(dw),
      static_cast<bf16*>(dfeat), n, n_, c, nnc, cs, R);
  return cudaGetLastError();
}

cudaError_t launch_resident_shape(const Resident& R, const void* w,
                                  const void* feat, const void* g,
                                  const void* entry, const void* offset,
                                  void* dw, void* dfeat, int b, int n, int n_,
                                  int c, int nnc, int cs,
                                  cudaStream_t stream) {
#define CM_RESIDENT(NT, MTW)                                                 \
  case kR##NT##x##MTW:                                                       \
    return launch_resident<NT, MTW>(R, w, feat, g, entry, offset, dw, dfeat, \
                                    b, n, n_, c, nnc, cs, stream);
  switch (R.shape) {
    CM_RESIDENT(1, 2)
    CM_RESIDENT(1, 4)
    CM_RESIDENT(1, 8)
    CM_RESIDENT(1, 16)
    CM_RESIDENT(2, 2)
    CM_RESIDENT(2, 4)
    CM_RESIDENT(2, 8)
    CM_RESIDENT(4, 2)
    CM_RESIDENT(4, 4)
  }
#undef CM_RESIDENT
  return cudaErrorInvalidValue;
}

template <typename E>
cudaError_t launch(const void* w, const void* feat, const void* g,
                   const void* entry, const void* offset, void* dw,
                   void* dfeat, int b, int n, int n_, int c, int nnc, int cs,
                   cudaStream_t stream) {
  const int k = (n + cs - 1) / cs;
  if (b == 0 || k == 0 || c == 0) return cudaSuccess;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  Resident R;
  if (std::is_same<E, bf16>::value &&
      resident_plan(b, n, n_, c, cs, sms, &R)) {
    return launch_resident_shape(R, w, feat, g, entry, offset, dw, dfeat, b,
                                 n, n_, c, nnc, cs, stream);
  }
  const Plan P = make_plan(sizeof(E), c, cs);
  const bool vec = c * sizeof(E) % 16 == 0;
  auto kernel = vec ? cluster_merge_bwd_staged<E, true>
                    : cluster_merge_bwd_staged<E, false>;
  err = allow_shmem(kernel, P.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(k, b), kThreads, P.bytes, stream>>>(
      static_cast<const E*>(w), static_cast<const E*>(feat),
      static_cast<const E*>(g), static_cast<const int*>(entry),
      static_cast<const int*>(offset), static_cast<E*>(dw),
      static_cast<E*>(dfeat), n, n_, c, nnc, cs, P);
  return cudaGetLastError();
}

// The inverse index of ncc, one block per image: entry lists, per
// cluster, the flat pairs e = t * nnc + j with ncc[t, j] = kappa in
// ascending e (a stable counting sort), offset[kappa] where kappa's list
// starts. Each of the 32 warps takes one contiguous segment of the image's
// ids. Clusters go in ranges of kIdxRange (one range at every AFF merge);
// per range the warps count their segment's ids into a (cluster, warp)
// table in shared memory, the block scans the table in cluster-major
// order (so each warp gets its own cursor per cluster, after the cursors
// of the earlier warps), and each warp then walks its segment in order,
// 32 ids at a time, placing each id after the earlier ones of its cluster
// (__match_any_sync ranks the equal ids of a step). Every step is fixed,
// so the lists come out the same on every run.
constexpr int kIdxThreads = 1024;
constexpr int kIdxWarps = kIdxThreads / 32;
constexpr int kIdxRange = 512;             // clusters per range
constexpr int kIdxStride = kIdxRange + 1;  // a warp's column (odd: banks)
constexpr int kIdxBytes = (kIdxWarps * kIdxStride + 32) * 4;

__global__ void __launch_bounds__(kIdxThreads)
merge_index_kernel(const int* __restrict__ ncc, int* __restrict__ entry,
                   int* __restrict__ offset, int L, int k) {
  extern __shared__ int table[];  // [warp][cluster of the range], 32 sums
  int* part = table + kIdxWarps * kIdxStride;
  const int bi = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int* key = ncc + static_cast<long long>(bi) * L;
  int* ent = entry + static_cast<long long>(bi) * L;
  int* off = offset + static_cast<long long>(bi) * (k + 1);
  const int seg = (L + kIdxWarps - 1) / kIdxWarps;
  const int e_lo = min(warp * seg, L), e_hi = min(e_lo + seg, L);
  int* cursor = table + warp * kIdxStride;
  // (cluster, warp) in cluster-major order o = cluster * 32 + warp
  auto at = [](int o) { return (o & 31) * kIdxStride + (o >> 5); };
  const unsigned below = (1u << lane) - 1u;
  int base = 0;  // list entries of the earlier ranges
  for (int k0 = 0; k0 < k; k0 += kIdxRange) {
    const unsigned kr = static_cast<unsigned>(min(kIdxRange, k - k0));
    for (int i = tid; i < kIdxWarps * kIdxStride; i += kIdxThreads)
      table[i] = 0;
    __syncthreads();
    for (int e = e_lo + lane; e < e_hi; e += 32) {
      const unsigned u = static_cast<unsigned>(key[e] - k0);
      if (u < kr) atomicAdd(&cursor[u], 1);
    }
    __syncthreads();
    // exclusive scan of the table: thread tid takes entries [o0, o1)
    const int n_o = static_cast<int>(kr) * kIdxWarps;
    const int per = (n_o + kIdxThreads - 1) / kIdxThreads;
    const int o0 = min(tid * per, n_o), o1 = min(o0 + per, n_o);
    int own = 0;
    for (int o = o0; o < o1; ++o) own += table[at(o)];
    int x = own;  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) part[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int p = part[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, p, d);
        if (lane >= d) p += y;
      }
      part[lane] = p;
    }
    __syncthreads();
    int run = base + x - own + (warp > 0 ? part[warp - 1] : 0);
    for (int o = o0; o < o1; ++o) {
      const int count = table[at(o)];
      if ((o & 31) == 0) off[k0 + (o >> 5)] = run;  // the list's start
      table[at(o)] = run;
      run += count;
    }
    base += part[31];
    __syncthreads();
    for (int s = e_lo; s < e_hi; s += 32) {
      const int e = s + lane;
      const unsigned u =
          e < e_hi ? static_cast<unsigned>(key[e] - k0) : 0xffffffffu;
      const bool in = u < kr;
      const unsigned peers =
          __match_any_sync(0xffffffffu, in ? u : 0xffffffffu);
      const int pos = in ? cursor[u] + __popc(peers & below) : 0;
      __syncwarp();
      if (in && (peers >> lane) == 1u) cursor[u] = pos + 1;  // the last
      __syncwarp();
      if (in) ent[pos] = e;
    }
    __syncthreads();
  }
  if (tid == 0) off[k] = base;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (w, feat, g, dw and dfeat). entry
// (b, n' * nnc) and offset (b, k + 1) are the inverse index of ncc, int32
// (ops/cluster_merge.py::merge_inverse_index). Every pointer 16-byte
// aligned; ic must be 4. dw and dfeat are written in full (no zeroing
// needed). Returns a cudaError_t.
extern "C" int cluster_merge_bwd(const void* w, const void* feat,
                                 const void* g, const void* entry,
                                 const void* offset, void* dw, void* dfeat,
                                 int b, int n, int n_, int c, int nnc, int cs,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(w, feat, g, entry, offset, dw, dfeat, b, n, n_, c,
                         nnc, cs, st);
  if (dtype == 1)
    return launch<bf16>(w, feat, g, entry, offset, dw, dfeat, b, n, n_, c,
                        nnc, cs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The inverse index of ncc (b, n' * nnc) int32 for k clusters: entry
// (b, n' * nnc) and offset (b, k + 1) int32, as
// ops/cluster_merge.py::merge_inverse_index defines them. Returns a
// cudaError_t.
extern "C" int merge_inverse_index(const void* ncc, void* entry,
                                   void* offset, int b, int L, int k,
                                   void* stream) {
  if (b == 0) return cudaSuccess;
  const cudaError_t err = allow_shmem(merge_index_kernel, kIdxBytes);
  if (err != cudaSuccess) return err;
  merge_index_kernel<<<b, kIdxThreads, kIdxBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ncc), static_cast<int*>(entry),
      static_cast<int*>(offset), L, k);
  return cudaGetLastError();
}
