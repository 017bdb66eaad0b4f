// Query-tile machinery shared by the fused cluster-attention forward
// (cluster_attention.cu) and backward (cluster_attention_bwd.cu), for
// Hopper (sm_90a).
//
// A block (512 threads, one per SM) owns a tile of kTile = 64 consecutive
// cluster-ordered query rows of one image, a group of G heads and, when a
// head is wider than kMaxCP = 64 channels, one slice of kMaxCP output
// channels. Its queries' neighbour clusters form the tile's union: the
// sorted cluster ids and, per row, the sorted union indices of the row's
// nnc clusters, made once per stage by
// ops/cluster_attention.py::tile_metadata. The block walks the union's
// tokens in chunks of Uc positions, as many as its shared memory holds
// (the whole union of every AFF-Mini stage-1 tile in the bf16 forward).
// Per chunk it stages, with 16-byte cp.async copies, the k and v rows of
// the chunk's tokens for its heads and their positions, and maps each
// (row, chunk position) to where the row keeps that slot's logit. Then
//   S = Q K^T over the tile x chunk (bf16: mma.sync m16n8k16 with f32
//       accumulators; f32: CUDA cores, same shared-memory tiles), summed
//       over channel chunks of at most kMaxCP, 16 x 16 blocks that hold no
//       slot skipped; the epilogue keeps only the entries of each row's
//       slots - the slot mask;
//   a row pass, kRow = 8 threads per row, adds the rel-pos bias (geometry
//       once per (query, slot), shared by the G heads) and runs an online
//       softmax (running max and sum per (query, head)) whose first term
//       is the blank token, writing P at the slots' positions;
//   O = alpha O + P V for the block's channel slice, again on the tensor
//       cores (bf16) or CUDA cores.
// Every k/v row thus comes from L2/HBM once per tile, not once per
// (query, head). What bounds a block is latency: its phases are separated
// by barriers, and the row pass is a chain of dependent shared-memory
// reads and IEEE sqrt/division per slot.
//
// Any shape runs: the staged tiles are at most kMaxCP channels wide and a
// chunk at least 16 positions (a cluster may straddle two chunks). A row
// keeps its logits per slot (m of them) when they fit beside a chunk of
// one cluster ("keep"), else per chunk position, and the backward then
// computes a chunk's logits again in its second pass. A cluster that a
// query lists twice counts twice, as in the plain version: the row pass
// visits it once with weight 2. The common case - one channel chunk,
// logits kept per slot, the rows' union indices in shared memory - is
// compiled apart (WIDE false), and only a tile whose rows repeat a
// cluster walks its slots with the checks repeats need, so that the
// AFF shapes pay nothing for the generality.
//
// Two modes of the JAX kernels ride on the same block. Saved statistics:
// the forward writes each row's softmax max and denominator, and the
// backward reads them (cluster_attention_bwd.cu). Attention dropout: the
// probabilities of the slots and of the blank are multiplied by a
// keep/scale that drop_keep computes in registers from the global (image,
// head, query row, kv token); the denominator is not dropped. Dropout is
// a template parameter of the block (DROP): a launch without it compiles
// to a block without the hash, whose registers a row pass cannot spare.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace ca {

constexpr int kTile = 64;      // query rows per tile; TILE in Python
constexpr int kThreads = 512;  // 16 warps per block, one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 4;       // heads per block at most
constexpr int kMaxCP = 64;     // channels of a staged tile at most
constexpr int kMaxUc = 4096;   // positions per chunk at most (short maps)
constexpr int kSmemNnc = 128;  // rows' union indices in shared memory
constexpr int kRow = kThreads / kTile;  // threads per tile row
static_assert(kRow * kTile == kThreads && (kRow & (kRow - 1)) == 0,
              "a power-of-two group of threads per tile row");

using bf16 = __nv_bfloat16;

template <typename E>
__device__ __forceinline__ float to_f(E x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum and max over a row's group of kRow neighbouring lanes
template <typename T>
__device__ __forceinline__ T row_sum(T v) {
#pragma unroll
  for (int o = 1; o < kRow; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < kRow; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int row_min_i(int v) {
#pragma unroll
  for (int o = 1; o < kRow; o <<= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int row_max_i(int v) {
#pragma unroll
  for (int o = 1; o < kRow; o <<= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

constexpr int kBlankCol = 65535;  // the blank slot's kv column in the hash

// The keep/scale of attention-probability dropout at (image, head, query
// row, kv column): the JAX package's _drop_keep (clusten_pallas.py:708), a
// lowbias32-style hash whose int32 arithmetic wraps, here as uint32 (the
// constants are its negative int32 multipliers mod 2^32). 0 below the
// threshold int(rate * (2^31 - 1)), else scale = float32(1 / (1 - rate)).
__device__ __forceinline__ float drop_keep(int seed, int img, int head,
                                           int row, int col, int thresh,
                                           float scale) {
  uint32_t x = static_cast<uint32_t>(row) * 65536u +
               static_cast<uint32_t>(col) + static_cast<uint32_t>(seed) +
               2654435761u * static_cast<uint32_t>(img) +
               2246822519u * static_cast<uint32_t>(head);
  x ^= x >> 16;
  x *= 2146121005u;
  x ^= x >> 15;
  x *= 2221747851u;
  x ^= x >> 16;
  return static_cast<int>(x & 0x7fffffffu) >= thresh ? scale : 0.f;
}

// ------------------------------------------------------------ layout ----

// Byte offsets of the block's shared-memory arrays. The host sizes the
// launch with the same function the kernel carves with.
struct Layout {
  int lds, ldp, ldo, lm, ldd;  // row strides: E tiles, P/dL, O, L/dP, dst
  int q, g, k, v, lg, dp, p, dl, o, st, qpos, upos, stok, dst, occ, nidx,
      rng, acc, wts, bk;
  int bytes;
};

__host__ __device__ inline int take(int* off, long long bytes) {
  const int at = *off;
  *off += static_cast<int>((bytes + 15) & ~15LL);
  return at;
}

// esize: bytes of an element of q/kv; G heads; CP: staged channels, a
// multiple of 16; Uc chunk positions, a multiple of 16; nnc clusters of
// cs tokens per query; keep: logits per slot, else per chunk position.
__host__ __device__ inline Layout make_layout(int esize, int G, int CP,
                                              int Uc, int nnc, int cs,
                                              bool keep, bool bwd) {
  Layout L;
  int off = 0;
  L.lds = CP + 16 / esize;  // 16-byte row padding: cp.async alignment, banks
  L.ldp = Uc + 8;
  L.ldo = CP + 4;
  L.lm = (keep ? nnc * cs : Uc) + 1;
  L.ldd = Uc + 8;  // 16-byte rows; conflict-free pair loads
  const long long T = kTile, tile = G * T * L.lds * esize;
  const long long chunk = 1LL * G * Uc * L.lds * esize;
  const long long slots = G * T * L.lm * 4, pd = G * T * L.ldp * esize;
  L.q = take(&off, tile);
  L.g = bwd ? take(&off, tile) : 0;
  L.k = take(&off, chunk);
  L.v = take(&off, chunk);
  L.lg = take(&off, slots);
  L.dp = bwd ? take(&off, slots) : 0;
  L.p = take(&off, pd);
  L.dl = bwd ? take(&off, pd) : 0;
  L.o = take(&off, G * T * L.ldo * 4);
  L.st = take(&off, 6 * G * T * 4);
  L.qpos = take(&off, T * 2 * 4);
  L.stok = take(&off, 1LL * Uc * 4);
  L.upos = take(&off, 1LL * Uc * 2 * 4);
  L.dst = take(&off, T * L.ldd * 2);
  L.occ = take(&off, T / 16 * (Uc / 16));
  L.nidx = take(&off, nnc <= kSmemNnc ? T * nnc * 4 : 0);
  L.rng = take(&off, 2 * T * 4);
  // the backward's rel-pos gradient sums: one slot per warp
  L.acc = take(&off, (bwd ? kWarps : 1) * 6 * G * 4);
  L.wts = take(&off, 6 * G * 4);
  L.bk = take(&off, 2 * kMaxCP * 4);  // blank k, v of one channel chunk
  L.bytes = off;
  return L;
}

constexpr int kMaxShmem = 232448;  // a block's limit on the H100

struct Plan {
  int G, CP, Uc, keep, bytes;
};

// The launch shape: heads per block G (a divisor of h, G * c_ <= 64 where
// possible), the staged width CP, whether rows keep their logits per slot,
// and the chunk of Uc positions, the largest that fits the SM's shared
// memory (one block per SM) and no larger than a tile's union can be.
// Keeping, with a chunk of at least one cluster, is preferred. The last
// try (G = 1, per-position logits, Uc = 16) fits every shape.
inline bool plan(int esize, int h, int c_, int nnc, int cs, int n, bool bwd,
                 Plan* out) {
  const int CP = c_ <= kMaxCP ? round16(c_) : kMaxCP;
  const long long clusters = (n + cs - 1) / cs;
  long long un = 1LL * kTile * nnc;
  if (clusters < un) un = clusters;
  long long need = (un * cs + 15) / 16 * 16;
  if (need > kMaxUc) need = kMaxUc;
  if (need < 16) need = 16;
  for (int keep = 1; keep >= 0; --keep) {
    for (int G = h < kMaxG ? h : kMaxG; G >= 1; --G) {
      if (h % G != 0 || (G > 1 && G * c_ > 64)) continue;
      int lo = keep ? round16(cs) : 16;
      if (lo > need) lo = static_cast<int>(need);
      auto fits = [&](int Uc) {
        return make_layout(esize, G, CP, Uc, nnc, cs, keep, bwd).bytes <=
               kMaxShmem;
      };
      if (!fits(lo)) continue;
      int a = lo / 16, b = static_cast<int>(need / 16);  // in 16s
      while (a < b) {
        const int mid = (a + b + 1) / 2;
        if (fits(16 * mid))
          a = mid;
        else
          b = mid - 1;
      }
      const Layout L = make_layout(esize, G, CP, 16 * a, nnc, cs, keep, bwd);
      *out = {G, CP, 16 * a, keep, L.bytes};
      return true;
    }
  }
  return false;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ------------------------------------------------------- tile products ----

// Element (r, c) of batch g of a shared-memory tile: p[g*bs + r*ld + c],
// or p[g*bs + c*ld + r] when TR (a transposed view).
template <typename E, bool TR>
struct View {
  const E* p;
  int ld, bs;
  __device__ __forceinline__ const E* ptr(int g, int r, int c) const {
    return p + g * bs + (TR ? c * ld + r : r * ld + c);
  }
  __device__ __forceinline__ float at(int g, int r, int c) const {
    return to_f(*ptr(g, r, c));
  }
  // two neighbours as bf16x2, the first in the low half: (r, c), (r, c+1)
  // when ALONG_C, else (r, c), (r+1, c)
  template <bool ALONG_C>
  __device__ __forceinline__ uint32_t pair(int g, int r, int c) const {
    constexpr bool contiguous = ALONG_C != TR;
    const E* a = ptr(g, r, c);
    if constexpr (contiguous && std::is_same<E, bf16>::value) {
      return *reinterpret_cast<const uint32_t*>(a);
    } else if constexpr (contiguous) {
      const float2 v = *reinterpret_cast<const float2*>(a);
      return pack_bf16(v.x, v.y);
    } else if constexpr (std::is_same<E, bf16>::value) {
      const E* b = ALONG_C ? ptr(g, r, c + 1) : ptr(g, r + 1, c);
      return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(a)) |
             (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(b))
              << 16);
    } else {
      const E* b = ALONG_C ? ptr(g, r, c + 1) : ptr(g, r + 1, c);
      return pack_bf16(*a, *b);
    }
  }
};

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// For every batch g < nb: C = A B with A (M x K) and B (K x N), M, N, K
// multiples of 16; each pair C(r, c), C(r, c+1) (c even) goes to
// epi(g, r, c, v0, v1). TC: tensor cores, bf16 operands (f32 tiles are
// rounded to bf16), f32 accumulators, one warp per 16 x 16 block of C,
// and the 16-deep step ki of block (mi, ni) runs only when keep(mi, ni,
// ki) (a block of A or B that is all zero adds nothing); a block with no
// step left skips its epilogue too when `skip_empty`. Otherwise CUDA
// cores in f32, one thread per pair, every step.
template <bool TC, class VA, class VB, class Epi, class Keep>
__device__ __forceinline__ void tile_mm(const VA& A, const VB& B, int nb,
                                        int M, int N, int K, Epi epi,
                                        Keep keep, bool skip_empty) {
  if constexpr (TC) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, t2 = (lane & 3) * 2;
    const int mt = M >> 4, nt = N >> 4, units = nb * mt * nt;
    // each warp takes a contiguous run of 16 x 16 units, n fastest
    const int per = (units + kWarps - 1) / kWarps;
    int u = warp * per;
    const int u1 = min(units, u + per);
    if (u >= u1) return;
    int n0 = (u % nt) * 16, m0 = (u / nt % mt) * 16, g = u / (nt * mt);
    uint32_t a[2][4];  // A fragments of the first two k-steps
    int ag = -1, am = -1;
    for (; u < u1; ++u) {
      if (K <= 32 && (g != ag || m0 != am)) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (16 * s < K) {
            const int k0 = 16 * s;
            a[s][0] = A.template pair<true>(g, m0 + gq, k0 + t2);
            a[s][1] = A.template pair<true>(g, m0 + gq + 8, k0 + t2);
            a[s][2] = A.template pair<true>(g, m0 + gq, k0 + t2 + 8);
            a[s][3] = A.template pair<true>(g, m0 + gq + 8, k0 + t2 + 8);
          }
        }
        ag = g;
        am = m0;
      }
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      bool any = false;
      auto step = [&](const uint32_t* fa, int k0) {
        any = true;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + 8 * j + gq;
          mma_bf16_16816(acc[j], fa, B.template pair<false>(g, k0 + t2, n),
                         B.template pair<false>(g, k0 + t2 + 8, n));
        }
      };
      const int mi = m0 >> 4, ni = n0 >> 4;
      if (K <= 32) {
        if (keep(mi, ni, 0)) step(a[0], 0);
        if (K > 16 && keep(mi, ni, 1)) step(a[1], 16);
      } else {
        for (int k0 = 0; k0 < K; k0 += 16) {
          if (!keep(mi, ni, k0 >> 4)) continue;
          uint32_t f[4];
          f[0] = A.template pair<true>(g, m0 + gq, k0 + t2);
          f[1] = A.template pair<true>(g, m0 + gq + 8, k0 + t2);
          f[2] = A.template pair<true>(g, m0 + gq, k0 + t2 + 8);
          f[3] = A.template pair<true>(g, m0 + gq + 8, k0 + t2 + 8);
          step(f, k0);
        }
      }
      if (any || !skip_empty) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          epi(g, m0 + gq, n0 + 8 * j + t2, acc[j][0], acc[j][1]);
          epi(g, m0 + gq + 8, n0 + 8 * j + t2, acc[j][2], acc[j][3]);
        }
      }
      n0 += 16;  // the next unit
      if (n0 == N) {
        n0 = 0;
        m0 += 16;
        if (m0 == M) {
          m0 = 0;
          ++g;
        }
      }
    }
  } else {
    const int half = N >> 1;
    for (int e = threadIdx.x; e < nb * M * half; e += kThreads) {
      const int g = e / (M * half);
      const int rem = e - g * M * half;
      const int r = rem / half, c = (rem % half) * 2;
      float s0 = 0.f, s1 = 0.f;
      for (int k = 0; k < K; ++k) {
        const float a = A.at(g, r, k);
        s0 += a * B.at(g, k, c);
        s1 += a * B.at(g, k, c + 1);
      }
      epi(g, r, c, s0, s1);
    }
  }
}

// ----------------------------------------------------------- staging ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Fills nseg segments of CP elements of each of `rows` rows: dst(seg,
// row)[0, cw) = src(row)[seg * sstride + [0, cw)], the rest zeros; a row
// whose src is null gets zeros. VEC: cw is a multiple of 16 bytes and
// every source segment is 16-byte aligned, so the copy is cp.async in
// 16-byte pieces.
template <typename E, bool VEC, class Src, class Dst>
__device__ __forceinline__ void stage_rows(int rows, int nseg, int cw,
                                           int CP, int sstride, Src src,
                                           Dst dst) {
  if constexpr (VEC) {
    constexpr int N = 16 / sizeof(E);
    const int per_seg = CP / N;
    const int per_row = nseg * per_seg;
    for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
      const int row = e / per_row;
      const int rem = e - row * per_row;
      const int seg = rem / per_seg;
      const int at = (rem - seg * per_seg) * N;
      const E* s = src(row);
      E* d = dst(seg, row) + at;
      if (s != nullptr && at < cw) {
        cp_async16(d, s + seg * sstride + at);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const int per_row = nseg * CP;
    for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
      const int row = e / per_row;
      const int rem = e - row * per_row;
      const int seg = rem / CP;
      const int ch = rem - seg * CP;
      const E* s = src(row);
      dst(seg, row)[ch] = s != nullptr && ch < cw ? s[seg * sstride + ch]
                                                  : from_f<E>(0.f);
    }
  }
}

// The 5 rel-pos features (dx, dy, dist, sin, cos) of the offset (dx, dy),
// after the MixRes clamp of the table-frame coordinates when clamp_hi >= 0;
// IEEE sqrtf and division, as the plain version computes them.
__device__ __forceinline__ void rel_feat(float dx, float dy, float R,
                                         int clamp_hi, float* f) {
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

// ------------------------------------------------------------- block ----

struct Params {
  const void* q;
  const void* kv;
  const float* pos;
  const int* ucl;     // (B, ntiles, kTile * nnc) sorted union cluster ids
  const int* ucount;  // (B, ntiles) union sizes
  const int* nidx;    // (B, ntiles * kTile, nnc) sorted union indices
  const float* pe_kernel;  // (5, h)
  const float* pe_bias;    // (h,)
  const float* blank_k;    // (c_, h)
  const float* blank_v;    // (h, c_)
  void* out;               // forward: (b, nq, c) in q's dtype
  float* stats;  // (b, nq, 2h) f32 softmax max (lane hi) and denominator
                 // (lane h + hi): written by the forward when not null,
                 // read by the backward in the saved mode
  const void* g_out;       // backward: (b, nq, c)
  const void* outp;        // backward, saved mode: the forward's output
  void* dq;                // backward: (b, nq, c) in q's dtype
  float* dkv_part;  // backward: (b, ntiles, ucap, 2c) f32 tile partials
  float* dparams;   // backward: (b * ntiles, 6h + 2c) f32 block partials
  int b, n, h, c_, nnc, cs;
  // the query range: q, g_out, out, dq and stats hold nq rows, the rows
  // [qoff, qoff + nq) of the n tokens that kv and pos hold (0 and n: all)
  int nq, qoff;
  int G, CP, Uc, keep, nch, ntiles;  // nch: channel chunks of CP per head
  int clamp_hi;
  float R;
  long long pos_bstride;  // elements; 0 when pos is batch-broadcast
  int meta_batched;       // 0 when the metadata is batch-broadcast
  int ucap;               // backward: union positions per tile in dkv_part
  int drop, drop_seed, drop_thresh;  // attention dropout (drop_keep)
  float drop_scale;
};

// The launch grid: (image, tile) x (head group, channel slice).
inline dim3 grid_of(const Params& p) {
  return dim3(static_cast<unsigned>(p.ntiles) * p.b, p.h / p.G * p.nch);
}

// Fills the plan's fields of p; false when no plan fits.
inline bool apply_plan(Params& p, int esize, bool bwd, int* bytes) {
  Plan pl;
  if (!plan(esize, p.h, p.c_, p.nnc, p.cs, p.n, bwd, &pl)) return false;
  p.G = pl.G;
  p.CP = pl.CP;
  p.Uc = pl.Uc;
  p.keep = pl.keep;
  p.nch = (p.c_ + pl.CP - 1) / pl.CP;
  *bytes = pl.bytes;
  return true;
}

// Whether a launch needs the general block (WIDE): more than one channel
// chunk, logits per chunk position, or union indices in global memory. A
// narrow block knows at compile time that it has none of them.
inline bool wide_plan(const Params& p) {
  return !(p.nch == 1 && p.keep && p.nnc <= kSmemNnc);
}

// The per-block state of one (image, tile, head group, channel slice).
// Per (head, row) statistics: m_ the running max, l_ the running sum
// (1 / sum in the backward's second pass), a_ the forward's rescale
// factor or the backward's sum of p dp (then S = g . out), bl_ the blank
// logit, and dlb_ and pb_ of the backward's blank token (pb_ holds
// g . blank_v until then).
template <typename E, bool VEC, bool BWD, bool WIDE, bool DROP>
struct Block {
  using Elem = E;
  static constexpr bool TC = std::is_same<E, bf16>::value;
  static constexpr bool Drop = DROP;
  const Params& P;
  Layout L;
  E *sq, *sg, *sk, *sv, *sp, *sdl;
  float *slg, *sdp, *so;  // logits and dP per (head, row, slot); O
  float *m_, *l_, *a_, *bl_, *dlb_, *pb_;
  float *qpos, *upos;
  float* acc;  // backward: (warp, G, 6) rel-pos gradient sums
  float* wts;  // pe_kernel and pe_bias of the G heads: (G, 6)
  float *sbk, *sbv;  // blank_k, blank_v of the G heads when nch = 1
  int *stok, *ra, *rb;  // ra, rb: each row's slots [ra, rb) in the chunk
  int* snid;  // rows' union indices, in shared memory when nnc <= kSmemNnc
  short* dst;  // (row, chunk position) -> where the row keeps it, or -1
  unsigned char* occ;  // 16 x 16 (row, position) blocks with a slot
  int bi, t, hg, sl, chs, cws, q0, rows, UT, p0, Ue, G, c_, c;
  bool reps;  // a row of the tile lists a cluster more than once
  const E* qb;   // this image's q rows, at the head group's first channel
  const E* gb;   // the same of g (backward)
  const E* kvb;  // this image's kv rows, at the head group's first channel
  const float* posb;
  const int* ucl_g;
  const int* nidx_g;

  __device__ Block(const Params& p, unsigned char* smem) : P(p) {
    G = P.G;
    c_ = P.c_;
    c = P.h * c_;
    L = make_layout(sizeof(E), G, P.CP, P.Uc, P.nnc, P.cs, keep(), BWD);
    sq = reinterpret_cast<E*>(smem + L.q);
    sg = reinterpret_cast<E*>(smem + L.g);
    sk = reinterpret_cast<E*>(smem + L.k);
    sv = reinterpret_cast<E*>(smem + L.v);
    sp = reinterpret_cast<E*>(smem + L.p);
    sdl = reinterpret_cast<E*>(smem + L.dl);
    slg = reinterpret_cast<float*>(smem + L.lg);
    sdp = reinterpret_cast<float*>(smem + L.dp);
    so = reinterpret_cast<float*>(smem + L.o);
    float* st = reinterpret_cast<float*>(smem + L.st);
    const int gt = G * kTile;
    m_ = st;
    l_ = st + gt;
    a_ = st + 2 * gt;
    bl_ = st + 3 * gt;
    dlb_ = st + 4 * gt;
    pb_ = st + 5 * gt;
    qpos = reinterpret_cast<float*>(smem + L.qpos);
    stok = reinterpret_cast<int*>(smem + L.stok);
    upos = reinterpret_cast<float*>(smem + L.upos);
    dst = reinterpret_cast<short*>(smem + L.dst);
    occ = smem + L.occ;
    ra = reinterpret_cast<int*>(smem + L.rng);
    rb = ra + kTile;
    acc = reinterpret_cast<float*>(smem + L.acc);
    wts = reinterpret_cast<float*>(smem + L.wts);
    sbk = reinterpret_cast<float*>(smem + L.bk);
    sbv = sbk + kMaxCP;

    t = blockIdx.x % P.ntiles;
    bi = blockIdx.x / P.ntiles;
    hg = blockIdx.y / nch();
    sl = blockIdx.y % nch();
    chs = sl * P.CP;
    cws = min(P.CP, c_ - chs);
    q0 = t * kTile;
    rows = min(kTile, P.nq - q0);
    p0 = 0;
    Ue = 0;
    qb = static_cast<const E*>(P.q) + static_cast<long long>(bi) * P.nq * c +
         hg * G * c_;
    gb = BWD ? static_cast<const E*>(P.g_out) +
                   static_cast<long long>(bi) * P.nq * c + hg * G * c_
             : nullptr;
    kvb = static_cast<const E*>(P.kv) +
          static_cast<long long>(bi) * P.n * 2 * c + hg * G * 2 * c_;
    posb = P.pos + bi * P.pos_bstride;
    const long long mt =
        static_cast<long long>(bi * P.meta_batched) * P.ntiles + t;
    UT = P.ucount[mt] * P.cs;
    ucl_g = P.ucl + mt * kTile * P.nnc;
    nidx_g = P.nidx + mt * kTile * P.nnc;
    snid = reinterpret_cast<int*>(smem + L.nidx);
  }

  __device__ int head(int g) const { return hg * G + g; }
  // the dropout keep/scale of (head g, row i) at kv token tok (kBlankCol:
  // the blank); 1 without dropout
  __device__ float keep_at(int g, int i, int tok) const {
    if constexpr (DROP)
      return drop_keep(P.drop_seed, bi, head(g), P.qoff + q0 + i, tok,
                       P.drop_thresh, P.drop_scale);
    return 1.f;
  }
  __device__ bool keep() const { return !WIDE || P.keep; }
  __device__ int nch() const { return WIDE ? P.nch : 1; }
  // entry e of the tile's rows' union indices: shared memory when they fit
  // (loads stay shared-space), else global
  __device__ int nid(int e) const {
    return !WIDE || P.nnc <= kSmemNnc ? snid[e] : __ldg(nidx_g + e);
  }
  __device__ int st_at(int g, int i) const { return g * kTile + i; }
  __device__ float* lrow(int g, int i) const {
    return slg + (g * kTile + i) * L.lm;
  }
  __device__ float* dprow(int g, int i) const {
    return sdp + (g * kTile + i) * L.lm;
  }
  __device__ E* prow(int g, int i) const {
    return sp + (g * kTile + i) * L.ldp;
  }
  __device__ E* dlrow(int g, int i) const {
    return sdl + (g * kTile + i) * L.ldp;
  }
  __device__ float* orow(int g, int i) const {
    return so + (g * kTile + i) * L.ldo;
  }

  // keep() predicates of tile_mm from the chunk's occupancy of 16 x 16
  // (row, position) blocks: C's block (rows mi, positions ni); A's block
  // (rows mi, positions ki); the transposed product's (positions mi, rows
  // ki).
  struct Occ {
    const unsigned char* occ;
    int npt, mode;  // 0: (mi, ni)  1: (mi, ki)  2: (ki, mi)
    __device__ bool operator()(int mi, int ni, int ki) const {
      const int r = mode == 2 ? ki : mi;
      const int p = mode == 0 ? ni : mode == 1 ? ki : mi;
      return occ[r * npt + p] != 0;
    }
  };
  __device__ Occ occupied_rp() const { return {occ, P.Uc / 16, 0}; }
  __device__ Occ occupied_rk() const { return {occ, P.Uc / 16, 1}; }
  __device__ Occ occupied_pr() const { return {occ, P.Uc / 16, 2}; }

  // Thread q of row i's group zeroes its share of the row of a P-like
  // buffer, all heads.
  __device__ void zero_row(E* buf, int i, int q) const {
    const int per = Ue * static_cast<int>(sizeof(E)) / 16;
    for (int g = 0; g < G; ++g) {
      uint4* row = reinterpret_cast<uint4*>(buf + (g * kTile + i) * L.ldp);
      for (int e = q; e < per; e += kRow) row[e] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Stages channels [ch0, ch0 + CP) of the head group's tile rows of a
  // (b, n, c) tensor (cp.async: cp_async_wait_all before use).
  __device__ void stage_tile(const E* base, E* tile, int ch0) const {
    const int ld = L.lds, bs = kTile * L.lds;
    const int live = rows, q0_ = q0, c__ = c;
    stage_rows<E, VEC>(
        kTile, G, min(P.CP, c_ - ch0), P.CP, c_,
        [=](int i) -> const E* {
          return i < live ? base + static_cast<long long>(q0_ + i) * c__ + ch0
                          : nullptr;
        },
        [=](int seg, int i) { return tile + seg * bs + i * ld; });
  }

  // Stages channels [ch0, ch0 + CP) of the k rows (with_k) and v rows
  // (with_v) of the chunk's tokens (cp.async).
  __device__ void stage_kv(int ch0, bool with_k, bool with_v) const {
    const int* stok_ = stok;
    const int c2 = 2 * c, ld = L.lds, bs = P.Uc * L.lds;
    E* sk_ = sk;
    E* sv_ = sv;
    const bool both = with_k && with_v;
    // segments per row: k of each head, v of each head, or both (k and v
    // of head g are segments 2g and 2g + 1, c_ apart)
    const int first = with_k ? 0 : 1;
    const int step = both ? 1 : 2;
    const E* kvb_ = kvb + first * c_ + ch0;
    stage_rows<E, VEC>(
        Ue, both ? 2 * G : G, min(P.CP, c_ - ch0), P.CP, step * c_,
        [=](int p) -> const E* {
          const int tok = stok_[p];
          return tok >= 0 ? kvb_ + static_cast<long long>(tok) * c2
                          : nullptr;
        },
        [=](int seg, int p) {
          const int s = both ? seg : 2 * seg + first;
          return ((s & 1) ? sv_ : sk_) + (s >> 1) * bs + p * ld;
        });
  }

  // The block's start: the q (and g) tile when a head is one channel
  // chunk, the rows' union indices, the query positions, and the blank
  // logit as the first term of each softmax (m = blank logit, l = 1, O =
  // blank_v); the backward's g . blank_v.
  __device__ void begin() {
    if (nch() == 1) {
      stage_tile(qb, sq, 0);
      if constexpr (BWD) stage_tile(gb, sg, 0);
    }
    for (int e = threadIdx.x; e < 6 * G; e += kThreads) {
      const int g = e / 6, f = e - g * 6;
      wts[e] = f < 5 ? P.pe_kernel[f * P.h + head(g)] : P.pe_bias[head(g)];
    }
    for (int e = threadIdx.x; e < (BWD ? kWarps : 1) * 6 * G; e += kThreads)
      acc[e] = 0.f;
    if (P.nnc <= kSmemNnc) {
      const int tn = kTile * P.nnc;  // ints, a multiple of 64
      for (int e = threadIdx.x; e < tn / 4; e += kThreads)
        cp_async16(snid + 4 * e, nidx_g + 4 * e);
    }
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool live = i < rows;
      const long long r = P.qoff + q0 + i;  // the query's token row
      qpos[2 * i] = live ? posb[2 * r] : 0.f;
      qpos[2 * i + 1] = live ? posb[2 * r + 1] : 0.f;
    }
    const bool one = nch() == 1;  // then G c_ <= kMaxCP
    if (one) {
      for (int e = threadIdx.x; e < G * c_; e += kThreads) {
        const int g = e / c_, ch = e - g * c_;
        sbk[e] = P.blank_k[ch * P.h + head(g)];
        sbv[e] = P.blank_v[head(g) * c_ + ch];
      }
    }
    cp_async_wait_all();
    __syncthreads();
    int twice = 0;
    for (int e = threadIdx.x; e < rows * P.nnc; e += kThreads)
      twice |= e % P.nnc != 0 && nid(e) == nid(e - 1);
    reps = __syncthreads_or(twice) != 0;
    // the blank logit q . blank_k (and the backward's g . blank_v) per
    // (head, row), from the staged tiles or, for a wide head, from global
    // memory
    const int i = threadIdx.x / kRow, q = threadIdx.x % kRow;
    for (int g = 0; g < G; ++g) {
      float bq = 0.f, bg = 0.f;
      if (one) {
        const E* qr = sq + st_at(g, i) * L.lds;
        const E* gr = sg + st_at(g, i) * L.lds;
        for (int ch = q; ch < c_; ch += kRow) {
          bq += to_f(qr[ch]) * sbk[g * c_ + ch];
          if constexpr (BWD) bg += to_f(gr[ch]) * sbv[g * c_ + ch];
        }
      } else if (i < rows) {
        const long long at = static_cast<long long>(q0 + i) * c + g * c_;
        for (int ch = q; ch < c_; ch += kRow) {
          bq += to_f(qb[at + ch]) * P.blank_k[ch * P.h + head(g)];
          if constexpr (BWD)
            bg += to_f(gb[at + ch]) * P.blank_v[head(g) * c_ + ch];
        }
      }
      bq = row_sum(bq);
      if constexpr (BWD) bg = row_sum(bg);
      if (q == 0) {
        const int at = st_at(g, i);
        m_[at] = bq;
        bl_[at] = bq;
        l_[at] = 1.f;
        a_[at] = 0.f;
        pb_[at] = bg;
      }
    }
    for (int e = threadIdx.x; e < G * kTile * P.CP; e += kThreads) {
      const int row = e / P.CP, ch = e - row * P.CP, g = row / kTile;
      float v = 0.f;
      if (!BWD && ch < cws) {
        v = one ? sbv[g * c_ + ch] : P.blank_v[head(g) * c_ + chs + ch];
        if constexpr (DROP) v *= keep_at(g, row - g * kTile, kBlankCol);
      }
      so[row * L.ldo + ch] = v;
    }
    __syncthreads();
  }

  // Maps union positions [p0_, p0_ + Ue), Ue = Uc or what is left of
  // the union (rounded up to 16): the chunk's token ids (stok, -1 = none)
  // and positions, each row's slots in the chunk, the occupancy of 16 x 16
  // (row, position) blocks and, with fill_dst, where each row keeps the
  // logit of each chunk position it attends (dst, -1 = none). Ends
  // synchronised; stage_kv stages the k/v rows.
  __device__ void stage_meta(int p0_, bool fill_dst) {
    p0 = p0_;
    Ue = min(P.Uc, round16(UT - p0));
    const int cs = P.cs, nnc = P.nnc, n = P.n, ue = Ue;
    for (int p = threadIdx.x; p < ue; p += kThreads) {
      const int gp = p0 + p;
      int tok = -1;
      if (gp < UT) {
        const int lc = gp / cs;
        tok = ucl_g[lc] * cs + (gp - lc * cs);
        if (tok >= n) tok = -1;
      }
      stok[p] = tok;
      upos[2 * p] = tok >= 0 ? posb[2 * tok] : 0.f;
      upos[2 * p + 1] = tok >= 0 ? posb[2 * tok + 1] : 0.f;
    }
    {  // [ra, rb): the run of the row's slots x = j cs + r from its first to
       // its last in the chunk. Positions grow with x, so the run holds no
       // other slot, but those of a repeated cluster that straddles the
       // chunk's edge (for_slots skips them).
      const int i = threadIdx.x / kRow, q = threadIdx.x % kRow;
      int a = 0x7fffffff, b = 0;
      if (i < rows) {
        for (int j = q; j < nnc; j += kRow) {
          const int base = nid(i * nnc + j) * cs;
          const int r0 = min(max(p0 - base, 0), cs);
          const int r1 = min(max(p0 + ue - base, 0), cs);
          if (r0 < r1) {
            a = min(a, j * cs + r0);
            b = max(b, j * cs + r1);
          }
        }
      }
      a = row_min_i(a);
      b = row_max_i(b);
      if (q == 0) {
        ra[i] = b > 0 ? a : 0;
        rb[i] = b;
      }
    }
    const int ldd = L.ldd, npt = P.Uc / 16, w8 = ue / 8;
    if (fill_dst) {  // a warp per row, rows of a multiple of 16 bytes
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      for (int r = warp; r < kTile; r += kWarps) {
        uint4* row = reinterpret_cast<uint4*>(dst + r * ldd);
        for (int e = lane; e < w8; e += 32)
          row[e] = make_uint4(~0u, ~0u, ~0u, ~0u);
      }
    }
    for (int e = threadIdx.x; e < kTile / 16 * npt; e += kThreads) occ[e] = 0;
    __syncthreads();
    for (int e = threadIdx.x; e < rows * nnc; e += kThreads) {
      const int i = e / nnc, j = e - i * nnc, v = nid(e);
      if (j > 0 && nid(e - 1) == v) continue;  // a repeat: see for_slots
      const int base = v * cs - p0;
      const int r0 = max(0, -base), r1 = min(cs, ue - base);
      if (r0 >= r1) continue;
      if (fill_dst) {
        for (int r = r0; r < r1; ++r)
          if (stok[base + r] >= 0)
            dst[i * ldd + base + r] =
                static_cast<short>(keep() ? j * cs + r : base + r);
      }
      for (int pt = (base + r0) / 16; pt <= (base + r1 - 1) / 16; ++pt)
        occ[(i >> 4) * npt + pt] = 1;
    }
    __syncthreads();
  }

  // f(x, pos, mult) for thread q's share of row i's slots in the chunk:
  // pos the slot's chunk position, x where the row keeps its logit (the
  // slot itself when keeping, else pos), mult the number of times the row
  // lists the slot's cluster (its repeats, and slots outside the chunk,
  // are skipped; only a tile with repeats checks for them). A padded slot
  // is skipped. The slot is walked as (j, r), with one division per row.
  template <class F>
  __device__ void for_slots(int i, int q, F f) const {
    if (reps)
      walk<true>(i, q, f);
    else
      walk<false>(i, q, f);
  }

  template <bool REPS, class F>
  __device__ void walk(int i, int q, F f) const {
    if (i >= rows) return;
    const int cs = P.cs, nnc = P.nnc, xb = rb[i], e0 = i * nnc;
    int x = ra[i] + q;
    if (x >= xb) return;
    int j = x / cs, r = x - j * cs;
    for (; x < xb; x += kRow) {
      const int v = nid(e0 + j);
      const int pos = v * cs + r - p0;
      bool take = true;
      int mult = 1;
      if constexpr (REPS) {
        take = (j == 0 || nid(e0 + j - 1) != v) && pos >= 0 && pos < Ue;
        while (j + mult < nnc && nid(e0 + j + mult) == v) ++mult;
      }
      if (take && stok[pos] >= 0)
        f(keep() ? x : pos, pos, static_cast<float>(mult));
      r += kRow;
      while (r >= cs) {
        r -= cs;
        ++j;
      }
    }
  }

  // the G heads' rel-pos weights, into registers for a row pass
  __device__ void weights(float (&w)[kMaxG][6]) const {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
#pragma unroll
      for (int f = 0; f < 6; ++f) w[g][f] = g < G ? wts[6 * g + f] : 0.f;
  }

  static __device__ float bias(const float (&w)[kMaxG][6], int g,
                               const float* f) {
    return w[g][0] * f[0] + w[g][1] * f[1] + w[g][2] * f[2] +
           w[g][3] * f[3] + w[g][4] * f[4] + w[g][5];
  }

  __device__ void feat(int i, int p, float* f) const {
    rel_feat(upos[2 * p] - qpos[2 * i], upos[2 * p + 1] - qpos[2 * i + 1],
             P.R, P.clamp_hi, f);
  }

  // C = A B^T of a (b, n, c) tile's heads against the chunk (S = Q K^T,
  // or in the backward dP = G V^T), kept only where a row has a slot:
  // out[g][i][x] for row i's slot kept at x (dst), the rest dropped; with
  // `add`, added to what is there (a later channel chunk).
  __device__ void scores(const E* a, const E* b, float* out, bool add) {
    const int lm = L.lm, ldd = L.ldd;
    const short* dst_ = dst;
    tile_mm<TC>(View<E, false>{a, L.lds, kTile * L.lds},
                View<E, true>{b, L.lds, P.Uc * L.lds}, G, kTile, Ue, P.CP,
                [=](int g, int r, int col, float v0, float v1) {
                  // the slots of columns col, col + 1 in one 32-bit load
                  const uint32_t d = *reinterpret_cast<const uint32_t*>(
                      dst_ + r * ldd + col);
                  const int x0 = static_cast<short>(d & 0xffffu);
                  const int x1 = static_cast<short>(d >> 16);
                  float* row = out + (g * kTile + r) * lm;
                  if (x0 >= 0) row[x0] = add ? row[x0] + v0 : v0;
                  if (x1 >= 0) row[x1] = add ? row[x1] + v1 : v1;
                },
                occupied_rp(), true);
  }

  // S (and in the backward dP) of the staged chunk over the channel
  // chunks of the heads. With one channel chunk, q (and g) stay staged
  // from begin() and k and v are staged together.
  __device__ void contract() {
    for (int cc = 0; cc < nch(); ++cc) {
      const int ch0 = cc * P.CP;
      if (nch() > 1) {
        if (cc > 0) __syncthreads();  // the last products read the tiles
        stage_tile(qb, sq, ch0);
        if constexpr (BWD) stage_tile(gb, sg, ch0);
      }
      stage_kv(ch0, true, BWD || nch() == 1);
      cp_async_wait_all();
      __syncthreads();
      scores(sq, sk, slg, cc > 0);
      if constexpr (BWD) scores(sg, sv, sdp, cc > 0);
    }
  }

  // The softmax row pass over one chunk, a group of kRow threads per row,
  // each over its share of the row's slots: the logit (bias from the
  // geometry, computed once per slot for all heads) replaces q.k in
  // place; (m, l) take the online update. Forward: P = exp(logit - m) at
  // the slots (times the dropout keep/scale), 0 elsewhere, and a_ =
  // exp(m_old - m_new). Backward (first pass): a_ gathers the sum of
  // exp(logit - m) dP (dP times the keep/scale).
  __device__ void softmax_chunk() {
    const int i = threadIdx.x / kRow, q = threadIdx.x % kRow;
    if constexpr (!BWD) zero_row(sp, i, q);
    float w[kMaxG][6];
    weights(w);
    float mx[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) mx[g] = -INFINITY;
    for_slots(i, q, [&](int x, int pos, float) {
      float f[5];
      feat(i, pos, f);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float* s = lrow(g, i) + x;
          const float lg = *s + bias(w, g, f);
          *s = lg;
          mx[g] = fmaxf(mx[g], lg);
        }
      }
    });
    float mn[kMaxG], sm[kMaxG], sd[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      mn[g] = g < G ? fmaxf(m_[st_at(g, i)], row_max(mx[g])) : 0.f;
      sm[g] = 0.f;
      sd[g] = 0.f;
    }
    __syncwarp();
    for_slots(i, q, [&](int x, int pos, float mult) {
      const int tok = stok[pos];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float e = mult * expf(lrow(g, i)[x] - mn[g]);
          sm[g] += e;
          if constexpr (BWD) {
            sd[g] += DROP ? e * dprow(g, i)[x] * keep_at(g, i, tok)
                          : e * dprow(g, i)[x];
          } else {
            prow(g, i)[pos] = from_f<E>(DROP ? e * keep_at(g, i, tok) : e);
          }
        }
      }
    });
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float tot = row_sum(sm[g]);
        const float dtot = BWD ? row_sum(sd[g]) : 0.f;
        if (q == 0 && i < rows) {
          const int at = st_at(g, i);
          const float al = expf(m_[at] - mn[g]);
          m_[at] = mn[g];
          l_[at] = l_[at] * al + tot;
          a_[at] = BWD ? a_[at] * al + dtot : al;
        }
      }
    }
  }

  // O = alpha O + P V over the block's channel slice.
  __device__ void pv() {
    float* so_ = so;
    const float* a = a_;
    const int ldo = L.ldo;
    tile_mm<TC>(View<E, false>{sp, L.ldp, kTile * L.ldp},
                View<E, false>{sv, L.lds, P.Uc * L.lds}, G, kTile, P.CP,
                Ue, [=](int g, int r, int col, float v0, float v1) {
                  float2* o = reinterpret_cast<float2*>(
                      so_ + (g * kTile + r) * ldo + col);
                  const float al = a[g * kTile + r];
                  const float2 x = *o;
                  *o = make_float2(x.x * al + v0, x.y * al + v1);
                },
                occupied_rk(), false);
  }

  // The forward over the whole union (the backward's first pass, which
  // needs dP instead of O): after it, (m, l) are the softmax statistics
  // and so holds the unnormalised output, blank term included.
  __device__ void attend() {
    for (int p = 0; p < UT; p += P.Uc) {
      stage_meta(p, true);
      contract();
      __syncthreads();
      softmax_chunk();
      __syncthreads();
      if constexpr (!BWD) {
        if (nch() > 1) {  // v of the block's slice
          stage_kv(chs, false, true);
          cp_async_wait_all();
          __syncthreads();
        }
        pv();
        __syncthreads();
      }
    }
  }
};

}  // namespace ca
