// Pieces shared by the fused cluster-merge forward (cluster_merge.cu) and
// backward (cluster_merge_bwd.cu), for Hopper (sm_90a): element
// conversions, cp.async copies, ldmatrix, the XOR swizzle of rows kept in
// shared memory, the bf16 tensor-core product mma.sync m16n8k16 (f32
// accumulators) and a warp-level 16 x 8 tile product over shared-memory
// views that runs it, or, for f32 operands, the same tile in exact f32
// FMAs on the CUDA cores.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace cm {

constexpr int kIC = 4;  // ClusterMerging's weight_net width
constexpr int kMaxShmem = 232448;  // a block's limit on the H100
constexpr int kMaxDevices = 64;

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

__host__ __device__ inline int round_up(int x, int q) {
  return (x + q - 1) / q * q;
}

__device__ __forceinline__ uint32_t bits16(const bf16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of 16 (cg: L2 only) or 4/8 bytes (ca)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  static_assert(BYTES == 4 || BYTES == 8, "cp.async.ca takes 4 or 8 bytes");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 b16 matrices from shared memory, one row address per lane
// (lanes 8q .. 8q + 7 give matrix q's rows); .trans delivers them
// transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4],
                                                  const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// Rows of bf16 resident in shared memory, XOR-swizzled: a row holds
// Q = width / 8 chunks of 16 bytes, and chunk q of row r sits at
// q ^ ((r >> sh) & mask). Any 8 consecutive rows then fall in 8 distinct
// 16-byte bank groups, so ldmatrix gathers them without conflicts. The
// width must be 16, 32 or a multiple of 64.
struct Swizzle {
  int sh, mask;
  __host__ __device__ static bool fits(int width) {
    return width == 16 || width == 32 || (width > 0 && width % 64 == 0);
  }
  __host__ __device__ static Swizzle of(int width) {
    const int Q = width / 8;
    return {Q >= 8 ? 0 : (Q == 4 ? 1 : 2), Q >= 8 ? 7 : Q - 1};
  }
  // element offset of chunk q of row r in rows of `width` elements
  __device__ __forceinline__ int at(int r, int q, int width) const {
    return r * width + ((q ^ ((r >> sh) & mask)) << 3);
  }
};

// Element (r, c) of a shared-memory matrix: p[r * ld + c], or p[c * ld + r]
// when TR (a transposed view).
template <typename E, bool TR>
struct View {
  const E* p;
  int ld;
  __device__ __forceinline__ const E* ptr(int r, int c) const {
    return p + (TR ? c * ld + r : r * ld + c);
  }
  __device__ __forceinline__ float at(int r, int c) const {
    return to_f(*ptr(r, c));
  }
  // (r, c) and (r, c + 1) as bf16x2, the first in the low half (bf16 only)
  __device__ __forceinline__ uint32_t pair(int r, int c) const {
    if constexpr (!TR) {
      return *reinterpret_cast<const uint32_t*>(ptr(r, c));
    } else {
      return bits16(ptr(r, c)) | (bits16(ptr(r, c + 1)) << 16);
    }
  }
};

// One warp adds to d the 16 x 8 tile C[m0:m0+16, n0:n0+8] of C = A B over
// k in [0, K), K a multiple of 16; A is (M x K) and Bt is B transposed
// (N x K), so that both are read along k. The fragment layout is that of
// mma.sync m16n8k16: lane (gq = lane / 4, t2 = 2 * (lane % 4)) holds
// C(m0 + gq, n0 + t2 + {0, 1}) in d[0..1] and C(m0 + gq + 8, ...) in
// d[2..3]. TC (bf16 operands): the tensor cores. Otherwise (f32 operands)
// the same entries as exact f32 FMAs on the CUDA cores.
template <bool TC, class VA, class VB>
__device__ __forceinline__ void tile_16x8(float (&d)[4], const VA& A,
                                          const VB& Bt, int m0, int n0,
                                          int K) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, t2 = (lane & 3) * 2;
  if constexpr (TC) {
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      a[0] = A.pair(m0 + gq, k0 + t2);
      a[1] = A.pair(m0 + gq + 8, k0 + t2);
      a[2] = A.pair(m0 + gq, k0 + t2 + 8);
      a[3] = A.pair(m0 + gq + 8, k0 + t2 + 8);
      mma_bf16_16816(d, a, Bt.pair(n0 + gq, k0 + t2),
                     Bt.pair(n0 + gq, k0 + t2 + 8));
    }
  } else {
    for (int k = 0; k < K; ++k) {
      const float a0 = A.at(m0 + gq, k), a1 = A.at(m0 + gq + 8, k);
      const float b0 = Bt.at(n0 + t2, k), b1 = Bt.at(n0 + t2 + 1, k);
      d[0] += a0 * b0;
      d[1] += a0 * b1;
      d[2] += a1 * b0;
      d[3] += a1 * b1;
    }
  }
}

// Two neighbouring rows of an mma.sync C fragment, for a store of bf16
// pairs: lane (gq, t2) holds (gq, t2) in lo and (gq, t2 + 1) in hi; it
// returns rows (gq & ~1, gq | 1) of column t2 + (gq & 1), trading one value
// with lane ^ 4 (rows that are neighbours in memory then go out as one
// 4-byte store).
__device__ __forceinline__ uint32_t row_pair(float lo, float hi) {
  const bool odd = (threadIdx.x >> 2) & 1;
  const float got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 4);
  const __nv_bfloat162 v = odd ? __floats2bfloat162_rn(got, hi)
                               : __floats2bfloat162_rn(lo, got);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stores the tile of tile_16x8 through f(row, col, value).
template <class F>
__device__ __forceinline__ void tile_store(const float (&d)[4], int m0,
                                           int n0, F f) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2, t2 = (lane & 3) * 2;
  f(m0 + gq, n0 + t2, d[0]);
  f(m0 + gq, n0 + t2 + 1, d[1]);
  f(m0 + gq + 8, n0 + t2, d[2]);
  f(m0 + gq + 8, n0 + t2 + 1, d[3]);
}

// The SM count of the current device, queried once per device.
inline cudaError_t sm_count(int* sms) {
  static int count[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    err = cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return err;
  }
  *sms = count[dev];
  return cudaSuccess;
}

// A kernel's dynamic shared memory above 48 KB needs the attribute.
template <class K>
cudaError_t allow_shmem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace cm
