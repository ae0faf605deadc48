// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Three kernels replace the three TPU kernels of lzy_tpu/ops/flash_attention.py:
// - fwd_kernel replaces `_fwd_kernel` (:79): per tile of query rows, an online
//   softmax over KV tiles; writes O and the per-row logsumexp (lse);
// - dq_kernel replaces `_bwd_dq_kernel` (:197): per tile of query rows, a loop
//   over KV tiles, p = exp(s - lse), ds = p (dp - delta) scale, dQ += ds K;
// - dkv_kernel replaces `_bwd_dkv_kernel` (:260): per tile of key rows, a loop
//   over query tiles, dV += p^T dO, dK += ds^T Q.
// Same semantics as the reference: scores (q . k) * scale in f32, an additive
// per-key bias (0 keep, -1e30 drop: kv_mask), causal and same-document masks;
// a row with nothing visible gets O = 0 and lse = -1e30, and the backward
// zeroes p wherever lse <= -1e30 / 2 (the bias would otherwise cancel). The
// KV loop stops at the diagonal when causal and, with packed documents, runs
// only over the tiles between the tile's first document start and its last
// document end (per-position (id, start, end) in `bounds`, int32 [B, T, 3];
// the id is the document's start, so a repeated id is a new document).
// delta = rowsum(dO * O) comes precomputed, as in the reference's `_bwd`.
//
// Bound: at the training shape (B*H = 128, T = 2048, D = 128, causal, bf16)
// every kernel is bound by operations, not bytes: the forward does 2 matmuls
// over the causal half (1.37e11 FLOP, 0.139 ms at 989 TFLOP/s), dQ 3
// (0.208 ms), dK/dV 4 (0.278 ms), while Q, K, V and O are 268 MB (0.08 ms at
// 3.35 TB/s). So the design keeps the score matrix on chip and feeds the tensor
// cores: bf16 products run on mma.sync m16n8k16 with f32 accumulation.
//
// Design (simple and right first; wgmma, TMA and pipelining are later work):
// - 4 warps per CTA, each owning 16 rows of the CTA's 64-row tile; the other
//   operand streams through shared memory one 64-row (32 for dK/dV) tile at a
//   time, loaded with 16-byte vectors, rows past T zero-filled and masked;
// - bf16 fragments come from shared memory by ldmatrix (transposed on load
//   where the tile's rows are the product's k); P and dS go through shared
//   memory in the input dtype before the second product (the reference
//   keeps them in f32: a bf16 rounding, 2^-9 relative);
// - float32 inputs take the same loops with an FMA product in place of
//   mma.sync (each thread computes the fragment elements it owns), so f32 is
//   exact to the summation order;
// - any head dim that is a multiple of 16 up to 128, any T (a ragged tail is
//   masked); the model keeps the reference's T % 128 == 0 dispatch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDMax = 128;
constexpr int kPad = 8;      // elements of padding per shared-memory row
constexpr int kTile = 64;    // rows per CTA (16 per warp); KV tile of fwd/dQ
constexpr int kTileQ = 32;   // query tile of the dK/dV loop
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Views of a shared-memory tile: (r, c) -> element.
template <typename T>
struct RowMajor {
  const T* p;
  int ld;
  __device__ __forceinline__ T operator()(int r, int c) const {
    return p[r * ld + c];
  }
};
template <typename T>
struct ColMajor {
  const T* p;
  int ld;
  __device__ __forceinline__ T operator()(int r, int c) const {
    return p[c * ld + r];
  }
};

// Warp-level tile product c[16 x 8] += A[16 x 16] B[16 x 8] in f32, with the
// accumulator in mma.sync's layout: lane = 4 g + i, c[0..1] at row g, columns
// 2i, 2i + 1; c[2..3] at row g + 8.
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  using T = __nv_bfloat16;
  struct FragA {
    uint32_t r[4];
  };
  struct FragB {
    uint32_t r[2];
  };
  static __device__ __forceinline__ uint32_t smem(const T* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
  }
  // A: rows 0-15 x columns 0-15 of a row-major tile, as four 8 x 8
  // matrices (lanes 8m..8m+7 give matrix m's row addresses)
  static __device__ __forceinline__ FragA load_a(const RowMajor<T>& a) {
    const int lane = threadIdx.x & 31, m = lane >> 3;
    const int row = (lane & 7) + (m & 1) * 8, col = (m >> 1) * 8;
    FragA f;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(f.r[0]), "=r"(f.r[1]), "=r"(f.r[2]), "=r"(f.r[3])
        : "r"(smem(a.p + row * a.ld + col)));
    return f;
  }
  // B(k, n) = p[n * ld + k]: the tile's rows are B's columns
  static __device__ __forceinline__ FragB load_b(const ColMajor<T>& b) {
    const int lane = threadIdx.x & 15;  // x2 reads lanes 0-15's addresses
    FragB f;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(f.r[0]), "=r"(f.r[1])
        : "r"(smem(b.p + (lane & 7) * b.ld + (lane >> 3) * 8)));
    return f;
  }
  // B(k, n) = p[k * ld + n]: the tile's rows are B's rows, transposed on
  // the way into the registers
  static __device__ __forceinline__ FragB load_b(const RowMajor<T>& b) {
    const int lane = threadIdx.x & 15;
    FragB f;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(f.r[0]), "=r"(f.r[1])
        : "r"(smem(b.p + lane * b.ld)));
    return f;
  }
  static __device__ __forceinline__ void run(float c[4], const FragA& a,
                                             const FragB& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

template <>
struct Mma<float> {
  // f32: the "fragment" is the view itself; each thread sums the products
  // of the accumulator elements it owns, in k order.
  template <class A>
  static __device__ __forceinline__ A load_a(const A& a) {
    return a;
  }
  template <class B>
  static __device__ __forceinline__ B load_b(const B& b) {
    return b;
  }
  template <class A, class B>
  static __device__ __forceinline__ void run(float c[4], const A& a,
                                             const B& b) {
    const int lane = threadIdx.x & 31, g = lane >> 2, n = (lane & 3) * 2;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float a0 = a(g, k), a1 = a(g + 8, k);
      const float b0 = b(k, n), b1 = b(k, n + 1);
      c[0] = fmaf(a0, b0, c[0]);
      c[1] = fmaf(a0, b1, c[1]);
      c[2] = fmaf(a1, b0, c[2]);
      c[3] = fmaf(a1, b1, c[3]);
    }
  }
};

// Rows [row0, row0 + rows) of a row-major [t, d] matrix into shared memory
// (row stride ld); rows at or past t are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          int row0, int rows, int t, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = d / kVec;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// S[16 x 8 * NT] (this warp's rows) = A[16 x d] B[d x 8 * NT], with A rows
// read from `a` (row-major, stride ld) and B(k, n) = rows[n][k] (a row-major
// tile whose rows are the product's columns).
template <typename T, int NT>
__device__ __forceinline__ void product_nt(float s[NT][4], const T* a,
                                           const T* rows, int ld, int d) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int kk = 0; kk < d; kk += 16) {
    const auto fa = Mma<T>::load_a(RowMajor<T>{a + kk, ld});
#pragma unroll
    for (int n = 0; n < NT; ++n)
      Mma<T>::run(s[n], fa,
                  Mma<T>::load_b(ColMajor<T>{rows + n * 8 * ld + kk, ld}));
  }
}

// acc[16 x d] += A[16 x K] B[K x d], A row-major (stride lda) and B a
// row-major tile (stride ldb) over the first d columns.
template <typename T, int K>
__device__ __forceinline__ void product_nn(float acc[kDMax / 8][4],
                                           const T* a, int lda, const T* b,
                                           int ldb, int d) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    const auto fa = Mma<T>::load_a(RowMajor<T>{a + kk, lda});
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
      if (n * 8 < d)
        Mma<T>::run(acc[n], fa,
                    Mma<T>::load_b(RowMajor<T>{b + kk * ldb + n * 8, ldb}));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Shape {
  int H, t, d, causal;
  float scale;
};

// Query-tile loop range over KV tiles of `tile` columns for query rows
// [q0, q0 + rows): the causal diagonal, then the documents' span.
__device__ __forceinline__ void kv_range(const Shape& s, const int* bnd,
                                         int q0, int rows, int tile, int* lo,
                                         int* hi) {
  *lo = 0;
  *hi = (s.t + tile - 1) / tile;
  if (s.causal) *hi = min(*hi, (q0 + rows - 1) / tile + 1);
  if (bnd) {
    const int last = min(q0 + rows, s.t) - 1;
    *lo = bnd[q0 * 3 + 1] / tile;
    *hi = min(*hi, (bnd[last * 3 + 2] + tile - 1) / tile);
  }
}

// -- forward ----------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, const float* __restrict__ bias,
               const int* __restrict__ bounds, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = s.d + kPad, ldp = kTile + kPad;
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kTile * ld;
  T* sV = sK + kTile * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  T* sP = sV + kTile * ld + warp * 16 * ldp;
  const int bh = blockIdx.y, b = bh / s.H, q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * s.t * s.d;
  const int* bnd = bounds ? bounds + static_cast<size_t>(b) * s.t * 3
                          : nullptr;
  const float* kb = bias ? bias + static_cast<size_t>(b) * s.t : nullptr;
  int lo, hi;
  kv_range(s, bnd, q0, kTile, kTile, &lo, &hi);
  load_tile(sQ, ld, q + base, q0, kTile, s.t, s.d);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int id[2] = {0, 0};
  if (bnd) {
#pragma unroll
    for (int r = 0; r < 2; ++r) id[r] = bnd[min(row[r], s.t - 1) * 3];
  }
  float acc[kDMax / 8][4];
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(sK, ld, k + base, c0, kTile, s.t, s.d);
    load_tile(sV, ld, v + base, c0, kTile, s.t, s.d);
    __syncthreads();
    float sc[kTile / 8][4];
    product_nt<T, kTile / 8>(sc, sQ + warp * 16 * ld, sK, ld, s.d);
    uint32_t keep = 0;  // bit 4 n + i: element (n, i) is visible
    float mt[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, col = c0 + n * 8 + c2 + (i & 1);
        float x = sc[n][i] * s.scale;
        bool ok = col < s.t;
        if (ok && kb) x += kb[col];
        if (s.causal) ok = ok && row[r] >= col;
        if (bnd) ok = ok && col < s.t && bnd[col * 3] == id[r];
        x = ok ? x : kNegInf;
        keep |= static_cast<uint32_t>(ok) << (4 * n + i);
        sc[n][i] = x;
        mt[r] = fmaxf(mt[r], x);
      }
    float alpha[2], msafe[2], lt[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mnew = fmaxf(m[r], quad_max(mt[r]));
      msafe[r] = mnew <= kNegInf / 2 ? 0.f : mnew;
      alpha[r] = m[r] <= kNegInf / 2 ? 0.f : expf(m[r] - msafe[r]);
      m[r] = mnew;
    }
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const float p = (keep >> (4 * n + i)) & 1u
                            ? expf(sc[n][i] - msafe[r])
                            : 0.f;
        lt[r] += p;
        sP[(g + 8 * r) * ldp + n * 8 + c2 + (i & 1)] = from_f32<T>(p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(lt[r]);
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    __syncwarp();
    product_nn<T, kTile>(acc, sP, ldp, sV, ld, s.d);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s.t) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* out = o + base + static_cast<size_t>(row[r]) * s.d;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
      if (n * 8 < s.d) {
        out[n * 8 + c2] = from_f32<T>(acc[n][2 * r] * inv);
        out[n * 8 + c2 + 1] = from_f32<T>(acc[n][2 * r + 1] * inv);
      }
    if (c2 == 0)
      lse[static_cast<size_t>(bh) * s.t + row[r]] =
          l[r] > 0.f ? m[r] + logf(fmaxf(l[r], 1e-30f)) : kNegInf;
  }
}

// -- backward: dQ -------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, const float* __restrict__ bias,
              const int* __restrict__ bounds, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = s.d + kPad, ldp = kTile + kPad;
  T* sQ = reinterpret_cast<T*>(smem);
  T* sO = sQ + kTile * ld;  // dO rows
  T* sK = sO + kTile * ld;
  T* sV = sK + kTile * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  T* sS = sV + kTile * ld + warp * 16 * ldp;  // this warp's dS rows
  const int bh = blockIdx.y, b = bh / s.H, q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * s.t * s.d;
  const int* bnd = bounds ? bounds + static_cast<size_t>(b) * s.t * 3
                          : nullptr;
  const float* kb = bias ? bias + static_cast<size_t>(b) * s.t : nullptr;
  int lo, hi;
  kv_range(s, bnd, q0, kTile, kTile, &lo, &hi);
  load_tile(sQ, ld, q + base, q0, kTile, s.t, s.d);
  load_tile(sO, ld, dout + base, q0, kTile, s.t, s.d);

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  int id[2] = {0, 0};
  float L[2] = {kNegInf, kNegInf}, dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (row[r] < s.t) {
      L[r] = lse[static_cast<size_t>(bh) * s.t + row[r]];
      dl[r] = delta[static_cast<size_t>(bh) * s.t + row[r]];
      if (bnd) id[r] = bnd[row[r] * 3];
    }
  float acc[kDMax / 8][4];
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = lo; j < hi; ++j) {
    const int c0 = j * kTile;
    __syncthreads();
    load_tile(sK, ld, k + base, c0, kTile, s.t, s.d);
    load_tile(sV, ld, v + base, c0, kTile, s.t, s.d);
    __syncthreads();
    float sc[kTile / 8][4], dp[kTile / 8][4];
    product_nt<T, kTile / 8>(sc, sQ + warp * 16 * ld, sK, ld, s.d);
    product_nt<T, kTile / 8>(dp, sO + warp * 16 * ld, sV, ld, s.d);
#pragma unroll
    for (int n = 0; n < kTile / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, col = c0 + n * 8 + c2 + (i & 1);
        bool ok = col < s.t && row[r] < s.t && L[r] > kNegInf / 2;
        if (s.causal) ok = ok && row[r] >= col;
        if (bnd) ok = ok && col < s.t && bnd[col * 3] == id[r];
        float ds = 0.f;
        if (ok) {
          float x = sc[n][i] * s.scale;
          if (kb) x += kb[col];
          ds = expf(x - L[r]) * (dp[n][i] - dl[r]) * s.scale;
        }
        sS[(g + 8 * r) * ldp + n * 8 + c2 + (i & 1)] = from_f32<T>(ds);
      }
    __syncwarp();
    product_nn<T, kTile>(acc, sS, ldp, sK, ld, s.d);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s.t) continue;
    T* out = dq + base + static_cast<size_t>(row[r]) * s.d;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
      if (n * 8 < s.d) {
        out[n * 8 + c2] = from_f32<T>(acc[n][2 * r]);
        out[n * 8 + c2 + 1] = from_f32<T>(acc[n][2 * r + 1]);
      }
  }
}

// -- backward: dK and dV -------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, const float* __restrict__ bias,
               const int* __restrict__ bounds, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = s.d + kPad, ldp = kTileQ + kPad;
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kTile * ld;
  T* sQ = sV + kTile * ld;
  T* sO = sQ + kTileQ * ld;  // dO rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  T* sP = sO + kTileQ * ld + warp * 16 * ldp;          // this warp's P^T
  T* sS = sO + kTileQ * ld + (kWarps + warp) * 16 * ldp;  // and dS^T
  float* sL = reinterpret_cast<float*>(sO + kTileQ * ld +
                                       2 * kWarps * 16 * ldp);
  float* sD = sL + kTileQ;
  int* sId = reinterpret_cast<int*>(sD + kTileQ);
  const int bh = blockIdx.y, b = bh / s.H, k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * s.t * s.d;
  const int* bnd = bounds ? bounds + static_cast<size_t>(b) * s.t * 3
                          : nullptr;
  const float* kb = bias ? bias + static_cast<size_t>(b) * s.t : nullptr;
  // mirror of the forward's skip: only query rows inside this key tile's
  // documents (and, causal, at or below its diagonal) can reach it
  int lo = s.causal ? k0 / kTileQ : 0;
  int hi = (s.t + kTileQ - 1) / kTileQ;
  if (bnd) {
    const int last = min(k0 + kTile, s.t) - 1;
    if (!s.causal) lo = max(lo, bnd[k0 * 3 + 1] / kTileQ);
    hi = min(hi, (bnd[last * 3 + 2] + kTileQ - 1) / kTileQ);
  }
  load_tile(sK, ld, k + base, k0, kTile, s.t, s.d);
  load_tile(sV, ld, v + base, k0, kTile, s.t, s.d);

  // this thread's key rows (rows of S^T)
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  int kid[2] = {0, 0};
  float kbias[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (key[r] < s.t) {
      if (bnd) kid[r] = bnd[key[r] * 3];
      if (kb) kbias[r] = kb[key[r]];
    }
  float accK[kDMax / 8][4], accV[kDMax / 8][4];
#pragma unroll
  for (int n = 0; n < kDMax / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) accK[n][i] = accV[n][i] = 0.f;

  for (int it = lo; it < hi; ++it) {
    const int qs = it * kTileQ;
    __syncthreads();
    load_tile(sQ, ld, q + base, qs, kTileQ, s.t, s.d);
    load_tile(sO, ld, dout + base, qs, kTileQ, s.t, s.d);
    for (int i = threadIdx.x; i < kTileQ; i += kThreads) {
      const bool in = qs + i < s.t;
      const size_t at = static_cast<size_t>(bh) * s.t + qs + i;
      sL[i] = in ? lse[at] : kNegInf;
      sD[i] = in ? delta[at] : 0.f;
      sId[i] = in && bnd ? bnd[(qs + i) * 3] : 0;
    }
    __syncthreads();
    float st[kTileQ / 8][4], dpt[kTileQ / 8][4];
    product_nt<T, kTileQ / 8>(st, sK + warp * 16 * ld, sQ, ld, s.d);
    product_nt<T, kTileQ / 8>(dpt, sV + warp * 16 * ld, sO, ld, s.d);
#pragma unroll
    for (int n = 0; n < kTileQ / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, qc = n * 8 + c2 + (i & 1), qrow = qs + qc;
        bool ok = qrow < s.t && key[r] < s.t && sL[qc] > kNegInf / 2;
        if (s.causal) ok = ok && qrow >= key[r];
        if (bnd) ok = ok && sId[qc] == kid[r];
        float p = 0.f, ds = 0.f;
        if (ok) {
          p = expf(st[n][i] * s.scale + kbias[r] - sL[qc]);
          ds = p * (dpt[n][i] - sD[qc]) * s.scale;
        }
        sP[(g + 8 * r) * ldp + qc] = from_f32<T>(p);
        sS[(g + 8 * r) * ldp + qc] = from_f32<T>(ds);
      }
    __syncwarp();
    product_nn<T, kTileQ>(accV, sP, ldp, sO, ld, s.d);
    product_nn<T, kTileQ>(accK, sS, ldp, sQ, ld, s.d);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= s.t) continue;
    const size_t at = base + static_cast<size_t>(key[r]) * s.d;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
      if (n * 8 < s.d)
        for (int e = 0; e < 2; ++e) {
          dk[at + n * 8 + c2 + e] = from_f32<T>(accK[n][2 * r + e]);
          dv[at + n * 8 + c2 + e] = from_f32<T>(accV[n][2 * r + e]);
        }
  }
}

// -- launchers ------------------------------------------------------------------

template <typename T>
size_t fwd_smem(int d) {
  return (3 * kTile * (d + kPad) + kWarps * 16 * (kTile + kPad)) * sizeof(T);
}
template <typename T>
size_t dq_smem(int d) {
  return (4 * kTile * (d + kPad) + kWarps * 16 * (kTile + kPad)) * sizeof(T);
}
template <typename T>
size_t dkv_smem(int d) {
  return (2 * (kTile + kTileQ) * (d + kPad) +
          2 * kWarps * 16 * (kTileQ + kPad)) * sizeof(T) +
         3 * kTileQ * 4;
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

bool valid(int b, int h, int t, int d) {
  return b > 0 && h > 0 && t > 0 && d >= 16 && d <= kDMax && d % 16 == 0 &&
         b * h <= 65535;
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        const void* bias, const void* bounds, int b, int h, int t, int d,
        int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<T>(d);
  if (int rc = prepare(fwd_kernel<T>, smem)) return rc;
  const dim3 grid((t + kTile - 1) / kTile, b * h);
  fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      static_cast<const float*>(bias), static_cast<const int*>(bounds),
      Shape{h, t, d, causal, scale});
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const void* bias,
           const void* bounds, int b, int h, int t, int d, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = dq_smem<T>(d);
  if (int rc = prepare(dq_kernel<T>, smem)) return rc;
  const dim3 grid((t + kTile - 1) / kTile, b * h);
  dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), static_cast<const float*>(bias),
      static_cast<const int*>(bounds), Shape{h, t, d, causal, scale});
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const void* bias, const void* bounds, int b, int h, int t, int d,
            int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<T>(d);
  if (int rc = prepare(dkv_kernel<T>, smem)) return rc;
  const dim3 grid((t + kTile - 1) / kTile, b * h);
  dkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<const float*>(bias), static_cast<const int*>(bounds),
      Shape{h, t, d, causal, scale});
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points: device pointers in, cudaGetLastError() out (-1 for a shape
// or dtype the kernels do not take). q, k, v, o, dO, dQ, dK, dV are contiguous
// [B, H, T, D] in one dtype (0 = float32, 1 = bfloat16); lse and delta f32
// [B, H, T]; bias f32 [B, T] or null; bounds int32 [B, T, 3] or null.

extern "C" int lzy_flash_fwd(int dtype, const void* q, const void* k,
                             const void* v, void* o, void* lse,
                             const void* bias, const void* bounds, int b,
                             int h, int t, int d, int causal, float scale,
                             void* stream) {
  if (!valid(b, h, t, d)) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return fwd<float>(q, k, v, o, lse, bias, bounds, b, h, t, d, causal,
                      scale, st);
  if (dtype == kBF16)
    return fwd<__nv_bfloat16>(q, k, v, o, lse, bias, bounds, b, h, t, d,
                              causal, scale, st);
  return -1;
}

extern "C" int lzy_flash_bwd_dq(int dtype, const void* q, const void* k,
                                const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                const void* bias, const void* bounds, int b,
                                int h, int t, int d, int causal, float scale,
                                void* stream) {
  if (!valid(b, h, t, d)) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return bwd_dq<float>(q, k, v, dout, lse, delta, dq, bias, bounds, b, h,
                         t, d, causal, scale, st);
  if (dtype == kBF16)
    return bwd_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bias,
                                 bounds, b, h, t, d, causal, scale, st);
  return -1;
}

extern "C" int lzy_flash_bwd_dkv(int dtype, const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const void* lse, const void* delta,
                                 void* dk, void* dv, const void* bias,
                                 const void* bounds, int b, int h, int t,
                                 int d, int causal, float scale,
                                 void* stream) {
  if (!valid(b, h, t, d)) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return bwd_dkv<float>(q, k, v, dout, lse, delta, dk, dv, bias, bounds, b,
                          h, t, d, causal, scale, st);
  if (dtype == kBF16)
    return bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bias,
                                  bounds, b, h, t, d, causal, scale, st);
  return -1;
}
