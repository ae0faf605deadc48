// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Six kernels replace the three TPU kernels of lzy_tpu/ops/flash_attention.py,
// a bf16 kernel on TMA and wgmma and a float32 kernel on FMA loops for each:
// - fwd_wgmma_kernel (bf16) and fwd_kernel (float32) replace `_fwd_kernel`
//   (:79): per tile of query rows, an online softmax over KV tiles; writes O
//   and the per-row logsumexp (lse);
// - dq_wgmma_kernel and dq_kernel replace `_bwd_dq_kernel` (:197): per tile
//   of query rows, a loop over KV tiles, p = exp(s - lse),
//   ds = p (dp - delta) scale, dQ += ds K;
// - dkv_wgmma_kernel and dkv_kernel replace `_bwd_dkv_kernel` (:260): per
//   tile of key rows, a loop over query tiles, dV += p^T dO, dK += ds^T Q.
// Same semantics as the reference: scores (q . k) * scale in f32, an additive
// per-key bias (0 keep, -1e30 drop: kv_mask), causal and same-document masks;
// a row with nothing visible gets O = 0 and lse = -1e30, and the backward
// zeroes p wherever lse <= -1e30 / 2 (the bias would otherwise cancel). The
// KV loop stops at the diagonal when causal and, with packed documents, runs
// only over the tiles between the tile's first document start and its last
// document end (per-position (id, start, end) in `bounds`, int32 [B, T, 3];
// the id is the document's start, so a repeated id is a new document); the
// dK/dV loop over query tiles mirrors it. delta = rowsum(dO * O) comes
// precomputed, as in the reference's `_bwd`. No kernel uses atomics: each
// CTA owns the rows it writes, so results repeat bit for bit.
//
// Bound: at the training shape (B*H = 128, T = 2048, D = 128, causal, bf16)
// every kernel is bound by operations, not bytes: the forward does 2 matmuls
// over the causal half (1.37e11 FLOP, 0.139 ms at 989 TFLOP/s), dQ 3
// (0.208 ms), dK/dV 4 (0.278 ms), while Q, K, V and O are 268 MB (0.08 ms at
// 3.35 TB/s). So the design keeps the score matrix on chip and feeds the tensor
// cores.
//
// The bf16 kernels share one shape, the one Hopper wants:
// - a warp-specialised CTA of 384 threads per SM, resident for the whole
//   launch: warpgroup 0 is the producer (one thread issues TMA loads, the
//   warpgroup gives its registers away with setmaxnreg), warpgroups 1 and 2
//   are consumers of 64 rows each of a 128-row tile. The CTA walks work
//   items of two 128-row tiles, the i-th from either end of the causal
//   triangle, so every item costs the same number of inner tiles, and the
//   producer runs ahead into the next tile while the consumers finish one;
// - operands arrive by TMA (cp.async.bulk.tensor into 128-byte swizzled
//   64-column panels) through rings in shared memory with a full and an
//   empty mbarrier per stage, so loads overlap the products;
// - products are wgmma from shared memory with f32 accumulators in
//   registers; a probability (P, P^T) or a score gradient (dS, dS^T) is
//   rounded to bf16 in registers (where the mma.sync versions rounded it on
//   its way through shared memory) and is wgmma's register A operand for
//   the second product, against a tile read from shared memory as a
//   transposed (MN-major) B operand: neither ever touches shared memory;
// - the two consumer warpgroups take turns at the tensor cores (named
//   barriers 1 and 2): one issues its products while the other runs its
//   elementwise work;
// - exponentials run in the exp2 domain with scale * log2(e) folded into
//   one multiply; masks run only on tiles that need them (crossing the
//   causal diagonal or T, or with a bias or bounds);
// - head dims that are multiples of 16 up to 128 are padded to 64 or 128
//   columns by TMA's zero fill, and rows past T are zero-filled too, so any
//   T works. The tensor maps are encoded on the host with
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no link
//   against libcuda).
// Per kernel:
// - forward: per 128-row query tile, Q once, K and V tiles of 128 keys
//   through a three-stage ring; S = Q K^T (m64n128), online softmax,
//   O += P V;
// - dQ: the forward with a second score product and no online softmax
//   (lse is known): per 128-row query tile, Q and dO once, K and V tiles of
//   128 keys through a ring (two stages at d 128, three at d 64, as shared
//   memory allows); S = Q K^T and dP = dO V^T (m64n128), dQ += dS K with K
//   as the transposed B operand;
// - dK/dV: per 128-key tile, K and V once; Q and dO tiles of 64 query rows
//   stream through a three-stage ring, each stage with the rows' lse * log2(e)
//   (+inf where p must be 0: rows with no softmax mass, rows past T),
//   delta and document ids, written by a second producer warp; per query
//   tile S^T = K Q^T and dP^T = V dO^T (m64n64), then dV += P^T dO and
//   dK += dS^T Q with dO and Q as transposed B operands; a key block wholly
//   above the causal diagonal skips its products; dK and dV are staged in
//   the K/V tile's own rows and stored as 16-byte vectors.
// Measured at the train step's shape (16 x 8 heads, T 2048, d 128, causal;
// NVIDIA H100 80GB HBM3, 700 W): PERF.md's kernel table.
//
// float32 inputs keep FMA loops (fwd_kernel, dq_kernel, dkv_kernel): wgmma's
// f32 form is TF32, whose 10-bit mantissa would break the f32 row limit of
// 2e-5. They run 4 warps per CTA, each owning 16 rows of the CTA's 64-row
// tile; the other operand streams through shared memory one 64-row (32 for
// dK/dV) tile at a time, loaded with 16-byte vectors, rows past T
// zero-filled and masked; P and dS go through shared memory. Any head dim
// that is a multiple of 16 up to 128, any T (a ragged tail is masked); the
// model keeps the reference's T % 128 == 0 dispatch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDMax = 128;
constexpr int kPad = 8;      // floats of padding per shared-memory row
constexpr int kTile = 64;    // rows per CTA (16 per warp); KV tile of fwd/dQ
constexpr int kTileQ = 32;   // query tile of the f32 dK/dV loop
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

// Views of a shared-memory tile: (r, c) -> element.
struct RowMajor {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[r * ld + c];
  }
};
struct ColMajor {
  const float* p;
  int ld;
  __device__ __forceinline__ float operator()(int r, int c) const {
    return p[c * ld + r];
  }
};

// Warp-level tile product c[16 x 8] += A[16 x 16] B[16 x 8] in f32 by FMA,
// with the accumulator in mma.sync's layout: lane = 4 g + i, c[0..1] at row
// g, columns 2i, 2i + 1; c[2..3] at row g + 8. Each thread sums the products
// of the elements it owns, in k order.
template <class A, class B>
__device__ __forceinline__ void fma_tile(float c[4], const A& a, const B& b) {
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

// Rows [row0, row0 + rows) of a row-major [t, d] matrix into shared memory
// (row stride ld); rows at or past t are zero-filled.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int row0, int rows, int t, int d) {
  constexpr int kVec = 4;
  const int chunks = d / kVec;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * kVec;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t)
      val = *reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * d + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// S[16 x 8 * NT] (this warp's rows) = A[16 x d] B[d x 8 * NT], with A rows
// read from `a` (row-major, stride ld) and B(k, n) = rows[n][k] (a row-major
// tile whose rows are the product's columns).
template <int NT>
__device__ __forceinline__ void product_nt(float s[NT][4], const float* a,
                                           const float* rows, int ld, int d) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int kk = 0; kk < d; kk += 16) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
      fma_tile(s[n], RowMajor{a + kk, ld},
               ColMajor{rows + n * 8 * ld + kk, ld});
  }
}

// acc[16 x d] += A[16 x K] B[K x d], A row-major (stride lda) and B a
// row-major tile (stride ldb) over the first d columns.
template <int K>
__device__ __forceinline__ void product_nn(float acc[kDMax / 8][4],
                                           const float* a, int lda,
                                           const float* b, int ldb, int d) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
      if (n * 8 < d)
        fma_tile(acc[n], RowMajor{a + kk, lda},
                 RowMajor{b + kk * ldb + n * 8, ldb});
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
  int bh;  // B * H (the bf16 kernels' work list)
};

// The batch row's document bounds of head bh, or null.
__device__ __forceinline__ const int* doc_bounds(const int* bounds,
                                                 const Shape& s, int bh) {
  return bounds ? bounds + static_cast<size_t>(bh / s.H) * s.t * 3
                : nullptr;
}

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

// Key-tile loop range over query tiles of `tile` rows for key rows
// [k0, k0 + rows), the mirror of kv_range: only query rows inside the keys'
// documents (and, causal, at or below their diagonal) can reach them.
__device__ __forceinline__ void q_range(const Shape& s, const int* bnd,
                                        int k0, int rows, int tile, int* lo,
                                        int* hi) {
  *lo = s.causal ? k0 / tile : 0;
  *hi = (s.t + tile - 1) / tile;
  if (bnd) {
    const int last = min(k0 + rows, s.t) - 1;
    *lo = max(*lo, bnd[k0 * 3 + 1] / tile);
    *hi = min(*hi, (bnd[last * 3 + 2] + tile - 1) / tile);
  }
}

// -- forward, float32: FMA loops (bf16 runs fwd_wgmma_kernel below) ----------

__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o,
               float* __restrict__ lse, const float* __restrict__ bias,
               const int* __restrict__ bounds, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = s.d + kPad, ldp = kTile + kPad;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + kTile * ld;
  float* sV = sK + kTile * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  float* sP = sV + kTile * ld + warp * 16 * ldp;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * s.t * s.d;
  const int* bnd = doc_bounds(bounds, s, bh);
  const float* kb = bias ? bias + static_cast<size_t>(bh / s.H) * s.t
                         : nullptr;
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
    product_nt<kTile / 8>(sc, sQ + warp * 16 * ld, sK, ld, s.d);
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
        sP[(g + 8 * r) * ldp + n * 8 + c2 + (i & 1)] = p;
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
    product_nn<kTile>(acc, sP, ldp, sV, ld, s.d);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s.t) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* out = o + base + static_cast<size_t>(row[r]) * s.d;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
      if (n * 8 < s.d) {
        out[n * 8 + c2] = acc[n][2 * r] * inv;
        out[n * 8 + c2 + 1] = acc[n][2 * r + 1] * inv;
      }
    if (c2 == 0)
      lse[static_cast<size_t>(bh) * s.t + row[r]] =
          l[r] > 0.f ? m[r] + logf(fmaxf(l[r], 1e-30f)) : kNegInf;
  }
}

// -- backward, float32: dQ ------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, const float* __restrict__ bias,
              const int* __restrict__ bounds, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = s.d + kPad, ldp = kTile + kPad;
  float* sQ = reinterpret_cast<float*>(smem);
  float* sO = sQ + kTile * ld;  // dO rows
  float* sK = sO + kTile * ld;
  float* sV = sK + kTile * ld;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  float* sS = sV + kTile * ld + warp * 16 * ldp;  // this warp's dS rows
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * s.t * s.d;
  const int* bnd = doc_bounds(bounds, s, bh);
  const float* kb = bias ? bias + static_cast<size_t>(bh / s.H) * s.t
                         : nullptr;
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
    product_nt<kTile / 8>(sc, sQ + warp * 16 * ld, sK, ld, s.d);
    product_nt<kTile / 8>(dp, sO + warp * 16 * ld, sV, ld, s.d);
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
        sS[(g + 8 * r) * ldp + n * 8 + c2 + (i & 1)] = ds;
      }
    __syncwarp();
    product_nn<kTile>(acc, sS, ldp, sK, ld, s.d);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= s.t) continue;
    float* out = dq + base + static_cast<size_t>(row[r]) * s.d;
#pragma unroll
    for (int n = 0; n < kDMax / 8; ++n)
      if (n * 8 < s.d) {
        out[n * 8 + c2] = acc[n][2 * r];
        out[n * 8 + c2 + 1] = acc[n][2 * r + 1];
      }
  }
}

// -- backward, float32: dK and dV ----------------------------------------------

__global__ void __launch_bounds__(kThreads)
    dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, const float* __restrict__ bias,
               const int* __restrict__ bounds, Shape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = s.d + kPad, ldp = kTileQ + kPad;
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + kTile * ld;
  float* sQ = sV + kTile * ld;
  float* sO = sQ + kTileQ * ld;  // dO rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  float* sP = sO + kTileQ * ld + warp * 16 * ldp;              // P^T
  float* sS = sO + kTileQ * ld + (kWarps + warp) * 16 * ldp;   // dS^T
  float* sL = sO + kTileQ * ld + 2 * kWarps * 16 * ldp;
  float* sD = sL + kTileQ;
  int* sId = reinterpret_cast<int*>(sD + kTileQ);
  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(bh) * s.t * s.d;
  const int* bnd = doc_bounds(bounds, s, bh);
  const float* kb = bias ? bias + static_cast<size_t>(bh / s.H) * s.t
                         : nullptr;
  int lo, hi;
  q_range(s, bnd, k0, kTile, kTileQ, &lo, &hi);
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
    product_nt<kTileQ / 8>(st, sK + warp * 16 * ld, sQ, ld, s.d);
    product_nt<kTileQ / 8>(dpt, sV + warp * 16 * ld, sO, ld, s.d);
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
        sP[(g + 8 * r) * ldp + qc] = p;
        sS[(g + 8 * r) * ldp + qc] = ds;
      }
    __syncwarp();
    product_nn<kTileQ>(accV, sP, ldp, sO, ld, s.d);
    product_nn<kTileQ>(accK, sS, ldp, sQ, ld, s.d);
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
          dk[at + n * 8 + c2 + e] = accK[n][2 * r + e];
          dv[at + n * 8 + c2 + e] = accV[n][2 * r + e];
        }
  }
}

// -- bf16: the Hopper machinery ------------------------------------------------

constexpr int kBM = 128;              // rows of a work item's tile (2 x 64)
constexpr int kBN = 128;              // keys per K/V tile of fwd and dQ
constexpr int kBQ = 64;               // query rows per Q/dO tile of dK/dV
constexpr int kStages = 3;            // the forward's K/V ring depth
constexpr int kWgThreads = 128;       // one warpgroup
constexpr int kWsThreads = 3 * kWgThreads;  // producer + two consumers
constexpr uint32_t kPanelRowBytes = 128;  // one 64-column bf16 row of a panel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TMA's 128-byte swizzle repeats every 1024 bytes: the dynamic shared
// memory's base rounded up to it (the kernels ask for 1024 bytes more).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// One arrival that also tells the barrier how many bytes TMA will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// A [64 columns, rows, 1] box of a [B*H, T, D] bf16 tensor into shared memory
// at (column c0, row c1, head c2); out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// All 64-column panels of one tile (rows from row0 of head bh), each
// `panel` bytes apart, completing on `bar`.
template <int Panels>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, uint32_t panel,
                                         int row0, int bh) {
#pragma unroll
  for (int p = 0; p < Panels; ++p)
    tma_load(dst + p * panel, map, bar, 64 * p, row0, bh);
}

// wgmma shared-memory descriptor for a 128-byte swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = SW128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous region (issue ... wait).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for wgmma's register A operand, which must stay untouched (and
// its registers unreused) until the product that reads it has completed.
template <int K>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// The value, hidden from the optimizer: what is computed from it stays where
// it is written instead of being hoisted out of the loop around it.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An m64nNk16 accumulator (N / 2 floats per thread, 4 per 8 columns) as
// wgmma's register A operand: bf16 pairs, 4 registers per 16 columns.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&c)[N / 2]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    a[n >> 1][(n & 1) * 2] = pack_bf16(c[n * 4], c[n * 4 + 1]);
    a[n >> 1][(n & 1) * 2 + 1] = pack_bf16(c[n * 4 + 2], c[n * 4 + 3]);
  }
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory;
// accumulate is false: d = A B
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// accumulate is false: d = A B
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A in registers (bf16 pairs), B
// MN-major in shared memory (transposed on read)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory (transposed on read)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x DP] += A[64 x 16] B[16 x DP]: A in registers, B MN-major with its
// DP columns in 64-column panels
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_n64(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_n128(d, a, b);
}

// Named barriers 1 and 2 take turns between the consumer warpgroups: a
// warpgroup issues its products only in its turn, then hands the turn over,
// so one warpgroup's products run while the other computes elementwise.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(2 * kWgThreads)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - wg), "n"(2 * kWgThreads)
               : "memory");
}
// Named barriers 3 and 4: the four warps of one consumer warpgroup.
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + wg), "n"(kWgThreads)
               : "memory");
}

// One arrival per warp on an empty barrier once the warp is done reading.
__device__ __forceinline__ void warp_release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The CTA's 128-row tiles (query tiles of fwd and dQ, key tiles of dK/dV):
// work item i is head i / pairs and the tile pair (n - 1 - p, p),
// p = i % pairs, so that under the causal mask every item costs the same
// number of inner tiles (n + 1 KV tiles of a query pair); a CTA takes the
// items blockIdx.x, + gridDim.x, ... (one CTA per SM stays resident and
// walks them, its loads running ahead across tile boundaries).
template <class Fn>
__device__ __forceinline__ void for_each_tile(const Shape& s, Fn&& fn) {
  const int n_qt = (s.t + kBM - 1) / kBM, pairs = (n_qt + 1) / 2;
  const int items = s.bh * pairs;
  int seq = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int bh = i / pairs, p = i % pairs;
    // one call site, so that the tile's code is inlined once
    for (int k = 0; k < (p == n_qt - 1 - p ? 1 : 2); ++k)
      fn(bh, k == 0 ? n_qt - 1 - p : p, seq++);
  }
}

// Shared memory and barriers of a kernel that walks 128-row query tiles
// (the forward, NQ = 1: Q; dQ, NQ = 2: Q and dO): the query-side tiles
// [panels][128 rows][64], then Stages K tiles and Stages V tiles
// [panels][128 keys][64], each panel 128-byte swizzled by TMA (1024-byte
// aligned), then the barriers. DP: the head dim padded to whole 64-column
// panels (64 or 128).
template <int DP, int NQ, int Stages>
struct QueryRing {
  static constexpr int kPanels = DP / 64;
  static constexpr uint32_t kPanelQ = kBM * kPanelRowBytes;
  static constexpr uint32_t kPanelKV = kBN * kPanelRowBytes;
  static constexpr uint32_t kTileQ = kPanels * kPanelQ;
  static constexpr uint32_t kTileKV = kPanels * kPanelKV;
  static constexpr uint32_t kBars = NQ * kTileQ + 2 * Stages * kTileKV;
  static constexpr uint32_t kBytes = kBars + (2 + 4 * Stages) * 8 + 1024;

  unsigned char *q, *k, *v;
  uint64_t *full_q, *empty_q, *full_k, *full_v, *empty_k, *empty_v;

  __device__ explicit QueryRing(unsigned char* smem)
      : q(smem), k(smem + NQ * kTileQ), v(k + Stages * kTileKV) {
    full_q = reinterpret_cast<uint64_t*>(smem + kBars);
    empty_q = full_q + 1;
    full_k = full_q + 2;
    full_v = full_k + Stages;
    empty_k = full_v + Stages;
    empty_v = empty_k + Stages;
  }

  // by one thread, before the CTA's first __syncthreads
  __device__ void init() const {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 8);  // one arrival per consumer warp
    for (int st = 0; st < Stages; ++st) {
      mbar_init(&full_k[st], 1);
      mbar_init(&full_v[st], 1);
      mbar_init(&empty_k[st], 8);
      mbar_init(&empty_v[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The producer, one thread: the query-side tiles once per query tile,
  // then the tile's K/V range through the ring, running ahead into the
  // next query tile while the consumers finish this one.
  __device__ void produce(const Shape& s, const int* bounds,
                          const CUtensorMap* tq, const CUtensorMap* tdo,
                          const CUtensorMap* tk,
                          const CUtensorMap* tv) const {
    int it = 0;
    for_each_tile(s, [&](int bh, int qt, int seq) {
      int lo, hi;
      kv_range(s, doc_bounds(bounds, s, bh), qt * kBM, kBM, kBN, &lo, &hi);
      mbar_wait(empty_q, (seq & 1) ^ 1);
      mbar_expect_tx(full_q, NQ * kTileQ);
      tma_tile<kPanels>(q, tq, full_q, kPanelQ, qt * kBM, bh);
      if (NQ == 2)
        tma_tile<kPanels>(q + kTileQ, tdo, full_q, kPanelQ, qt * kBM, bh);
      for (int j = lo; j < hi; ++j, ++it) {
        const int st = it % Stages;
        const uint32_t parity = ((it / Stages) & 1) ^ 1;
        mbar_wait(&empty_k[st], parity);
        mbar_expect_tx(&full_k[st], kTileKV);
        tma_tile<kPanels>(k + st * kTileKV, tk, &full_k[st], kPanelKV,
                          j * kBN, bh);
        mbar_wait(&empty_v[st], parity);
        mbar_expect_tx(&full_v[st], kTileKV);
        tma_tile<kPanels>(v + st * kTileKV, tv, &full_v[st], kPanelKV,
                          j * kBN, bh);
      }
    });
  }
};

// -- forward, bf16: TMA ring, wgmma, P in registers ----------------------------

template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     const float* __restrict__ bias,
                     const int* __restrict__ bounds, Shape s) {
  using L = QueryRing<DP, 1, kStages>;
  extern __shared__ unsigned char smem_raw[];
  const L ring(align_1024(smem_raw));
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) ring.produce(s, bounds, &tq, nullptr, &tk, &tv);
  } else {
    // consumers: warpgroup cw owns rows q0 + 64 cw + [0, 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * kWgThreads;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const float scale2 = s.scale * kLog2e;
    const uint32_t q_addr = smem_u32(ring.q) + cw * 64 * kPanelRowBytes;
    float acc[DP / 2], sc[64];
    uint32_t pa[8][4];
    // S = Q K^T for the tile in stage st: 64 x 128 for this warpgroup, k
    // over the padded head dim (issued, not waited for)
    auto issue_s = [&](int st) {
      const uint32_t k_addr = smem_u32(ring.k + st * L::kTileKV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes
        wgmma_ss_n128(
            sc, sw128_desc(q_addr + (kk / 4) * L::kPanelQ + off, 16, 1024),
            sw128_desc(k_addr + (kk / 4) * L::kPanelKV + off, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V for the tile in stage st, V's rows (keys) the product's k
    auto issue_pv = [&](int st) {
      const uint32_t v_addr = smem_u32(ring.v + st * L::kTileKV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<DP>(acc, pa[kk],
                     sw128_desc(v_addr + kk * 16 * kPanelRowBytes,
                                L::kPanelKV, 1024));
      wgmma_commit();
    };

    if (cw == 1) turn_pass(cw);  // warpgroup 0 takes the first turn
    int it = 0;
    for_each_tile(s, [&](int bh, int qt, int seq) {
      const int q0 = qt * kBM, b = bh / s.H;
      const int* bnd = doc_bounds(bounds, s, bh);
      const float* kb = bias ? bias + static_cast<size_t>(b) * s.t : nullptr;
      int lo, hi;
      kv_range(s, bnd, q0, kBM, kBN, &lo, &hi);
      const int row_min = q0 + 64 * cw;
      const int row[2] = {row_min + 16 * warp + g,
                          row_min + 16 * warp + g + 8};
      int id[2] = {0, 0};
      if (bnd) {
#pragma unroll
        for (int r = 0; r < 2; ++r) id[r] = bnd[min(row[r], s.t - 1) * 3];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      // scores of KV tile j -> p in f32, in place, the running max and
      // sum, and the factor alpha by which the earlier O must be scaled
      auto softmax = [&](int j, float (&alpha)[2]) {
        const int c0 = j * kBN;
        float mt[2] = {-INFINITY, -INFINITY};
        // masks only where one can bite: tiles crossing the causal
        // diagonal or T, or with a bias or bounds
        if (kb || bnd || c0 + kBN > s.t ||
            (s.causal && c0 + kBN - 1 > row_min)) {
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i >> 1, col = c0 + n * 8 + c2 + (i & 1);
              float x = sc[n * 4 + i] * scale2;
              bool ok = col < s.t;
              if (ok && kb) x += kb[col] * kLog2e;
              if (s.causal) ok = ok && row[r] >= col;
              if (bnd) ok = ok && col < s.t && bnd[col * 3] == id[r];
              x = ok ? x : -INFINITY;
              sc[n * 4 + i] = x;
              mt[r] = fmaxf(mt[r], x);
            }
        } else {
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float x = sc[n * 4 + i] * scale2;
              sc[n * 4 + i] = x;
              mt[i >> 1] = fmaxf(mt[i >> 1], x);
            }
        }
        float msafe[2], lt[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mnew = fmaxf(m[r], quad_max(mt[r]));
          // a row whose every score is masked (or -1e30 by the bias)
          // keeps p = 0; its earlier tiles contributed nothing either
          msafe[r] = mnew <= kNegInf / 2 ? 0.f : mnew;
          alpha[r] = m[r] <= kNegInf / 2 ? 0.f : ex2(m[r] - msafe[r]);
          m[r] = mnew;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          sc[i] = ex2(sc[i] - msafe[(i >> 1) & 1]);
          lt[(i >> 1) & 1] += sc[i];
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(lt[r]);
      };

      mbar_wait(ring.full_q, seq & 1);
      // phase j: S of tile j (j < hi) and P V of tile j - 1 (j > lo) in
      // this warpgroup's turn, then tile j's softmax while the other
      // warpgroup's products run
      for (int j = lo; j <= hi; ++j, ++it) {
        const bool has_s = j < hi, has_pv = j > lo;
        const int st = it % kStages, sv = (it + kStages - 1) % kStages;
        if (has_s) mbar_wait(&ring.full_k[st], (it / kStages) & 1);
        if (has_pv) mbar_wait(&ring.full_v[sv], ((it - 1) / kStages) & 1);
        fence_regs(acc);  // O and P are defined before the products start
        fence_regs(pa);
        fence_regs(sc);
        turn_wait(cw);
        if (has_s) issue_s(st);
        if (has_pv) issue_pv(sv);
        turn_pass(cw);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(pa);
        if (has_s) warp_release(&ring.empty_k[st]);
        if (has_pv) warp_release(&ring.empty_v[sv]);
        if (j == hi - 1 || lo == hi) warp_release(ring.empty_q);  // Q read
        if (has_s) {
          float alpha[2];
          softmax(j, alpha);
#pragma unroll
          for (int n = 0; n < DP / 8; ++n) {
            acc[n * 4 + 0] *= alpha[0];
            acc[n * 4 + 1] *= alpha[0];
            acc[n * 4 + 2] *= alpha[1];
            acc[n * 4 + 3] *= alpha[1];
          }
          pack_a<kBN>(pa, sc);  // P in bf16 as wgmma's A fragments
        }
      }
      --it;  // the last phase loaded no tile

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= s.t) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* out = o + static_cast<size_t>(bh) * s.t * s.d +
                             static_cast<size_t>(row[r]) * s.d;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
          if (n * 8 < s.d)
            *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + c2) =
                __floats2bfloat162_rn(acc[n * 4 + 2 * r] * inv,
                                      acc[n * 4 + 2 * r + 1] * inv);
        if (c2 == 0)
          lse[static_cast<size_t>(bh) * s.t + row[r]] =
              l[r] > 0.f ? m[r] * kLn2 + logf(l[r]) : kNegInf;
      }
    });
    if (cw == 0) turn_wait(cw);  // the other warpgroup's last hand-over
  }
}

// -- dQ, bf16: the forward's ring with dO beside Q, dS in registers ------------

// K/V ring depth of dQ: Q and dO take 2 x 32 KB at d 128, which leaves
// room for two stages of K and V (64 KB a stage) in 227 KB; three at d 64.
template <int DP>
struct DqDepth {
  static constexpr int kValue = DP == 128 ? 2 : 3;
};

template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq,
                    const float* __restrict__ bias,
                    const int* __restrict__ bounds, Shape s) {
  constexpr int kDepth = DqDepth<DP>::kValue;
  using L = QueryRing<DP, 2, kDepth>;
  extern __shared__ unsigned char smem_raw[];
  const L ring(align_1024(smem_raw));
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) ring.produce(s, bounds, &tq, &tdo, &tk, &tv);
  } else {
    // consumers: warpgroup cw owns rows q0 + 64 cw + [0, 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * kWgThreads;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const float scale2 = s.scale * kLog2e;
    const uint32_t q_addr = smem_u32(ring.q) + cw * 64 * kPanelRowBytes;
    const uint32_t do_addr = q_addr + L::kTileQ;
    float acc[DP / 2], sc[64], dp[64];
    uint32_t da[8][4];
    // S = Q K^T and dP = dO V^T for the tiles in stage st: 64 x 128 each
    // for this warpgroup, k over the padded head dim
    auto issue_sdp = [&](int st) {
      const uint32_t k_addr = smem_u32(ring.k + st * L::kTileKV);
      const uint32_t v_addr = smem_u32(ring.v + st * L::kTileKV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::kPanelQ + (kk & 3) * 32;
        const uint32_t koff = (kk / 4) * L::kPanelKV + (kk & 3) * 32;
        wgmma_ss_n128(sc, sw128_desc(q_addr + off, 16, 1024),
                      sw128_desc(k_addr + koff, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::kPanelQ + (kk & 3) * 32;
        const uint32_t koff = (kk / 4) * L::kPanelKV + (kk & 3) * 32;
        wgmma_ss_n128(dp, sw128_desc(do_addr + off, 16, 1024),
                      sw128_desc(v_addr + koff, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K for the tile in stage st, K's rows (keys) the product's k
    auto issue_dq = [&](int st) {
      const uint32_t k_addr = smem_u32(ring.k + st * L::kTileKV);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<DP>(acc, da[kk],
                     sw128_desc(k_addr + kk * 16 * kPanelRowBytes,
                                L::kPanelKV, 1024));
      wgmma_commit();
    };

    if (cw == 1) turn_pass(cw);  // warpgroup 0 takes the first turn
    int it = 0;
    for_each_tile(s, [&](int bh, int qt, int seq) {
      const int q0 = qt * kBM;
      const int* bnd = doc_bounds(bounds, s, bh);
      const float* kb =
          bias ? bias + static_cast<size_t>(bh / s.H) * s.t : nullptr;
      int lo, hi;
      kv_range(s, bnd, q0, kBM, kBN, &lo, &hi);
      const int row_min = q0 + 64 * cw;
      const int row[2] = {row_min + 16 * warp + g,
                          row_min + 16 * warp + g + 8};
      // per row: lse * log2(e), +inf where p must be 0 (no softmax mass,
      // or past T), and delta
      int id[2] = {0, 0};
      float lse2[2] = {INFINITY, INFINITY}, dl[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < s.t) {
          const size_t at = static_cast<size_t>(bh) * s.t + row[r];
          const float x = lse[at];
          if (x > kNegInf / 2) lse2[r] = x * kLog2e;
          dl[r] = delta[at];
          if (bnd) id[r] = bnd[row[r] * 3];
        }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

      mbar_wait(ring.full_q, seq & 1);
      for (int j = lo; j < hi; ++j, ++it) {
        const int st = it % kDepth;
        const uint32_t parity = (it / kDepth) & 1;
        mbar_wait(&ring.full_k[st], parity);
        mbar_wait(&ring.full_v[st], parity);
        fence_regs(sc);
        fence_regs(dp);
        turn_wait(cw);
        issue_sdp(st);
        turn_pass(cw);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        warp_release(&ring.empty_v[st]);             // V read for good
        if (j == hi - 1) warp_release(ring.empty_q);  // Q and dO too
        // ds = p (dp - delta) scale, p = 2^(s scale log2(e) - lse log2(e));
        // masks only where one can bite
        const int c0 = j * kBN;
        if (kb || bnd || c0 + kBN > s.t ||
            (s.causal && c0 + kBN - 1 > row_min)) {
#pragma unroll
          for (int n = 0; n < 16; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i >> 1, col = c0 + n * 8 + c2 + (i & 1);
              float x = fmaf(sc[n * 4 + i], scale2, -lse2[r]);
              bool ok = col < s.t;
              if (ok && kb) x += kb[col] * kLog2e;
              if (s.causal) ok = ok && row[r] >= col;
              if (bnd) ok = ok && col < s.t && bnd[col * 3] == id[r];
              const float p = ok ? ex2(x) : 0.f;
              dp[n * 4 + i] = p * (dp[n * 4 + i] - dl[r]) * s.scale;
            }
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            const int r = (i >> 1) & 1;
            const float p = ex2(fmaf(sc[i], scale2, -lse2[r]));
            dp[i] = p * (dp[i] - dl[r]) * s.scale;
          }
        }
        pack_a<kBN>(da, dp);  // dS in bf16 as wgmma's A fragments
        fence_regs(acc);
        fence_regs(da);
        turn_wait(cw);
        issue_dq(st);
        turn_pass(cw);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(da);
        warp_release(&ring.empty_k[st]);  // K read for good
      }
      if (lo == hi) warp_release(ring.empty_q);

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row[r] >= s.t) continue;
        __nv_bfloat16* out = dq + static_cast<size_t>(bh) * s.t * s.d +
                             static_cast<size_t>(row[r]) * s.d;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
          if (n * 8 < s.d)
            *reinterpret_cast<__nv_bfloat162*>(out + n * 8 + c2) =
                __floats2bfloat162_rn(acc[n * 4 + 2 * r],
                                      acc[n * 4 + 2 * r + 1]);
      }
    });
    if (cw == 0) turn_wait(cw);  // the other warpgroup's last hand-over
  }
}

// -- dK/dV, bf16: K and V once per key tile, a Q/dO ring, P^T and dS^T in
// registers -------------------------------------------------------------------

// Shared memory of dkv_wgmma_kernel: K and V of the 128-key tile
// [panels][128 keys][64] (at the end, each consumer warpgroup stages its
// dK and dV in its own 64 rows of them), then kDepth stages of Q and dO
// [panels][64 queries][64], each panel 128-byte swizzled by TMA (1024-byte
// aligned), then per stage the 64 query rows' lse * log2(e), delta and
// document ids, then the barriers.
template <int DP>
struct KeyRing {
  static constexpr int kPanels = DP / 64;
  static constexpr int kDepth = 3;
  static constexpr uint32_t kPanelKV = kBN * kPanelRowBytes;
  static constexpr uint32_t kPanelQ = kBQ * kPanelRowBytes;
  static constexpr uint32_t kTileKV = kPanels * kPanelKV;
  static constexpr uint32_t kTileQ = kPanels * kPanelQ;
  static constexpr uint32_t kRows = 2 * kTileKV + 2 * kDepth * kTileQ;
  static constexpr uint32_t kRowBytes = 3 * kBQ * 4;
  static constexpr uint32_t kBars = kRows + kDepth * kRowBytes;
  static constexpr uint32_t kBytes = kBars + (2 + 2 * kDepth) * 8 + 1024;

  unsigned char *k, *v, *qdo;
  float* rows;
  uint64_t *full_kv, *empty_kv, *full_q, *empty_q;

  __device__ explicit KeyRing(unsigned char* smem)
      : k(smem), v(smem + kTileKV), qdo(smem + 2 * kTileKV),
        rows(reinterpret_cast<float*>(smem + kRows)) {
    full_kv = reinterpret_cast<uint64_t*>(smem + kBars);
    empty_kv = full_kv + 1;
    full_q = full_kv + 2;
    empty_q = full_q + kDepth;
  }
  __device__ unsigned char* q(int st) const { return qdo + st * 2 * kTileQ; }
  __device__ unsigned char* dout(int st) const { return q(st) + kTileQ; }
  // stage st's row arrays: lse * log2(e) [64], delta [64], ids [64]
  __device__ float* row_lse(int st) const { return rows + st * 3 * kBQ; }
  __device__ float* row_delta(int st) const { return row_lse(st) + kBQ; }
  __device__ int* row_id(int st) const {
    return reinterpret_cast<int*>(row_lse(st) + 2 * kBQ);
  }

  __device__ void init() const {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 8);  // one arrival per consumer warp
    for (int st = 0; st < kDepth; ++st) {
      // TMA's arrival and one per lane of the warp that writes the rows
      mbar_init(&full_q[st], 1 + 32);
      mbar_init(&empty_q[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
    dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     const float* __restrict__ bias,
                     const int* __restrict__ bounds, Shape s) {
  using L = KeyRing<DP>;
  constexpr int kDepth = L::kDepth;
  extern __shared__ unsigned char smem_raw[];
  const L ring(align_1024(smem_raw));
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 0) {
    // At 24 registers the two producer loops keep a few words of loop
    // state in local memory (what ptxas -v counts as this kernel's
    // spills, reloaded once per query tile, off the products' path).
    // More registers here cost the consumers theirs: 40/232 ran about a
    // quarter slower at the train shape (ops/flash_variants.py), and
    // 32/240, the whole register file, never started.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      // TMA: K and V once per key tile, Q and dO per query tile; the
      // first stages of a key tile's queries are requested before its
      // K and V, whose buffer frees only when the previous tile is stored
      int it = 0;
      for_each_tile(s, [&](int bh, int kt, int seq) {
        int lo, hi;
        q_range(s, doc_bounds(bounds, s, bh), kt * kBN, kBN, kBQ, &lo, &hi);
        auto load_q = [&](int j) {
          const int st = it % kDepth;
          mbar_wait(&ring.empty_q[st], ((it / kDepth) & 1) ^ 1);
          mbar_expect_tx(&ring.full_q[st], 2 * L::kTileQ);
          tma_tile<L::kPanels>(ring.q(st), &tq, &ring.full_q[st],
                               L::kPanelQ, j * kBQ, bh);
          tma_tile<L::kPanels>(ring.dout(st), &tdo, &ring.full_q[st],
                               L::kPanelQ, j * kBQ, bh);
          ++it;
        };
        const int ahead = min(lo + kDepth, hi);
        for (int j = lo; j < ahead; ++j) load_q(j);
        mbar_wait(ring.empty_kv, (seq & 1) ^ 1);
        mbar_expect_tx(ring.full_kv, 2 * L::kTileKV);
        tma_tile<L::kPanels>(ring.k, &tk, ring.full_kv, L::kPanelKV,
                             kt * kBN, bh);
        tma_tile<L::kPanels>(ring.v, &tv, ring.full_kv, L::kPanelKV,
                             kt * kBN, bh);
        for (int j = ahead; j < hi; ++j) load_q(j);
      });
    } else if (warp == 1) {
      // the query rows' lse * log2(e) (+inf where p must be 0: no softmax
      // mass, or past T), delta and document ids, per stage
      int it = 0;
      for_each_tile(s, [&](int bh, int kt, int seq) {
        const int* bnd = doc_bounds(bounds, s, bh);
        int lo, hi;
        q_range(s, bnd, kt * kBN, kBN, kBQ, &lo, &hi);
        for (int j = lo; j < hi; ++j, ++it) {
          const int st = it % kDepth;
          mbar_wait(&ring.empty_q[st], ((it / kDepth) & 1) ^ 1);
          for (int i = lane; i < kBQ; i += 32) {
            const int qr = j * kBQ + i;
            float l2 = INFINITY, dd = 0.f;
            int id = 0;
            if (qr < s.t) {
              const size_t at = static_cast<size_t>(bh) * s.t + qr;
              const float x = lse[at];
              if (x > kNegInf / 2) l2 = x * kLog2e;
              dd = delta[at];
              if (bnd) id = bnd[qr * 3];
            }
            ring.row_lse(st)[i] = l2;
            ring.row_delta(st)[i] = dd;
            ring.row_id(st)[i] = id;
          }
          mbar_arrive(&ring.full_q[st]);
        }
      });
    }
  } else {
    // consumers: warpgroup cw owns keys k0 + 64 cw + [0, 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * kWgThreads;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c2 = (lane & 3) * 2;
    const float scale2 = s.scale * kLog2e;
    const uint32_t k_addr = smem_u32(ring.k) + cw * 64 * kPanelRowBytes;
    const uint32_t v_addr = smem_u32(ring.v) + cw * 64 * kPanelRowBytes;
    float acc_k[DP / 2], acc_v[DP / 2];
    // S^T = K Q^T and dP^T = V dO^T for the query tile in stage st: 64
    // keys x 64 queries each for this warpgroup, k over the head dim
    auto issue_sdp = [&](int st, float (&sc)[32], float (&dp)[32]) {
      // one descriptor per operand, advanced by immediate offsets in its
      // 16-byte address field; opaque, so that the compiler does not keep
      // all the steps' descriptors in registers across the loop
      const uint64_t kd = opaque(sw128_desc(k_addr, 16, 1024));
      const uint64_t vd = opaque(sw128_desc(v_addr, 16, 1024));
      const uint64_t qd = sw128_desc(smem_u32(ring.q(st)), 16, 1024);
      const uint64_t od = qd + (L::kTileQ >> 4);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a = ((kk / 4) * L::kPanelKV + (kk & 3) * 32) >> 4;
        const uint32_t b = ((kk / 4) * L::kPanelQ + (kk & 3) * 32) >> 4;
        wgmma_ss_n64(sc, kd + a, qd + b, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a = ((kk / 4) * L::kPanelKV + (kk & 3) * 32) >> 4;
        const uint32_t b = ((kk / 4) * L::kPanelQ + (kk & 3) * 32) >> 4;
        wgmma_ss_n64(dp, vd + a, od + b, kk > 0);
      }
      wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q, the query rows the products' k
    auto issue_dkv = [&](int st, const uint32_t (&pa)[4][4],
                         const uint32_t (&da)[4][4]) {
      const uint64_t qd =
          opaque(sw128_desc(smem_u32(ring.q(st)), L::kPanelQ, 1024));
      const uint64_t od = qd + (L::kTileQ >> 4);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)  // 16 query rows = 2048 bytes
        wgmma_rs<DP>(acc_v, pa[kk], od + kk * (16 * kPanelRowBytes >> 4));
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<DP>(acc_k, da[kk], qd + kk * (16 * kPanelRowBytes >> 4));
      wgmma_commit();
    };
    // this warpgroup's dK (or dV) rows into its rows of the K (or V) tile,
    // in the tile's swizzled layout: 16-byte chunk c of row r at c ^ (r & 7)
    auto stage_out = [&](unsigned char* tile, const float (&acc)[DP / 2]) {
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 64 * cw + 16 * warp + g + 8 * r;
          *reinterpret_cast<uint32_t*>(
              tile + (n / 8) * L::kPanelKV + row * kPanelRowBytes +
              (((n & 7) ^ (row & 7)) << 4) + c2 * 2) =
              pack_bf16(acc[n * 4 + 2 * r], acc[n * 4 + 2 * r + 1]);
        }
    };

    if (cw == 1) turn_pass(cw);  // warpgroup 0 takes the first turn
    int it = 0;
    for_each_tile(s, [&](int bh, int kt, int seq) {
      const int k0 = kt * kBN, kw0 = k0 + 64 * cw;
      const int* bnd = doc_bounds(bounds, s, bh);
      const float* kb =
          bias ? bias + static_cast<size_t>(bh / s.H) * s.t : nullptr;
      int lo, hi;
      q_range(s, bnd, k0, kBN, kBQ, &lo, &hi);
      // this thread's key rows (rows of S^T), their ids and bias * log2(e)
      const int key[2] = {kw0 + 16 * warp + g, kw0 + 16 * warp + g + 8};
      int kid[2] = {0, 0};
      float kb2[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (key[r] < s.t) {
          if (bnd) kid[r] = bnd[key[r] * 3];
          if (kb) kb2[r] = kb[key[r]] * kLog2e;
        }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

      mbar_wait(ring.full_kv, seq & 1);
      for (int j = lo; j < hi; ++j, ++it) {
        const int st = it % kDepth, q0 = j * kBQ;
        mbar_wait(&ring.full_q[st], (it / kDepth) & 1);
        if (s.causal && q0 + kBQ - 1 < kw0) {
          // a block wholly above the causal diagonal adds nothing: pass
          // both turns
          turn_wait(cw);
          turn_pass(cw);
          turn_wait(cw);
          turn_pass(cw);
          warp_release(&ring.empty_q[st]);
          continue;
        }
        // S^T and dP^T, then P^T and dS^T live only inside this tile's
        // body: declared outside it, they would hold their registers
        // across the dV and dK products too
        float sc[32], dp[32];
        turn_wait(cw);
        issue_sdp(st, sc, dp);
        turn_pass(cw);
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        // p = 2^(s^T scale log2(e) + bias log2(e) - lse log2(e)),
        // ds = p (dp - delta) scale; element (n, i) is key row key[i >> 1]
        // and query column q0 + 8 n + c2 + (i & 1)
        const float* l2 = ring.row_lse(st);
        const float* dd = ring.row_delta(st);
        if (bnd || (s.causal && q0 < kw0 + 63)) {
          const int* qid = ring.row_id(st);
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i >> 1, c = 8 * n + c2 + (i & 1);
              // the row arrays always hold ids (0 without bounds), so
              // both tests read unconditionally and select, not branch
              const bool ok = (!s.causal | (q0 + c >= key[r])) &
                              (!bnd | (qid[c] == kid[r]));
              const float e =
                  ex2(fmaf(sc[n * 4 + i], scale2, kb2[r] - l2[c]));
              const float p = ok ? e : 0.f;
              sc[n * 4 + i] = p;
              dp[n * 4 + i] = p * (dp[n * 4 + i] - dd[c]) * s.scale;
            }
        } else {
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 l =
                *reinterpret_cast<const float2*>(l2 + 8 * n + c2);
            const float2 d =
                *reinterpret_cast<const float2*>(dd + 8 * n + c2);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i >> 1;
              const float p = ex2(fmaf(sc[n * 4 + i], scale2,
                                       kb2[r] - ((i & 1) ? l.y : l.x)));
              sc[n * 4 + i] = p;
              dp[n * 4 + i] =
                  p * (dp[n * 4 + i] - ((i & 1) ? d.y : d.x)) * s.scale;
            }
          }
        }
        uint32_t pa[4][4], da[4][4];  // P^T and dS^T as wgmma's A operand
        pack_a<kBQ>(pa, sc);
        pack_a<kBQ>(da, dp);
        fence_regs(acc_k);
        fence_regs(acc_v);
        fence_regs(pa);
        fence_regs(da);
        turn_wait(cw);
        issue_dkv(st, pa, da);
        turn_pass(cw);
        wgmma_wait<0>();
        fence_regs(acc_k);
        fence_regs(acc_v);
        fence_regs(pa);
        fence_regs(da);
        warp_release(&ring.empty_q[st]);
      }

      // dK and dV: staged in this warpgroup's rows of the K and V tiles
      // (its own products read no other rows), then stored as 16-byte
      // vectors, rows past T and columns past d left out
      stage_out(ring.k, acc_k);
      stage_out(ring.v, acc_v);
      warpgroup_sync(cw);
      constexpr int kChunks = DP / 8;  // 16-byte chunks per row
      for (int c = tid; c < 64 * kChunks; c += kWgThreads) {
        const int row = c / kChunks, ch = c % kChunks;
        const int key_row = kw0 + row;
        if (key_row >= s.t || ch * 8 >= s.d) continue;
        const uint32_t off = (ch / 8) * L::kPanelKV +
                             (64 * cw + row) * kPanelRowBytes +
                             (((ch & 7) ^ (row & 7)) << 4);
        const size_t at = (static_cast<size_t>(bh) * s.t + key_row) * s.d +
                          ch * 8;
        *reinterpret_cast<uint4*>(dk + at) =
            *reinterpret_cast<const uint4*>(ring.k + off);
        *reinterpret_cast<uint4*>(dv + at) =
            *reinterpret_cast<const uint4*>(ring.v + off);
      }
      // the next TMA load into these tiles follows generic-proxy accesses
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warp_release(ring.empty_kv);
    });
    if (cw == 0) turn_wait(cw);  // the other warpgroup's last hand-over
  }
}

// -- launchers ------------------------------------------------------------------

size_t f32_fwd_smem(int d) {
  return (3 * kTile * (d + kPad) + kWarps * 16 * (kTile + kPad)) *
         sizeof(float);
}
size_t f32_dq_smem(int d) {
  return (4 * kTile * (d + kPad) + kWarps * 16 * (kTile + kPad)) *
         sizeof(float);
}
size_t f32_dkv_smem(int d) {
  return (2 * (kTile + kTileQ) * (d + kPad) +
          2 * kWarps * 16 * (kTileQ + kPad)) * sizeof(float) +
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

// cuTensorMapEncodeTiled, a driver entry point, fetched through the runtime
// (cudaGetDriverEntryPoint) so the library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &got);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &got);
#endif
    return rc == cudaSuccess && got == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A [B*H, T, D] bf16 tensor read in boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzled; columns past D and rows past T read as zeros.
bool encode(CUtensorMap* map, const void* base, int bh, int t, int d,
            int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(t) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Grid of a warp-specialised bf16 kernel: one resident CTA per SM walks the
// work items (pairs of 128-row tiles), or fewer CTAs than SMs when there
// are fewer items.
int resident_grid(int b, int h, int t, int* grid) {
  int dev = 0, n_sm = 0;
  if (cudaError_t rc = cudaGetDevice(&dev)) return static_cast<int>(rc);
  if (cudaError_t rc = cudaDeviceGetAttribute(
          &n_sm, cudaDevAttrMultiProcessorCount, dev))
    return static_cast<int>(rc);
  *grid = min(b * h * (((t + kBM - 1) / kBM + 1) / 2), n_sm);
  return 0;
}

template <int DP>
int fwd_bf16(const void* q, const void* k, const void* v, void* o,
             void* lse, const void* bias, const void* bounds, int b, int h,
             int t, int d, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, b * h, t, d, kBM) || !encode(&tk, k, b * h, t, d, kBN) ||
      !encode(&tv, v, b * h, t, d, kBN))
    return -3;
  const size_t smem = QueryRing<DP, 1, kStages>::kBytes;
  if (int rc = prepare(fwd_wgmma_kernel<DP>, smem)) return rc;
  int grid = 0;
  if (int rc = resident_grid(b, h, t, &grid)) return rc;
  fwd_wgmma_kernel<DP><<<grid, kWsThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const float*>(bias), static_cast<const int*>(bounds),
      Shape{h, t, d, causal, scale, b * h});
  return static_cast<int>(cudaGetLastError());
}

int fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
            const void* bias, const void* bounds, int b, int h, int t, int d,
            int causal, float scale, cudaStream_t stream) {
  const size_t smem = f32_fwd_smem(d);
  if (int rc = prepare(fwd_kernel, smem)) return rc;
  const dim3 grid((t + kTile - 1) / kTile, b * h);
  fwd_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), static_cast<const float*>(bias),
      static_cast<const int*>(bounds), Shape{h, t, d, causal, scale});
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dq_bf16(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, const void* bias,
            const void* bounds, int b, int h, int t, int d, int causal,
            float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!encode(&tq, q, b * h, t, d, kBM) ||
      !encode(&tdo, dout, b * h, t, d, kBM) ||
      !encode(&tk, k, b * h, t, d, kBN) || !encode(&tv, v, b * h, t, d, kBN))
    return -3;
  const size_t smem = QueryRing<DP, 2, DqDepth<DP>::kValue>::kBytes;
  if (int rc = prepare(dq_wgmma_kernel<DP>, smem)) return rc;
  int grid = 0;
  if (int rc = resident_grid(b, h, t, &grid)) return rc;
  dq_wgmma_kernel<DP><<<grid, kWsThreads, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
      static_cast<const float*>(bias), static_cast<const int*>(bounds),
      Shape{h, t, d, causal, scale, b * h});
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv,
             const void* bias, const void* bounds, int b, int h, int t,
             int d, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv;
  if (!encode(&tq, q, b * h, t, d, kBQ) ||
      !encode(&tdo, dout, b * h, t, d, kBQ) ||
      !encode(&tk, k, b * h, t, d, kBN) || !encode(&tv, v, b * h, t, d, kBN))
    return -3;
  const size_t smem = KeyRing<DP>::kBytes;
  if (int rc = prepare(dkv_wgmma_kernel<DP>, smem)) return rc;
  int grid = 0;
  if (int rc = resident_grid(b, h, t, &grid)) return rc;
  dkv_wgmma_kernel<DP><<<grid, kWsThreads, smem, stream>>>(
      tq, tdo, tk, tv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<const float*>(bias),
      static_cast<const int*>(bounds), Shape{h, t, d, causal, scale, b * h});
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const void* bias,
           const void* bounds, int b, int h, int t, int d, int causal,
           float scale, cudaStream_t stream);

template <>
int bwd_dq<float>(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const void* bias, const void* bounds, int b,
                  int h, int t, int d, int causal, float scale,
                  cudaStream_t stream) {
  const size_t smem = f32_dq_smem(d);
  if (int rc = prepare(dq_kernel, smem)) return rc;
  const dim3 grid((t + kTile - 1) / kTile, b * h);
  dq_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<const float*>(bias),
      static_cast<const int*>(bounds), Shape{h, t, d, causal, scale});
  return static_cast<int>(cudaGetLastError());
}

template <>
int bwd_dq<__nv_bfloat16>(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, const void* bias,
                          const void* bounds, int b, int h, int t, int d,
                          int causal, float scale, cudaStream_t stream) {
  if (d <= 64)
    return dq_bf16<64>(q, k, v, dout, lse, delta, dq, bias, bounds, b, h, t,
                       d, causal, scale, stream);
  return dq_bf16<128>(q, k, v, dout, lse, delta, dq, bias, bounds, b, h, t,
                      d, causal, scale, stream);
}

template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const void* bias, const void* bounds, int b, int h, int t, int d,
            int causal, float scale, cudaStream_t stream);

template <>
int bwd_dkv<float>(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const void* bias, const void* bounds,
                   int b, int h, int t, int d, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = f32_dkv_smem(d);
  if (int rc = prepare(dkv_kernel, smem)) return rc;
  const dim3 grid((t + kTile - 1) / kTile, b * h);
  dkv_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const float*>(bias), static_cast<const int*>(bounds),
      Shape{h, t, d, causal, scale});
  return static_cast<int>(cudaGetLastError());
}

template <>
int bwd_dkv<__nv_bfloat16>(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv,
                           const void* bias, const void* bounds, int b, int h,
                           int t, int d, int causal, float scale,
                           cudaStream_t stream) {
  if (d <= 64)
    return dkv_bf16<64>(q, k, v, dout, lse, delta, dk, dv, bias, bounds, b,
                        h, t, d, causal, scale, stream);
  return dkv_bf16<128>(q, k, v, dout, lse, delta, dk, dv, bias, bounds, b, h,
                       t, d, causal, scale, stream);
}

}  // namespace

// C entry points: device pointers in, cudaGetLastError() out (-1 for a shape
// or dtype the kernels do not take, -3 if a TMA tensor map cannot be
// encoded). q, k, v, o, dO, dQ, dK, dV are contiguous
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
    return fwd_f32(q, k, v, o, lse, bias, bounds, b, h, t, d, causal, scale,
                   st);
  if (dtype == kBF16 && d <= 64)
    return fwd_bf16<64>(q, k, v, o, lse, bias, bounds, b, h, t, d, causal,
                        scale, st);
  if (dtype == kBF16)
    return fwd_bf16<128>(q, k, v, o, lse, bias, bounds, b, h, t, d, causal,
                         scale, st);
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
