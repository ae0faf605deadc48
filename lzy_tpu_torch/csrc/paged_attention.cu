// Paged attention through the page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_kernel` in lzy_tpu/ops/paged_attention.py
// (launched by `_pallas_paged_attention` on grid (batch row, kv head)). Same
// function: for every query row, read the row's K/V blocks straight out of the
// pooled cache by block id, score in f32 with d^-0.5 applied after the dot,
// mask pooled slot l unless l <= the query's absolute position (-1e30), take
// the full-row softmax, cast the probabilities to the compute dtype, and
// contract with V. int8 pools are dequantized inside the block loop as
// (q * scale + zp), rounded to the compute dtype, with per-position, per-head
// f32 sidecars. Output layout [B, T, KV, G, D] with head h = kv * G + g.
//
// Bound: decode (T = 1) and speculative verify (T = gamma + 1) are bound by
// device memory: per (row, kv head) the kernel must read every visible token's
// K and V once, bytes = visible tokens x KV x D x 2 (K and V) x bytes per
// element (+ 4 f32 sidecars per token and head for int8 pools). The Pallas
// version staged the whole per-head pool into VMEM and refused pools over
// 48 MiB; this kernel reads only the visible pages from HBM, loading the block
// id itself, so a multi-GiB pool costs nothing beyond the tokens a row sees.
//
// Design (simple and exact first; wgmma, TMA and split-K are later work):
// - one CTA per (tile of 16 query rows, kv head, batch row); the 16 rows are
//   (t, g) pairs t-major over g, so a decode row's G heads share one K/V sweep;
// - key slots are staged 32 at a time through shared memory in f32 with
//   16-byte vector loads, and only slots 0 .. max(position) of the tile are
//   visited (masked slots contribute exactly 0 in the reference);
// - two passes over K: pass 1 keeps each row's running max and sum, pass 2
//   recomputes the scores, normalizes p = exp(s - m) / l, rounds p to the
//   compute dtype (the reference casts before P.V) and accumulates P.V in f32;
//   both running sums (l and P.V) take each 32-slot block's sum with Kahan
//   compensation: a plain f32 running sum over the 8192 slots of a long row
//   drifted 5.7e-5 from a float64 evaluation where cuBLAS's blocked sum in
//   the plain version stayed within 7.8e-7 (idle row, int8 pool, f32; H100).
//   Reading K twice costs 1.5x the bound's bytes; it buys the reference's
//   rounding order (normalize, round, then contract).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 16;  // query rows (t * G + g) per CTA
constexpr int kBlk = 32;      // key slots staged per iteration (one per lane)
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round an f32 value to the compute dtype and back (no-op for f32).
template <typename IO>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename IO>
__device__ __forceinline__ IO from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte chunk of a pooled K/V row, widened to f32.
template <typename IO>
__device__ __forceinline__ void load_chunk(const float* src, float* dst,
                                           float, float) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

template <typename IO>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* src,
                                           float* dst, float, float) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
}

// int8: dequantize as the reference does, (q * scale + zp) in f32 with two
// roundings, then round to the compute dtype. The multiply and the add are
// kept apart (no fused multiply-add): the reference's scale is not always an
// exact power of two, so fusing could move the result by one ulp.
template <typename IO>
__device__ __forceinline__ void load_chunk(const int8_t* src, float* dst,
                                           float scale, float zp) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    dst[i] = round_to<IO>(__fadd_rn(__fmul_rn(static_cast<float>(c[i]), scale), zp));
}

template <typename IO, typename KV, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const IO* __restrict__ q, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ k_zp, const float* __restrict__ v_scale,
    const float* __restrict__ v_zp, const int* __restrict__ page_table,
    const int* __restrict__ positions, IO* __restrict__ out, int T, int H,
    int KVH, int n_blocks, int page, int P, float scale) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(KV));
  constexpr int CH = D / VEC;  // 16-byte chunks per pooled row
  constexpr int ROW_STEP = kThreads / D;
  constexpr int ACC = kRowTile * D / kThreads;
  static_assert(D % VEC == 0, "head dim must fill whole 16-byte chunks");
  static_assert(kThreads % D == 0, "threads must tile the head dim");
  static_assert(ACC * ROW_STEP == kRowTile, "accumulators must cover the tile");
  static_assert(kBlk == 32, "row statistics use one lane per staged slot");

  __shared__ float q_s[kRowTile][D];
  __shared__ float k_s[kBlk][D + 1];  // +1: conflict-free score reads
  __shared__ float v_s[kBlk][D];
  __shared__ float p_s[kRowTile][kBlk];
  __shared__ float m_s[kRowTile];
  __shared__ float l_s[kRowTile];
  __shared__ float lc_s[kRowTile];  // Kahan compensation of l_s
  __shared__ int pos_s[kRowTile];
  __shared__ int row_s[kBlk];  // pooled row (block, offset, head) per slot
  __shared__ int n_vis_s;

  const int tile = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / KVH;
  const int r0 = tile * kRowTile;
  const int rows = min(kRowTile, T * G - r0);
  const int L = P * page;

  for (int i = tid; i < kRowTile * D; i += kThreads) {
    const int r = i / D, e = i % D;
    float val = 0.f;
    if (r < rows) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      val = to_f32(q[((static_cast<size_t>(b) * T + t) * H + kvh * G + g) * D + e]);
    }
    q_s[r][e] = val;
  }
  if (tid < kRowTile) {
    int p = 0;
    if (tid < rows) p = positions[b * T + (r0 + tid) / G];
    pos_s[tid] = p;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    lc_s[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = 0;
    for (int r = 0; r < rows; ++r) mx = max(mx, pos_s[r]);
    n_vis_s = min(mx + 1, L);
  }
  __syncthreads();
  const int n_vis = n_vis_s;
  const int n_kb = (n_vis + kBlk - 1) / kBlk;

  // Stage slots [kb * kBlk, kb * kBlk + kBlk) of K (and V) into shared memory.
  auto stage = [&](int kb, bool with_v) {
    if (tid < kBlk) {
      const int lg = kb * kBlk + tid;
      int row = -1;
      if (lg < n_vis) {
        // clamp like the reference's gather (out-of-range ids read the last block)
        const int blk = min(max(page_table[b * P + lg / page], 0), n_blocks - 1);
        row = (blk * page + lg % page) * KVH + kvh;
      }
      row_s[tid] = row;
    }
    __syncthreads();
    for (int i = tid; i < kBlk * CH; i += kThreads) {
      const int l = i / CH, c = i % CH;
      const int row = row_s[l];
      float kb_f[VEC], vb_f[VEC];
      if (row >= 0) {
        float ks = 0.f, kz = 0.f, vs = 0.f, vz = 0.f;
        if (k_scale != nullptr) {
          ks = k_scale[row];
          kz = k_zp[row];
          vs = v_scale[row];
          vz = v_zp[row];
        }
        const size_t base = static_cast<size_t>(row) * D + c * VEC;
        load_chunk<IO>(k_pool + base, kb_f, ks, kz);
        if (with_v) load_chunk<IO>(v_pool + base, vb_f, vs, vz);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kb_f[j] = vb_f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) k_s[l][c * VEC + j] = kb_f[j];
      if (with_v) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) v_s[l][c * VEC + j] = vb_f[j];
      }
    }
    __syncthreads();
  };

  // Masked, scaled f32 scores of the staged slots into p_s.
  auto scores = [&](int kb) {
    for (int i = tid; i < kRowTile * kBlk; i += kThreads) {
      const int r = i / kBlk, l = i % kBlk;
      const int lg = kb * kBlk + l;
      float s = kNegInf;
      if (r < rows && lg < n_vis && lg <= pos_s[r]) {
        float acc = 0.f;
#pragma unroll 8
        for (int e = 0; e < D; ++e) acc += q_s[r][e] * k_s[l][e];
        s = acc * scale;  // scale after the dot, as the reference does
      }
      p_s[r][l] = s;
    }
    __syncthreads();
  };

  // Pass 1: running row max and sum of exp over all visible slots.
  const int warp = tid / 32, lane = tid % 32;
  for (int kb = 0; kb < n_kb; ++kb) {
    stage(kb, false);
    scores(kb);
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float s = p_s[r][lane];
      const float m_old = m_s[r];
      float bm = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, o));
      const float m_new = fmaxf(m_old, bm);
      float sum = expf(s - m_new);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        // compensated: a row over thousands of slots adds hundreds of
        // block sums, and a plain f32 running sum drifts ~1e-5 relative
        const float alpha = expf(m_old - m_new);
        const float l_old = l_s[r] * alpha;
        const float y = sum - lc_s[r] * alpha;
        const float t = l_old + y;
        lc_s[r] = (t - l_old) - y;
        l_s[r] = t;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
  }

  // Pass 2: normalized probabilities, rounded to the compute dtype, times V.
  const int e = tid % D;
  const int rb = tid / D;
  float acc[ACC], comp[ACC];  // running sums and their Kahan compensation
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = comp[j] = 0.f;
  for (int kb = 0; kb < n_kb; ++kb) {
    stage(kb, true);
    scores(kb);
    for (int i = tid; i < kRowTile * kBlk; i += kThreads) {
      const int r = i / kBlk, l = i % kBlk;
      float p = 0.f;
      if (r < rows) p = round_to<IO>(expf(p_s[r][l] - m_s[r]) / l_s[r]);
      p_s[r][l] = p;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      const int r = rb + j * ROW_STEP;
      float part = 0.f;  // this block's 32 terms, then one compensated add
#pragma unroll 8
      for (int l = 0; l < kBlk; ++l) part += p_s[r][l] * v_s[l][e];
      const float y = part - comp[j];
      const float t = acc[j] + y;
      comp[j] = (t - acc[j]) - y;
      acc[j] = t;
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < ACC; ++j) {
    const int r = rb + j * ROW_STEP;
    if (r < rows) {
      const int t = (r0 + r) / G, g = (r0 + r) % G;
      out[(((static_cast<size_t>(b) * T + t) * KVH + kvh) * G + g) * D + e] =
          from_f32<IO>(acc[j]);
    }
  }
}

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *k_zp, *v_scale, *v_zp;
  const void *page_table, *positions;
  void* out;
  int B, T, H, KVH, n_blocks, page, P;
  float scale;
  cudaStream_t stream;
};

template <typename IO, typename KV, int D>
int launch(const Args& a) {
  const int rows = a.T * (a.H / a.KVH);
  const dim3 grid((rows + kRowTile - 1) / kRowTile, a.KVH, a.B);
  paged_attention_kernel<IO, KV, D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const IO*>(a.q), static_cast<const KV*>(a.k_pool),
      static_cast<const KV*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.k_zp), static_cast<const float*>(a.v_scale),
      static_cast<const float*>(a.v_zp), static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.positions), static_cast<IO*>(a.out), a.T, a.H,
      a.KVH, a.n_blocks, a.page, a.P, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO, typename KV>
int dispatch_head_dim(int d, const Args& a) {
  switch (d) {
    case 16: return launch<IO, KV, 16>(a);
    case 32: return launch<IO, KV, 32>(a);
    case 64: return launch<IO, KV, 64>(a);
    case 128: return launch<IO, KV, 128>(a);
    default: return -2;
  }
}

}  // namespace

// Returns 0 on a clean launch, cudaGetLastError() otherwise, -1 for an
// unsupported dtype pair and -2 for an unsupported head dim.
extern "C" int lzy_paged_attention(
    int io_dtype, int kv_dtype, int head_dim, const void* q,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* k_zp, const void* v_scale, const void* v_zp,
    const void* page_table, const void* positions, void* out, int B, int T,
    int H, int KVH, int n_blocks, int page, int P, float scale,
    void* stream) {
  const Args a{q, k_pool, v_pool, k_scale, k_zp, v_scale, v_zp,
               page_table, positions, out, B, T, H, KVH, n_blocks, page, P,
               scale, static_cast<cudaStream_t>(stream)};
  if (io_dtype == kF32 && kv_dtype == kF32)
    return dispatch_head_dim<float, float>(head_dim, a);
  if (io_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, a);
  if (io_dtype == kF32 && kv_dtype == kI8)
    return dispatch_head_dim<float, int8_t>(head_dim, a);
  if (io_dtype == kBF16 && kv_dtype == kI8)
    return dispatch_head_dim<__nv_bfloat16, int8_t>(head_dim, a);
  return -1;
}
