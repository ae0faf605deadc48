// Paged attention through the page table, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_pallas_kernel` in lzy_tpu/ops/paged_attention.py
// (launched by `_pallas_paged_attention` on grid (batch row, kv head)). Same
// function: for every query row, read the row's K/V blocks straight out of the
// pooled cache by block id, score in f32 with d^-0.5 applied after the dot,
// mask pooled slot l unless l <= the query's absolute position (-1e30), take
// the full-row softmax, cast the probabilities to the compute dtype, and
// contract with V. int8 pools are dequantized as (q * scale + zp), rounded to
// the compute dtype, with per-position, per-head f32 sidecars. Output layout
// [B, T, KV, G, D] with head h = kv * G + g.
//
// Bound: decode (T = 1) and speculative verify (T = gamma + 1) are bound by
// device memory: per (row, kv head) the kernel must read every visible token's
// K and V once, bytes = visible tokens x KV x D x 2 (K and V) x bytes per
// element (+ 4 f32 sidecars per token and head for int8 pools). The Pallas
// version staged the whole per-head pool into VMEM and refused pools over
// 48 MiB; these kernels read only the visible pages, loading the block id
// themselves, so a multi-GiB pool costs nothing beyond the tokens a row sees.
//
// Design: split-K over pages, in two passes, so that the probabilities are
// normalized and rounded to the compute dtype before P.V, in the
// reference's order:
// - work unit = (batch row, kv head, tile of RT query rows, split). The RT
//   rows are (t, g) pairs t-major over g, RT = 4 when T x G <= 4 (decode:
//   the G heads of one token share one K/V sweep, no idle rows) and 8
//   otherwise. The wrapper picks the number of splits S from the shapes
//   (ops/paged_attention.split_plan); split s of a tile takes its even share
//   of the tile's visible pages, whole pages only;
// - pass 1 (paged_stats): per split and row, the max and the sum of exp of
//   the scores, written to f32 scratch; where a slot's T x G f32 scores take
//   fewer bytes than its K row (decode, verify) the scores too, so that
//   pass 2 reads them instead of K;
// - pass 2 (paged_pv): every CTA combines all splits' (max, sum) of its rows
//   in split order, forms p = round(exp(s - max) / sum) and its partial P.V
//   in f32; with one split that is the output; with more, the tile's last
//   CTA to finish (an atomic ticket, zeroed by pass 1) sums every split's
//   partial in split order and rounds once. Every order is fixed, so
//   results repeat from run to run.
// Pass 2 is launched with programmatic dependent launch: its prologue
// (positions, block ids) runs while pass 1 finishes, and it waits for pass
// 1 (griddepcontrol.wait) before it reads pass 1's output.
// Inside a CTA (8 warps) a warp streams slots: a lane holds a 16- or
// 32-byte chunk of one slot's K (or V) row, D / chunk lanes share a slot, and
// the dot product is reduced by recursive halving (each lane ends with whole
// dot products of its own rows, so the softmax work runs once per row, not
// once per row per lane). The raw chunks of the next two batches of slots
// are in flight by cp.async into a per-thread ring in shared memory, so
// global latency is covered without holding loads in registers; the block
// ids of the split's pages are loaded once, into shared memory. Warps merge
// their rows' statistics and sums through shared memory once, at the end.
// With f32 compute the running sums take each term with Kahan compensation
// (a float64 evaluation of an 8192-slot idle row required it of the
// one-pass version); with bf16 compute the output is rounded to bf16 and
// plain f32 sums suffice. Either way p is the reference's exp(s - m) / l
// in f32, rounded once to the compute dtype.
//
// Times at chip_smoke.py's decode shape (8 rows, 32 heads over 8 KV heads,
// d 128, page 16, 5690 visible tokens, bf16; NVIDIA H100 80GB HBM3,
// 700 W): 0.364 ms for the one-pass kernel of one CTA per (16 rows, KV
// head, row), 0.0425 ms of device time for these two passes (0.061 ms a
// call as its caller sees it, the wrapper's host time included), against
// a byte bound of 0.0070 ms: what is left of the device time is each
// pass's fixed cost (two dependent global round trips before the first K
// load, the launch) and latency, not bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 64;  // splits of one page walk (ops/paged_attention)

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A lane's chunk of one pooled K/V row: its raw load (16 bytes, two for
// bf16 at 16 elements, 8 for int8 at 8) and its number of elements. Tiles of
// 4 rows take 16 elements a lane (bf16, int8), so that a warp covers 4 slots
// at once and the per-slot work (addressing, the reduction, the softmax)
// runs on fewer warps; 8-row tiles take 8, to leave registers for the
// accumulators of their 8 rows. f32 takes 4.
struct alignas(16) Uint4x2 {
  uint4 lo, hi;
};
template <typename KV, int RT>
struct Chunk;
template <int RT>
struct Chunk<float, RT> {
  using Raw = float4;
  static constexpr int kVec = 4;
};
template <int RT>
struct Chunk<__nv_bfloat16, RT> {
  using Raw = std::conditional_t<RT == 4, Uint4x2, uint4>;
  static constexpr int kVec = RT == 4 ? 16 : 8;
};
template <int RT>
struct Chunk<int8_t, RT> {
  using Raw = std::conditional_t<RT == 4, uint4, uint2>;
  static constexpr int kVec = RT == 4 ? 16 : 8;
};

// One pooled element in f32: f32 as is, bf16 widened, int8 dequantized as
// the reference does, (q * scale + zp) in f32 with two roundings, then
// rounded to the compute dtype. The multiply and the add are kept apart (no
// fused multiply-add): the reference's scale is not always an exact power of
// two, so fusing could move the result by one ulp.
template <typename IO>
__device__ __forceinline__ float element(float x, float, float) {
  return x;
}
template <typename IO>
__device__ __forceinline__ float element(__nv_bfloat16 x, float, float) {
  return __bfloat162float(x);
}
template <typename IO>
__device__ __forceinline__ float element(int8_t x, float scale, float zp) {
  return round_to<IO>(__fadd_rn(__fmul_rn(static_cast<float>(x), scale), zp));
}

template <typename IO, typename KV, class Raw, int N>
__device__ __forceinline__ void widen(const Raw& raw, float (&x)[N],
                                      float scale, float zp) {
  static_assert(sizeof(Raw) == N * sizeof(KV), "chunk and width disagree");
  const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = element<IO>(e[i], scale, zp);
}

// s += y with Kahan compensation c (true sum ~ s - c).
__device__ __forceinline__ void kahan_add(float& s, float& c, float y) {
  const float z = y - c;
  const float t = s + z;
  c = (t - s) - z;
  s = t;
}

struct Params {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *k_zp, *v_scale, *v_zp;
  const int *page_table, *positions;
  void* out;    // [B, T, KV, G, D] in the compute dtype
  float* ml;    // [B, KV, S, T*G, 2]: per split and row, (max, sum of exp)
  float* part;  // [B, KV, S, T*G, D]: per split, partial P.V (S > 1)
  float* scores;  // [B, KV, P * page, T*G]: pass 1's scores, or null
  int* tickets;   // [B, KV, row tiles]: pass 2's CTAs done (S > 1)
  int B, T, H, KVH, n_blocks, page, P, splits;
  float scale;
  int page_shift;  // log2(page), or -1 if page is not a power of two
};

// The CTA's place: rows [r0, r0 + rows) of (b, kvh), split `split`, and the
// slots [lo, hi) it reads: its even share of the tile's visible pages,
// pages [p0, p1).
template <int RT>
struct Place {
  int b, kvh, split, r0, rows, lo, hi, p0;

  // where the CTA sits; the rows' positions into pos_s (-1: no slot is
  // visible to a row past the tile's end), read after a barrier
  __device__ __forceinline__ Place(const Params& a, int* pos_s) {
    const int G = a.H / a.KVH;
    split = blockIdx.x % a.splits;
    r0 = (blockIdx.x / a.splits) * RT;
    kvh = blockIdx.y;
    b = blockIdx.z;
    rows = min(RT, a.T * G - r0);
    if (threadIdx.x < RT)
      pos_s[threadIdx.x] = static_cast<int>(threadIdx.x) < rows
                               ? a.positions[b * a.T + (r0 + threadIdx.x) / G]
                               : -1;
  }

  // after the barrier: the split's pages, and their block ids into blk_s,
  // clamped into the pool like the reference's gather (out-of-range ids
  // read the last block), so that no K/V load waits on a page-table load
  __device__ __forceinline__ void pages(const Params& a, const int* pos_s,
                                        int* blk_s) {
    int mx = 0;
#pragma unroll
    for (int r = 0; r < RT; ++r) mx = max(mx, pos_s[r]);
    const int n_vis = min(mx + 1, a.P * a.page);
    const int n = (n_vis + a.page - 1) / a.page;
    p0 = static_cast<int>(static_cast<long long>(split) * n / a.splits);
    const int p1 =
        static_cast<int>(static_cast<long long>(split + 1) * n / a.splits);
    lo = p0 * a.page;
    hi = min(p1 * a.page, n_vis);
    for (int i = threadIdx.x; i < p1 - p0; i += kThreads)
      blk_s[i] = min(max(a.page_table[b * a.P + p0 + i], 0), a.n_blocks - 1);
  }
};

// Index of (slot, tile row r) in the kept scores [B, KV, P * page, T*G]:
// the rows of one slot are adjacent, as the lanes that hold them.
template <int RT>
__device__ __forceinline__ size_t score_at(const Params& a,
                                           const Place<RT>& w, int slot,
                                           int r) {
  const int TG = a.T * (a.H / a.KVH);
  return ((static_cast<size_t>(w.b) * a.KVH + w.kvh) * a.P * a.page + slot) *
             TG + w.r0 + r;
}

// The tile's query rows into shared memory, widened to f32 (zeros past the
// tile's end), 16 bytes a thread.
template <typename IO, int D, int RT>
__device__ __forceinline__ void load_q(const Params& a, const Place<RT>& w,
                                       float (*q_s)[D]) {
  constexpr int kV = 16 / sizeof(IO), kChunks = D / kV;  // per row
  const int G = a.H / a.KVH;
  for (int i = threadIdx.x; i < RT * kChunks; i += kThreads) {
    const int r = i / kChunks, ch = i % kChunks;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < w.rows) {
      const int t = (w.r0 + r) / G, g = w.r0 + r - t * G;
      raw = *reinterpret_cast<const uint4*>(
          static_cast<const IO*>(a.q) +
          ((static_cast<size_t>(w.b) * a.T + t) * a.H + w.kvh * G + g) * D +
          ch * kV);
    }
    const IO* x = reinterpret_cast<const IO*>(&raw);
#pragma unroll
    for (int k = 0; k < kV; ++k) q_s[r][ch * kV + k] = to_f32(x[k]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Programmatic dependent launch (Hopper): pass 1 lets pass 2 start its
// prologue (positions, block ids) before pass 1 has finished; pass 2 waits
// for pass 1 before it reads what pass 1 wrote.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Asynchronous global -> shared copies of one thread (cp.async): issued,
// grouped, and waited for by the same thread, which alone reads them back.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N)
                 : "memory");
}
template <class Raw>
__device__ __forceinline__ void cp_async_raw(Raw* dst, const void* src) {
  if constexpr (sizeof(Raw) == 32) {
    cp_async<16>(dst, src);
    cp_async<16>(reinterpret_cast<char*>(dst) + 16,
                 static_cast<const char*>(src) + 16);
  } else {
    cp_async<sizeof(Raw)>(dst, src);
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How the kLanes lanes of a slot group share the tile's RT rows once a
// score is reduced: lane c ends with the full dot products of kRows rows,
// rows [(c / kLanesPerRow) * kRows, + kRows).
template <int D, int RT, int kVec>
struct Lanes {
  static constexpr int kLanes = D / kVec;            // lanes sharing a slot
  static constexpr int kSpw = 32 / kLanes;           // slots per warp
  static constexpr int kRows = RT > kLanes ? RT / kLanes : 1;
  static constexpr int kLanesPerRow = kLanes / (RT / kRows);
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "lanes must tile a warp");

  // v[r]: this lane's partial dot for row r. Recursive halving: at each
  // step a lane keeps half of its rows and adds its partner's half of them
  // (one shuffle per row kept), then, one row left, the rest of the group
  // sums it. Far fewer shuffles than reducing every row on every lane, and
  // every later per-row step runs once per row, not once per row per lane.
  static __device__ __forceinline__ void reduce(float (&v)[RT], int c) {
    step<kLanes / 2, RT>(v, c);
  }
  // offset O between partners, N rows still held
  template <int O, int N>
  static __device__ __forceinline__ void step(float (&v)[RT], int c) {
    if constexpr (O > 0) {
      if constexpr (N > kRows) {
        const bool upper = c & O;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const float send = upper ? v[i] : v[N / 2 + i];
          const float keep = upper ? v[N / 2 + i] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
        step<O / 2, N / 2>(v, c);
      } else {
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          v[i] += __shfl_xor_sync(0xffffffffu, v[i], O);
        step<O / 2, N>(v, c);
      }
    }
  }
};

// A warp's walk over its slots of the split, kUnroll slots per lane a
// batch, with the raw K (and V, int8 sidecars, kept scores) of the next
// kDepth - 1 batches in flight by cp.async into a per-thread ring in shared
// memory: global latency is covered without holding loads in registers.
// kKeep: pass 2 over the scores pass 1 kept, instead of K.
template <typename KV, int D, int RT, bool kWithK, bool kWithV, bool kKeep>
struct Stream {
  using C = Chunk<KV, RT>;
  using Raw = typename C::Raw;
  using Ln = Lanes<D, RT, C::kVec>;
  static constexpr int kUnroll = 4, kDepth = 3;
  static constexpr int kSide = std::is_same_v<KV, int8_t> ? 1 : 0;
  static constexpr int kKept = kKeep ? Ln::kRows : 0;
  // bytes of ring per thread
  static constexpr int kBytes =
      kDepth * kUnroll *
      ((kWithK + kWithV) * static_cast<int>(sizeof(Raw)) + kSide * 16 +
       kKept * 4);

  Raw *k_ring, *v_ring;
  float4* side_ring;  // (k scale, k zp, v scale, v zp)
  float* kept_ring;
  int first, step, hi;  // this lane's first slot, the stride, the end

  // ring entry (batch b, unroll u) of this thread
  __device__ __forceinline__ int at(int b, int u) const {
    return ((b % kDepth) * kUnroll + u) * kThreads + threadIdx.x;
  }
  __device__ __forceinline__ int slot(int b, int u) const {
    return first + (b * kUnroll + u) * step;
  }

  __device__ __forceinline__ Stream(unsigned char* ring, int first_, int step_,
                                    int hi_)
      : first(first_), step(step_), hi(hi_) {
    constexpr int n = kDepth * kUnroll * kThreads;
    unsigned char* p = ring;
    k_ring = reinterpret_cast<Raw*>(p);
    p += kWithK * n * sizeof(Raw);
    v_ring = reinterpret_cast<Raw*>(p);
    p += kWithV * n * sizeof(Raw);
    side_ring = reinterpret_cast<float4*>(p);
    p += kSide * n * sizeof(float4);
    kept_ring = reinterpret_cast<float*>(p);
  }

  // batch b's copies, one commit group (empty past the end)
  __device__ __forceinline__ void issue(const Params& a, const int* blk_s,
                                        const Place<RT>& w, int b, int c,
                                        int rb) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int sl = slot(b, u);
      if (sl < hi) {
        // a power-of-two page (the engine's 16) divides by a shift
        const int pg = a.page_shift >= 0 ? sl >> a.page_shift : sl / a.page;
        const size_t row =
            (static_cast<size_t>(blk_s[pg - w.p0]) * a.page + sl -
             pg * a.page) * a.KVH + w.kvh;
        const size_t off = row * D + c * C::kVec;
        const int e = at(b, u);
        if (kWithK)
          cp_async_raw(&k_ring[e], static_cast<const KV*>(a.k_pool) + off);
        if (kWithV)
          cp_async_raw(&v_ring[e], static_cast<const KV*>(a.v_pool) + off);
        if (kSide && c == 0) {  // the group reads them from its lane 0
          float* sd = reinterpret_cast<float*>(&side_ring[e]);
          if (kWithK) {
            cp_async<4>(sd, a.k_scale + row);
            cp_async<4>(sd + 1, a.k_zp + row);
          }
          if (kWithV) {
            cp_async<4>(sd + 2, a.v_scale + row);
            cp_async<4>(sd + 3, a.v_zp + row);
          }
        }
        if (kKept) {
#pragma unroll
          for (int j = 0; j < kKept; ++j)
            if (rb + j < w.rows)
              cp_async<4>(&kept_ring[e * kKept + j],
                          a.scores + score_at(a, w, sl, rb + j));
        }
      }
    }
    cp_commit();
  }

  // batch b's K (or V) chunk of unroll u, widened (zeros past the end: a
  // stale ring entry must not reach a sum)
  template <typename IO, bool kV>
  __device__ __forceinline__ void get(int b, int u,
                                      float (&x)[C::kVec]) const {
    const int e = at(b, u);
    // the sidecars sit in the entry of the slot group's lane 0 (made visible
    // to the group by the __syncwarp after the wait)
    const float4 sd = kSide ? side_ring[e - static_cast<int>(threadIdx.x % Ln::kLanes)]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const Raw raw = kV ? v_ring[e] : k_ring[e];  // whole 16-byte reads
    widen<IO, KV>(raw, x, kV ? sd.z : sd.x, kV ? sd.w : sd.y);
    if (slot(b, u) >= hi) {
#pragma unroll
      for (int i = 0; i < C::kVec; ++i) x[i] = 0.f;
    }
  }
};

// This lane's chunk of the tile's query rows: in registers where they fit
// beside the rest (bf16 compute, 4-row tiles), else read from shared memory
// (f32 compute, whose Kahan sums need the registers; 8-row tiles, where
// fewer registers buy more CTAs per SM).
template <int D, int RT, int kVec, bool kInRegs>
struct QRows {
  const float (*q_s)[D];
  int c;
  float reg[kInRegs ? RT : 1][kInRegs ? kVec : 1];
  __device__ __forceinline__ QRows(const float (*q)[D], int chunk)
      : q_s(q), c(chunk) {
    if constexpr (kInRegs) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int i = 0; i < kVec; ++i) reg[r][i] = q_s[r][c * kVec + i];
    }
  }
  __device__ __forceinline__ float operator()(int r, int i) const {
    if constexpr (kInRegs) return reg[r][i];
    return q_s[r][c * kVec + i];
  }
};

// s[j]: the scaled scores of K chunk kf for this lane's rows rb + j.
template <class Ln, int RT, int kVec, class QV>
__device__ __forceinline__ void own_scores(const float (&kf)[kVec],
                                           const QV& qv, int c, float scale,
                                           float (&s)[Ln::kRows]) {
  float dot[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) part = fmaf(qv(r, i), kf[i], part);
    dot[r] = part;
  }
  Ln::reduce(dot, c);
#pragma unroll
  for (int j = 0; j < Ln::kRows; ++j)
    s[j] = dot[j] * scale;  // scale after the dot, as the reference
}

// Merge running (max, sum of exp) b into a; either may be empty (-inf, 0).
__device__ __forceinline__ void merge_stats(float& m, float& l, float mo,
                                            float lo) {
  const float mn = fmaxf(m, mo);
  if (mn == -INFINITY) return;
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

// The prologue both passes share: where the CTA sits, its query rows
// (unless kKeep), the split's page range and block ids; the ring after them.
template <typename IO, int D, int RT>
__device__ __forceinline__ Place<RT> begin(const Params& a, bool with_q,
                                           float (*q_s)[D], int* pos_s,
                                           int* blk_s) {
  Place<RT> w(a, pos_s);
  if (with_q) load_q<IO, D, RT>(a, w, q_s);
  __syncthreads();
  w.pages(a, pos_s, blk_s);
  return w;
}

// Bytes of shared memory a pass needs beyond its static arrays: the block
// ids of one split's pages, then the ring.
template <class S>
size_t dynamic_smem(const Params& a) {
  const size_t ids = ((a.P + a.splits - 1) / a.splits) * sizeof(int);
  return (ids + 15) / 16 * 16 + static_cast<size_t>(S::kBytes) * kThreads;
}
template <class S>
__device__ __forceinline__ unsigned char* ring_of(const Params& a,
                                                  int* blk_s) {
  const size_t ids = ((a.P + a.splits - 1) / a.splits) * sizeof(int);
  return reinterpret_cast<unsigned char*>(blk_s) + (ids + 15) / 16 * 16;
}

// Pass 1: per split and row, the max and the sum of exp of the scores; with
// kKeep the scores themselves too, for pass 2.
template <typename IO, typename KV, int D, int RT, bool kKeep>
__global__ void __launch_bounds__(kThreads) paged_stats(Params a) {
  using S = Stream<KV, D, RT, true, false, false>;
  using Ln = typename S::Ln;
  constexpr int kVec = S::C::kVec, kSpw = Ln::kSpw, kRows = Ln::kRows;
  constexpr int kUnroll = S::kUnroll;
  constexpr bool kKahan = sizeof(IO) == 4;
  __shared__ __align__(16) float q_s[RT][D];
  __shared__ int pos_s[RT];
  __shared__ float red_m[kWarps * kSpw][RT], red_l[kWarps * kSpw][RT];
  extern __shared__ __align__(16) int blk_s[];  // block ids, then the ring
  let_next_start();
  const Place<RT> w = begin<IO, D, RT>(a, true, q_s, pos_s, blk_s);
  if (a.splits > 1 && w.split == 0 && threadIdx.x == 0)
    a.tickets[(static_cast<size_t>(w.b) * a.KVH + w.kvh) * gridDim.x /
                  a.splits + w.r0 / RT] = 0;  // for pass 2's last CTA
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / Ln::kLanes, c = lane % Ln::kLanes;
  const int rb = (c / Ln::kLanesPerRow) * kRows;  // this lane's first row
  const QRows<D, RT, kVec, !kKahan && RT == 4> qv(q_s, c);
  float m[kRows], l[kRows], lc[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    m[j] = -INFINITY;
    l[j] = lc[j] = 0.f;
  }
  constexpr int kStep = kSpw * kWarps;
  const int start = w.lo + warp * kSpw;  // the warp's first slot
  const int n = start < w.hi ? (w.hi - start + kStep * kUnroll - 1) /
                                   (kStep * kUnroll)
                             : 0;
  S st(ring_of<S>(a, blk_s), start + grp, kStep, w.hi);
#pragma unroll
  for (int b = 0; b < S::kDepth - 1; ++b) {
    if (b < n) st.issue(a, blk_s, w, b, c, rb);
    else cp_commit();
  }
  for (int b = 0; b < n; ++b) {
    if (b + S::kDepth - 1 < n) st.issue(a, blk_s, w, b + S::kDepth - 1, c, rb);
    else cp_commit();
    cp_wait<S::kDepth - 1>();
    if (S::kSide) __syncwarp();  // lane 0's sidecar copies, for its group
    float s[kUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kVec];
      st.template get<IO, false>(b, u, kf);
      own_scores<Ln, RT, kVec>(kf, qv, c, a.scale, s[u]);
      const int sl = st.slot(b, u);
      if (kKeep && c % Ln::kLanesPerRow == 0 && sl < w.hi) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (rb + j < w.rows) a.scores[score_at(a, w, sl, rb + j)] = s[u][j];
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int pos = pos_s[rb + j];
      float mb = -INFINITY;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int sl = st.slot(b, u);
        if (sl < w.hi && sl <= pos) mb = fmaxf(mb, s[u][j]);
      }
      if (mb == -INFINITY) continue;
      const float mn = fmaxf(m[j], mb);
      const float alpha = expf(m[j] - mn);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int sl = st.slot(b, u);
        if (sl < w.hi && sl <= pos) sum += expf(s[u][j] - mn);
      }
      l[j] *= alpha;
      lc[j] *= alpha;
      kahan_add(l[j], lc[j], sum);
      m[j] = mn;
    }
  }
  cp_wait<0>();

  // every lane of a row's lanes holds the same statistics: one writes them,
  // then the slot groups and warps merge in order
  if (c % Ln::kLanesPerRow == 0) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      red_m[warp * kSpw + grp][rb + j] = m[j];
      red_l[warp * kSpw + grp][rb + j] = l[j] - lc[j];
    }
  }
  __syncthreads();
  // warp r merges row r's entries: strided over the lanes, then a butterfly
  // (a fixed order: the same result in every run)
  for (int r = warp; r < w.rows; r += kWarps) {
    float mm = -INFINITY, ll = 0.f;
    for (int i = lane; i < kWarps * kSpw; i += 32)
      merge_stats(mm, ll, red_m[i][r], red_l[i][r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, mm, o);
      const float lo = __shfl_xor_sync(0xffffffffu, ll, o);
      merge_stats(mm, ll, mo, lo);
    }
    if (lane == 0) {
      const int TG = a.T * (a.H / a.KVH);
      float* dst = a.ml + ((((static_cast<size_t>(w.b) * a.KVH + w.kvh) *
                                 a.splits + w.split) * TG) + w.r0 + r) * 2;
      dst[0] = mm;
      dst[1] = ll;
    }
  }
}

// Pass 2: the row's (max, sum) over all splits, p = round(exp(s - max) / sum),
// and this split's P.V: a partial in f32, or the output with one split. With
// kKeep the scores come from pass 1 and K is not read again.
template <typename IO, typename KV, int D, int RT, bool kKeep>
__global__ void __launch_bounds__(kThreads) paged_pv(Params a) {
  using S = Stream<KV, D, RT, !kKeep, true, kKeep>;
  using Ln = typename S::Ln;
  constexpr int kVec = S::C::kVec, kSpw = Ln::kSpw, kRows = Ln::kRows;
  constexpr int kUnroll = S::kUnroll;
  constexpr bool kKahan = sizeof(IO) == 4;
  __shared__ __align__(16) float q_s[RT][D];
  __shared__ int pos_s[RT];
  __shared__ float m_s[RT], l_s[RT];
  __shared__ __align__(16) float red[kWarps][RT][D];
  __shared__ float2 ml_s[kMaxSplits][RT];
  extern __shared__ __align__(16) int blk_s[];  // block ids, then the ring
  const int TG = a.T * (a.H / a.KVH);
  const size_t head =
      static_cast<size_t>(blockIdx.z) * a.KVH + blockIdx.y;
  const Place<RT> w = begin<IO, D, RT>(a, !kKeep, q_s, pos_s, blk_s);
  wait_for_previous();  // pass 1's statistics, scores and tickets
  // every split's statistics of the tile's rows, all loads in flight at once
  for (int i = threadIdx.x; i < a.splits * RT; i += kThreads) {
    const int sp = i / RT, r = i % RT;
    ml_s[sp][r] = r < w.rows ? *reinterpret_cast<const float2*>(
                                   a.ml + ((head * a.splits + sp) * TG +
                                           w.r0 + r) * 2)
                             : make_float2(-INFINITY, 0.f);
  }
  __syncthreads();
  if (threadIdx.x < RT) {
    const int r = threadIdx.x;
    float mm = -INFINITY, ll = 0.f;
    for (int sp = 0; sp < a.splits; ++sp)
      merge_stats(mm, ll, ml_s[sp][r].x, ml_s[sp][r].y);
    m_s[r] = mm;
    l_s[r] = ll;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / Ln::kLanes, c = lane % Ln::kLanes;
  const int rb = (c / Ln::kLanesPerRow) * kRows;
  const int first = grp * Ln::kLanes;  // the slot group's first lane
  const QRows<D, RT, kVec, !kKahan && RT == 4 && !kKeep> qv(q_s, c);
  float acc[RT][kVec], comp[RT][kVec];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[r][i] = comp[r][i] = 0.f;
  constexpr int kStep = kSpw * kWarps;
  const int start = w.lo + warp * kSpw;
  const int n = start < w.hi ? (w.hi - start + kStep * kUnroll - 1) /
                                   (kStep * kUnroll)
                             : 0;
  S st(ring_of<S>(a, blk_s), start + grp, kStep, w.hi);
#pragma unroll
  for (int b = 0; b < S::kDepth - 1; ++b) {
    if (b < n) st.issue(a, blk_s, w, b, c, rb);
    else cp_commit();
  }
  for (int b = 0; b < n; ++b) {
    if (b + S::kDepth - 1 < n) st.issue(a, blk_s, w, b + S::kDepth - 1, c, rb);
    else cp_commit();
    cp_wait<S::kDepth - 1>();
    if (S::kSide) __syncwarp();  // lane 0's sidecar copies, for its group
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int sl = st.slot(b, u);
      float s[kRows], own[kRows];
      if constexpr (kKeep) {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          s[j] = st.kept_ring[st.at(b, u) * kRows + j];
      } else {
        float kf[kVec];
        st.template get<IO, false>(b, u, kf);
        own_scores<Ln, RT, kVec>(kf, qv, c, a.scale, s);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = rb + j;
        // the reference's exp and division, then one rounding: a faster
        // exp, a few f32 ulps off, would move more p across a bf16
        // rounding boundary than the reference's own
        own[j] = sl < w.hi && sl <= pos_s[r]
                     ? round_to<IO>(expf(s[j] - m_s[r]) / l_s[r])
                     : 0.f;
      }
      float vf[kVec];
      st.template get<IO, true>(b, u, vf);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        // row r's p, from a lane that holds it
        const float p = __shfl_sync(
            0xffffffffu, own[r % kRows],
            first + (r / kRows) * Ln::kLanesPerRow);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          if (kKahan)
            kahan_add(acc[r][i], comp[r][i], p * vf[i]);
          else
            acc[r][i] = fmaf(p, vf[i], acc[r][i]);
        }
      }
    }
  }
  cp_wait<0>();

  // merge the warp's slot groups, then the warps in order
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      float x = acc[r][i] - comp[r][i];
#pragma unroll
      for (int o = Ln::kLanes; o < 32; o <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      if (grp == 0) red[warp][r][c * kVec + i] = x;
    }
  __syncthreads();
  const int G = a.H / a.KVH;
  for (int i = threadIdx.x; i < RT * D; i += kThreads) {
    const int r = i / D, e = i % D;
    if (r >= w.rows) continue;
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) x += red[k][r][e];
    if (a.splits == 1) {
      const int t = (w.r0 + r) / G, g = (w.r0 + r) % G;
      static_cast<IO*>(a.out)[(((static_cast<size_t>(w.b) * a.T + t) * a.KVH +
                                w.kvh) * G + g) * D + e] = from_f32<IO>(x);
    } else {
      a.part[((head * a.splits + w.split) * TG + w.r0 + r) * D + e] = x;
    }
  }
  if (a.splits == 1) return;

  // the tile's last CTA to finish sums every split's partial, in split
  // order (whichever CTA is last, the sum is the same), and rounds once
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&a.tickets[head * (gridDim.x / a.splits) + w.r0 / RT],
                     1) == a.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < RT * D; i += kThreads) {
    const int r = i / D, e = i % D;
    if (r >= w.rows) continue;
    float x = 0.f;
    for (int sp = 0; sp < a.splits; ++sp)
      x += __ldcg(&a.part[((head * a.splits + sp) * TG + w.r0 + r) * D + e]);
    const int t = (w.r0 + r) / G, g = (w.r0 + r) % G;
    static_cast<IO*>(a.out)[(((static_cast<size_t>(w.b) * a.T + t) * a.KVH +
                              w.kvh) * G + g) * D + e] = from_f32<IO>(x);
  }
}

// Lets a kernel take all the shared memory a block may opt into beside its
// static arrays (once per kernel); returns that room in bytes.
template <auto kKernel>
size_t open_smem() {
  static const size_t room = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, kKernel) != cudaSuccess)
      return size_t{0};
    const size_t r = optin - attr.sharedSizeBytes;
    return cudaFuncSetAttribute(kKernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(r)) == cudaSuccess
               ? r
               : size_t{0};
  }();
  return room;
}

template <typename IO, typename KV, int D, int RT, bool kKeep>
int launch_rows(const Params& a, cudaStream_t stream) {
  const int rows = a.T * (a.H / a.KVH);
  const dim3 grid(((rows + RT - 1) / RT) * a.splits, a.KVH, a.B);
  constexpr auto stats = paged_stats<IO, KV, D, RT, kKeep>;
  constexpr auto pv = paged_pv<IO, KV, D, RT, kKeep>;
  const size_t smem_stats =
      dynamic_smem<Stream<KV, D, RT, true, false, false>>(a);
  const size_t smem_pv = dynamic_smem<Stream<KV, D, RT, !kKeep, true, kKeep>>(a);
  if (smem_stats > open_smem<stats>() || smem_pv > open_smem<pv>())
    return static_cast<int>(cudaErrorInvalidValue);
  paged_stats<IO, KV, D, RT, kKeep><<<grid, kThreads, smem_stats, stream>>>(a);
  if (cudaError_t rc = cudaGetLastError()) return static_cast<int>(rc);
  // pass 2 may start its prologue while pass 1 runs (it waits for pass 1
  // before it reads what pass 1 wrote)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem_pv;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  if (cudaError_t rc =
          cudaLaunchKernelEx(&config, paged_pv<IO, KV, D, RT, kKeep>, a))
    return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename IO, typename KV, int D, int RT>
int launch_rows(const Params& a, cudaStream_t stream) {
  if (a.scores != nullptr) return launch_rows<IO, KV, D, RT, true>(a, stream);
  return launch_rows<IO, KV, D, RT, false>(a, stream);
}

template <typename IO, typename KV, int D>
int launch(const Params& a, cudaStream_t stream) {
  // decode's G heads of one token fill a 4-row tile; more rows take 8
  if (a.T * (a.H / a.KVH) <= 4) return launch_rows<IO, KV, D, 4>(a, stream);
  return launch_rows<IO, KV, D, 8>(a, stream);
}

template <typename IO, typename KV>
int dispatch_head_dim(int d, const Params& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<IO, KV, 16>(a, stream);
    case 32: return launch<IO, KV, 32>(a, stream);
    case 64: return launch<IO, KV, 64>(a, stream);
    case 128: return launch<IO, KV, 128>(a, stream);
    default: return -2;
  }
}

}  // namespace

// Returns 0 on clean launches, cudaGetLastError() otherwise, -1 for an
// unsupported dtype pair or split count and -2 for an unsupported head dim.
// One call issues two CUDA launches (statistics, P.V). `ml` is f32 scratch
// [B, KV, splits, T*G, 2]; with more than one split, `part` is f32 scratch
// [B, KV, splits, T*G, D] and `tickets` int32 scratch [B, KV, row tiles]
// (both unused, may be null, with one split); `scores`, f32 scratch [B, KV,
// P * page, T*G] or null: where given, pass 1 keeps the scores there and
// pass 2 reads them instead of K (worth it where T*G scores take fewer
// bytes than a K row).
extern "C" int lzy_paged_attention(
    int io_dtype, int kv_dtype, int head_dim, const void* q,
    const void* k_pool, const void* v_pool, const void* k_scale,
    const void* k_zp, const void* v_scale, const void* v_zp,
    const void* page_table, const void* positions, void* out, void* ml,
    void* part, void* scores, void* tickets, int B, int T, int H, int KVH,
    int n_blocks, int page, int P, int splits, float scale, void* stream) {
  if (splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return -1;
  const Params a{q,
                 k_pool,
                 v_pool,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(k_zp),
                 static_cast<const float*>(v_scale),
                 static_cast<const float*>(v_zp),
                 static_cast<const int*>(page_table),
                 static_cast<const int*>(positions),
                 out,
                 static_cast<float*>(ml),
                 static_cast<float*>(part),
                 static_cast<float*>(scores),
                 static_cast<int*>(tickets),
                 B, T, H, KVH, n_blocks, page, P, splits, scale,
                 page > 0 && (page & (page - 1)) == 0 ? __builtin_ctz(page) : -1};
  const auto st = static_cast<cudaStream_t>(stream);
  if (io_dtype == kF32 && kv_dtype == kF32)
    return dispatch_head_dim<float, float>(head_dim, a, st);
  if (io_dtype == kBF16 && kv_dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, a, st);
  if (io_dtype == kF32 && kv_dtype == kI8)
    return dispatch_head_dim<float, int8_t>(head_dim, a, st);
  if (io_dtype == kBF16 && kv_dtype == kI8)
    return dispatch_head_dim<__nv_bfloat16, int8_t>(head_dim, a, st);
  return -1;
}
