// Paged decode/chunk attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel cloud_tpu/ops/paged_attention.py::_paged_kernel
// (pallas_call in _paged_pallas), both of its branches.  Same function:
// queries q [B, Tq, H, hd] attend over keys read in place through a per-row
// block table.  Page p of row b covers positions [p*bt, (p+1)*bt); its table
// entry selects a pool block (entry >= 0, pool [NB, bt, H, hd]) or the slot
// row itself (-1, slot [B, S, H, hd]).  Key j is valid for query t iff
// j < cur_len[b] + t (chunk-causal; with Tq == 1 the plain decode mask),
// masked keys score the finite NEG_INF, softmax state is f32, and a row
// whose softmax sum is zero returns zeros.
//
// Two entry points, one kernel template over the K/V element type:
// paged_attention (K8: K/V of q's type, f32 or bf16) and
// paged_attention_int8 (K8q, the TPU kernel's quantized=True branch: int8
// K/V with f32 per-(position, head) scales [B, S, H, 1] for the slot row and
// [NB, bt, H, 1] for the pool).  K8q folds the scales in with the TPU
// kernel's post-scale algebra: s = (q . k_int8) * scale * k_scale[j] before
// the mask, the softmax sum l adds the unscaled p, and p * v_scale[j] feeds
// the P.V product.
//
// Translation: split across pages (flash-decoding).  The TPU grid walked
// (row, page) with the table and lengths scalar-prefetched and the
// online-softmax state in VMEM scratch, one row at a time.  Here the grid
// is (H, B, n_split): the wrapper picks n_split from static shapes only (B,
// H, S, bt and the SM count; it never reads cur_len, which lives on the
// card) so that B * H * n_split blocks cover the SMs several times over, and
// no split is narrower than a page.  Each block reads cur_len[b] itself,
// takes the row's live pages ceil((cur_len + Tq - 1) / bt) (the dead-page
// skip) and its even share of them, split * n_live / n_split up to
// (split + 1) * n_live / n_split, so a short row does not leave one split
// with all the work; a split with no live page writes an empty partial and
// exits.
//   - Loads: the split's keys arrive in tiles of 64 (32 for f32 K/V) by
//     16-byte cp.async copies in a 2-stage ring, tile i + 1 in flight while
//     tile i is computed, in their stored type (bf16, int8 or f32; K8q's
//     f32 scales by 4-byte copies beside them).  Each copied key resolves
//     its own page through the block table, so any page size works.
//     Rows are padded by 16 bytes in shared memory.
//   - Scores: two threads a (query, key) pair, each over half of hd, so
//     every thread works at Tq = 1; the online softmax takes a warp a query
//     row (one exp a score); the P.V update four threads a (query, column
//     pair), each over a quarter of the tile's keys, joined by shuffles.
//     Keys outside the split score -inf (no key at all); keys of the split
//     at or past cur_len + t score NEG_INF.
//   - Each (b, t, h, split) writes its partial (m, l, acc[hd]) in f32 to a
//     workspace the wrapper takes from PyTorch's caching allocator; a
//     second kernel on the same stream merges a row's partials: m = max
//     m_i, out = sum exp(m_i - m) acc_i / sum exp(m_i - m) l_i, zeros where
//     that sum is 0, in q's type.  That is the single pass's answer in
//     every case: a split whose keys are all masked (m_i = NEG_INF, l_i its
//     key count) weighs 0 beside a split with a valid key and 1 when no
//     split has one, as its keys would have in one pass; an empty split
//     (l_i = 0, acc_i = 0) adds nothing.
//
// What bounds it on H100: the K/V bytes it reads.  A decode step reads
// every live page of every slot once per layer and does two FLOPs per byte
// (four per byte for int8), far below the card's ~295 FLOPs/byte balance
// point.  The design reads each live K/V element once per (row, head),
// skips dead pages, keeps 16-byte copies in flight on every SM, and spends
// on the partials (hd + 2) f32 per (row, query, head, split), a few percent
// of the K/V bytes at the engine's shapes.  K8q reads 2*hd + 8 bytes per
// live (key, head) against 4*hd for bf16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;

struct Params {
  const void* q;        // [B, Tq, H, D]
  const void* slot_k;   // [B, S, H, D]
  const void* slot_v;
  const float* slot_ks; // [B, S, H, 1] (K8q) or nullptr
  const float* slot_vs;
  const void* pool_k;   // [NB, bt, H, D] or nullptr
  const void* pool_v;
  const float* pool_ks; // [NB, bt, H, 1] (K8q with a pool) or nullptr
  const float* pool_vs;
  const int32_t* table; // [B, n_tab] or nullptr (every page reads the slot)
  const int32_t* cur_len;  // [B]
  void* out;            // [B, Tq, H, D]
  float* part_ml;       // [B * Tq * H, n_split, 2]: (m, l) of each split
  float* part_acc;      // [B * Tq * H, n_split, D]
  int B, Tq, H, S, bt, n_tab, n_split;
  float scale;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Keys per staged tile: 64, or 32 for f32 K/V, whose 64-key ring at hd=128
// beside Tq=64 queries would not fit a block's shared memory.
template <typename KV> __host__ __device__ constexpr int tile_keys() {
  return sizeof(KV) == 4 ? 32 : 64;
}

// One staged key row in shared memory, bytes: hd values, padded by 16.
template <typename KV, int D> __host__ __device__ constexpr int row_bytes() {
  return D * static_cast<int>(sizeof(KV)) + 16;
}

template <typename KV, int D> size_t smem_bytes(int tq) {
  constexpr int kKT = tile_keys<KV>();
  return 4 * static_cast<size_t>(kKT) * row_bytes<KV, D>() +  // K, V rings
         sizeof(float) * (4 * kKT +                             // scales
                          tq * (2 * D + kKT + 3));  // q, acc, weights, m l c
}

// The 8 bytes at p as floats: 4 bf16, 8 int8 or 2 f32.
template <typename KV>
__device__ __forceinline__ void unpack8(const unsigned char* p,
                                       float (&x)[8 / sizeof(KV)]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else if constexpr (std::is_same<KV, int8_t>::value) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = static_cast<float>(static_cast<int8_t>(raw.x >> (8 * e)));
      x[4 + e] = static_cast<float>(static_cast<int8_t>(raw.y >> (8 * e)));
    }
  } else {
    x[0] = __uint_as_float(raw.x);
    x[1] = __uint_as_float(raw.y);
  }
}

// Elements d, d + 1 (d even) of a staged row.
template <typename KV>
__device__ __forceinline__ float2 load_pair(const unsigned char* row, int d) {
  if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + 2 * d));
  } else if constexpr (std::is_same<KV, int8_t>::value) {
    const char2 c = *reinterpret_cast<const char2*>(row + d);
    return make_float2(c.x, c.y);
  } else {
    return *reinterpret_cast<const float2*>(row + 4 * d);
  }
}

// Where key j of row b lives: the pool block its page's table entry names,
// or the slot row; returns the source's [rows, H] row index and sets the
// source pointers.
template <typename KV>
__device__ __forceinline__ long long key_source(const Params& p, int b, int j,
                                                const KV*& k, const KV*& v,
                                                const float*& ks,
                                                const float*& vs) {
  const int page = j / p.bt;
  const int entry =
      (p.table != nullptr && page < p.n_tab) ? p.table[b * p.n_tab + page] : -1;
  if (entry >= 0 && p.pool_k != nullptr) {
    k = static_cast<const KV*>(p.pool_k);
    v = static_cast<const KV*>(p.pool_v);
    ks = p.pool_ks;
    vs = p.pool_vs;
    return static_cast<long long>(entry) * p.bt + j % p.bt;
  }
  k = static_cast<const KV*>(p.slot_k);
  v = static_cast<const KV*>(p.slot_v);
  ks = p.slot_ks;
  vs = p.slot_vs;
  return static_cast<long long>(b) * p.S + j;
}

// T: the type of q and out.  KV: the type of the stored K/V, T itself (K8)
// or int8_t (K8q, with per-(position, head) scales).  One block: one (head,
// row, split); writes that split's partial.
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params p) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kKT = tile_keys<KV>();
  constexpr int kRowB = row_bytes<KV, D>();
  constexpr int kTileB = kKT * kRowB;
  constexpr int kChunks = D * static_cast<int>(sizeof(KV)) / 16;
  constexpr int kPer = 8 / static_cast<int>(sizeof(KV));  // values per 8 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sK = smem;             // [2][kKT][kRowB]
  unsigned char* sV = sK + 2 * kTileB;  // [2][kKT][kRowB]
  float* sKs = reinterpret_cast<float*>(sV + 2 * kTileB);  // [2][kKT]
  float* sVs = sKs + 2 * kKT;           // [2][kKT], 0 outside the split
  const int Tq = p.Tq;
  float* sQ = sVs + 2 * kKT;            // [Tq][D]
  float* sAcc = sQ + Tq * D;            // [Tq][D]
  float* sW = sAcc + Tq * D;            // [Tq][kKT]: scores, then weights
  float* sM = sW + Tq * kKT;            // [Tq]
  float* sL = sM + Tq;                  // [Tq]
  float* sC = sL + Tq;                  // [Tq]: this tile's correction

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int len = p.cur_len[b];
  // Partial (b, t, h, split) is at part(t) = part0 + t * H * n_split.
  const long long part0 =
      (static_cast<long long>(b) * Tq * p.H + h) * p.n_split + split;
  const long long part_t = static_cast<long long>(p.H) * p.n_split;

  // This split's keys: its even share of the row's live pages.  The
  // largest key any query of the row sees is len + Tq - 2.
  const int limit = len + Tq - 1;
  const int n_pages = (p.S + p.bt - 1) / p.bt;
  const int n_live =
      limit <= 0 ? 0 : min((limit + p.bt - 1) / p.bt, n_pages);
  const int j_begin = split * n_live / p.n_split * p.bt;
  const int j_end = min((split + 1) * n_live / p.n_split * p.bt, p.S);

  if (j_begin >= j_end) {  // no live page: an empty partial
    for (int i = tid; i < Tq * D; i += kThreads) {
      p.part_acc[(part0 + (i / D) * part_t) * D + i % D] = 0.f;
    }
    for (int t = tid; t < Tq; t += kThreads) {
      p.part_ml[2 * (part0 + t * part_t)] = kNegInf;
      p.part_ml[2 * (part0 + t * part_t) + 1] = 0.f;
    }
    return;
  }

  // Stage keys [j0, j0 + kKT) of the split into ring slot `slot`, zero
  // outside the split (no bytes read there).
  auto issue = [&](int slot, int j0) {
    for (int i = tid; i < kKT * kChunks; i += kThreads) {
      const int c = i / kChunks, ch = i % kChunks, j = j0 + c;
      const KV* k = static_cast<const KV*>(p.slot_k);
      const KV* v = static_cast<const KV*>(p.slot_v);
      const float* ks;
      const float* vs;
      long long at = 0;  // element offset of this 16-byte piece
      if (j < j_end) {
        at = (key_source<KV>(p, b, j, k, v, ks, vs) * p.H + h) * D +
             ch * (16 / static_cast<int>(sizeof(KV)));
      }
      const int dst = slot * kTileB + c * kRowB + ch * 16;
      tc::cp_async16(sK + dst, k + at, j < j_end);
      tc::cp_async16(sV + dst, v + at, j < j_end);
    }
    if constexpr (kQuant) {
      if (tid < kKT) {
        const int j = j0 + tid;
        const KV* k;
        const KV* v;
        const float* ks = p.slot_ks;
        const float* vs = p.slot_vs;
        long long at = 0;
        if (j < j_end) at = key_source<KV>(p, b, j, k, v, ks, vs) * p.H + h;
        tc::cp_async4(sKs + slot * kKT + tid, ks + at, j < j_end);
        tc::cp_async4(sVs + slot * kKT + tid, vs + at, j < j_end);
      }
    }
  };

  const int n_tiles = (j_end - j_begin + kKT - 1) / kKT;
  issue(0, j_begin);
  tc::cp_async_commit();
  const T* q = static_cast<const T*>(p.q);
  for (int i = tid; i < Tq * D; i += kThreads) {
    const int t = i / D, d = i % D;
    sQ[i] = to_f<T>(q[((static_cast<long long>(b) * Tq + t) * p.H + h) * D + d]);
    sAcc[i] = 0.f;
  }
  for (int t = tid; t < Tq; t += kThreads) {
    sM[t] = kNegInf;
    sL[t] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int slot = it & 1;
    const int j0 = j_begin + it * kKT;
    if (it + 1 < n_tiles) issue(slot ^ 1, j0 + kKT);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile it has landed (this thread's copies)
    __syncthreads();         // ... and everyone's; sQ, sM, sL are set
    const unsigned char* tK = sK + slot * kTileB;
    const unsigned char* tV = sV + slot * kTileB;
    const float* tKs = sKs + slot * kKT;
    const float* tVs = sVs + slot * kKT;

    // Scores: two threads a (query, key) pair, each over half of hd.  The
    // trip count is a multiple of 32 threads, so shuffles see whole warps.
    for (int i = tid; i < Tq * kKT * 2; i += kThreads) {
      const int half = i & 1, c = (i >> 1) % kKT, t = (i >> 1) / kKT;
      const float* qr = sQ + t * D + half * (D / 2);
      const unsigned char* kr = tK + c * kRowB + half * (D / 2) * sizeof(KV);
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < D / 2 / kPer; ++u) {
        float x[kPer];
        unpack8<KV>(kr + 8 * u, x);
#pragma unroll
        for (int e = 0; e < kPer; ++e) s += qr[u * kPer + e] * x[e];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (half == 0) {
        const int j = j0 + c;
        s *= p.scale;
        if constexpr (kQuant) s *= tKs[c];
        if (j >= j_end) {
          s = -INFINITY;  // not a key of this split
        } else if (j >= len + t) {
          s = kNegInf;
        }
        sW[t * kKT + c] = s;
      }
    }
    __syncthreads();

    // Online softmax, a warp a query row: one exp a score.
    for (int t = warp; t < Tq; t += kWarps) {
      float s[kKT / 32];
      float m_blk = -INFINITY;
#pragma unroll
      for (int u = 0; u < kKT / 32; ++u) {
        s[u] = sW[t * kKT + lane + 32 * u];
        m_blk = fmaxf(m_blk, s[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, o));
      const float m_prev = sM[t];
      const float m_new = fmaxf(m_prev, m_blk);
      float psum = 0.f;  // the softmax sum takes p before any v_scale
#pragma unroll
      for (int u = 0; u < kKT / 32; ++u) {
        const int c = lane + 32 * u;
        const float pj = expf(s[u] - m_new);
        psum += pj;
        sW[t * kKT + c] = kQuant ? pj * tVs[c] : pj;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[t] = corr;
        sM[t] = m_new;
        sL[t] = sL[t] * corr + psum;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V: four threads a (query, column pair), each over
    // a quarter of the keys.
    for (int i = tid; i < Tq * D * 2; i += kThreads) {
      const int kq = i & 3, d = 2 * ((i >> 2) % (D / 2)), t = (i >> 2) / (D / 2);
      const float* w = sW + t * kKT;
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
      for (int c = kq; c < kKT; c += 4) {
        const float2 x = load_pair<KV>(tV + c * kRowB, d);
        a0 += w[c] * x.x;
        a1 += w[c] * x.y;
      }
      a0 += __shfl_xor_sync(0xffffffffu, a0, 1);
      a1 += __shfl_xor_sync(0xffffffffu, a1, 1);
      a0 += __shfl_xor_sync(0xffffffffu, a0, 2);
      a1 += __shfl_xor_sync(0xffffffffu, a1, 2);
      if (kq == 0) {
        float* acc = sAcc + t * D + d;
        acc[0] = acc[0] * sC[t] + a0;
        acc[1] = acc[1] * sC[t] + a1;
      }
    }
    __syncthreads();  // ring slot it & 1 and sW are free
  }

  for (int i = tid; i < Tq * D; i += kThreads) {
    p.part_acc[(part0 + (i / D) * part_t) * D + i % D] = sAcc[i];
  }
  for (int t = tid; t < Tq; t += kThreads) {
    p.part_ml[2 * (part0 + t * part_t)] = sM[t];
    p.part_ml[2 * (part0 + t * part_t) + 1] = sL[t];
  }
}

// Merge the n_split partials of each (b, t, h) row, a warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    paged_attention_combine(const float* part_ml, const float* part_acc,
                            void* out, int rows, int n_split) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* ml = part_ml + 2 * static_cast<long long>(row) * n_split;
  const float* acc = part_acc + static_cast<long long>(row) * n_split * D;
  float m = kNegInf;
  for (int i = lane; i < n_split; i += 32) m = fmaxf(m, ml[2 * i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  for (int i = lane; i < n_split; i += 32) l += expf(ml[2 * i] - m) * ml[2 * i + 1];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float safe_l = l == 0.f ? 1.f : l;
  T* o_row = static_cast<T*>(out) + static_cast<long long>(row) * D;
  for (int d = lane; d < D; d += 32) {
    float a = 0.f;
    for (int i = 0; i < n_split; ++i) a += expf(ml[2 * i] - m) * acc[i * D + d];
    o_row[d] = from_f<T>(a / safe_l);
  }
}

template <typename T, typename KV, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<KV, D>(p.Tq);
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, KV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid(p.H, p.B, p.n_split);
  paged_attention_kernel<T, KV, D><<<grid, kThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = p.B * p.Tq * p.H;
  paged_attention_combine<T, D><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                                  stream>>>(p.part_ml, p.part_acc, p.out, rows,
                                            p.n_split);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, KV, 16>(p, stream);
    case 32: return launch<T, KV, 32>(p, stream);
    case 64: return launch<T, KV, 64>(p, stream);
    case 128: return launch<T, KV, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, int D, int is_bf16, bool quant, int device,
        void* stream) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.B <= 0 || p.Tq <= 0 || p.H <= 0) return 0;
  if (p.bt <= 0 || p.S <= 0 || p.n_split <= 0 || p.part_ml == nullptr ||
      p.part_acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (quant) {
    e = is_bf16 ? launch_d<__nv_bfloat16, int8_t>(p, D, st)
                : launch_d<float, int8_t>(p, D, st);
  } else {
    e = is_bf16 ? launch_d<__nv_bfloat16, __nv_bfloat16>(p, D, st)
                : launch_d<float, float>(p, D, st);
  }
  return static_cast<int>(e);
}

}  // namespace

// K/V rows must start on 16 bytes (cp.async); part_ml and part_acc are the
// f32 workspace of B * Tq * H * n_split * 2 and * hd floats.
extern "C" int paged_attention(const void* q, const void* slot_k,
                               const void* slot_v, const void* pool_k,
                               const void* pool_v, const void* table,
                               const void* cur_len, void* out, void* part_ml,
                               void* part_acc, int B, int Tq, int H, int D,
                               int S, int bt, int n_tab, int n_split,
                               float scale, int is_bf16, int device,
                               void* stream) {
  Params p{q, slot_k, slot_v, nullptr, nullptr, pool_k, pool_v, nullptr,
           nullptr, static_cast<const int32_t*>(table),
           static_cast<const int32_t*>(cur_len), out,
           static_cast<float*>(part_ml), static_cast<float*>(part_acc),
           B, Tq, H, S, bt, n_tab, n_split, scale};
  return run(p, D, is_bf16, false, device, stream);
}

// K8q: int8 K/V, f32 scales.  The pool's four leaves are all nullptr or all
// set; q and out are f32 or bf16 (is_bf16).
extern "C" int paged_attention_int8(const void* q, const void* slot_k,
                                    const void* slot_v, const void* slot_ks,
                                    const void* slot_vs, const void* pool_k,
                                    const void* pool_v, const void* pool_ks,
                                    const void* pool_vs, const void* table,
                                    const void* cur_len, void* out,
                                    void* part_ml, void* part_acc,
                                    int B, int Tq, int H, int D, int S, int bt,
                                    int n_tab, int n_split, float scale,
                                    int is_bf16, int device, void* stream) {
  if (slot_ks == nullptr || slot_vs == nullptr ||
      (pool_k != nullptr && (pool_ks == nullptr || pool_vs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, slot_k, slot_v, static_cast<const float*>(slot_ks),
           static_cast<const float*>(slot_vs), pool_k, pool_v,
           static_cast<const float*>(pool_ks), static_cast<const float*>(pool_vs),
           static_cast<const int32_t*>(table),
           static_cast<const int32_t*>(cur_len), out,
           static_cast<float*>(part_ml), static_cast<float*>(part_acc),
           B, Tq, H, S, bt, n_tab, n_split, scale};
  return run(p, D, is_bf16, true, device, stream);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
