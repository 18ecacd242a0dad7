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
// the P.V product; keys past S get zero K/V and v_scale 0.
//
// Translation.  The TPU grid walked (row, page) with the table and lengths
// scalar-prefetched and the online-softmax state in VMEM scratch.  Here one
// block owns one (row b, head h) and loops over that row's live pages; the
// loop bound ceil((cur_len[b] + Tq - 1) / bt) is the dead-page skip.  For
// each page the block reads its table entry itself, then stages the page's
// K/V (and, for K8q, its scales) from the slot row or from the pool into
// shared memory as f32, 32 keys at a time; int8 K/V arrive as char4 loads,
// four bytes a thread.  Key lanes at or beyond S are zeroed before the P.V
// product.  Each warp owns whole query rows: one lane per staged key for the
// scores, one lane per output column for the accumulator, so the softmax
// reductions are warp shuffles and the running (m, l, acc) never leave the
// block.
//
// What bounds it on H100: the K/V bytes it reads.  A decode step reads
// every live page of every slot once per layer and does two FLOPs per byte
// (four per byte for int8), far below the card's ~295 FLOPs/byte balance
// point.  The design reads each live K/V element exactly once per (row,
// head), skips dead pages, and makes neighbouring threads read neighbouring
// bytes of a page.  K8q reads 2*hd + 8 bytes per live (key, head) against
// 4*hd for bf16.  Splitting the page loop across blocks (flash-decoding) to
// fill all SMs at small batch is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kKT = 32;        // keys per staged tile (one per warp lane)
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
  int B, Tq, H, S, bt, n_tab;
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

// T: the type of q and out.  KV: the type of the stored K/V, T itself (K8)
// or int8_t (K8q, with per-(position, head) scales).
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params p) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  extern __shared__ float smem[];
  const int Tq = p.Tq;
  float* sQ = smem;                    // [Tq][D + 1]
  float* sK = sQ + Tq * (D + 1);       // [kKT][D + 1]
  float* sV = sK + kKT * (D + 1);      // [kKT][D]
  float* sP = sV + kKT * D;            // [Tq][kKT]
  float* sAcc = sP + Tq * kKT;         // [Tq][D]
  float* sM = sAcc + Tq * D;           // [Tq]
  float* sL = sM + Tq;                 // [Tq]
  __shared__ int sIn[kKT];             // 1: a key of this page below S
  __shared__ float sKs[kKT];           // K8q: k_scale of each staged key
  __shared__ float sVs[kKT];           // K8q: v_scale (0 past S)

  const T* q = static_cast<const T*>(p.q);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = p.cur_len[b];

  for (int i = tid; i < Tq * D; i += kThreads) {
    const int t = i / D, d = i % D;
    sQ[t * (D + 1) + d] =
        to_f<T>(q[((static_cast<long long>(b) * Tq + t) * p.H + h) * D + d]);
    sAcc[i] = 0.f;
  }
  for (int t = tid; t < Tq; t += kThreads) {
    sM[t] = kNegInf;
    sL[t] = 0.f;
  }

  // Dead-page skip: the largest key any query of this row sees is
  // len + Tq - 2, so pages from ceil((len + Tq - 1) / bt) on are never read.
  const int limit = len + Tq - 1;
  const int n_pages_total = (p.S + p.bt - 1) / p.bt;
  const int n_live = limit <= 0 ? 0 : min((limit + p.bt - 1) / p.bt, n_pages_total);

  for (int page = 0; page < n_live; ++page) {
    int entry = -1;
    if (p.table != nullptr && page < p.n_tab) entry = p.table[b * p.n_tab + page];
    const bool from_pool = entry >= 0 && p.pool_k != nullptr;
    const KV* ksrc;
    const KV* vsrc;
    const float* kssrc;
    const float* vssrc;
    long long row;  // index of this page's first key in [rows, H] order
    if (from_pool) {
      ksrc = static_cast<const KV*>(p.pool_k);
      vsrc = static_cast<const KV*>(p.pool_v);
      kssrc = p.pool_ks;
      vssrc = p.pool_vs;
      row = static_cast<long long>(entry) * p.bt;
    } else {
      ksrc = static_cast<const KV*>(p.slot_k);
      vsrc = static_cast<const KV*>(p.slot_v);
      kssrc = p.slot_ks;
      vssrc = p.slot_vs;
      row = static_cast<long long>(b) * p.S + static_cast<long long>(page) * p.bt;
    }
    const long long base = (row * p.H + h) * D;  // element offset, head h
    for (int sub0 = 0; sub0 < p.bt; sub0 += kKT) {
      const int j0 = page * p.bt + sub0;
      if (j0 >= p.S) break;
      __syncthreads();  // the previous tile's readers are done
      if constexpr (kQuant) {
        // char4 loads: four int8 of one key row a thread.
        for (int i = tid; i < kKT * (D / 4); i += kThreads) {
          const int c = i / (D / 4), d = (i % (D / 4)) * 4, off = sub0 + c;
          char4 kc = make_char4(0, 0, 0, 0), vc = make_char4(0, 0, 0, 0);
          if (off < p.bt && j0 + c < p.S) {
            const long long at = base + static_cast<long long>(off) * p.H * D + d;
            kc = *reinterpret_cast<const char4*>(ksrc + at);
            vc = *reinterpret_cast<const char4*>(vsrc + at);
          }
          float* kd = sK + c * (D + 1) + d;
          kd[0] = kc.x; kd[1] = kc.y; kd[2] = kc.z; kd[3] = kc.w;
          float* vd = sV + c * D + d;
          vd[0] = vc.x; vd[1] = vc.y; vd[2] = vc.z; vd[3] = vc.w;
        }
        if (tid < kKT) {
          const int off = sub0 + tid;
          const bool in = off < p.bt && j0 + tid < p.S;
          const long long at = (row + off) * p.H + h;
          sKs[tid] = in ? kssrc[at] : 0.f;
          sVs[tid] = in ? vssrc[at] : 0.f;
        }
      } else {
        for (int i = tid; i < kKT * D; i += kThreads) {
          const int c = i / D, d = i % D, off = sub0 + c;
          float kv = 0.f, vv = 0.f;  // lanes past the page or past S stay zero
          if (off < p.bt && j0 + c < p.S) {
            const long long at = base + static_cast<long long>(off) * p.H * D + d;
            kv = to_f<KV>(ksrc[at]);
            vv = to_f<KV>(vsrc[at]);
          }
          sK[c * (D + 1) + d] = kv;
          sV[c * D + d] = vv;
        }
      }
      if (tid < kKT) sIn[tid] = (sub0 + tid < p.bt) && (j0 + tid < p.S);
      __syncthreads();

      for (int t = warp; t < Tq; t += kWarps) {
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) s += sQ[t * (D + 1) + d] * sK[lane * (D + 1) + d];
        s *= p.scale;
        if constexpr (kQuant) s *= sKs[lane];
        if (!sIn[lane]) {
          s = -INFINITY;  // not a key of this row at all
        } else if (j0 + lane >= len + t) {
          s = kNegInf;
        }
        float m_blk = s;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, o));
        const float m_prev = sM[t];
        const float l_prev = sL[t];
        const float m_new = fmaxf(m_prev, m_blk);
        const float pj = expf(s - m_new);
        float psum = pj;  // the softmax sum takes p before any v_scale
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, o);
        const float corr = expf(m_prev - m_new);
        sP[t * kKT + lane] = kQuant ? pj * sVs[lane] : pj;
        __syncwarp();
        for (int d = lane; d < D; d += 32) {
          float a = sAcc[t * D + d] * corr;
#pragma unroll 8
          for (int c = 0; c < kKT; ++c) a += sP[t * kKT + c] * sV[c * D + d];
          sAcc[t * D + d] = a;
        }
        __syncwarp();  // every lane has read sM/sL/sP for this row
        if (lane == 0) {
          sM[t] = m_new;
          sL[t] = l_prev * corr + psum;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  T* out = static_cast<T*>(p.out);
  for (int i = tid; i < Tq * D; i += kThreads) {
    const int t = i / D, d = i % D;
    const float l = sL[t];
    const float safe_l = l == 0.f ? 1.f : l;
    out[((static_cast<long long>(b) * Tq + t) * p.H + h) * D + d] =
        from_f<T>(sAcc[i] / safe_l);
  }
}

size_t smem_bytes(int tq, int d) {
  return sizeof(float) *
         (tq * (d + 1) + kKT * (d + 1) + kKT * d + tq * kKT + tq * d + 2 * tq);
}

template <typename T, typename KV, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.Tq, D);
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, KV, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  dim3 grid(p.H, p.B);
  paged_attention_kernel<T, KV, D><<<grid, kThreads, smem, stream>>>(p);
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
  if (p.bt <= 0 || p.S <= 0) return static_cast<int>(cudaErrorInvalidValue);
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

extern "C" int paged_attention(const void* q, const void* slot_k,
                               const void* slot_v, const void* pool_k,
                               const void* pool_v, const void* table,
                               const void* cur_len, void* out,
                               int B, int Tq, int H, int D, int S, int bt,
                               int n_tab, float scale, int is_bf16,
                               int device, void* stream) {
  Params p{q, slot_k, slot_v, nullptr, nullptr, pool_k, pool_v, nullptr,
           nullptr, static_cast<const int32_t*>(table),
           static_cast<const int32_t*>(cur_len), out,
           B, Tq, H, S, bt, n_tab, scale};
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
                                    int B, int Tq, int H, int D, int S, int bt,
                                    int n_tab, float scale, int is_bf16,
                                    int device, void* stream) {
  if (slot_ks == nullptr || slot_vs == nullptr ||
      (pool_k != nullptr && (pool_ks == nullptr || pool_vs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, slot_k, slot_v, static_cast<const float*>(slot_ks),
           static_cast<const float*>(slot_vs), pool_k, pool_v,
           static_cast<const float*>(pool_ks), static_cast<const float*>(pool_vs),
           static_cast<const int32_t*>(table),
           static_cast<const int32_t*>(cur_len), out,
           B, Tq, H, S, bt, n_tab, scale};
  return run(p, D, is_bf16, true, device, stream);
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
