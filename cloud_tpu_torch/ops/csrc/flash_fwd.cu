// Causal flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel cloud_tpu/ops/flash_attention.py::_fwd_kernel
// (pallas_call in _fwd_pallas).  Same function: online-softmax attention
// over [B, T, H, D] with a causal tile skip, an optional [B, T] key-padding
// mask applied with the finite NEG_INF = -1e30, f32 softmax state, and a
// safe divide for rows whose softmax sum is zero.  Emits out [B, T, H, D]
// in the input type and lse [B, H, T] in f32.
//
// Translation.  The TPU grid walked key blocks as a sequential grid
// dimension carrying (m, l, acc) in VMEM scratch; here one block owns a
// (b, h, 64-row query tile) and walks the key tiles in a loop, with the
// running state in registers.  K/V tiles are staged in shared memory; Q
// stays in shared memory for the whole block.  Ragged T is masked inside
// the kernel (keys past T never contribute, query rows past T are not
// written), so every prompt bucket and any T run without padding copies.
// q/k/v are read through their strides, so the [B, T, H, D] layout needs
// no transpose.
//
// Rows with no valid key (every key masked or causally hidden) get the
// plain version's answer: every score is NEG_INF there, so the softmax is
// uniform over all T keys.  The causal skip never visits the keys above the
// diagonal, so such rows take a second pass over all key tiles that sums V.
//
// What bounds it on H100: at the serving prompt buckets (T = 32..512, one
// sequence per insert, 12 heads) the grid is 12..96 blocks, well under the
// 132 SMs, and the work is tiny, so launch latency and the FMA rate of the
// few active SMs bound it.  The design keeps one launch per layer, reads
// each K/V tile once per query tile, and skips tiles above the diagonal.
// Tensor-core (mma/wgmma) tiles and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 32;        // keys per staged tile
constexpr int kThreads = 256;  // 4 threads per query row

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* mask;  // [B, T] or nullptr
  void* out;            // [B, T, H, D] contiguous
  float* lse;           // [B, H, T] contiguous
  int B, T, H;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  int causal;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* sQ = smem;                     // [kBQ][D + 1]
  float* sK = sQ + kBQ * (D + 1);       // [kBK][D + 1]
  float* sV = sK + kBK * (D + 1);       // [kBK][D]
  float* sP = sV + kBK * D;             // [kBQ][kBK + 1]
  __shared__ int sValid[kBK];           // 1 valid, 0 masked, -1 past T

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r = tid >> 2;       // this thread's query row in the tile
  const int lane4 = tid & 3;    // which quarter of the row it owns
  const int qpos = q0 + r;
  const bool row_ok = qpos < p.T;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D, pos = q0 + rr;
    sQ[rr * (D + 1) + d] =
        pos < p.T ? to_f<T>(q[b * p.sqb + pos * p.sqt + h * p.sqh + d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;

  // Causal tile skip: no row of this tile sees a key at or past q0 + kBQ.
  const int k_end = p.causal ? min(p.T, q0 + kBQ) : p.T;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D, pos = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (pos < p.T) {
        kv = to_f<T>(k[b * p.skb + pos * p.skt + h * p.skh + d]);
        vv = to_f<T>(v[b * p.svb + pos * p.svt + h * p.svh + d]);
      }
      sK[c * (D + 1) + d] = kv;
      sV[c * D + d] = vv;
    }
    if (tid < kBK) {
      const int pos = k0 + tid;
      sValid[tid] = pos >= p.T ? -1
                  : (p.mask == nullptr || p.mask[b * p.T + pos] != 0) ? 1 : 0;
    }
    __syncthreads();

    float s[kBK / 4];
    float m_blk = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const int c = lane4 + 4 * j;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot += sQ[r * (D + 1) + d] * sK[c * (D + 1) + d];
      dot *= p.scale;
      const int valid = sValid[c];
      if (valid < 0) {
        dot = -INFINITY;  // past T: not a key at all
      } else if (valid == 0 || (p.causal && k0 + c > qpos)) {
        dot = kNegInf;
      }
      s[j] = dot;
      m_blk = fmaxf(m_blk, dot);
    }
    m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, 1));
    m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, 2));
    const float m_new = fmaxf(m, m_blk);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float pj = expf(s[j] - m_new);
      psum += pj;
      // The weights meet V in V's type, as p.astype(v.dtype) on the TPU.
      sP[r * (kBK + 1) + lane4 + 4 * j] = to_f<T>(from_f<T>(pj));
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // row r's weights come from the 4 lanes that read them
#pragma unroll
    for (int j = 0; j < D / 4; ++j) {
      const int d = lane4 + 4 * j;
      float a = acc[j] * corr;
#pragma unroll 8
      for (int c = 0; c < kBK; ++c) a += sP[r * (kBK + 1) + c] * sV[c * D + d];
      acc[j] = a;
    }
  }

  // Rows that saw no valid key: uniform weights over all T keys.
  const int empty = row_ok && m <= kNegInf;
  if (__syncthreads_or(empty)) {
    if (empty) {
      l = static_cast<float>(p.T);
#pragma unroll
      for (int j = 0; j < D / 4; ++j) acc[j] = 0.f;
    }
    for (int k0 = 0; k0 < p.T; k0 += kBK) {
      __syncthreads();
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int c = i / D, d = i % D, pos = k0 + c;
        sV[c * D + d] =
            pos < p.T ? to_f<T>(v[b * p.svb + pos * p.svt + h * p.svh + d]) : 0.f;
      }
      __syncthreads();
      if (empty) {
#pragma unroll
        for (int j = 0; j < D / 4; ++j) {
          const int d = lane4 + 4 * j;
          float a = acc[j];
          for (int c = 0; c < kBK; ++c) a += sV[c * D + d];
          acc[j] = a;
        }
      }
    }
  }

  if (!row_ok) return;
  const float safe_l = l == 0.f ? 1.f : l;
  T* out = static_cast<T*>(p.out);
  const long long obase = ((static_cast<long long>(b) * p.T + qpos) * p.H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    out[obase + lane4 + 4 * j] = from_f<T>(acc[j] / safe_l);
  }
  if (lane4 == 0) {
    p.lse[(static_cast<long long>(b) * p.H + h) * p.T + qpos] = m + logf(safe_l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((p.T + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* out, void* lse,
                         int B, int T, int H, int D,
                         long long sqb, long long sqt, long long sqh,
                         long long skb, long long skt, long long skh,
                         long long svb, long long svt, long long svh,
                         int causal, float scale, int is_bf16, int device,
                         void* stream) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  Params p{q, k, v, static_cast<const int32_t*>(mask), out,
           static_cast<float*>(lse), B, T, H,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? launch_d<__nv_bfloat16>(p, D, st)
                          : launch_d<float>(p, D, st);
  return static_cast<int>(e);
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
