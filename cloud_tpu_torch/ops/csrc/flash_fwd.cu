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
// running state in registers.  Ragged T is masked inside the kernel (keys
// past T are no keys at all, query rows past T are not written), so every
// prompt bucket and any T run without padding copies.  q/k/v are read
// through their strides, so the [B, T, H, D] layout needs no transpose.
//
// Two kernels.  bfloat16 (every main path) runs flash_fwd_kernel_tc on the
// tensor cores; float32 runs flash_fwd_kernel, an f32-only CUDA-core kernel
// whose products stay in full f32 (TF32 tensor cores would not hold the f32
// parity checks' 1e-4).
//
// bf16 design (flash_fwd_kernel_tc).  Route: mma.sync m16n8k16 with
// ldmatrix, not warpgroup wgmma.  The tiles here are small (64 x 64, a
// head dim of 64 at every main path) and the forward is short, so FA2's
// warp-level shape fits: each warp owns 16 query rows, its softmax runs on
// its own accumulator fragments, and the weights feed P.V straight from
// registers with no shared-memory round trip and no warpgroup barriers;
// the inline PTX needs no CUTLASS and keeps the build at nvcc's plain
// flags.  wgmma (m64, operands in shared memory through descriptors) is
// the next step if this kernel becomes the bottleneck again.
//   - 4 warps, 64 query rows a block; key tiles of 64.  Q is copied once
//     and held as A fragments in registers.  K and V tiles arrive 16
//     bytes a thread by cp.async into a 2-stage ring (tile j + 1 is in
//     flight while tile j is computed); rows are padded to D + 8 elements
//     so ldmatrix's eight row addresses hit distinct banks.  Rows past T
//     are zero-filled (cp.async with src-size 0).
//   - S = Q K^T on tensor cores, scaled in f32; masks applied to the
//     fragment (-inf past T, NEG_INF for padding and above the diagonal,
//     elementwise only in tiles that need it); one exp a score; row max
//     and sum reduced across the lane quad by shuffles (l sums the f32 p,
//     as the TPU kernel).  P is rounded to bf16 in registers (p.astype
//     (v.dtype) on the TPU) and is the A operand of O += P V, with V's B
//     fragments from ldmatrix.trans.
//   - The causal grid runs longest first: the block index's slowest part
//     is the query tile, counted from the diagonal end, so the tiles with
//     the most key tiles are scheduled before the short ones.
//   - Occupancy: B * H * ceil(T / 64) blocks of 128 threads; 768 at the LM
//     training shape (B=4, T=1024, H=12) and at BERT's (B=32, T=128), about
//     5.8 blocks per SM of the 132; at the serving prompt buckets (B=1,
//     T=32..512) 12..96 blocks, launch-bound.  Shared memory is 5 tiles of
//     64 x (D + 8) bf16: 46 KB at D=64, 87 KB at D=128 (set as the
//     dynamic limit below).
// What bounds it on H100: at the LM shape 6.4 GFLOP of products against 25
// MB, operation-bound on the tensor cores; at BERT's and serving shapes
// the bytes and the launch.
//
// Rows with no valid key (every key masked or causally hidden) get the
// plain version's answer: every score is NEG_INF there, so the softmax is
// uniform over all T keys.  The causal skip never visits the keys above the
// diagonal, so such rows sum V over all T keys in a second, scalar pass.
// No main path has such rows.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// float32 on the CUDA cores: 4 threads a query row, 32-key tiles staged in
// shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* sQ = smem;                     // [kBQ][D + 1]
  float* sK = sQ + kBQ * (D + 1);       // [kBK][D + 1]
  float* sV = sK + kBK * (D + 1);       // [kBK][D]
  float* sP = sV + kBK * D;             // [kBQ][kBK + 1]
  __shared__ int sValid[kBK];           // 1 valid, 0 masked, -1 past T

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
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
        pos < p.T ? q[b * p.sqb + pos * p.sqt + h * p.sqh + d] : 0.f;
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
        kv = k[b * p.skb + pos * p.skt + h * p.skh + d];
        vv = v[b * p.svb + pos * p.svt + h * p.svh + d];
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
      sP[r * (kBK + 1) + lane4 + 4 * j] = pj;  // V's type: f32, unrounded
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
            pos < p.T ? v[b * p.svb + pos * p.svt + h * p.svh + d] : 0.f;
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
  float* out = static_cast<float*>(p.out);
  const long long obase = ((static_cast<long long>(b) * p.T + qpos) * p.H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 4; ++j) {
    out[obase + lane4 + 4 * j] = acc[j] / safe_l;
  }
  if (lane4 == 0) {
    p.lse[(static_cast<long long>(b) * p.H + h) * p.T + qpos] = m + logf(safe_l);
  }
}

constexpr int kTcRows = 64;      // query rows per block, 16 per warp
constexpr int kTcKeys = 64;      // keys per tile
constexpr int kTcThreads = 128;  // 4 warps

template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_kernel_tc(Params p) {
  constexpr int kStride = D + 8;             // padded row, in elements
  constexpr int kTile = kTcKeys * kStride;   // one K or V stage
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sK = sQ + kTcRows * kStride;  // [2][kTcKeys][kStride]
  __nv_bfloat16* sV = sK + 2 * kTile;          // [2][kTcKeys][kStride]

  // Longest first: the slowest part of the block index is the query tile,
  // from the diagonal end when causal.
  const int n_tiles = (p.T + kTcRows - 1) / kTcRows;
  const int bh = blockIdx.x % (p.B * p.H);
  const int order = blockIdx.x / (p.B * p.H);
  const int qt = p.causal ? n_tiles - 1 - order : order;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kTcRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + h * p.skh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + h * p.svh;
  const int32_t* mask = p.mask == nullptr ? nullptr : p.mask + b * p.T;

  // Causal tile skip (query and key tiles are both 64 wide): key tiles
  // 0 .. qt, the last one on the diagonal.
  const int n_k = p.causal ? qt + 1 : n_tiles;
  tc::load_rows<D, kTcRows, kTcThreads>(sQ, q, p.sqt, q0, p.T);
  tc::load_rows<D, kTcKeys, kTcThreads>(sK, k, p.skt, 0, p.T);
  tc::load_rows<D, kTcKeys, kTcThreads>(sV, v, p.svt, 0, p.T);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    tc::ldsm_x4(qf[kk], sQ + (warp * 16 + tc::a_lane_row(lane)) * kStride +
                            kk * 16 + tc::a_lane_col(lane));
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int j = 0; j < n_k; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_k) {  // tile j + 1 into the other stage, in flight
      const int next = (j + 1) * kTcKeys;
      tc::load_rows<D, kTcKeys, kTcThreads>(sK + (stage ^ 1) * kTile, k,
                                            p.skt, next, p.T);
      tc::load_rows<D, kTcKeys, kTcThreads>(sV + (stage ^ 1) * kTile, v,
                                            p.svt, next, p.T);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile j has landed (this thread's copies)
    __syncthreads();         // ... and everyone's
    const __nv_bfloat16* tK = sK + stage * kTile;
    const __nv_bfloat16* tV = sV + stage * kTile;

    // S = Q K^T: 8 tiles of 8 keys, f32 accumulators.
    float s[kTcKeys / 8][4];
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np) {
        uint32_t r[4];
        tc::ldsm_x4(r, tK + (np * 16 + tc::b_lane_row(lane)) * kStride +
                           kk * 16 + tc::b_lane_col(lane));
        tc::mma(s[2 * np], qf[kk], r[0], r[1]);
        tc::mma(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    // Scale in f32, then mask: -inf past T (no key), NEG_INF for padding
    // and above the diagonal.  Interior tiles need none of it.
    const int k0 = j * kTcKeys;
    const bool full = mask == nullptr && k0 + kTcKeys <= p.T &&
                      !(p.causal && j == qt);
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * p.scale;
        if (!full) {
          const int key = k0 + 8 * i + 2 * t4 + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (key >= p.T) {
            x = -INFINITY;
          } else if ((mask != nullptr && mask[key] == 0) ||
                     (p.causal && key > row)) {
            x = kNegInf;
          }
        }
        s[i][e] = x;
      }
    }

    // Online softmax on the fragment: rows row0 (e = 0, 1), row0 + 8 (2, 3).
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[i][0], s[i][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[i][2], s[i][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = tc::quad_max(mx[r]);
      const float corr = __expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][2 * r] *= corr;
        o[i][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int i = 0; i < kTcKeys / 8; ++i) {
      s[i][0] = __expf(s[i][0] - m[0]);
      s[i][1] = __expf(s[i][1] - m[0]);
      s[i][2] = __expf(s[i][2] - m[1]);
      s[i][3] = __expf(s[i][3] - m[1]);
      l[0] += s[i][0] + s[i][1];  // the unrounded f32 weights
      l[1] += s[i][2] + s[i][3];
    }

    // O += P V, P rounded to bf16 in registers as the A operand.
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      uint32_t pa[4];
      tc::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t r[4];
        tc::ldsm_x4_t(r, tV + (kk * 16 + tc::bt_lane_row(lane)) * kStride +
                             dp * 16 + tc::bt_lane_col(lane));
        tc::mma(o[2 * dp], pa, r[0], r[1]);
        tc::mma(o[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // stage j & 1 is free for tile j + 2
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    l[r] = tc::quad_add(l[r]);
    if (row >= p.T) continue;
    if (m[r] <= kNegInf) {
      // No valid key: uniform weights over all T keys (scalar, rare).
      l[r] = static_cast<float>(p.T);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * i + 2 * t4 + e;
          float a = 0.f;
          for (int c = 0; c < p.T; ++c) {
            a += __bfloat162float(v[c * p.svt + d]);
          }
          o[i][2 * r + e] = a;
        }
      }
    }
    const float safe_l = l[r] == 0.f ? 1.f : l[r];
    const long long base =
        ((static_cast<long long>(b) * p.T + row) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(out + base + 8 * i + 2 * t4) =
          tc::pack(o[i][2 * r] / safe_l, o[i][2 * r + 1] / safe_l);
    }
    if (t4 == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.T + row] =
          m[r] + logf(safe_l);
    }
  }
}

template <int D>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((p.T + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (kTcRows + 4 * kTcKeys) * (D + 8);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int blocks = p.B * p.H * ((p.T + kTcRows - 1) / kTcRows);
  flash_fwd_kernel_tc<D><<<blocks, kTcThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, bool bf16, cudaStream_t stream) {
  return bf16 ? launch_bf16<D>(p, stream) : launch_f32<D>(p, stream);
}

cudaError_t launch_d(const Params& p, int d, bool bf16, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(p, bf16, stream);
    case 32: return launch<32>(p, bf16, stream);
    case 64: return launch<64>(p, bf16, stream);
    case 128: return launch<128>(p, bf16, stream);
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
  return static_cast<int>(launch_d(p, D, is_bf16 != 0, st));
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
