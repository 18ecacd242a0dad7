// Flash-attention backward for Hopper (sm_90a), plain C interface: K6 (dq)
// and K7 (dk, dv).
//
// Replaces the TPU kernels cloud_tpu/ops/flash_attention.py::_bwd_dq_kernel
// and ::_bwd_dkv_kernel (both pallas_calls in _bwd_pallas).  Same function,
// the recompute scheme: with the forward's lse and rowterm = delta - g_lse
// (delta = rowsum(dO * O), both [B, H, T] f32, computed by the caller),
//   s  = scale * q k^T, then NEG_INF where causal (q_pos < k_pos) or where
//        the [B, T] key-padding mask is zero,
//   p  = exp(s - lse),  dp = dO v^T,  ds = p * (dp - rowterm),
//   dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T dO,
// with p and ds rounded to the input type before their products, as the TPU
// kernel casts them before its MXU dots; sums are f32 and the outputs are
// written in the input type.  q/k/v/dO are read through their strides in
// the [B, T, H, D] layout, so no transpose copy is made.
//
// Translation.  The TPU carried dq across the sequential key axis of its
// grid, and dk/dv across the query axis, in VMEM scratch.  Here a K6 block
// owns a (b, h, 64-row query tile) and loops over key tiles; a K7 block
// owns a (b, h, 64-key tile) and loops over query tiles.  Each block
// writes only its own rows, so there are no atomics and the result does not
// depend on scheduling.  The causal tile skip carries over: K6 stops after
// the 64-key block that holds its last row's diagonal, K7 starts at the
// query tile of its first key; inside a tile the mask compares global
// positions.  Ragged T is masked in the kernel: keys past T are no keys
// (p = 0), query rows past T contribute nothing and are not written.
//
// In float32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): four threads
// share a row; thread g holds dims 4 (g + 4 j) .. +3 of its row (q and dO
// for K6, k and v for K7) and of its accumulators in registers, so a dot
// product is a partial sum over those dims plus two shuffles, and the
// staged 32-row tile is read as float4 broadcast across the warp's rows.
// Products on the CUDA cores in f32 (TF32 tensor cores would not hold the
// f32 parity checks' 1e-4).
//
// In bfloat16 (every main path) K6 runs flash_bwd_dq_kernel_tc and K7
// flash_bwd_dkv_kernel_tc, both on the tensor cores.  Route: mma.sync
// m16n8k16 with ldmatrix, as K5 (see flash_fwd.cu for why not wgmma);
// helpers and fragment layouts in mma_bf16.cuh.
//
// K6 in bf16 (flash_bwd_dq_kernel_tc):
//   - 4 warps, a block owns a (b, h, 64-row query tile), each warp 16
//     rows.  Q and dO are copied once and held as A fragments in
//     registers for the whole walk, beside the rows' lse and rowterm.
//   - The block walks key tiles of 32 keys: K and V arrive by cp.async in
//     a 2-stage ring, tile j + 1 in flight while tile j is computed, rows
//     padded to D + 8 elements for conflict-free ldmatrix, zero past T.
//     32 keys, not 64, because the kernel is latency-bound: S and dP of
//     32 keys fit a cap of 128 registers, so 4 blocks (16 warps) share an
//     SM, where 64-key tiles took 176 registers and left 2.
//   - Per key tile: S = Q K^T and dP = dO V^T on tensor cores (f32
//     accumulators; K and V row-major are the B operand through
//     ldmatrix); per element, owned by one thread, so one exp a (query,
//     key) pair: scale, mask, p = exp(s - lse), ds = p (dp - rowterm).  dS
//     is rounded to bf16 in registers (the TPU kernel's cast before its
//     MXU dot) and is the A operand of dQ += dS K, K's B fragments from
//     ldmatrix.trans: the C fragments of two 8-key tiles are the A
//     fragment of 16 keys (mma_bf16.cuh).
//   - dQ is scaled by `scale` at the end and written in bf16 by the
//     block that owns the rows.  No atomics.
//   - Grid: B * H * ceil(T / 64) blocks of 128 threads, query tile
//     slowest and, under causal masking, counted from the last tile, so
//     the longest blocks are scheduled first: 768 at both training
//     shapes.  Shared memory 37 KB at D=64, 70 KB at D=128.
//
// K7 in bf16 (flash_bwd_dkv_kernel_tc):
//   - 4 warps, a block owns a (b, h, 64-key tile), each warp 16 keys.  K
//     and V are copied once into shared memory and read as A fragments.
//     The block walks query tiles of 64 rows (32 at D=128, where 64 would
//     not fit the registers): Q, dO, lse and rowterm arrive by cp.async in
//     a 2-stage ring, tile i + 1 in flight while tile i is computed, rows
//     padded to D + 8 elements for conflict-free ldmatrix, zero past T.
//   - Per query tile: S^T = K Q^T and dP^T = V dO^T on tensor cores (f32
//     accumulators); per element, owned by one thread, so one exp a (key,
//     query) pair: scale, mask, p = exp(s - lse), ds = p (dp - rowterm).
//     P^T and dS^T are rounded to bf16 in registers (the TPU kernel's
//     casts before its MXU dots) and are the A operands of dV += P^T dO
//     and dK += dS^T Q, with dO's and Q's B fragments from ldmatrix.trans.
//   - dK is scaled by `scale` at the end; dK and dV are written in bf16 by
//     the block that owns the keys.  No atomics.
//   - Grid: B * H * ceil(T / 64) blocks of 128 threads, key tile slowest,
//     so under the causal skip the longest blocks (the first keys, which
//     every later query sees) are scheduled first: 768 blocks at both
//     training shapes.  Shared memory 55 KB at D=64, 70 KB at D=128.
//
// Rows with no valid key.  The forward leaves lse = NEG_INF exactly there
// (-1e30 + log T rounds back to -1e30 in f32), so p = exp(NEG_INF - lse) =
// 1 for every masked key, as in the TPU kernel, not the forward's 1/T.
// Without causal masking this is every key, as the plain version computes.
// With causal masking the TPU kernel's answer depends on its tiles (keys
// above the diagonal in a visited tile count, skipped tiles do not); each
// kernel here does the same with its own tiles, and all of them visit one
// set.  K7 (both types): such a row gets p = 1 from every key of its own
// 64-key block and the blocks before it, 0 from later blocks.  K6 (both
// types) walks its key tiles, 32 keys wide, up to min(T, q0 + 64) for its
// 64-row query tile at q0: the end of the 64-key block that holds the
// tile's last diagonal, the same set (the bf16 K6 also drops a row's keys
// past its own 64-key block, so a taller query tile would keep it).  The
// causal LM never has such rows: position 0 always sees itself.
//
// What bounds it on H100.  At head_dim 64, K6 does 3 and K7 4 products of
// B*H*T*T*D multiply-adds (half of them under the causal skip): at the LM
// training shape (B=4, T=1024, H=12) that is 9.7 and 12.9 GFLOP against
// ~32 and ~38 MB, operation-bound on the tensor cores; at BERT's (B=32,
// T=128) the bytes bound it.  Both keep one read of each K/V (K6) or
// Q/dO (K7) tile per block, no [T, T] intermediate in device memory, and
// the causal half skipped.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;        // 4 threads per row
constexpr int kRows = kThreads / 4;  // rows a block owns: queries (K6), keys (K7)
constexpr int kTile = 32;            // rows staged per loop step

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;      // [B, H, T]
  const float* rowterm;  // [B, H, T]: delta - g_lse
  const int32_t* mask;   // [B, T] or nullptr
  void* dq;              // [B, T, H, D] contiguous
  void* dk;
  void* dv;
  int B, T, H;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  int causal;
  float scale;
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Load this thread's dims (4 (g + 4 j) + u) of one [D] row into regs.
template <int D>
__device__ __forceinline__ void load_row(const float* src, bool ok, int g,
                                         float (&dst)[D / 4]) {
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int d = 4 * (g + 4 * j) + u;
      dst[4 * j + u] = ok ? src[d] : 0.f;
    }
  }
}

// Stage rows [r0, r0 + kTile) of two [B, T, H, D] tensors, zero past T.
template <int D>
__device__ __forceinline__ void stage(float* sa, float* sb, const float* a,
                                      const float* b, long long a0, long long sat,
                                      long long b0, long long sbt, int r0,
                                      int T_) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D, pos = r0 + r;
    float x = 0.f, y = 0.f;
    if (pos < T_) {
      x = a[a0 + pos * sat + d];
      y = b[b0 + pos * sbt + d];
    }
    sa[i] = x;
    sb[i] = y;
  }
}

// Partial dots of regs x, y with staged rows ra, rb over this thread's dims.
template <int D>
__device__ __forceinline__ void dots(const float (&x)[D / 4],
                                     const float (&y)[D / 4], const float* ra,
                                     const float* rb, int g, float& sx,
                                     float& sy) {
  const float4* a4 = reinterpret_cast<const float4*>(ra);
  const float4* b4 = reinterpret_cast<const float4*>(rb);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const float4 a = a4[g + 4 * j];
    const float4 b = b4[g + 4 * j];
    sx += x[4 * j] * a.x + x[4 * j + 1] * a.y + x[4 * j + 2] * a.z + x[4 * j + 3] * a.w;
    sy += y[4 * j] * b.x + y[4 * j + 1] * b.y + y[4 * j + 2] * b.z + y[4 * j + 3] * b.w;
  }
}

// acc += w * staged row, over this thread's dims.
template <int D>
__device__ __forceinline__ void axpy(float (&acc)[D / 4], float w,
                                     const float* row, int g) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const float4 a = r4[g + 4 * j];
    acc[4 * j] += w * a.x;
    acc[4 * j + 1] += w * a.y;
    acc[4 * j + 2] += w * a.z;
    acc[4 * j + 3] += w * a.w;
  }
}

template <int D>
__device__ __forceinline__ void store_row(void* dst, long long base, int g,
                                          const float (&x)[D / 4], float mul) {
  float* out = static_cast<float*>(dst) + base;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
#pragma unroll
    for (int u = 0; u < 4; ++u) out[4 * (g + 4 * j) + u] = mul * x[4 * j + u];
  }
}

// K6 in float32 (the bf16 K6 is flash_bwd_dq_kernel_tc below): dq for one
// (b, h, 64-row query tile), looping over 32-key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  __shared__ __align__(16) float sK[kTile * D];
  __shared__ __align__(16) float sV[kTile * D];
  __shared__ int sValid[kTile];  // 1 valid key, 0 masked, -1 past T

  const int tid = threadIdx.x, r = tid >> 2, g = tid & 3;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int qpos = q0 + r;
  const bool row_ok = qpos < p.T;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);

  float qr[D / 4], dor[D / 4], acc[D / 4];
  load_row<D>(q + b * p.sqb + qpos * p.sqt + h * p.sqh, row_ok, g, qr);
  load_row<D>(dout + b * p.sob + qpos * p.sot + h * p.soh, row_ok, g, dor);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  const long long row = (static_cast<long long>(b) * p.H + h) * p.T + qpos;
  const float lse = row_ok ? p.lse[row] : 0.f;
  const float rt = row_ok ? p.rowterm[row] : 0.f;

  // Causal tile skip: no row of this tile sees a key at or past q0 + kRows.
  const int k_end = p.causal ? min(p.T, q0 + kRows) : p.T;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    stage<D>(sK, sV, k, v, b * p.skb + h * p.skh, p.skt,
             b * p.svb + h * p.svh, p.svt, k0, p.T);
    if (tid < kTile) {
      const int pos = k0 + tid;
      sValid[tid] = pos >= p.T ? -1
                  : (p.mask == nullptr || p.mask[b * p.T + pos] != 0) ? 1 : 0;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      float s = 0.f, dp = 0.f;
      dots<D>(qr, dor, sK + c * D, sV + c * D, g, s, dp);
      s = quad_sum(s);
      dp = quad_sum(dp);
      const int valid = sValid[c];
      float ds = 0.f;
      if (row_ok && valid >= 0) {
        s *= p.scale;
        if (valid == 0 || (p.causal && k0 + c > qpos)) s = kNegInf;
        ds = expf(s - lse) * (dp - rt);  // f32: no rounding to the type
      }
      axpy<D>(acc, ds, sK + c * D, g);
    }
  }
  if (!row_ok) return;
  store_row<D>(p.dq, ((static_cast<long long>(b) * p.T + qpos) * p.H + h) * D,
               g, acc, p.scale);
}

// K7 in float32 (the bf16 K7 is flash_bwd_dkv_kernel_tc below): dk and dv
// for one (b, h, 64-key tile), looping over query tiles.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  __shared__ __align__(16) float sQ[kTile * D];
  __shared__ __align__(16) float sO[kTile * D];
  __shared__ float sLse[kTile];
  __shared__ float sRt[kTile];
  __shared__ int sRowOk[kTile];

  const int tid = threadIdx.x, c = tid >> 2, g = tid & 3;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kpos = k0 + c;
  const bool key_ok = kpos < p.T;
  // The mask entry of this block's own key rows.
  const bool key_valid =
      key_ok && (p.mask == nullptr || p.mask[b * p.T + kpos] != 0);
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);

  float kr[D / 4], vr[D / 4], dk[D / 4], dv[D / 4];
  load_row<D>(k + b * p.skb + kpos * p.skt + h * p.skh, key_ok, g, kr);
  load_row<D>(v + b * p.svb + kpos * p.svt + h * p.svh, key_ok, g, vr);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;

  // Causal tile skip: query rows before k0 see none of this key tile.
  const int q_begin = p.causal ? k0 : 0;
  for (int q0 = q_begin; q0 < p.T; q0 += kTile) {
    __syncthreads();
    stage<D>(sQ, sO, q, dout, b * p.sqb + h * p.sqh, p.sqt,
             b * p.sob + h * p.soh, p.sot, q0, p.T);
    if (tid < kTile) {
      const int pos = q0 + tid;
      const bool ok = pos < p.T;
      sRowOk[tid] = ok;
      sLse[tid] = ok ? p.lse[rows + pos] : 0.f;
      sRt[tid] = ok ? p.rowterm[rows + pos] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float s = 0.f, dp = 0.f;
      dots<D>(kr, vr, sQ + r * D, sO + r * D, g, s, dp);
      s = quad_sum(s);
      dp = quad_sum(dp);
      float pc = 0.f, ds = 0.f;
      if (key_ok && sRowOk[r]) {
        s *= p.scale;
        if (!key_valid || (p.causal && kpos > q0 + r)) s = kNegInf;
        pc = expf(s - sLse[r]);  // f32: the input type needs no rounding
        ds = pc * (dp - sRt[r]);
      }
      axpy<D>(dv, pc, sO + r * D, g);
      axpy<D>(dk, ds, sQ + r * D, g);
    }
  }
  if (!key_ok) return;
  const long long base = ((static_cast<long long>(b) * p.T + kpos) * p.H + h) * D;
  store_row<D>(p.dk, base, g, dk, p.scale);
  store_row<D>(p.dv, base, g, dv, 1.f);
}

constexpr int kTcKeys = 64;      // keys a K7 block owns, 16 per warp
constexpr int kTcThreads = 128;  // 4 warps

// Query rows per staged tile of the bf16 K7: 64, or 32 at D=128, where
// S^T, dP^T, dK and dV at 64 rows would not fit in the registers.
template <int D> __host__ __device__ constexpr int tc_q_rows() {
  return D == 128 ? 32 : 64;
}

template <int D> constexpr size_t tc_dkv_smem() {
  return sizeof(__nv_bfloat16) * (2 * kTcKeys + 4 * tc_q_rows<D>()) * (D + 8) +
         sizeof(float) * 4 * tc_q_rows<D>();
}

// K7 in bf16 on the tensor cores: dk and dv for one (b, h, 64-key tile).
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkv_kernel_tc(Params p) {
  constexpr int kQ = tc_q_rows<D>();
  constexpr int kStride = D + 8;  // padded row, in elements
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sV = sK + kTcKeys * kStride;
  __nv_bfloat16* sQ = sV + kTcKeys * kStride;  // [2][kQ][kStride]
  __nv_bfloat16* sO = sQ + 2 * kQ * kStride;   // [2][kQ][kStride]
  float* sLse = reinterpret_cast<float*>(sO + 2 * kQ * kStride);  // [2][kQ]
  float* sRt = sLse + 2 * kQ;                                     // [2][kQ]

  // Key tile slowest in the block index: the first keys, which under the
  // causal skip walk the most query tiles, are scheduled first.
  const int bh = blockIdx.x % (p.B * p.H);
  const int k0 = (blockIdx.x / (p.B * p.H)) * kTcKeys;
  const int b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + h * p.skh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + h * p.svh;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.sob + h * p.soh;
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
  const float* lse = p.lse + rows;
  const float* rowterm = p.rowterm + rows;
  bool key_ok[2], key_valid[2];  // inside T; and not masked out
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    key_ok[r] = key < p.T;
    key_valid[r] =
        key_ok[r] && (p.mask == nullptr || p.mask[b * p.T + key] != 0);
  }

  // Stage query tile i (rows q0 .. q0 + kQ) into ring slot i & 1.
  auto issue = [&](int slot, int q0) {
    tc::load_rows<D, kQ, kTcThreads>(sQ + slot * kQ * kStride, q, p.sqt, q0,
                                     p.T);
    tc::load_rows<D, kQ, kTcThreads>(sO + slot * kQ * kStride, dout, p.sot,
                                     q0, p.T);
    if (threadIdx.x < kQ) {
      const int pos = q0 + threadIdx.x;
      const bool ok = pos < p.T;
      tc::cp_async4(sLse + slot * kQ + threadIdx.x, lse + (ok ? pos : 0), ok);
      tc::cp_async4(sRt + slot * kQ + threadIdx.x, rowterm + (ok ? pos : 0),
                    ok);
    }
  };

  // Causal tile skip: query rows before k0 see none of this key tile.
  const int q_begin = p.causal ? k0 : 0;
  const int n_q = (p.T - q_begin + kQ - 1) / kQ;
  tc::load_rows<D, kTcKeys, kTcThreads>(sK, k, p.skt, k0, p.T);
  tc::load_rows<D, kTcKeys, kTcThreads>(sV, v, p.svt, k0, p.T);
  issue(0, q_begin);
  tc::cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  }

  for (int it = 0; it < n_q; ++it) {
    const int slot = it & 1;
    const int q0 = q_begin + it * kQ;
    if (it + 1 < n_q) issue(slot ^ 1, q0 + kQ);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile it (and K, V) landed: this thread's
    __syncthreads();         // ... and everyone's copies
    const __nv_bfloat16* tQ = sQ + slot * kQ * kStride;
    const __nv_bfloat16* tO = sO + slot * kQ * kStride;
    const float* tLse = sLse + slot * kQ;
    const float* tRt = sRt + slot * kQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kQ queries.
    float s[kQ / 8][4], dp[kQ / 8][4];
#pragma unroll
    for (int i = 0; i < kQ / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      const int a_off = (warp * 16 + tc::a_lane_row(lane)) * kStride +
                        kk * 16 + tc::a_lane_col(lane);
      tc::ldsm_x4(ka, sK + a_off);
      tc::ldsm_x4(va, sV + a_off);
#pragma unroll
      for (int np = 0; np < kQ / 16; ++np) {
        const int b_off = (np * 16 + tc::b_lane_row(lane)) * kStride +
                          kk * 16 + tc::b_lane_col(lane);
        uint32_t rq[4], ro[4];
        tc::ldsm_x4(rq, tQ + b_off);
        tc::ldsm_x4(ro, tO + b_off);
        tc::mma(s[2 * np], ka, rq[0], rq[1]);
        tc::mma(s[2 * np + 1], ka, rq[2], rq[3]);
        tc::mma(dp[2 * np], va, ro[0], ro[1]);
        tc::mma(dp[2 * np + 1], va, ro[2], ro[3]);
      }
    }

    // One exp a (key, query) pair: s becomes p, dp becomes ds.  Only tiles
    // on the diagonal, at the ragged end or under a mask test each pair.
    const bool full = p.mask == nullptr && k0 + kTcKeys <= p.T &&
                      q0 + kQ <= p.T && !(p.causal && q0 < k0 + kTcKeys);
#pragma unroll
    for (int i = 0; i < kQ / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * i + 2 * t4 + (e & 1);
        const int r = e >> 1;
        float x = s[i][e] * p.scale;
        float pr = 0.f;
        if (full) {
          pr = __expf(x - tLse[qi]);
        } else if (key_ok[r] && q0 + qi < p.T) {
          if (!key_valid[r] || (p.causal && key0 + 8 * r > q0 + qi)) {
            x = kNegInf;
          }
          pr = __expf(x - tLse[qi]);
        }
        s[i][e] = pr;
        dp[i][e] = pr * (dp[i][e] - tRt[qi]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
    // registers as the A operands.
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      tc::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      tc::pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        const int bt_off = (kk * 16 + tc::bt_lane_row(lane)) * kStride +
                           dn * 16 + tc::bt_lane_col(lane);
        uint32_t ro[4], rq[4];
        tc::ldsm_x4_t(ro, tO + bt_off);
        tc::ldsm_x4_t(rq, tQ + bt_off);
        tc::mma(dv[2 * dn], pa, ro[0], ro[1]);
        tc::mma(dv[2 * dn + 1], pa, ro[2], ro[3]);
        tc::mma(dk[2 * dn], da, rq[0], rq[1]);
        tc::mma(dk[2 * dn + 1], da, rq[2], rq[3]);
      }
    }
    __syncthreads();  // slot it & 1 is free for tile it + 2
  }

  __nv_bfloat16* gdk = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* gdv = static_cast<__nv_bfloat16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!key_ok[r]) continue;
    const long long base =
        ((static_cast<long long>(b) * p.T + key0 + 8 * r) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int d = 8 * i + 2 * t4;
      *reinterpret_cast<uint32_t*>(gdk + base + d) =
          tc::pack(p.scale * dk[i][2 * r], p.scale * dk[i][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(gdv + base + d) =
          tc::pack(dv[i][2 * r], dv[i][2 * r + 1]);
    }
  }
}

constexpr int kDqWarps = 4;                // bf16 K6: warps a block
constexpr int kDqThreads = 32 * kDqWarps;
constexpr int kDqRows = 16 * kDqWarps;     // query rows a block owns
static_assert(kDqRows % 64 == 0, "K6 query tiles hold whole 64-key blocks");

// Keys per staged tile of the bf16 K6.  32, not 64: S and dP of 32 keys
// leave room under a 128-register cap, so four blocks share an SM.
constexpr int kDqKeys = 32;

// Blocks of the bf16 K6 an SM holds at once: 4 (a cap of 128 registers a
// thread) up to D=64; at D=128 the fragments alone take ~200 registers.
template <int D> __host__ __device__ constexpr int tc_dq_min_blocks() {
  return D == 128 ? 1 : 4;
}

template <int D> constexpr size_t tc_dq_smem() {
  return sizeof(__nv_bfloat16) * (2 * kDqRows + 4 * kDqKeys) * (D + 8);
}

// K6 in bf16 on the tensor cores: dq for one (b, h, kDqRows-row query
// tile).
template <int D>
__global__ void __launch_bounds__(kDqThreads, tc_dq_min_blocks<D>())
    flash_bwd_dq_kernel_tc(Params p) {
  constexpr int kN = kDqKeys;
  constexpr int kStride = D + 8;  // padded row, in elements
  constexpr int kTile = kN * kStride;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sO = sQ + kDqRows * kStride;
  __nv_bfloat16* sK = sO + kDqRows * kStride;  // [2][kN][kStride]
  __nv_bfloat16* sV = sK + 2 * kTile;          // [2][kN][kStride]

  // Longest first: the slowest part of the block index is the query tile,
  // from the last tile when causal.
  const int n_tiles = (p.T + kDqRows - 1) / kDqRows;
  const int bh = blockIdx.x % (p.B * p.H);
  const int order = blockIdx.x / (p.B * p.H);
  const int qt = p.causal ? n_tiles - 1 - order : order;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = qt * kDqRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb + h * p.sqh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + h * p.skh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + h * p.svh;
  const __nv_bfloat16* dout =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.sob + h * p.soh;
  const int32_t* mask = p.mask == nullptr ? nullptr : p.mask + b * p.T;
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
  float lse[2], rt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse[r] = row < p.T ? p.lse[rows + row] : 0.f;
    rt[r] = row < p.T ? p.rowterm[rows + row] : 0.f;
  }

  // Causal tile skip: keys up to the end of the 64-key block that holds
  // this tile's last diagonal, whatever kN; inside, a row's keys past its
  // own 64-key block are no keys (the set K7 visits, header).
  const int k_end = p.causal ? min(p.T, q0 + kDqRows) : p.T;
  const int n_k = (k_end + kN - 1) / kN;
  tc::load_rows<D, kDqRows, kDqThreads>(sQ, q, p.sqt, q0, p.T);
  tc::load_rows<D, kDqRows, kDqThreads>(sO, dout, p.sot, q0, p.T);
  tc::load_rows<D, kN, kDqThreads>(sK, k, p.skt, 0, p.T);
  tc::load_rows<D, kN, kDqThreads>(sV, v, p.svt, 0, p.T);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4], of[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a_off = (warp * 16 + tc::a_lane_row(lane)) * kStride +
                      kk * 16 + tc::a_lane_col(lane);
    tc::ldsm_x4(qf[kk], sQ + a_off);
    tc::ldsm_x4(of[kk], sO + a_off);
  }

  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int j = 0; j < n_k; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_k) {  // tile j + 1 into the other stage, in flight
      const int next = (j + 1) * kN;
      tc::load_rows<D, kN, kDqThreads>(sK + (stage ^ 1) * kTile, k, p.skt,
                                       next, p.T);
      tc::load_rows<D, kN, kDqThreads>(sV + (stage ^ 1) * kTile, v, p.svt,
                                       next, p.T);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile j has landed (this thread's copies)
    __syncthreads();         // ... and everyone's
    const __nv_bfloat16* tK = sK + stage * kTile;
    const __nv_bfloat16* tV = sV + stage * kTile;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x kN keys.
    float s[kN / 8][4], dp[kN / 8][4];
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        const int b_off = (np * 16 + tc::b_lane_row(lane)) * kStride +
                          kk * 16 + tc::b_lane_col(lane);
        uint32_t rk[4], rv[4];
        tc::ldsm_x4(rk, tK + b_off);
        tc::ldsm_x4(rv, tV + b_off);
        tc::mma(s[2 * np], qf[kk], rk[0], rk[1]);
        tc::mma(s[2 * np + 1], qf[kk], rk[2], rk[3]);
        tc::mma(dp[2 * np], of[kk], rv[0], rv[1]);
        tc::mma(dp[2 * np + 1], of[kk], rv[2], rv[3]);
      }
    }

    // One exp a (query, key) pair: dp becomes ds.  Only tiles on the
    // diagonal block, at the ragged end or under a mask test each pair.
    const int k0 = j * kN;
    const bool full = mask == nullptr && k0 + kN <= p.T &&
                      q0 + kDqRows <= p.T && !(p.causal && k0 + kN > q0);
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * i + 2 * t4 + (e & 1);
        const int r = e >> 1, row = row0 + 8 * r;
        float x = s[i][e] * p.scale;
        float pr = 0.f;
        if (full) {
          pr = __expf(x - lse[r]);
        } else if (key < p.T && row < p.T &&
                   !(p.causal && key >= (row | 63) + 1)) {
          if ((mask != nullptr && mask[key] == 0) ||
              (p.causal && key > row)) {
            x = kNegInf;
          }
          pr = __expf(x - lse[r]);
        }
        dp[i][e] = pr * (dp[i][e] - rt[r]);
      }
    }

    // dQ += dS K, dS rounded to bf16 in registers as the A operand.
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t da[4];
      tc::pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t rk[4];
        tc::ldsm_x4_t(rk, tK + (kk * 16 + tc::bt_lane_row(lane)) * kStride +
                              dn * 16 + tc::bt_lane_col(lane));
        tc::mma(dq[2 * dn], da, rk[0], rk[1]);
        tc::mma(dq[2 * dn + 1], da, rk[2], rk[3]);
      }
    }
    __syncthreads();  // stage j & 1 is free for tile j + 2
  }

  __nv_bfloat16* gdq = static_cast<__nv_bfloat16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.T) continue;
    const long long base =
        ((static_cast<long long>(b) * p.T + row) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<uint32_t*>(gdq + base + 8 * i + 2 * t4) =
          tc::pack(p.scale * dq[i][2 * r], p.scale * dq[i][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq_bf16(const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tc_dq_smem<D>()));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int blocks = p.B * p.H * ((p.T + kDqRows - 1) / kDqRows);
  flash_bwd_dq_kernel_tc<D>
      <<<blocks, kDqThreads, tc_dq_smem<D>(), stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tc_dkv_smem<D>()));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int blocks = p.B * p.H * ((p.T + kTcKeys - 1) / kTcKeys);
  flash_bwd_dkv_kernel_tc<D>
      <<<blocks, kTcThreads, tc_dkv_smem<D>(), stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, bool dkv, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return dkv ? launch_dkv_bf16<D>(p, stream) : launch_dq_bf16<D>(p, stream);
  } else {
    dim3 grid((p.T + kRows - 1) / kRows, p.H, p.B);
    if (dkv) {
      flash_bwd_dkv_kernel<D><<<grid, kThreads, 0, stream>>>(p);
    } else {
      flash_bwd_dq_kernel<D><<<grid, kThreads, 0, stream>>>(p);
    }
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch_d(const Params& p, int d, bool dkv, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, dkv, stream);
    case 32: return launch<T, 32>(p, dkv, stream);
    case 64: return launch<T, 64>(p, dkv, stream);
    case 128: return launch<T, 128>(p, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(bool dkv, const void* q, const void* k, const void* v,
        const void* dout, const void* lse, const void* rowterm,
        const void* mask, void* dq, void* dk, void* dv, int B, int T, int H,
        int D, long long sqb, long long sqt, long long sqh, long long skb,
        long long skt, long long skh, long long svb, long long svt,
        long long svh, long long sob, long long sot, long long soh,
        int causal, float scale, int is_bf16, int device, void* stream) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (T <= 0 || B <= 0 || H <= 0) return 0;
  Params p{q, k, v, dout,
           static_cast<const float*>(lse), static_cast<const float*>(rowterm),
           static_cast<const int32_t*>(mask), dq, dk, dv, B, T, H,
           sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
           causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = is_bf16 ? launch_d<__nv_bfloat16>(p, D, dkv, st)
                          : launch_d<float>(p, D, dkv, st);
  return static_cast<int>(e);
}

}  // namespace

// Both entry points take the same arguments; K6 writes dq only, K7 dk and dv.
#define FLASH_BWD_ARGS                                                        \
  const void *q, const void *k, const void *v, const void *dout,              \
      const void *lse, const void *rowterm, const void *mask, void *dq,       \
      void *dk, void *dv, int B, int T, int H, int D, long long sqb,          \
      long long sqt, long long sqh, long long skb, long long skt,             \
      long long skh, long long svb, long long svt, long long svh,             \
      long long sob, long long sot, long long soh, int causal, float scale,   \
      int is_bf16, int device, void *stream
#define FLASH_BWD_PASS                                                        \
  q, k, v, dout, lse, rowterm, mask, dq, dk, dv, B, T, H, D, sqb, sqt, sqh,   \
      skb, skt, skh, svb, svt, svh, sob, sot, soh, causal, scale, is_bf16,    \
      device, stream

extern "C" int flash_bwd_dq(FLASH_BWD_ARGS) { return run(false, FLASH_BWD_PASS); }

extern "C" int flash_bwd_dkv(FLASH_BWD_ARGS) { return run(true, FLASH_BWD_PASS); }

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
