// GroupNorm forward and backward over NHWC for Hopper (sm_90a), plain C interface.
//
// Replaces the four TPU kernels of cloud_tpu/ops/group_norm.py:
//   K1 _fwd_kernel      y = [relu](gn(x))              -> group_norm_fwd, res == nullptr
//   K2 _fwd_kernel_res  y = [relu](gn(x) + residual)   -> group_norm_fwd, res != nullptr
//   K3 _bwd_kernel      dx, ds, db                     -> group_norm_bwd, res == nullptr
//   K4 _bwd_kernel_res  K3 plus dres = the gated dy    -> group_norm_bwd, res != nullptr
// x, y, dy, dx, residual and dres are [B, HW, C] (NHWC with H and W merged)
// of one type, float32 or bfloat16; scale and bias are float32 [C]; the
// saved group statistics mean and rstd are float32 [B, G]; ds and db are
// float32 [C], summed over B here.  Every value is computed in float32 and
// rounded once to the output type.
//
// Numerics are the TPU kernels' (_fwd_math, _bwd_core).  Sums are taken
// around a per-channel pivot, x[b, 0, c], so E[x^2] - E[x]^2 stays of the
// order of the variance when |mean| >> std.  With the pivot fixed, the
// shifted sums s1 = sum(x - p) and s2 = sum((x - p)^2) of disjoint row
// ranges add, so a sample may be split over several CTAs with the algebra
// unchanged:
//   mean_g = sum_{c in g} (s1_c + HW p_c) / n,     d_c = mean_g - p_c,
//   var_g  = sum_{c in g} (s2_c - 2 d_c s1_c + HW d_c^2) / n,   n = HW C/G.
// The pre-activation is built with explicit round-to-nearest intrinsics in
// one order (pre_act), so the backward's recomputed relu gate equals the
// forward's relu decision bit for bit.
//
// What bounds it on H100: bytes.  There is no matrix product (a few FLOPs
// per element against the card's ~295 FLOPs per byte balance point), so
// wgmma and the tensor cores do not apply.  The floor is one read of each
// input and one write of each output, and the design aims at it: one pass
// over the data per direction, with the statistics reduced in the kernel.
//
// Translation.  A TPU grid step held one whole sample in VMEM and folded
// channels into groups with one-hot [C, G] matmuls.  Here a sample lives in
// the shared memory of one CTA or, when it does not fit one, of a thread
// block cluster of up to 8 CTAs (grid = (cluster, B), one cluster a
// sample).  The host's plan (ops/group_norm.py, _plan) picks the cluster
// size, the rows of HW each CTA owns, how many of them it keeps in shared
// memory and the block size, and passes them in.  Each CTA
//   1. copies its rows into shared memory with 16-byte cp.async; rows that
//      do not fit are read from device memory last in step 2 and again,
//      first in step 4, while they are still in the L2 (reading them
//      first, under the copies, was slower on the card).  It reads the
//      pivot row itself;
//   2. reduces per-channel shifted sums: a thread keeps the sums of one
//      16-byte column vector over a strided set of rows in registers; the
//      block's rows of threads are added with warp shuffles, then by one
//      thread a column in shared memory (two barriers, fixed order);
//   3. adds the cluster's per-channel sums in rank order through
//      distributed shared memory (every CTA gets the same bits) and folds
//      channels into groups, all groups at once, a warp segment of up to
//      32 lanes a group (warp shuffles);
//   4. normalises from shared memory and writes with 16-byte stores.
// The backward does the same with sum(dy) and sum(dy xhat), the relu gate
// recomputed from x, the saved statistics [and the residual], the gated dy
// taking dy's place in shared memory; then dx = rstd (dy scale - (A_g +
// xhat B_g) / n) with A_g = sum scale db, B_g = sum scale ds over the
// group, and dres = the gated dy.  CTA 0 of each sample writes the
// sample's ds, db to scratch and a second, small kernel sums them over B in
// a fixed order: no atomics, so two launches on the same inputs give the
// same bits, and nothing needs clearing between calls (CUDA-graph safe).
// Channels that are not a multiple of a 16-byte vector, or a pointer that
// is not 16-byte aligned, take the scalar route of the same kernels (V =
// 1): nothing is kept in shared memory and step 4 reads the rows again.
//
// Chip numbers (chip_smoke.py, device time, NVIDIA H100 80GB HBM3 at 700
// W): one call at 224 b128, K1 0.189 ms at (128, 112, 112, 64) against a
// byte bound of 0.123, K2 0.320 at (128, 56, 56, 256) against 0.184, K3
// 0.343 against 0.184, K4 0.536 against 0.307; over the calls of a CIFAR
// b256 step, K1 0.238, K2 0.192, K3 0.340, K4 0.234 ms (PERF.md, kernel
// table).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kSmemMax = 232448;  // 227 KB: what one block may use on H100
constexpr int kSumCols = 16, kSumSlices = 16;

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

// V consecutive elements at p as floats: one 16-byte load when V > 1.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = to_f<T>(*p);
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // a bfloat16 is the top half of a float
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// V floats rounded to T and stored at p: one 16-byte store when V > 1.
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = from_f<T>(v[0]);
  } else if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(tc::pack(v[0], v[1]), tc::pack(v[2], v[3]),
                                              tc::pack(v[4], v[5]), tc::pack(v[6], v[7]));
  }
}

// The pre-activation ((x - m) r) s + b, each step rounded on its own (no
// FMA contraction), in the forward and in the backward's gate alike.
__device__ __forceinline__ float pre_act(float x, float m, float r, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), r), s), b);
}

struct Params {
  const void *x, *dy, *res;
  const float *scale, *bias;
  void* out;           // forward: y; backward: dx
  void* dres;          // backward with a residual: the gated dy
  float *mean, *rstd;  // written by the forward, read by the backward
  float* part;         // backward: [B][2C] per-sample db, then ds
  int B, HW, C, G;
  int cluster;  // CTAs per sample (gridDim.x)
  int rows;     // rows of HW per CTA; CTA k owns [k rows, min((k + 1) rows, HW))
  int cached;   // of those, the first `cached` are kept in shared memory
  float eps;
};

// Bytes of shared memory before the cached rows: per-channel sums [2C],
// the cluster's sums [2C] (aliased to the first without a cluster), the
// rows of threads being added [threads V] and per-group values [2G];
// 16-byte aligned.
__host__ __device__ __forceinline__ int fixed_smem_bytes(int C, int G, int threads, int V,
                                                         int cluster) {
  const int floats = 2 * C * (cluster > 1 ? 2 : 1) + threads * V + 2 * G;
  return (floats * 4 + 15) / 16 * 16;
}

// One CTA's part of its sample and its thread layout: TX threads across
// the C / V column vectors of a row, TY rows of threads.
struct Tile {
  int b, r0, nrows, ncached, CV, TX, TY, tx, ty;
};

template <int V>
__device__ __forceinline__ Tile make_tile(const Params& p) {
  Tile t;
  t.b = blockIdx.y;
  t.r0 = blockIdx.x * p.rows;
  t.nrows = max(0, min(p.rows, p.HW - t.r0));
  t.ncached = min(p.cached, t.nrows);
  t.CV = p.C / V;
  t.TX = min(t.CV, static_cast<int>(blockDim.x));
  t.TY = blockDim.x / t.TX;
  t.tx = threadIdx.x % t.TX;
  t.ty = threadIdx.x / t.TX;
  return t;
}

struct Smem {
  float *chan, *tot, *red, *grp;
  unsigned char* data;
};

template <int V>
__device__ __forceinline__ Smem carve(unsigned char* base, const Params& p) {
  Smem s;
  s.chan = reinterpret_cast<float*>(base);
  s.tot = p.cluster > 1 ? s.chan + 2 * p.C : s.chan;
  s.red = s.chan + 2 * p.C * (p.cluster > 1 ? 2 : 1);
  s.grp = s.red + blockDim.x * V;
  s.data = base + fixed_smem_bytes(p.C, p.G, blockDim.x, V, p.cluster);
  return s;
}

// Start copying `nrows` rows of C elements at src into dst, 16 bytes a
// cp.async; the caller commits and waits.  Nothing on the scalar route.
template <typename T, int V>
__device__ __forceinline__ void stage(T* dst, const T* src, int nrows, int C) {
  if constexpr (V > 1) {
    const int CV = C / V, n = nrows * CV;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / CV, o = row * C + (i - row * CV) * V;
      tc::cp_async16(dst + o, src + o, true);
    }
  }
}

// The group of each of V consecutive channels from c, without a division
// per channel.
template <int V>
__device__ __forceinline__ void groups_of(int c, int cpg, int (&g)[V]) {
  int gi = c / cpg, rem = c - gi * cpg;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    g[j] = gi;
    if (++rem == cpg) {
      rem = 0;
      ++gi;
    }
  }
}

// Column sums of the row-reduction buffer: nq quantities (a then b) of V
// planes each, a plane holding R rows of TX floats; the sum over the rows
// of column tx of plane j lands in d0 (or d1 for b)[(cv0 + tx) V + j].
template <int V>
__device__ __forceinline__ void column_sums(const float* red, int nq, int R, float* d0, float* d1,
                                            int cv0, const Tile& t) {
  const int plane = R * t.TX;
  for (int col = threadIdx.x; col < nq * V * t.TX; col += blockDim.x) {
    const int tx = col % t.TX, qj = col / t.TX, cv = cv0 + tx;
    if (cv >= t.CV) continue;
    const float* src = red + qj * plane + tx;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += src[r * t.TX];
    (qj < V ? d0 : d1)[cv * V + qj % V] = s;
  }
}

// Both sums of a thread, a[V] and b[V] of column vector cv0 + tx, over the
// block's rows of threads into da and db, in a fixed order.  Where a warp
// holds whole rows of threads (TX divides 32), the warp's rows are added
// first with shuffles, one row a warp is left.  The rows left go to shared
// memory, both sums at once where they fit in threads V floats, and one
// thread a column adds them in order: two barriers a quantity at most.
template <int V>
__device__ __forceinline__ void reduce_rows(float* red, float (&a)[V], float (&b)[V], float* da,
                                             float* db, int cv0, const Tile& t) {
  int R = t.TY, row = t.ty;
  bool lead = t.ty < t.TY;  // the threads past TX TY hold nothing
  if (t.TX < 32 && 32 % t.TX == 0) {
    for (int o = t.TX; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a[j] += __shfl_xor_sync(0xffffffffu, a[j], o);
        b[j] += __shfl_xor_sync(0xffffffffu, b[j], o);
      }
    }
    const int per = 32 / t.TX;
    R = t.TY / per;
    row = t.ty / per;
    lead = t.ty % per == 0;
  }
  const int plane = R * t.TX;
  float* mine = red + row * t.TX + t.tx;  // [a then b][j][row][tx]
  if (2 * V * plane <= V * static_cast<int>(blockDim.x)) {
    if (lead) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mine[j * plane] = a[j];
        mine[(V + j) * plane] = b[j];
      }
    }
    __syncthreads();
    column_sums<V>(red, 2, R, da, db, cv0, t);
    __syncthreads();
    return;
  }
  if (lead) {
#pragma unroll
    for (int j = 0; j < V; ++j) mine[j * plane] = a[j];
  }
  __syncthreads();
  column_sums<V>(red, 1, R, da, nullptr, cv0, t);
  __syncthreads();
  if (lead) {
#pragma unroll
    for (int j = 0; j < V; ++j) mine[j * plane] = b[j];
  }
  __syncthreads();
  column_sums<V>(red, 1, R, db, nullptr, cv0, t);
  __syncthreads();
}

// The cluster's per-channel sums, added in rank order through distributed
// shared memory: every CTA of the sample gets the same bits.  Without a
// cluster, tot is chan.
__device__ __forceinline__ void combine(float* chan, float* tot, int n, int cluster) {
  if (cluster == 1) return;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every CTA's chan is complete
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < cluster; ++r) s += cl.map_shared_rank(chan, r)[c];
    tot[c] = s;
  }
  cl.sync();  // no CTA leaves (or reuses chan) while a peer still reads it
}

// Sum over the `width` lanes of a warp segment (a power of two <= 32);
// every lane of the segment gets the sum of its segment.  Fixed order.
__device__ __forceinline__ float segment_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Groups folded in parallel: a warp segment of `width` lanes a group (the
// power of two at or above C/G, at most 32), every warp of the block.  A
// warp takes groups first + seg, first + stride + seg, ...: the loop bound
// is the warp's, so its lanes stay converged for the shuffles.
struct Fold {
  int width, lane, seg, first, stride;
};

__device__ __forceinline__ Fold make_fold(int cpg) {
  Fold f;
  f.width = 1;
  while (f.width < cpg && f.width < 32) f.width <<= 1;
  const int per_warp = 32 / f.width;
  f.lane = (threadIdx.x & 31) % f.width;
  f.seg = (threadIdx.x & 31) / f.width;
  f.first = (threadIdx.x >> 5) * per_warp;
  f.stride = (blockDim.x >> 5) * per_warp;
  return f;
}

// ---------------------------------------------------------------------------
// Forward: K1 / K2
// ---------------------------------------------------------------------------

template <typename T, int V>
__device__ __forceinline__ void add_shifted(float (&s1)[V], float (&s2)[V], const T* src,
                                            const float (&piv)[V]) {
  float v[V];
  load_vec<T, V>(src, v);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = v[j] - piv[j];
    s1[j] += d;
    s2[j] += d * d;
  }
}

template <typename T, int V, bool RES, bool RELU>
__device__ __forceinline__ void fwd_out(const float (&xv)[V], const T* res, T* y,
                                        const float (&m)[V], const float (&r)[V],
                                        const float (&sc)[V], const float (&bi)[V]) {
  float rv[V], v[V];
  if constexpr (RES) load_vec<T, V>(res, rv);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float a = pre_act(xv[j], m[j], r[j], sc[j], bi[j]);
    if constexpr (RES) a = __fadd_rn(a, rv[j]);
    if constexpr (RELU) a = fmaxf(a, 0.f);
    v[j] = a;
  }
  store_vec<T, V>(y, v);
}

template <typename T, int V, bool RES, bool RELU>
__global__ void __launch_bounds__(kMaxThreads) gn_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve<V>(smem_raw, p);
  const Tile t = make_tile<V>(p);
  const int C = p.C, G = p.G, cpg = C / G;
  const long long base = static_cast<long long>(t.b) * p.HW * C;
  const T* xb = static_cast<const T*>(p.x) + base;  // the sample; row 0 is the pivot
  const T* xr = xb + t.r0 * C;                       // this CTA's first row
  T* xs = reinterpret_cast<T*>(sm.data);

  // 1-2. Shifted per-channel sums: the rows in shared memory, then the
  // rest (read last here and first in step 4, so they are still in L2).
  stage<T, V>(xs, xr, t.ncached, C);
  tc::cp_async_commit();
  for (int cv0 = 0; cv0 < t.CV; cv0 += t.TX) {
    const int cv = cv0 + t.tx, c = cv * V;
    const bool valid = t.ty < t.TY && cv < t.CV;
    float s1[V], s2[V], piv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = piv[j] = 0.f;
    if (cv0 == 0) {
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    if (valid) {
      load_vec<T, V>(xb + c, piv);
#pragma unroll 4
      for (int row = t.ty; row < t.ncached; row += t.TY)
        add_shifted<T, V>(s1, s2, xs + row * C + c, piv);
#pragma unroll 4
      for (int row = t.ncached + t.ty; row < t.nrows; row += t.TY)
        add_shifted<T, V>(s1, s2, xr + row * C + c, piv);
    }
    reduce_rows<V>(sm.red, s1, s2, sm.chan, sm.chan + C, cv0, t);
  }

  // 3. The sample's sums, then mean and rstd per group.
  combine(sm.chan, sm.tot, 2 * C, p.cluster);
  const float hw = static_cast<float>(p.HW), n = hw * static_cast<float>(cpg);
  const Fold f = make_fold(cpg);
  for (int g0 = f.first; g0 < G; g0 += f.stride) {
    const int g = g0 + f.seg;
    const bool live = g < G;
    float a = 0.f;
    for (int j = f.lane; live && j < cpg; j += f.width) {
      const int c = g * cpg + j;
      a += sm.tot[c] + hw * to_f<T>(xb[c]);
    }
    const float m = segment_sum(a, f.width) / n;
    float q = 0.f;
    for (int j = f.lane; live && j < cpg; j += f.width) {
      const int c = g * cpg + j;
      const float d = m - to_f<T>(xb[c]);
      q += sm.tot[C + c] - 2.f * d * sm.tot[c] + hw * d * d;
    }
    const float r = rsqrtf(fmaxf(segment_sum(q, f.width) / n, 0.f) + p.eps);
    if (live && f.lane == 0) {
      sm.grp[g] = m;
      sm.grp[G + g] = r;
      if (blockIdx.x == 0) {
        p.mean[t.b * G + g] = m;
        p.rstd[t.b * G + g] = r;
      }
    }
  }
  __syncthreads();

  // 4. Normalise: rows read again from L2 first, then those in shared memory.
  const T* resr = RES ? static_cast<const T*>(p.res) + base + t.r0 * C : nullptr;
  T* yr = static_cast<T*>(p.out) + base + t.r0 * C;
  for (int cv0 = 0; cv0 < t.CV; cv0 += t.TX) {
    const int cv = cv0 + t.tx, c = cv * V;
    if (t.ty >= t.TY || cv >= t.CV) continue;
    float m[V], r[V], sc[V], bi[V];
    int gj[V];
    groups_of<V>(c, cpg, gj);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = gj[j];
      m[j] = sm.grp[g];
      r[j] = sm.grp[G + g];
      sc[j] = p.scale[c + j];
      bi[j] = p.bias[c + j];
    }
#pragma unroll 2
    for (int row = t.ncached + t.ty; row < t.nrows; row += t.TY) {
      const int o = row * C + c;
      float xv[V];
      load_vec<T, V>(xr + o, xv);
      fwd_out<T, V, RES, RELU>(xv, resr + o, yr + o, m, r, sc, bi);
    }
#pragma unroll 2
    for (int row = t.ty; row < t.ncached; row += t.TY) {
      const int o = row * C + c;
      float xv[V];
      load_vec<T, V>(xs + o, xv);
      fwd_out<T, V, RES, RELU>(xv, resr + o, yr + o, m, r, sc, bi);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: K3 / K4
// ---------------------------------------------------------------------------

// xhat = (x - m) r and the gated cotangent d of V elements.  xhat is
// rounded as the first two steps of pre_act, so the recomputed relu gate,
// pre = xhat s + b [+ res] > 0, equals the forward's decision bit for bit;
// without relu d is dy unchanged.
template <typename T, int V, bool RES, bool RELU>
__device__ __forceinline__ void gate_xhat(float (&d)[V], float (&xhat)[V], const float (&xv)[V],
                                          const T* res, const float (&m)[V], const float (&r)[V],
                                          const float (&sc)[V], const float (&bi)[V]) {
  float rv[V];
  if constexpr (RELU && RES) load_vec<T, V>(res, rv);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    xhat[j] = __fmul_rn(__fsub_rn(xv[j], m[j]), r[j]);
    if constexpr (RELU) {
      float pre = __fadd_rn(__fmul_rn(xhat[j], sc[j]), bi[j]);
      if constexpr (RES) pre = __fadd_rn(pre, rv[j]);
      if (!(pre > 0.f)) d[j] = 0.f;
    }
  }
}

// dx = rstd (d scale - (A_g + xhat B_g) / n) as k1 d - (k2 xhat + k3)
// with k1 = rstd scale, k2 = rstd B_g / n, k3 = rstd A_g / n per channel;
// dres = d.
template <typename T, int V, bool RES>
__device__ __forceinline__ void bwd_out(const float (&d)[V], const float (&xhat)[V], T* dx,
                                        T* dres, const float (&k1)[V], const float (&k2)[V],
                                        const float (&k3)[V]) {
  float v[V];
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = k1[j] * d[j] - (k2[j] * xhat[j] + k3[j]);
  store_vec<T, V>(dx, v);
  if constexpr (RES) store_vec<T, V>(dres, d);
}

template <typename T, int V, bool RES, bool RELU>
__global__ void __launch_bounds__(kMaxThreads) gn_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem sm = carve<V>(smem_raw, p);
  const Tile t = make_tile<V>(p);
  const int C = p.C, G = p.G, cpg = C / G;
  const long long base = static_cast<long long>(t.b) * p.HW * C + t.r0 * C;
  const T* xr = static_cast<const T*>(p.x) + base;  // this CTA's first row
  const T* dyr = static_cast<const T*>(p.dy) + base;
  const T* resr = RES ? static_cast<const T*>(p.res) + base : nullptr;
  T* xs = reinterpret_cast<T*>(sm.data);
  T* ds = xs + p.cached * C;  // dy, then the gated dy

  // 1-2. Per-channel sum(d) and sum(d xhat) of the gated cotangent d: the
  // rows in shared memory, then the rest (read last here and first in
  // step 4, so they are still in L2).
  stage<T, V>(xs, xr, t.ncached, C);
  stage<T, V>(ds, dyr, t.ncached, C);
  tc::cp_async_commit();
  for (int cv0 = 0; cv0 < t.CV; cv0 += t.TX) {
    const int cv = cv0 + t.tx, c = cv * V;
    const bool valid = t.ty < t.TY && cv < t.CV;
    float m[V], r[V], sc[V], bi[V], sdy[V], sdyx[V];
    int gj[V];
    groups_of<V>(valid ? c : 0, cpg, gj);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int ch = valid ? c + j : 0;
      m[j] = p.mean[t.b * G + gj[j]];
      r[j] = p.rstd[t.b * G + gj[j]];
      sc[j] = p.scale[ch];
      bi[j] = p.bias[ch];
      sdy[j] = sdyx[j] = 0.f;
    }
    if (cv0 == 0) {
      tc::cp_async_wait<0>();
      __syncthreads();
    }
    if (valid) {
#pragma unroll 2
      for (int row = t.ty; row < t.ncached; row += t.TY) {
        const int o = row * C + c;
        float xv[V], d[V], xhat[V];
        load_vec<T, V>(xs + o, xv);
        load_vec<T, V>(ds + o, d);
        gate_xhat<T, V, RES, RELU>(d, xhat, xv, resr + o, m, r, sc, bi);
        if constexpr (RELU) store_vec<T, V>(ds + o, d);  // exact: dy or 0
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sdy[j] += d[j];
          sdyx[j] += d[j] * xhat[j];
        }
      }
    }
    if (valid) {
#pragma unroll 2
      for (int row = t.ncached + t.ty; row < t.nrows; row += t.TY) {
        const int o = row * C + c;
        float xv[V], d[V], xhat[V];
        load_vec<T, V>(xr + o, xv);
        load_vec<T, V>(dyr + o, d);
        gate_xhat<T, V, RES, RELU>(d, xhat, xv, resr + o, m, r, sc, bi);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sdy[j] += d[j];
          sdyx[j] += d[j] * xhat[j];
        }
      }
    }
    reduce_rows<V>(sm.red, sdy, sdyx, sm.chan, sm.chan + C, cv0, t);
  }

  // 3. The sample's db, ds (to scratch, for the sum over B) and per group
  // A_g = sum scale db, B_g = sum scale ds.
  combine(sm.chan, sm.tot, 2 * C, p.cluster);
  if (blockIdx.x == 0) {
    float* part = p.part + static_cast<long long>(t.b) * 2 * C;
    for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) part[c] = sm.tot[c];
  }
  const Fold f = make_fold(cpg);
  for (int g0 = f.first; g0 < G; g0 += f.stride) {
    const int g = g0 + f.seg;
    const bool live = g < G;
    float a = 0.f, bsum = 0.f;
    for (int j = f.lane; live && j < cpg; j += f.width) {
      const int c = g * cpg + j;
      a += p.scale[c] * sm.tot[c];
      bsum += p.scale[c] * sm.tot[C + c];
    }
    a = segment_sum(a, f.width);
    bsum = segment_sum(bsum, f.width);
    if (live && f.lane == 0) {
      sm.grp[g] = a;
      sm.grp[G + g] = bsum;
    }
  }
  __syncthreads();

  // 4. dx [and dres]: rows read again from L2 first, then those in shared
  // memory (x and the gated dy).
  const float n = static_cast<float>(p.HW) * static_cast<float>(cpg);
  T* dxr = static_cast<T*>(p.out) + base;
  T* dresr = RES ? static_cast<T*>(p.dres) + base : nullptr;
  for (int cv0 = 0; cv0 < t.CV; cv0 += t.TX) {
    const int cv = cv0 + t.tx, c = cv * V;
    if (t.ty >= t.TY || cv >= t.CV) continue;
    float m[V], r[V], sc[V], bi[V], k1[V], k2[V], k3[V];
    int gj[V];
    groups_of<V>(c, cpg, gj);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = gj[j];
      m[j] = p.mean[t.b * G + g];
      r[j] = p.rstd[t.b * G + g];
      sc[j] = p.scale[c + j];
      bi[j] = p.bias[c + j];
      k1[j] = r[j] * sc[j];
      k2[j] = r[j] * sm.grp[G + g] / n;
      k3[j] = r[j] * sm.grp[g] / n;
    }
#pragma unroll 2
    for (int row = t.ncached + t.ty; row < t.nrows; row += t.TY) {
      const int o = row * C + c;
      float xv[V], d[V], xhat[V];
      load_vec<T, V>(xr + o, xv);
      load_vec<T, V>(dyr + o, d);
      gate_xhat<T, V, RES, RELU>(d, xhat, xv, resr + o, m, r, sc, bi);
      bwd_out<T, V, RES>(d, xhat, dxr + o, dresr + o, k1, k2, k3);
    }
#pragma unroll 2
    for (int row = t.ty; row < t.ncached; row += t.TY) {
      const int o = row * C + c;
      float xv[V], d[V], xhat[V];
      load_vec<T, V>(xs + o, xv);
      load_vec<T, V>(ds + o, d);
#pragma unroll
      for (int j = 0; j < V; ++j) xhat[j] = __fmul_rn(__fsub_rn(xv[j], m[j]), r[j]);
      bwd_out<T, V, RES>(d, xhat, dxr + o, dresr + o, k1, k2, k3);
    }
  }
}

// out[j] = sum over b of part[b][j], j < n = 2C (db then ds): kSumSlices
// slices of B per column, each summed in order, then the slices in order.
__global__ void __launch_bounds__(kSumCols* kSumSlices) gn_bwd_sum(const float* __restrict__ part,
                                                                   float* __restrict__ out, int B,
                                                                   int n) {
  __shared__ float acc[kSumSlices][kSumCols];
  const int lane = threadIdx.x % kSumCols, slice = threadIdx.x / kSumCols;
  const int col = blockIdx.x * kSumCols + lane;
  const int per = (B + kSumSlices - 1) / kSumSlices;
  const int b0 = slice * per, b1 = min(b0 + per, B);
  float s = 0.f;
  if (col < n) {
#pragma unroll 16
    for (int b = b0; b < b1; ++b) s += part[static_cast<long long>(b) * n + col];
  }
  acc[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && col < n) {
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kSumSlices; ++k) total += acc[k][lane];
    out[col] = total;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, const Params& p, int threads, int smem,
                           cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;  // a lone CTA needs no cluster
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int V, bool RES, bool RELU>
cudaError_t fwd_launch(const Params& p, int threads, int smem, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gn_fwd_kernel<T, V, RES, RELU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  return launch_cluster(gn_fwd_kernel<T, V, RES, RELU>, p, threads, smem, st);
}

template <typename T, int V, bool RES, bool RELU>
cudaError_t bwd_launch(const Params& p, void* sums, int threads, int smem, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(gn_bwd_kernel<T, V, RES, RELU>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  cudaError_t e = launch_cluster(gn_bwd_kernel<T, V, RES, RELU>, p, threads, smem, st);
  if (e != cudaSuccess) return e;
  const int n = 2 * p.C;
  gn_bwd_sum<<<(n + kSumCols - 1) / kSumCols, kSumCols * kSumSlices, 0, st>>>(
      p.part, static_cast<float*>(sums), p.B, n);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t fwd_flags(const Params& p, bool relu, int threads, int smem, cudaStream_t st) {
  if (p.res != nullptr)
    return relu ? fwd_launch<T, V, true, true>(p, threads, smem, st)
                : fwd_launch<T, V, true, false>(p, threads, smem, st);
  return relu ? fwd_launch<T, V, false, true>(p, threads, smem, st)
              : fwd_launch<T, V, false, false>(p, threads, smem, st);
}

template <typename T, int V>
cudaError_t bwd_flags(const Params& p, void* sums, bool relu, int threads, int smem,
                      cudaStream_t st) {
  if (p.res != nullptr)
    return relu ? bwd_launch<T, V, true, true>(p, sums, threads, smem, st)
                : bwd_launch<T, V, true, false>(p, sums, threads, smem, st);
  return relu ? bwd_launch<T, V, false, true>(p, sums, threads, smem, st)
              : bwd_launch<T, V, false, false>(p, sums, threads, smem, st);
}

// Checks the shape and the plan and selects the device; 0 on success.
int prepare(const Params& p, int vec, int threads, int smem, int itemsize, int copies,
            int device) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int wide = 16 / itemsize;
  const bool ok =
      p.B > 0 && p.B <= 65535 && p.HW > 0 && p.C > 0 && p.G > 0 && p.C % p.G == 0 &&
      static_cast<long long>(p.HW) * p.C < (1LL << 31) && (vec == 1 || vec == wide) &&
      p.C % vec == 0 && threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
      p.cluster >= 1 && p.cluster <= kMaxCluster && p.rows >= 1 &&
      static_cast<long long>(p.rows) * p.cluster >= p.HW && p.cached >= 0 &&
      p.cached <= p.rows && (vec > 1 || p.cached == 0) && smem <= kSmemMax &&
      smem >= fixed_smem_bytes(p.C, p.G, threads, vec, p.cluster) +
                  copies * p.cached * p.C * itemsize;
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The plan's fields (vec, threads, cluster, rows, cached, smem) come from
// ops/group_norm.py _plan; mean and rstd are written, [B, G] each.
extern "C" int group_norm_fwd(const void* x, const void* res, const void* scale,
                              const void* bias, void* y, void* mean, void* rstd, int B, int HW,
                              int C, int G, int vec, int threads, int cluster, int rows,
                              int cached, int smem, float eps, int relu, int is_bf16, int device,
                              void* stream) {
  Params p{x,       nullptr, res,  static_cast<const float*>(scale),
           static_cast<const float*>(bias), y, nullptr, static_cast<float*>(mean),
           static_cast<float*>(rstd), nullptr, B, HW, C, G, cluster, rows, cached, eps};
  const int rc = prepare(p, vec, threads, smem, is_bf16 ? 2 : 4, 1, device);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16)
    e = vec > 1 ? fwd_flags<__nv_bfloat16, 8>(p, relu != 0, threads, smem, st)
                : fwd_flags<__nv_bfloat16, 1>(p, relu != 0, threads, smem, st);
  else
    e = vec > 1 ? fwd_flags<float, 4>(p, relu != 0, threads, smem, st)
                : fwd_flags<float, 1>(p, relu != 0, threads, smem, st);
  return static_cast<int>(e);
}

// sums: [2, C] float32, db then ds, summed over B.  part: [B, 2C] float32
// scratch.  dres is written only when res is given.
extern "C" int group_norm_bwd(const void* x, const void* dy, const void* res, const void* scale,
                              const void* bias, const void* mean, const void* rstd, void* dx,
                              void* dres, void* sums, void* part, int B, int HW, int C, int G,
                              int vec, int threads, int cluster, int rows, int cached, int smem,
                              int relu, int is_bf16, int device, void* stream) {
  Params p{x,
           dy,
           res,
           static_cast<const float*>(scale),
           static_cast<const float*>(bias),
           dx,
           dres,
           const_cast<float*>(static_cast<const float*>(mean)),
           const_cast<float*>(static_cast<const float*>(rstd)),
           static_cast<float*>(part),
           B, HW, C, G, cluster, rows, cached, 0.f};
  const int rc = prepare(p, vec, threads, smem, is_bf16 ? 2 : 4, 2, device);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (is_bf16)
    e = vec > 1 ? bwd_flags<__nv_bfloat16, 8>(p, sums, relu != 0, threads, smem, st)
                : bwd_flags<__nv_bfloat16, 1>(p, sums, relu != 0, threads, smem, st);
  else
    e = vec > 1 ? bwd_flags<float, 4>(p, sums, relu != 0, threads, smem, st)
                : bwd_flags<float, 1>(p, sums, relu != 0, threads, smem, st);
  return static_cast<int>(e);
}

extern "C" const char* group_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
