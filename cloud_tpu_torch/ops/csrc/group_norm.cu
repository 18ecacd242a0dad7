// GroupNorm forward and backward over NHWC for Hopper (sm_90a), plain C interface.
//
// Replaces the four TPU kernels of cloud_tpu/ops/group_norm.py:
//   K1 _fwd_kernel      y = [relu](gn(x))                 -> group_norm_fwd, res == nullptr
//   K2 _fwd_kernel_res  y = [relu](gn(x) + residual)      -> group_norm_fwd, res != nullptr
//   K3 _bwd_kernel      dx, per-sample ds/db              -> group_norm_bwd, res == nullptr
//   K4 _bwd_kernel_res  K3 plus dres = the gated dy       -> group_norm_bwd, res != nullptr
// x, y, dy, dx, residual and dres are [B, HW, C] (NHWC with H and W merged) of
// one type, float32 or bfloat16; scale and bias are float32 [C]; the saved
// group statistics mean and rstd are float32 [B, G]; ds and db are the
// per-sample float32 [B, C] partials that the caller sums over B.  Every
// value is computed in float32 and rounded once to the output type.
//
// Numerics are the TPU kernels' (_fwd_math, _bwd_core).  Sums are taken
// around a per-channel pivot, x[b, 0, c], so E[x^2] - E[x]^2 stays of the
// order of the variance when |mean| >> std.  With the pivot fixed, the
// shifted sums s1 = sum(x - p) and s2 = sum((x - p)^2) of disjoint row ranges
// add, so the reduction is split over many blocks with the algebra unchanged:
//   mean_g = sum_{c in g} (s1_c + HW p_c) / n,     d_c = mean_g - p_c,
//   var_g  = sum_{c in g} (s2_c - 2 d_c s1_c + HW d_c^2) / n,   n = HW C/G.
//
// Translation.  A TPU grid step held one whole sample in VMEM.  A sample of
// the ImageNet-shape stem (112 x 112 x 64, 3.2 MB in float32) fits no CTA's
// shared memory, so each direction is three launches over a grid of (row
// chunk, sample) blocks:
//   forward:  1. per-channel shifted s1, s2 of each chunk -> scratch
//             2. fold: chunks and the C/G adjacent channels of a group ->
//                mean, rstd [B, G] (one thread per (sample, group))
//             3. elementwise: y = (x - mean) rstd scale + bias [+ res] [relu]
//   backward: 1. the relu gate recomputed from x, the saved stats, scale,
//                bias [and res] with the forward's expression, then per
//                channel sum(dy) and sum(dy xhat) of each chunk -> scratch
//             2. fold: chunks -> db, ds [B, C]; groups -> A_g = sum scale db,
//                B_g = sum scale ds (the TPU kernel's sum(dxh), sum(dxh xhat))
//             3. elementwise: dx = rstd (dy scale - (A_g + xhat B_g) / n)
//                [and dres = gated dy]
// A block is 256 threads laid out (TX channels) x (TY rows): neighbouring
// threads read neighbouring channels of one row, so every load is coalesced,
// and each thread keeps its channel's statistics in registers while it walks
// its rows.  The TPU kernel's one-hot [C, G] matmuls are folds over C/G
// adjacent channels and are not carried over.  The pre-activation is built
// with explicit round-to-nearest intrinsics in one order, so the backward's
// recomputed gate equals the forward's relu decision bit for bit.
//
// What bounds it on H100: bytes.  There is no matrix product here (a few
// FLOPs per element against the card's ~295 FLOPs per byte balance point),
// so wgmma and the tensor cores do not apply, and TMA would only replace
// plain coalesced loads of a streaming pass.  The floor is one read of each
// input and one write of each output; this design reads x twice in the
// forward (stats, then normalise) and x, dy [and res] twice in the backward.
// Fusing pass 1 into pass 3 for samples that fit shared memory, and wider
// vector loads, are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

struct Shape {
  int B, HW, C, G;
  int rpc;      // rows (of HW) per chunk
  int nchunks;  // ceil(HW / rpc)
};

// The pre-activation ((x - m) r) s + b, each step rounded on its own (no
// FMA contraction), in the forward and in the backward's gate alike.
__device__ __forceinline__ float pre_act(float x, float m, float r, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, m), r), s), b);
}

// Sum over the block's TY rows of threads, for two values at once; the
// result lands in red0[tx], red1[tx].  TY is a power of two.
__device__ __forceinline__ void reduce_rows(float* red0, float* red1, float a0, float a1) {
  const int tx = threadIdx.x, ty = threadIdx.y, TX = blockDim.x;
  const int t = ty * TX + tx;
  red0[t] = a0;
  red1[t] = a1;
  __syncthreads();
  for (int h = blockDim.y / 2; h > 0; h >>= 1) {
    if (ty < h) {
      red0[t] += red0[t + h * TX];
      red1[t] += red1[t + h * TX];
    }
    __syncthreads();
  }
}

// Forward pass 1: per-channel shifted sums of one row chunk of one sample.
// part holds s1 at [chunk][b][c] and s2 after it.
template <typename T>
__global__ void __launch_bounds__(kThreads) gn_fwd_partial(const T* __restrict__ x,
                                                           float* __restrict__ part,
                                                           Shape s) {
  __shared__ float red0[kThreads], red1[kThreads];
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int r0 = chunk * s.rpc, r1 = min(r0 + s.rpc, s.HW);
  const T* xb = x + static_cast<long long>(b) * s.HW * s.C;
  const long long plane = static_cast<long long>(s.nchunks) * s.B * s.C;
  for (int c0 = 0; c0 < s.C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    float s1 = 0.f, s2 = 0.f;
    if (c < s.C) {
      const float pivot = to_f<T>(xb[c]);
      for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
        const float v = to_f<T>(xb[static_cast<long long>(r) * s.C + c]) - pivot;
        s1 += v;
        s2 += v * v;
      }
    }
    reduce_rows(red0, red1, s1, s2);
    if (threadIdx.y == 0 && c < s.C) {
      const long long o = (static_cast<long long>(chunk) * s.B + b) * s.C + c;
      part[o] = red0[threadIdx.x];
      part[plane + o] = red1[threadIdx.x];
    }
    __syncthreads();  // red0/red1 are reused by the next channel tile
  }
}

// Forward pass 2: one thread per (sample, group) folds chunks and channels.
template <typename T>
__global__ void gn_fwd_fold(const T* __restrict__ x, const float* __restrict__ part,
                            float* __restrict__ mean, float* __restrict__ rstd,
                            Shape s, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.B * s.G) return;
  const int b = i / s.G, g = i % s.G, cg = s.C / s.G;
  const float hw = static_cast<float>(s.HW);
  const float n = hw * static_cast<float>(cg);
  const long long plane = static_cast<long long>(s.nchunks) * s.B * s.C;
  const T* xb = x + static_cast<long long>(b) * s.HW * s.C;
  float sum = 0.f;
  for (int j = 0; j < cg; ++j) {
    const int c = g * cg + j;
    float s1 = 0.f;
    for (int k = 0; k < s.nchunks; ++k)
      s1 += part[(static_cast<long long>(k) * s.B + b) * s.C + c];
    sum += s1 + hw * to_f<T>(xb[c]);
  }
  const float m = sum / n;
  float acc = 0.f;
  for (int j = 0; j < cg; ++j) {
    const int c = g * cg + j;
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < s.nchunks; ++k) {
      const long long o = (static_cast<long long>(k) * s.B + b) * s.C + c;
      s1 += part[o];
      s2 += part[plane + o];
    }
    const float d = m - to_f<T>(xb[c]);
    acc += s2 - 2.f * d * s1 + hw * d * d;
  }
  mean[i] = m;
  rstd[i] = rsqrtf(fmaxf(acc / n, 0.f) + eps);
}

// Forward pass 3: normalise, affine, [+ residual], [relu].
template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads) gn_fwd_apply(
    const T* __restrict__ x, const T* __restrict__ res, const float* __restrict__ scale,
    const float* __restrict__ bias, const float* __restrict__ mean,
    const float* __restrict__ rstd, T* __restrict__ y, Shape s) {
  const int chunk = blockIdx.x, b = blockIdx.y, cg = s.C / s.G;
  const int r0 = chunk * s.rpc, r1 = min(r0 + s.rpc, s.HW);
  const long long base = static_cast<long long>(b) * s.HW * s.C;
  for (int c = threadIdx.x; c < s.C; c += blockDim.x) {
    const int bg = b * s.G + c / cg;
    const float m = mean[bg], r = rstd[bg], sc = scale[c], bi = bias[c];
    for (int row = r0 + threadIdx.y; row < r1; row += blockDim.y) {
      const long long o = base + static_cast<long long>(row) * s.C + c;
      float v = pre_act(to_f<T>(x[o]), m, r, sc, bi);
      if (RES) v = __fadd_rn(v, to_f<T>(res[o]));
      if (RELU) v = fmaxf(v, 0.f);
      y[o] = from_f<T>(v);
    }
  }
}

// The cotangent at one element after the relu gate (recomputed, not saved).
template <typename T, bool RES, bool RELU>
__device__ __forceinline__ float gated(float dyv, float xv, const T* __restrict__ res,
                                       long long o, float m, float r, float sc, float bi) {
  if (!RELU) return dyv;
  float pre = pre_act(xv, m, r, sc, bi);
  if (RES) pre = __fadd_rn(pre, to_f<T>(res[o]));
  return pre > 0.f ? dyv : 0.f;
}

// Backward pass 1: per-channel sum(dy) and sum(dy xhat) of one row chunk;
// part holds sum(dy) at [chunk][b][c] and sum(dy xhat) after it.
template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads) gn_bwd_partial(
    const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ res,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    float* __restrict__ part, Shape s) {
  __shared__ float red0[kThreads], red1[kThreads];
  const int chunk = blockIdx.x, b = blockIdx.y, cg = s.C / s.G;
  const int r0 = chunk * s.rpc, r1 = min(r0 + s.rpc, s.HW);
  const long long base = static_cast<long long>(b) * s.HW * s.C;
  const long long plane = static_cast<long long>(s.nchunks) * s.B * s.C;
  for (int c0 = 0; c0 < s.C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    float sdy = 0.f, sdyx = 0.f;
    if (c < s.C) {
      const int bg = b * s.G + c / cg;
      const float m = mean[bg], r = rstd[bg], sc = scale[c], bi = bias[c];
      for (int row = r0 + threadIdx.y; row < r1; row += blockDim.y) {
        const long long o = base + static_cast<long long>(row) * s.C + c;
        const float xv = to_f<T>(x[o]);
        const float d = gated<T, RES, RELU>(to_f<T>(dy[o]), xv, res, o, m, r, sc, bi);
        sdy += d;
        sdyx += d * ((xv - m) * r);
      }
    }
    reduce_rows(red0, red1, sdy, sdyx);
    if (threadIdx.y == 0 && c < s.C) {
      const long long o = (static_cast<long long>(chunk) * s.B + b) * s.C + c;
      part[o] = red0[threadIdx.x];
      part[plane + o] = red1[threadIdx.x];
    }
    __syncthreads();
  }
}

// Backward pass 2: one thread per (sample, group).  Writes the per-sample
// db, ds [B, C] of its channels and ab[(b, g)] = (A_g, B_g).
__global__ void gn_bwd_fold(const float* __restrict__ part, const float* __restrict__ scale,
                            float* __restrict__ ds, float* __restrict__ db,
                            float* __restrict__ ab, Shape s) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s.B * s.G) return;
  const int b = i / s.G, g = i % s.G, cg = s.C / s.G;
  const long long plane = static_cast<long long>(s.nchunks) * s.B * s.C;
  float a_g = 0.f, b_g = 0.f;
  for (int j = 0; j < cg; ++j) {
    const int c = g * cg + j;
    float sdy = 0.f, sdyx = 0.f;
    for (int k = 0; k < s.nchunks; ++k) {
      const long long o = (static_cast<long long>(k) * s.B + b) * s.C + c;
      sdy += part[o];
      sdyx += part[plane + o];
    }
    db[static_cast<long long>(b) * s.C + c] = sdy;
    ds[static_cast<long long>(b) * s.C + c] = sdyx;
    a_g += scale[c] * sdy;
    b_g += scale[c] * sdyx;
  }
  ab[2 * i] = a_g;
  ab[2 * i + 1] = b_g;
}

// Backward pass 3: dx [and dres, the gated dy].
template <typename T, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads) gn_bwd_apply(
    const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ res,
    const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const float* __restrict__ ab, T* __restrict__ dx, T* __restrict__ dres, Shape s) {
  const int chunk = blockIdx.x, b = blockIdx.y, cg = s.C / s.G;
  const int r0 = chunk * s.rpc, r1 = min(r0 + s.rpc, s.HW);
  const long long base = static_cast<long long>(b) * s.HW * s.C;
  const float n = static_cast<float>(s.HW) * static_cast<float>(cg);
  for (int c = threadIdx.x; c < s.C; c += blockDim.x) {
    const int bg = b * s.G + c / cg;
    const float m = mean[bg], r = rstd[bg], sc = scale[c], bi = bias[c];
    const float a_g = ab[2 * bg], b_g = ab[2 * bg + 1];
    for (int row = r0 + threadIdx.y; row < r1; row += blockDim.y) {
      const long long o = base + static_cast<long long>(row) * s.C + c;
      const float xv = to_f<T>(x[o]);
      const float d = gated<T, RES, RELU>(to_f<T>(dy[o]), xv, res, o, m, r, sc, bi);
      if (RES) dres[o] = from_f<T>(d);
      const float xhat = (xv - m) * r;
      dx[o] = from_f<T>(r * (d * sc - (a_g + xhat * b_g) / n));
    }
  }
}

dim3 block_shape(int C) {
  int tx = 32;
  while (tx < C && tx < kThreads) tx *= 2;
  return dim3(tx, kThreads / tx);
}

struct FwdArgs {
  const void *x, *res, *scale, *bias;
  void *y, *mean, *rstd, *part;
  Shape s;
  float eps;
  bool relu;
};

template <typename T, bool RES, bool RELU>
cudaError_t fwd_launch(const FwdArgs& a, cudaStream_t st) {
  const Shape& s = a.s;
  const T* x = static_cast<const T*>(a.x);
  float* mean = static_cast<float*>(a.mean);
  float* rstd = static_cast<float*>(a.rstd);
  float* part = static_cast<float*>(a.part);
  const dim3 grid(s.nchunks, s.B), block = block_shape(s.C);
  gn_fwd_partial<T><<<grid, block, 0, st>>>(x, part, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int bg = s.B * s.G;
  gn_fwd_fold<T><<<(bg + 127) / 128, 128, 0, st>>>(x, part, mean, rstd, s, a.eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_fwd_apply<T, RES, RELU><<<grid, block, 0, st>>>(
      x, static_cast<const T*>(a.res), static_cast<const float*>(a.scale),
      static_cast<const float*>(a.bias), mean, rstd, static_cast<T*>(a.y), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_flags(const FwdArgs& a, cudaStream_t st) {
  if (a.res != nullptr)
    return a.relu ? fwd_launch<T, true, true>(a, st) : fwd_launch<T, true, false>(a, st);
  return a.relu ? fwd_launch<T, false, true>(a, st) : fwd_launch<T, false, false>(a, st);
}

struct BwdArgs {
  const void *x, *dy, *res, *scale, *bias, *mean, *rstd;
  void *dx, *dres, *ds, *db, *part, *ab;
  Shape s;
  bool relu;
};

template <typename T, bool RES, bool RELU>
cudaError_t bwd_launch(const BwdArgs& a, cudaStream_t st) {
  const Shape& s = a.s;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  const T* res = static_cast<const T*>(a.res);
  const float* scale = static_cast<const float*>(a.scale);
  const float* bias = static_cast<const float*>(a.bias);
  const float* mean = static_cast<const float*>(a.mean);
  const float* rstd = static_cast<const float*>(a.rstd);
  float* part = static_cast<float*>(a.part);
  float* ab = static_cast<float*>(a.ab);
  const dim3 grid(s.nchunks, s.B), block = block_shape(s.C);
  gn_bwd_partial<T, RES, RELU><<<grid, block, 0, st>>>(x, dy, res, scale, bias, mean,
                                                       rstd, part, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int bg = s.B * s.G;
  gn_bwd_fold<<<(bg + 127) / 128, 128, 0, st>>>(part, scale, static_cast<float*>(a.ds),
                                                static_cast<float*>(a.db), ab, s);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gn_bwd_apply<T, RES, RELU><<<grid, block, 0, st>>>(
      x, dy, res, scale, bias, mean, rstd, ab, static_cast<T*>(a.dx),
      static_cast<T*>(a.dres), s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_flags(const BwdArgs& a, cudaStream_t st) {
  if (a.res != nullptr)
    return a.relu ? bwd_launch<T, true, true>(a, st) : bwd_launch<T, true, false>(a, st);
  return a.relu ? bwd_launch<T, false, true>(a, st) : bwd_launch<T, false, false>(a, st);
}

// Checks the shape and selects the device; 0 on success.
int prepare(Shape& s, int device) {
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (s.B <= 0 || s.B > 65535 || s.HW <= 0 || s.C <= 0 || s.G <= 0 || s.C % s.G != 0 ||
      s.rpc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  s.nchunks = (s.HW + s.rpc - 1) / s.rpc;
  return 0;
}

}  // namespace

// part: 2 * ceil(HW / rpc) * B * C floats of scratch.
extern "C" int group_norm_fwd(const void* x, const void* res, const void* scale,
                              const void* bias, void* y, void* mean, void* rstd,
                              void* part, int B, int HW, int C, int G, int rpc,
                              float eps, int relu, int is_bf16, int device,
                              void* stream) {
  Shape s{B, HW, C, G, rpc, 0};
  const int rc = prepare(s, device);
  if (rc != 0) return rc;
  FwdArgs a{x, res, scale, bias, y, mean, rstd, part, s, eps, relu != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? fwd_flags<__nv_bfloat16>(a, st) : fwd_flags<float>(a, st));
}

// part: 2 * ceil(HW / rpc) * B * C floats of scratch; ab: 2 * B * G floats.
// dres is written only when res is given.
extern "C" int group_norm_bwd(const void* x, const void* dy, const void* res,
                              const void* scale, const void* bias, const void* mean,
                              const void* rstd, void* dx, void* dres, void* ds, void* db,
                              void* part, void* ab, int B, int HW, int C, int G, int rpc,
                              int relu, int is_bf16, int device, void* stream) {
  Shape s{B, HW, C, G, rpc, 0};
  const int rc = prepare(s, device);
  if (rc != 0) return rc;
  BwdArgs a{x, dy, res, scale, bias, mean, rstd, dx, dres, ds, db, part, ab, s, relu != 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_bf16 ? bwd_flags<__nv_bfloat16>(a, st) : bwd_flags<float>(a, st));
}

extern "C" const char* group_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
